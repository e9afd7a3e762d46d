"""The port's AOT programs on the card: a deployment exported with
`python -m vits_tpu_torch.export --convert 1 --device cpu` (traced on the
CPU, so its device constants are the CPU's) served by `EmoVITS(aot=True)`
on the GPU, where `AOTBundle` replays a CUDA graph per bucket. Each phase
is held against the same model's eager phase on the same inputs at the
bucket's shapes, atol 1e-4 (the same kernels; the graph only replays
them), and a second replay gives the first one's outputs. Marked `cuda`;
skips where no CUDA device is present. Run on the GPU machine with
`python -m pytest --noconftest tests/test_torch_aot_cuda.py -q`."""

import json

import numpy as np
import pytest
import torch

import vits_tpu_torch.export as texport
from vits_tpu_torch.config import get_hparams_from_file
from vits_tpu_torch.convert import params_to_jax
from vits_tpu_torch.infer import EmoVITS
from vits_tpu_torch.models.synthesizer import Synthesizer
from vits_tpu_torch.nn.core import init_weights
from vits_tpu_torch.ops.seq import infer_path
from vits_tpu_torch.utils import checkpoint as ck

pytestmark = pytest.mark.cuda

# a small two-speaker config of the repo's layout (the CPU tests' TINY widths)
SMALL = {
    "train": {"segment_size": 64, "learning_rate": 2e-4, "betas": [0.8, 0.99], "eps": 1e-9,
              "batch_size": 2, "lr_decay": 0.999875, "seed": 1, "epochs": 1, "steps": 10,
              "weight_decay": 0.01, "c_mel": 45, "c_dur": 2, "c_kl": 1.0, "c_kl_q": 0.01,
              "log_interval": 1, "eval_interval": 2},
    "data": {"text_channels": 16, "sampling_rate": 1600, "filter_length": 64,
             "hop_length": 8, "win_length": 64, "n_mel_channels": 20, "mel_fmin": 0.0,
             "mel_fmax": None, "n_speakers": 8, "noise_scale": 0.707, "max_text_len": 384,
             "training_files": "x", "validation_files": "x"},
    "model": {"inter_channels": 8, "hidden_channels": 16, "filter_channels": 24, "n_heads": 2,
              "n_layers": 2, "kernel_size": 3, "p_dropout": 0.1, "ffn": "FFN2",
              "resblock": "2", "resblock_kernel_sizes": [3],
              "resblock_dilation_sizes": [[1, 3]], "upsample_rates": [4, 2],
              "upsample_initial_channel": 64, "upsample_kernel_sizes": [8, 4],
              "kernel_size_q": 5, "n_layers_q": 3, "hidden_size_d": 16, "kernel_size_d": 5,
              "p_dropout_d": 0.5, "act_func_d": "ReLU", "use_spectral_norm": False,
              "dilation_rate": [1, 1], "n_flows": 2, "gin_channels": 16},
}
FRAME_BUCKETS = (64, 128)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the bucket graphs are CUDA graphs)")
    return torch.device("cuda", 0)


def _close(got, want):
    for g, w in zip(got, want) if isinstance(got, tuple) else ((got, want),):
        torch.testing.assert_close(g, w, rtol=0, atol=1e-4)


def test_cpu_traced_programs_serve_on_the_card(cuda, tmp_path):
    src = tmp_path / "run"
    src.mkdir()
    with open(src / "config.json", "w") as f:
        json.dump(SMALL, f)
    hps = get_hparams_from_file(str(src / "config.json"))
    synth = init_weights(Synthesizer.from_hps(hps, train=True), torch.Generator().manual_seed(3))
    ck.save_checkpoint(str(src / "G_1.npz"), {"model": params_to_jax(synth.state_dict())})
    out = tmp_path / "deploy"
    texport.main(["--outdir", str(out), "--checkpoint", str(src), "--convert", "1",
                  "--device", "cpu", "--text-buckets", "32", "--frame-buckets",
                  ",".join(map(str, FRAME_BUCKETS)), "--verbose", "0"])
    model = EmoVITS(str(out / "checkpoint.npz"), device="cuda", aot=True)
    assert model.aot is not None and model.aot.device.type == "cuda"

    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(1, 32, 16).astype(np.float32)).to(cuda)
    x_mask = torch.zeros(1, 32, 1, device=cuda)
    x_mask[0, :27] = 1.0
    emo = torch.from_numpy(rng.randn(1, 1024).astype(np.float32)).to(cuda)
    sid = torch.tensor([3], device=cuda)
    with torch.inference_mode():
        got1 = model.aot.call_p1(32, x, x_mask, emo, sid)
        _close(got1, model.synth.infer_p1(x, emo, sid, x_mask=x_mask))
        _close(model.aot.call_p1(32, x, x_mask, emo, sid), got1)
        m_p, s_p, logw, g = got1
        dur = torch.zeros(1, 32, device=cuda)
        dur[0, :27] = torch.ceil(torch.exp(logw[0, :27, 0]))
        for fb in FRAME_BUCKETS:
            attn = infer_path(dur, fb)
            noise = torch.from_numpy(rng.randn(1, fb, 8).astype(np.float32)).to(cuda)
            y_mask = torch.zeros(1, fb, 1, device=cuda)
            y_mask[0, :min(int(dur.sum()), fb)] = 1.0
            got2 = model.aot.call_p2(32, fb, attn, m_p, s_p, g, noise, y_mask)
            _close(got2, model.synth.infer_p2(attn, m_p, s_p, g, noise, y_mask))
            _close(model.aot.call_p2(32, fb, attn, m_p, s_p, g, noise, y_mask), got2)
    assert sorted(model.aot.graphs) == [("p1", 32)] + [("p2", 32, fb) for fb in FRAME_BUCKETS]

    text = rng.randn(19, 16).astype(np.float32)
    np.random.seed(1)
    wav, _ = model.infer(3, text, rng.randn(1024).astype(np.float32))
    assert len(wav) > 0 and len(wav) % 8 == 0 and np.all(np.isfinite(wav))
