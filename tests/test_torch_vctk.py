"""The VCTK configuration (`benchmark/configs/vctk.json`, VITS's
`configs/vctk_base.json`) on the port's serving path, on the CPU.

At TINY channels with the configuration's shape pattern (ResBlock1 with
kernels 3/7/11 and dilations 1/3/5, upsamples 8, 8, 2, 2 over kernels 16,
16, 4, 4, hop 256), `EmoVITS.infer` on its default engine serves a request
by the fused pass and one whose durations fill a budget of one frame a
token, served again two-phase. Each is held by the benchmark's own
comparison (`benchmark/harness/check.py::compare_served`) to the frozen
reference with the same seeded weights: the durations agree and the
waveform within 1e-5 (fp32 on one CPU in both; the full-width model read
6.1e-7). A conv2 kernel of one ResBlock1 (the third stage's first) scaled by
1.01 in the engine's copy reads above the cell's 3e-4 (1.4e-3 here; the
first stage's read ~1.3e-4 at TINY widths). Both requests take the decoder's
packed body, whose ResBlock1 conv1 is a view of the kernel's first
`inter_channels` rows and computes the full conv's first channels.

At the published widths (the reference on the meta device), the decoder is
ResBlock1 throughout, its hop is the product of its upsample rates, and the
frozen FLOP count reads 0.912 GFLOP a decoded frame.
"""

import copy
import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from benchmark.harness.check import compare_served, fused_budget
from benchmark.harness.common import hparams, load_cell
from benchmark.harness.serve import engine_ring
from benchmark.harness.traffic import hps_of
from benchmark.harness.weights import build_serving_model, write_checkpoint
from benchmark.harness.work import meta_models
from benchmark.reference import flops
from benchmark.reference.modules import ResBlock1
from benchmark.tests.tiny import TINY_CONFIG
from vits_tpu_torch.infer import EmoVITS
from vits_tpu_torch.models.modules import fused_steps

SEED = 23
CPU = torch.device("cpu")


def _tiny_vctk():
    cfg = copy.deepcopy(TINY_CONFIG)
    cfg["assumed"] = {"frames_per_token": 5.0, "duration_spread": 0.3}
    cfg["data"].update(sampling_rate=22050, filter_length=1024, hop_length=256,
                       win_length=1024)
    cfg["model"].update(resblock="1", ffn="FFN", resblock_kernel_sizes=[3, 7, 11],
                        resblock_dilation_sizes=[[1, 3, 5]] * 3, upsample_rates=[8, 8, 2, 2],
                        upsample_initial_channel=256, upsample_kernel_sizes=[16, 16, 4, 4])
    return cfg


@pytest.fixture(scope="module")
def deploy(tmp_path_factory):
    cfg = _tiny_vctk()
    hps_dict = hparams(cfg)
    hps = hps_of(hps_dict)
    ref = build_serving_model(hps, SEED, CPU, cfg["assumed"])
    ckpt = write_checkpoint(str(tmp_path_factory.mktemp("vctk")), ref, hps_dict)
    return ckpt, hps, ref


@pytest.fixture(autouse=True)
def serving_env(monkeypatch):
    for k in ("VITS_TPU_FUSED", "VITS_TPU_FUSED_Q8", "VITS_TPU_FUSED_FRAMES_PER_TOKEN",
              "VITS_TPU_QUANTIZE", "VITS_TPU_AOT", "VITS_TPU_DTYPE"):
        monkeypatch.delenv(k, raising=False)


def _serve(model, tokens, seed):
    rng = np.random.default_rng(seed)
    r = {"tokens": tokens, "text": rng.standard_normal((tokens, 16), np.float32),
         "emo": rng.standard_normal(1024, np.float32), "spk": int(rng.integers(0, 8)),
         "np_seed": seed}
    np.random.seed(r["np_seed"])
    wav, _ = model.infer(r["spk"], r["text"], r["emo"])
    return {"req": r, "wav": wav}


@pytest.mark.parametrize("frames_per_token", [8.0, 1.0], ids=["fused", "retried"])
def test_served_request_equals_the_reference(deploy, monkeypatch, frames_per_token):
    monkeypatch.setenv("VITS_TPU_FUSED_FRAMES_PER_TOKEN", repr(frames_per_token))
    ckpt, hps, ref = deploy
    model = EmoVITS(ckpt, device="cpu")
    assert model.synth.dec.resblock == "1" and model.hop_size == 256
    served = _serve(model, 24, seed=5)
    frames = len(served["wav"]) // model.hop_size
    retried = frames >= fused_budget(24, hps, frames_per_token)
    assert model.counts["retried"] == int(retried) == int(frames_per_token == 1.0)
    assert model.counts["dec_fused"] == 1  # the packed body, fused or retried
    readings = compare_served(ref, hps, engine_ring(hps), [served], frames_per_token, CPU)
    assert readings["dur_gap"] == 0.0
    assert readings["wav_rel_err"] <= 1e-5


@pytest.mark.parametrize("k", [3, 7, 11])
def test_the_narrowed_conv1_is_the_full_conv_first_channels(deploy, k):
    """The packed body's ResBlock1 conv1 (`fused_steps`) is a contiguous
    view of the folded kernel's first `inter_channels` output channels (not
    a copy), and computes the full conv's first channels, the ones conv2
    reads (fp32; the convs of two widths may block their sums apart: 1e-6)."""
    model = EmoVITS(deploy[0], device="cpu")
    rb = next(b for b in model.synth.dec.resblocks.values() if b.kernel_size == k)
    ic = rb.inter_channels
    x = torch.randn(2, rb.channels, 50, generator=torch.Generator().manual_seed(k))
    for i, st in enumerate(fused_steps(rb)):
        c1 = rb.convs1[str(i)]
        assert c1.out_channels == 2 * ic and st["w1"].shape[0] == ic
        assert st["w1"].is_contiguous() and st["w1"].data_ptr() == c1.weight.data_ptr()
        with torch.no_grad():
            full = F.conv1d(x, c1.weight, None, padding=c1.padding, dilation=c1.dilation)
            narrow = F.conv1d(x, st["w1"], None, padding=st["pad1"], dilation=st["dilation"])
        np.testing.assert_allclose(narrow.numpy(), full[:, :ic].numpy(), atol=1e-6, rtol=0)
    pack = model.synth.dec.pack_fused()
    assert pack is not None and not pack["glu"]


def test_a_scaled_resblock1_kernel_is_caught(deploy):
    ckpt, hps, ref = deploy
    model = EmoVITS(ckpt, device="cpu")
    with torch.no_grad():
        model.synth.dec.resblocks["6"].convs2["0"].weight.mul_(1.01)
    readings = compare_served(ref, hps, engine_ring(hps), [_serve(model, 24, seed=5)], 8.0,
                              CPU)
    assert readings["dur_gap"] == 0.0
    assert readings["wav_rel_err"] > 3e-4


def test_published_widths():
    cfg = load_cell("vctk-serve-b1")["config_file"]
    assert cfg["reduced"] == []
    hps = hps_of(hparams(cfg))
    d, m = hps.data, hps.model
    assert (d.sampling_rate, d.filter_length, d.hop_length, d.win_length, d.n_mel_channels,
            d.n_speakers) == (22050, 1024, 256, 1024, 80, 109)
    assert (m.inter_channels, m.hidden_channels, m.filter_channels, m.n_heads, m.n_layers,
            m.kernel_size, m.ffn, m.n_flows, m.gin_channels) == (
        192, 192, 768, 2, 6, 3, "FFN", 4, 256)
    synth, _ = meta_models(hps)
    dec = synth.dec
    assert len(dec.resblocks) == 12
    assert all(isinstance(rb, ResBlock1) for rb in dec.resblocks.values())
    assert [(rb.kernel_size, rb.dilation) for rb in dec.resblocks.values()] == [
        (k, (1, 3, 5)) for k in (3, 7, 11)] * 4
    assert d.hop_length == math.prod(dec.upsample_rates) == 256
    assert dec.upsample_kernel_sizes == (16, 16, 4, 4)
    assert dec.conv_pre.out_channels == 512 and dec.conv_post.in_channels == 32
    per_frame = flops.generator_flops(dec, 1, 1000)["total"] / 1000
    assert per_frame == pytest.approx(0.912e9, rel=5e-3)
