"""The port's AOT serving (`vits_tpu_torch.serve.aot`, `export --convert 1`,
`EmoVITS(aot=True)`) against its own eager phases and the JAX package's AOT
engine on the CPU at TINY. Both exporters write into one deployment
directory (text bucket 32, frame buckets 64 and 128, as tests/test_aot.py
exports); the port's programs run on the CPU, where `AOTBundle` calls the
exported module directly (the CUDA-graph replay runs on the card, in
chip_smoke.py's [sat] phase).

Tolerances: the port's programs against its eager phases exactly (the same
operations on the same weights); against the JAX package atol 1e-4 (fp32,
sums in another order), as tests/test_torch_serving.py holds the engines.
"""

import json
import logging
import os
import shutil

import numpy as np
import pytest
import torch

import jax

import vits_tpu.export as jexport
from test_infer_wrap import TINY_JSON
from vits_tpu.config import get_hparams_from_file as jax_get_hparams
from vits_tpu.infer import EmoVITS as JEmoVITS
from vits_tpu.models.synthesizer import Synthesizer as JSynth
from vits_tpu.nn.core import fold_weight_norm
from vits_tpu.utils import checkpoint as jax_ckpt

import vits_tpu_torch.export as texport
from vits_tpu_torch.infer import EmoVITS as TEmoVITS
from vits_tpu_torch.ops.seq import infer_path
from vits_tpu_torch.serve.aot import AOTBundle

TEXT_BUCKETS = (32,)
FRAME_BUCKETS = (64, 128)
BUCKET_FLAGS = ["--text-buckets", "32", "--frame-buckets", "64,128", "--verbose", "0"]


@pytest.fixture(scope="module")
def aot_dir(tmp_path_factory):
    """A TINY deployment (JAX-initialised weights, a speaker map and a bank)
    exported with --convert 1 by both packages into one directory."""
    src = tmp_path_factory.mktemp("deploy")
    with open(src / "config.json", "w") as f:
        json.dump(TINY_JSON, f)
    js = JSynth.from_hps(jax_get_hparams(str(src / "config.json")))
    params = jax.tree_util.tree_map(
        np.asarray, jax.device_get(jax.jit(js.init_params)(jax.random.PRNGKey(7))))
    jax_ckpt.save_checkpoint(str(src / "checkpoint.npz"), {"model": params})
    out = tmp_path_factory.mktemp("aot")
    orig = JSynth.init_params
    JSynth.init_params = lambda self, key: params  # the JAX exporter's template
    try:
        jexport.main(["--outdir", str(out), "--checkpoint", str(src / "checkpoint.npz"),
                      "--convert", "1", *BUCKET_FLAGS])
    finally:
        JSynth.init_params = orig
    texport.main(["--outdir", str(out), "--checkpoint", str(src / "checkpoint.npz"),
                  "--convert", "1", "--device", "cpu", *BUCKET_FLAGS])
    with open(out / "spk.map", "w") as f:
        f.write("10000 3\n")
    np.random.RandomState(5).randn(2, 1024).astype(np.float32).tofile(str(out / "3.emo"))
    return str(out), js, params


@pytest.fixture(autouse=True)
def serving_env(monkeypatch):
    for k in ("VITS_TPU_FUSED", "VITS_TPU_FUSED_Q8", "VITS_TPU_Q8_CALIB_REQUESTS",
              "VITS_TPU_QUANTIZE", "VITS_TPU_AOT", "VITS_TPU_DTYPE"):
        monkeypatch.delenv(k, raising=False)


def _ckpt(d):
    return os.path.join(d, "checkpoint.npz")


def _request(seed, n_tokens):
    rng = np.random.RandomState(seed)
    return rng.randn(n_tokens, 16).astype(np.float32), rng.randn(1024).astype(np.float32)


def test_bundle_buckets_and_artifacts(aot_dir):
    """The bucket lists and picks of the JAX bundle, and artifacts that hold
    no weights: every program takes them as an input."""
    d = aot_dir[0]
    bundle = AOTBundle(d, {}, "cpu")
    assert bundle.text_buckets() == [32]
    assert bundle.frame_buckets(32) == [64, 128]
    assert bundle.frame_buckets(64) == []
    assert (bundle.pick_text_bucket(20), bundle.pick_text_bucket(32),
            bundle.pick_text_bucket(33)) == (32, 32, None)
    assert (bundle.pick_frame_bucket(32, 64), bundle.pick_frame_bucket(32, 65),
            bundle.pick_frame_bucket(32, 129)) == (64, 128, None)
    programs = [fn for fn in os.listdir(d) if fn.endswith(".pt2")]
    assert len(programs) == 3
    for fn in programs:
        ep = torch.export.load(os.path.join(d, fn))
        assert not ep.state_dict, fn
        # phase 1's positional table (built once at the text encoder's 384
        # rows, a buffer outside the state dict) is the one constant
        shapes = [tuple(t.shape) for t in ep.constants.values()]
        assert shapes == ([(1, 384, 16)] if fn.startswith("model_p1") else []), fn


def _phase1_inputs(rng, tb=32, n=27):
    x = rng.randn(1, tb, 16).astype(np.float32)
    x_mask = np.zeros((1, tb, 1), np.float32)
    x_mask[0, :n] = 1.0
    emo = rng.randn(1, 1024).astype(np.float32)
    return x, x_mask, emo, np.asarray([3], np.int32)


@pytest.mark.parametrize("fb", FRAME_BUCKETS)
def test_programs_match_eager_and_jax(aot_dir, fb, monkeypatch):
    """call_p1 / call_p2 exactly equal to the port's eager infer_p1 /
    infer_p2 on the same weights (the decoder's eager body, which an export
    takes; the engine's own decodes take the packed body, within 1e-6 of
    it), and within 1e-4 of the JAX package's jitted phases."""
    d, js, params = aot_dir
    folded = fold_weight_norm(params)
    model = TEmoVITS(_ckpt(d), device="cpu", aot=True)
    synth = model.synth
    rng = np.random.RandomState(fb)
    x, x_mask, emo, sid = _phase1_inputs(rng)
    tx = [torch.from_numpy(a) for a in (x, x_mask, emo)] + [torch.from_numpy(sid).long()]
    with torch.inference_mode():
        got1 = model.aot.call_p1(32, *tx)
        eager1 = synth.infer_p1(tx[0], tx[2], tx[3], x_mask=tx[1])
    want1 = jax.jit(lambda p, a, m, e, s: js.infer_p1(p, a, e, s, x_mask=m))(
        folded, x, x_mask, emo, sid)
    for g, e, w_ in zip(got1, eager1, want1):
        torch.testing.assert_close(g, e, rtol=0, atol=0)
        np.testing.assert_allclose(g.numpy(), np.asarray(w_), atol=1e-4, rtol=0)

    m_p, s_p, logw, g = got1
    w_ceil = np.ceil(np.exp(logw.numpy())[0, :27, 0])
    dur = np.zeros((1, 32), np.float32)
    dur[0, :27] = w_ceil
    y_len = min(int(w_ceil.sum()), fb)
    attn = infer_path(torch.from_numpy(dur), fb)
    noise = torch.from_numpy(rng.randn(1, fb, 8).astype(np.float32))
    y_mask = torch.zeros(1, fb, 1)
    y_mask[0, :y_len] = 1.0
    with torch.inference_mode():
        got2 = model.aot.call_p2(32, fb, attn, m_p, s_p, g, noise, y_mask)
        packed2 = synth.infer_p2(attn, m_p, s_p, g, noise, y_mask)
        monkeypatch.setattr(synth.dec, "_pack", None)  # the eager body
        eager2 = synth.infer_p2(attn, m_p, s_p, g, noise, y_mask)
    torch.testing.assert_close(got2, eager2, rtol=0, atol=0)
    torch.testing.assert_close(packed2, eager2, rtol=0, atol=1e-6)
    want2 = jax.jit(lambda p, a, m, s, gg, n, ym: js.infer_p2(p, a, m, s, gg, n, y_mask=ym))(
        folded, attn.numpy(), m_p.numpy(), s_p.numpy(), g.numpy(), noise.numpy(),
        y_mask.numpy())
    np.testing.assert_allclose(got2.numpy(), np.asarray(want2), atol=1e-4, rtol=0)


@pytest.fixture
def jax_init(aot_dir, monkeypatch):
    monkeypatch.setattr(JSynth, "init_params", lambda self, key: aot_dir[2])


@pytest.mark.parametrize("spk", [2, 10000])
def test_emovits_aot_matches_jax(aot_dir, jax_init, spk):
    """An in-bucket request through both packages' AOT engines (the same
    np.random seed: the bank pick, then the noise-ring start), an explicit
    emotion vector and a mapped speaker with its bank: the same length and
    waveform to 1e-4."""
    d = aot_dir[0]
    port = TEmoVITS(_ckpt(d), device="cpu", aot=True)
    ref = JEmoVITS(_ckpt(d), aot=True)
    assert port.aot is not None and ref.aot is not None
    text, emo = _request(3, 19)
    emo = emo if spk == 2 else None
    np.random.seed(11)
    wav_t, emo_t = port.infer(spk, text, emo)
    np.random.seed(11)
    wav_j, emo_j = ref.infer(spk, text, emo)
    np.testing.assert_array_equal(emo_t, emo_j)
    assert len(wav_t) == len(wav_j) > 0
    np.testing.assert_allclose(wav_t, wav_j, atol=1e-4, rtol=0)


def test_out_of_bucket_requests_go_eager(aot_dir, monkeypatch):
    """Past the text bucket both phases run eagerly; inside it but past the
    frame buckets phase 2 does. Each equals the eager engine's two-phase
    decode of the same request exactly (the same padded shapes)."""
    d = aot_dir[0]
    model = TEmoVITS(_ckpt(d), device="cpu", aot=True)
    eager = TEmoVITS(_ckpt(d), device="cpu")
    calls = []
    for name in ("call_p1", "call_p2"):
        orig = getattr(model.aot, name)
        monkeypatch.setattr(model.aot, name,
                            lambda *a, _o=orig, _n=name: calls.append(_n) or _o(*a))
    text, emo = _request(4, 40)
    np.random.seed(12)
    wav_a, _ = model.infer(2, text, emo)
    np.random.seed(12)
    wav_e, _ = eager._infer_two_phase(2, text, emo)
    assert calls == []
    np.testing.assert_array_equal(wav_a, wav_e)

    text, emo = _request(5, 30)
    np.random.seed(13)
    wav_a, _ = model.infer(2, text, emo, duration_rate=8.0)
    np.random.seed(13)
    wav_e, _ = eager._infer_two_phase(2, text, emo, duration_rate=8.0)
    assert calls == ["call_p1"]
    assert len(wav_a) > 128 * model.hop_size
    np.testing.assert_array_equal(wav_a, wav_e)


def test_bf16_with_aot_raises(aot_dir, monkeypatch):
    with pytest.raises(ValueError, match="fp32"):
        TEmoVITS(_ckpt(aot_dir[0]), device="cpu", aot=True, compute_dtype="bf16")
    monkeypatch.setenv("VITS_TPU_AOT", "1")
    monkeypatch.setenv("VITS_TPU_DTYPE", "bf16")
    with pytest.raises(ValueError, match="fp32"):
        TEmoVITS(_ckpt(aot_dir[0]), device="cpu")


def test_directory_without_programs_warns_and_serves_eager(aot_dir, tmp_path, caplog):
    for fn in ("config.json", "checkpoint.npz"):
        shutil.copy(os.path.join(aot_dir[0], fn), tmp_path / fn)
    with caplog.at_level(logging.WARNING, logger="vits_tpu_torch"):
        model = TEmoVITS(str(tmp_path / "checkpoint.npz"), device="cpu", aot=True)
    assert model.aot is None
    assert any("no .pt2 programs" in r.getMessage() for r in caplog.records)
    text, emo = _request(6, 12)
    wav, _ = model.infer(2, text, emo)
    assert len(wav) > 0 and np.all(np.isfinite(wav))


def test_quantized_aot_serves_phase1_from_the_bundle(aot_dir, monkeypatch):
    """With quantize=True phase 1 comes from the bundle and phase 2 is the
    eager path: the float decoder while calibrating, then the int8 one,
    never a phase-2 program (VITS_TPU_AOT=1 turns the bundle on)."""
    monkeypatch.setenv("VITS_TPU_Q8_CALIB_REQUESTS", "1")
    monkeypatch.setenv("VITS_TPU_Q8_MIN_CORR", "0")
    monkeypatch.setenv("VITS_TPU_AOT", "1")
    model = TEmoVITS(_ckpt(aot_dir[0]), device="cpu", quantize=True)
    assert model.aot is not None
    calls = []
    for name in ("call_p1", "call_p2"):
        orig = getattr(model.aot, name)
        monkeypatch.setattr(model.aot, name,
                            lambda *a, _o=orig, _n=name: calls.append(_n) or _o(*a))
    text, emo = _request(7, 19)
    model.infer(2, text, emo)  # calibrates and freezes
    assert model.dec_q8 is not None
    wav, _ = model.infer(2, text, emo)
    assert calls == ["call_p1", "call_p1"]
    assert len(wav) > 0 and np.all(np.isfinite(wav))
