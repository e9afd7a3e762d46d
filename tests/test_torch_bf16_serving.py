"""The port's bf16 serving against the JAX package's on the CPU: the
attention-score repair, K1's plain chain in bf16 against the Pallas chain
at bf16, and `EmoVITS(compute_dtype="bf16")` two-phase, fused, streamed and
with the int8 decoder against the JAX engine at `compute_dtype=bfloat16`,
on one seeded deployment written by the JAX package at TINY (the same
`np.random` seed per request in both packages).

The two packages round bf16 at different places by design (not emulated):
a conv's bias add, which JAX rounds after the product and torch fuses;
LayerNorm, whose mean and variance JAX takes in bf16 and `F.layer_norm` in
f32; softmax; the transcendentals of the two libraries. Tolerances:
- attention scores: the port's, from bf16 q and k, equal JAX's f32-accumulated
  einsum of the same q and k to rtol 1e-6 (f32 sums in another order); the
  old bf16 einsum is off by far more;
- K1's plain chain in bf16 against the Pallas chain at bf16
  (`interpret=True`, run eagerly so that XLA keeps each of the kernel's
  bf16 roundings; under jit its CPU backend may carry f32 across one): both
  round at the same points, but the Pallas chain quantizes by x * (1 / s)
  where the port divides, and the libraries' tanh and exp differ in the
  last bits, so now and then an int8 value moves by one step and the step
  spreads along the following taps: at most 1% of the elements off by more
  than 2^-6 of the output's peak, none by more than 2^-3 of max(1, peak).
  Against `apply_q8`, which rounds its dequantized conv to bf16 before the
  gate (the JAX package's other int8 path), 10% and 2^-3;
- phase 1 (m_p, s_p, logw, g): each within 2^-4 of its peak magnitude;
- waveforms in (-1, 1) from the same alignment: max abs difference 2^-5 and
  correlation > 0.995 (a random TINY voice peaks near 0.05, so a few bf16
  steps of difference are a few percent of it); the int8 decoder (K1's rounding points against JAX's
  `apply_q8`, each engine calibrated on its own bf16 latents): correlation
  > 0.99 against JAX and against the float decode.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_infer_wrap import TINY_JSON
from test_torch_quant import _t
from vits_tpu.config import get_hparams_from_file as jax_get_hparams
from vits_tpu.infer import EmoVITS as JEmoVITS
from vits_tpu.models.attentions import MultiHeadAttention as JMHA
from vits_tpu.models.modules import ResBlock2 as JResBlock2
from vits_tpu.models.synthesizer import Synthesizer as JSynth
from vits_tpu.nn.core import fold_weight_norm
from vits_tpu.nn.packed import mask_packed
from vits_tpu.nn.pallas_rb import resblock2_chain_q8 as pallas_chain
from vits_tpu.utils import checkpoint as jax_ckpt

from vits_tpu_torch.convert import params_from_jax
from vits_tpu_torch.infer import EmoVITS as TEmoVITS
from vits_tpu_torch.infer import serving_dtype
from vits_tpu_torch.models.attentions import MultiHeadAttention as TMHA
from vits_tpu_torch.models.modules import ResBlock2 as TResBlock2
from vits_tpu_torch.nn import rb_chain
from vits_tpu_torch.vits_wrap import VITSWrap

BF = jnp.bfloat16


def _f32(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def _bf(a):
    """numpy -> the bf16-rounded values, as float32 numpy."""
    return np.asarray(jnp.asarray(a, BF).astype(jnp.float32))


def _corr(a, b):
    return float(np.corrcoef(np.ravel(a), np.ravel(b))[0, 1])


def _seeded(seed, fn, *a, **k):
    np.random.seed(seed)
    return fn(*a, **k)


@pytest.fixture(scope="module")
def deploy(tmp_path_factory):
    d = tmp_path_factory.mktemp("deploy_bf16")
    with open(d / "config.json", "w") as f:
        json.dump(TINY_JSON, f)
    js = JSynth.from_hps(jax_get_hparams(str(d / "config.json")))
    params = jax.tree_util.tree_map(
        np.asarray, jax.device_get(jax.jit(js.init_params)(jax.random.PRNGKey(7))))
    jax_ckpt.save_checkpoint(str(d / "checkpoint.npz"), {"model": params})
    return str(d / "checkpoint.npz"), params


@pytest.fixture
def jax_init(deploy, monkeypatch):
    """The JAX engine builds its checkpoint template with an eager
    init_params; the fixture's tree has the same structure."""
    monkeypatch.setattr(JSynth, "init_params", lambda self, key: deploy[1])


@pytest.fixture(autouse=True)
def serving_env(monkeypatch):
    for k in ("VITS_TPU_FUSED", "VITS_TPU_FUSED_Q8", "VITS_TPU_FUSED_FRAMES_PER_TOKEN",
              "VITS_TPU_Q8_CALIB_REQUESTS", "VITS_TPU_QUANTIZE", "VITS_TPU_AOT",
              "VITS_TPU_DTYPE"):
        monkeypatch.delenv(k, raising=False)


def test_attention_scores_are_f32_from_bf16_q_k(monkeypatch):
    """The repair of attentions.py: scores from bf16 q, k cast to f32, as the
    JAX package's preferred_element_type=float32; the layer's output within
    bf16 tolerance of JAX's on the same bf16 weights."""
    rng = np.random.RandomState(0)
    jm = JMHA(32, 32, 2)
    p = _f32(jax.tree_util.tree_map(lambda a: a.astype(BF),
                                    jm.init_params(jax.random.PRNGKey(3))))
    tm = params_from_jax(p, TMHA(32, 32, 2)).to(torch.bfloat16)
    x = _bf(rng.randn(2, 40, 32) * 2).copy()
    seen = {}
    real_softmax = torch.softmax

    def softmax(scores, dim):
        seen["s"] = scores
        return real_softmax(scores, dim)

    monkeypatch.setattr(torch, "softmax", softmax)
    for name in ("q", "k"):
        getattr(tm, f"conv_{name}").register_forward_hook(
            lambda m, a, o, _n=name: seen.__setitem__(_n, o))
    with torch.no_grad():
        out = tm(torch.from_numpy(x).bfloat16(), torch.from_numpy(x).bfloat16())
    assert seen["s"].dtype == torch.float32 and out.dtype == torch.bfloat16
    q = jnp.asarray(seen["q"].float().numpy(), BF).reshape(2, 40, 2, 16)
    k = jnp.asarray(seen["k"].float().numpy(), BF).reshape(2, 40, 2, 16)
    want = np.asarray(jnp.einsum("bthd,bshd->bhts", q / np.sqrt(16.0), k,
                                 preferred_element_type=jnp.float32))
    np.testing.assert_allclose(seen["s"].numpy(), want, rtol=1e-6, atol=1e-6)
    # the einsum the port took before: bf16 scores, then .float()
    qt, kt = (seen[n].reshape(2, 40, 2, 16) for n in ("q", "k"))
    old = torch.einsum("bthd,bshd->bhts", qt / 4.0, kt).float().numpy()
    assert np.abs(old - want).max() > 100 * max(np.abs(seen["s"].numpy() - want).max(), 1e-7)
    ref = np.asarray(jm.apply(jax.tree_util.tree_map(lambda a: jnp.asarray(a, BF), p),
                              jnp.asarray(x, BF), jnp.asarray(x, BF)).astype(jnp.float32))
    assert np.abs(out.float().numpy() - ref).max() <= 2 ** -4 * np.abs(ref).max()


def _chain_off(out, ref, frac, step):
    out, ref = np.asarray(out, np.float32), np.asarray(ref, np.float32)
    assert out.shape == ref.shape
    diff = np.abs(out - ref)
    peak = np.abs(ref).max()
    assert diff.max() <= 2 ** -3 * max(1.0, peak), diff.max()
    assert (diff > step * peak).mean() <= frac, (diff > step * peak).mean()


@pytest.mark.parametrize("C,pack,ks,dil,B,M", [
    (16, 2, 3, (1, 3), 2, 12),
    (32, 1, 3, (1, 3, 5), 2, 20),
    (16, 4, 5, (1, 3, 5), 1, 16),
    (64, 1, 7, (1, 3, 5), 2, 200),
    (128, 1, 7, (1, 3, 5), 1, 48),
])
def test_plain_chain_bf16_matches_pallas(C, pack, ks, dil, B, M):
    """test_pallas_rb.py's three shapes, a k = 7 one at a whole-chain width
    of K1 and one at a split-form width (C = 128, k = 7), in bf16: the JAX
    block's weight norm folded in f32 and then cast, as its engine does; the
    JAX block calibrated in bf16 (phase packed at `pack`) and both packages
    quantized from that record; the port runs the same frames unpacked. A
    CPU tensor takes the plain version through the kernel's entry point."""
    rng = np.random.RandomState(0)
    jrb = JResBlock2(channels=C, kernel_size=ks, dilation=dil, gin_channels=16)
    p = fold_weight_norm(jax.jit(jrb.init_params)(jax.random.PRNGKey(1)))
    pb = jax.tree_util.tree_map(lambda a: a.astype(BF), p)
    T = M * pack
    lens = [T - 3 * (i % 2) - 1 for i in range(B)]
    mask = (np.arange(T)[None, :, None] < np.asarray(lens)[:, None, None]).astype(np.float32)
    x = _bf(rng.randn(B, T, C)) * mask
    g = _bf(rng.randn(B, 16))
    xp = jnp.asarray(x.reshape(B, M, pack * C), BF)
    gj, mj = jnp.asarray(g, BF), jnp.asarray(mask, BF)
    rec = {}
    if pack > 1:
        jrb.apply_packed(pb, xp, gj, pack, x_mask=mj, record=rec)
    else:
        jrb.apply(pb, xp, gj, x_mask=mj, record=rec)
    qp = jrb.quantize_params(pb, rec, pack)
    pal = pallas_chain(jrb, qp, mask_packed(xp, mj, pack), gj, pack=pack, x_mask=mj,
                       chunk=M, interpret=True)
    ref = jrb.apply_q8(qp, xp, gj, pack=pack, x_mask=mj)
    assert pal.dtype == ref.dtype == BF
    trb = params_from_jax(_f32(p), TResBlock2(C, ks, dil, 16)).eval().to(torch.bfloat16)
    tqp = trb.quantize_params({k: _t(np.asarray(v, np.float32)) for k, v in rec.items()})
    xt = _t(x).bfloat16()
    with torch.no_grad():
        out = trb.apply_q8(tqp, xt, _t(g).bfloat16(), x_mask=_t(mask).bfloat16())
        gs = torch.stack([trb.conds[str(i)](_t(g).bfloat16()) for i in range(len(dil))],
                         1).float()
    assert out.dtype == torch.bfloat16
    out = out.float().numpy()
    _chain_off(out, np.asarray(pal.astype(jnp.float32)).reshape(B, T, C), 0.01, 2 ** -6)
    _chain_off(out, np.asarray(ref.astype(jnp.float32)).reshape(B, T, C), 0.10, 2 ** -6)
    valid = torch.tensor(lens, dtype=torch.int32)
    np.testing.assert_array_equal(
        rb_chain.resblock2_chain_q8(tqp, xt, gs, valid).float().numpy(),
        rb_chain.chain_q8_plain(tqp, xt, gs, valid).float().numpy())


def _engines(deploy, **kw):
    ckpt = deploy[0]
    return (JEmoVITS(ckpt, compute_dtype=BF, **kw),
            TEmoVITS(ckpt, device="cpu", compute_dtype="bf16", **kw))


def _request(seed, n_tok):
    rng = np.random.RandomState(seed)
    return rng.randn(n_tok, 16).astype(np.float32), rng.randn(1024).astype(np.float32)


def _close_wav(a, b):
    assert a.shape == b.shape and len(a) > 0
    assert np.abs(a - b).max() <= 2 ** -5
    assert _corr(a, b) > 0.995


@pytest.mark.parametrize("n_tok", [20, 41])
def test_two_phase_bf16_matches_jax(deploy, jax_init, n_tok):
    """Phase 1 within tolerance; then phase 2 in both packages from the JAX
    engine's alignment and noise slice (a bf16 rounding difference in logw
    may move a duration's ceil by a frame); then the whole request."""
    jm, tm = _engines(deploy, frame_quantum=16)
    assert tm.synth.dec.conv_pre.weight.dtype == torch.bfloat16
    text, emo = _request(n_tok, n_tok)
    x_pad = tm._quantize(n_tok, tm.text_quantum, tm.max_text_len)
    p1_j = jm._run_phase1(2, text, emo, n_tok, x_pad)
    p1_t = tm._run_phase1(2, text, emo, n_tok, x_pad)
    for name, a, b in zip(("m_p", "s_p", "logw", "g"), p1_j, p1_t):
        a = np.asarray(a, np.float32)
        assert b.dtype == torch.bfloat16, name
        assert np.abs(b.float().numpy() - a).max() <= 2 ** -4 * np.abs(a).max(), name
    w = np.ceil(np.exp(np.asarray(p1_j[2], np.float32))[0, :n_tok, 0])
    y_len = int(w.sum())
    y_pad = tm._quantize(y_len, tm.frame_quantum)
    attn, noise, y_mask = _seeded(3, jm._alignment, w, n_tok, x_pad, y_len, y_pad)
    wav_j = np.asarray(jm._p2(jm.params, attn, *p1_j[:2], p1_j[3], noise, y_mask), np.float32)
    with torch.inference_mode():
        args = [torch.from_numpy(np.array(a)).to(torch.bfloat16) for a in (attn, noise, y_mask)]
        wav_t = tm.synth.infer_p2(args[0], *p1_t[:2], p1_t[3], args[1], args[2])
    assert wav_t.dtype == torch.bfloat16
    _close_wav(wav_t.float().numpy().ravel(), wav_j.ravel())
    _close_wav(_seeded(5, tm._infer_two_phase, 2, text, emo)[0],
               _seeded(5, jm._infer_two_phase, 2, text, emo)[0])


def test_fused_and_stream_bf16_match_jax(deploy, jax_init):
    """The fused default (float decoder) and `infer_stream` in bf16 against
    the JAX engine's; the stream is the port's two-phase output."""
    jm, tm = _engines(deploy, frame_quantum=16)
    assert tm.inference == tm.infer and tm._prefer_fused
    text, emo = _request(7, 61)
    wav_t, _ = _seeded(11, tm.infer, 2, text, emo)
    wav_j, _ = _seeded(11, jm.infer, 2, text, emo)
    assert 0 < len(wav_t) < tm.fused_frames(61) * tm.hop_size
    _close_wav(wav_t, wav_j)
    chunks = _seeded(13, lambda: list(tm.infer_stream(2, text, emo)))
    assert len(chunks) > 2
    streamed = np.concatenate(chunks)
    np.testing.assert_array_equal(streamed, _seeded(13, tm._infer_two_phase, 2, text, emo)[0])
    _close_wav(streamed, np.concatenate(_seeded(13, lambda: list(jm.infer_stream(2, text, emo)))))


def test_int8_bf16_matches_jax(deploy, jax_init, monkeypatch):
    """Two calibration requests freeze each engine's int8 decoder on its
    bf16 activations; then a two-phase int8 request and a fused int8 one.
    Every chain the port's int8 decodes run goes through K1's entry point
    in bf16."""
    monkeypatch.setenv("VITS_TPU_Q8_CALIB_REQUESTS", "2")
    jm, tm = _engines(deploy, quantize=True)
    chains = []
    real = rb_chain.resblock2_chain_q8
    monkeypatch.setattr(rb_chain, "resblock2_chain_q8",
                        lambda qp, x, *a: chains.append(x.dtype) or real(qp, x, *a))
    for i in range(2):
        text, emo = _request(40 + i, 20)
        _close_wav(_seeded(40 + i, tm.infer, 2 + i, text, emo)[0],
                   _seeded(40 + i, jm.infer, 2 + i, text, emo)[0])
    assert tm.dec_q8 is not None and jm.dec_q8 is not None and tm.q8_corr > 0.995
    text, emo = _request(42, 20)
    chains.clear()
    wav_t, _ = _seeded(42, tm._infer_two_phase, 4, text, emo)
    wav_j, _ = _seeded(42, jm._infer_two_phase, 4, text, emo)
    assert chains and set(chains) == {torch.bfloat16}
    assert wav_t.shape == wav_j.shape and _corr(wav_t, wav_j) > 0.99
    wav_f, _ = _seeded(43, tm.infer_fused, 4, text, emo)  # fused, float decoder
    monkeypatch.setenv("VITS_TPU_FUSED_Q8", "1")
    chains.clear()
    wav_t, _ = _seeded(43, tm.infer, 4, text, emo)
    wav_j, _ = _seeded(43, jm.infer, 4, text, emo)
    assert chains and set(chains) == {torch.bfloat16}
    assert wav_t.shape == wav_j.shape == wav_f.shape
    assert _corr(wav_t, wav_j) > 0.99 and _corr(wav_t, wav_f) > 0.99


def test_serving_dtype_and_its_plumbing(deploy, monkeypatch):
    """compute_dtype and VITS_TPU_DTYPE take fp32 and bf16 (names or torch
    dtypes) and refuse anything else, as the JAX engine does; VITSWrap (and
    so both servers, which build it from the environment) passes it on."""
    assert serving_dtype() == torch.float32
    assert serving_dtype("bf16") == serving_dtype(torch.bfloat16) == torch.bfloat16
    with pytest.raises(ValueError):
        serving_dtype("fp16")
    with pytest.raises(ValueError):
        serving_dtype(torch.float16)
    monkeypatch.setenv("VITS_TPU_DTYPE", "fp16")
    with pytest.raises(ValueError, match="VITS_TPU_DTYPE"):
        TEmoVITS(deploy[0], device="cpu")
    monkeypatch.setenv("VITS_TPU_DTYPE", "bf16")
    tts = VITSWrap(deploy[0], device="cpu")
    assert tts.speecher.compute_dtype == torch.bfloat16
    assert tts.speecher.synth.enc_p.emb["0"].weight.dtype == torch.bfloat16
    out = tts.speaking({"text": "bf16 through the wrapper.", "spkid": 1,
                        "emotion": np.zeros(1024, np.float32)})
    assert out["wav"][:4] == b"RIFF" and len(out["wav"]) > 44
    assert VITSWrap(deploy[0], device="cpu", compute_dtype="fp32").speecher.compute_dtype \
        == torch.float32
    with pytest.raises(ValueError, match="fp32"):  # AOT programs are fp32, as JAX's are
        TEmoVITS(deploy[0], device="cpu", aot=True)
