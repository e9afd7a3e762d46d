"""The port's serving engine against the JAX package on the CPU: the fused
default of `EmoVITS.infer` (float and int8), its two-phase fallback,
`infer_stream`, `Synthesizer.stream_decode`, and `.pth` checkpoints. Both
engines serve one deployment directory written by the JAX package at TINY,
with the same `np.random` seed per request (the emotion-bank pick, then the
noise-ring start). One text bucket (32 tokens) keeps the JAX compiles few.

Tolerances: float waveforms atol 1e-4 against the JAX package (fp32, sums
in another order), 1e-5 between two paths of the port, 1e-6 between two
loads of the same weights; int8 waveform correlation > 0.999 (identical
integer products; a quantized value may move by one step where float
rounding differs).

Two defects of the reference are pinned, not copied: its fused fallback
resolves the speaker a second time (a chained speaker map moves it to
another speaker), and its frame budget floors to 0 when the frame quantum
passes the noise ring.
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch

import jax

from test_infer_wrap import TINY_JSON
from vits_tpu.config import get_hparams_from_file as jax_get_hparams
from vits_tpu.infer import EmoVITS as JEmoVITS
from vits_tpu.models.synthesizer import Synthesizer as JSynth
from vits_tpu.nn.core import fold_weight_norm
from vits_tpu.utils import checkpoint as jax_ckpt
from vits_tpu.utils.torch_compat import save_torch_checkpoint

from vits_tpu_torch.config import get_hparams_from_file
from vits_tpu_torch.infer import EmoVITS as TEmoVITS
from vits_tpu_torch.utils import torch_compat

T_TOKENS = 20  # one text bucket; budget 8 x 20 -> 192 frames


@pytest.fixture(scope="module")
def deploy(tmp_path_factory):
    d = tmp_path_factory.mktemp("deploy")
    with open(d / "config.json", "w") as f:
        json.dump(TINY_JSON, f)
    js = JSynth.from_hps(jax_get_hparams(str(d / "config.json")))
    params = jax.tree_util.tree_map(
        np.asarray, jax.device_get(jax.jit(js.init_params)(jax.random.PRNGKey(7))))
    jax_ckpt.save_checkpoint(str(d / "checkpoint.npz"), {"model": params})
    with open(d / "spk.map", "w") as f:
        f.write("# map\n10000 3\n")
    np.random.RandomState(5).randn(2, 1024).astype(np.float32).tofile(str(d / "3.emo"))
    return str(d), js, params


@pytest.fixture
def jax_init(deploy, monkeypatch):
    """The JAX engine builds its checkpoint template with an eager
    init_params; the fixture's tree has the same structure."""
    monkeypatch.setattr(JSynth, "init_params", lambda self, key: deploy[2])


@pytest.fixture(autouse=True)
def serving_env(monkeypatch):
    for k in ("VITS_TPU_FUSED", "VITS_TPU_FUSED_Q8", "VITS_TPU_FUSED_FRAMES_PER_TOKEN",
              "VITS_TPU_Q8_CALIB_REQUESTS", "VITS_TPU_QUANTIZE", "VITS_TPU_AOT"):
        monkeypatch.delenv(k, raising=False)


def _ckpt(deploy):
    return os.path.join(deploy[0], "checkpoint.npz")


def _corr(a, b):
    return float(np.corrcoef(np.ravel(a), np.ravel(b))[0, 1])


def _seeded(seed, fn, *a, **k):
    np.random.seed(seed)
    return fn(*a, **k)


@pytest.mark.parametrize("decoder", ["float", "int8"])
def test_synthesizer_inference_matches_jax(deploy, decoder):
    """`Synthesizer.inference` at B = 2 with ragged text lengths and the
    same pre-scaled noise: the alignment built on the device, the clipped
    output lengths and the waveform agree with the JAX package's, with the
    float decoder (atol 1e-4) and the int8 one (each package calibrated on
    its own latent; correlation > 0.999). A noise draw from a generator is
    the same draw passed as a tensor."""
    _, js, params = deploy
    p = fold_weight_norm(params)
    ts = TEmoVITS(_ckpt(deploy), device="cpu").synth
    rng = np.random.RandomState(31)
    x = rng.randn(2, 32, 16).astype(np.float32)
    x_len = np.array([T_TOKENS, 5], np.int32)
    emo = rng.randn(2, 1024).astype(np.float32)
    sid = np.array([1, 6], np.int32)
    max_frames = 16  # clips the first utterance (23 frames), not the second
    noise = (rng.randn(2, max_frames, 8) * 0.707).astype(np.float32)

    def jax_run(dec_q8=None):
        return jax.jit(lambda p, d, *a: js.inference(p, None, *a, max_frames=max_frames,
                                                     noise=noise, dec_q8=d))(
            p, dec_q8, x, x_len, emo, sid)

    def port_run(dec_q8=None, **kw):
        args = [torch.from_numpy(a) for a in (x, x_len, emo)] + [torch.from_numpy(sid).long()]
        return ts.inference(*args, max_frames=max_frames, dec_q8=dec_q8,
                            **(kw or {"noise": torch.from_numpy(noise)}))

    o_j, attn_j, ym_j, lat_j = jax_run()
    o_t, attn_t, ym_t, lat_t = port_run()
    np.testing.assert_array_equal(attn_t.numpy(), np.asarray(attn_j))
    np.testing.assert_array_equal(ym_t.numpy(), np.asarray(ym_j))
    lengths = ym_t[..., 0].sum(1).numpy()
    assert lengths[0] == max_frames > lengths[1] > 0
    if decoder == "float":
        np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), atol=1e-4, rtol=0)
        gen = torch.Generator().manual_seed(3)
        drawn = port_run(generator=gen, noise_scale=0.707)[0]
        gen.manual_seed(3)
        given = port_run(noise=torch.randn(2, max_frames, 8, generator=gen) * 0.707)[0]
        assert torch.equal(drawn, given)
        return
    ym = np.asarray(ym_j)
    dq_j = js.quantize_decoder(p, lat_j[0] * ym, jax.numpy.asarray(
        js.emb_g.apply(p["emb_g"], sid)), jax.numpy.asarray(ym))
    with torch.no_grad():
        dq_t = ts.quantize_decoder(lat_t[0] * ym_t, ts.emb_g(torch.from_numpy(sid).long()), ym_t)
    oq_t = port_run(dec_q8=dq_t)[0].numpy()
    oq_j = np.asarray(jax_run(dq_j)[0])
    assert _corr(oq_t, oq_j) > 0.999
    assert _corr(oq_t, o_t.numpy()) > 0.99


def test_fused_float_matches_jax(deploy, jax_init):
    jm = JEmoVITS(_ckpt(deploy))
    tm = TEmoVITS(_ckpt(deploy), device="cpu")
    assert tm._prefer_fused and tm.inference == tm.infer
    budget = tm.fused_frames(T_TOKENS)
    rng = np.random.RandomState(21)
    requests = [(10000, rng.randn(T_TOKENS, 16).astype(np.float32), None),  # bank pick
                (2, rng.randn(T_TOKENS, 16).astype(np.float32),
                 rng.randn(1024).astype(np.float32))]
    for i, (spk, text, emo) in enumerate(requests):
        wav_j, emo_j = _seeded(300 + i, jm.infer_fused, spk, text, emo)
        wav_t, emo_t = _seeded(300 + i, tm.infer_fused, spk, text, emo)
        np.testing.assert_array_equal(emo_t, emo_j)
        assert 0 < len(wav_t) < budget * tm.hop_size  # the fused pass served it
        np.testing.assert_allclose(wav_t, wav_j, atol=1e-4, rtol=0)
        wav_2p, _ = _seeded(300 + i, tm._infer_two_phase, spk, text, emo)
        assert len(wav_2p) == len(wav_t)  # the same durations drive both paths


def test_fused_int8_matches_jax(deploy, jax_init, monkeypatch):
    """Two calibration requests (two-phase, float decoder) freeze the int8
    decoder; with VITS_TPU_FUSED_Q8=1 the next request runs the fused pass
    with the int8 decoder in both packages."""
    monkeypatch.setenv("VITS_TPU_Q8_CALIB_REQUESTS", "2")
    jm = JEmoVITS(_ckpt(deploy), quantize=True)
    tm = TEmoVITS(_ckpt(deploy), device="cpu", quantize=True)
    rng = np.random.RandomState(23)
    requests = [(2 + i, rng.randn(T_TOKENS, 16).astype(np.float32),
                 rng.randn(1024).astype(np.float32)) for i in range(3)]
    fused_q8 = []
    orig = tm.synth.inference_decode
    monkeypatch.setattr(tm.synth, "inference_decode", lambda *a, **k: fused_q8.append(
        k.get("dec_q8") is not None) or orig(*a, **k))
    for i, (spk, text, emo) in enumerate(requests[:2]):
        wav_j, _ = _seeded(400 + i, jm.infer, spk, text, emo)
        wav_t, _ = _seeded(400 + i, tm.infer, spk, text, emo)
        np.testing.assert_allclose(wav_t, wav_j, atol=1e-4, rtol=0)
    assert tm.dec_q8 is not None and jm.dec_q8 is not None and fused_q8 == []
    spk, text, emo = requests[2]
    wav_f, _ = _seeded(402, tm.infer, spk, text, emo)  # fused, float decoder (default)
    monkeypatch.setenv("VITS_TPU_FUSED_Q8", "1")
    wav_j, _ = _seeded(402, jm.infer, spk, text, emo)
    wav_t, _ = _seeded(402, tm.infer, spk, text, emo)
    assert fused_q8 == [False, True]
    assert wav_t.shape == wav_j.shape == wav_f.shape
    assert _corr(wav_t, wav_j) > 0.999
    assert _corr(wav_t, wav_f) > 0.99


def test_fused_fallback_is_the_two_phase_request(deploy, jax_init, monkeypatch):
    """A budget of 0.1 frames a token (one 16-frame quantum) clips the
    request: it is served again two-phase, as long as two-phase serves it
    and equal to the JAX package's fallback (an explicit emotion vector, so
    neither package draws a bank index)."""
    tm = TEmoVITS(_ckpt(deploy), device="cpu", frame_quantum=16)
    jm = JEmoVITS(_ckpt(deploy), frame_quantum=16)
    rng = np.random.RandomState(25)
    text = rng.randn(T_TOKENS, 16).astype(np.float32)
    emo = rng.randn(1024).astype(np.float32)
    wav_2p, _ = _seeded(5, tm._infer_two_phase, 2, text, emo)
    monkeypatch.setenv("VITS_TPU_FUSED_FRAMES_PER_TOKEN", "0.1")
    assert tm.fused_frames(T_TOKENS) == 16 < len(wav_2p) // tm.hop_size
    fallbacks = []
    orig = tm._two_phase
    monkeypatch.setattr(tm, "_two_phase", lambda *a: fallbacks.append(a[0]) or orig(*a))
    wav_t, _ = _seeded(6, tm.infer_fused, 2, text, emo)
    wav_j, _ = _seeded(6, jm.infer_fused, 2, text, emo)
    assert fallbacks == [2]
    assert len(wav_t) == len(wav_2p)
    np.testing.assert_allclose(wav_t, wav_j, atol=1e-4, rtol=0)


def test_fused_fallback_resolves_the_speaker_once(deploy, jax_init, tmp_path, monkeypatch):
    """With a chained map (10000 -> 3, 3 -> 5) the port's fallback serves
    speaker 3, as the fused pass does; the reference's serves 5 (it passes
    the remapped id to a path that remaps it again)."""
    for f in ("config.json", "checkpoint.npz"):
        shutil.copy(os.path.join(deploy[0], f), tmp_path / f)
    (tmp_path / "spk.map").write_text("10000 3\n3 5\n")
    monkeypatch.setenv("VITS_TPU_FUSED_FRAMES_PER_TOKEN", "0.1")
    rng = np.random.RandomState(27)
    text = rng.randn(T_TOKENS, 16).astype(np.float32)
    emo = rng.randn(1024).astype(np.float32)
    served = {}
    for name, cls, kw in (("port", TEmoVITS, {"device": "cpu"}), ("jax", JEmoVITS, {})):
        m = cls(str(tmp_path / "checkpoint.npz"), frame_quantum=16, **kw)
        orig = m._run_phase1
        monkeypatch.setattr(m, "_run_phase1", lambda spkid, *a, _o=orig, _n=name: (
            served.setdefault(_n, []).append(spkid) or _o(spkid, *a)))
        wav, _ = _seeded(7, m.infer_fused, 10000, text, emo)
        assert len(wav) > 16 * m.hop_size
    assert served == {"port": [3], "jax": [5]}


def test_frame_quantum_past_the_noise_ring_is_refused(deploy):
    """The reference floors its fused budget to 0 frames there; the port
    refuses the engine."""
    with pytest.raises(ValueError, match="noise ring"):
        TEmoVITS(_ckpt(deploy), device="cpu", frame_quantum=8192)
    tm = TEmoVITS(_ckpt(deploy), device="cpu", frame_quantum=4096)
    assert tm.ring_frames == 4096
    assert tm.fused_frames(1) == tm.fused_frames(10 ** 4) == 4096


def test_infer_dispatches_to_fused(deploy, monkeypatch):
    """infer() routes to infer_fused by default; VITS_TPU_FUSED=0 restores
    two-phase; int8 serving stays two-phase until its calibration freezes."""
    rng = np.random.RandomState(3)
    text = rng.randn(17, 16).astype(np.float32)
    emo = rng.randn(1024).astype(np.float32)

    def spy(m):
        calls = []
        orig = m.infer_fused
        monkeypatch.setattr(m, "infer_fused", lambda *a, **k: calls.append(1) or orig(*a, **k))
        return calls

    tm = TEmoVITS(_ckpt(deploy), device="cpu")
    calls = spy(tm)
    wav, _ = tm.infer(1, text, emo)
    assert calls and np.all(np.isfinite(wav))
    monkeypatch.setenv("VITS_TPU_FUSED", "0")
    tm_2p = TEmoVITS(_ckpt(deploy), device="cpu")
    calls = spy(tm_2p)
    wav_2p, _ = tm_2p.infer(1, text, emo)
    assert not tm_2p._prefer_fused and not calls and len(wav_2p) == len(wav)
    monkeypatch.delenv("VITS_TPU_FUSED")
    tm_q = TEmoVITS(_ckpt(deploy), device="cpu", quantize=True)
    calls = spy(tm_q)
    wav_q, _ = tm_q.infer(1, text, emo)
    assert tm_q._prefer_fused and tm_q.dec_q8 is None and not calls
    assert np.all(np.isfinite(wav_q))


def test_infer_stream_matches_two_phase_and_jax(deploy, jax_init):
    """frame_quantum 16 keeps the two-phase padding (and so the seeded noise
    slice) equal to the stream's while forcing several decode windows."""
    tm = TEmoVITS(_ckpt(deploy), device="cpu", frame_quantum=16)
    jm = JEmoVITS(_ckpt(deploy), frame_quantum=16)
    rng = np.random.RandomState(11)
    text = rng.randn(37, 16).astype(np.float32)
    emo = rng.randn(1024).astype(np.float32)
    wav, _ = _seeded(99, tm._infer_two_phase, 2, text, emo)
    chunks = _seeded(99, lambda: list(tm.infer_stream(2, text, emo)))
    assert len(chunks) > 2, "expected several decode windows"
    streamed = np.concatenate(chunks)
    assert streamed.shape == wav.shape
    np.testing.assert_allclose(streamed, wav, atol=1e-5, rtol=0)
    chunks_j = _seeded(99, lambda: list(jm.infer_stream(2, text, emo)))
    assert [len(c) for c in chunks_j] == [len(c) for c in chunks]
    np.testing.assert_allclose(streamed, np.concatenate(chunks_j), atol=1e-4, rtol=0)


@pytest.mark.parametrize("halo", [24, 0], ids=["halo24_equals_full", "halo0_differs"])
def test_stream_decode(deploy, halo):
    """stream_decode equals a full decode with a halo over the receptive
    radius (and the JAX package's stream_decode); without one the seams
    show."""
    _, js, params = deploy
    tm = TEmoVITS(_ckpt(deploy), device="cpu")
    rng = np.random.RandomState(halo)
    z = rng.randn(2, 100, 8).astype(np.float32)
    sid = np.array([0, 1])
    with torch.no_grad():
        g = tm.synth.emb_g(torch.from_numpy(sid))
        full = tm.synth.dec(torch.from_numpy(z), g=g).numpy()
    streamed = tm.synth.stream_decode(torch.from_numpy(z), g=g, chunk_frames=32,
                                      halo=halo).numpy()
    assert streamed.shape == full.shape
    if halo:
        np.testing.assert_allclose(streamed, full, atol=1e-6, rtol=0)
        g_j = js.emb_g.apply(params["emb_g"], sid)
        ref = np.asarray(js.stream_decode(params, z, g=g_j, chunk_frames=32, halo=halo))
        np.testing.assert_allclose(streamed, ref, atol=1e-4, rtol=0)
    else:
        assert float(np.abs(streamed - full).max()) > 1e-4


def test_pth_template_is_the_jax_tree(deploy):
    """The slots a .pth fills are the JAX package's init_params tree: the
    same leaf paths and shapes."""
    hps = get_hparams_from_file(os.path.join(deploy[0], "config.json"))

    def leaves(tree, prefix=()):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from leaves(v, prefix + (k,))
            else:
                yield prefix + (k,), tuple(np.shape(v))

    assert dict(leaves(torch_compat.params_template(hps))) == dict(leaves(deploy[2]))


def test_pth_checkpoint_serves_like_npz(deploy, jax_init, tmp_path):
    """A .pth written by the JAX package's save_torch_checkpoint serves what
    the .npz of the same params serves, and what the JAX engine serves from
    the same .pth."""
    for f in ("config.json", "spk.map", "3.emo"):
        shutil.copy(os.path.join(deploy[0], f), tmp_path / f)
    pth = str(tmp_path / "G_1.pth")
    save_torch_checkpoint(pth, deploy[2], iteration=1)
    t_pth = TEmoVITS(pth, device="cpu")
    t_npz = TEmoVITS(_ckpt(deploy), device="cpu")
    j_pth = JEmoVITS(pth)
    rng = np.random.RandomState(29)
    requests = [(10000, rng.randn(T_TOKENS, 16).astype(np.float32), None),
                (6, rng.randn(T_TOKENS, 16).astype(np.float32),
                 rng.randn(1024).astype(np.float32))]
    for i, (spk, text, emo) in enumerate(requests):
        wav, emo_t = _seeded(500 + i, t_pth.infer, spk, text, emo)
        wav_npz, _ = _seeded(500 + i, t_npz.infer, spk, text, emo)
        wav_j, emo_j = _seeded(500 + i, j_pth.infer, spk, text, emo)
        np.testing.assert_allclose(wav, wav_npz, atol=1e-6, rtol=0)
        np.testing.assert_array_equal(emo_t, emo_j)
        np.testing.assert_allclose(wav, wav_j, atol=1e-4, rtol=0)
