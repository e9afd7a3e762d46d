"""The port's synthesizer and two-phase serving against the JAX package on
the CPU, with the JAX `init_params` weights carried across by
`vits_tpu_torch.convert.params_from_jax`.

Tolerances: phase-1 outputs and the float waveform atol 1e-4 (fp32, sums in
another order); int8 waveform correlation with the JAX int8 waveform
> 0.999 (identical integer products; a quantized value may move by one step
where float rounding differs); calibration scales rtol 1e-4 and weight scales
rtol 1e-5. The `slow` full-size test uses test_fullsize_parity.py's
tolerances: phase 1 atol 5e-4, float waveform atol 2e-3 with corr > 0.99999.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vits_tpu.config import default_config_path as jax_default_config_path
from vits_tpu.config import get_hparams_from_file as jax_get_hparams
from vits_tpu.models.synthesizer import Synthesizer as JSynth
from vits_tpu.nn.core import fold_weight_norm
from vits_tpu.ops.seq import infer_path as jax_infer_path
from vits_tpu.utils import checkpoint as jax_ckpt

from vits_tpu_torch.convert import params_from_jax
from vits_tpu_torch.models.synthesizer import Synthesizer as TSynth

TINY_JSON = {
    "train": {"segment_size": 64},
    "data": {"text_channels": 16, "sampling_rate": 1600, "filter_length": 64,
             "hop_length": 8, "win_length": 64, "n_mel_channels": 20, "n_speakers": 8,
             "noise_scale": 0.707, "max_text_len": 384},
    "model": {"inter_channels": 8, "hidden_channels": 16, "filter_channels": 24,
              "n_heads": 2, "n_layers": 2, "kernel_size": 3, "p_dropout": 0.1,
              "ffn": "FFN2", "resblock": "2", "resblock_kernel_sizes": [3, 5],
              "resblock_dilation_sizes": [[1, 3], [1, 3, 5]], "upsample_rates": [4, 2],
              "upsample_initial_channel": 64, "upsample_kernel_sizes": [8, 4],
              "kernel_size_q": 5, "n_layers_q": 3, "hidden_size_d": 16,
              "kernel_size_d": 5, "p_dropout_d": 0.5, "act_func_d": "ReLU",
              "dilation_rate": [1, 1], "n_flows": 2, "gin_channels": 16},
}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _t(a, dtype=torch.float32):
    return torch.tensor(np.asarray(a), dtype=dtype)


def _corr(a, b):
    return float(np.corrcoef(np.ravel(a), np.ravel(b))[0, 1])


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    d = tmp_path_factory.mktemp("deploy")
    with open(d / "config.json", "w") as f:
        json.dump(TINY_JSON, f)
    hps = jax_get_hparams(str(d / "config.json"))
    js = JSynth.from_hps(hps)
    params = _np(jax.jit(js.init_params)(jax.random.PRNGKey(7)))
    jax_ckpt.save_checkpoint(str(d / "checkpoint.npz"), {"model": params})
    with open(d / "spk.map", "w") as f:
        f.write("# map\n10000 3\n")
    np.random.RandomState(5).randn(2, 1024).astype(np.float32).tofile(str(d / "3.emo"))
    ts = params_from_jax(params, TSynth.from_hps(hps)).eval()
    return str(d), js, fold_weight_norm(params), ts, params


def _inputs(rng, B=2, T=13, lens=(13, 8)):
    x = rng.randn(B, T, 16).astype(np.float32)
    emo = rng.randn(B, 1024).astype(np.float32)
    sid = np.array([1, 5], np.int32)[:B]
    xm = (np.arange(T)[None, :, None] < np.asarray(lens)[:, None, None]).astype(np.float32)
    return x, emo, sid, xm


def test_infer_p1_p2_float_and_int8(tiny):
    _, js, p, ts, _ = tiny
    rng = np.random.RandomState(0)
    x, emo, sid, xm = _inputs(rng)
    p1_j = jax.jit(lambda p, x, e, s, m: js.infer_p1(p, x, e, s, x_mask=m))(
        p, jnp.asarray(x), jnp.asarray(emo), jnp.asarray(sid), jnp.asarray(xm))
    p1_t = ts.infer_p1(_t(x), _t(emo), _t(sid, torch.long), x_mask=_t(xm))
    for a, b in zip(p1_j, p1_t):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-4, rtol=0)

    m_p, s_p, logw, g = p1_j
    w = np.ceil(np.exp(np.asarray(logw))[..., 0] * xm[..., 0])
    t_y = 64
    y_len = np.minimum(w.sum(1), t_y)
    attn = np.asarray(jax_infer_path(jnp.asarray(w), t_y))
    ym = (np.arange(t_y)[None, :, None] < y_len[:, None, None]).astype(np.float32)
    noise = (rng.randn(2, t_y, 8) * 0.707).astype(np.float32)
    args_j = (jnp.asarray(attn), m_p, s_p, g, jnp.asarray(noise), jnp.asarray(ym))
    args_t = (_t(attn), *p1_t[:2], p1_t[3], _t(noise), _t(ym))

    wav_j = jax.jit(lambda p, a, m, s, g, n, y: js.infer_p2(p, a, m, s, g, n, y_mask=y))(
        p, *args_j)
    wav_t = ts.infer_p2(*args_t[:5], y_mask=args_t[5])
    np.testing.assert_allclose(wav_t.numpy(), np.asarray(wav_j), atol=1e-4, rtol=0)

    # int8: calibrate on the float latent, quantize, decode
    z_j = jax.jit(lambda p, a, m, s, g, n, y: js.flow.apply(
        p["flow"], jnp.einsum("byx,bxc->byc", a, m) + n * jnp.einsum("byx,bxc->byc", a, s),
        y, g=g, reverse=True) * y)(p, *args_j)
    dq_j = js.quantize_decoder(p, z_j, g, args_j[5])
    z_t = ts.latent(*args_t[:5], args_t[5])
    np.testing.assert_allclose(z_t.numpy(), np.asarray(z_j), atol=1e-4, rtol=0)
    dq_t = ts.quantize_decoder(z_t, p1_t[3], args_t[5])

    np.testing.assert_allclose(float(dq_t["pre"]["s_in"]), float(dq_j["pre_q8"]["s_in"]),
                               rtol=1e-4)
    np.testing.assert_allclose(dq_t["pre"]["s_w"].numpy(), np.asarray(dq_j["pre_q8"]["s_w"]),
                               rtol=1e-5)
    for i, q in dq_t["ups"].items():
        jq = dq_j["ups_q8"][i]
        np.testing.assert_allclose(float(q["s_in"]), float(jq["s_in"]), rtol=1e-4)
        s_j = np.asarray(jq["s_w"]).reshape(-1, q["s_w"].shape[1])
        np.testing.assert_allclose(np.tile(q["s_w"].numpy(), (s_j.shape[0] // q["s_w"].shape[0],
                                                               1)), s_j, rtol=1e-5)
    for idx, chain in dq_t["resblocks"].items():
        for i, it in enumerate(chain["iters"]):
            for tag, key in (("c1", "1"), ("c2", "2")):
                jq = dq_j["resblocks"][idx][f"{tag}_{i}"]
                np.testing.assert_allclose(float(it[f"s_in{key}"]), float(jq["s_in"]),
                                           rtol=1e-4)
                s_j = np.asarray(jq["s_w"])
                np.testing.assert_allclose(
                    np.tile(it[f"s_w{key}"].numpy(), s_j.size // it[f"s_w{key}"].numel()),
                    s_j, rtol=1e-5)
    np.testing.assert_allclose(dq_t["post"]["s_w"].numpy(),
                               np.asarray(dq_j["post_q8"]["s_w"])[:1], rtol=1e-5)

    wq_j = jax.jit(lambda p, d, a, m, s, g, n, y: js.infer_p2(p, a, m, s, g, n, y_mask=y,
                                                              dec_q8=d))(p, dq_j, *args_j)
    wq_t = ts.infer_p2(*args_t[:5], y_mask=args_t[5], dec_q8=dq_t)
    assert _corr(wq_t.numpy(), wq_j) > 0.999
    assert _corr(wq_t.numpy(), wav_t.numpy()) > 0.99


@pytest.mark.parametrize("quantize", [False, True])
def test_emovits_serving_matches_jax(tiny, monkeypatch, quantize):
    """Both engines serve one checkpoint dir written by the JAX package, with
    the same np.random seed per request (emotion-bank pick and noise-ring
    start). With quantize, 2 calibration requests freeze the int8 decoder."""
    d, _, _, _, params = tiny
    monkeypatch.setenv("VITS_TPU_FUSED", "0")
    monkeypatch.setenv("VITS_TPU_Q8_CALIB_REQUESTS", "2")
    # the JAX engine builds its checkpoint template with an eager init_params;
    # the fixture's tree has the same structure (values come from the file)
    monkeypatch.setattr(JSynth, "init_params", lambda self, key: params)
    from vits_tpu.infer import EmoVITS as JEmoVITS
    from vits_tpu_torch.infer import EmoVITS as TEmoVITS
    ckpt = os.path.join(d, "checkpoint.npz")
    jm = JEmoVITS(ckpt, quantize=quantize)
    tm = TEmoVITS(ckpt, device="cpu", quantize=quantize)
    assert tm.spkid_mapping == {10000: 3} and tm.q8_calib_requests == 2
    rng = np.random.RandomState(11)
    # one text bucket (32) and short outputs keep the JAX engine's compiles few
    requests = [(10000, rng.randn(12, 16).astype(np.float32), None, 1.0),
                (2, rng.randn(14, 16).astype(np.float32), rng.randn(1024).astype(np.float32),
                 1.2),
                (10000, rng.randn(11, 16).astype(np.float32), (3, 1), 0.9),
                (4, rng.randn(13, 16).astype(np.float32), rng.randn(1024).astype(np.float32),
                 1.1)]
    for i, (spk, text, emo, rate) in enumerate(requests):
        np.random.seed(100 + i)
        wav_j, emo_j = jm.infer(spk, text, emo, duration_rate=rate)
        np.random.seed(100 + i)
        wav_t, emo_t = tm.infer(spk, text, emo, duration_rate=rate)
        np.testing.assert_array_equal(emo_t, emo_j)
        assert wav_t.shape == wav_j.shape and np.all(np.isfinite(wav_t))
        if quantize and i >= 1:  # request 1 freezes the scales and decodes in int8
            assert (tm.dec_q8 is not None) == (jm.dec_q8 is not None)
            assert tm.dec_q8 is not None
            assert _corr(wav_t, wav_j) > 0.999
        else:
            np.testing.assert_allclose(wav_t, wav_j, atol=1e-4, rtol=0)
    # the bank/map reload
    with open(os.path.join(d, "spk.map"), "w") as f:
        f.write("10000 5\n")
    os.utime(os.path.join(d, "spk.map"), (0, 2_000_000_000))
    tm.update()
    assert tm.spkid_mapping[10000] == 5
    with open(os.path.join(d, "spk.map"), "w") as f:
        f.write("# map\n10000 3\n")


def test_cli_main_cpu(tiny, tmp_path):
    d = tiny[0]
    from vits_tpu_torch.infer import main
    vec = tmp_path / "utt1.vec"
    np.random.RandomState(3).randn(11, 16).astype(np.float32).tofile(str(vec))
    scp = tmp_path / "list.scp"
    scp.write_text(f"{vec}|10000\n")
    main(["--scp", str(scp), "--outdir", str(tmp_path / "out"), "--device", "cpu",
          "--checkpoint", os.path.join(d, "checkpoint.npz"), "--verbose", "0"])
    wav = (tmp_path / "out" / "utt1.wav").read_bytes()
    assert wav[:4] == b"RIFF" and len(wav) > 44


@pytest.mark.slow
def test_fullsize_base_config_parity():
    """configs/base.json at full width: phase 1 and the float decode of the
    port against the JAX package on the same weights."""
    hps = jax_get_hparams(jax_default_config_path("base"))
    js = JSynth.from_hps(hps)
    params = fold_weight_norm(_np(jax.jit(js.init_params)(jax.random.PRNGKey(0))))
    ts = params_from_jax(params, TSynth.from_hps(hps)).eval()
    rng = np.random.RandomState(123)
    T_x = 64
    x = rng.randn(1, T_x, hps.data.text_channels).astype(np.float32)
    emo = rng.randn(1, 1024).astype(np.float32)
    sid = np.array([1234], np.int32)
    p1_j = jax.jit(js.infer_p1)(params, jnp.asarray(x), jnp.asarray(emo), jnp.asarray(sid))
    p1_t = ts.infer_p1(_t(x), _t(emo), _t(sid, torch.long))
    for a, b in zip(p1_j, p1_t):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=5e-4, rtol=0)
    m_p, s_p, logw, g = p1_j
    w = np.minimum(np.ceil(np.exp(np.asarray(logw))[..., 0]), 4.0)
    t_y = max(int(w.sum()), 1)
    attn = np.asarray(jax_infer_path(jnp.asarray(w), t_y))
    noise = (rng.randn(1, t_y, hps.model.inter_channels) * hps.data.noise_scale).astype(
        np.float32)
    wav_j = np.asarray(jax.jit(js.infer_p2)(params, jnp.asarray(attn), m_p, s_p, g,
                                            jnp.asarray(noise)))
    wav_t = ts.infer_p2(_t(attn), p1_t[0], p1_t[1], p1_t[3], _t(noise)).numpy()
    np.testing.assert_allclose(wav_t, wav_j, atol=2e-3, rtol=0)
    assert _corr(wav_t, wav_j) > 0.99999
