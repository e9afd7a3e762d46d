"""The port's stft/MRD training step against the JAX package's at TINY on the
CPU (`__graft_entry__._tiny_cfg()` with both dropout rates 0,
`tiny_step_config("stft")`, `tiny_mrd_disc()`, AdamW for G and RAdam for
D), from the same weights: the port's seeded initialisation (weight-norm
pairs, spectral-norm kernels and their u) carried to a JAX tree by
`params_to_jax`. The noise the JAX graph draws from its keys is rebuilt here
from the same keys. Each JAX step compiles once, at XLA's lowest backend
optimisation level, which only saves compile time, and the bf16 one on a
second thread beside the rest of the fixture.

fp32, tests/test_torch_train.py's tolerances: the MAS path EQUAL; losses
rtol 1e-4, atol 1e-6; every G and D gradient before the optimizer atol
1e-5 + 1e-3 of the tensor's largest magnitude; updated parameters atol 1e-6
+ 1e-4 relative, and up to 2 * lr where a G gradient element lies within
that tolerance of zero (AdamW's first update is about lr * sign(g); RAdam's
first five are the momentum step lr * m_hat, here lr * g, so D needs no such
allowance); every updated spectral-norm u atol 1e-6 + 1e-4 relative, and
every u of more than one element has moved.

bf16, tests/test_torch_bf16_train.py's rule (the yardstick of each
tolerance is JAX's own bf16 rounding, its distance to the port's float32
step, with the noise factor C = 4): the MAS path EQUAL; each loss and
gradient norm |port - jax| <= C |jax - f32| + 2^-8 |jax|; each gradient
tensor ||port - jax|| <= C ||jax - f32|| + 2^-7 ||jax||; with that tensor's
elementwise gradient tolerance g_tol = C max|jax - f32| + 2^-7 max|jax|,
updated parameters atol 1e-6 + 1e-4 relative plus, for G, 2 * lr where JAX's
gradient element lies within g_tol of zero (Adam's first step) and, for D,
lr * g_tol (RAdam's momentum step moves a parameter by lr * g, so by lr
times its gradient's error); each updated u atol 1e-6 + 1e-4 relative plus C
max|jax - f32|. The port's CPU steps run with oneDNN off (see that file's
docstring).
"""

import dataclasses
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_bf16_train import C, _noise as _noise_dtype
from test_torch_train import (FAST_COMPILE, LR, _batch, _cfg, _np, _Probe, _torch_batch,  # noqa: F401
                              one_torch_thread)
from vits_tpu.models.synthesizer import Synthesizer as JSynth
from vits_tpu.train.optim import Optimizer as JOptimizer
from vits_tpu.train.step import make_train_step as j_make_train_step
from vits_tpu.utils.tiny import TINY_RESOLUTIONS, tiny_mrd_disc, tiny_step_config

from vits_tpu_torch.convert import params_from_jax, params_to_jax, state_from_jax
from vits_tpu_torch.models.mrd import MultiWaveSTFTDiscriminator as TMRD
from vits_tpu_torch.models.synthesizer import Synthesizer as TSynth
from vits_tpu_torch.nn.core import init_weights
from vits_tpu_torch.train.optim import Optimizer as TOptimizer
from vits_tpu_torch.train.step import TrainStepConfig, make_train_step

LOSS_KEYS = ("loss_disc", "loss_gen", "loss_stft", "loss_dur", "loss_kl", "loss_kl_q",
             "loss_g_total", "grad_norm_d", "grad_norm_g")
VEC_KEYS = ("losses_d_r", "losses_d_g", "losses_g")


def tiny_mrd():
    """The port's twin of `vits_tpu.utils.tiny.tiny_mrd_disc()`."""
    return TMRD(num_dwt=2, wave_layers=4, fft_sizes=(64, 32), hop_sizes=(16, 8),
                win_sizes=(64, 32), stft_num_layers=(3, 3), stft_kernel_sizes=(3, 3),
                stft_conv_channels=(8, 8))


def port_cfg(dtype=torch.float32, **kw):
    """`tiny_step_config("stft")` as the port's TrainStepConfig."""
    c = tiny_step_config("stft")
    return TrainStepConfig(segment_frames=c.segment_frames, hop_length=c.hop_length,
                           filter_length=c.filter_length, win_length=c.win_length,
                           n_mel_channels=c.n_mel_channels, sampling_rate=c.sampling_rate,
                           compute_dtype=dtype, variant="stft", **kw)


def tiny_weights(seed=5):
    """JAX trees of the port's seeded TINY synthesizer and MRD."""
    gen = torch.Generator().manual_seed(seed)
    gp = params_to_jax(init_weights(TSynth(**_cfg(), weight_norm=True), gen).state_dict())
    dp = params_to_jax(init_weights(tiny_mrd(), gen).state_dict())
    return gp, dp


J_OPTS = (JOptimizer("adamw", (0.8, 0.99), 1e-9, 0.01), JOptimizer("radam", (0.8, 0.99), 1e-9, 0.0))


def _j_step(dtype):
    """The JAX stft step in `dtype`, jitted, its optimizers probed."""
    cfg = dataclasses.replace(tiny_step_config("stft"), compute_dtype=dtype)
    return jax.jit(j_make_train_step(JSynth(**_cfg()), tiny_mrd_disc(), cfg,
                                     *(_Probe(o) for o in J_OPTS)), compiler_options=FAST_COMPILE)


def _j_state(gp, dp):
    pg, pd = (_Probe(o) for o in J_OPTS)
    return {"gen": gp, "disc": dp, "gen_opt": pg.init(gp), "disc_opt": pd.init(dp),
            "step": jnp.zeros((), jnp.int32)}


def _j_run(fn, state, b, key):
    new, m = fn(state, {k: jnp.asarray(v) for k, v in b.items()}, key, LR, LR, 0.01)
    return _np(new), _np(m)


def _port_state(gp, dp):
    ts = params_from_jax(gp, TSynth(**_cfg(), weight_norm=True)).train()
    td = params_from_jax(dp, tiny_mrd()).train()
    return {"gen": ts, "disc": td,
            "gen_opt": TOptimizer((0.8, 0.99), 1e-9, 0.01).init(ts.parameters()),
            "disc_opt": TOptimizer((0.8, 0.99), 1e-9, 0.0, "radam").init(td.parameters()),
            "step": 0, "rng": None}


def _port_noise(key, b, dtype=torch.float32):
    rng_fwd, _ = jax.random.split(key)
    return _noise_dtype(rng_fwd, b["x"].shape[0], b["x"].shape[1], b["spec"].shape[1],
                        _cfg()["inter_channels"], dtype)


def _port_step(gp, dp, b, key, dtype, hooks=None):
    state = _port_state(gp, dp)
    ts, td = state["gen"], state["disc"]
    if hooks is not None:
        for name, mod in (("G", ts.dec.conv_pre), ("D", td.mwd), ("D", td.mfd.discriminators["0"])):
            mod.register_forward_hook(lambda m, a, o, _n=name: hooks.append((_n, a[0].dtype)))
    with torch.backends.mkldnn.flags(enabled=False):
        state, metrics = make_train_step(port_cfg(dtype))(state, _torch_batch(b),
                                                          _port_noise(key, b, dtype), LR, LR, 0.01)
    assert state["step"] == 1
    return ts, td, metrics


@pytest.fixture(scope="module")
def steps():
    """Each package's fp32 and bf16 step from the same weights, batch and key.
    The JAX bf16 step is traced and compiled on a second thread while the
    rest runs (XLA's compiler and torch's ops release the GIL)."""
    gp, dp = tiny_weights()
    b, key = _batch(), jax.random.PRNGKey(21)
    hooks = []
    with ThreadPoolExecutor(1) as pool:
        jax_bf16 = pool.submit(lambda: _j_run(_j_step(jnp.bfloat16), _j_state(gp, dp), b, key))
        fn = _j_step(jnp.float32)
        out = {"gp": gp, "dp": dp, "hooks": hooks, "fn_f32": fn,
               "jax_f32": _j_run(fn, _j_state(gp, dp), b, key),
               "port_f32": _port_step(gp, dp, b, key, torch.float32),
               "port_bf16": _port_step(gp, dp, b, key, torch.bfloat16, hooks)}
        out["jax_bf16"] = jax_bf16.result()
    return out


def _u(model):
    return {n: b for n, b in model.named_buffers() if n.endswith("weight_u")}


def test_stft_step_losses_match_jax(steps):
    _, m_j = steps["jax_f32"]
    _, _, m_t = steps["port_f32"]
    assert set(m_t) == set(m_j)
    assert not {"loss_mel", "loss_fm", "viz_mel_all"} & set(m_t)
    # the port's step takes the resolutions from the MRD, the JAX step from its config
    assert tiny_mrd().resolutions == tiny_step_config("stft").resolutions == TINY_RESOLUTIONS
    np.testing.assert_array_equal(m_t["viz_attn"].numpy(), m_j["viz_attn"])
    for k in LOSS_KEYS + VEC_KEYS:
        np.testing.assert_allclose(m_t[k].numpy(), m_j[k], rtol=1e-4, atol=1e-6, err_msg=k)
    assert m_t["losses_d_r"].shape == (4,)  # 2 wave levels + 2 resolutions
    for k in ("viz_mel_org", "viz_mel_gen"):
        assert m_t[k].shape == m_j[k].shape == (8, 20), k
        np.testing.assert_allclose(m_t[k].numpy(), m_j[k], rtol=1e-4, atol=1e-4, err_msg=k)


def test_stft_step_gradients_params_and_u_match_jax(steps):
    new_j, _ = steps["jax_f32"]
    ts, td, _ = steps["port_f32"]
    for model, opt_j, new_p, rule_lr in ((ts, new_j["gen_opt"], new_j["gen"], 2 * LR),
                                         (td, new_j["disc_opt"], new_j["disc"], 0.0)):
        keys = set(model.state_dict())
        grads = state_from_jax(opt_j[1], keys)
        params = state_from_jax(new_p, keys)
        for name, prm in model.named_parameters():
            g_j = grads[name].numpy()
            g_tol = 1e-5 + 1e-3 * float(np.abs(g_j).max())
            np.testing.assert_allclose(prm.grad.numpy(), g_j, atol=g_tol, rtol=0, err_msg=name)
            p_j = params[name].numpy()
            p_tol = 1e-6 + 1e-4 * np.abs(p_j) + np.where(np.abs(g_j) <= g_tol, rule_lr, 0.0)
            assert np.all(np.abs(prm.detach().numpy() - p_j) <= p_tol), name
    keys = set(td.state_dict())
    before = state_from_jax(steps["dp"], keys)
    after = state_from_jax(new_j["disc"], keys)
    us = _u(td)
    assert len(us) == 14  # every conv of the tiny MRD
    for name, u in us.items():
        # the JAX tree's u leaves get zero gradients; the port keeps u out of autograd
        assert np.all(state_from_jax(new_j["disc_opt"][1], keys)[name].numpy() == 0), name
        u_j = after[name].numpy()
        assert np.all(np.abs(u.numpy() - u_j) <= 1e-6 + 1e-4 * np.abs(u_j)), name
        if u.numel() > 1:
            assert not np.allclose(u_j, before[name].numpy(), atol=1e-3), name


def _within(port, jax_v, f32, rel):
    return abs(port - jax_v) <= C * abs(jax_v - f32) + rel * abs(jax_v)


def test_bf16_stft_step_matches_jax(steps):
    new_j, m_j = steps["jax_bf16"]
    ts, td, m_t = steps["port_bf16"]
    tf, tdf, m_f = steps["port_f32"]
    # the generator forward, the MRD's D pass (2B: its wave branch and first
    # resolution) and its G pass (B) ran in bf16
    assert steps["hooks"] == [("G", torch.bfloat16)] + [("D", torch.bfloat16)] * 4
    np.testing.assert_array_equal(m_t["viz_attn"].float().numpy(),
                                  np.asarray(m_j["viz_attn"], np.float32))
    for k in LOSS_KEYS:
        assert m_t[k].dtype == torch.float32, k
        p, j, f = float(m_t[k]), float(np.asarray(m_j[k], np.float32)), float(m_f[k])
        assert _within(p, j, f, 2 ** -8), (k, p, j, f)
    for k in VEC_KEYS:
        p, j, f = m_t[k].numpy(), np.asarray(m_j[k], np.float32), m_f[k].numpy()
        assert np.all(np.abs(p - j) <= C * np.abs(j - f) + 2 ** -8 * np.abs(j)), k
    for model, model_f, opt_j, new_p in ((ts, tf, new_j["gen_opt"], new_j["gen"]),
                                         (td, tdf, new_j["disc_opt"], new_j["disc"])):
        keys = set(model.state_dict())
        grads = state_from_jax(opt_j[1], keys)
        params = state_from_jax(new_p, keys)
        ref = dict(model_f.named_parameters())
        for name, prm in model.named_parameters():
            assert prm.dtype == torch.float32 and prm.grad.dtype == torch.float32, name
            g_t, g_j, g_f = prm.grad.numpy(), grads[name].numpy(), ref[name].grad.numpy()
            err = np.linalg.norm(g_t - g_j)
            assert err <= C * np.linalg.norm(g_j - g_f) + 2 ** -7 * np.linalg.norm(g_j), name
            g_tol = C * np.abs(g_j - g_f).max() + 2 ** -7 * np.abs(g_j).max()
            p_j = params[name].numpy()
            if model is td:
                p_tol = 1e-6 + 1e-4 * np.abs(p_j) + LR * g_tol
            else:
                p_tol = 1e-6 + 1e-4 * np.abs(p_j) + np.where(np.abs(g_j) <= g_tol, 2 * LR, 0.0)
            assert np.all(np.abs(prm.detach().numpy() - p_j) <= p_tol), name
        if model is td:
            u_f = _u(tdf)
            for name, u in _u(td).items():
                assert u.dtype == torch.float32, name
                u_j = params[name].numpy()
                tol = 1e-6 + 1e-4 * np.abs(u_j) + C * np.abs(u_j - u_f[name].numpy()).max()
                assert np.all(np.abs(u.numpy() - u_j) <= tol), name


def test_ten_stft_steps_track_jax_through_the_rectified_radam_steps(steps):
    """Ten consecutive steps of each package from the same weights, on three
    batches in turn: D's first five RAdam updates take the momentum step,
    steps 6-10 the rectified one, and u advances each step. At every step the
    MAS path is EQUAL, D's parameters and every u hold the one-step rule
    (atol 1e-6 + 1e-4 relative), G's parameters the one-step rule plus 2 * lr
    per step taken (each AdamW step may flip a near-zero gradient's sign, as
    in the one-step test), and each summed loss and D's gradient norm rtol
    1e-4 per step taken. G's gradient norm (a sum over every G gradient) and
    the per-sub-discriminator losses follow G's drift more closely and are
    held by the one-step tests only."""
    fn, state_j = steps["fn_f32"], _j_state(steps["gp"], steps["dp"])
    state_t = _port_state(steps["gp"], steps["dp"])
    step_t = make_train_step(port_cfg())
    for k in range(1, 11):
        b, key = _batch(seed=k % 3), jax.random.PRNGKey(100 + k)
        state_j, m_j = _j_run(fn, state_j, b, key)
        state_t, m_t = step_t(state_t, _torch_batch(b), _port_noise(key, b), LR, LR, 0.01)
        np.testing.assert_array_equal(m_t["viz_attn"].numpy(), m_j["viz_attn"], err_msg=k)
        for name in LOSS_KEYS:
            if name != "grad_norm_g":
                np.testing.assert_allclose(m_t[name].numpy(), m_j[name], rtol=1e-4 * k,
                                           atol=1e-6, err_msg=(k, name))
        for key_, drift in (("disc", 0.0), ("gen", 2 * LR * k)):
            model = state_t[key_]
            ref = state_from_jax(state_j[key_], set(model.state_dict()))
            for name, t in model.state_dict().items():
                r = ref[name].numpy()
                assert np.all(np.abs(t.numpy() - r) <= 1e-6 + 1e-4 * np.abs(r) + drift), \
                    (k, key_, name)
    assert int(state_t["disc_opt"].state[next(iter(state_t["disc"].parameters()))]["step"]) == 10
