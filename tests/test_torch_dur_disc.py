"""The duration discriminator of the `-d` flag against the JAX package at
TINY on the CPU (`__graft_entry__._tiny_cfg()` with both dropout rates 0,
`tiny_step_config("mel", use_dur_dis=True)`, MPD periods 2 and 3, the
critic at the loop's widths: filter 64, kernel 5), from the same weights
(the port's seeded initialisation carried to JAX trees by `params_to_jax`)
and the same noise.

Tolerances (fp32 on both sides), those of tests/test_torch_train.py:
- the critic's scores atol 1e-5;
- the step's losses (the critic's D loss and G term among them) and
  gradient norms rtol 1e-4, atol 1e-6; every G, D and P gradient before the
  optimizer atol 1e-5 + 1e-3 of the tensor's largest magnitude;
- updated parameters atol 1e-6 + 1e-4 relative, and up to 2 * lr (P's lr
  for P) where the gradient element lies within the gradient tolerance of
  zero (Adam's first update is about lr * sign(g)).
Without the flag the step computes what it computed before: from the same
state and noise, every output that does not involve the critic is EQUAL
with and without it.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_train import FAST_COMPILE, LR, _batch, _cfg, _noise, _np, _port, _Probe, \
    _torch_batch, one_torch_thread  # noqa: F401 (a fixture)
from vits_tpu.models.discriminators import MultiPeriodDiscriminator as JMPD
from vits_tpu.models.synthesizer import DurationDiscriminator as JDur
from vits_tpu.models.synthesizer import Synthesizer as JSynth
from vits_tpu.train.optim import Optimizer as JOptimizer
from vits_tpu.train.step import make_train_step as j_make_train_step
from vits_tpu.utils.tiny import tiny_step_config

from vits_tpu_torch.convert import params_from_jax, params_to_jax, state_from_jax
from vits_tpu_torch.models.discriminators import MultiPeriodDiscriminator as TMPD
from vits_tpu_torch.models.synthesizer import DurationDiscriminator as TDur
from vits_tpu_torch.models.synthesizer import Synthesizer as TSynth
from vits_tpu_torch.nn.core import init_weights
from vits_tpu_torch.train.optim import Optimizer as TOptimizer
from vits_tpu_torch.train.step import TrainStepConfig, make_train_step

LR_P = 1e-4
HIDDEN = _cfg()["hidden_channels"]
P_KEYS = ("loss_disc_p", "losses_p_r", "losses_p_g", "loss_gen_p", "losses_p", "grad_norm_p")
LOSS_KEYS = ("loss_disc", "loss_gen", "loss_fm", "loss_mel", "loss_dur", "loss_kl", "loss_kl_q",
             "loss_g_total", "losses_d_r", "losses_d_g", "losses_g", "grad_norm_d",
             "grad_norm_g") + P_KEYS
KEY = 21


def _cfg_t(use_dur_dis):
    c = tiny_step_config("mel")
    return TrainStepConfig(segment_frames=c.segment_frames, hop_length=c.hop_length,
                           filter_length=c.filter_length, win_length=c.win_length,
                           n_mel_channels=c.n_mel_channels, sampling_rate=c.sampling_rate,
                           use_dur_dis=use_dur_dis)


@pytest.fixture(scope="module")
def weights():
    gen = torch.Generator().manual_seed(5)
    models = (TSynth(**_cfg(), weight_norm=True), TMPD(periods=(2, 3)), TDur(HIDDEN, 64, 5))
    return tuple(params_to_jax(init_weights(m, gen).state_dict()) for m in models)


def _port_state(weights, use_dur_dis=True):
    gp, dp, pp = weights
    ts, td = _port(gp, dp)
    opts = TOptimizer((0.8, 0.99), 1e-9, 0.01), TOptimizer((0.8, 0.99), 1e-9, 0.0)
    state = {"gen": ts, "disc": td, "gen_opt": opts[0].init(ts.parameters()),
             "disc_opt": opts[1].init(td.parameters()), "step": 0, "rng": None}
    if use_dur_dis:
        tp = params_from_jax(pp, TDur(HIDDEN, 64, 5)).train()
        state.update(dur=tp, dur_opt=TOptimizer((0.8, 0.99), 1e-9, 0.0).init(tp.parameters()))
    return state


def _port_step(weights, use_dur_dis):
    b = _batch()
    B, T_x, _ = b["x"].shape
    rng_fwd, _ = jax.random.split(jax.random.PRNGKey(KEY))
    noise = _noise(rng_fwd, B, T_x, b["spec"].shape[1], _cfg()["inter_channels"])
    return make_train_step(_cfg_t(use_dur_dis))(_port_state(weights, use_dur_dis),
                                                _torch_batch(b), noise, LR, LR, 0.01, LR_P)


@pytest.fixture(scope="module")
def jax_step(weights):
    gp, dp, pp = weights
    opts = (JOptimizer("adamw", (0.8, 0.99), 1e-9, 0.01),
            JOptimizer("adamw", (0.8, 0.99), 1e-9, 0.0),
            JOptimizer("adamw", (0.8, 0.99), 1e-9, 0.0))
    pg, pd, pq = (_Probe(o) for o in opts)
    cfg = tiny_step_config("mel", use_dur_dis=True)
    step = jax.jit(j_make_train_step(JSynth(**_cfg()), JMPD(periods=(2, 3)), cfg, pg, pd,
                                     JDur(HIDDEN, 64, 5), pq), compiler_options=FAST_COMPILE)
    state = {"gen": gp, "disc": dp, "dur": pp, "gen_opt": pg.init(gp),
             "disc_opt": pd.init(dp), "dur_opt": pq.init(pp), "step": jnp.zeros((), jnp.int32)}
    new, m = step(state, {k: jnp.asarray(v) for k, v in _batch().items()},
                  jax.random.PRNGKey(KEY), LR, LR, 0.01, LR_P)
    return _np(new), _np(m)


def test_scores_match_jax_and_x_carries_no_gradient(weights):
    _, _, pp = weights
    rng = np.random.RandomState(3)
    B, T = 2, 11
    x = rng.randn(B, T, HIDDEN).astype(np.float32)
    mask = (np.arange(T)[None, :] < np.array([[T], [T - 4]])).astype(np.float32)[..., None]
    d_r, d_g = (rng.randn(B, T, 1).astype(np.float32) for _ in range(2))
    rj, gj = JDur(HIDDEN, 64, 5).apply(pp, *(jnp.asarray(a) for a in (x, mask, d_r, d_g)))
    tp = params_from_jax(pp, TDur(HIDDEN, 64, 5))
    xt = torch.from_numpy(x).requires_grad_(True)
    dg = torch.from_numpy(d_g).requires_grad_(True)
    rt, gt = tp(xt, torch.from_numpy(mask), torch.from_numpy(d_r), dg)
    assert len(rt) == len(gt) == 1
    np.testing.assert_allclose(rt[0].detach().numpy(), np.asarray(rj[0]), atol=1e-5, rtol=0)
    np.testing.assert_allclose(gt[0].detach().numpy(), np.asarray(gj[0]), atol=1e-5, rtol=0)
    (rt[0].sum() + gt[0].sum()).backward()
    assert xt.grad is None and dg.grad is not None and float(dg.grad.abs().sum()) > 0


def test_step_with_the_duration_discriminator_matches_jax(weights, jax_step):
    new_j, m_j = jax_step
    state, m_t = _port_step(weights, True)
    np.testing.assert_array_equal(m_t["viz_attn"].numpy(), m_j["viz_attn"])
    assert set(LOSS_KEYS) <= set(m_t) and set(P_KEYS) <= set(m_j)
    for k in LOSS_KEYS:
        np.testing.assert_allclose(m_t[k].numpy(), m_j[k], rtol=1e-4, atol=1e-6, err_msg=k)
    assert float(m_t["grad_norm_p"]) > 0
    for key, lr in (("gen", LR), ("disc", LR), ("dur", LR_P)):
        model = state[key]
        keys = set(model.state_dict())
        grads = state_from_jax(new_j[f"{key}_opt"][1], keys)
        params = state_from_jax(new_j[key], keys)
        for name, prm in model.named_parameters():
            g_j = grads[name].numpy()
            g_tol = 1e-5 + 1e-3 * float(np.abs(g_j).max())
            np.testing.assert_allclose(prm.grad.numpy(), g_j, atol=g_tol, rtol=0,
                                       err_msg=f"{key}.{name}")
            p_j = params[name].numpy()
            p_tol = 1e-6 + 1e-4 * np.abs(p_j) + np.where(np.abs(g_j) <= g_tol, 2 * lr, 0.0)
            assert np.all(np.abs(prm.detach().numpy() - p_j) <= p_tol), f"{key}.{name}"


def test_without_the_flag_the_step_is_unchanged(weights):
    """From the same state and noise, the step without the critic and with
    it give equal D losses, D parameters, generator losses and every
    generator parameter outside the duration predictor (the critic's
    gradient reaches the generator only through the predicted
    log-durations); the total adds the critic's term; without the flag its
    metrics are the zeros of loss_disc_p and grad_norm_p alone."""
    s0, m0 = _port_step(weights, False)
    s1, m1 = _port_step(weights, True)
    assert set(m1) - set(m0) == set(P_KEYS) - {"loss_disc_p", "grad_norm_p"}
    assert float(m0["loss_disc_p"]) == 0.0 and float(m0["grad_norm_p"]) == 0.0
    for k in set(m0) - {"loss_g_total", "grad_norm_g", "loss_disc_p", "grad_norm_p"}:
        assert torch.equal(m0[k], m1[k]), k
    assert torch.equal(m1["loss_g_total"], m0["loss_g_total"] + m1["loss_gen_p"])
    for key in ("gen", "disc"):
        p1 = dict(s1[key].named_parameters())
        moved = []
        for name, p in s0[key].named_parameters():
            if name.startswith("dp."):
                moved.append(not torch.equal(p, p1[name]))
            else:
                assert torch.equal(p, p1[name]), f"{key}.{name}"
        assert key == "disc" or any(moved)


def test_a_compact_batch_steps_as_its_dequantized_float_batch(weights):
    """A compact batch (int16 wav, bfloat16 text and emotion vectors, as
    `collate(compact=True)` ships them) steps exactly as the float batch
    holding the values the JAX step dequantizes them to: the wav at
    float32(int16) * float32(1 / 32767), the vectors widened."""
    b = _batch(spec=False)
    B, T_x, _ = b["x"].shape
    T_y = (b["wav"].shape[1] - 64) // 8
    pcm = np.clip(np.rint(b["wav"] * 32767.0), -32767, 32767).astype(np.int16)
    compact = {**_torch_batch(b), "wav": torch.from_numpy(pcm),
               "x": torch.from_numpy(b["x"]).to(torch.bfloat16),
               "emo": torch.from_numpy(b["emo"]).to(torch.bfloat16)}
    wide = {**compact, "wav": torch.from_numpy(pcm.astype(np.float32)
                                               * np.float32(1.0 / 32767.0)),
            "x": compact["x"].float(), "emo": compact["emo"].float()}
    rng_fwd, _ = jax.random.split(jax.random.PRNGKey(KEY))
    noise = _noise(rng_fwd, B, T_x, T_y, _cfg()["inter_channels"])
    outs = [make_train_step(_cfg_t(True))(_port_state(weights), batch, noise, LR, LR, 0.01,
                                          LR_P)
            for batch in (compact, wide)]
    (s_c, m_c), (s_w, m_w) = outs
    assert set(m_c) == set(m_w)
    for k in m_c:
        assert torch.equal(m_c[k], m_w[k]), k
    for key in ("gen", "disc", "dur"):
        for (name, p), q in zip(s_c[key].named_parameters(), s_w[key].parameters()):
            assert torch.equal(p, q), f"{key}.{name}"
