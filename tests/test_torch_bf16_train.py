"""The port's bf16 training step against the JAX package's at TINY on the
CPU (`__graft_entry__._tiny_cfg()` with both dropout rates 0,
`tiny_step_config("mel")` at `compute_dtype=jnp.bfloat16`, MPD periods 2
and 3), from the same weights and the same noise, which the JAX graph draws
in bf16 from its keys and which is rebuilt here from the same keys. The JAX
step compiles at XLA's lowest backend optimisation level, which only saves
compile time.

The two bf16 steps are the same computation rounded at different places
(by design, not emulated): a conv or a dense layer's bias add, which JAX
rounds after the product and torch's convolutions fuse; LayerNorm, whose
mean and variance JAX takes in bf16 and `F.layer_norm` in f32; softmax;
the neg_cent einsums; the transcendentals of the two libraries. So each
lies about as far from the other as either lies from the float32 step, and
the yardstick of every tolerance below is JAX's own bf16 rounding: its
distance to the port's float32 step from the same weights and noise (which
tests/test_torch_train.py holds to JAX's float32 step at 1e-4).

Tolerances:
- the MAS path EQUAL (bf16 neg_cent, f32 DP in both);
- each loss and gradient norm: |port - jax| <= 4 |jax - f32| + 2^-8 |jax|;
- each gradient tensor before the optimizer, in the L2 norm:
  ||port - jax|| <= 4 ||jax - f32|| + 2^-7 ||jax||;
- updated parameters atol 1e-6 + 1e-4 relative, and, by the existing Adam
  first-step rule (an update of about lr * sign(g)), up to 2 * lr where
  JAX's gradient element lies within that tensor's gradient tolerance of
  zero, elementwise: 4 max|jax - f32| + 2^-7 max|jax|.
Forward hooks show that the generator, the D pass and G's adversarial pass
run in bf16. The recipe run at float32 is the float32 step bit for bit.

The port's steps run on torch's own CPU convolutions (oneDNN off). In bf16
oneDNN picks, from one process to the next, between weight-gradient kernels
of different accumulation precision for a convolution as DiscriminatorS's
grouped 41-tap conv over a one-frame input: its weight gradient moved by up
to 75% of its norm between identical runs (and Adam's first step turns that
into 2 * lr on the parameters), which says nothing of the port. torch's own
convolutions are deterministic and accumulate in f32. The card runs cuDNN.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_train import (FAST_COMPILE, LR, _batch, _cfg, _np, _port, _Probe,  # noqa: F401
                              _torch_batch, one_torch_thread)
from vits_tpu.models.discriminators import MultiPeriodDiscriminator as JMPD
from vits_tpu.models.synthesizer import Synthesizer as JSynth
from vits_tpu.ops.mas import mask_to_lengths as j_mask_to_lengths
from vits_tpu.train.optim import Optimizer as JOptimizer
from vits_tpu.train.step import make_train_step as j_make_train_step
from vits_tpu.utils.tiny import tiny_step_config

from vits_tpu_torch.config import default_config_path, get_hparams_from_file
from vits_tpu_torch.convert import params_to_jax, state_from_jax
from vits_tpu_torch.models.discriminators import MultiPeriodDiscriminator as TMPD
from vits_tpu_torch.models.synthesizer import Synthesizer as TSynth
from vits_tpu_torch.nn.core import init_weights
from vits_tpu_torch.ops.mas import mask_to_lengths
from vits_tpu_torch.train import step as step_mod
from vits_tpu_torch.train.loop import build_step
from vits_tpu_torch.train.optim import Optimizer as TOptimizer
from vits_tpu_torch.train.step import TrainStepConfig, make_train_step

C = 4.0  # the noise factor of every tolerance


def _noise(rng_fwd, B, T_x, T_y, inter, dtype):
    """The noise JAX's Synthesizer.forward draws from `rng_fwd` in the
    compute dtype (synthesizer.py:682-723), as the port's noise dict."""
    r = dict(zip(["encp", "postq", "noise_mas", "slice", "fwd", "dp"],
                 jax.random.split(rng_fwd, 6)))
    jd = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    n = {"post": jax.random.normal(r["postq"], (B, T_y, inter), jd),
         "mas": jax.random.normal(r["noise_mas"], (B, T_y, T_x), jd),
         "slice": jax.random.uniform(r["slice"], (B,)),
         "fwd": jax.random.normal(r["fwd"], (B, T_y, inter), jd)}
    return {k: torch.from_numpy(np.array(v, np.float32)).to(dtype if k != "slice"
                                                              else torch.float32)
            for k, v in n.items()}


def _port_cfg(dtype):
    c = tiny_step_config("mel")
    return TrainStepConfig(segment_frames=c.segment_frames, hop_length=c.hop_length,
                           filter_length=c.filter_length, win_length=c.win_length,
                           n_mel_channels=c.n_mel_channels, sampling_rate=c.sampling_rate,
                           compute_dtype=dtype)


def _port_step(gp, dp, b, key, dtype, hooks=None):
    ts, td = _port(gp, dp)
    gen_t, disc_t = TOptimizer((0.8, 0.99), 1e-9, 0.01), TOptimizer((0.8, 0.99), 1e-9, 0.0)
    state = {"gen": ts, "disc": td, "gen_opt": gen_t.init(ts.parameters()),
             "disc_opt": disc_t.init(td.parameters()), "step": 0, "rng": None}
    if hooks is not None:
        for name, mod in (("G", ts.dec.conv_pre), ("D", td.discriminators["0"])):
            mod.register_forward_hook(
                lambda m, a, o, _n=name: hooks.append((_n, a[0].dtype)))
    B, T_x, _ = b["x"].shape
    rng_fwd, _ = jax.random.split(key)
    noise = _noise(rng_fwd, B, T_x, b["spec"].shape[1], _cfg()["inter_channels"], dtype)
    with torch.backends.mkldnn.flags(enabled=False):  # see the module docstring
        state, metrics = make_train_step(_port_cfg(dtype))(state, _torch_batch(b), noise,
                                                           LR, LR, 0.01)
    return ts, td, metrics


@pytest.fixture(scope="module")
def steps():
    """One bf16 step of each package and the port's float32 step, from the
    port's seeded initialisation carried to a JAX tree."""
    gen = torch.Generator().manual_seed(5)
    gp = params_to_jax(init_weights(TSynth(**_cfg(), weight_norm=True), gen).state_dict())
    dp = params_to_jax(init_weights(TMPD(periods=(2, 3)), gen).state_dict())
    gen_j, disc_j = JOptimizer("adamw", (0.8, 0.99), 1e-9, 0.01), \
        JOptimizer("adamw", (0.8, 0.99), 1e-9, 0.0)
    cfg_j = dataclasses.replace(tiny_step_config("mel"), compute_dtype=jnp.bfloat16)
    step_j = jax.jit(j_make_train_step(JSynth(**_cfg()), JMPD(periods=(2, 3)), cfg_j,
                                       _Probe(gen_j), _Probe(disc_j)),
                     compiler_options=FAST_COMPILE)
    pg, pd = _Probe(gen_j), _Probe(disc_j)
    state_j = {"gen": gp, "disc": dp, "gen_opt": pg.init(gp), "disc_opt": pd.init(dp),
               "step": jnp.zeros((), jnp.int32)}
    b = _batch()
    key = jax.random.PRNGKey(21)
    new_j, m_j = step_j(state_j, {k: jnp.asarray(v) for k, v in b.items()}, key, LR, LR, 0.01)
    hooks = []
    bf16 = _port_step(gp, dp, b, key, torch.bfloat16, hooks)
    f32 = _port_step(gp, dp, b, key, torch.float32)
    return _np(new_j), _np(m_j), bf16, f32, hooks


def _within(port, jax_v, f32, rel):
    return abs(port - jax_v) <= C * abs(jax_v - f32) + rel * abs(jax_v)


def test_bf16_step_losses_and_path_match_jax(steps):
    _, m_j, (_, _, m_t), (_, _, m_f), hooks = steps
    # the generator forward, the D step and G's adversarial pass (twice the
    # D: real and fake in one batch each time) all ran in bf16
    assert hooks == [("G", torch.bfloat16), ("D", torch.bfloat16), ("D", torch.bfloat16)]
    np.testing.assert_array_equal(m_t["viz_attn"].float().numpy(),
                                  np.asarray(m_j["viz_attn"], np.float32))
    for k in ("loss_disc", "loss_gen", "loss_fm", "loss_mel", "loss_dur", "loss_kl",
              "loss_kl_q", "loss_g_total", "grad_norm_d", "grad_norm_g"):
        assert m_t[k].dtype == torch.float32, k
        p, j, f = float(m_t[k]), float(np.asarray(m_j[k], np.float32)), float(m_f[k])
        assert _within(p, j, f, 2 ** -8), (k, p, j, f)
    for k in ("losses_d_r", "losses_d_g", "losses_g"):
        p, j, f = m_t[k].numpy(), np.asarray(m_j[k], np.float32), m_f[k].numpy()
        assert np.all(np.abs(p - j) <= C * np.abs(j - f) + 2 ** -8 * np.abs(j)), k


def test_bf16_step_gradients_and_params_match_jax(steps):
    new_j, _, (ts, td, _), (tf, tdf, _), _ = steps
    for model, model_f, opt_j, new_p in ((ts, tf, new_j["gen_opt"], new_j["gen"]),
                                         (td, tdf, new_j["disc_opt"], new_j["disc"])):
        keys = set(model.state_dict())
        grads = state_from_jax(opt_j[1], keys)
        params = state_from_jax(new_p, keys)
        ref = dict(model_f.named_parameters())
        for name, prm in model.named_parameters():
            assert prm.dtype == torch.float32 and prm.grad.dtype == torch.float32, name
            g_t, g_j, g_f = prm.grad.numpy(), grads[name].float().numpy(), ref[name].grad.numpy()
            err = np.linalg.norm(g_t - g_j)
            assert err <= C * np.linalg.norm(g_j - g_f) + 2 ** -7 * np.linalg.norm(g_j), name
            g_tol = C * np.abs(g_j - g_f).max() + 2 ** -7 * np.abs(g_j).max()
            p_j = params[name].numpy()
            p_tol = 1e-6 + 1e-4 * np.abs(p_j) + np.where(np.abs(g_j) <= g_tol, 2 * LR, 0.0)
            assert np.all(np.abs(prm.detach().numpy() - p_j) <= p_tol), name


def test_bf16_recipe_at_f32_is_the_fp32_step(monkeypatch):
    """The cast recipe at float32 (every cast the parameter itself, through
    functional_call) against the same step calling the modules directly:
    losses, gradients and updated parameters bit-equal."""
    gen = torch.Generator().manual_seed(6)
    gp = params_to_jax(init_weights(TSynth(**_cfg(), weight_norm=True), gen).state_dict())
    dp = params_to_jax(init_weights(TMPD(periods=(2, 3)), gen).state_dict())
    b, key = _batch(seed=3), jax.random.PRNGKey(4)
    ts, td, m = _port_step(gp, dp, b, key, torch.float32)
    monkeypatch.setattr(step_mod, "cast_call", lambda module, dtype, *a, **k: module(*a, **k))
    ts_d, td_d, m_d = _port_step(gp, dp, b, key, torch.float32)
    for k in m:
        assert torch.equal(m[k], m_d[k]), k
    for a, d in ((ts, ts_d), (td, td_d)):
        for (name, p), p_d in zip(a.named_parameters(), d.parameters()):
            assert torch.equal(p.grad, p_d.grad) and torch.equal(p, p_d), name


def test_step_dtype_follows_bf16_run():
    """TrainStepConfig.from_hps and loop.build_step take the compute dtype
    from train.bf16_run (configs/base.json sets it), as the JAX loop does."""
    hps = get_hparams_from_file(default_config_path("base"))
    assert hps.train.bf16_run
    assert TrainStepConfig.from_hps(hps).compute_dtype == torch.bfloat16
    assert TrainStepConfig.from_hps(hps, torch.float32).compute_dtype == torch.float32
    hps.train.bf16_run = False
    assert TrainStepConfig.from_hps(hps).compute_dtype == torch.float32
    assert callable(build_step(hps))


def test_mas_lengths_of_a_bf16_mask_are_exact():
    """A bf16 attention mask of 387 valid frames: the JAX package counts its
    lengths in bf16 (387 rounds to 388, ROADMAP C); the port counts in f32."""
    t_ys = np.array([387, 300, 256])
    mask = (np.arange(400)[None, :, None] < t_ys[:, None, None]) & \
        (np.arange(7)[None, None, :] < 5)
    ty_j, _ = j_mask_to_lengths(jnp.asarray(mask, jnp.bfloat16))
    assert list(np.asarray(ty_j)) == [388, 300, 256]
    ty_t, tx_t = mask_to_lengths(torch.from_numpy(mask).to(torch.bfloat16))
    assert ty_t.tolist() == [387, 300, 256] and tx_t.tolist() == [5, 5, 5]
