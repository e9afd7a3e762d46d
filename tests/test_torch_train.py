"""The port's training graph and mel/MPD step against the JAX package at
TINY on the CPU (`__graft_entry__._tiny_cfg()` with both dropout rates 0,
`tiny_step_config("mel")`, MPD periods 2 and 3), from the same weights: the
port's seeded initialisation (weight-norm g/v pairs trainable) carried to a
JAX tree by `params_to_jax`, which is also the converter's inverse under
test. The noise the JAX graph draws from its keys is rebuilt here from the
same keys and handed to the port. The JAX graphs compile at XLA's lowest
backend optimisation level, which only saves compile time.

Tolerances (fp32 on both sides; sums in other orders):
- `Synthesizer.forward`: `attn` (and the slice starts) EQUAL; every other
  output atol 1e-4 with rtol 1e-4.
- the step: losses rtol 1e-4; every G and D gradient before the optimizer
  atol 1e-5 + 1e-3 of that tensor's largest magnitude (a backward through
  the whole GAN graph: decoder, flows, posterior stack, MPD; gradients that
  are zero in exact arithmetic, such as the attention key bias's under the
  shift-invariant softmax, are rounding noise of ~1e-6).
- updated parameters atol 1e-6 + 1e-4 relative. Adam's first update is
  lr * g / (|g| + eps) with eps 1e-9, about lr * sign(g): an element whose
  gradient lies within the gradient tolerance of zero may take either sign
  in the two packages, so for those elements (and only those) the update may
  differ by up to 2 * lr. The gradient check itself is not loosened.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import __graft_entry__
from vits_tpu.models.discriminators import MultiPeriodDiscriminator as JMPD
from vits_tpu.models.synthesizer import Synthesizer as JSynth
from vits_tpu.train.optim import Optimizer as JOptimizer
from vits_tpu.train.step import make_train_step as j_make_train_step
from vits_tpu.utils.tiny import tiny_step_config

from vits_tpu_torch.convert import params_from_jax, params_to_jax, state_from_jax
from vits_tpu_torch.models.discriminators import MultiPeriodDiscriminator as TMPD
from vits_tpu_torch.models.synthesizer import Synthesizer as TSynth
from vits_tpu_torch.nn.core import init_weights
from vits_tpu_torch.train.optim import Optimizer as TOptimizer
from vits_tpu_torch.train.step import TrainStepConfig, make_train_step

HOP = 8
LR = 2e-4
FAST_COMPILE = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Run a module's torch ops on one intra-op thread. TINY ops gain nothing
    from more, and under a parallel test run (pytest -n) every busy core
    stalls the threads' barriers: ten port steps took 12 s on one thread
    and 168 s on eight beside five busy processes on an 8-core host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg():
    cfg = __graft_entry__._tiny_cfg()
    cfg.update(p_dropout=0.0, p_dropout_d=0.0)
    return cfg


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _batch(B=2, T_x=11, T_y=24, seed=0, spec=True):
    """tests/test_train_step.py's batch at the graft entry's TINY widths; a
    spec-less batch carries filter_length extra wav samples."""
    rng = np.random.RandomState(seed)
    c = _cfg()
    b = {
        "x": rng.randn(B, T_x, c["text_channels"]).astype(np.float32),
        "x_lengths": np.array([T_x - (i % 4) for i in range(B)], np.int32),
        "spec": np.abs(rng.randn(B, T_y, c["spec_channels"])).astype(np.float32),
        "spec_lengths": np.array([T_y - (i % 3) * 3 for i in range(B)], np.int32),
        "wav": rng.uniform(-0.5, 0.5, (B, T_y * HOP + (0 if spec else 64))).astype(np.float32),
        "emo": rng.randn(B, 1024).astype(np.float32),
        "sid": np.array([i % c["n_speakers"] for i in range(B)], np.int32),
    }
    if not spec:
        del b["spec"]
    return b


def _noise(rng_fwd, B, T_x, T_y, inter):
    """The noise JAX's Synthesizer.forward draws from `rng_fwd`
    (synthesizer.py:682-723), as the port's noise dict."""
    r = dict(zip(["encp", "postq", "noise_mas", "slice", "fwd", "dp"],
                 jax.random.split(rng_fwd, 6)))
    n = {"post": jax.random.normal(r["postq"], (B, T_y, inter)),
         "mas": jax.random.normal(r["noise_mas"], (B, T_y, T_x)),
         "slice": jax.random.uniform(r["slice"], (B,)),
         "fwd": jax.random.normal(r["fwd"], (B, T_y, inter))}
    return {k: torch.from_numpy(np.asarray(v)) for k, v in n.items()}


def _torch_batch(b):
    return {k: torch.from_numpy(v).long() if k == "sid" else torch.from_numpy(v)
            for k, v in b.items()}


@pytest.fixture(scope="module")
def tiny():
    gen = torch.Generator().manual_seed(5)
    gp = params_to_jax(init_weights(TSynth(**_cfg(), weight_norm=True), gen).state_dict())
    dp = params_to_jax(init_weights(TMPD(periods=(2, 3)), gen).state_dict())
    return JSynth(**_cfg()), JMPD(periods=(2, 3)), gp, dp


def _port(gp, dp):
    ts = params_from_jax(gp, TSynth(**_cfg(), weight_norm=True)).train()
    td = params_from_jax(dp, TMPD(periods=(2, 3))).train()
    return ts, td


def test_synthesizer_forward_matches_jax(tiny):
    js, _, gp, dp = tiny
    ts, _ = _port(gp, dp)
    b = _batch()
    rng = jax.random.PRNGKey(9)
    B, T_x, _ = b["x"].shape
    T_y = b["spec"].shape[1]
    args = [jnp.asarray(b[k]) for k in ("x", "x_lengths", "spec", "spec_lengths", "emo", "sid")]
    out_j = _np(jax.jit(lambda p, r, *a: js.forward(p, r, *a, align_noise=0.5,
                                                    mas_impl="scan", train=True),
                        compiler_options=FAST_COMPILE)(gp, rng, *args))
    tb = _torch_batch(b)
    out_t = ts(tb["x"], tb["x_lengths"], tb["spec"], tb["spec_lengths"], tb["emo"], tb["sid"],
               _noise(rng, B, T_x, T_y, _cfg()["inter_channels"]), align_noise=0.5)
    assert set(out_t) == set(out_j)
    np.testing.assert_array_equal(out_t["attn"].numpy(), out_j["attn"])
    np.testing.assert_array_equal(out_t["ids_slice"].numpy(), out_j["ids_slice"])
    assert out_j["attn"].sum() == b["spec_lengths"].sum()
    for k, v in out_j.items():
        assert tuple(out_t[k].shape) == v.shape, k
        np.testing.assert_allclose(out_t[k].detach().numpy(), v, atol=1e-4, rtol=1e-4,
                                   err_msg=k)


class _Probe:
    """A JAX optimizer that applies `opt` and keeps the gradients it was
    given in its state, so one jitted step yields the losses, the gradients
    before the optimizer and the updated parameters."""

    def __init__(self, opt):
        self.opt = opt

    def init(self, params):
        return (self.opt.init(params), jax.tree_util.tree_map(jnp.zeros_like, params))

    def update(self, grads, state, params, lr):
        upd, s = self.opt.update(grads, state[0], params, lr)
        return upd, (s, grads)


@pytest.mark.parametrize("with_spec", [True, False])
def test_train_step_matches_jax(tiny, with_spec):
    js, jd, gp, dp = tiny
    gen_j, disc_j = JOptimizer("adamw", (0.8, 0.99), 1e-9, 0.01), \
        JOptimizer("adamw", (0.8, 0.99), 1e-9, 0.0)
    step_j = jax.jit(j_make_train_step(js, jd, tiny_step_config("mel"), _Probe(gen_j),
                                       _Probe(disc_j)), compiler_options=FAST_COMPILE)
    pg, pd = _Probe(gen_j), _Probe(disc_j)
    state_j = {"gen": gp, "disc": dp, "gen_opt": pg.init(gp), "disc_opt": pd.init(dp),
               "step": jnp.zeros((), jnp.int32)}
    b = _batch(spec=with_spec)
    key = jax.random.PRNGKey(21)
    new_j, m_j = step_j(state_j, {k: jnp.asarray(v) for k, v in b.items()}, key, LR, LR, 0.01)
    new_j, m_j = _np(new_j), _np(m_j)

    ts, td = _port(gp, dp)
    gen_t, disc_t = TOptimizer((0.8, 0.99), 1e-9, 0.01), TOptimizer((0.8, 0.99), 1e-9, 0.0)
    state_t = {"gen": ts, "disc": td, "gen_opt": gen_t.init(ts.parameters()),
               "disc_opt": disc_t.init(td.parameters()), "step": 0, "rng": None}
    c = tiny_step_config("mel")
    cfg_t = TrainStepConfig(segment_frames=c.segment_frames,
                            hop_length=c.hop_length, filter_length=c.filter_length,
                            win_length=c.win_length, n_mel_channels=c.n_mel_channels,
                            sampling_rate=c.sampling_rate)
    B, T_x, _ = b["x"].shape
    T_y = b["spec_lengths"].max() if not with_spec else b["spec"].shape[1]
    rng_fwd, _ = jax.random.split(key)
    noise = _noise(rng_fwd, B, T_x, int(T_y), _cfg()["inter_channels"])
    state_t, m_t = make_train_step(cfg_t)(state_t, _torch_batch(b), noise,
                                                         LR, LR, 0.01)
    assert state_t["step"] == 1

    np.testing.assert_array_equal(m_t["viz_attn"].numpy(), m_j["viz_attn"])
    for k in ("loss_disc", "loss_gen", "loss_fm", "loss_mel", "loss_dur", "loss_kl",
              "loss_kl_q", "loss_g_total", "losses_d_r", "losses_d_g", "losses_g",
              "grad_norm_d", "grad_norm_g"):
        np.testing.assert_allclose(m_t[k].numpy(), m_j[k], rtol=1e-4, atol=1e-6, err_msg=k)

    for model, opt_j, new_p in ((ts, new_j["gen_opt"], new_j["gen"]),
                                (td, new_j["disc_opt"], new_j["disc"])):
        keys = set(model.state_dict())
        grads = state_from_jax(opt_j[1], keys)
        params = state_from_jax(new_p, keys)
        for name, prm in model.named_parameters():
            g_j = grads[name].numpy()
            g_tol = 1e-5 + 1e-3 * float(np.abs(g_j).max())
            np.testing.assert_allclose(prm.grad.numpy(), g_j, atol=g_tol, rtol=0, err_msg=name)
            p_j = params[name].numpy()
            p_tol = 1e-6 + 1e-4 * np.abs(p_j) + np.where(np.abs(g_j) <= g_tol, 2 * LR, 0.0)
            assert np.all(np.abs(prm.detach().numpy() - p_j) <= p_tol), name
