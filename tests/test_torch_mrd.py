"""The port's spectral norm, multi-resolution discriminators, STFT losses and
RAdam against the JAX package on the CPU. Weights come from the JAX
package's own `init_params` (spectral-norm w_orig and u) and are carried to
the port by `vits_tpu_torch.convert`, which is under test both ways.

Tolerances (fp32 on both sides; sums in other orders):
- spectral norm: the normalised kernel and the advanced u atol 1e-6 with
  rtol 1e-5; the gradient of a scalar through the normalised kernel atol
  1e-6 with rtol 1e-4 (u and v held constant in both);
- discriminator scores atol 1e-5 with rtol 1e-4, as
  tests/test_torch_disc.py holds the MPD; the full-width convolution plans
  and parameter counts EQUAL;
- |STFT| magnitudes atol 1e-4 with rtol 1e-4 (the port's framed matmul
  against the JAX package's strided conv, through 2048-point DFTs); the sc
  and mag losses rtol 1e-5;
- RAdam: every parameter and both moments after each of 10 updates atol
  1e-7 with rtol 1e-5 (the first five take the momentum step, the rest the
  rectified one with betas (0.8, 0.99)); the count equal.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vits_tpu.models import mrd as JM
from vits_tpu.models.discriminators import MultiPeriodDiscriminator as JMPD
from vits_tpu.nn import core as JC
from vits_tpu.train import losses as JL
from vits_tpu.train.loop import count_params as j_count_params
from vits_tpu.train.optim import Optimizer as JOptimizer

from vits_tpu_torch.convert import (optimizer_from_jax, optimizer_to_jax, params_from_jax,
                                    params_to_jax)
from vits_tpu_torch.models import mrd as TM
from vits_tpu_torch.models.discriminators import MultiPeriodDiscriminator as TMPD
from vits_tpu_torch.nn.core import Conv1d, Conv2d, sn_kernel, sn_update, spectral_normalize
from vits_tpu_torch.train import losses as TL
from vits_tpu_torch.train.loop import count_params
from vits_tpu_torch.train.optim import Optimizer as TOptimizer

FAST_COMPILE = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


# ---------------------------------------------------------------------------
# spectral norm
# ---------------------------------------------------------------------------

SN_LAYERS = {  # (JAX layer, port layer), each spectral-normed
    "conv1d": (JC.Conv1d(6, 7, 5, dilation=2, spectral_norm=True),
               Conv1d(6, 7, 5, dilation=2, spectral_norm=True)),
    "conv1d_one_out": (JC.Conv1d(8, 1, 1, spectral_norm=True),
                       Conv1d(8, 1, 1, spectral_norm=True)),
    "conv2d": (JC.Conv2d(4, 6, (5, 3), (2, 1), (0, 1), spectral_norm=True),
               Conv2d(4, 6, (5, 3), (2, 1), (0, 1), spectral_norm=True)),
}


@pytest.mark.parametrize("kind", sorted(SN_LAYERS))
def test_spectral_norm_matches_jax(kind):
    jl, tl = SN_LAYERS[kind]
    p = _np(jl.init_params(jax.random.PRNGKey(3)))
    params_from_jax(p, tl)
    assert torch.equal(tl.weight_u, _t(p["u"])) and not tl.weight_u.requires_grad
    assert [n for n, _ in tl.named_buffers()] == ["weight_u"]
    w_j = np.asarray(JC._sn_kernel(jnp.asarray(p["w_orig"]), jnp.asarray(p["u"])))
    back = params_to_jax({"weight": tl.kernel().detach()})["w"]
    np.testing.assert_allclose(back, w_j, atol=1e-6, rtol=1e-5)

    # the gradient reaches the kernel through w @ v and the division only
    r = np.random.RandomState(1).randn(*p["w_orig"].shape).astype(np.float32)
    g_j = np.asarray(jax.grad(lambda w: jnp.sum(JC._sn_kernel(w, jnp.asarray(p["u"]))
                                                * jnp.asarray(r)))(jnp.asarray(p["w_orig"])))
    torch.sum(tl.kernel() * params_from_jax({"w": r})["weight"]).backward()
    g_t = params_to_jax({"weight_orig": tl.weight_orig.grad})["w_orig"]
    np.testing.assert_allclose(g_t, g_j, atol=1e-6, rtol=1e-4)
    assert tl.weight_u.grad is None

    # one power iteration on the kernel: spectral_normalize and sn_update
    w_sn_j, u_j = JC.spectral_normalize(jnp.asarray(p["w_orig"]), jnp.asarray(p["u"]))
    w_sn_t, u_t = spectral_normalize(tl.weight_orig.detach(), tl.weight_u)
    np.testing.assert_allclose(params_to_jax({"weight": w_sn_t})["w"], np.asarray(w_sn_j),
                               atol=1e-6, rtol=1e-5)
    np.testing.assert_allclose(u_t.numpy(), np.asarray(u_j), atol=1e-6, rtol=1e-5)
    u_upd = np.asarray(JC.sn_update({"layer": p})["layer"]["u"])
    sn_update(tl)
    np.testing.assert_allclose(tl.weight_u.numpy(), u_upd, atol=1e-6, rtol=1e-5)
    if tl.out_channels > 1:
        assert not np.allclose(u_upd, p["u"], atol=1e-3)


def test_sn_kernel_is_sigma_of_the_kernel_at_the_fixed_point():
    """With u at its fixed point, sn_kernel divides by the largest singular
    value of the kernel flattened to (C_out, -1)."""
    w = torch.randn(5, 3, 4, generator=torch.Generator().manual_seed(0))
    u = torch.randn(5, generator=torch.Generator().manual_seed(1))
    for _ in range(200):
        _, u = spectral_normalize(w, u)
    sigma = torch.linalg.matrix_norm(w.reshape(5, -1), ord=2)
    torch.testing.assert_close(sn_kernel(w, u), w / sigma, atol=1e-6, rtol=1e-5)


# ---------------------------------------------------------------------------
# the discriminators
# ---------------------------------------------------------------------------

RES = ((64, 16, 64), (32, 8, 32))


def _mags(wave, resolutions=RES):
    return [np.asarray(JL.stft_magnitude(jnp.asarray(wave[..., 0]), *r)) for r in resolutions]


MRD_CASES = {
    # name: (JAX module, port module, inputs) at small widths
    "wave": (JM.WaveDiscriminator(2, layers=5, conv_channels=8),
             TM.WaveDiscriminator(2, layers=5, conv_channels=8), "wave2"),
    "multi_wave": (JM.MultiWaveDiscriminator(num_dwt=3, layers=4, conv_channels=8),
                   TM.MultiWaveDiscriminator(num_dwt=3, layers=4, conv_channels=8), "wave_odd"),
    "stft": (JM.STFTDiscriminator(64, 16, 64, num_layers=3, kernel_size=3, conv_channels=8),
             TM.STFTDiscriminator(64, 16, 64, num_layers=3, kernel_size=3, conv_channels=8),
             "mag"),
    "multi_stft": (JM.MultiSTFTDiscriminator((64, 32), (16, 8), (64, 32), (3, 3), (3, 3), (8, 8)),
                   TM.MultiSTFTDiscriminator((64, 32), (16, 8), (64, 32), (3, 3), (3, 3), (8, 8)),
                   "mags"),
    "multi_wave_stft": (JM.MultiWaveSTFTDiscriminator(
        num_dwt=2, wave_layers=4, fft_sizes=(64, 32), hop_sizes=(16, 8), win_sizes=(64, 32),
        stft_num_layers=(3, 3), stft_kernel_sizes=(3, 3), stft_conv_channels=(8, 8)),
        TM.MultiWaveSTFTDiscriminator(
        num_dwt=2, wave_layers=4, fft_sizes=(64, 32), hop_sizes=(16, 8), win_sizes=(64, 32),
        stft_num_layers=(3, 3), stft_kernel_sizes=(3, 3), stft_conv_channels=(8, 8)),
        "wave_mags"),
}


def _inputs(kind, rng):
    wave = rng.uniform(-0.5, 0.5, (3, 64, 1)).astype(np.float32)
    if kind == "wave2":
        return (rng.randn(3, 40, 2).astype(np.float32),)
    if kind == "wave_odd":  # 149 samples: reflect-padded to 150 (75 x 2 channels), then
        return (rng.uniform(-0.5, 0.5, (3, 149, 1)).astype(np.float32),)  # to 76 (38 x 4)
    if kind == "mag":
        return (_mags(wave)[0],)
    if kind == "mags":
        return (_mags(wave),)
    return wave, _mags(wave)


def _as_t(a):
    return [_as_t(x) for x in a] if isinstance(a, list) else torch.from_numpy(np.array(a))


@pytest.mark.parametrize("name", sorted(MRD_CASES))
def test_mrd_forward_matches_jax(name):
    jm, tm, kind = MRD_CASES[name]
    p = _np(jax.jit(jm.init_params, compiler_options=FAST_COMPILE)(jax.random.PRNGKey(7)))
    params_from_jax(p, tm)
    back = params_to_jax(tm.state_dict())
    jax.tree_util.tree_map(np.testing.assert_array_equal, back, p)
    args = _inputs(kind, np.random.RandomState(2))
    out_j = jax.jit(jm.apply, compiler_options=FAST_COMPILE)(
        p, *[jax.tree_util.tree_map(jnp.asarray, a) for a in args])
    with torch.no_grad():
        out_t = tm(*[_as_t(a) for a in args])
    out_j = out_j if isinstance(out_j, list) else [out_j]
    out_t = out_t if isinstance(out_t, list) else [out_t]
    assert len(out_t) == len(out_j)
    for a, b in zip(out_j, out_t):
        assert tuple(b.shape) == a.shape
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-5, rtol=1e-4)


FULL = list(zip((128, 256, 512, 1024, 2048), (32, 64, 128, 256, 512), (5, 6, 7, 8, 9)))


@pytest.mark.parametrize("fft,hop,layers", FULL)
def test_full_width_stft_plan_matches_jax(fft, hop, layers):
    """Each full-width resolution's convolutions (a plan, no forward): (5, 5)
    kernels at stride (2, 1) and a last (1, 1) conv, as JAX `_plan()`."""
    plan_j = [(c.in_channels, c.out_channels, tuple(c.kernel_size), tuple(c.stride),
               tuple(c.padding)) for c in JM.STFTDiscriminator(
        fft, hop, fft, layers, 5, conv_channels=64)._plan()]
    assert TM.stft_plan(fft, layers, 5, 1, 64) == plan_j
    assert plan_j[0][2:4] == ((5, 5), (2, 1)) and plan_j[-1][2] == (1, 1)
    d = TM.MultiWaveSTFTDiscriminator().mfd.discriminators[str(FULL.index((fft, hop, layers)))]
    assert [(c.in_channels, c.out_channels, c.kernel_size, c.stride, c.padding)
            for c in d.convs.values()] == plan_j


def test_full_width_mrd_tree_and_count_match_jax():
    """The full-width MRD's state dict is the JAX tree leaf for leaf (255:
    85 spectral-norm convs of w_orig, b and u) and its count is the JAX
    loop's `count_params(state["disc"], exclude=())`, the u leaves in it."""
    shapes = jax.eval_shape(JM.MultiWaveSTFTDiscriminator().init_params, jax.random.PRNGKey(0))
    tm = TM.MultiWaveSTFTDiscriminator()
    mine = jax.tree_util.tree_map(np.shape, params_to_jax(tm.state_dict()))
    assert mine == jax.tree_util.tree_map(lambda s: s.shape, shapes)
    assert len(jax.tree_util.tree_leaves(shapes)) == 255
    assert count_params(tm) == j_count_params(shapes, exclude=()) == 6275860
    assert sum(1 for n, _ in tm.named_buffers()) == 85


def test_mpd_with_spectral_norm_matches_jax():
    jd = JMPD(use_spectral_norm=True, periods=(2, 3))
    p = _np(jax.jit(jd.init_params, compiler_options=FAST_COMPILE)(jax.random.PRNGKey(4)))
    td = params_from_jax(p, TMPD(use_spectral_norm=True, periods=(2, 3)))
    assert not any(n.endswith(("weight_g", "weight_v")) for n in td.state_dict())
    rng = np.random.RandomState(0)
    y, y_hat = (rng.uniform(-0.5, 0.5, (2, 125, 1)).astype(np.float32) for _ in range(2))
    out_j = _np(jax.jit(jd.apply, compiler_options=FAST_COMPILE)(p, jnp.asarray(y),
                                                                 jnp.asarray(y_hat)))
    with torch.no_grad():
        out_t = td(torch.from_numpy(y), torch.from_numpy(y_hat))
    for part_j, part_t in zip(out_j[:2], out_t[:2]):
        for a, b in zip(part_j, part_t):
            np.testing.assert_allclose(b.numpy(), a, atol=1e-5, rtol=1e-4)
    for fj, ft in zip(out_j[2], out_t[2]):
        for a, b in zip(fj, ft):
            np.testing.assert_allclose(b.numpy(), a, atol=1e-5, rtol=1e-4)
    u_j = JC.sn_update(p)["discriminators"]["1"]["conv_post"]["u"]
    sn_update(td)
    np.testing.assert_allclose(td.discriminators["1"].conv_post.weight_u.numpy(),
                               np.asarray(u_j), atol=1e-6, rtol=1e-5)


# ---------------------------------------------------------------------------
# the multi-resolution STFT loss
# ---------------------------------------------------------------------------

def test_stft_magnitudes_and_losses_match_jax():
    rng = np.random.RandomState(3)
    x = rng.uniform(-0.5, 0.5, (2, 4096)).astype(np.float32)
    y = (x + 0.1 * rng.randn(2, 4096)).astype(np.float32)
    assert TL.DEFAULT_RESOLUTIONS == JL.DEFAULT_RESOLUTIONS
    assert TM.MultiWaveSTFTDiscriminator().resolutions == TL.DEFAULT_RESOLUTIONS
    xs_j, ys_j, xs_t, ys_t = [], [], [], []
    for res in TL.DEFAULT_RESOLUTIONS:
        for wav, out_j, out_t in ((x, xs_j, xs_t), (y, ys_j, ys_t)):
            out_j.append(np.asarray(JL.stft_magnitude(jnp.asarray(wav), *res)))
            out_t.append(TL.stft_magnitude(torch.from_numpy(wav), *res))
            assert tuple(out_t[-1].shape) == out_j[-1].shape == (2, 4096 // res[1] + 1,
                                                                 res[0] // 2 + 1)
            np.testing.assert_allclose(out_t[-1].numpy(), out_j[-1], atol=1e-4, rtol=1e-4)
    sc_j, mag_j = JL.multi_resolution_stft_losses(xs_j, ys_j)
    sc_t, mag_t = TL.multi_resolution_stft_losses([torch.from_numpy(a) for a in xs_j],
                                                  [torch.from_numpy(a) for a in ys_j])
    np.testing.assert_allclose(float(sc_t), float(sc_j), rtol=1e-5)
    np.testing.assert_allclose(float(mag_t), float(mag_j), rtol=1e-5)
    for a, b in zip(xs_j[:1], ys_j[:1]):
        sc1_j, mag1_j = JL.stft_losses_from_mags(a, b)
        sc1_t, mag1_t = TL.stft_losses_from_mags(torch.from_numpy(a), torch.from_numpy(b))
        np.testing.assert_allclose([float(sc1_t), float(mag1_t)],
                                   [float(sc1_j), float(mag1_j)], rtol=1e-5)


# ---------------------------------------------------------------------------
# RAdam
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("weight_decay", [0.0, 0.01])
def test_radam_matches_optax_over_both_branches(weight_decay):
    """10 updates from the same parameters and gradients: the port's RAdam
    against the JAX `Optimizer("radam", (0.8, 0.99), 1e-9, wd)`; its state
    goes through `optimizer_to_jax` onto the JAX state's leaves."""
    rng = np.random.RandomState(5)
    conv = Conv1d(3, 4, 3, spectral_norm=True)
    shapes = {n: tuple(t.shape) for n, t in conv.state_dict().items()}
    p_j = params_to_jax({n: torch.from_numpy(rng.randn(*s).astype(np.float32))
                         for n, s in shapes.items()})
    params_from_jax(p_j, conv)
    opt_j = JOptimizer("radam", (0.8, 0.99), 1e-9, weight_decay)
    s_j = opt_j.init(jax.tree_util.tree_map(jnp.asarray, p_j))
    opt_t = TOptimizer((0.8, 0.99), 1e-9, weight_decay, "radam")
    s_t = opt_t.init(conv.parameters())
    assert isinstance(s_t, torch.optim.RAdam)
    lr = 1e-2
    for i in range(10):
        g_j = {"w_orig": rng.randn(*p_j["w_orig"].shape).astype(np.float32),
               "b": rng.randn(4).astype(np.float32), "u": np.zeros(4, np.float32)}
        upd, s_j = opt_j.update(jax.tree_util.tree_map(jnp.asarray, g_j), s_j,
                                jax.tree_util.tree_map(jnp.asarray, p_j), lr)
        p_j = _np(jax.tree_util.tree_map(lambda a, b: a + b, p_j, upd))
        p_j["u"] = np.asarray(p_j["u"])
        conv.weight_orig.grad = params_from_jax({"w_orig": g_j["w_orig"]})["weight_orig"]
        conv.bias.grad = torch.from_numpy(g_j["b"])
        TOptimizer.update(s_t, lr)
        back = params_to_jax(conv.state_dict())
        for k in ("w_orig", "b"):
            np.testing.assert_allclose(back[k], p_j[k], atol=1e-7, rtol=1e-5, err_msg=(i, k))
        # u has no gradient and no update in the port; the JAX chain decays
        # it by (1 - lr wd) an update, which moves no kernel: u enters
        # sn_kernel and sn_update through its direction only
        np.testing.assert_allclose(back["u"] * (1 - lr * weight_decay) ** (i + 1), p_j["u"],
                                   atol=1e-7, rtol=1e-5)
        tree = optimizer_to_jax(s_t, conv)
        inner = s_j.inner_state[0]
        assert int(tree["3"]["0"]["0"]) == int(inner.count) == int(s_j.count) == i + 1
        for mom, k in ((inner.mu, "1"), (inner.nu, "2")):
            for leaf in ("w_orig", "b", "u"):
                np.testing.assert_allclose(tree["3"]["0"][k][leaf], np.asarray(mom[leaf]),
                                           atol=1e-7, rtol=1e-5, err_msg=(i, k, leaf))
    # the state read back from the JAX tree continues identically
    fresh = TOptimizer((0.8, 0.99), 1e-9, weight_decay, "radam").init(conv.parameters())
    optimizer_from_jax(optimizer_to_jax(s_t, conv), fresh, conv)
    for p in conv.parameters():
        for k in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(fresh.state[p][k], s_t.state[p][k])
        assert int(fresh.state[p]["step"]) == 10
