"""The port's multi-period discriminator and GAN losses against the JAX
package on the CPU, with the JAX `init_params` weights (weight-norm g/v
pairs kept trainable) carried across by `vits_tpu_torch.convert`.

Tolerances: scores and feature maps atol 1e-5 with rtol 1e-4 (fp32 convs of
up to 1024 channels, sums in another order); losses rtol 1e-5; the
gradients of the discriminator loss atol 1e-5 with rtol 1e-3 of each
tensor's largest magnitude (a backward through five convs). The JAX graphs
compile at XLA's lowest backend optimisation level, which only saves compile
time."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vits_tpu.models.discriminators import MultiPeriodDiscriminator as JMPD
from vits_tpu.train import losses as JL

from vits_tpu_torch.convert import params_from_jax, params_to_jax, state_from_jax
from vits_tpu_torch.models.discriminators import MultiPeriodDiscriminator as TMPD
from vits_tpu_torch.train import losses as TL

FAST_COMPILE = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


@pytest.fixture(scope="module")
def mpd():
    jd = JMPD()
    p = _np(jax.jit(jd.init_params, compiler_options=FAST_COMPILE)(jax.random.PRNGKey(11)))
    td = params_from_jax(p, TMPD())
    rng = np.random.RandomState(0)
    T = 250  # a multiple of no period: every DiscriminatorP reflect-pads
    y = rng.uniform(-0.5, 0.5, (2, T, 1)).astype(np.float32)
    y_hat = rng.uniform(-0.5, 0.5, (2, T, 1)).astype(np.float32)
    out_j = _np(jax.jit(jd.apply, compiler_options=FAST_COMPILE)(p, jnp.asarray(y),
                                                                 jnp.asarray(y_hat)))
    return jd, p, td, y, y_hat, out_j


def test_mpd_scores_and_fmaps(mpd):
    _, p, td, y, y_hat, out_j = mpd
    with torch.no_grad():
        out_t = td(torch.from_numpy(y), torch.from_numpy(y_hat))
    for part_j, part_t in zip(out_j[:2], out_t[:2]):  # scores (B, n) per sub-discriminator
        assert len(part_j) == len(part_t) == 6
        for a, b in zip(part_j, part_t):
            assert tuple(b.shape) == a.shape
            np.testing.assert_allclose(b.numpy(), a, atol=1e-5, rtol=1e-4)
    for part_j, part_t in zip(out_j[2:], out_t[2:]):  # fmaps in the JAX layouts
        for fj, ft in zip(part_j, part_t):
            assert len(fj) == len(ft)
            for a, b in zip(fj, ft):
                assert tuple(b.shape) == a.shape
                np.testing.assert_allclose(b.numpy(), a, atol=1e-5, rtol=1e-4)
    back = params_to_jax(td.state_dict())
    jax.tree_util.tree_map(np.testing.assert_array_equal, back, p)


def test_losses_and_disc_grads(mpd):
    jd, p, td, y, y_hat, out_j = mpd
    y_d_r, y_d_g, fmap_r, fmap_g = out_j
    as_t = lambda xs: [torch.from_numpy(np.array(a)) for a in xs]
    ld_j, r_j, g_j = JL.discriminator_loss(y_d_r, y_d_g)
    ld_t, r_t, g_t = TL.discriminator_loss(as_t(y_d_r), as_t(y_d_g))
    np.testing.assert_allclose(float(ld_t), float(ld_j), rtol=1e-5)
    np.testing.assert_allclose(torch.stack(r_t).numpy(), np.stack(r_j), rtol=1e-5)
    np.testing.assert_allclose(torch.stack(g_t).numpy(), np.stack(g_j), rtol=1e-5)
    lg_j, per_j = JL.generator_loss(y_d_g)
    lg_t, per_t = TL.generator_loss(as_t(y_d_g))
    np.testing.assert_allclose(float(lg_t), float(lg_j), rtol=1e-5)
    np.testing.assert_allclose(torch.stack(per_t).numpy(), np.stack(per_j), rtol=1e-5)
    fm_t = TL.feature_loss([as_t(f) for f in fmap_r], [as_t(f) for f in fmap_g])
    np.testing.assert_allclose(float(fm_t), float(JL.feature_loss(fmap_r, fmap_g)), rtol=1e-5)
    rng = np.random.RandomState(1)
    z_p, logs_q, m_p, logs_p = (rng.randn(2, 9, 4).astype(np.float32) * 0.5 for _ in range(4))
    z_mask = (np.arange(9)[None, :, None] < np.array([9, 6])[:, None, None]).astype(np.float32)
    args = (z_p, logs_q, m_p, logs_p, z_mask)
    np.testing.assert_allclose(float(TL.kl_loss(*map(torch.from_numpy, args))),
                               float(JL.kl_loss(*map(jnp.asarray, args))), rtol=1e-5)

    # the discriminator loss's gradients, every g, v and bias
    def d_loss(pp):
        r, g, _, _ = jd.apply(pp, jnp.asarray(y), jnp.asarray(y_hat))
        return JL.discriminator_loss(r, g)[0]
    grads_j = state_from_jax(_np(jax.jit(jax.grad(d_loss), compiler_options=FAST_COMPILE)(p)),
                             set(td.state_dict()))
    td.zero_grad(set_to_none=True)
    r, g, _, _ = td(torch.from_numpy(y), torch.from_numpy(y_hat))
    TL.discriminator_loss(r, g)[0].backward()
    for name, prm in td.named_parameters():
        want = grads_j[name].numpy()
        np.testing.assert_allclose(prm.grad.numpy(), want,
                                   atol=1e-5 + 1e-3 * float(np.abs(want).max()), rtol=0,
                                   err_msg=name)
