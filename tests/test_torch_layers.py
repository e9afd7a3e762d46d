"""The port's layers, sequence ops, text encoder, WN and reverse coupling
against the JAX package at fp32 on the CPU (atol 1e-5): same numpy-seeded
inputs, JAX weights carried across with `vits_tpu_torch.convert`."""

import numpy as np
import pytest
import torch
from torch import nn

import jax
import jax.numpy as jnp

from vits_tpu.models import attentions as jatt
from vits_tpu.models import modules as jmod
from vits_tpu.nn import core as jcore
from vits_tpu.ops import seq as jseq

from vits_tpu_torch.convert import params_from_jax
from vits_tpu_torch.models import attentions as tatt
from vits_tpu_torch.models import modules as tmod
from vits_tpu_torch.nn import core as tcore
from vits_tpu_torch.ops import seq as tseq

ATOL = 1e-5


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _load(module, jparams, transposed=False):
    """Load a JAX tree into a port module. The converter knows a transposed
    conv by its place in the decoder ("ups.<i>"); a lone one is wrapped so."""
    if transposed:
        tl = params_from_jax(_np({"ups": {"0": jparams}}),
                             nn.ModuleDict({"ups": nn.ModuleDict({"0": module})}))
        return tl["ups"]["0"].eval()
    return params_from_jax(_np(jparams), module).eval()


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _init(layer, seed):
    return jax.jit(layer.init_params)(jax.random.PRNGKey(seed))


def _close(jax_out, torch_out, atol=ATOL):
    np.testing.assert_allclose(torch_out.detach().numpy(), np.asarray(jax_out), atol=atol,
                               rtol=0)


@pytest.mark.parametrize("case", ["dense", "dense_wn", "conv", "conv_dil_groups", "conv_wn",
                                  "convT_subpixel", "convT_wn", "layernorm", "embedding"])
def test_core_layer(case):
    rng = np.random.RandomState(0)
    x = rng.randn(2, 13, 8).astype(np.float32)
    transposed = False
    if case.startswith("dense"):
        jl, tl = jcore.Dense(8, 6, weight_norm=case == "dense_wn"), tcore.Dense(8, 6)
    elif case == "conv":
        jl, tl = jcore.Conv1d(8, 6, 5, padding=2), tcore.Conv1d(8, 6, 5, padding=2)
    elif case == "conv_dil_groups":
        jl = jcore.Conv1d(8, 4, 3, padding=3, dilation=3, groups=2)
        tl = tcore.Conv1d(8, 4, 3, padding=3, dilation=3, groups=2)
    elif case == "conv_wn":
        jl = jcore.Conv1d(8, 6, 3, padding=1, weight_norm=True)
        tl = tcore.Conv1d(8, 6, 3, padding=1)
    elif case.startswith("convT"):
        jl = jcore.ConvTranspose1d(8, 4, 12, 6, padding=3, weight_norm=case == "convT_wn")
        tl, transposed = tcore.ConvTranspose1d(8, 4, 12, 6, padding=3), True
    elif case == "layernorm":
        jl, tl = jcore.LayerNorm(8), tcore.LayerNorm(8)
    else:
        jl, tl = jcore.Embedding(10, 8), tcore.Embedding(10, 8)
        x = np.array([[1, 9, 0], [3, 3, 7]])
    p = _init(jl, 1)
    if case == "layernorm":
        p = {"gamma": jnp.asarray(rng.randn(8)), "beta": jnp.asarray(rng.randn(8))}
    tl = _load(tl, p, transposed)
    tx = torch.from_numpy(x) if case == "embedding" else _t(x)
    _close(jax.jit(jl.apply)(p, jnp.asarray(x)), tl(tx))
    if transposed:  # the JAX subpixel form's plain lhs-dilated twin agrees too
        plain = jcore.ConvTranspose1d(8, 4, 12, 6, padding=3, subpixel=False,
                                      weight_norm=case == "convT_wn")
        _close(jax.jit(plain.apply)(p, jnp.asarray(x)), tl(tx))


def test_leaky_relu_and_weight_norm_fold():
    x = np.random.RandomState(1).randn(4, 7).astype(np.float32)
    _close(jcore.leaky_relu(jnp.asarray(x), 0.1), tcore.leaky_relu(_t(x), 0.1), atol=0)
    p = _init(jcore.ConvTranspose1d(6, 4, 4, 2, padding=1, weight_norm=True), 2)
    p["g"] = p["g"] * 1.7  # make the fold non-trivial
    np.testing.assert_allclose(tcore.fold_weight_norm(_np(p))["w"],
                               np.asarray(jcore.fold_weight_norm(p)["w"]), atol=ATOL)


def test_seq_ops():
    rng = np.random.RandomState(2)
    lengths = np.array([5, 9, 1], np.int32)
    np.testing.assert_array_equal(
        tseq.sequence_mask(torch.from_numpy(lengths), 10).numpy(),
        np.asarray(jseq.sequence_mask(jnp.asarray(lengths), 10)))
    dur = rng.randint(0, 4, size=(3, 6)).astype(np.float32)
    x_mask = (np.arange(6)[None] < np.array([6, 4, 2])[:, None]).astype(np.float32)
    t_y = int(dur.sum(1).max()) + 2
    y_mask = (np.arange(t_y)[None] < (dur * x_mask).sum(1)[:, None]).astype(np.float32)
    attn_mask = y_mask[:, :, None] * x_mask[:, None, :]
    np.testing.assert_array_equal(
        tseq.generate_path(_t(dur), _t(attn_mask)).numpy(),
        np.asarray(jseq.generate_path(jnp.asarray(dur), jnp.asarray(attn_mask))))
    np.testing.assert_array_equal(tseq.infer_path(_t(dur), t_y).numpy(),
                                  np.asarray(jseq.infer_path(jnp.asarray(dur), t_y)))
    np.testing.assert_array_equal(tseq.gen_sin_table(40, 16),
                                  np.asarray(jseq.gen_sin_table(40, 16)))


@pytest.mark.parametrize("ffn", ["FFN", "FFN2", "FFN3"])
def test_encoder(ffn):
    rng = np.random.RandomState(3)
    je = jatt.Encoder(16, 24, 2, 2, kernel_size=3, ffn=ffn, gin_channels=8)
    pe = _init(je, 4)
    te = _load(tatt.Encoder(16, 24, 2, 2, kernel_size=3, ffn=ffn, gin_channels=8), pe)
    x = rng.randn(2, 11, 16).astype(np.float32)
    g = rng.randn(2, 8).astype(np.float32)
    m = (np.arange(11)[None, :, None] < np.array([11, 6])[:, None, None]).astype(np.float32)
    out_j = jax.jit(lambda p, x, m, g: je.apply(p, x, m, g=g))(
        pe, jnp.asarray(x), jnp.asarray(m), jnp.asarray(g))
    _close(out_j, te(_t(x), _t(m), g=_t(g)))


def test_wn_and_coupling_reverse():
    rng = np.random.RandomState(5)
    x = rng.randn(2, 17, 8).astype(np.float32)
    g = rng.randn(2, 12).astype(np.float32)
    m = (np.arange(17)[None, :, None] < np.array([17, 10])[:, None, None]).astype(np.float32)
    jw = jmod.WN(16, 5, 2, 3, gin_channels=12)
    pw = _init(jw, 6)
    tw = _load(tmod.WN(16, 5, 2, 3, gin_channels=12), pw)
    h = rng.randn(2, 17, 16).astype(np.float32) * m
    _close(jax.jit(lambda p, h, m, g: jw.apply(p, h, m, g=g))(
        pw, jnp.asarray(h), jnp.asarray(m), jnp.asarray(g)), tw(_t(h), _t(m), g=_t(g)))

    jc = jmod.ResidualCouplingLayer(8, 16, 5, 1, 3, gin_channels=12, mean_only=True)
    pc = dict(_init(jc, 7))
    # the post conv starts at zero (identity flow); give it weights to test
    pc["post"]["w"] = jnp.asarray(rng.randn(*pc["post"]["w"].shape).astype(np.float32) * 0.1)
    pc["post"]["b"] = jnp.asarray(rng.randn(*pc["post"]["b"].shape).astype(np.float32) * 0.1)
    tc = _load(tmod.ResidualCouplingLayer(8, 16, 5, 1, 3, gin_channels=12), pc)
    _close(jax.jit(lambda p, x, m, g: jc.apply(p, x, m, g=g, reverse=True))(
        pc, jnp.asarray(x), jnp.asarray(m), jnp.asarray(g)), tc(_t(x), _t(m), g=_t(g)))
    _close(jmod.flip_channels(jnp.asarray(x)), tmod.flip_channels(_t(x)), atol=0)
