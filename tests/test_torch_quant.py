"""The port's int8 ops against the JAX package on the CPU: exact int32
accumulators, the per-phase transposed-conv scales of the JAX package's
packed quantization (rtol 1e-5), pack-independent regular-conv scales, and
the plain int8 ResBlock2 chain (the CUDA kernel's reference) against JAX
`apply_q8` and the Pallas kernel in interpret mode. Chain tolerance: atol
0.05 * max(1, max|ref|) with under 1% of elements off by more than
1e-3 * max|ref| (only the gate's transcendental rounding may differ, and
it can move a quantized gate by one step)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vits_tpu.models.modules import ResBlock2 as JResBlock2
from vits_tpu.models.synthesizer import Generator as JGenerator
from vits_tpu.nn import quant as JQ
from vits_tpu.nn.packed import mask_packed
from vits_tpu.nn.pallas_rb import resblock2_chain_q8 as pallas_chain

from vits_tpu_torch.config import default_config_path, get_hparams_from_file
from vits_tpu_torch.convert import params_from_jax
from vits_tpu_torch.models.modules import ResBlock2 as TResBlock2
from vits_tpu_torch.nn import quant as TQ
from vits_tpu_torch.nn import rb_chain


def _t(a, dtype=torch.float32):
    return torch.tensor(np.asarray(a), dtype=dtype)


def _chain_close(out, ref):
    out, ref = np.asarray(out, np.float32), np.asarray(ref, np.float32)
    assert out.shape == ref.shape
    diff = np.abs(out - ref)
    peak = np.abs(ref).max()
    assert diff.max() <= 0.05 * max(1.0, peak), diff.max()
    assert (diff > 1e-3 * peak).mean() < 0.01, (diff > 1e-3 * peak).mean()


@pytest.mark.parametrize("K,dil", [(3, 1), (5, 3), (7, 5)])
def test_conv1d_q8_exact(K, dil):
    rng = np.random.RandomState(K)
    x8 = rng.randint(-127, 128, size=(2, 19, 24)).astype(np.int8)
    w8 = rng.randint(-127, 128, size=(K, 24, 16)).astype(np.int8)
    pad = dil * (K - 1) // 2
    acc_j = jax.lax.conv_general_dilated(
        jnp.asarray(x8), jnp.asarray(w8), (1,), [(pad, pad)],
        dimension_numbers=("NWC", "WIO", "NWC"), rhs_dilation=(dil,),
        preferred_element_type=jnp.int32)
    acc_t = TQ.conv1d_acc(torch.from_numpy(x8), torch.from_numpy(w8), dil, pad)
    assert acc_t.dtype == torch.int32
    np.testing.assert_array_equal(acc_t.numpy(), np.asarray(acc_j))
    s_w = rng.uniform(0.001, 0.01, 16).astype(np.float32)
    b = rng.randn(16).astype(np.float32)
    y_j = JQ.conv1d_q8(jnp.asarray(x8), jnp.asarray(w8), -pad, pad, jnp.float32(0.02),
                       jnp.asarray(s_w), jnp.asarray(b), out_dtype=jnp.float32,
                       rhs_dilation=dil)
    y_t = TQ.conv1d_q8(torch.from_numpy(x8), torch.from_numpy(w8), torch.tensor(0.02),
                       torch.from_numpy(s_w), torch.from_numpy(b), dilation=dil, padding=pad)
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), rtol=1e-6, atol=1e-6)


def _base_transposed_geometries():
    """(k, u, pad, p_in) of every base-config upsample, p_in from the JAX
    package's own pack schedule."""
    m = get_hparams_from_file(default_config_path("base")).model
    gen = JGenerator(m.inter_channels, m.resblock, tuple(m.resblock_kernel_sizes),
                     tuple(map(tuple, m.resblock_dilation_sizes)), tuple(m.upsample_rates),
                     m.upsample_initial_channel, tuple(m.upsample_kernel_sizes))
    packs = gen._pack_schedule()
    out, p_in = [], 1
    for i, (u, k) in enumerate(zip(m.upsample_rates, m.upsample_kernel_sizes)):
        out.append((k, u, (k - u) // 2, p_in))
        p_in = packs[i]
    return out


@pytest.mark.parametrize("k,u,pad,p_in", _base_transposed_geometries())
def test_transposed_phase_scales_match_packed(k, u, pad, p_in):
    """The port's polyphase (phase mod stride, channel) scales are the JAX
    package's packed per-column scales, and the int8 upsample computes the
    same output as its packed int8 conv."""
    rng = np.random.RandomState(k * 10 + p_in)
    C_in, C_out, B, T = 8, 4, 2, 6 * p_in
    w = rng.randn(k, C_in, C_out).astype(np.float32) * np.linspace(0.2, 2.0, k)[:, None, None]
    w8_j, s_j = JQ.pack_quantize_transposed_kernel(jnp.asarray(w), k, p_in, u, pad)
    w8_t, s_t = TQ.quantize_transposed_kernel(torch.from_numpy(w), u, pad)
    s_j = np.asarray(s_j).reshape(p_in * u, C_out)
    np.testing.assert_allclose(np.tile(s_t.numpy(), (p_in, 1)), s_j, rtol=1e-5)

    x8 = rng.randint(-127, 128, size=(B, T, C_in)).astype(np.int8)
    fmin, fmax = JQ.transposed_geometry(k, p_in, u, pad)
    y_j = JQ.conv1d_q8(jnp.asarray(x8.reshape(B, T // p_in, p_in * C_in)), w8_j, fmin, fmax,
                       jnp.float32(0.03), jnp.asarray(s_j.reshape(-1)), None,
                       out_dtype=jnp.float32)
    wsub, dmin, dmax = TQ.transposed_subpixel_kernel(w8_t, u, pad)
    y_t = TQ.conv_transpose1d_q8(torch.from_numpy(x8), wsub, dmin, dmax, torch.tensor(0.03),
                                 s_t)
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j).reshape(B, T * u, C_out),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("K,pack,dil", [(3, 2, 5), (11, 4, 3), (7, 4, 1)])
def test_regular_conv_scales_pack_independent(K, pack, dil):
    """A regular conv's packed columns each see every tap, so the JAX
    package's packed scales are the pack-1 per-channel scales."""
    w = np.random.RandomState(K).randn(K, 8, 6).astype(np.float32)
    _, s_packed, _, _, _ = JQ.pack_quantize_kernel(jnp.asarray(w), K, pack, dil,
                                                   dil * (K - 1) // 2)
    _, s_t = TQ.quantize_kernel(torch.from_numpy(w))
    np.testing.assert_allclose(np.asarray(s_packed).reshape(pack, 6),
                               np.tile(s_t.numpy(), (pack, 1)), rtol=1e-5)


def _port_chain(jrb, p, rec, x, g, mask):
    """The port's plain chain on the JAX block's weights and calibration."""
    trb = params_from_jax(jax.tree_util.tree_map(np.asarray, p),
                          TResBlock2(jrb.channels, jrb.kernel_size, jrb.dilation,
                                     jrb.gin_channels)).eval()
    qp = trb.quantize_params({k: _t(v) for k, v in rec.items()})
    with torch.no_grad():
        return trb.apply_q8(qp, _t(x), _t(g), x_mask=_t(mask)), trb, qp


@pytest.mark.parametrize("C,pack,ks,dil,B,M", [
    (16, 2, 3, (1, 3), 2, 12),
    (32, 1, 3, (1, 3, 5), 2, 20),
    (16, 4, 5, (1, 3, 5), 1, 16),
])
def test_plain_chain_matches_apply_q8_and_pallas(C, pack, ks, dil, B, M):
    """test_pallas_rb.py's three shapes, at fp32. The JAX block runs phase
    packed at `pack`; the port runs the same frames unpacked."""
    rng = np.random.RandomState(0)
    jrb = JResBlock2(channels=C, kernel_size=ks, dilation=dil, gin_channels=16)
    p = jax.jit(jrb.init_params)(jax.random.PRNGKey(1))
    T = M * pack
    x = rng.randn(B, T, C).astype(np.float32)
    g = rng.randn(B, 16).astype(np.float32)
    lens = [T - 3 * (i % 2) - 1 for i in range(B)]
    mask = (np.arange(T)[None, :, None] < np.asarray(lens)[:, None, None]).astype(np.float32)
    x = x * mask
    xp = jnp.asarray(x.reshape(B, M, pack * C))
    gj, mj = jnp.asarray(g), jnp.asarray(mask)

    @jax.jit
    def calibrate(p, xp, gj, mj):
        rec = {}
        if pack > 1:
            jrb.apply_packed(p, xp, gj, pack, x_mask=mj, record=rec)
        else:
            jrb.apply(p, xp, gj, x_mask=mj, record=rec)
        return rec

    rec = jax.device_get(calibrate(p, xp, gj, mj))
    qp = jax.jit(lambda p, rec: jrb.quantize_params(p, rec, pack))(p, rec)
    ref = np.asarray(jax.jit(lambda qp, xp, gj, mj: jrb.apply_q8(qp, xp, gj, pack=pack,
                                                                  x_mask=mj))(
        qp, xp, gj, mj)).reshape(B, T, C)
    pal = np.asarray(jax.jit(lambda qp, xp, gj, mj: pallas_chain(
        jrb, qp, mask_packed(xp, mj, pack), gj, pack=pack, x_mask=mj, chunk=M,
        interpret=True))(qp, xp, gj, mj)).reshape(B, T, C)
    out, trb, tqp = _port_chain(jrb, p, rec, x, g, mask)
    _chain_close(out, ref)
    _chain_close(out, pal)
    # a CPU tensor takes the plain version through the kernel's entry point
    gs = torch.stack([trb.conds[str(i)](_t(g)) for i in range(len(dil))], 1).detach()
    valid = torch.tensor(lens, dtype=torch.int32)
    np.testing.assert_array_equal(
        rb_chain.resblock2_chain_q8(tqp, _t(x), gs, valid).numpy(),
        rb_chain.chain_q8_plain(tqp, _t(x), gs, valid).numpy())


def test_kernel_operand_layout():
    """The packed weight words hold 4 consecutive input channels, lowest
    byte first (the kernel's __dp4a operand)."""
    w8 = torch.randint(-127, 128, (3, 8, 5), dtype=torch.int8)
    words = rb_chain.pack_words(w8)
    assert words.shape == (3, 2, 5) and words.dtype == torch.int32
    b = words.contiguous().view(torch.int8).reshape(3, 2, 5, 4)
    assert torch.equal(b.permute(0, 1, 3, 2).reshape(3, 8, 5), w8)
    ops, nbytes = rb_chain.chain_ops_bytes(1, 2048, 256, 11, 3)
    assert ops == 9 * 2048 * 11 * 256 * 256
    assert nbytes > 2 * 2048 * 256 * 4
