"""The int8 ResBlock2-chain kernel's host side on the CPU: the plan (form,
tile, shared memory, launches), the packed wgmma weight layout, and a tiled
emulation of the whole-chain form that holds the halo arithmetic the kernel
relies on, array-equal to the plain chain over the whole sequence."""

import numpy as np
import pytest
import torch

from vits_tpu_torch.config import default_config_path, get_hparams_from_file
from vits_tpu_torch.models.modules import ResBlock2
from vits_tpu_torch.nn import rb_chain
from vits_tpu_torch.nn.core import init_weights


def _chains(name="base"):
    """(C, k, dilations, M at 256 frames) of a config's 12 chains."""
    m = get_hparams_from_file(default_config_path(name)).model
    out, up = [], 1
    for s, u in enumerate(m.upsample_rates):
        up *= u
        for k, dil in zip(m.resblock_kernel_sizes, m.resblock_dilation_sizes):
            out.append((m.upsample_initial_channel // 2 ** (s + 1), k, tuple(dil), 256 * up))
    return out


BASE = _chains()
ADAPT = _chains("adapt")  # 8 kHz, hop 96: M = T_y x (6, 24, 48, 96)
# the longest fused frame budget (the 4096-frame noise ring) at the last stage
FUSED_M = 4096 * 192
# the forms the arithmetic gives: a whole-chain tile of 64 frames fits beside
# one dilation's weights everywhere but C = 256 and C = 128 at k = 7, 11
SPLIT = {(256, 3), (256, 7), (256, 11), (128, 7), (128, 11)}


@pytest.mark.parametrize("C,k,dil,M256", BASE, ids=[f"C{c}-k{k}" for c, k, _, _ in BASE])
def test_plan_base_chain(C, k, dil, M256):
    assert rb_chain.kernel_form(C, k, dil) == ("split" if (C, k) in SPLIT else "chain")
    for B in (1, 4, 8):
        for M in (16, 17, 100, 1000, 2048, 4097, M256, 256 * 192, FUSED_M):
            p = rb_chain.plan(B, M, C, k, dil)
            assert p.smem <= rb_chain.SMEM_LIMIT == 232448
            starts = range(0, M, p.T)
            covered = np.zeros(M, np.int32)
            for t0 in starts:
                covered[t0:t0 + p.T] += 1
            assert (covered == 1).all()
            assert p.tiles == B * len(starts)
            if p.form == "chain":
                assert p.halo == sum((d + 1) * (k - 1) // 2 for d in dil)
                assert p.launches == 1
                assert 1 <= p.grid <= p.tiles
                lay = rb_chain.chain_layout(C, k, len(dil), p.T, p.halo, p.resident)
                assert lay[:-1] == p.offsets and lay[-1] == p.smem
                assert all(o % 16 == 0 for o in p.offsets[:3]) and p.offsets[3] % 8 == 0
            else:
                assert p.T == rb_chain.SPLIT_ROWS and p.launches == 2 * len(dil)
                assert p.halo == max(dil) * (k - 1) // 2
                assert p.grid == p.tiles * C // 64
                assert p.offsets == tuple(rb_chain.split_layout(C, k, d, mode)
                                          for d in dil for mode in (0, 1))
                assert p.smem == max(lay[-1] for lay in p.offsets)
    assert rb_chain.plan(1, M256, C, k, dil).launches == (6 if (C, k) in SPLIT else 1)


@pytest.mark.parametrize("C,k,dil,M256", ADAPT, ids=[f"C{c}-k{k}" for c, k, _, _ in ADAPT])
def test_plan_adapt_chain(C, k, dil, M256):
    """Every chain of configs/adapt.json (upsampling 6, 4, 2, 2; the base
    config's channels, kernels and dilations) has a whole-chain or a split
    form at the lengths a cloned voice's requests give (T_y of 1-2000
    frames, and the [sat] phase's 256) and the fused budget's, within
    shared memory, with the launches the K1 count of chip_smoke.py's [sat]
    phase expects: 37 a decode."""
    up = M256 // 256
    assert rb_chain.kernel_form(C, k, dil) == ("split" if (C, k) in SPLIT else "chain")
    for t_y in (1, 37, 256, 700, 1000, 2000, 4096):
        p = rb_chain.plan(1, t_y * up, C, k, dil)
        assert p.form == rb_chain.kernel_form(C, k, dil)
        assert p.smem <= rb_chain.SMEM_LIMIT and 1 <= p.grid
        assert p.launches == (6 if p.form == "split" else 1)
        if p.form == "chain":
            assert p.T % 32 == 0 and 64 <= p.T <= 512
            assert p.offsets + (p.smem,) == rb_chain.chain_layout(
                C, k, len(dil), p.T, p.halo, p.resident)
    assert sum(rb_chain.plan(1, M, C, k, dil).launches for C, k, dil, M in ADAPT) == 37


def test_plan_refuses_shapes_without_a_kernel():
    assert rb_chain.kernel_form(16, 3, (1, 3, 5)) is None
    assert rb_chain.kernel_form(32, 4, (1, 3)) is None
    with pytest.raises(ValueError, match="no kernel"):
        rb_chain.plan(1, 100, 96, 3, (1, 3, 5))


def _unpack_kmajor(packed, K, C_in, C_out, nb, glu):
    """The inverse of pack_kmajor, element by element from its byte formula."""
    nb = nb or C_out
    G, KB = C_out // nb, -(-C_in // 32)
    p = packed.reshape(G, K, KB, nb * 32).numpy()
    w = np.zeros((K, KB * 32, C_out), np.int8)
    for g in range(G):
        for n in range(nb):
            if glu:
                half = n >= nb // 2
                col = half * (C_out // 2) + g * nb // 2 + n - half * nb // 2
            else:
                col = g * nb + n
            for kk in range(KB * 32):
                byte = (n // 8) * 256 + ((kk % 32) // 16) * 128 + (n % 8) * 16 + kk % 16
                w[:, kk, col] = p[g, :, kk // 32, byte]
    return w


@pytest.mark.parametrize("K,C_in,C_out,nb,glu", [(3, 32, 32, None, False),
                                                 (3, 16, 32, None, False),
                                                 (2, 64, 128, 64, True),
                                                 (2, 64, 128, 64, False)])
def test_kmajor_packing_round_trips(K, C_in, C_out, nb, glu):
    """The wgmma operand packing holds every weight once at the byte its
    core-matrix formula names; padded input channels are zero."""
    w8 = torch.randint(-127, 128, (K, C_in, C_out), dtype=torch.int8,
                       generator=torch.Generator().manual_seed(K + C_in))
    packed = rb_chain.pack_kmajor(w8, nb, glu=glu)
    G = C_out // (nb or C_out)
    assert packed.dtype == torch.int8 and packed.shape == (G, K, -(-C_in // 32) * 32 *
                                                           (nb or C_out))
    back = _unpack_kmajor(packed, K, C_in, C_out, nb, glu)
    np.testing.assert_array_equal(back[:, :C_in], w8.numpy())
    assert not back[:, C_in:].any()


def test_kernel_operands_of_a_chain():
    gen = torch.Generator().manual_seed(5)
    rb = init_weights(ResBlock2(32, 3, (1, 3, 5), 8), gen).eval()
    rec = {}
    with torch.no_grad():
        rb(torch.randn(1, 40, 32, generator=gen), torch.randn(1, 8, generator=gen), record=rec)
    qp = rb.quantize_params(rec)
    kp = qp["kernel"]
    assert kp["form"] == "chain" and kp["vec"].shape == (3, 4 * 32 + 4)
    assert kp["wq"].shape == (3 * 3 * 32 * (32 + 32),)
    for i, it in enumerate(qp["iters"]):
        v = kp["vec"][i]
        assert torch.equal(v[:32], it["s_in1"] * it["s_w1"]) and torch.equal(v[32:64], it["b1"])
        assert torch.equal(v[64:96], it["s_in2"] * it["s_w2"])
        assert torch.equal(v[96:128], it["b2"])
        assert float(v[128]) == float(it["s_in1"]) and float(v[129]) == float(it["s_in2"])


def _chain_case(C, k, dil, B, M, seed):
    gen = torch.Generator().manual_seed(seed)
    rb = init_weights(ResBlock2(C, k, dil, 8), gen).eval()
    lens = [M - 1 - 37 * i for i in range(B)]
    valid = torch.tensor(lens, dtype=torch.int32)
    mask = (torch.arange(M)[None, :] < valid[:, None]).float()[..., None]
    x = torch.randn(B, M, C, generator=gen) * mask
    g = torch.randn(B, 8, generator=gen)
    rec = {}
    with torch.no_grad():
        rb(x, g, x_mask=mask, record=rec)
        gs = torch.stack([rb.conds[str(i)](g) for i in range(len(dil))], 1)
    return rb.quantize_params(rec), x, gs, valid, gen


@pytest.mark.parametrize("C,k,dil,B,M,T", [(32, 3, (1, 3, 5), 2, 400, None),
                                           (32, 7, (1, 3, 5), 2, 300, 64),
                                           (64, 11, (1, 3, 5), 1, 333, 128),
                                           (32, 5, (1, 3), 3, 250, 64)])
def test_tiled_whole_chain_equals_plain(C, k, dil, B, M, T):
    """Each whole-chain tile of T frames sees the input only on its frames
    plus `halo` per side; everything beyond is replaced by noise (the rows a
    tile computes outside its shrinking valid region hold garbage), and the
    sequence's own edges keep the conv's zero padding. The central T frames,
    stitched, equal the plain chain over the whole sequence bit for bit.
    The tiles run at the full sequence length, so every element sits where
    it sits in the full run and takes the same vectorized arithmetic."""
    qp, x, gs, valid, gen = _chain_case(C, k, dil, B, M, C + k + M)
    p = rb_chain.plan(B, M, C, k, dil)
    T = T or p.T
    h = rb_chain.chain_halo(k, dil)
    assert h == p.halo
    full = rb_chain.chain_q8_plain(qp, x, gs, valid)
    out = torch.full_like(full, float("nan"))
    frames = torch.arange(M)
    for t0 in range(0, M, T):
        seen = ((frames >= t0 - h) & (frames < t0 + T + h))[None, :, None]
        xt = torch.where(seen, x, 3 * torch.randn(x.shape, generator=gen))
        out[:, t0:t0 + T] = rb_chain.chain_q8_plain(qp, xt, gs, valid)[:, t0:t0 + T]
    np.testing.assert_array_equal(out.numpy(), full.numpy())
    # half the halo is not enough: the noise reaches the central frames
    t0 = T if M > 2 * T + 2 * h else 0
    seen = ((frames >= t0 - h // 2) & (frames < t0 + T + h // 2))[None, :, None]
    xt = torch.where(seen, x, 3 * torch.randn(x.shape, generator=gen))
    short = rb_chain.chain_q8_plain(qp, xt, gs, valid)[:, t0:t0 + T]
    assert not torch.equal(short, full[:, t0:t0 + T])
