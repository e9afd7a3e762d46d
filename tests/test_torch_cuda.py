"""The port's CUDA kernels on the card: the int8 ResBlock2 chain against its
plain PyTorch version at small shapes, through both of its forms, with the
launches its plan gives (tolerance of chip_smoke.py: atol
0.05 * max(1, max|plain|), under 1% of elements off by more than
1e-3 * max|plain|), bit-equal over the fused budget, and in its bfloat16
form bit-equal at every base-config chain (the plain version rounds to
bf16 where the kernel does); and MAS against its plain version,
array-equal (the same f32 adds and maxes), in the form its plan picks, on
f32 and on bf16 input; that ranks sharing a card never get NCCL; and the
float decoder's two glue kernels against their plain twins at every stage
shape of the base and VCTK decoders, and a packed decode replayed from a
CUDA graph. Marked `cuda`; skips
where no CUDA device is present. Run on the GPU machine with
`python -m pytest --noconftest tests/test_torch_cuda.py -q` (tests/conftest.py
imports jax, which that machine need not have)."""

import copy
import dataclasses

import pytest
import torch

from vits_tpu_torch.models.modules import ResBlock2
from vits_tpu_torch.models.synthesizer import Generator
from vits_tpu_torch.nn import dec_glue, rb_chain
from vits_tpu_torch.nn.core import init_weights
from vits_tpu_torch.ops import mas
from vits_tpu_torch.parallel import dist
from vits_tpu_torch.serve.graphs import Graph

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU form)")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("C,k,dil,B,M,form", [(32, 3, (1, 3, 5), 2, 300, "chain"),
                                              (64, 7, (1, 3), 1, 129, "chain"),
                                              (64, 7, (1, 3, 5), 4, 1000, "chain"),
                                              (128, 11, (1, 3, 5), 3, 77, "split")])
def test_chain_kernel_matches_plain(cuda, C, k, dil, B, M, form):
    gen = torch.Generator().manual_seed(C + k + B)
    rb = init_weights(ResBlock2(C, k, dil, 16), gen).to(cuda).eval()
    x = torch.randn(B, M, C, generator=gen).to(cuda)
    # ragged: the first length runs past M (the kernel clamps it), B = 4 cuts
    # tiles and halos at odd places
    lens = torch.tensor([M + 7 - 12 * i if B < 4 else M - 293 * i - 7 * (i % 2)
                         for i in range(B)], dtype=torch.int32, device=cuda)
    mask = (torch.arange(M, device=cuda)[None] < lens[:, None]).float()[..., None]
    x = x * mask
    g = torch.randn(B, 16, generator=gen).to(cuda)
    with torch.no_grad():
        rec = {}
        rb(x, g, x_mask=mask, record=rec)
        qp = rb.quantize_params(rec)
        gs = torch.stack([rb.conds[str(i)](g) for i in range(len(dil))], 1).float()
    plan = rb_chain.plan(B, M, C, k, dil, torch.cuda.get_device_properties(cuda)
                         .multi_processor_count)
    assert plan.form == form
    before = rb_chain.counter.launches
    out = rb_chain.resblock2_chain_q8(qp, x, gs, lens)
    assert rb_chain.counter.launches - before == plan.launches
    ref = rb_chain.chain_q8_plain(qp, x, gs, lens)
    torch.cuda.synchronize()
    diff = (out - ref).abs()
    peak = float(ref.abs().max())
    assert float(diff.max()) <= 0.05 * max(1.0, peak)
    assert float((diff > 1e-3 * peak).float().mean()) < 0.01


def _tampered(p):
    """Plans one number off the shape's own: each must be refused."""
    if p.form == "chain":
        o = p.offsets
        return [dataclasses.replace(p, **kw) for kw in (
            {"T": p.T + 32}, {"T": p.T + 1}, {"halo": p.halo - 1}, {"smem": p.smem + 16},
            {"grid": p.grid + 1}, {"resident": not p.resident},
            {"offsets": (o[0], o[1] + 16) + o[2:]})]
    (a, bar, smem), rest = p.offsets[0], p.offsets[1:]
    return [dataclasses.replace(p, offsets=((a + 64, bar, smem),) + rest),
            dataclasses.replace(p, offsets=((a, bar, smem + 8),) + rest),
            dataclasses.replace(p, offsets=rest[:1] + rest[:1] + rest[1:])]


def _chain_case(cuda, C, k, dil, B, M, seed):
    """A quantized ResBlock2 and its masked input (every length M - 5)."""
    gen = torch.Generator().manual_seed(seed)
    rb = init_weights(ResBlock2(C, k, dil, 16), gen).to(cuda).eval()
    x = torch.randn(B, M, C, generator=gen).to(cuda)
    lens = torch.full((B,), max(M - 5, 1), dtype=torch.int32, device=cuda)
    mask = (torch.arange(M, device=cuda)[None] < lens[:, None]).float()[..., None]
    x = x * mask
    g = torch.randn(B, 16, generator=gen).to(cuda)
    with torch.no_grad():
        rec = {}
        rb(x, g, x_mask=mask, record=rec)
        qp = rb.quantize_params(rec)
        gs = torch.stack([rb.conds[str(i)](g) for i in range(len(dil))], 1).float()
    return qp, x, gs, lens


@pytest.mark.parametrize("C,k,B,M", [(64, 7, 2, 700), (32, 11, 1, 4800), (256, 3, 1, 300)])
def test_chain_kernel_refuses_a_tampered_plan(cuda, C, k, B, M):
    """rb2_chain_q8 / rb2_split_q8 recompute the plan from the shape and
    refuse numbers that differ: a caller's plan (chain_q8_cuda's tuning
    hook) one tile, halo, byte, block or offset off raises and launches
    nothing, while another tile the rules allow runs and matches."""
    dil = (1, 3, 5)
    qp, x, gs, lens = _chain_case(cuda, C, k, dil, B, M, C * k)
    n_sm = torch.cuda.get_device_properties(cuda).multi_processor_count
    p = rb_chain.plan(B, M, C, k, dil, n_sm)
    for bad in _tampered(p):
        before = rb_chain.counter.launches
        with pytest.raises(RuntimeError, match="invalid argument"):
            rb_chain.chain_q8_cuda(qp, x, gs, lens, bad)
        assert rb_chain.counter.launches == before
    ref = rb_chain.chain_q8_plain(qp, x, gs, lens)
    others = [rb_chain.chain_plan(B, M, C, k, dil, T, n_sm) for T in (64, 96)] \
        if p.form == "chain" else [p]
    for q in filter(None, others):
        out = rb_chain.chain_q8_cuda(qp, x, gs, lens, q)
        torch.cuda.synchronize()
        assert float((out - ref).abs().max()) <= 0.05 * max(1.0, float(ref.abs().max()))


@pytest.mark.parametrize("B,M", [(1, 37), (2, 1536), (1, 24576)])
@pytest.mark.parametrize("C,k,dil", [(32, 3, (1, 3, 5)), (32, 11, (1, 3, 5)), (64, 7, (1, 3, 5)),
                                     (64, 3, (1, 3)), (128, 3, (1, 3, 5)), (128, 7, (1, 3, 5)),
                                     (256, 11, (1, 3, 5))])
def test_chain_plan_agrees_with_the_kernel(cuda, C, k, dil, B, M):
    """The C entries keep their own copy of nn/rb_chain.py's plan rules
    (halo, layout, residency, blocks per SM, grid, split layout) to refuse a
    plan that differs, so every plan the Python rules give must launch:
    `plan` and, in the whole-chain form, every tile `chain_plan` allows,
    from one short tile to many resident blocks (M = 24576 is the adapt
    config's last chain at 256 frames), each matching the plain version."""
    qp, x, gs, lens = _chain_case(cuda, C, k, dil, B, M, C + k + M)
    n_sm = torch.cuda.get_device_properties(cuda).multi_processor_count
    p = rb_chain.plan(B, M, C, k, dil, n_sm)
    plans = [p] + ([q for q in (rb_chain.chain_plan(B, M, C, k, dil, T, n_sm)
                                for T in rb_chain.CHAIN_TILES) if q and q != p]
                   if p.form == "chain" else [])
    assert len(plans) > (p.form == "chain")
    ref = rb_chain.chain_q8_plain(qp, x, gs, lens)
    tol = 0.05 * max(1.0, float(ref.abs().max()))
    for q in plans:
        before = rb_chain.counter.launches
        out = rb_chain.chain_q8_cuda(qp, x, gs, lens, q)
        torch.cuda.synchronize()
        assert rb_chain.counter.launches - before == q.launches, q
        assert float((out - ref).abs().max()) <= tol, q


@pytest.mark.parametrize("C,up", [(32, 192), (64, 96), (128, 48), (256, 8)])
@pytest.mark.parametrize("k", [3, 7, 11])
def test_chain_kernel_at_the_fused_budget(cuda, k, C, up):
    """Each base-config chain over the longest fused frame budget (4096
    frames x the stage's upsampling: 786,432 samples at the last stage) with
    a 700-frame request in it: the long masked tail the fused path gives K1,
    and at C = 32, 64 and 128 a persistent block that works through several
    whole-chain tiles. Bit-equal to the plain version."""
    M, valid = 4096 * up, 700 * up
    gen = torch.Generator().manual_seed(k + C)
    rb = init_weights(ResBlock2(C, k, (1, 3, 5), 16), gen).to(cuda).eval()
    lens = torch.tensor([valid], dtype=torch.int32, device=cuda)
    mask = (torch.arange(M, device=cuda)[None] < lens[:, None]).float()[..., None]
    x = torch.randn(1, M, C, generator=gen).to(cuda) * mask
    g = torch.randn(1, 16, generator=gen).to(cuda)
    with torch.no_grad():
        rec = {}
        rb(x, g, x_mask=mask, record=rec)
        qp = rb.quantize_params(rec)
        gs = torch.stack([rb.conds[str(i)](g) for i in range(3)], 1).float()
    out = rb_chain.resblock2_chain_q8(qp, x, gs, lens)
    assert rb_chain.counter.last[0] == M and rb_chain.counter.last[1] is lens
    ref = rb_chain.chain_q8_plain(qp, x, gs, lens)
    torch.cuda.synchronize()
    assert torch.equal(out, ref)
    assert not out[:, valid:].any()


def _bf16_case(cuda, C, k, lens, M, seed):
    """A seeded ResBlock2 in bfloat16 at (C, k, dilations 1, 3, 5), calibrated
    on its own bf16 input and quantized from its bf16 weights, as bf16
    serving quantizes: (qp, x (B, M, C) bf16 masked past each length, gs
    float32, valid)."""
    gen = torch.Generator().manual_seed(seed)
    rb = init_weights(ResBlock2(C, k, (1, 3, 5), 16), gen).to(cuda, torch.bfloat16).eval()
    valid = torch.tensor(lens, dtype=torch.int32, device=cuda)
    mask = (torch.arange(M, device=cuda)[None] < valid[:, None]).to(torch.bfloat16)[..., None]
    x = torch.randn(len(lens), M, C, generator=gen).to(cuda, torch.bfloat16) * mask
    g = torch.randn(len(lens), 16, generator=gen).to(cuda, torch.bfloat16)
    with torch.no_grad():
        rec = {}
        rb(x, g, x_mask=mask, record=rec)
        qp = rb.quantize_params(rec)
        gs = torch.stack([rb.conds[str(i)](g) for i in range(3)], 1).float()
    return qp, x, gs, valid


def _bf16_equal(qp, x, gs, valid, launches):
    before, before_f32 = rb_chain.counter_bf16.launches, rb_chain.counter.launches
    out = rb_chain.resblock2_chain_q8(qp, x, gs, valid)
    assert rb_chain.counter_bf16.launches - before == launches
    assert rb_chain.counter.launches == before_f32  # the float32 form's count
    ref = rb_chain.chain_q8_plain(qp, x, gs, valid)
    torch.cuda.synchronize()
    assert out.dtype == torch.bfloat16 and ref.dtype == torch.bfloat16
    assert torch.equal(out, ref)
    return out


@pytest.mark.parametrize("C,up", [(32, 192), (64, 96), (128, 48), (256, 8)])
@pytest.mark.parametrize("k", [3, 7, 11])
@pytest.mark.parametrize("frames", [256, 4096])
def test_chain_kernel_bf16_matches_plain(cuda, k, C, up, frames):
    """K1's bfloat16 form at each base-config chain, over a 256-frame
    request (valid to a ragged length) and over the 4096-frame fused budget
    (a 700-frame request in it): bit-equal to the plain version in bf16,
    which rounds at the same points."""
    M = frames * up
    valid = M - 37 * up // 8 - 1 if frames == 256 else 700 * up
    qp, x, gs, lens = _bf16_case(cuda, C, k, [valid], M, k + C + frames)
    n_sm = torch.cuda.get_device_properties(cuda).multi_processor_count
    out = _bf16_equal(qp, x, gs, lens, rb_chain.plan(1, M, C, k, (1, 3, 5), n_sm).launches)
    assert not out[:, valid:].any()


@pytest.mark.parametrize("C,k", [(64, 7), (256, 3)])
def test_chain_kernel_bf16_batch(cuda, C, k):
    """K1's bfloat16 form at B = 4 with ragged lengths, one whole-chain and
    one split chain, bit-equal to the plain version."""
    M = 256 * 48
    qp, x, gs, lens = _bf16_case(cuda, C, k, [M - 1, M - 3001, M // 2 + 17, 901], M, C + k)
    n_sm = torch.cuda.get_device_properties(cuda).multi_processor_count
    _bf16_equal(qp, x, gs, lens, rb_chain.plan(4, M, C, k, (1, 3, 5), n_sm).launches)


@pytest.mark.parametrize("B,T_y,T_x", [(2, 800, 384), (16, 400, 96)])
def test_mas_kernel_takes_bf16_input(cuda, B, T_y, T_x):
    """maximum_path on bf16 neg_cent (the bf16 training step's): the kernel
    takes it cast to f32 and the path comes back in bf16, equal to the plain
    path on the same input."""
    gen = torch.Generator().manual_seed(T_y + B)
    neg = (torch.randn(B, T_y, T_x, generator=gen) * 10).to(cuda, torch.bfloat16)
    t_ys = torch.tensor([T_y - 13 * (i % 4) for i in range(B)], dtype=torch.int32)
    t_xs = torch.tensor([T_x - i % 7 for i in range(B)], dtype=torch.int32)
    mask = ((torch.arange(T_y)[None, :, None] < t_ys[:, None, None])
            & (torch.arange(T_x)[None, None, :] < t_xs[:, None, None])).to(cuda, torch.bfloat16)
    before = mas.counter.launches
    got = mas.maximum_path(neg, mask)
    assert mas.counter.launches - before == 1
    want = mas.maximum_path_plain(neg * mask, t_ys.to(cuda), t_xs.to(cuda))
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, want)
    assert torch.equal(got.float().sum(dim=(1, 2)), t_ys.to(cuda).float())


@pytest.mark.parametrize("B,T_y,T_x,case,form", [
    (16, 400, 96, "bench", "warp"), (3, 37, 37, "diagonal", "warp"),
    (2, 1000, 1, "one_token", "warp"), (2, 2000, 384, "long_utterance", "warp"),
    (4, 70, 45, "zero_length", "warp"), (2, 200, 992, "widest_warp", "warp"),
    (2, 200, 1000, "past_the_warp_form", "block"),
    (2, 1200, 1100, "two_columns_per_thread", "block"),
    (2, 4000, 512, "bits_in_global_scratch", "block")])
def test_mas_kernel_equals_plain(cuda, B, T_y, T_x, case, form):
    assert mas.plan(B, T_y, T_x).form == form
    gen = torch.Generator().manual_seed(T_y + T_x)
    neg = (torch.randn(B, T_y, T_x, generator=gen) * 10).to(cuda)
    if case == "diagonal":
        t_ys = t_xs = torch.tensor([37, 20, 1], dtype=torch.int32)
    elif case == "zero_length":  # an empty utterance, and t_x = 0 with frames left
        t_ys = torch.tensor([0, 70, 33, 12], dtype=torch.int32)
        t_xs = torch.tensor([0, 45, 0, 12], dtype=torch.int32)
    else:
        t_ys = torch.tensor([T_y - 13 * (i % 4) for i in range(B)], dtype=torch.int32)
        t_xs = torch.tensor([max(T_x - i % 7, 1) for i in range(B)], dtype=torch.int32)
    t_ys, t_xs = t_ys.to(cuda), t_xs.to(cuda)
    before = mas.counter.launches
    got = mas.maximum_path_cuda(neg, t_ys, t_xs)
    assert mas.counter.launches - before == 1
    want = mas.maximum_path_plain(neg, t_ys, t_xs)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(got.sum(dim=(1, 2)), t_ys.float())


@pytest.mark.parametrize("T_y,T_x", [(T_x + 64, T_x) for T_x in (1, 33, 97, 161, 289, 545, 801,
                                                                 961, 992, 993, 1024, 1025,
                                                                 2048)]
                         + [(T_y, 384) for T_y in (3000, 3800, 4100, 4300)])
def test_mas_plan_agrees_with_the_kernel(cuda, T_y, T_x):
    """mas_forward refuses plan numbers that differ from its own copy of the
    rules, so every R, ring depth and form edge of ops/mas.py::plan launches
    here and gives the plain version's path."""
    gen = torch.Generator().manual_seed(T_y * T_x)
    neg = (torch.randn(1, T_y, T_x, generator=gen) * 10).to(cuda)
    t_ys = torch.tensor([T_y - 3], dtype=torch.int32, device=cuda)
    t_xs = torch.tensor([max(T_x - 2, 1)], dtype=torch.int32, device=cuda)
    got = mas.maximum_path_cuda(neg, t_ys, t_xs)
    assert torch.equal(got, mas.maximum_path_plain(neg, t_ys, t_xs))


def test_ranks_sharing_a_card_never_get_nccl(cuda, monkeypatch):
    """On a card: two ranks on one card (a bare "cuda" with more ranks on the
    host than cards, or an explicit cuda:0 for both) take gloo, and an
    explicit NCCL for them raises; one rank a card takes NCCL."""
    cards = torch.cuda.device_count()
    dev, per_card = dist._rank_device("cuda", 1, 2 * cards)
    assert dev == torch.device("cuda", 1 % cards) and per_card == 2
    assert dist.pick_backend(dev, per_card) == "gloo"
    assert dist._rank_device("cuda:0", 1, 2) == (torch.device("cuda", 0), 2)
    assert dist.pick_backend(torch.device("cuda", 0), 1) == "nccl"
    monkeypatch.setenv("WORLD_SIZE", str(2 * cards))
    monkeypatch.setenv("LOCAL_WORLD_SIZE", str(2 * cards))
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("LOCAL_RANK", "0")
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    monkeypatch.setenv("MASTER_PORT", "1")
    with pytest.raises(ValueError, match="NCCL with 2 ranks on one card is refused"):
        dist.init_distributed("cuda", backend="nccl")
    assert not torch.distributed.is_initialized()


# the float decoder's glue kernels (nn/dec_glue.py): every stage's shape of
# the base and VCTK decoders at a 64-frame pad, (C, T) of conv_pre, the four
# upsample stages and conv_post; B = 2 with the first utterance valid for 37
# of the 64 frames
GLUE_SHAPES = {"base": [(512, 64), (256, 512), (128, 3072), (64, 6144), (32, 12288)],
               "vctk": [(512, 64), (256, 512), (128, 4096), (64, 8192), (32, 16384)]}
GLUE_POST = {"base": 12288, "vctk": 16384}


def _glue_valid(cuda):
    return torch.tensor([37, 64], dtype=torch.int32, device=cuda)


def _assert_twin(got, ref):
    """The kernels' adds, products, quotients and leaky ReLU are the
    twin's own; tanhf and expf may differ from PyTorch's by an ulp."""
    torch.cuda.synchronize()
    torch.testing.assert_close(got, ref, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("config", ["base", "vctk"])
@pytest.mark.parametrize("stage", range(1, 5))
def test_gate_kernel_equals_its_twin(cuda, config, stage):
    """conv1's output to conv2's input at the stage's width: the GLU gate
    (ResBlock2, base) or tanh (ResBlock1, VCTK), the speaker term a column
    slice of the decoder's one matrix; a ragged T takes the scalar path."""
    C, T = GLUE_SHAPES[config][stage]
    glu = config == "base"
    gen = torch.Generator().manual_seed(stage)
    valid, vmul = _glue_valid(cuda), T // 64
    s_all = torch.randn(2, 3 * C, generator=gen).to(cuda)
    for t in (T, T - 3):
        a = torch.randn(2, C, t, generator=gen).to(cuda)
        s = s_all[:, C:2 * C]
        before = dec_glue.counter.launches
        got = dec_glue.gate(a, s, valid, vmul, glu)
        assert dec_glue.counter.launches == before + 1
        assert got.shape == (2, C // 2 if glu else C, t)
        _assert_twin(got, dec_glue.gate_plain(a, s, valid, vmul, glu))
        assert float(got[0, :, 37 * vmul:].abs().max()) == 0.0


# the epilogue's uses, as the packed body makes them: (bias, x, acc, div,
# act, slope, want_v, want_a, v written in place over x or acc)
EPILOGUES = {
    "conv_pre": (True, False, False, 1.0, "lrelu", 0.1, False, True, None),
    "upsample": (True, False, False, 1.0, "lrelu", 0.1, True, True, None),
    "residual": (True, True, False, 1.0, "lrelu", 0.1, True, True, "x"),
    "sum_first": (True, True, False, 1.0, None, 0.1, True, False, None),
    "sum": (True, True, True, 1.0, None, 0.1, True, False, "acc"),
    "mean": (True, True, True, 3.0, "lrelu", 0.1, False, True, None),
    "mean_last": (True, True, True, 3.0, "lrelu", 0.01, False, True, None),
}


@pytest.mark.parametrize("config", ["base", "vctk"])
@pytest.mark.parametrize("stage", range(5))
@pytest.mark.parametrize("use", list(EPILOGUES))
def test_epilogue_kernel_equals_its_twin(cuda, config, stage, use):
    """Every use of the epilogue at every stage shape (stage 0 is conv_pre's
    output), in place where the packed body writes in place, at T and at a
    ragged T (the scalar path); and conv_post's tanh, unmasked."""
    if (use == "conv_pre") != (stage == 0):
        pytest.skip("conv_pre's epilogue runs at its own shape alone")
    has_b, has_x, has_acc, div, act, slope, want_v, want_a, inplace = EPILOGUES[use]
    C, T = GLUE_SHAPES[config][stage]
    gen = torch.Generator().manual_seed(10 * stage + len(use))
    valid, vmul = _glue_valid(cuda), T // 64
    for t in (T, T - 1):
        c, x, acc = (torch.randn(2, C, t, generator=gen).to(cuda) for _ in range(3))
        bias = torch.randn(C, generator=gen).to(cuda) if has_b else None
        kw = dict(bias=bias, x=x if has_x else None, acc=acc if has_acc else None,
                  valid=valid, vmul=vmul, div=div, act=act, slope=slope, want_v=want_v,
                  want_a=want_a)
        ref = dec_glue.epilogue_plain(c, **kw)
        out_v = {"x": x, "acc": acc, None: None}[inplace]
        got = dec_glue.epilogue(c, out_v=out_v, **kw)
        for g, r in zip(got, ref):
            assert (g is None) == (r is None)
            if g is not None:
                _assert_twin(g, r)
        if out_v is not None:
            assert got[0].data_ptr() == out_v.data_ptr()
    L = GLUE_POST[config]
    post = torch.randn(2, 1, L, generator=gen).to(cuda) * 3
    got = dec_glue.epilogue(post, act="tanh", want_v=False, want_a=True)[1]
    _assert_twin(got, torch.tanh(post))


@pytest.mark.parametrize("resblock", ["2", "1"])
def test_a_packed_decode_replays_from_a_cuda_graph(cuda, resblock, monkeypatch):
    """A packed decode captured by `serve/graphs.py::Graph` replays, on new
    inputs, equal to its run outside the graph: the kernels launch on
    PyTorch's current stream and allocate nothing of their own. Both equal
    the eager body within 1e-5 with TF32 off, as the serving engine sets
    it (float order; TF32 convs differ by ~5e-5 between the two bodies)."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    gen = torch.Generator().manual_seed(3)
    dec = init_weights(Generator(8, resblock, (3, 5, 7), ((1, 3, 5),) * 3, (4, 2), 64, (8, 4),
                                 gin_channels=16), gen).to(cuda).eval()
    eager_dec = copy.deepcopy(dec)  # keeps no pack
    assert dec.pack_fused() is not None
    T = 64

    def inputs(n):
        z = torch.randn(2, T, 8, generator=gen).to(cuda)
        m = (torch.arange(T)[None] < torch.tensor([[n], [T]])).float()[..., None].to(cuda)
        return z * m, torch.randn(2, 16, generator=gen).to(cuda), m

    with torch.inference_mode():
        graph = Graph(lambda z, g, m: dec(z, g=g, x_mask=m), inputs(50))
        graph.capture(torch.cuda.graph_pool_handle(), warmups=1)
        launches = dec_glue.counter.launches
        z, g, m = inputs(29)
        out = graph(z, g, m).clone()
        assert dec_glue.counter.launches == launches  # a replay launches through no wrapper
        ref = dec(z, g=g, x_mask=m)
        eager = eager_dec(z, g=g, x_mask=m)
    torch.cuda.synchronize()
    assert torch.equal(out, ref)
    torch.testing.assert_close(out, eager, rtol=0, atol=1e-5)
