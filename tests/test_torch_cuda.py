"""The port's CUDA kernels on the card: the int8 ResBlock2 chain against its
plain PyTorch version at small shapes, through both of its forms, with the
launches its plan gives (tolerance of chip_smoke.py: atol
0.05 * max(1, max|plain|), under 1% of elements off by more than
1e-3 * max|plain|), and MAS against its plain version, array-equal (the
same f32 adds and maxes), in the form its plan picks. Marked `cuda`; skips
where no CUDA device is present. Run on the GPU machine with
`python -m pytest --noconftest tests/test_torch_cuda.py -q` (tests/conftest.py
imports jax, which that machine need not have)."""

import pytest
import torch

from vits_tpu_torch.models.modules import ResBlock2
from vits_tpu_torch.nn import rb_chain
from vits_tpu_torch.nn.core import init_weights
from vits_tpu_torch.ops import mas

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
