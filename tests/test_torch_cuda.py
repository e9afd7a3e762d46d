"""The port's CUDA kernel on the card: the int8 ResBlock2 chain against its
plain PyTorch version at small shapes (tolerance of chip_smoke.py: atol
0.05 * max(1, max|plain|), under 1% of elements off by more than
1e-3 * max|plain|). Marked `cuda`; skips where no CUDA device is present.
Run on the GPU machine with
`python -m pytest --noconftest tests/test_torch_cuda.py -q` (tests/conftest.py
imports jax, which that machine need not have)."""

import pytest
import torch

from vits_tpu_torch.models.modules import ResBlock2
from vits_tpu_torch.nn import rb_chain
from vits_tpu_torch.nn.core import init_weights

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU form)")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("C,k,dil,B,M", [(32, 3, (1, 3, 5), 2, 300), (64, 7, (1, 3), 1, 129),
                                         (128, 11, (1, 3, 5), 3, 77)])
def test_chain_kernel_matches_plain(cuda, C, k, dil, B, M):
    gen = torch.Generator().manual_seed(C + k)
    rb = init_weights(ResBlock2(C, k, dil, 16), gen).to(cuda).eval()
    x = torch.randn(B, M, C, generator=gen).to(cuda)
    lens = torch.tensor([M - 5 * i for i in range(B)], dtype=torch.int32, device=cuda)
    mask = (torch.arange(M, device=cuda)[None] < lens[:, None]).float()[..., None]
    x = x * mask
    g = torch.randn(B, 16, generator=gen).to(cuda)
    with torch.no_grad():
        rec = {}
        rb(x, g, x_mask=mask, record=rec)
        qp = rb.quantize_params(rec)
        gs = torch.stack([rb.conds[str(i)](g) for i in range(len(dil))], 1).float()
    before = rb_chain.counter.launches
    out = rb_chain.resblock2_chain_q8(qp, x, gs, lens)
    assert rb_chain.counter.launches - before == len(dil)
    ref = rb_chain.chain_q8_plain(qp, x, gs, lens)
    torch.cuda.synchronize()
    diff = (out - ref).abs()
    peak = float(ref.abs().max())
    assert float(diff.max()) <= 0.05 * max(1.0, peak)
    assert float((diff > 1e-3 * peak).float().mean()) < 0.01
