"""int8 ResBlock2 chain: the port of TPU kernel K1
(vits_tpu/nn/pallas_rb.py::_make_kernel, launched by resblock2_chain_q8).

One ResBlock2's int8 chain over its dilations; per dilation:
  lrelu(0.1) -> quantize (divide by s_in, round half to even, clip +-127)
  -> int8 conv1 (k taps at dilation d, s8 x s8 -> s32) -> dequantize
  (acc * s_in*s_w) + b1 + cond(g) -> tanh(a) * sigmoid(b) -> mask
  -> quantize -> int8 conv2 -> dequantize + b2 -> + residual -> mask.

`resblock2_chain_q8` is the entry: on a CPU tensor it runs `chain_q8_plain`
(the arithmetic of the JAX package's `ResBlock2.apply_q8`, with exact
integer products); on a CUDA tensor it launches the hand-written kernel in
`vits_tpu_torch/csrc/rb_chain_q8.cu` (int8 tensor-core MMA), one launch per
dilation, or raises.
`launches` counts those launches.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Sequence

import torch

from vits_tpu_torch.nn import quant as Q
from vits_tpu_torch.nn.core import leaky_relu
from vits_tpu_torch.utils import cuda_build

SOURCE = "rb_chain_q8.cu"
LRELU_SLOPE = 0.1
SMEM_LIMIT = 232448  # dynamic shared memory a block may use on sm_90

counter = cuda_build.LaunchCounter()


# ---------------------------------------------------------------------------
# quantized parameters
# ---------------------------------------------------------------------------

def pack_words(w8: torch.Tensor) -> torch.Tensor:
    """(K, C_in, C_out) int8 -> (K, C_in/4, C_out) int32: each word holds 4
    consecutive input channels (lowest byte first), the kernel's __dp4a
    operand layout. None when C_in is not a multiple of 4 (no kernel form)."""
    K, C_in, C_out = w8.shape
    if C_in % 4:
        return None
    w = w8.reshape(K, C_in // 4, 4, C_out).permute(0, 1, 3, 2).contiguous()
    return w.view(torch.int32).reshape(K, C_in // 4, C_out)


@torch.no_grad()
def quantize_chain(convs, kernel_size: int, dilation: Sequence[int]) -> Dict:
    """Quantize one ResBlock2's convs. convs: per dilation
    (w1 (K, C, C), b1, amax1, w2 (K, C/2, C), b2, amax2) with float kernels in
    (K, C_in, C_out) layout and calibrated input max-abs values. Returns the
    chain's params: int8 kernels with per-output-channel scales, activation
    scales, and the kernel's packed weight words and dequant vectors."""
    iters = []
    for w1, b1, a1, w2, b2, a2 in convs:
        w1_8, s_w1 = Q.quantize_kernel(w1)
        w2_8, s_w2 = Q.quantize_kernel(w2)
        s1, s2 = Q.act_scale(a1).to(w1.device), Q.act_scale(a2).to(w1.device)
        iters.append({
            "w1": w1_8, "s_w1": s_w1, "b1": b1.detach().float(), "s_in1": s1,
            "w2": w2_8, "s_w2": s_w2, "b2": b2.detach().float(), "s_in2": s2,
            # kernel operands
            "w1p": pack_words(w1_8), "w2p": pack_words(w2_8),
            "deq1": (s1 * s_w1).contiguous(), "deq2": (s2 * s_w2).contiguous(),
            "s_in": torch.stack([s1, s2]).contiguous(),
        })
    return {"kernel_size": kernel_size, "dilation": tuple(dilation), "iters": iters}


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------

def chain_q8_plain(qp: Dict, x: torch.Tensor, gs: torch.Tensor,
                   valid: torch.Tensor) -> torch.Tensor:
    """The chain in plain PyTorch, in the JAX package's `apply_q8` order.
    x (B, M, C) float32; gs (B, n_iter, C) = cond_i(g); valid (B,) int32."""
    K = qp["kernel_size"]
    M = x.shape[1]
    mask = (torch.arange(M, device=x.device)[None, :] < valid[:, None]).to(x.dtype)[..., None]
    for i, (it, d) in enumerate(zip(qp["iters"], qp["dilation"])):
        half = it["w2"].shape[1]
        xt = leaky_relu(x, LRELU_SLOPE)
        y = Q.conv1d_q8(Q.quantize_act(xt, it["s_in1"]), it["w1"], it["s_in1"], it["s_w1"],
                        it["b1"], dilation=d, padding=d * (K - 1) // 2)
        gate = torch.tanh(y[..., :half] + gs[:, i, None, :half]) * \
            torch.sigmoid(y[..., half:] + gs[:, i, None, half:])
        gate = gate * mask
        y = Q.conv1d_q8(Q.quantize_act(gate, it["s_in2"]), it["w2"], it["s_in2"], it["s_w2"],
                        it["b2"], padding=(K - 1) // 2)
        x = (y + x) * mask
    return x


# ---------------------------------------------------------------------------
# CUDA kernel
# ---------------------------------------------------------------------------

_P, _I = ctypes.c_void_p, ctypes.c_int


def _lib() -> ctypes.CDLL:
    lib = cuda_build.load(SOURCE)
    if not getattr(lib, "_vits_typed", False):
        lib.rb2_iter_q8.argtypes = [_P] * 11 + [_I] * 6 + [_P]
        lib.rb2_iter_q8.restype = _I
        lib.rb2_iter_q8_smem_bytes.argtypes = [_I] * 4
        lib.rb2_iter_q8_smem_bytes.restype = _I
        lib.rb2_error_string.argtypes = [_I]
        lib.rb2_error_string.restype = ctypes.c_char_p
        lib._vits_typed = True
    return lib


def tile_frames(lib, B: int, M: int, C: int, K: int, d: int, n_sm: int) -> int:
    """Output frames per block: the largest of 128/64/32/16 that still gives
    two blocks per SM, within the shared-memory limit."""
    T = 128
    while T > 16 and B * -(-M // T) < 2 * n_sm:
        T //= 2
    while T > 8 and lib.rb2_iter_q8_smem_bytes(C, K, d, T) > SMEM_LIMIT:
        T //= 2
    return T


def _check(name, t, dtype, shape, device):
    if t.device != device or t.dtype != dtype or tuple(t.shape) != tuple(shape) \
            or not t.is_contiguous():
        raise ValueError(f"rb2_chain_q8: {name} must be a contiguous {dtype} tensor of "
                         f"shape {tuple(shape)} on {device}; got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")


def chain_q8_cuda(qp: Dict, x: torch.Tensor, gs: torch.Tensor,
                  valid: torch.Tensor) -> torch.Tensor:
    """Launch the kernel once per dilation on the current stream."""
    B, M, C = x.shape
    K, dil = qp["kernel_size"], qp["dilation"]
    n = len(dil)
    dev = x.device
    if C % 32 or K % 2 == 0:
        raise ValueError(f"rb2_chain_q8 needs C % 32 == 0 and odd k; got C={C}, k={K}")
    _check("x", x, torch.float32, (B, M, C), dev)
    _check("gs", gs, torch.float32, (B, n, C), dev)
    _check("valid", valid, torch.int32, (B,), dev)
    valid = valid.clamp(0, M)  # the kernel masks frames >= valid; none exist past M
    H = C // 2
    lib = _lib()
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
    cur = x
    for i, (it, d) in enumerate(zip(qp["iters"], dil)):
        if it["w2"].shape[1] != H:
            raise ValueError(f"rb2_chain_q8 needs inter_channels == channels (C={C})")
        _check("w1p", it["w1p"], torch.int32, (K, C // 4, C), dev)
        _check("w2p", it["w2p"], torch.int32, (K, H // 4, C), dev)
        for name in ("deq1", "deq2", "b2"):
            _check(name, it[name], torch.float32, (C,), dev)
        _check("s_in", it["s_in"], torch.float32, (2,), dev)
        ga = (gs[:, i, :H] + it["b1"][:H]).contiguous()
        gb = (gs[:, i, H:] + it["b1"][H:]).contiguous()
        out = torch.empty_like(x)
        T = tile_frames(lib, B, M, C, K, d, n_sm)
        err = lib.rb2_iter_q8(
            cur.data_ptr(), out.data_ptr(), it["w1p"].data_ptr(), it["w2p"].data_ptr(),
            it["deq1"].data_ptr(), it["deq2"].data_ptr(), it["b2"].data_ptr(),
            ga.data_ptr(), gb.data_ptr(), valid.data_ptr(), it["s_in"].data_ptr(),
            B, M, C, K, d, T, stream)
        if err != 0:
            raise RuntimeError(f"rb2_iter_q8 launch failed: {lib.rb2_error_string(err).decode()}")
        counter.launches += 1
        cur = out
    return cur


def resblock2_chain_q8(qp: Dict, x: torch.Tensor, gs: torch.Tensor,
                       valid: torch.Tensor) -> torch.Tensor:
    """One ResBlock2's int8 chain. x (B, M, C) float32 activations (masked
    like the JAX package's apply_q8 input); gs (B, n_iter, C) float32 gate
    conditioning cond_i(g); valid (B,) int32 valid-frame counts (<= M).
    CPU tensors take the plain version, CUDA tensors the kernel."""
    if x.device.type == "cpu":
        return chain_q8_plain(qp, x, gs, valid)
    if x.device.type != "cuda":
        raise ValueError(f"rb2_chain_q8 runs on CUDA or CPU tensors, not {x.device}")
    return chain_q8_cuda(qp, x, gs, valid)


def chain_ops_bytes(B: int, M: int, C: int, K: int, n_iter: int) -> List[int]:
    """(operations, bytes) one chain needs: 2 ops per int8 MAC of both convs
    of every dilation; each f32 activation read once and written once, the
    int8 weights and the f32 per-channel vectors read once."""
    ops = n_iter * 2 * B * M * K * (C * C + (C // 2) * C)
    weights = n_iter * (K * C * C + K * (C // 2) * C)
    vectors = n_iter * 4 * (5 * C + 2) + B * n_iter * C * 4 + B * 4
    return [ops, 2 * B * M * C * 4 + weights + vectors]
