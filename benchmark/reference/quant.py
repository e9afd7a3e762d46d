"""int8 inference ops (counterpart of vits_tpu/nn/quant.py), at pack 1.

Quantization contract (the JAX package's):
  x8 = clip(round(x / s_in), -127, 127)          round half to even
  w8[..., c] = clip(round(w[..., c] / s_w[c]), -127, 127)
  y  = conv_s8s8_s32(x8, w8) * (s_in * s_w) + bias

The JAX package phase-packs the small-channel decoder stages (a TPU lane
layout, vits_tpu/nn/packed.py) and quantizes the packed kernels per packed
output column. For a regular conv every packed column holds every tap of one
output channel, so its scale is the pack-1 per-channel scale. For a
transposed conv of stride u, packed output phase r sees only the taps j with
(r + pad - j) mod u == 0, so its scale is per (phase mod u, channel): the
port's transposed int8 conv is polyphase with those per-phase scales
(`quantize_transposed_kernel`, `conv_transpose1d_q8`).

The integer products are exact: `int_mm` is `torch._int_mm` (int8 x int8 ->
int32) on an im2col matrix, on the CPU and the GPU alike. These convs are
plain XLA convs in the JAX package, not TPU kernels.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

Q_MAX = 127.0


# Weight levels of the kernels' symmetric quantization: 127 (int8) as the
# port quantizes; the benchmark's control sets 7 (int4).
WEIGHT_QMAX = 127


def amax(x: torch.Tensor) -> torch.Tensor:
    """Max-abs of a tensor (calibration statistic), a float32 0-d tensor."""
    return x.float().abs().amax()


def act_scale(a, eps: float = 1e-12) -> torch.Tensor:
    """Activation scale from a calibrated max-abs."""
    return torch.clamp(torch.as_tensor(a, dtype=torch.float32), min=eps) / Q_MAX


def quantize_act(x: torch.Tensor, scale) -> torch.Tensor:
    """float activations -> int8 at a scalar scale (divides, rounds half to
    even, clips to +-127)."""
    q = torch.round(x.float() / scale)
    return torch.clamp(q, -Q_MAX, Q_MAX).to(torch.int8)


def kernel_klast(weight: torch.Tensor) -> torch.Tensor:
    """torch Conv1d weight (C_out, C_in, K) -> the JAX layout (K, C_in, C_out)."""
    return weight.detach().permute(2, 1, 0).float()


def quantize_kernel(w: torch.Tensor, eps: float = 1e-12):
    """Per-output-channel symmetric int8 quantization of a (K, C_in, C_out)
    kernel. Returns (w8, s_w[C_out] float32)."""
    w = w.float()
    s = torch.clamp(w.abs().amax(dim=tuple(range(w.ndim - 1))), min=eps) / WEIGHT_QMAX
    w8 = torch.clamp(torch.round(w / s), -WEIGHT_QMAX, WEIGHT_QMAX).to(torch.int8)
    return w8, s


def transposed_phases(kernel_size: int, stride: int, padding: int):
    """Output phase (t mod stride) that each tap j of a transposed conv feeds:
    y[t] gets x[(t + pad - j) / u] w[j] only when u | (t + pad - j)."""
    return [(j - padding) % stride for j in range(kernel_size)]


def quantize_transposed_kernel(w: torch.Tensor, stride: int, padding: int,
                               eps: float = 1e-12):
    """Polyphase int8 quantization of a transposed-conv kernel in forward
    layout (K, C_in, C_out): one scale per (output phase mod stride, C_out),
    the scales the JAX package's packed quantization gives at any pack.
    Returns (w8 (K, C_in, C_out) int8, s_w (stride, C_out) float32)."""
    w = w.float()
    K = w.shape[0]
    if K < stride:
        raise ValueError(f"transposed kernel of {K} taps cannot cover stride {stride}")
    phase = torch.tensor(transposed_phases(K, stride, padding), device=w.device)
    colmax = w.abs().amax(dim=1)  # (K, C_out)
    s = torch.stack([colmax[phase == r].amax(dim=0) for r in range(stride)])
    s = torch.clamp(s, min=eps) / WEIGHT_QMAX  # (stride, C_out)
    w8 = torch.clamp(torch.round(w / s[phase][:, None, :]), -WEIGHT_QMAX,
                     WEIGHT_QMAX).to(torch.int8)
    return w8, s


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def int_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact int8 x int8 -> int32 product of (m, k) and (k, n). Zero-pads to
    `torch._int_mm`'s CUDA shape rules (m > 16, k and n multiples of 8)."""
    m, k = a.shape
    n = b.shape[1]
    mp = max(_round_up(m, 8), 24)
    kp, np_ = _round_up(k, 8), _round_up(n, 8)
    if (mp, kp) != (m, k):
        a = F.pad(a, (0, kp - k, 0, mp - m))
    if (kp, np_) != (k, n):
        b = F.pad(b, (0, np_ - n, 0, kp - k))
    # row-major a, column-major b: the operand layout cuBLASLt's int8 GEMM takes
    out = torch._int_mm(a.contiguous(), b.t().contiguous().t())
    return out[:m, :n]


def im2col(x8: torch.Tensor, offsets, pad_l: int, pad_r: int) -> torch.Tensor:
    """(B, T, C) -> (B*T, len(offsets)*C): column block a holds
    x[t + offsets[a] - pad_l], zero outside [0, T)."""
    B, T, C = x8.shape
    xp = F.pad(x8, (0, 0, pad_l, pad_r))
    cols = torch.cat([xp[:, o:o + T] for o in offsets], dim=-1)
    return cols.reshape(B * T, len(offsets) * C)


def conv1d_acc(x8: torch.Tensor, w8: torch.Tensor, dilation: int = 1,
               padding: int = 0) -> torch.Tensor:
    """int32 accumulators of a 'same' s8 x s8 conv: x8 (B, T, C_in), w8
    (K, C_in, C_out) -> (B, T, C_out) int32."""
    B, T, _ = x8.shape
    K, C_in, C_out = w8.shape
    cols = im2col(x8, [j * dilation for j in range(K)], padding,
                  (K - 1) * dilation - padding)
    return int_mm(cols, w8.reshape(K * C_in, C_out)).reshape(B, T, C_out)


def conv1d_q8(x8, w8, s_in, s_w, bias=None, dilation: int = 1, padding: int = 0,
              out_dtype=torch.float32):
    """s8 x s8 -> s32 'same' conv with the dequant epilogue in float32, the
    result rounded to out_dtype (the activation dtype, as the JAX package's
    `out_dtype=x.dtype`)."""
    y = conv1d_acc(x8, w8, dilation, padding).float() * (s_in * s_w)
    if bias is not None:
        y = y + bias
    return y.to(out_dtype)


def transposed_subpixel_kernel(w8: torch.Tensor, stride: int, padding: int):
    """Regroup a (K, C_in, C_out) transposed kernel into one dense matrix over
    input-frame offsets: y[m*u + r] = sum_delta x[m + delta] W[delta, :, r, :]
    with j = r + pad - delta*u. Returns (W (J*C_in, u*C_out), delta_min,
    delta_max)."""
    K, C_in, C_out = w8.shape
    u, P = stride, padding
    deltas = [(r + P - j) // u for r in range(u) for j in range(K) if (r + P - j) % u == 0]
    dmin, dmax = min(deltas), max(deltas)
    J = dmax - dmin + 1
    W = torch.zeros(J, C_in, u, C_out, dtype=w8.dtype, device=w8.device)
    for r in range(u):
        for a in range(J):
            j = r + P - (dmin + a) * u
            if 0 <= j < K:
                W[a, :, r, :] = w8[j]
    return W.reshape(J * C_in, u * C_out), dmin, dmax


def conv_transpose1d_q8(x8, wsub, dmin: int, dmax: int, s_in, s_w, bias=None,
                        out_dtype=torch.float32):
    """Length-preserving (k == 2*pad + u) polyphase int8 transposed conv.
    x8 (B, T, C_in) int8; wsub from `transposed_subpixel_kernel`; s_w
    (u, C_out) per-phase scales. Returns (B, T*u, C_out), the float32
    epilogue rounded to out_dtype."""
    B, T, _ = x8.shape
    u, C_out = s_w.shape
    cols = im2col(x8, list(range(dmax - dmin + 1)), -dmin, dmax)
    y = int_mm(cols, wsub).float() * (s_in * s_w.reshape(1, u * C_out))
    y = y.reshape(B, T * u, C_out)
    if bias is not None:
        y = y + bias
    return y.to(out_dtype)
