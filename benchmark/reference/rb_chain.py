"""The int8 ResBlock2 chain in plain PyTorch: a frozen copy of the port's
`nn/rb_chain.py` quantization and plain version, without the CUDA kernel.

Per dilation: lrelu(0.1) -> quantize (divide by s_in, round half to even,
clip +-127) -> int8 conv1 (s8 x s8 -> s32) -> dequantize + b1 + cond(g) ->
tanh(a) * sigmoid(b) -> mask -> quantize -> int8 conv2 -> dequantize + b2 ->
+ residual -> mask. `weight_bits` below 8 quantizes the weights to that many
bits instead (the lower-precision control of the benchmark's comparison).
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch

from benchmark.reference import quant as Q
from benchmark.reference.core import leaky_relu

LRELU_SLOPE = 0.1


def quantize_chain(convs, kernel_size: int, dilation: Sequence[int]) -> Dict:
    """Quantize one ResBlock2's convs. convs: per dilation
    (w1 (K, C, C), b1, amax1, w2 (K, C/2, C), b2, amax2) with float kernels in
    (K, C_in, C_out) layout and calibrated input max-abs values. Returns the
    chain's params: int8 kernels with per-output-channel scales, activation
    scales, and the kernel's packed operands ("kernel")."""
    iters = []
    for w1, b1, a1, w2, b2, a2 in convs:
        w1_8, s_w1 = Q.quantize_kernel(w1)
        w2_8, s_w2 = Q.quantize_kernel(w2)
        s1, s2 = Q.act_scale(a1).to(w1.device), Q.act_scale(a2).to(w1.device)
        iters.append({
            "w1": w1_8, "s_w1": s_w1, "b1": b1.detach().float(), "s_in1": s1,
            "w2": w2_8, "s_w2": s_w2, "b2": b2.detach().float(), "s_in2": s2,
        })
    return {"kernel_size": kernel_size, "dilation": tuple(dilation), "iters": iters}


def chain_q8_plain(qp: Dict, x: torch.Tensor, gs: torch.Tensor,
                   valid: torch.Tensor) -> torch.Tensor:
    """The chain in plain PyTorch, in the JAX package's `apply_q8` order.
    x (B, M, C) float32 or bfloat16; gs (B, n_iter, C) float32 = cond_i(g);
    valid (B,) int32. The products, dequantization and gate run in float32;
    in bfloat16 the values round to it where the Pallas chain at that dtype
    rounds (vits_tpu/nn/pallas_rb.py:119-137): the leaky ReLU of the
    residual (slope bf16(0.1)), the gate before the mask and the quantize,
    conv2's dequantized output, and the residual sum."""
    K = qp["kernel_size"]
    M, dt = x.shape[1], x.dtype
    mask = (torch.arange(M, device=x.device)[None, :] < valid[:, None]).to(dt)[..., None]
    for i, (it, d) in enumerate(zip(qp["iters"], qp["dilation"])):
        half = it["w2"].shape[1]
        xt = leaky_relu(x, LRELU_SLOPE)
        y = Q.conv1d_q8(Q.quantize_act(xt, it["s_in1"]), it["w1"], it["s_in1"], it["s_w1"],
                        it["b1"], dilation=d, padding=d * (K - 1) // 2)
        gate = torch.tanh(y[..., :half] + gs[:, i, None, :half]) * \
            torch.sigmoid(y[..., half:] + gs[:, i, None, half:])
        gate = gate.to(dt) * mask
        y = Q.conv1d_q8(Q.quantize_act(gate, it["s_in2"]), it["w2"], it["s_in2"], it["s_w2"],
                        it["b2"], padding=(K - 1) // 2, out_dtype=dt)
        x = (y + x) * mask
    return x



def resblock2_chain_q8(qp: Dict, x: torch.Tensor, gs: torch.Tensor,
                       valid: torch.Tensor) -> torch.Tensor:
    """One ResBlock2's int8 chain, always the plain version."""
    return chain_q8_plain(qp, x, gs, valid)


def chain_ops_bytes(B: int, M: int, C: int, K: int, n_iter: int,
                    io_bytes: int = 4) -> List[int]:
    """(operations, bytes) one chain needs: 2 ops per int8 MAC of both convs
    of every dilation; each activation (io_bytes: 4 in float32, 2 in
    bfloat16) read once and written once, the int8 weights and the f32
    per-channel vectors read once."""
    ops = n_iter * 2 * B * M * K * (C * C + (C // 2) * C)
    weights = n_iter * (K * C * C + K * (C // 2) * C)
    vectors = n_iter * 4 * (5 * C + 2) + B * n_iter * C * 4 + B * 4
    return [ops, 2 * B * M * C * io_bytes + weights + vectors]
