"""Core blocks (counterpart of vits_tpu/models/modules.py): the WaveNet
stack, the GLU ResBlock2 with its int8 form, and the coupling flow (reverse
direction, inference only). Tensors are channel-last (B, T, C).

Masking rule (the JAX package's): every conv with k > 1 sees masked input,
so bucketed, padded inference equals exact-length inference.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from vits_tpu_torch.nn import quant as Q
from vits_tpu_torch.nn import rb_chain
from vits_tpu_torch.nn.core import Conv1d, Dense, leaky_relu

LRELU_SLOPE = 0.1


def _mask(x, x_mask):
    return x if x_mask is None else x * x_mask


def _round16(c: int) -> int:
    return (c // 16) * 16


def flip_channels(x):
    """modules.Flip: reverse the channel axis."""
    return torch.flip(x, dims=(-1,))


class WN(nn.Module):
    """Gated dilated conv stack with res/skip and speaker conditioning."""

    def __init__(self, hidden_channels: int, kernel_size: int, dilation_rate: int,
                 n_layers: int, gin_channels: int = 0):
        super().__init__()
        self.hidden_channels, self.n_layers, self.gin_channels = (
            hidden_channels, n_layers, gin_channels)
        h = hidden_channels
        ins, res_skips = {}, {}
        for i in range(n_layers):
            d = dilation_rate ** i
            ins[str(i)] = Conv1d(h, 2 * h, kernel_size, padding=(kernel_size * d - d) // 2,
                                 dilation=d)
            out = 2 * h if i < n_layers - 1 else h
            res_skips[str(i)] = Conv1d(h, out, 1)
        self.in_layers = nn.ModuleDict(ins)
        self.res_skip_layers = nn.ModuleDict(res_skips)
        if gin_channels:
            self.cond_layer = Dense(gin_channels, 2 * h * n_layers)

    def forward(self, x, x_mask=None, g=None):
        h = self.hidden_channels
        output = torch.zeros_like(x)
        cond = self.cond_layer(g) if self.gin_channels else None
        for i in range(self.n_layers):
            acts = self.in_layers[str(i)](x)
            if cond is not None:
                acts = acts + cond[:, None, i * 2 * h:(i + 1) * 2 * h]
            acts = torch.tanh(acts[..., :h]) * torch.sigmoid(acts[..., h:])
            res_skip = self.res_skip_layers[str(i)](acts)
            if i < self.n_layers - 1:
                x = _mask(x + res_skip[..., :h], x_mask)
                output = output + res_skip[..., h:]
            else:
                output = output + res_skip
        return _mask(output, x_mask)


class ResBlock2(nn.Module):
    """GLU-gated speaker-conditioned resblock (the configured default).

    `forward` is the float path (with optional max-abs recording for int8
    calibration); `quantize_params` + `apply_q8` the int8 path, which runs
    through `vits_tpu_torch.nn.rb_chain` (the CUDA kernel on the GPU, its
    plain version on the CPU)."""

    def __init__(self, channels: int, kernel_size: int = 3,
                 dilation: Sequence[int] = (1, 3, 5), gin_channels: int = 0):
        super().__init__()
        self.channels, self.kernel_size = channels, kernel_size
        self.dilation = tuple(dilation)
        self.inter_channels = ic = _round16(channels)
        n = len(self.dilation)
        self.convs1 = nn.ModuleDict({
            str(i): Conv1d(channels, ic, kernel_size, padding=(kernel_size * d - d) // 2,
                           dilation=d) for i, d in enumerate(self.dilation)})
        self.convs2 = nn.ModuleDict({
            str(i): Conv1d(ic // 2, channels, kernel_size, padding=(kernel_size - 1) // 2)
            for i in range(n)})
        self.conds = nn.ModuleDict({str(i): Dense(gin_channels, ic) for i in range(n)})

    def forward(self, x, g, x_mask=None, record=None, rec_prefix=""):
        half = self.inter_channels // 2
        for i in range(len(self.dilation)):
            xt = leaky_relu(x, LRELU_SLOPE)
            if record is not None:
                record[f"{rec_prefix}c1_{i}"] = Q.amax(xt)
            xt = self.convs1[str(i)](xt)
            gs = self.conds[str(i)](g)
            xt = torch.tanh(xt[..., :half] + gs[:, None, :half]) * \
                torch.sigmoid(xt[..., half:] + gs[:, None, half:])
            xt = _mask(xt, x_mask)
            if record is not None:
                record[f"{rec_prefix}c2_{i}"] = Q.amax(xt)
            xt = self.convs2[str(i)](xt)
            x = _mask(xt + x, x_mask)
        return x

    @torch.no_grad()
    def quantize_params(self, scales, prefix: str = ""):
        """Post-training int8 quantization of this block's convs from a
        calibration record (`forward(..., record=...)`). Per-output-channel
        weight scales (the JAX package's scales at any phase pack); the
        conditioning Denses stay float. Returns the chain's quantized params
        (`rb_chain.quantize_chain`)."""
        convs = []
        for i in range(len(self.dilation)):
            c1, c2 = self.convs1[str(i)], self.convs2[str(i)]
            convs.append((Q.kernel_klast(c1.weight), c1.bias,
                          scales[f"{prefix}c1_{i}"],
                          Q.kernel_klast(c2.weight), c2.bias,
                          scales[f"{prefix}c2_{i}"]))
        return rb_chain.quantize_chain(convs, self.kernel_size, self.dilation)

    def apply_q8(self, qp, x, g, x_mask=None):
        """int8 forward of the whole chain: x (B, M, C) float32, g (B, gin),
        x_mask (B, M, 1) prefix mask or None."""
        gs = torch.stack([self.conds[str(i)](g) for i in range(len(self.dilation))],
                         dim=1).float()
        B, M, _ = x.shape
        if x_mask is None:
            valid = torch.full((B,), M, dtype=torch.int32, device=x.device)
        else:
            valid = x_mask[:, :, 0].sum(dim=1).to(torch.int32)
        return rb_chain.resblock2_chain_q8(qp, x, gs, valid)


class ResidualCouplingLayer(nn.Module):
    """Mean-only affine coupling over channel halves; the post conv is
    zero-initialised so each flow starts at identity. Reverse direction."""

    def __init__(self, channels: int, hidden_channels: int, kernel_size: int,
                 dilation_rate: int, n_layers: int, gin_channels: int = 0):
        super().__init__()
        self.half_channels = channels // 2
        self.pre = Conv1d(self.half_channels, hidden_channels, 1)
        self.enc = WN(hidden_channels, kernel_size, dilation_rate, n_layers,
                      gin_channels=gin_channels)
        self.post = Conv1d(hidden_channels, self.half_channels, 1, init="zeros")

    def forward(self, x, x_mask=None, g=None):
        """Reverse coupling: x1 <- (x1 - m(x0)) masked."""
        half = self.half_channels
        x0, x1 = x[..., :half], x[..., half:]
        h = _mask(self.pre(x0), x_mask)
        h = self.enc(h, x_mask, g=g)
        m = _mask(self.post(h), x_mask)
        x1 = _mask(x1 - m, x_mask)
        return torch.cat([x0, x1], dim=-1)
