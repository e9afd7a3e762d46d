"""Core blocks (counterpart of vits_tpu/models/modules.py): the learned
Swish, the WaveNet stack, the GLU ResBlock2 with its int8 form, the
tanh-gated ResBlock1 (float only, as in the JAX package), the affine
coupling flow in both directions (mean-only by default) with its logdet,
ElementwiseAffine and the Log flow. Tensors are channel-last (B, T, C).
`weight_norm=True` builds the layers the JAX package weight-normalises
(WN's in/res-skip/cond layers, the resblocks' convs and conds) with
trainable g/v pairs.

Masking rule (the JAX package's): every conv with k > 1 sees masked input,
so bucketed, padded inference equals exact-length inference.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from vits_tpu_torch.nn import quant as Q
from vits_tpu_torch.nn import rb_chain
from vits_tpu_torch.nn.core import Conv1d, Dense, dropout, leaky_relu

LRELU_SLOPE = 0.1


def _mask(x, x_mask):
    return x if x_mask is None else x * x_mask


def _round16(c: int) -> int:
    return (c // 16) * 16


def fused_steps(block) -> list:
    """A ResBlock's dilation steps as `Generator.forward`'s packed body runs
    them: conv1 computes only the `inter_channels` channels the gate reads
    (all of ResBlock2's, the first half of ResBlock1's), its kernel a view
    of the folded weight; conv2 as it is; the speaker rows of each step
    (cond's kernel and its bias plus conv1's, over those channels). The
    biases go to the glue kernels: the convs run without."""
    ic = block.inter_channels
    steps = []
    for i, d in enumerate(block.dilation):
        c1, c2, cond = block.convs1[str(i)], block.convs2[str(i)], block.conds[str(i)]
        steps.append({"w1": c1.weight[:ic], "dilation": d, "pad1": c1.padding,
                      "w2": c2.weight, "pad2": c2.padding, "b2": c2.bias,
                      "s_w": cond.weight[:ic], "s_b": cond.bias[:ic] + c1.bias[:ic]})
    return steps


def flip_channels(x):
    """modules.Flip: reverse the channel axis."""
    return torch.flip(x, dims=(-1,))


class Swish(nn.Module):
    """x * sigmoid(w * x) with a learned scalar w, initialised to 1 (the
    duration predictor's `act_func_d: "swish"`)."""

    def __init__(self, num_parameters: int = 1, init: float = 1.0):
        super().__init__()
        self.init = init
        self.weight = nn.Parameter(torch.full((num_parameters,), init))

    def reset_parameters(self, gen=None):
        with torch.no_grad():
            self.weight.fill_(self.init)

    def forward(self, x):
        return x * torch.sigmoid(self.weight * x)


class WN(nn.Module):
    """Gated dilated conv stack with res/skip and speaker conditioning; in
    training mode, dropout of rate p_dropout on the gated activations."""

    def __init__(self, hidden_channels: int, kernel_size: int, dilation_rate: int,
                 n_layers: int, gin_channels: int = 0, p_dropout: float = 0.0,
                 weight_norm: bool = False):
        super().__init__()
        self.hidden_channels, self.n_layers, self.gin_channels = (
            hidden_channels, n_layers, gin_channels)
        self.p_dropout = p_dropout
        h, wn = hidden_channels, weight_norm
        ins, res_skips = {}, {}
        for i in range(n_layers):
            d = dilation_rate ** i
            ins[str(i)] = Conv1d(h, 2 * h, kernel_size, padding=(kernel_size * d - d) // 2,
                                 dilation=d, weight_norm=wn)
            out = 2 * h if i < n_layers - 1 else h
            res_skips[str(i)] = Conv1d(h, out, 1, weight_norm=wn)
        self.in_layers = nn.ModuleDict(ins)
        self.res_skip_layers = nn.ModuleDict(res_skips)
        if gin_channels:
            self.cond_layer = Dense(gin_channels, 2 * h * n_layers, weight_norm=wn)

    def forward(self, x, x_mask=None, g=None, rng=None):
        h = self.hidden_channels
        output = torch.zeros_like(x)
        cond = self.cond_layer(g) if self.gin_channels else None
        for i in range(self.n_layers):
            acts = self.in_layers[str(i)](x)
            if cond is not None:
                acts = acts + cond[:, None, i * 2 * h:(i + 1) * 2 * h]
            acts = torch.tanh(acts[..., :h]) * torch.sigmoid(acts[..., h:])
            acts = dropout(acts, self.p_dropout if self.training else 0.0, rng)
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

    GLU = True  # the packed body's gate: tanh(a) * sigmoid(b) over conv1's halves

    def __init__(self, channels: int, kernel_size: int = 3,
                 dilation: Sequence[int] = (1, 3, 5), gin_channels: int = 0,
                 weight_norm: bool = False):
        super().__init__()
        self.channels, self.kernel_size = channels, kernel_size
        self.dilation = tuple(dilation)
        self.inter_channels = ic = _round16(channels)
        n, wn = len(self.dilation), weight_norm
        self.convs1 = nn.ModuleDict({
            str(i): Conv1d(channels, ic, kernel_size, padding=(kernel_size * d - d) // 2,
                           dilation=d, weight_norm=wn) for i, d in enumerate(self.dilation)})
        self.convs2 = nn.ModuleDict({
            str(i): Conv1d(ic // 2, channels, kernel_size, padding=(kernel_size - 1) // 2,
                           weight_norm=wn)
            for i in range(n)})
        self.conds = nn.ModuleDict({str(i): Dense(gin_channels, ic, weight_norm=wn)
                                    for i in range(n)})

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
            convs.append((Q.kernel_klast(c1.kernel()), c1.bias,
                          scales[f"{prefix}c1_{i}"],
                          Q.kernel_klast(c2.kernel()), c2.bias,
                          scales[f"{prefix}c2_{i}"]))
        return rb_chain.quantize_chain(convs, self.kernel_size, self.dilation)

    def apply_q8(self, qp, x, g, x_mask=None):
        """int8 forward of the whole chain: x (B, M, C) float32 or bfloat16,
        g (B, gin), x_mask (B, M, 1) prefix mask or None."""
        gs = torch.stack([self.conds[str(i)](g) for i in range(len(self.dilation))],
                         dim=1).float()
        B, M, _ = x.shape
        if x_mask is None:
            valid = torch.full((B,), M, dtype=torch.int32, device=x.device)
        else:
            valid = x_mask[:, :, 0].float().sum(dim=1).to(torch.int32)  # exact in f32
        return rb_chain.resblock2_chain_q8(qp, x, gs, valid)


class ResBlock1(nn.Module):
    """The fork's speaker-conditioned, tanh-gated HiFi-GAN resblock
    (vits_tpu ResBlock1, modules.py:126): per dilation, xt = tanh(conv1(
    lrelu(x)) + cond(g)) over 2 * inter channels, of which conv2 takes the
    first `inter_channels` (the reference's block is shape-inconsistent
    there; the JAX package takes the first half), masked, then the residual
    add. Float only: neither package has an int8 form of it. The packed
    body (`fused_steps`) computes only the channels conv2 reads."""

    GLU = False  # the packed body's gate: tanh over the channels conv2 reads

    def __init__(self, channels: int, kernel_size: int = 3,
                 dilation: Sequence[int] = (1, 3, 5), gin_channels: int = 0,
                 weight_norm: bool = False):
        super().__init__()
        self.channels, self.kernel_size = channels, kernel_size
        self.dilation = tuple(dilation)
        self.inter_channels = ic = _round16(channels)
        wn = weight_norm
        self.convs1 = nn.ModuleDict({
            str(i): Conv1d(channels, 2 * ic, kernel_size, padding=(kernel_size * d - d) // 2,
                           dilation=d, weight_norm=wn) for i, d in enumerate(self.dilation)})
        self.convs2 = nn.ModuleDict({
            str(i): Conv1d(ic, channels, kernel_size, padding=(kernel_size - 1) // 2,
                           weight_norm=wn)
            for i in range(len(self.dilation))})
        self.conds = nn.ModuleDict({str(i): Dense(gin_channels, 2 * ic, weight_norm=wn)
                                    for i in range(len(self.dilation))})

    def forward(self, x, g, x_mask=None, record=None, rec_prefix=""):
        del record, rec_prefix  # no int8 form to calibrate
        ic = self.inter_channels
        for i in range(len(self.dilation)):
            xt = self.convs1[str(i)](leaky_relu(x, LRELU_SLOPE))
            xt = torch.tanh(xt + self.conds[str(i)](g)[:, None, :])
            xt = self.convs2[str(i)](_mask(xt[..., :ic], x_mask))
            x = _mask(xt + x, x_mask)
        return x


class ResidualCouplingLayer(nn.Module):
    """Affine coupling over channel halves, mean-only unless `mean_only`
    is False (then the post conv also gives log-scales); the post conv is
    zero-initialised so each flow starts at identity."""

    def __init__(self, channels: int, hidden_channels: int, kernel_size: int,
                 dilation_rate: int, n_layers: int, gin_channels: int = 0,
                 weight_norm: bool = False, mean_only: bool = True):
        super().__init__()
        self.half_channels = channels // 2
        self.mean_only = mean_only
        self.pre = Conv1d(self.half_channels, hidden_channels, 1)
        self.enc = WN(hidden_channels, kernel_size, dilation_rate, n_layers,
                      gin_channels=gin_channels, weight_norm=weight_norm)
        self.post = Conv1d(hidden_channels, self.half_channels * (2 - int(mean_only)), 1,
                           init="zeros")

    def forward(self, x, x_mask=None, g=None, reverse: bool = True):
        """reverse: x1 <- (x1 - m(x0)) * exp(-logs(x0)) masked (inference),
        returns x; forward (reverse=False, training): x1 <- m(x0) + x1 *
        exp(logs(x0)) masked, returns (x, logdet (B,)), logdet the sum of
        logs over time and channels (0 for a mean-only flow)."""
        half = self.half_channels
        x0, x1 = x[..., :half], x[..., half:]
        h = _mask(self.pre(x0), x_mask)
        h = self.enc(h, x_mask, g=g)
        stats = _mask(self.post(h), x_mask)
        if self.mean_only:
            m, logs = stats, None
        else:
            m, logs = stats[..., :half], stats[..., half:]
        if reverse:
            x1 = x1 - m if logs is None else (x1 - m) * torch.exp(-logs)
            return torch.cat([x0, _mask(x1, x_mask)], dim=-1)
        if logs is None:
            x1, logdet = m + x1, x.new_zeros(x.shape[0])
        else:
            x1, logdet = m + x1 * torch.exp(logs), torch.sum(logs, dim=(1, 2))
        return torch.cat([x0, _mask(x1, x_mask)], dim=-1), logdet


class ElementwiseAffine(nn.Module):
    """modules.ElementwiseAffine (vits_tpu modules.py:397): y = m + exp(logs)
    * x per channel, with logdet sum(logs) over the masked positions; m and
    logs start at 0. Present in the reference and unused by its model."""

    def __init__(self, channels: int):
        super().__init__()
        self.m = nn.Parameter(torch.zeros(channels))
        self.logs = nn.Parameter(torch.zeros(channels))

    def reset_parameters(self, gen=None):
        with torch.no_grad():
            self.m.zero_()
            self.logs.zero_()

    def forward(self, x, x_mask=None, reverse: bool = False):
        """forward: (y, logdet (B,)); reverse: x."""
        if reverse:
            return _mask((x - self.m) * torch.exp(-self.logs), x_mask)
        y = _mask(self.m + torch.exp(self.logs) * x, x_mask)
        logs = self.logs.expand(x.shape)
        return y, torch.sum(logs if x_mask is None else logs * x_mask, dim=(1, 2))


def log_flow(x, x_mask=None, reverse: bool = False):
    """modules.Log (vits_tpu modules.py:417): forward y = log(max(x, 1e-5))
    masked, returns (y, logdet = -sum(y)); reverse exp(x) masked."""
    if reverse:
        return _mask(torch.exp(x), x_mask)
    y = _mask(torch.log(torch.clamp(x, min=1e-5)), x_mask)
    return y, torch.sum(-y, dim=(1, 2))
