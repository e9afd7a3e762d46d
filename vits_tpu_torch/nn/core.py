"""Layers of the port (counterpart of vits_tpu/nn/core.py).

Every layer takes and returns channel-last `(B, T, C)` tensors, the JAX
package's layout, and keeps its weights in torch's own layout:

  Dense            weight (out, in)
  Conv1d           weight (out, in // groups, k)
  ConvTranspose1d  weight (in, out, k)
  Embedding        weight (n, d)
  LayerNorm        gamma, beta (C,)

Weight norm exists only in the parameter trees the JAX package writes; the
port serves folded kernels (`fold_weight_norm`, applied by
`vits_tpu_torch.convert.params_from_jax`).

Random initialisation (`init_weights`) follows the distributions of
vits_tpu/nn/core.py:39-80 (not their bits), so a randomly initialised model
has realistic activation scales.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


# ---------------------------------------------------------------------------
# initializers (distributions of vits_tpu/nn/core.py:39-80)
# ---------------------------------------------------------------------------

def _uniform_(t: torch.Tensor, bound: float, gen: Optional[torch.Generator]):
    with torch.no_grad():
        t.copy_(torch.rand(t.shape, generator=gen) * (2 * bound) - bound)


def _kaiming_bound(fan_in: int) -> float:
    """torch's default Linear/Conv bound: leaky-relu gain with a=sqrt(5)."""
    return math.sqrt(2.0 / 6.0) * math.sqrt(3.0 / fan_in)


def _xavier_bound(fan_in: int, fan_out: int) -> float:
    return math.sqrt(6.0 / (fan_in + fan_out))


def _bias_bound(fan_in: int) -> float:
    return 1.0 / math.sqrt(fan_in) if fan_in > 0 else 0.0


def init_weights(module: nn.Module, generator: Optional[torch.Generator] = None):
    """Randomly initialise every layer under `module` from `generator` (a CPU
    `torch.Generator`); call before moving the module to its device."""
    for m in module.modules():
        reset = getattr(m, "reset_parameters", None)
        if reset is not None and m.__class__.__module__.startswith("vits_tpu_torch"):
            reset(generator)
    return module


# ---------------------------------------------------------------------------
# weight norm on JAX parameter trees (vits_tpu/nn/core.py:91, :150)
# ---------------------------------------------------------------------------

def _wn_axes(v: np.ndarray, g: np.ndarray):
    if g.ndim == 1:
        return tuple(range(v.ndim - 1))
    return tuple(i for i in range(v.ndim) if g.shape[i] == 1)


def wn_kernel(p):
    """Materialise a kernel from a weight-norm {"g", "v"} pair (numpy, float32)
    or return the plain {"w"} kernel."""
    if "v" in p:
        v = np.asarray(p["v"], np.float32)
        g = np.asarray(p["g"], np.float32)
        norm = np.sqrt(np.sum(np.square(v), axis=_wn_axes(v, g), keepdims=True))
        return (g * v / norm).astype(np.float32)
    return np.asarray(p["w"])


def fold_weight_norm(params):
    """Recursively fold every {"g", "v"} pair of a JAX parameter tree into a
    plain "w" kernel."""
    if isinstance(params, dict):
        if "v" in params and "g" in params:
            out = {k: v for k, v in params.items() if k not in ("v", "g")}
            out["w"] = wn_kernel(params)
            return out
        return {k: fold_weight_norm(v) for k, v in params.items()}
    return params


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

class Dense(nn.Module):
    """Linear layer on the last axis (vits_tpu Dense)."""

    def __init__(self, in_features: int, out_features: int, init: str = "torch"):
        super().__init__()
        self.in_features, self.out_features, self.init = in_features, out_features, init
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.empty(out_features))

    def reset_parameters(self, gen=None):
        if self.init == "xavier":
            bound = _xavier_bound(self.in_features, self.out_features)
        else:
            bound = _kaiming_bound(self.in_features)
        _uniform_(self.weight, bound, gen)
        _uniform_(self.bias, _bias_bound(self.in_features), gen)

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)


class Conv1d(nn.Module):
    """Stride-1 1-D convolution on (B, T, C) (vits_tpu Conv1d: padding on
    both sides, dilation, groups). init: "torch" (kaiming uniform), "xavier",
    or "zeros"."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 padding: int = 0, dilation: int = 1, groups: int = 1,
                 bias: bool = True, init: str = "torch"):
        super().__init__()
        self.in_channels, self.out_channels = in_channels, out_channels
        self.kernel_size, self.padding = kernel_size, padding
        self.dilation, self.groups, self.init = dilation, groups, init
        self.weight = nn.Parameter(
            torch.empty(out_channels, in_channels // groups, kernel_size))
        self.bias = nn.Parameter(torch.empty(out_channels)) if bias else None

    def reset_parameters(self, gen=None):
        k = self.kernel_size
        fan_in = (self.in_channels // self.groups) * k
        if self.init == "zeros":  # coupling-layer post conv: each flow starts at identity
            with torch.no_grad():
                self.weight.zero_()
                if self.bias is not None:
                    self.bias.zero_()
            return
        if self.init == "xavier":
            bound = _xavier_bound(fan_in, self.out_channels * k)
        else:
            bound = _kaiming_bound(fan_in)
        _uniform_(self.weight, bound, gen)
        if self.bias is not None:
            _uniform_(self.bias, _bias_bound(fan_in), gen)

    def forward(self, x):
        y = F.conv1d(x.transpose(1, 2), self.weight, self.bias, padding=self.padding,
                     dilation=self.dilation, groups=self.groups)
        return y.transpose(1, 2)


class ConvTranspose1d(nn.Module):
    """torch-semantics transposed convolution on (B, T, C). The JAX package
    computes it as a subpixel (phase-packed) conv (core.py:332); this is the
    same function in its plain form. Output length (T-1)*stride - 2*padding + k."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int, padding: int = 0):
        super().__init__()
        self.in_channels, self.out_channels = in_channels, out_channels
        self.kernel_size, self.stride, self.padding = kernel_size, stride, padding
        self.weight = nn.Parameter(torch.empty(in_channels, out_channels, kernel_size))
        self.bias = nn.Parameter(torch.empty(out_channels))

    def reset_parameters(self, gen=None):
        fan_in = self.out_channels * self.kernel_size  # torch's fan for (in, out, k)
        _uniform_(self.weight, _kaiming_bound(fan_in), gen)
        _uniform_(self.bias, _bias_bound(fan_in), gen)

    def forward(self, x):
        y = F.conv_transpose1d(x.transpose(1, 2), self.weight, self.bias,
                               stride=self.stride, padding=self.padding)
        return y.transpose(1, 2)


class Embedding(nn.Module):
    def __init__(self, num_embeddings: int, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(num_embeddings, features))

    def reset_parameters(self, gen=None):
        with torch.no_grad():
            self.weight.copy_(torch.randn(self.weight.shape, generator=gen))

    def forward(self, ids):
        return F.embedding(ids, self.weight)


class LayerNorm(nn.Module):
    """LayerNorm over the channel (last) axis with gamma/beta."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.channels, self.eps = channels, eps
        self.gamma = nn.Parameter(torch.ones(channels))
        self.beta = nn.Parameter(torch.zeros(channels))

    def reset_parameters(self, gen=None):
        with torch.no_grad():
            self.gamma.fill_(1.0)
            self.beta.zero_()

    def forward(self, x):
        return F.layer_norm(x, (self.channels,), self.gamma, self.beta, self.eps)


def leaky_relu(x, slope: float = 0.1):
    return F.leaky_relu(x, slope)
