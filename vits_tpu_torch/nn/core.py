"""Layers of the port (counterpart of vits_tpu/nn/core.py).

Every layer takes and returns channel-last tensors, the JAX package's
layout ((B, T, C); (B, H, W, C) for Conv2d), and keeps its weights in
torch's own layout:

  Dense            weight (out, in)
  Conv1d           weight (out, in // groups, k)
  ConvTranspose1d  weight (in, out, k)
  Conv2d           weight (out, in, kh, kw)
  Embedding        weight (n, d)
  LayerNorm        gamma, beta (C,)

Weight norm. Built with `weight_norm=True`, a Dense/Conv1d/ConvTranspose1d/
Conv2d holds `weight_g` (dim 0 kept, the rest 1) and `weight_v` (the
kernel's shape) in place of `weight`, and computes its kernel
g * v / ||v|| on every forward, the norm over every dim but 0 (torch's
`weight_norm(dim=0)` names and axes; the JAX package's g per output channel,
and per input channel for the transposed conv). Training builds its layers
so; serving builds plain layers and loads folded kernels
(`fold_weight_norm`, applied by `vits_tpu_torch.convert.params_from_jax`).
`kernel()` returns the kernel either way.

Spectral norm (vits_tpu/nn/core.py:103-182, the discriminators of the
stft/MRD variant). Built with `spectral_norm=True`, a Conv1d/Conv2d holds
`weight_orig` (a parameter, the kernel's shape) and `weight_u` (a buffer,
(C_out,), unit length), and divides the kernel by sigma, its largest singular
value estimated by one power iteration from u on every forward, with u and v
constants there (`sn_kernel`). u is advanced only by an explicit
`sn_update(module)`, once per discriminator step after its optimizer update,
as the JAX step does (vits_tpu/train/step.py:201-214), never by a forward;
`torch.nn.utils.spectral_norm`, which advances u on each training forward,
is not this function. The kernel flattens to (C_out, -1) in torch's layout,
a permutation of the JAX package's columns, which leaves sigma unchanged.

Random initialisation (`init_weights`) follows the distributions of
vits_tpu/nn/core.py:39-80 (not their bits), so a randomly initialised model
has realistic activation scales.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

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


def _xavier_bound(fan_in: int, fan_out: int, gain: float = 1.0) -> float:
    return gain * math.sqrt(6.0 / (fan_in + fan_out))


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

def _wn_norm(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(v * v, dim=tuple(range(1, v.ndim)), keepdim=True))


SN_EPS = 1e-12


def _unit(x: torch.Tensor) -> torch.Tensor:
    return x / (torch.linalg.vector_norm(x) + SN_EPS)


def _power_iteration(w: torch.Tensor, u: torch.Tensor):
    """One power-iteration step on w (C_out, -1) from u (C_out,): (v, u')
    with v = unit(w^T u), u' = unit(w v); sigma is u' . (w v)."""
    v = _unit(w.t() @ u)
    return v, _unit(w @ v)


def spectral_normalize(kernel: torch.Tensor, u: torch.Tensor):
    """One power-iteration step (vits_tpu/nn/core.py:167): kernel in torch's
    layout (C_out, ...) flattened to (C_out, -1), u (C_out,). Returns
    (kernel / sigma, the advanced u)."""
    w = kernel.reshape(kernel.shape[0], -1)
    v, u_new = _power_iteration(w, u)
    return kernel / (u_new @ (w @ v)), u_new


def sn_kernel(kernel: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """The spectral-normalised kernel of a forward (vits_tpu/nn/core.py:103
    `_sn_kernel`): one power iteration from u with u and v held constant, so
    the gradient reaches the kernel through w @ v and the division only."""
    w = kernel.reshape(kernel.shape[0], -1)
    with torch.no_grad():
        v, u_new = _power_iteration(w, u)
    return kernel / (u_new @ (w @ v))


def make_spectral_norm(c_out: int, gen: Optional[torch.Generator] = None) -> torch.Tensor:
    """A unit u of (C_out,) from N(0, 1) (vits_tpu/nn/core.py:132)."""
    u = torch.randn(c_out, generator=gen)
    return u / (torch.linalg.vector_norm(u) + SN_EPS)


@torch.no_grad()
def sn_update(module: nn.Module) -> nn.Module:
    """Advance every spectral-norm u under `module` by one power iteration on
    its current `weight_orig` (vits_tpu/nn/core.py:116): once per
    discriminator step, after its optimizer update."""
    for m in module.modules():
        if isinstance(m, _Kernel) and m.spectral_norm:
            w = m.weight_orig.reshape(m.weight_orig.shape[0], -1)
            m.weight_u.copy_(_power_iteration(w, m.weight_u)[1])
    return module


class _Kernel(nn.Module):
    """A layer's kernel: a plain `weight`, the weight-norm pair
    `weight_g`/`weight_v` (vits_tpu/nn/core.py:91 `wn_kernel`), or the
    spectral-norm `weight_orig` with its buffer `weight_u`."""

    def _make_kernel(self, shape, weight_norm: bool, spectral_norm: bool = False):
        if weight_norm and spectral_norm:
            raise ValueError("a kernel takes weight norm or spectral norm, not both")
        self.weight_norm, self.spectral_norm = weight_norm, spectral_norm
        if weight_norm:
            self.weight_g = nn.Parameter(torch.empty(shape[0], *([1] * (len(shape) - 1))))
            self.weight_v = nn.Parameter(torch.empty(*shape))
        elif spectral_norm:
            self.weight_orig = nn.Parameter(torch.empty(*shape))
            self.register_buffer("weight_u", torch.empty(shape[0]))
        else:
            self.weight = nn.Parameter(torch.empty(*shape))

    def kernel(self) -> torch.Tensor:
        if self.weight_norm:
            return self.weight_g * self.weight_v / _wn_norm(self.weight_v)
        if self.spectral_norm:
            return sn_kernel(self.weight_orig, self.weight_u)
        return self.weight

    def _raw(self) -> nn.Parameter:
        if self.weight_norm:
            return self.weight_v
        return self.weight_orig if self.spectral_norm else self.weight

    @torch.no_grad()
    def _set_kernel(self, w: torch.Tensor, gen=None):
        """Initialise from a kernel: weight norm starts at g = ||w||, so the
        layer computes w (vits_tpu/nn/core.py:137 `make_weight_norm`);
        spectral norm at w with a random unit u (`make_spectral_norm`)."""
        self._raw().copy_(w)
        if self.weight_norm:
            self.weight_g.copy_(_wn_norm(w))
        elif self.spectral_norm:
            self.weight_u.copy_(make_spectral_norm(w.shape[0], gen))

    def _uniform_kernel(self, bound: float, gen):
        self._set_kernel(torch.rand(self._raw().shape, generator=gen) * (2 * bound) - bound, gen)


class Dense(_Kernel):
    """Linear layer on the last axis (vits_tpu Dense)."""

    def __init__(self, in_features: int, out_features: int, init: str = "torch",
                 weight_norm: bool = False):
        super().__init__()
        self.in_features, self.out_features, self.init = in_features, out_features, init
        self._make_kernel((out_features, in_features), weight_norm)
        self.bias = nn.Parameter(torch.empty(out_features))

    def reset_parameters(self, gen=None):
        if self.init == "xavier":
            bound = _xavier_bound(self.in_features, self.out_features)
        else:
            bound = _kaiming_bound(self.in_features)
        self._uniform_kernel(bound, gen)
        _uniform_(self.bias, _bias_bound(self.in_features), gen)

    def forward(self, x):
        if x.dtype == torch.bfloat16:
            # the product rounded, then the bias add rounded, as the JAX
            # package's dot(preferred_element_type=x.dtype) + b: the speaker
            # conditioning K1's gate reads is bit-equal to its
            return F.linear(x, self.kernel()) + self.bias
        return F.linear(x, self.kernel(), self.bias)


class Conv1d(_Kernel):
    """1-D convolution on (B, T, C) (vits_tpu Conv1d: padding on both sides,
    stride, dilation, groups). init: "torch" (kaiming uniform), "xavier"
    (times `init_gain`), or "zeros". `conv_ncl` is the same convolution on
    (B, C, T)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 padding: int = 0, dilation: int = 1, groups: int = 1,
                 bias: bool = True, init: str = "torch", stride: int = 1,
                 weight_norm: bool = False, spectral_norm: bool = False,
                 init_gain: float = 1.0):
        super().__init__()
        self.in_channels, self.out_channels = in_channels, out_channels
        self.kernel_size, self.padding, self.stride = kernel_size, padding, stride
        self.dilation, self.groups, self.init = dilation, groups, init
        self.init_gain = init_gain
        self._make_kernel((out_channels, in_channels // groups, kernel_size), weight_norm,
                          spectral_norm)
        self.bias = nn.Parameter(torch.empty(out_channels)) if bias else None

    def reset_parameters(self, gen=None):
        k = self.kernel_size
        fan_in = (self.in_channels // self.groups) * k
        if self.init == "zeros":  # coupling-layer post conv: each flow starts at identity
            with torch.no_grad():
                self.weight.zero_()  # a plain kernel: weight norm of zeros is 0/0
                if self.bias is not None:
                    self.bias.zero_()
            return
        if self.init == "xavier":
            bound = _xavier_bound(fan_in, self.out_channels * k, self.init_gain)
        else:
            bound = _kaiming_bound(fan_in)
        self._uniform_kernel(bound, gen)
        if self.bias is not None:
            _uniform_(self.bias, _bias_bound(fan_in), gen)

    def conv_ncl(self, x):
        return F.conv1d(x, self.kernel(), self.bias, stride=self.stride, padding=self.padding,
                        dilation=self.dilation, groups=self.groups)

    def forward(self, x):
        return self.conv_ncl(x.transpose(1, 2)).transpose(1, 2)


class ConvTranspose1d(_Kernel):
    """torch-semantics transposed convolution on (B, T, C). The JAX package
    computes it as a subpixel (phase-packed) conv (core.py:332); this is the
    same function in its plain form. Output length (T-1)*stride - 2*padding + k."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int, padding: int = 0, weight_norm: bool = False):
        super().__init__()
        self.in_channels, self.out_channels = in_channels, out_channels
        self.kernel_size, self.stride, self.padding = kernel_size, stride, padding
        self._make_kernel((in_channels, out_channels, kernel_size), weight_norm)
        self.bias = nn.Parameter(torch.empty(out_channels))

    def reset_parameters(self, gen=None):
        fan_in = self.out_channels * self.kernel_size  # torch's fan for (in, out, k)
        self._uniform_kernel(_kaiming_bound(fan_in), gen)
        _uniform_(self.bias, _bias_bound(fan_in), gen)

    def forward(self, x):
        y = F.conv_transpose1d(x.transpose(1, 2), self.kernel(), self.bias,
                               stride=self.stride, padding=self.padding)
        return y.transpose(1, 2)


class Conv2d(_Kernel):
    """2-D convolution (vits_tpu Conv2d): (B, H, W, C) at the public face;
    `conv_nchw` is the same convolution on (B, C, H, W). init: "torch"
    (kaiming uniform) or "xavier" (times `init_gain`)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: Tuple[int, int],
                 stride: Tuple[int, int] = (1, 1), padding: Tuple[int, int] = (0, 0),
                 bias: bool = True, weight_norm: bool = False, spectral_norm: bool = False,
                 init: str = "torch", init_gain: float = 1.0):
        super().__init__()
        self.in_channels, self.out_channels = in_channels, out_channels
        self.kernel_size, self.stride, self.padding = (tuple(kernel_size), tuple(stride),
                                                       tuple(padding))
        self.init, self.init_gain = init, init_gain
        self._make_kernel((out_channels, in_channels, *self.kernel_size), weight_norm,
                          spectral_norm)
        self.bias = nn.Parameter(torch.empty(out_channels)) if bias else None

    def reset_parameters(self, gen=None):
        area = self.kernel_size[0] * self.kernel_size[1]
        fan_in = self.in_channels * area
        if self.init == "xavier":
            bound = _xavier_bound(fan_in, self.out_channels * area, self.init_gain)
        else:
            bound = _kaiming_bound(fan_in)
        self._uniform_kernel(bound, gen)
        if self.bias is not None:
            _uniform_(self.bias, _bias_bound(fan_in), gen)

    def conv_nchw(self, x):
        return F.conv2d(x, self.kernel(), self.bias, stride=self.stride, padding=self.padding)

    def forward(self, x):
        return self.conv_nchw(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


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
    """x where x >= 0, else x * slope with the slope in x's dtype, as the
    JAX package multiplies by a Python float (vits_tpu/nn/core.py:466): in
    bf16 that is bf16(0.1) = 0.10009765625, the product rounded once."""
    if x.dtype == torch.bfloat16:
        slope = float(torch.tensor(slope, dtype=torch.bfloat16))
    return F.leaky_relu(x, slope)


def dropout(x, p: float, generator: Optional[torch.Generator] = None):
    """Inverted dropout (vits_tpu/nn/core.py:457): keep each element with
    probability 1 - p and scale it by 1 / (1 - p); a no-op at p = 0. The mask
    is drawn from `generator` (on x's device; None draws from torch's global
    generator)."""
    if p == 0.0:
        return x
    keep = 1.0 - p
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))
