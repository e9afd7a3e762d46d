"""Multi-period waveform discriminators (counterpart of
vits_tpu/models/discriminators.py): DiscriminatorP (period-reshaped 2-D
convs), DiscriminatorS (grouped strided 1-D convs) and
MultiPeriodDiscriminator (S + periods 2, 3, 5, 7, 11), every conv
weight-normed, or spectral-normed with `use_spectral_norm`
(vits_tpu/models/discriminators.py:33-49, :79-83; both shipped configs
set it false).

Waveforms are (B, T, 1). Inside, the convs run channel-first (NCHW, NCL);
the feature maps come back as channel-last views in the JAX package's
layouts: (B, T // p, p, C) for DiscriminatorP, (B, T', C) for
DiscriminatorS. Scores are (B, n).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference.core import Conv1d, Conv2d, leaky_relu

LRELU_SLOPE = 0.1


def _pad(k, d=1):
    return (k * d - d) // 2


def _norm(use_spectral_norm: bool):
    return dict(weight_norm=not use_spectral_norm, spectral_norm=use_spectral_norm)


class DiscriminatorP(nn.Module):
    def __init__(self, period: int, kernel_size: int = 5, stride: int = 3,
                 use_spectral_norm: bool = False):
        super().__init__()
        self.period = period
        k, s = kernel_size, stride
        norm = _norm(use_spectral_norm)
        chans = [(1, 32), (32, 128), (128, 512), (512, 1024)]
        convs = [Conv2d(ci, co, (k, 1), (s, 1), (_pad(k), 0), **norm) for ci, co in chans]
        convs.append(Conv2d(1024, 1024, (k, 1), (1, 1), (_pad(k), 0), **norm))
        self.convs = nn.ModuleDict({str(i): c for i, c in enumerate(convs)})
        self.conv_post = Conv2d(1024, 1, (3, 1), (1, 1), (1, 0), **norm)

    def forward(self, x):
        """x (B, T, 1) -> (score (B, n), fmaps). T is reflect-padded to a
        multiple of the period, then viewed as (B, 1, T // p, p)."""
        B, T, C = x.shape
        h = x.transpose(1, 2)  # (B, 1, T)
        if T % self.period:
            n_pad = self.period - T % self.period
            h = F.pad(h, (0, n_pad), mode="reflect")
            T += n_pad
        h = h.reshape(B, C, T // self.period, self.period)
        fmap = []
        for conv in self.convs.values():
            h = leaky_relu(conv.conv_nchw(h), LRELU_SLOPE)
            fmap.append(h.permute(0, 2, 3, 1))
        h = self.conv_post.conv_nchw(h)
        fmap.append(h.permute(0, 2, 3, 1))
        return h.reshape(B, -1), fmap


class DiscriminatorS(nn.Module):
    def __init__(self, use_spectral_norm: bool = False):
        super().__init__()
        norm = _norm(use_spectral_norm)
        spec = [(1, 16, 15, 1, 1, 7), (16, 64, 41, 4, 4, 20), (64, 256, 41, 4, 16, 20),
                (256, 1024, 41, 4, 64, 20), (1024, 1024, 41, 4, 256, 20),
                (1024, 1024, 5, 1, 1, 2)]
        self.convs = nn.ModuleDict({
            str(i): Conv1d(ci, co, k, padding=pd, groups=g, stride=s, **norm)
            for i, (ci, co, k, s, g, pd) in enumerate(spec)})
        self.conv_post = Conv1d(1024, 1, 3, padding=1, **norm)

    def forward(self, x):
        """x (B, T, 1) -> (score (B, T'), fmaps (B, T_i, C_i))."""
        h = x.transpose(1, 2)
        fmap = []
        for conv in self.convs.values():
            h = leaky_relu(conv.conv_ncl(h), LRELU_SLOPE)
            fmap.append(h.transpose(1, 2))
        h = self.conv_post.conv_ncl(h)
        fmap.append(h.transpose(1, 2))
        return h.reshape(h.shape[0], -1), fmap


class MultiPeriodDiscriminator(nn.Module):
    def __init__(self, use_spectral_norm: bool = False,
                 periods: Sequence[int] = (2, 3, 5, 7, 11)):
        super().__init__()
        discs = [DiscriminatorS(use_spectral_norm)] + \
            [DiscriminatorP(p, use_spectral_norm=use_spectral_norm) for p in periods]
        self.discriminators = nn.ModuleDict({str(i): d for i, d in enumerate(discs)})

    def forward(self, y, y_hat):
        """y, y_hat (B, T, 1) -> (y_d_rs, y_d_gs, fmap_rs, fmap_gs). Real and
        fake run as one batch through each sub-discriminator."""
        B = y.shape[0]
        both = torch.cat([y, y_hat], dim=0)
        y_d_rs, y_d_gs, fmap_rs, fmap_gs = [], [], [], []
        for d in self.discriminators.values():
            s, f = d(both)
            y_d_rs.append(s[:B])
            y_d_gs.append(s[B:])
            fmap_rs.append([fm[:B] for fm in f])
            fmap_gs.append([fm[B:] for fm in f])
        return y_d_rs, y_d_gs, fmap_rs, fmap_gs
