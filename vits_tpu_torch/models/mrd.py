"""Multi-resolution wave and STFT discriminators of the stft/MRD variant
(counterpart of vits_tpu/models/mrd.py): WaveDiscriminator (a stack of VALID
1-D convs, dilations 2..layers-1 between two 1x1 convs), MultiWaveDiscriminator
(level i sees the wave folded into 2^i channels), STFTDiscriminator (2-D convs
that collapse the frequency axis of a magnitude image), MultiSTFTDiscriminator
(five resolutions) and MultiWaveSTFTDiscriminator (both). Every conv is
spectral-normed and xavier-initialised with the leaky-ReLU gain; the module
paths are the JAX tree's (`mwd.discriminators.<i>.convs.<j>`,
`mfd.discriminators.<i>.convs.<j>`). Each STFTDiscriminator holds the
(fft, hop, win) resolution of the magnitudes it reads, which the stft
training step computes from `MultiWaveSTFTDiscriminator.resolutions`.

Waves are (B, T, 1) and magnitudes (B, T', F), the JAX package's layouts;
inside, the convs run channel-first. The JAX package computes a dilated
conv as d dense convs over phase streams (mrd.py:83), a TPU reformulation of
the same values; here it is `F.conv1d` with `dilation=d`.
"""

from __future__ import annotations

import math
from typing import List, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from vits_tpu_torch.nn.core import Conv1d, Conv2d, leaky_relu

LRELU_SLOPE = 0.2


def lrelu_gain(slope: float = LRELU_SLOPE) -> float:
    return math.sqrt(2.0 / (1.0 + slope ** 2))


class WaveDiscriminator(nn.Module):
    def __init__(self, in_channels: int, kernel_size: int = 5, layers: int = 10,
                 conv_channels: int = 64):
        super().__init__()
        cc = conv_channels
        norm = dict(spectral_norm=True, init="xavier", init_gain=lrelu_gain())
        convs = [Conv1d(in_channels, cc, 1, **norm)]
        convs += [Conv1d(cc, cc, kernel_size, dilation=i + 2, **norm)
                  for i in range(layers - 2)]
        convs.append(Conv1d(cc, 1, 1, **norm))
        self.convs = nn.ModuleDict({str(i): c for i, c in enumerate(convs)})

    def forward_ncl(self, x):
        """x (B, in_channels, T) -> (B, T') score, T' = T - sum of the
        dilated convs' receptive spans (no padding)."""
        last = len(self.convs) - 1
        for i, conv in enumerate(self.convs.values()):
            x = conv.conv_ncl(x)
            if i < last:
                x = leaky_relu(x, LRELU_SLOPE)
        return x[:, 0]

    def forward(self, x):
        """x (B, T, in_channels) -> (B, T') score."""
        return self.forward_ncl(x.transpose(1, 2))


class MultiWaveDiscriminator(nn.Module):
    def __init__(self, num_dwt: int = 5, kernel_size: int = 5, layers: int = 10,
                 conv_channels: int = 64):
        super().__init__()
        self.discriminators = nn.ModuleDict({
            str(i): WaveDiscriminator(2 ** i, kernel_size, layers, conv_channels + i * 32)
            for i in range(num_dwt)})

    def forward(self, x) -> List[torch.Tensor]:
        """x (B, T, 1) -> one score per level. Between levels an odd length is
        reflect-padded by one sample and each channel's sequence is split
        into halves that become channels 2c and 2c + 1 (mrd.py:137-145, the
        reference's view(b, period, -1))."""
        h = x.transpose(1, 2)  # (B, C, T)
        outs = []
        n = len(self.discriminators)
        for i, d in enumerate(self.discriminators.values()):
            outs.append(d.forward_ncl(h))
            if i + 1 == n:
                break
            B, C, T = h.shape
            period = 2 ** (i + 1)
            if (T * C) % period:
                n_pad = (period - (T * C) % period) // C
                h = F.pad(h, (0, n_pad), mode="reflect")
                T += n_pad
            h = h.reshape(B, 2 * C, T // 2)
        return outs


def stft_plan(fft_size: int, num_layers: int, kernel_size: int, stride: int,
              conv_channels: int):
    """The convs of a STFTDiscriminator (mrd.py:164): [(in, out, (kh, kw),
    (sh, sw), (ph, pw))], frequency kernels and strides from
    s0 = int(F^(1 / num_layers)), a last (F_left, 1) conv onto one channel."""
    F_ = fft_size // 2 + 1
    s0 = int(F_ ** (1.0 / float(num_layers)))
    k0, k1, cc = s0 * 2 + 1, kernel_size, conv_channels
    plan = [(1, cc, (k0, k1), (s0, stride), (0, k1 // 2))]
    F_ = int((F_ - k0) / s0 + 1)
    for _ in range(num_layers - 2):
        plan.append((cc, cc, (k0, k1), (s0, stride), (0, k1 // 2)))
        F_ = int((F_ - k0) / s0 + 1)
    plan.append((cc, 1, (F_, 1), (1, 1), (0, 0)))
    return plan


class STFTDiscriminator(nn.Module):
    def __init__(self, fft_size: int = 1024, hop_size: int = 256, win_size: int = 1024,
                 num_layers: int = 4, kernel_size: int = 3, stride: int = 1,
                 conv_channels: int = 256):
        super().__init__()
        self.resolution = (fft_size, hop_size, win_size)
        self.convs = nn.ModuleDict({
            str(i): Conv2d(ci, co, k, s, p, spectral_norm=True, init="xavier",
                           init_gain=lrelu_gain())
            for i, (ci, co, k, s, p) in enumerate(
                stft_plan(fft_size, num_layers, kernel_size, stride, conv_channels))})

    def forward(self, mag):
        """mag (B, T', F) -> (B, T'') score; the magnitudes are read as a
        (B, 1, F, T') image."""
        x = mag.transpose(1, 2)[:, None]
        last = len(self.convs) - 1
        for i, conv in enumerate(self.convs.values()):
            x = conv.conv_nchw(x)
            if i < last:
                x = leaky_relu(x, LRELU_SLOPE)
        return x[:, 0, 0]


class MultiSTFTDiscriminator(nn.Module):
    def __init__(self, fft_sizes: Sequence[int] = (128, 256, 512, 1024, 2048),
                 hop_sizes: Sequence[int] = (32, 64, 128, 256, 512),
                 win_sizes: Sequence[int] = (128, 256, 512, 1024, 2048),
                 num_layers: Sequence[int] = (5, 6, 7, 8, 9),
                 kernel_sizes: Sequence[int] = (5, 5, 5, 5, 5),
                 conv_channels: Sequence[int] = (64, 64, 64, 64, 64)):
        super().__init__()
        self.discriminators = nn.ModuleDict({
            str(i): STFTDiscriminator(fft_sizes[i], hop_sizes[i], win_sizes[i], num_layers[i],
                                      kernel_sizes[i], conv_channels=conv_channels[i])
            for i in range(len(fft_sizes))})
        self.resolutions = tuple(d.resolution for d in self.discriminators.values())

    def forward(self, mags) -> List[torch.Tensor]:
        """mags: one (B, T', F_i) magnitude per resolution -> their scores."""
        return [d(m) for d, m in zip(self.discriminators.values(), mags)]


class MultiWaveSTFTDiscriminator(nn.Module):
    """The wave branch (mwd) and the STFT branch (mfd) of mrd.py:236."""

    def __init__(self, num_dwt: int = 5, wave_kernel_size: int = 5, wave_layers: int = 10,
                 wave_conv_channels: int = 64,
                 fft_sizes: Sequence[int] = (128, 256, 512, 1024, 2048),
                 hop_sizes: Sequence[int] = (32, 64, 128, 256, 512),
                 win_sizes: Sequence[int] = (128, 256, 512, 1024, 2048),
                 stft_num_layers: Sequence[int] = (5, 6, 7, 8, 9),
                 stft_kernel_sizes: Sequence[int] = (5, 5, 5, 5, 5),
                 stft_conv_channels: Sequence[int] = (64, 64, 64, 64, 64)):
        super().__init__()
        self.mwd = MultiWaveDiscriminator(num_dwt, wave_kernel_size, wave_layers,
                                          wave_conv_channels)
        self.mfd = MultiSTFTDiscriminator(fft_sizes, hop_sizes, win_sizes, stft_num_layers,
                                          stft_kernel_sizes, stft_conv_channels)
        # (fft_size, hop_size, win_size) of each magnitude `forward` reads
        self.resolutions = self.mfd.resolutions

    def forward(self, x, mags) -> List[torch.Tensor]:
        """x (B, T, 1) wave, mags one (B, T', F_i) per resolution -> the
        wave levels' scores, then the resolutions'."""
        return self.mwd(x) + self.mfd(mags)
