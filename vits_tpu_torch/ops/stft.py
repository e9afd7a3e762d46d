"""STFT and mel DSP (counterpart of vits_tpu/ops/stft.py), channel-last.

Numerics of the reference (mel_processing.py:58-119): periodic Hann window
of win_length zero-padded centred to n_fft, `center=False` spectrograms
pre-padded reflect by (n_fft - hop) / 2, magnitude sqrt(re^2 + im^2 + 1e-6),
a Slaney-normalised mel basis, log-clamp(1e-5) compression.

The STFT is a framed matmul: frames (B, T', n_fft) cut by `unfold`, times
the windowed real-DFT basis (n_fft, 2F) that the JAX package convolves with
(stft.py:35). Torch autograd gives its gradient (the JAX package needs a
custom VJP there only to steer XLA, stft.py:106).
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def hann_window(win_length: int) -> np.ndarray:
    """Periodic Hann, torch.hann_window(win_length)."""
    n = np.arange(win_length, dtype=np.float64)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_length)).astype(np.float32)


@functools.lru_cache(maxsize=8)
def _dft_basis_np(n_fft: int, win_length: int) -> np.ndarray:
    """Windowed real-DFT basis (n_fft, 2F), columns [re bins, im bins], with
    torch.stft's sign: X[k] = sum_n w[n] x[n] exp(-2 pi i k n / N)."""
    window = np.zeros(n_fft, dtype=np.float64)
    lpad = (n_fft - win_length) // 2
    window[lpad:lpad + win_length] = hann_window(win_length).astype(np.float64)
    n = np.arange(n_fft, dtype=np.float64)
    k = np.arange(n_fft // 2 + 1, dtype=np.float64)
    ang = 2.0 * np.pi * np.outer(n, k) / n_fft
    basis = np.concatenate([np.cos(ang), -np.sin(ang)], axis=1)
    return (window[:, None] * basis).astype(np.float32)


@functools.lru_cache(maxsize=8)
def _dft_basis(n_fft: int, win_length: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_dft_basis_np(n_fft, win_length)).to(device)


def stft(x: torch.Tensor, n_fft: int, hop_length: int, win_length: Optional[int] = None,
         center: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, T) float32 -> (re, im), each (B, n_frames, n_fft // 2 + 1).
    center=True reflect-pads n_fft // 2 on both sides."""
    if win_length is None:
        win_length = n_fft
    if center:
        x = F.pad(x[:, None], (n_fft // 2, n_fft // 2), mode="reflect")[:, 0]
    frames = x.unfold(-1, n_fft, hop_length)  # (B, T', n_fft)
    y = torch.matmul(frames, _dft_basis(n_fft, win_length, x.device))
    F_ = n_fft // 2 + 1
    return y[..., :F_], y[..., F_:]


def spectrogram(y: torch.Tensor, n_fft: int, hop_length: int, win_length: int) -> torch.Tensor:
    """Linear magnitude spectrogram (mel_processing.spectrogram_torch): (B, T)
    waveform -> (B, T', F), T' = T // hop for T a multiple of hop."""
    pad = (n_fft - hop_length) // 2
    y = F.pad(y[:, None], (pad, pad), mode="reflect")[:, 0]
    re, im = stft(y, n_fft, hop_length, win_length, center=False)
    return torch.sqrt(re * re + im * im + 1e-6)


def _hz_to_mel_slaney(f):
    f = np.asarray(f, dtype=np.float64)
    f_sp = 200.0 / 3
    mels = f / f_sp
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(f >= min_log_hz,
                    min_log_mel + np.log(np.maximum(f, 1e-10) / min_log_hz) / logstep, mels)


def _mel_to_hz_slaney(m):
    m = np.asarray(m, dtype=np.float64)
    f_sp = 200.0 / 3
    freqs = m * f_sp
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(m >= min_log_mel, min_log_hz * np.exp(logstep * (m - min_log_mel)), freqs)


@functools.lru_cache(maxsize=8)
def mel_filterbank(sampling_rate: int, n_fft: int, n_mels: int, fmin: float = 0.0,
                   fmax: Optional[float] = None) -> np.ndarray:
    """Slaney-scale, Slaney-normalised triangular mel filterbank (F, n_mels),
    librosa.filters.mel(htk=False, norm='slaney') transposed (an own copy of
    vits_tpu/ops/stft.py:261-302)."""
    if fmax is None:
        fmax = sampling_rate / 2.0
    F_ = n_fft // 2 + 1
    fftfreqs = np.linspace(0.0, sampling_rate / 2.0, F_)
    mel_pts = _mel_to_hz_slaney(np.linspace(_hz_to_mel_slaney(fmin), _hz_to_mel_slaney(fmax),
                                             n_mels + 2))
    fdiff = np.diff(mel_pts)
    ramps = mel_pts[:, None] - fftfreqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    enorm = 2.0 / (mel_pts[2:n_mels + 2] - mel_pts[:n_mels])
    weights = weights * enorm[:, None]
    return weights.T.astype(np.float32)


@functools.lru_cache(maxsize=8)
def _mel_basis(sampling_rate: int, n_fft: int, n_mels: int, fmin: float,
               fmax: Optional[float], device: torch.device) -> torch.Tensor:
    return torch.from_numpy(mel_filterbank(sampling_rate, n_fft, n_mels, fmin, fmax)).to(device)


def dynamic_range_compression(x: torch.Tensor, clip_val: float = 1e-5) -> torch.Tensor:
    """log-clamp compression (mel_processing.py:26-32)."""
    return torch.log(torch.clamp(x, min=clip_val))


def spec_to_mel(spec: torch.Tensor, n_fft: int, n_mels: int, sampling_rate: int,
                fmin: float = 0.0, fmax: Optional[float] = None) -> torch.Tensor:
    """(B, T, F) linear magnitudes -> (B, T, n_mels) log-mel."""
    fb = _mel_basis(sampling_rate, n_fft, n_mels, fmin, fmax, spec.device)
    return dynamic_range_compression(torch.matmul(spec, fb))


def mel_spectrogram(y: torch.Tensor, n_fft: int, n_mels: int, sampling_rate: int,
                    hop_length: int, win_length: int, fmin: float = 0.0,
                    fmax: Optional[float] = None) -> torch.Tensor:
    """Waveform (B, T) -> (B, T', n_mels) log-mel (mel_spectrogram_torch)."""
    return spec_to_mel(spectrogram(y, n_fft, hop_length, win_length), n_fft, n_mels,
                       sampling_rate, fmin, fmax)
