"""Mask, path and slicing primitives (counterpart of vits_tpu/ops/seq.py):
masks, alignment paths, training-window slices, the Gaussian KL, the
sinusoidal table and the gradient norm."""

from __future__ import annotations

import math
from typing import Iterable, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def sequence_mask(lengths: torch.Tensor, max_length: int) -> torch.Tensor:
    """(B,) int lengths -> (B, max_length) bool mask."""
    pos = torch.arange(max_length, dtype=lengths.dtype, device=lengths.device)
    return pos[None, :] < lengths[:, None]


def _path_from_cumsum(cum: torch.Tensor, t_y: int, dtype) -> torch.Tensor:
    pos = torch.arange(t_y, dtype=cum.dtype, device=cum.device)
    path = (pos[None, :, None] < cum[:, None, :]).to(dtype)  # (B, T_y, T_x)
    return path - F.pad(path, (1, 0))[:, :, :-1]


def generate_path(duration: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Durations (B, T_x) -> hard monotonic path (B, T_y, T_x), times `mask`
    (B, T_y, T_x)."""
    path = _path_from_cumsum(torch.cumsum(duration, dim=-1), mask.shape[1], mask.dtype)
    return path * mask


def infer_path(duration: torch.Tensor, t_y: int) -> torch.Tensor:
    """Maskless path for two-phase inference: (B, T_x) -> (B, t_y, T_x)."""
    return _path_from_cumsum(torch.cumsum(duration, dim=-1), t_y, duration.dtype)


def slice_segments(x: torch.Tensor, ids_str: torch.Tensor, segment_size: int) -> torch.Tensor:
    """Fixed-size time windows per batch row: x (B, T, ...) and start frames
    (B,) -> (B, segment_size, ...). As `lax.dynamic_slice` in the JAX
    package, a negative start counts from the end and every start is then
    clamped into [0, T - segment_size]."""
    T = x.shape[1]
    start = ids_str.long()
    start = torch.where(start < 0, start + T, start).clamp(0, T - segment_size)
    idx = start[:, None] + torch.arange(segment_size, device=x.device)[None, :]
    return x[torch.arange(x.shape[0], device=x.device)[:, None], idx]


def slice_segments_1d(x: torch.Tensor, ids_str: torch.Tensor, segment_size: int) -> torch.Tensor:
    """x (B, T) -> (B, segment_size), starts clamped like `slice_segments`."""
    return slice_segments(x, ids_str, segment_size)


def rand_slice_segments(x: torch.Tensor, x_lengths: torch.Tensor, segment_size: int,
                        u: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Random training windows (vits_tpu/ops/seq.py:74-84) with the uniforms
    u (B,) in [0, 1) given: ids = max(int(u * (len - segment_size + 1)), 0).
    Returns (sliced (B, segment_size, C), ids_str (B,) int32)."""
    ids_str = (u * (x_lengths - segment_size + 1)).to(torch.int32).clamp(min=0)
    return slice_segments(x, ids_str, segment_size), ids_str


def kl_divergence(m_p, logs_p, m_q, logs_q):
    """KL(P || Q) between diagonal Gaussians (vits_tpu/ops/seq.py:94)."""
    kl = (logs_q - logs_p) - 0.5
    return kl + 0.5 * (torch.exp(2.0 * logs_p) + torch.square(m_p - m_q)) * torch.exp(-2.0 * logs_q)


@torch.no_grad()
def clip_grad_value(params: Iterable[torch.Tensor]) -> torch.Tensor:
    """The global 2-norm of the gradients of `params`, as the training step
    calls the reference's clip_grad_value_(params, None)
    (vits_tpu/ops/seq.py:115): the norm is reported and nothing is clipped.
    Returns a 0-d float32 tensor; parameters without a gradient count as
    zero."""
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return torch.zeros(())
    return torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in grads))


def gen_sin_table(max_len: int, d_model: int) -> np.ndarray:
    """Sinusoidal positional table (1, max_len, d_model), interleaved sin/cos."""
    position = np.arange(max_len, dtype=np.float32)[:, None]
    div_term = np.exp(np.arange(0, d_model, 2, dtype=np.float32)
                      * -(math.log(10000.0) / d_model))
    pe = np.zeros((max_len, d_model), dtype=np.float32)
    pe[:, 0::2] = np.sin(position * div_term)
    pe[:, 1::2] = np.cos(position * div_term)
    return pe[None]
