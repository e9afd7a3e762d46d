"""Mask and path primitives (counterpart of vits_tpu/ops/seq.py:18-52 and
its sinusoidal table)."""

from __future__ import annotations

import math

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


def gen_sin_table(max_len: int, d_model: int) -> np.ndarray:
    """Sinusoidal positional table (1, max_len, d_model), interleaved sin/cos."""
    position = np.arange(max_len, dtype=np.float32)[:, None]
    div_term = np.exp(np.arange(0, d_model, 2, dtype=np.float32)
                      * -(math.log(10000.0) / d_model))
    pe = np.zeros((max_len, d_model), dtype=np.float32)
    pe[:, 0::2] = np.sin(position * div_term)
    pe[:, 1::2] = np.cos(position * div_term)
    return pe[None]
