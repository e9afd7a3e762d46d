"""Monotonic alignment search in plain PyTorch: a frozen copy of the port's
`ops/mas.py` plain version (a torch twin of the JAX package's
`maximum_path_scan`), without the CUDA kernel."""

from __future__ import annotations

from typing import Tuple

import torch

NEG_INF = -1e9


def mask_to_lengths(mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """attn mask (B, T_y, T_x) -> (t_ys, t_xs) int32, counted in f32 (exact
    to 2^24) whatever the mask's dtype. The JAX package sums in the mask's
    dtype, so a bf16 mask rounds a length past 256 to 8 significant bits
    (vits_tpu/ops/mas.py:37); the port does not copy that."""
    t_ys = mask[:, :, 0].float().sum(dim=1).to(torch.int32)
    t_xs = mask[:, 0, :].float().sum(dim=1).to(torch.int32)
    return t_ys, t_xs


def maximum_path_plain(neg_cent: torch.Tensor, t_ys: torch.Tensor,
                       t_xs: torch.Tensor) -> torch.Tensor:
    """neg_cent (B, T_y, T_x); t_ys/t_xs (B,) int -> 0/1 path in
    neg_cent.dtype. Vectorised over the batch, Python loops over T_y for the
    forward DP and the backtrace, every value in f32."""
    out_dtype = neg_cent.dtype
    neg = neg_cent.float()
    B, T_y, T_x = neg.shape
    dev = neg.device
    t_ys, t_xs = t_ys.long(), t_xs.long()
    xs = torch.arange(T_x, device=dev)
    neg_row = torch.full((B, T_x), NEG_INF, dtype=torch.float32, device=dev)
    prev = neg_row
    values = []
    for y in range(T_y):
        first = torch.full((B, 1), 0.0 if y == 0 else NEG_INF, dtype=torch.float32, device=dev)
        best = torch.maximum(prev, torch.cat([first, prev[:, :-1]], dim=1))
        feas = ((xs[None, :] <= y) & (xs[None, :] >= (t_xs - t_ys + y)[:, None])
                & (xs[None, :] < t_xs[:, None]) & (y < t_ys)[:, None])
        prev = torch.where(feas, neg[:, y] + best, neg_row)
        values.append(prev)

    path = torch.zeros(B, T_y, T_x, dtype=out_dtype, device=dev)
    idx = (t_xs - 1).clamp(min=0)
    for y in range(T_y - 1, -1, -1):
        active = y < t_ys
        path[:, y] = ((xs[None, :] == idx[:, None]) & active[:, None]).to(out_dtype)
        if y == 0:
            break
        val_prev = values[y - 1]
        v_here = val_prev.gather(1, idx[:, None])[:, 0]
        v_left = val_prev.gather(1, (idx - 1).clamp(min=0)[:, None])[:, 0]
        move = active & (idx != 0) & ((idx == y) | (v_here < v_left))
        idx = idx - move.long()
    return path


def maximum_path(neg_cent: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """neg_cent (B, T_y, T_x), mask (B, T_y, T_x) 0/1 -> the 0/1 path in
    neg_cent's dtype, by the plain search on any device."""
    t_ys, t_xs = mask_to_lengths(mask)
    return maximum_path_plain(neg_cent * mask, t_ys, t_xs)


def mas_bytes(t_ys: torch.Tensor, t_xs: torch.Tensor, T_y: int, T_x: int) -> int:
    """Bytes the search must move for these lengths: one f32 read of the
    t_y x t_x cells of neg_cent it depends on and one f32 write of the whole
    path (B, T_y, T_x); the lengths themselves are negligible."""
    B = int(t_ys.shape[0])
    return 4 * int((t_ys.long() * t_xs.long()).sum()) + 4 * B * T_y * T_x
