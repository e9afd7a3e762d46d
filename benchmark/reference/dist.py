"""The reference's stand-in for the port's `parallel/dist.py`. In one
process (group None) every collective is the identity. A `ThreadGroup`
emulates W data-parallel ranks as W threads of one process, each with its
own model replica: a collective waits for every rank's thread, and each
thread then sums the ranks' tensors in rank order, so every replica gets
the same sum, as an all-reduce gives every rank."""

from __future__ import annotations

import threading
from typing import List

import torch


class ThreadGroup:
    """W ranks as threads; each thread sets its rank with `enter(rank)`."""

    def __init__(self, world: int):
        self.world = world
        self._barrier = threading.Barrier(world)
        self._slots: List = [None] * world
        self._local = threading.local()

    def enter(self, rank: int):
        self._local.rank = rank

    @property
    def rank(self) -> int:
        return self._local.rank

    def all_reduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        self._slots[self.rank] = t
        self._barrier.wait()
        total = self._slots[0].to(t.device).clone()
        for other in self._slots[1:]:
            total += other.to(t.device)
        self._barrier.wait()
        return total


def world_size(group) -> int:
    return 1 if group is None else group.world


def allreduce_grads(params, group) -> None:
    """Sum every parameter's gradient over the ranks (a missing one counts
    as zero), one flat buffer per dtype."""
    if world_size(group) == 1:
        return
    params = list(params)
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    by_dtype = {}
    for p in params:
        by_dtype.setdefault(p.grad.dtype, []).append(p.grad)
    for grads in by_dtype.values():
        flat = group.all_reduce_sum(torch.cat([g.reshape(-1) for g in grads]))
        with torch.no_grad():
            for g, part in zip(grads, flat.split([g.numel() for g in grads])):
                g.copy_(part.view_as(g))


def global_count(t: torch.Tensor, group) -> torch.Tensor:
    if world_size(group) == 1:
        return t
    return group.all_reduce_sum(t.detach().clone())


def global_std(x: torch.Tensor, group) -> torch.Tensor:
    """The population std over every rank's cells, its moments summed in
    float64."""
    if world_size(group) == 1:
        return torch.std(x, correction=0)
    xd = x.detach().double()
    s = group.all_reduce_sum(torch.stack([
        xd.sum(), torch.square(xd).sum(),
        torch.tensor(float(x.numel()), dtype=torch.float64, device=x.device)]))
    mean = s[0] / s[2]
    return torch.sqrt(torch.clamp(s[1] / s[2] - mean * mean, min=0.0)).to(x.dtype)
