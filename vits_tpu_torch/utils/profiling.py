"""Tracing and timing hooks (counterpart of vits_tpu/utils/profiling.py):
`torch.profiler` trace capture around a region, honest wall time of a call
with a device synchronisation and a host copy per call, and a per-step
throughput meter (steps/s and audio-seconds/s)."""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import numpy as np
import torch


@contextlib.contextmanager
def trace(log_dir: Optional[str]):
    """Capture a `torch.profiler` trace of the region (CPU, and CUDA where
    there is a card) if `log_dir` is set: a TensorBoard trace
    (`*.pt.trace.json`, Chrome's trace format) is written into it at the end.
    A no-op otherwise. Yields the profiler, or None."""
    if not log_dir:
        yield None
        return
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir)) as prof:
        yield prof


def _to_host(out):
    """Copy every tensor of `out` (a tensor, or a tuple, list or dict of
    them) to the host, so that the device has finished computing it."""
    if torch.is_tensor(out):
        return out.detach().cpu()
    if isinstance(out, dict):
        return {k: _to_host(v) for k, v in out.items()}
    if isinstance(out, (tuple, list)):
        return type(out)(_to_host(v) for v in out)
    return out


def _call(fn, args):
    out = fn(*args)
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()
    return _to_host(out)


def device_time(fn, *args, iters: int = 5, warmup: int = 1) -> float:
    """Median wall time in seconds of fn(*args), each call ended by
    `torch.cuda.synchronize()` (where CUDA is in use) and a copy of its
    outputs to the host, after `warmup` untimed calls."""
    for _ in range(warmup):
        _call(fn, args)
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        _call(fn, args)
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


class StepMeter:
    """Rolling throughput meter: steps/s and audio-seconds/s."""

    def __init__(self):
        self.reset()

    def reset(self):
        self._t0 = time.perf_counter()
        self._steps = 0
        self._audio_sec = 0.0

    def update(self, audio_sec: float = 0.0, steps: int = 1):
        self._steps += steps
        self._audio_sec += audio_sec

    def rates(self):
        dt = max(time.perf_counter() - self._t0, 1e-9)
        return {"steps_per_s": self._steps / dt,
                "audio_sec_per_s": self._audio_sec / dt,
                "elapsed_s": dt}
