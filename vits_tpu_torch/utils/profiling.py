"""Tracing hooks (counterpart of vits_tpu/utils/profiling.py): the program's
spans (`span`), a `torch.profiler` capture of a region (`trace`), and the
reduction of a capture to device time and idle gaps by span (`charge`).

Spans are `torch.profiler.record_function` ranges named "vits:<layer>",
opened at the layer boundaries of the synthesis path (the engine's request,
its host preparation, read backs and retry; the text encoder, the duration
predictor, the alignment, the flows, the decoders and each of their upsample
stages). They exist only while a profiler records, so they land in the same
trace, on the same host clock, as the CUDA kernels, copies and launch calls;
otherwise `span` returns one shared no-op context and costs a flag test."""

from __future__ import annotations

import contextlib
import os
import re
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import torch

SPAN_PREFIX = "vits:"
_NOOP = contextlib.nullcontext()

# the CUDA API calls that put work on a stream (cudaLaunchKernel,
# cuLaunchKernel, cudaLaunchKernelExC, cudaMemcpyAsync, cudaMemsetAsync, ...)
LAUNCH_CALL = re.compile(r"^cu(da)?(Launch|Memcpy|Memset|GraphLaunch)")


def span(name: str, args: Optional[str] = None):
    """The range "vits:<name>" while a profiler records (`args`, a string,
    passed to `record_function` as its args), the shared no-op context
    otherwise."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(SPAN_PREFIX + name, args)
    return _NOOP


@contextlib.contextmanager
def trace(log_dir: Optional[str]):
    """Capture a `torch.profiler` trace of the region (CPU, and CUDA where
    there is a card) if `log_dir` is set: a TensorBoard trace
    (`*.pt.trace.json`, Chrome's trace format, with the program's "vits:"
    spans on the host's rows) is written into it at the end. A no-op
    otherwise. Yields the profiler, or None."""
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


def _ns(ev) -> Tuple[int, int]:
    """(start, end) of a kineto event in nanoseconds."""
    start = ev.start_ns()
    return start, start + ev.duration_ns()


def on_device(ev) -> bool:
    """Whether a kineto event lies on a CUDA device's timeline."""
    return str(ev.device_type()).endswith("CUDA")


def _innermost(spans: List[Tuple[int, int, str]], times: Sequence[int]) -> List[Optional[Tuple]]:
    """For each of the sorted `times`, the innermost of `spans` ((start,
    end, name), nested as one thread opens them) open at it, as (start,
    name), or None."""
    spans = sorted(spans, key=lambda s: (s[0], -s[1]))
    out, stack, i = [], [], 0
    for t in times:
        while i < len(spans) and spans[i][0] <= t:
            while stack and stack[-1][1] < spans[i][0]:
                stack.pop()
            stack.append(spans[i])
            i += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out.append((stack[-1][0], stack[-1][2]) if stack else None)
    return out


def _label(per_thread: Dict[int, List], times: Sequence[int]) -> List[Optional[str]]:
    """The name of the innermost span open at each of the sorted `times` on
    any thread: of the threads' innermost spans, the one opened last."""
    best: List[Optional[Tuple]] = [None] * len(times)
    for spans in per_thread.values():
        for k, hit in enumerate(_innermost(spans, times)):
            if hit is not None and (best[k] is None or hit[0] >= best[k][0]):
                best[k] = hit
    return [b[1] if b else None for b in best]


def charge(events: Iterable, prefixes: Sequence[str] = (SPAN_PREFIX,)) -> Dict:
    """Device time and idle gaps of a capture (`prof.profiler.kineto_results
    .events()`), charged to spans: the host ranges whose names begin with
    one of `prefixes`, named without it.

    Each device operation (kernel, copy, set) is charged to the innermost
    span open on the host when its launch call (a CUDA API call:
    cudaLaunchKernel, cuLaunchKernel, cudaMemcpyAsync, ...) began; the
    call and the operation are matched by the correlation id kineto gives
    both. Each idle gap of the device (between the union of its operations'
    intervals) is labelled by the innermost span open on the host when it
    began. Spans nest within a thread; across threads the one opened last is
    the innermost (the autograd engine launches a backward pass's kernels
    from a thread of its own while the caller's thread waits in its span).
    A host range's twin on the device's timeline (a user annotation, under
    the range's own name) is not an operation.

    Returns "span_calls" {name: ranges}, "span_device_s" {name: seconds},
    "span_ops" {name: device operations charged}, "unspanned_device_s"
    (launched outside every span), "unmatched_device_s" and "unmatched_ops"
    {op name: seconds} (no launch call found), "launch_calls" {call name:
    count}, "busy_s", "idle_s" {label: seconds} ("outside spans" where none
    was open)."""
    spans: Dict[int, List[Tuple[int, int, str]]] = {}
    calls: Dict[str, int] = {}
    launches: Dict[int, Tuple[int, str]] = {}
    host_names, device = set(), []
    for ev in events:
        name = ev.name()
        if on_device(ev):
            device.append(ev)
            continue
        host_names.add(name)
        start, end = _ns(ev)
        tid = ev.start_thread_id()
        for p in prefixes:
            if name.startswith(p):
                short = name[len(p):]
                spans.setdefault(tid, []).append((start, end, short))
                calls[short] = calls.get(short, 0) + 1
                break
        else:
            if LAUNCH_CALL.match(name) and ev.correlation_id() > 0:
                launches[ev.correlation_id()] = (start, name)
    ops = [ev for ev in device if ev.name() not in host_names]

    timed: List[Tuple[int, int]] = []
    unmatched: Dict[str, float] = {}
    launch_calls: Dict[str, int] = {}
    for k, ev in enumerate(ops):
        hit = launches.get(ev.correlation_id())
        if hit is None:
            unmatched[ev.name()] = unmatched.get(ev.name(), 0.0) + ev.duration_ns() / 1e9
            continue
        launch_calls[hit[1]] = launch_calls.get(hit[1], 0) + 1
        timed.append((hit[0], k))
    timed.sort()
    span_s: Dict[str, float] = {}
    span_ops: Dict[str, int] = {}
    unspanned = 0.0
    for (_, k), lab in zip(timed, _label(spans, [t for t, _ in timed])):
        d = ops[k].duration_ns() / 1e9
        if lab is None:
            unspanned += d
        else:
            span_s[lab] = span_s.get(lab, 0.0) + d
            span_ops[lab] = span_ops.get(lab, 0) + 1

    intervals = sorted(_ns(ev) for ev in ops)
    busy, gaps = 0, []
    cur_s = cur_e = None
    for s, e in intervals:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
                gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    idle: Dict[str, float] = {}
    for (a, b), lab in zip(gaps, _label(spans, [a for a, _ in gaps])):
        key = lab or "outside spans"
        idle[key] = idle.get(key, 0.0) + (b - a) / 1e9
    return {"span_calls": calls, "span_device_s": span_s, "span_ops": span_ops,
            "unspanned_device_s": unspanned,
            "unmatched_device_s": sum(unmatched.values()), "unmatched_ops": unmatched,
            "launch_calls": launch_calls, "busy_s": busy / 1e9, "idle_s": idle}
