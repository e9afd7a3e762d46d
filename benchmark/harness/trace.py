"""The traced run's record: torch.profiler over the measured window, reduced
to device intervals, busy seconds, kernel time by name, and idle gaps
labelled by the benchmark's span the host was in when the device went idle.

Spans are `torch.profiler.record_function("bench:<name>")` ranges the
drivers open around their calls into the program's layers; they land in the
same trace, on the host's clock, as the kernels."""

from __future__ import annotations

import bisect
import contextlib
from typing import Dict, List, Optional, Tuple

SPAN_PREFIX = "bench:"


def span(name: str, traced: bool):
    """A labelled host range in the traced run; nothing otherwise."""
    if not traced:
        return contextlib.nullcontext()
    import torch
    return torch.profiler.record_function(SPAN_PREFIX + name)


@contextlib.contextmanager
def profiled(traced: bool, record: Dict):
    """Profile the block when traced, and reduce the trace into `record`:
    "kernels" [(name, start_us, dur_us)], "busy_s", "window_s",
    "breakdown"."""
    if not traced:
        yield
        return
    import time
    import torch
    from torch.profiler import ProfilerActivity, profile
    cuda = torch.cuda.is_available()
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    prof = profile(activities=[ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else []))
    prof.__enter__()
    sync()
    t0 = time.perf_counter()
    try:
        yield
        sync()
        window = time.perf_counter() - t0
    finally:
        prof.__exit__(None, None, None)
    record.update(reduce_events(prof.profiler.kineto_results.events(), window))


def _device_event(ev) -> bool:
    return str(ev.device_type()).endswith("CUDA")


def _ns(ev) -> Tuple[float, float]:
    """(start, duration) of a kineto event in nanoseconds."""
    if hasattr(ev, "start_ns"):
        return float(ev.start_ns()), float(ev.duration_ns())
    return ev.start_us() * 1e3, ev.duration_us() * 1e3


def reduce_events(events, window_s: float) -> Dict:
    """Device operations (kernels, copies, sets) and the benchmark's spans
    from the profiler's events. A host range (`record_function`) also
    appears on the device's timeline under its own name; such ranges are
    not operations and are left out."""
    kernels: List[Tuple[str, float, float]] = []
    spans: List[Tuple[float, float, str]] = []
    host_names = set()
    device = []
    for ev in events:
        name = ev.name()
        start, dur = _ns(ev)
        if _device_event(ev):
            device.append((name, start / 1e3, dur / 1e3))
        else:
            host_names.add(name)
            if name.startswith(SPAN_PREFIX):
                spans.append((start / 1e3, (start + dur) / 1e3, name[len(SPAN_PREFIX):]))
    kernels = [k for k in device if k[0] not in host_names]
    kernels.sort(key=lambda k: k[1])
    busy_us, gaps = 0.0, []
    cur_s = cur_e = None
    for _, s, d in kernels:
        e = s + d
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy_us += cur_e - cur_s
                gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy_us += cur_e - cur_s
    by_name: Dict[str, float] = {}
    for name, _, d in kernels:
        by_name[name] = by_name.get(name, 0.0) + d / 1e6
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {"kernels": kernels, "busy_s": busy_us / 1e6, "window_s": window_s,
            "kernel_s": by_name,
            "breakdown": {"device_ops": [[n, s] for n, s in top],
                          "idle_gaps": label_gaps(gaps, spans)}}


def label_gaps(gaps, spans) -> List[List]:
    """Idle seconds summed by the innermost benchmark span open on the host
    when each gap began ("outside spans" else), the ten largest sums."""
    spans = sorted(spans)
    starts = [s for s, _, _ in spans]
    by_label: Dict[str, float] = {}
    for a, b in gaps:
        label: Optional[str] = None
        i = bisect.bisect_right(starts, a)
        best = None
        for s, e, name in spans[max(0, i - 64):i]:
            if s <= a <= e and (best is None or s >= best):
                best, label = s, name
        key = label or "outside spans"
        by_label[key] = by_label.get(key, 0.0) + (b - a) / 1e6
    return [[k, v] for k, v in sorted(by_label.items(), key=lambda kv: -kv[1])[:10]]


def contains_seconds(record: Dict, words) -> float:
    """Device seconds of the kernels whose names contain one of `words`."""
    return sum(s for n, s in record.get("kernel_s", {}).items()
               if any(w in n for w in words))
