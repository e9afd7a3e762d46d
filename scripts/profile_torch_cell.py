#!/usr/bin/env python3
"""The program's spans and counters over one benchmark cell's traced window.

    python3 scripts/profile_torch_cell.py --workload base-serve-b1 --seed 3000001011 \\
        [--seconds 30] [--out FILE]

Runs the cell's traced run as `python3 benchmark/run.py --workload <cell>
--seed <n> --seconds <s> --trace 1` runs it (the same harness, weights,
traffic and window; the benchmark's own result line is printed as it prints
it), and also reduces the window's trace by the program's "vits:" spans
(`vits_tpu_torch.utils.profiling.charge`) nested in the benchmark's own
"bench:" spans: each program span's device ms a call, idle seconds by the
innermost span (a benchmark span's name where no program span was open), the
device time launched outside the program's spans and the time no launch
call claims (by operation name), and the launch calls seen. In a serving
cell it also takes the difference of the engine's `counts` over the window
and sets it beside the benchmark's own reckoning from the served lengths and
the fused budget's rule (`benchmark/harness/check.py::fused_budget`), with the
fused passes' served frames over their decoded ones and their decoded frames
(whole 64-frame quanta) over their budgets, the share of requests whose head
and flows replayed CUDA graphs (`head_ms.synth` is a replayed head's device
ms, beside the eager `enc_ms.synth`), the host's launch calls, the device
operations and the device ms a request (`graph_captures` in the counts' difference must read 0: no capture
in the window), the float decodes through the decoder's packed body
(`dec_fused_share`, % of requests), its glue kernels' launches, device ms
and achieved GB/s a request (`nn/dec_glue.counter`'s bytes, each input read
and each output written once over the pad, over the kernels' device time:
an upper figure, since the kernels skip the reads past a request's frames),
and the float decoder's launch calls a call (the operations its spans
launch). The decoders' device ms a call is given inclusive of their
upsample stages' spans (`dec_ms.synth`) and by stage (`dec_stage_ms.synth`). The last line of standard output is one JSON
object: "program" (these numbers) and "result" (the benchmark's line). Needs
a CUDA device.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

BENCH_PREFIX = "bench:"
# the hand-written kernels, by a fragment of their names: the calls that
# launch them are read off the trace (K1 and K2 are launched through ctypes)
KERNELS = {"K1": ("rb2_chain_kernel", "rb2_split_kernel"), "K2": ("mas_kernel", "mas_warp_kernel"),
           "glue": ("dg_gate_kernel", "dg_epilogue_kernel")}


def span_ms(charged, names, per):
    """Device ms charged to the spans `names` over the ranges of the spans
    `per`, or None where there are none."""
    n = sum(charged["span_calls"].get(k, 0) for k in per)
    if not n:
        return None
    return 1e3 * sum(charged["span_device_s"].get(k, 0.0) for k in names) / n


DECODERS = ("synth.decoder", "synth.decoder_q8")


def decoder_ms(charged):
    """The decoders' device ms a call inclusive of their upsample stages'
    spans ("<decoder>.stage<i>"; `charge` gives each operation to the
    innermost span alone), comparable with the figures taken before the
    decoders had stage spans, and each stage's; None where no decoder ran."""
    stages = sorted(k for k in charged["span_device_s"]
                    if k.startswith(tuple(d + "." for d in DECODERS)))
    return (span_ms(charged, [*DECODERS, *stages], DECODERS),
            {k: span_ms(charged, [k], DECODERS) for k in stages} or None)


def decoder_launches(charged):
    """Device operations launched in the float decoder's spans (its own and
    its stages'), a call: one launch call each, outside CUDA graphs."""
    ops = charged.get("span_ops", {})
    n = charged["span_calls"].get("synth.decoder", 0)
    if not n:
        return None
    return sum(v for k, v in ops.items()
               if k == "synth.decoder" or k.startswith("synth.decoder.stage")) / n


def outside_counts(rec, hps):
    """The benchmark's reckoning from outside the program: requests, those
    whose served frames fill the fused budget, the budgets, and the other
    requests' frames in whole 64-frame quanta (what the fused pass of the
    benchmark's engine decodes) and as served."""
    from benchmark.harness.check import fused_budget, quantize
    work = [(tokens, frames) for _, tokens, frames, _ in rec["synth_work"]]
    budgets = [fused_budget(t, hps) for t, _ in work]
    fused = [f for (_, f), b in zip(work, budgets) if f < b]
    return {"requests": len(work), "retried": len(work) - len(fused),
            "fused_frames_budget": sum(budgets),
            "fused_frames_decoded": sum(quantize(f, 64) for f in fused),
            "fused_frames_served": sum(fused)}


def fused_shares(counts) -> dict:
    """The fused passes' served frames over their decoded ones, and their
    decoded frames over their budgets, in %."""
    return {"fused_served": 100.0 * counts["fused_frames_served"]
            / max(counts["fused_frames_decoded"], 1),
            "fused_decoded_of_budget": 100.0 * counts["fused_frames_decoded"]
            / max(counts["fused_frames_budget"], 1)}


def per_request(charged, counts) -> dict:
    """A serving window's numbers a request: the CUDA graphs' replay shares
    (every request of a serving cell takes the fused pass first: the head's
    replays over the requests, the flows' over those not served again; 0
    where the engine has no graphs), the launch calls, and the device ms of
    every operation the trace holds (the figure to hold against an engine
    without graphs: lower means the profiler missed graph kernels)."""
    n = max(counts["requests"], 1)
    device_s = (sum(charged["span_device_s"].values()) + charged["unspanned_device_s"]
                + charged["unmatched_device_s"])
    return {"graph_replay_share.head": 100.0 * counts.get("graph_replays_head", 0) / n,
            "graph_replay_share.flow": 100.0 * counts.get("graph_replays_flow", 0)
            / max(counts["requests"] - counts["retried"], 1),
            "launch_calls_per_request": sum(charged["host_launch_calls"].values()) / n,
            "device_ops_per_request": sum(charged["launch_calls"].values()) / n,
            "device_ms_per_request": 1e3 * device_s / n}


def host_launch_calls(events) -> dict:
    """{launch call: count} of the host's launch calls in a capture (a
    `cudaGraphLaunch` once a replay, where `charge`'s "launch_calls" counts
    the operations each kind of call put on the card)."""
    from vits_tpu_torch.utils import profiling
    out = {}
    for ev in events:
        if not profiling.on_device(ev) and profiling.LAUNCH_CALL.match(ev.name()):
            out[ev.name()] = out.get(ev.name(), 0) + 1
    return out


def kernel_launch_calls(events):
    """{kernel: {launch call: count}} for the KERNELS found in a capture,
    matched through the correlation id ("none" where no call was found)."""
    from vits_tpu_torch.utils import profiling
    calls = {ev.correlation_id(): ev.name() for ev in events
             if not profiling.on_device(ev) and profiling.LAUNCH_CALL.match(ev.name())}
    found = {}
    for ev in events:
        for k, frags in KERNELS.items():
            if profiling.on_device(ev) and any(f in ev.name() for f in frags):
                call = calls.get(ev.correlation_id(), "none")
                found.setdefault(k, {})
                found[k][call] = found[k].get(call, 0) + 1
    return found


def kernel_device_s(events):
    """{kernel: device seconds} for the KERNELS found in a capture."""
    from vits_tpu_torch.utils import profiling
    out = {}
    for ev in events:
        for k, frags in KERNELS.items():
            if profiling.on_device(ev) and any(f in ev.name() for f in frags):
                out[k] = out.get(k, 0.0) + ev.duration_ns() / 1e9
    return out


def traced_run(run):
    """Call `run()` (a traced benchmark run printing its result line) with
    the harness's trace reduction, serving call and per-layer reading
    wrapped to keep what the program's spans and counters need; restores
    them after. Returns (run's return value, what was kept)."""
    from benchmark.harness import common, serve, trace
    from vits_tpu_torch.utils import profiling

    seen = {"engine": None, "counts": None, "rec": None, "charged": None}
    saved = (trace.reduce_events, trace.profiled, serve.serve_one, common.per_layer)
    reduce_events, profiled, serve_one, per_layer = saved

    def reduce_and_charge(events, window_s):
        events = list(events)
        seen["charged"] = profiling.charge(events, prefixes=(profiling.SPAN_PREFIX, BENCH_PREFIX))
        seen["charged"]["host_launch_calls"] = host_launch_calls(events)
        seen["kernel_calls"] = kernel_launch_calls(events)
        seen["kernel_s"] = kernel_device_s(events)
        return reduce_events(events, window_s)

    @contextlib.contextmanager
    def profiled_with_counts(traced, record):
        from vits_tpu_torch.nn import dec_glue
        engine = seen["engine"]
        before = dict(engine.counts) if engine is not None else None
        glue = (dec_glue.counter.launches, dec_glue.counter.bytes)
        with profiled(traced, record):
            yield
        seen["glue"] = {"launches": dec_glue.counter.launches - glue[0],
                        "bytes": dec_glue.counter.bytes - glue[1]}
        if before is not None:
            seen["counts"] = {k: engine.counts[k] - v for k, v in before.items()}

    def serve_and_keep(engine, r):
        seen["engine"] = engine
        return serve_one(engine, r)

    def per_layer_and_keep(cell, rec):
        seen["rec"] = rec
        return per_layer(cell, rec)

    trace.reduce_events, trace.profiled = reduce_and_charge, profiled_with_counts
    serve.serve_one, common.per_layer = serve_and_keep, per_layer_and_keep
    try:
        return run(), seen
    finally:
        trace.reduce_events, trace.profiled, serve.serve_one, common.per_layer = saved
        seen["engine"] = None


def report(seen) -> dict:
    """The program's numbers of a traced window (see the module's doc)."""
    c = seen["charged"]
    ours = ("engine.", "synth.")
    program = {k: v for k, v in c["span_device_s"].items() if k.startswith(ours)}
    idle_total = sum(c["idle_s"].values())
    out = {
        "span_calls": c["span_calls"],
        "span_device_ms_per_call": {k: 1e3 * v / c["span_calls"][k] for k, v in program.items()},
        "span_device_s": c["span_device_s"],
        "idle_s": c["idle_s"],
        "busy_s": c["busy_s"],
        "outside_program_spans_device_s": (sum(c["span_device_s"].values())
                                           - sum(program.values()) + c["unspanned_device_s"]),
        "unspanned_device_s": c["unspanned_device_s"],
        "unmatched_device_s": c["unmatched_device_s"],
        "unmatched_ops_s": dict(sorted(c["unmatched_ops"].items(), key=lambda kv: -kv[1])[:10]),
        "launch_calls": c["launch_calls"],
        "kernel_launch_calls": seen.get("kernel_calls"),
        "idle_share_labelled_by_program": idle_total and sum(
            v for k, v in c["idle_s"].items() if k.startswith(ours)) / idle_total,
        "enc_ms.synth": span_ms(c, ["synth.text_encoder", "synth.duration"],
                                ["synth.text_encoder"]),
        "head_ms.synth": span_ms(c, ["synth.head"], ["synth.head"]),
        "flow_ms.synth": span_ms(c, ["synth.flow"], ["synth.flow"]),
    }
    out["dec_ms.synth"], out["dec_stage_ms.synth"] = decoder_ms(c)
    out["decoder_launches_per_call"] = decoder_launches(c)
    glue, glue_s = seen.get("glue") or {}, (seen.get("kernel_s") or {}).get("glue", 0.0)
    out["glue"] = {"launches": glue.get("launches", 0), "device_s": glue_s,
                   "GB_per_s": glue["bytes"] / glue_s / 1e9 if glue_s else None,
                   "share_of_3.35TB_per_s": (100.0 * glue["bytes"] / glue_s / 3.35e12
                                             if glue_s else None)}
    counts, rec = seen["counts"], seen["rec"] or {}
    if counts:
        out["counts"] = counts
        n = max(counts["requests"], 1)
        out["retry_share.serve"] = 100.0 * counts["retried"] / n
        out.update(per_request(c, counts))
        out["dec_fused_share"] = 100.0 * counts.get("dec_fused", 0) / n
        out["glue"]["launches_per_request"] = out["glue"]["launches"] / n
        out["glue"]["device_ms_per_request"] = 1e3 * out["glue"]["device_s"] / n
        shares = fused_shares(counts)
        out["fused_served.serve"] = shares["fused_served"]
        out["fused_decoded_of_budget"] = shares["fused_decoded_of_budget"]
        outside = outside_counts(rec, rec["hps"])
        out["outside_counts"] = outside
        out["outside_shares"] = fused_shares(outside)
    events = rec.get("events_ms") or {}
    for k in ("p1", "p2"):
        if events.get(k):
            out[f"{k}_ms.batch"] = sum(events[k]) / len(events[k])
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--out", default=None, help="also write the JSON object to this file")
    args = ap.parse_args(argv)
    from benchmark import run as bench_run

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc, seen = traced_run(lambda: bench_run.main(
            ["--workload", args.workload, "--seed", str(args.seed),
             "--seconds", str(args.seconds), "--trace", "1"]))
    lines = out.getvalue().strip().splitlines()
    print("\n".join(lines), flush=True)
    if rc != 0 or not lines or seen["charged"] is None:
        print(f"profile_torch_cell: the run exited {rc} without a traced window",
              file=sys.stderr)
        return rc or 1
    line = json.dumps({"program": report(seen), "result": json.loads(lines[-1])})
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
