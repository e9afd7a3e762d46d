#!/usr/bin/env python3
"""Where a `loop.run` step's time goes on the GPU, for the PyTorch/CUDA port.

    python3 scripts/profile_torch_run.py [--epochs 3] [--workers 8] [--trace] [--out DIR]

Writes chip_smoke.py's `[run]` corpus (96 synthetic utterances of 2-12 s at
the base config's widths) into a temporary directory and trains on it
through `vits_tpu_torch.train.loop.run` as chip_smoke's `[run]` phase does
(full width, the duration discriminator, the configured bf16, batch 32,
spectrograms on the device, compact batches), for --epochs epochs, with
log_interval 1 so that every step reads its metrics back and its wall time
is the time between two log callbacks. No eval and no save but the last.
For each step it prints the batch's shape, the host time inside the step
call (the launches), the wall time and the input stall. With --trace the
last epoch, whose bucket shapes the first epoch has run, is traced with
torch.profiler (the device busy time and idle share of its steps; the
profiler's own host cost inflates them). --workers sets the prefetch
threads (`train.prefetch_workers`). Then the bare step (no data
pipeline, no summaries) is timed on the run's state: at each bucket's shape
three times running, warm, and over the epoch's shapes in turn, as the loop
meets them. With --out, writes the chrome trace there. Prints one JSON
line. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--workers", type=int, default=8, help="prefetch threads")
    ap.add_argument("--trace", action="store_true", help="trace the last epoch")
    ap.add_argument("--out", default=None, help="directory for the chrome trace")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_run: no CUDA device is available", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from torch.profiler import ProfilerActivity, profile
    from scripts.profile_torch_train import _busy_us
    from vits_tpu_torch.config import default_config_path, get_hparams_from_file
    from vits_tpu_torch.train import loop
    from vits_tpu_torch.train.data import (DEFAULT_BOUNDARIES, BucketSampler, Prefetcher,
                                           TextAudioSpeakerDataset)

    dev = torch.device("cuda", 0)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    hps = get_hparams_from_file(default_config_path("base"))
    with tempfile.TemporaryDirectory() as workdir:
        lines = cs.write_corpus(workdir, hps, cs.RUN_UTTS, cs.RUN_SECONDS, cs.SEED)
        scp = os.path.join(workdir, "train.scp")
        with open(scp, "w") as f:
            f.write("\n".join(lines))
        hps.data.training_files = scp
        hps.data.validation_files = os.path.join(workdir, "none.scp")
        dataset = TextAudioSpeakerDataset(scp, hps, load_spec=False)
        sampler = BucketSampler(dataset.lengths, hps.train.batch_size, DEFAULT_BOUNDARIES)
        per_epoch = len(sampler)
        total = per_epoch * args.epochs
        hps.train.log_interval, hps.train.eval_interval = 1, 10 ** 9
        hps.train.prefetch_workers = args.workers
        hps.model_dir = os.path.join(workdir, "logs", "profile")
        os.makedirs(hps.model_dir)
        hps.use_dur_dis = True

        steps = []      # (x shape, frames, host ms in the step call)
        seen = []       # (time, step, metrics)
        summaries = []  # host ms in log_train_summaries
        real = {k: getattr(loop, k) for k in ("make_train_step", "log_train_summaries")}
        real_make, real_summaries = real["make_train_step"], real["log_train_summaries"]

        def make(cfg):
            fn = real_make(cfg)

            def step(state, batch, noise, *a):
                t0 = time.perf_counter()
                out = fn(state, batch, noise, *a)
                steps.append((tuple(batch["x"].shape), noise["mas"].shape[1],
                              (time.perf_counter() - t0) * 1e3))
                return out
            return step

        def summarize(*a, **k):
            t0 = time.perf_counter()
            out = real_summaries(*a, **k)
            summaries.append((time.perf_counter() - t0) * 1e3)
            return out

        prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        window = {}

        def log_cb(s, m):
            seen.append((time.perf_counter(), s, m))
            if not args.trace:
                return
            if s == total - per_epoch:
                window["start"] = time.perf_counter()
                prof.start()
            elif s == total:
                torch.cuda.synchronize()
                prof.stop()
                window["end"] = time.perf_counter()

        loop.make_train_step, loop.log_train_summaries = make, summarize
        try:
            state, n = loop.run(hps, max_steps=total, device=dev, log_cb=log_cb)
        finally:
            for k, v in real.items():
                setattr(loop, k, v)
        if n != total:
            raise RuntimeError(f"the run took {n} steps of {total}")
        events = sorted(f for f in os.listdir(hps.model_dir) if f.startswith("events"))

        traced_ms = busy_ms = kernel_ms = float("nan")
        kernels = []
        if args.trace:
            kernels = [e for e in prof.events()
                       if e.device_type == torch.autograd.DeviceType.CUDA
                       and not e.is_user_annotation]
            if not kernels:
                raise RuntimeError("the profiler recorded no device activity")
            traced_ms = (window["end"] - window["start"]) * 1e3
            busy_ms = _busy_us(kernels) / 1e3
            kernel_ms = sum(e.time_range.end - e.time_range.start for e in kernels) / 1e3
            if args.out:
                os.makedirs(args.out, exist_ok=True)
                prof.export_chrome_trace(os.path.join(args.out, "trace_run_epoch.json"))

        # the bare step at each bucket's shape, warm, on the run's state
        bare, cycle = {}, []
        step_fn = loop.build_step(hps)
        gen = torch.Generator(device=dev).manual_seed(cs.SEED)
        batches = []
        for b in Prefetcher(dataset, sampler, compact=True).epoch(1):
            b.pop("wav_lengths")
            batches.append({k: v.to(dev) for k, v in b.items()})

        def bare_step(b):
            nonlocal state
            frames = (b["wav"].shape[1] - hps.data.filter_length) // hps.data.hop_length
            noise = state["gen"].draw_noise(b["x"].shape[0], b["x"].shape[1], frames, gen)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, _ = step_fn(state, b, noise, 1e-4, 1e-4, 1e-4, 1e-4)
            torch.cuda.synchronize()
            return (tuple(b["x"].shape), frames), (time.perf_counter() - t0) * 1e3

        for b in batches:
            times = [bare_step(b) for _ in range(4)][1:]
            bare[times[0][0]] = float(np.median([t for _, t in times]))
        for _ in range(2):  # the epoch's shapes in turn, as the loop meets them
            cycle += [bare_step(b)[1] for b in batches]

    card = cs.card_line()
    rows = []
    for i, ((shape, frames, host_ms), (t, s, m)) in enumerate(zip(steps, seen)):
        wall = (t - seen[i - 1][0]) * 1e3 if i else float("nan")
        rows.append({"step": s, "epoch": 1 + (s - 1) // per_epoch, "x": shape, "frames": frames,
                     "host_ms": host_ms, "wall_ms": wall, "bare_ms": bare.get((shape, frames)),
                     "stall_pct": m["input_stall_pct"], "audio_s_per_s": m["audio_sec_per_s"]})
        print(f"[run-profile] step {s:3d} epoch {rows[-1]['epoch']} x {shape} frames {frames:4d}: "
              f"host in step {host_ms:7.1f} ms, wall {wall:7.1f} ms, bare {rows[-1]['bare_ms']:.1f}"
              f" ms, input stall {m['input_stall_pct']:5.2f}%, "
              f"{m['audio_sec_per_s']:.1f} audio-s/s")
    last = [r for r in rows if r["epoch"] == args.epochs]
    ratio = [r["wall_ms"] / r["bare_ms"] for r in last]
    summary = {
        "epochs": args.epochs, "steps_per_epoch": per_epoch,
        "last_epoch_wall_ms_median": float(np.median([r["wall_ms"] for r in last])),
        "last_epoch_bare_ms_median": float(np.median([r["bare_ms"] for r in last])),
        "last_epoch_wall_over_bare_median": float(np.median(ratio)),
        "last_epoch_host_in_step_ms_median": float(np.median([r["host_ms"] for r in last])),
        "last_epoch_stall_pct_median": float(np.median([r["stall_pct"] for r in last])),
        "bare_in_turn_ms_median": float(np.median(cycle)),
        "workers": args.workers, "event_files": events,
        "summaries_ms_median": float(np.median(summaries)),
        "traced_last_epoch_ms": traced_ms, "device_busy_ms": busy_ms, "kernel_ms": kernel_ms,
        "device_idle_share": 1 - busy_ms / traced_ms, "kernels": len(kernels),
    }
    print(f"[run-profile] bare step over the epoch's shapes in turn: median "
          f"{summary['bare_in_turn_ms_median']:.1f} ms ({[round(t, 1) for t in cycle]})")
    print(f"[run-profile] last epoch ({per_epoch} steps, shapes warm): wall per step median "
          f"{summary['last_epoch_wall_ms_median']:.1f} ms against the bare step's "
          f"{summary['last_epoch_bare_ms_median']:.1f} (median ratio "
          f"{summary['last_epoch_wall_over_bare_median']:.2f}); host in the step call "
          f"{summary['last_epoch_host_in_step_ms_median']:.1f} ms; summaries "
          f"{summary['summaries_ms_median']:.1f} ms a log step; traced: {traced_ms:.1f} ms, "
          f"device busy {busy_ms:.1f} ms (idle share {summary['device_idle_share']:.3f}), "
          f"{len(kernels)} kernels, kernel time {kernel_ms:.1f} ms; workers {args.workers}, "
          f"summaries to {events}; {card}")
    print(json.dumps({"run_profile": summary, "rows": rows, "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
