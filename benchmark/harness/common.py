"""What every cell's run shares: the command line, the environment the
program runs in, the card check, the published peaks, the result line and
the check that nothing of JAX or the JAX package was loaded."""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Dict, List, Optional

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
BENCH = os.path.join(ROOT, "benchmark")

# Published dense peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, without
# sparsity, at the 700 W limit).
PEAK = {"bf16": 989e12, "int8": 1979e12, "tf32": 494.7e12, "fp32": 66.9e12}
HBM_BYTES_PER_S = 3.35e12

# Top-level module names no run may hold once its window has closed.
FORBIDDEN = ("jax", "jaxlib", "flax", "vits_tpu")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="One run of one benchmark cell of vits_tpu_torch.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def load_cell(name: str) -> Dict:
    """The cell `name` of BENCHMARK.json with its configuration file and its
    traffic file (benchmark/traffic/<traffic>.json)."""
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        spec = json.load(f)
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has {sorted(cells)}")
    cell = dict(cells[name])
    configs = {c["name"]: c for c in spec["configs"]}
    with open(os.path.join(ROOT, configs[cell["config"]]["file"])) as f:
        cell["config_file"] = json.load(f)
    with open(os.path.join(BENCH, "traffic", cell["traffic"] + ".json")) as f:
        cell["traffic_file"] = json.load(f)
    cell["end_to_end"] = [m for m in spec["end_to_end"]
                          if name in m.get("workloads", [name])]
    cell["per_layer"] = [m for m in spec["per_layer"] if name in m.get("workloads", [name])]
    return cell


def hparams(config: Dict) -> Dict:
    """The program's config.json from a configuration file: its train, data
    and model groups."""
    return {k: config[k] for k in ("train", "data", "model")}


def prepare_environment():
    """Caches inside the checkout at fixed paths; none of the engine's
    VITS_TPU_* switches inherited; no JAX from transformers-style libraries;
    one thread in the CPU math libraries (the host's cores go to the
    program's launching thread and its data pipeline; set before torch is
    imported)."""
    build = os.path.join(ROOT, "build")
    for k in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[k] = "1"
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(build, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(build, "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    for k in [k for k in os.environ if k.startswith("VITS_TPU_")]:
        del os.environ[k]


def require_cards(n: int):
    """Exit without a result where the machine lacks the cards the cell asks for."""
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < n:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"benchmark: the cell needs {n} CUDA device(s), this machine has {have}",
              file=sys.stderr)
        raise SystemExit(2)


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def device_info(chips: int, peak_bytes: int, dev) -> Dict:
    """The result's device: the card's name, or "cpu" in the CPU tests."""
    import torch
    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": chips, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
            "memory_peak_bytes": int(peak_bytes)}


def percentile(values, p: float) -> float:
    """The p-th percentile of values, linear between order statistics."""
    v = sorted(values)
    if not v:
        return float("nan")
    k = (len(v) - 1) * p / 100.0
    lo = int(k)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (k - lo)


class Clock:
    """Host-clock seconds since the run started (the set-up's origin)."""

    def __init__(self):
        self.t0 = time.perf_counter()

    def __call__(self) -> float:
        return time.perf_counter() - self.t0


def finish(result: Dict, checks: List[Dict]) -> int:
    """Print the numbers compared with their limits as the last lines of
    standard error, then the result line (with them under "checks", last)
    as the last line of standard output. Exits non-zero, printing no result,
    where JAX or the JAX package was loaded."""
    found = forbidden_modules()
    if found:
        print(f"benchmark: the run loaded {found}; the port must not import them",
              file=sys.stderr)
        return 3
    result["correct"] = bool(checks) and all(c["ok"] for c in checks)
    lines = [f"check {c['name']}: {c['value']!r} limit {c['limit']!r} "
             f"({'ok' if c['ok'] else 'FAILED'})" for c in checks]
    print("\n".join(lines), file=sys.stderr, flush=True)
    result["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]} for c in checks}
    print(json.dumps(result), flush=True)
    return 0


def note(text: str):
    """A line of what the run saw, on standard error."""
    print("benchmark: " + text, file=sys.stderr, flush=True)


def check(name: str, value: float, limit: float) -> Dict:
    """A number compared with its limit: it passes at or under the limit."""
    value = float(value)
    return {"name": name, "value": value, "limit": limit,
            "ok": value == value and value <= limit}


def metric(value: float, unit: str) -> Dict:
    return {"value": float(value), "unit": unit}


def per_layer(cell: Dict, run: Dict) -> Dict:
    """The cell's per-layer metrics, each read by benchmark/metrics/<name>.py
    from the traced run's record; a reader that finds nothing returns None
    and the metric is left out."""
    import importlib.util
    out = {}
    for m in cell["per_layer"]:
        path = os.path.join(BENCH, "metrics", m["name"] + ".py")
        spec = importlib.util.spec_from_file_location("bench_metric_" + m["name"].replace(
            ".", "_").replace("-", "_"), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        v: Optional[float] = mod.read(run)
        if v is not None:
            out[m["name"]] = metric(v, m["unit"])
    return out
