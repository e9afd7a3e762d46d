"""The benchmark of vits_tpu_torch: one run of one cell.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell's entry in BENCHMARK.json names its configuration file and its
traffic file (benchmark/traffic/<traffic>.json); the traffic file names the
driver (benchmark/harness/<driver>.py) that runs it. The last line of
standard output is the result: with --trace 0 the cell's end-to-end
metrics, with --trace 1 its per-layer metrics read by
benchmark/metrics/<name>.py from the traced window."""

from __future__ import annotations

import os
import sys
import time

T0 = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    import importlib

    from benchmark.harness import common
    args = common.parse_args(argv)
    cell = common.load_cell(args.workload)
    common.prepare_environment()
    common.require_cards(cell["chips"])
    import torch
    clock = common.Clock()
    clock.t0 = T0
    driver = importlib.import_module("benchmark.harness." + cell["traffic_file"]["driver"])
    result, checks = driver.run(cell, args, clock, torch.device("cuda"))
    return common.finish(result, checks)


if __name__ == "__main__":
    sys.exit(main())
