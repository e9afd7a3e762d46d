#!/usr/bin/env python3
"""Which phase of K2's warp form, the MAS kernel, its time goes to, on one
GPU.

    python3 scripts/probe_k2_phases.py

Builds variants of vits_tpu_torch/csrc/mas.cu with one phase cut out - "no
fill" (warps 1-3 write no zeros), "no walk" (no backtrace), "no copies"
(neg is not copied into the ring), "no ballot" (each lane keeps its own bit
instead of a warp vote), "no shuffle" (a lane's left neighbour is its own last column),
"no DP" (no row is computed) - and two with all but one phase cut, "DP
alone" and "walk alone", whose times at (1, 1000, 1) are the dependent
chains' floors per row. Times each at the warp-form shapes of chip_smoke.py
(device time from a CUDA graph, chip_smoke.graph_ms) beside the unmodified
kernel, then prints the card and its SM clock. The variants compute wrong
paths; they only say what each phase costs. Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

CUTS = {
    "no fill": ("if (c0 < n_path) zero_fill(", "if (c0 > n_path) zero_fill("),
    "no walk": ("for (int y0 = t_y - 1; y0 >= 0; y0 -= 32) {",
                "for (int y0 = t_y - 1; y0 >= 0 && T_x < 0; y0 -= 32) {"),
    "no copies": ("      copy_rows(ring", "      if (T_x < 0) copy_rows(ring"),
    "no ballot": ("__ballot_sync(kFull, d == 0 || here < left)",
                  "((d == 0 || here < left) ? 1u : 0u)"),
    "no shuffle": ("float left = __shfl_up_sync(kFull, v[R - 1], 1);", "float left = v[R - 1];"),
    "no DP": ("for (int k = 0; k < n; ++k) {\n        const int y = y0 + k;",
              "for (int k = 0; k < 0; ++k) {\n        const int y = y0 + k;"),
}


# all but one phase cut: what that phase takes alone, the floor of the
# dependent chain it runs
ALONE = {"DP alone": ("no copies", "no walk", "no fill"),
         "walk alone": ("no copies", "no DP", "no fill")}


def variants(src: str) -> dict:
    for old, _ in CUTS.values():
        if src.count(old) != 1:
            raise RuntimeError(f"the kernel source no longer has one {old!r}")
    out = {"kernel": src}
    out.update({name: src.replace(*cut) for name, cut in CUTS.items()})
    for name, cuts in ALONE.items():
        text = src
        for cut in cuts:
            text = text.replace(*CUTS[cut])
        out[name] = text
    return out


def build(out_dir: str, name: str, text: str) -> subprocess.Popen:
    from vits_tpu_torch.utils import cuda_build
    stem = name.replace(" ", "_")
    path = os.path.join(out_dir, f"mas_{stem}.cu")
    with open(path, "w") as f:
        f.write(text)
    return subprocess.Popen([cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, "-o",
                             os.path.join(out_dir, f"lib_{stem}.so"), path],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_k2_phases: no CUDA device is available", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from vits_tpu_torch.ops import mas
    from vits_tpu_torch.utils import cuda_build

    out_dir = os.path.join(os.path.dirname(cuda_build.BUILD_DIR), "k2_probe")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(cuda_build.CSRC, mas.SOURCE)) as f:
        src = f.read()
    procs = {name: build(out_dir, name, text) for name, text in variants(src).items()}
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on the {name} variant:\n{log[-3000:]}")
        lib = ctypes.CDLL(os.path.join(out_dir, f"lib_{name.replace(' ', '_')}.so"))
        lib._vits_typed = False
        libs[name] = lib
    real_load = cuda_build.load
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(cs.SEED)
    try:
        for name, B, T_y, T_x, t_ys, t_xs in cs.mas_cases():
            if mas.plan(B, T_y, T_x).form != "warp":
                continue
            neg, ty, tx = cs._mas_case(gen, dev, B, T_y, T_x, t_ys, t_xs)
            res = []
            for vname, lib in libs.items():
                cuda_build.load = lambda source, lib=lib: lib
                ms = cs.graph_ms(lambda: mas.maximum_path_cuda(neg, ty, tx))
                res.append(f"{vname} {ms * 1e3:.1f}")
            print(f"[k2-phases] ({B}, {T_y}, {T_x}) {name} (us): " + "  ".join(res), flush=True)
            del neg
    finally:
        cuda_build.load = real_load
    clock = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
                            "--format=csv,noheader"], capture_output=True, text=True,
                           timeout=60).stdout.strip()
    print(f"[k2-phases] {cs.card_line()}; SM clock after the runs {clock}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
