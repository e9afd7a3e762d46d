#!/usr/bin/env python3
"""Which phase of K1, the int8 ResBlock2-chain kernel, its time goes to, on
one GPU.

    python3 scripts/probe_k1_phases.py

Builds variants of vits_tpu_torch/csrc/rb_chain_q8.cu with one phase's
arithmetic cut short - "no gate math" (tanh, exp and the sigmoid's
reciprocal replaced by one multiply), "no quantize" (the quotient and its
rounding replaced by a clamped multiply), "no wgmma" (the tensor-core
products replaced by one add) - and times each at the 12 base-config chain
shapes of chip_smoke.py (device time from a CUDA graph, chip_smoke.graph_ms)
beside the unmodified kernel. The variants compute wrong values; they only
say what each phase costs. Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

QUANT = "__device__ __forceinline__ int quant(float v, Scale sc) {"
GATE = ("__device__ __forceinline__ float gate_value(int acc_a, int acc_b, const float* v, "
        "const float* gsb,\n                                            int C, int h) {")
MMA_DECL = ("template <int N>\n__device__ __forceinline__ void wgmma(int (&d)[N / 2], "
            "uint64_t da, uint64_t db);")
MMA_SPEC = "template <>\n__device__ __forceinline__ void wgmma<"


def variants(src: str) -> dict:
    for anchor in (QUANT, GATE, MMA_DECL, MMA_SPEC):
        if anchor not in src:
            raise RuntimeError(f"the kernel source no longer has {anchor!r}")
    cheap_gate = "\n  return static_cast<float>(acc_a - acc_b) * v[h];"
    cheap_quant = "\n  return static_cast<int>(fminf(fmaxf(v * sc.inv, -127.f), 127.f));"
    return {
        "kernel": src,
        "no gate math": src.replace(GATE, GATE + cheap_gate),
        "no quantize": src.replace(QUANT, QUANT + cheap_quant),
        "no wgmma": src.replace(MMA_SPEC, "template <>\n__device__ __forceinline__ void wgmma_off<")
        .replace(MMA_DECL, MMA_DECL.replace(";", " { d[0] += static_cast<int>(da ^ db); }") +
                 "\n" + MMA_DECL.replace("wgmma(", "wgmma_off(")),
    }


def build(out_dir: str, name: str, text: str) -> subprocess.Popen:
    from vits_tpu_torch.utils import cuda_build
    stem = name.replace(" ", "_")
    path = os.path.join(out_dir, f"rb_{stem}.cu")
    with open(path, "w") as f:
        f.write(text)
    return subprocess.Popen([cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, "-o",
                             os.path.join(out_dir, f"lib_{stem}.so"), path],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_k1_phases: no CUDA device is available", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from vits_tpu_torch.nn import rb_chain
    from vits_tpu_torch.utils import cuda_build

    out_dir = os.path.join(os.path.dirname(cuda_build.BUILD_DIR), "k1_probe")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(cuda_build.CSRC, rb_chain.SOURCE)) as f:
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
    shapes, gin = cs.k1_shapes()
    gen = torch.Generator().manual_seed(cs.SEED)
    total = dict.fromkeys(libs, 0.0)
    try:
        for C, k, dil, M, v in shapes:
            qp, x, gs, valid = cs.k1_case(dev, gen, C, k, dil, gin, [v], M)
            res = []
            for name, lib in libs.items():
                cuda_build.load = lambda source, lib=lib: lib
                ms = cs.graph_ms(lambda: rb_chain.chain_q8_cuda(qp, x, gs, valid))
                total[name] += ms
                res.append(f"{name} {ms * 1e3:.1f}")
            print(f"[k1-phases] C={C:3d} k={k:2d} (us): " + "  ".join(res), flush=True)
            del qp, x, gs
    finally:
        cuda_build.load = real_load
    print("[k1-phases] 12 chains (ms): " + "  ".join(f"{n} {t:.4f}" for n, t in total.items()) +
          f"; {cs.card_line()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
