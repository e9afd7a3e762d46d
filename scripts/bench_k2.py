#!/usr/bin/env python3
"""K2, the MAS kernel, against an earlier version of its source, on one GPU,
in turns (old, new, new, old) at the shapes of chip_smoke.py's MAS phase.

    git show <commit>:vits_tpu_torch/csrc/mas.cu > build/k2_old/mas.cu
    python3 scripts/bench_k2.py --old build/k2_old/mas.cu [--out k2.json]

The old source is the one-form kernel (entry `mas_forward` without a plan,
its global scratch sized by `mas_scratch_words`); it is built here with
nvcc and driven the way its wrapper drove it. The new one goes through
`vits_tpu_torch.ops.mas.maximum_path_cuda`, in the form `plan` picks. Both
are held against the plain version first, bit for bit. Prints, per shape,
the form, the four device times (chip_smoke.graph_ms: 20 calls in a CUDA
graph, so without the host's launch cost), the byte bound and the share of
it each version reaches, then the card's name and power limit.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

_P, _I = ctypes.c_void_p, ctypes.c_int


def build_old(src: str) -> ctypes.CDLL:
    from vits_tpu_torch.utils import cuda_build
    out = os.path.join(os.path.dirname(os.path.abspath(src)), "libmas_old.so")
    subprocess.run([cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, "-o", out, src], check=True,
                   capture_output=True, text=True)
    lib = ctypes.CDLL(out)
    lib.mas_forward.argtypes = [_P] * 5 + [_I] * 3 + [_P]
    lib.mas_forward.restype = _I
    lib.mas_scratch_words.argtypes = [_I, _I]
    lib.mas_scratch_words.restype = ctypes.c_int64
    return lib


def old_runner(lib, neg, t_ys, t_xs):
    """The old wrapper: a scratch where its bits do not fit, one launch."""
    B, T_y, T_x = neg.shape
    words = lib.mas_scratch_words(T_y, T_x)
    if words < 0:
        raise ValueError(f"the old kernel does not take T_x = {T_x}")

    def run():
        path = torch.empty_like(neg)
        scratch = torch.empty(B * words, dtype=torch.int32, device=neg.device) if words else None
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        err = lib.mas_forward(neg.data_ptr(), t_ys.data_ptr(), t_xs.data_ptr(), path.data_ptr(),
                              scratch.data_ptr() if words else None, B, T_y, T_x, stream)
        if err:
            raise RuntimeError(f"old mas_forward launch failed ({err})")
        return path
    return run


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--old", required=True, help="the earlier mas.cu")
    ap.add_argument("--out", default=None, help="write the numbers here as JSON")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_k2: no CUDA device is available", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from vits_tpu_torch.ops import mas

    dev = torch.device("cuda", 0)
    old = build_old(args.old)
    gen = torch.Generator().manual_seed(cs.SEED)
    rows = []
    for name, B, T_y, T_x, t_ys, t_xs in cs.mas_cases():
        neg, ty, tx = cs._mas_case(gen, dev, B, T_y, T_x, t_ys, t_xs)
        run_old = old_runner(old, neg, ty, tx)
        run_new = lambda: mas.maximum_path_cuda(neg, ty, tx)  # noqa: E731
        ref = mas.maximum_path_plain(neg, ty, tx)
        if not (torch.equal(run_old(), ref) and torch.equal(run_new(), ref)):
            raise RuntimeError(f"{name}: a version differs from the plain one")
        t = [cs.graph_ms(f) for f in (run_old, run_new, run_new, run_old)]
        bound = mas.mas_bytes(ty, tx, T_y, T_x) / cs.HBM_BW * 1e3
        p = mas.plan(B, T_y, T_x)
        r = dict(name=name, shape=[B, T_y, T_x], form=p.form, R=p.R, D=p.D, smem=p.smem,
                 old_ms=[t[0], t[3]], new_ms=[t[1], t[2]], bound_ms=bound)
        rows.append(r)
        o, n = min(r["old_ms"]), min(r["new_ms"])
        print(f"[k2] ({B}, {T_y}, {T_x}) {name}: form {p.form} R={p.R} D={p.D}: old "
              f"{t[0]:.4f} / {t[3]:.4f} ms, new {t[1]:.4f} / {t[2]:.4f} ms, bound {bound:.3e} ms "
              f"(bytes); share of the bound old {100 * bound / o:.2f}% new "
              f"{100 * bound / n:.2f}%; new/old {n / o:.3f}", flush=True)
        del neg, ref
    card = cs.card_line()
    print(f"[k2] {card}")
    res = {"rows": rows, "card": card}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    print(json.dumps({"new_over_old": {r["name"]: min(r["new_ms"]) / min(r["old_ms"])
                                       for r in rows}, "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
