#!/usr/bin/env python3
"""K1, the int8 ResBlock2-chain kernel, against an earlier version of its
source, on one GPU, in turns (old, new, new, old) at the 12 base-config chain
shapes of chip_smoke.py.

    git show <commit>:vits_tpu_torch/csrc/rb_chain_q8.cu > build/k1_old/rb_chain_q8.cu
    python3 scripts/bench_k1.py --old build/k1_old/rb_chain_q8.cu [--out k1.json]

The old source is the one-launch-per-dilation kernel (entry point
`rb2_iter_q8`, weights as `pack_words` words, the gate bias summed by the
host); it is built here with nvcc and driven the way its wrapper drove it.
The new one goes through `vits_tpu_torch.nn.rb_chain.chain_q8_cuda`. Both are
held against the plain version first (chip_smoke.py's tolerance). Prints, per
shape, the four device times (chip_smoke.graph_ms: 20 calls in a CUDA
graph, so without the host's launch cost), the bound and the share of it
each version reaches, and each version's time per eager call (host launch
cost included), then the 12-chain totals.
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
    out = os.path.join(os.path.dirname(os.path.abspath(src)), "librb_chain_q8_old.so")
    subprocess.run([cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, "-o", out, src], check=True,
                   capture_output=True, text=True)
    lib = ctypes.CDLL(out)
    lib.rb2_iter_q8.argtypes = [_P] * 11 + [_I] * 6 + [_P]
    lib.rb2_iter_q8.restype = _I
    lib.rb2_iter_q8_smem_bytes.argtypes = [_I] * 4
    lib.rb2_iter_q8_smem_bytes.restype = _I
    return lib


def old_runner(lib, qp, x, gs, valid, n_sm):
    """The old wrapper: per dilation, the gate bias ga/gb formed on the host
    and one launch on tiles of 128/64/32/16 frames."""
    from vits_tpu_torch.nn.rb_chain import SMEM_LIMIT, pack_words
    B, M, C = x.shape
    K, dil = qp["kernel_size"], qp["dilation"]
    H = C // 2
    its = []
    for it in qp["iters"]:
        its.append(dict(w1p=pack_words(it["w1"]), w2p=pack_words(it["w2"]),
                        deq1=(it["s_in1"] * it["s_w1"]).contiguous(),
                        deq2=(it["s_in2"] * it["s_w2"]).contiguous(), b2=it["b2"], b1=it["b1"],
                        s_in=torch.stack([it["s_in1"], it["s_in2"]]).contiguous()))

    def run():
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        v = valid.clamp(0, M)
        cur = x
        for i, (it, d) in enumerate(zip(its, dil)):
            ga = (gs[:, i, :H] + it["b1"][:H]).contiguous()
            gb = (gs[:, i, H:] + it["b1"][H:]).contiguous()
            out = torch.empty_like(x)
            T = 128
            while T > 16 and B * -(-M // T) < 2 * n_sm:
                T //= 2
            while T > 8 and lib.rb2_iter_q8_smem_bytes(C, K, d, T) > SMEM_LIMIT:
                T //= 2
            err = lib.rb2_iter_q8(cur.data_ptr(), out.data_ptr(), it["w1p"].data_ptr(),
                                  it["w2p"].data_ptr(), it["deq1"].data_ptr(),
                                  it["deq2"].data_ptr(), it["b2"].data_ptr(), ga.data_ptr(),
                                  gb.data_ptr(), v.data_ptr(), it["s_in"].data_ptr(),
                                  B, M, C, K, d, T, stream)
            if err:
                raise RuntimeError(f"old rb2_iter_q8 launch failed ({err})")
            cur = out
        return cur
    return run


def sweep(rb_chain, cs, qp, x, gs, valid, dil, n_sm):
    """Device ms of the whole-chain form at each tile that fits."""
    import dataclasses
    B, M, C = x.shape
    K = qp["kernel_size"]
    out = []
    for T in rb_chain.CHAIN_TILES:
        p = rb_chain.chain_plan(B, M, C, K, dil, T, n_sm)
        if p is None:
            continue
        for grid in sorted({p.grid, min(p.tiles, n_sm)}):
            q = dataclasses.replace(p, grid=grid)
            ms = cs.graph_ms(lambda: rb_chain.chain_q8_cuda(qp, x, gs, valid, q))
            rounds = rb_chain.chain_rounds(C, K, dil, T)
            out.append(dict(T=T, grid=grid, tiles=p.tiles, rounds=rounds, resident=p.resident,
                            smem=p.smem, ms=ms))
            print(f"[k1-sweep] C={C} k={K} T={T} tiles={p.tiles} grid={grid} rounds={rounds} "
                  f"resident={p.resident} smem={p.smem}: {ms:.4f} ms", flush=True)
    return out


def close(out, ref) -> bool:
    diff = (out - ref).abs()
    peak = float(ref.abs().max())
    return float(diff.max()) <= 0.05 * max(1.0, peak) and \
        float((diff > 1e-3 * peak).float().mean()) < 0.01


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--old", required=True, help="the earlier rb_chain_q8.cu")
    ap.add_argument("--out", default=None, help="write the numbers here as JSON")
    ap.add_argument("--sweep", action="store_true",
                    help="also time the whole-chain form at every tile that fits, with one "
                         "and (where the plan allows) two blocks per SM")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_k1: no CUDA device is available", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from vits_tpu_torch.nn import rb_chain

    dev = torch.device("cuda", 0)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    old = build_old(args.old)
    shapes, gin = cs.k1_shapes()
    gen = torch.Generator().manual_seed(cs.SEED)
    rows = []
    for C, k, dil, M, v in shapes:
        qp, x, gs, valid = cs.k1_case(dev, gen, C, k, dil, gin, [v], M)
        run_old = old_runner(old, qp, x, gs, valid, n_sm)
        run_new = lambda: rb_chain.chain_q8_cuda(qp, x, gs, valid)  # noqa: E731
        ref = rb_chain.chain_q8_plain(qp, x, gs, valid)
        if not (close(run_old(), ref) and close(run_new(), ref)):
            raise RuntimeError(f"C={C} k={k}: a version disagrees with the plain one")
        t = [cs.graph_ms(f) for f in (run_old, run_new, run_new, run_old)]
        call = [cs.cuda_ms(f, iters=20) for f in (run_old, run_new)]
        ops, nbytes = rb_chain.chain_ops_bytes(1, M, C, k, len(dil))
        bound = max(ops / cs.INT8_PEAK, nbytes / cs.HBM_BW) * 1e3
        p = rb_chain.plan(1, M, C, k, dil, n_sm)
        r = dict(C=C, k=k, M=M, form=p.form, T=p.T, launches_old=len(dil),
                 launches_new=p.launches, old_ms=[t[0], t[3]], new_ms=[t[1], t[2]],
                 old_call_ms=call[0], new_call_ms=call[1],
                 bound_ms=bound, bound_by="ops" if ops / cs.INT8_PEAK > nbytes / cs.HBM_BW
                 else "bytes")
        if args.sweep and p.form == "chain":
            r["sweep"] = sweep(rb_chain, cs, qp, x, gs, valid, dil, n_sm)
        rows.append(r)
        o, n = min(r["old_ms"]), min(r["new_ms"])
        print(f"[k1] C={C:3d} k={k:2d} M={M:5d} {p.form:5s} T={p.T:3d}: old {t[0]:.4f} / "
              f"{t[3]:.4f} ms, new {t[1]:.4f} / {t[2]:.4f} ms, bound {bound:.4f} ms "
              f"({r['bound_by']}); share of the bound old {100 * bound / o:.1f}% new "
              f"{100 * bound / n:.1f}%; new/old {n / o:.3f}; per eager call old "
              f"{call[0]:.4f} new {call[1]:.4f} ms", flush=True)
        del qp, x, gs, ref
    tot = {key: [sum(r[key][j] for r in rows) for j in range(2)] for key in ("old_ms", "new_ms")}
    tot.update({key: sum(r[key] for r in rows) for key in ("old_call_ms", "new_call_ms")})
    bound = sum(r["bound_ms"] for r in rows)
    card = cs.card_line()
    print(f"[k1] 12 chains of a {cs.CHAIN_FRAMES}-frame request: old {tot['old_ms'][0]:.4f} / "
          f"{tot['old_ms'][1]:.4f} ms ({sum(r['launches_old'] for r in rows)} launches), new "
          f"{tot['new_ms'][0]:.4f} / {tot['new_ms'][1]:.4f} ms "
          f"({sum(r['launches_new'] for r in rows)} launches), bound {bound:.4f} ms; per eager "
          f"call old {tot['old_call_ms']:.4f} new {tot['new_call_ms']:.4f} ms; {card}")
    res = {"rows": rows, "total": tot, "bound_ms": bound, "card": card}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    print(json.dumps({"total": tot, "bound_ms": bound, "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
