"""CLI: check and run an exported .onnx file without onnxruntime
(counterpart of `python -m vits_tpu.onnx`).

  python -m vits_tpu_torch.onnx model_p1.onnx              # summary + structure check
  python -m vits_tpu_torch.onnx model_p1.onnx --run        # run on random inputs (cuda)
  python -m vits_tpu_torch.onnx model_p2.onnx --run --seed 3 --device cpu

The structural check plays `onnx.checker`'s part (every node input is a
graph input, an initializer or an earlier node's output; every graph output
is produced; the file parses). `--run` evaluates the model on random inputs
with `vits_tpu_torch.onnx.runtime` on --device (`cuda` unless "cpu" is
asked for; without a GPU `--run` raises), a dynamic axis drawn at the
traced size the exporter recorded. The check alone needs no device.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from vits_tpu_torch.device import resolve_device
from vits_tpu_torch.onnx import proto, runtime


def check_model(model: dict) -> list:
    """Structural validation; returns a list of problem strings."""
    g = model.get("graph")
    if g is None:
        return ["no graph"]
    problems = [] if model.get("opset") is not None else ["no opset_import"]
    known = {t["name"] for t in g["initializer"]} | {vi["name"] for vi in g["input"]}
    for n in g["node"]:
        for i in n["input"]:
            if i and i not in known:
                problems.append(f"node {n['name']} ({n['op_type']}): input '{i}' is not a "
                                "graph input, initializer, or earlier output")
        if not n["op_type"]:
            problems.append(f"node {n['name']}: empty op_type")
        known |= set(n["output"])
    problems += [f"graph output '{vi['name']}' is never produced"
                 for vi in g["output"] if vi["name"] not in known]
    return problems


def random_input(vi: dict, seed: int, traced=None) -> np.ndarray:
    """A random input for a graph input: its static dims, the traced size
    (or 17) for a named one; normal floats, zero integers."""
    rng = np.random.RandomState(seed)
    shape = [d if isinstance(d, int) else (traced[ax] if traced else 17)
             for ax, d in enumerate(vi["shape"])]
    dt = proto.ONNX_TO_NP[vi["elem_type"]]
    if np.issubdtype(dt, np.floating):
        return rng.randn(*shape).astype(dt)
    return np.zeros(shape, dt)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m vits_tpu_torch.onnx")
    ap.add_argument("model")
    ap.add_argument("--run", action="store_true",
                    help="evaluate on random inputs with the port's runtime")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="torch device of --run (default cuda)")
    args = ap.parse_args(argv)

    with open(args.model, "rb") as f:
        buf = f.read()
    m = proto.parse_model(buf)
    g = m["graph"]
    ops = {}
    for n in g["node"]:
        ops[n["op_type"]] = ops.get(n["op_type"], 0) + 1
    print(f"{args.model}: ir_version={m['ir_version']} opset={m['opset']} "
          f"producer={m['producer']!r}")
    print(f"graph '{g['name']}': {len(g['node'])} nodes, {len(g['initializer'])} initializers "
          f"({sum(len(t['raw']) for t in g['initializer']) / 1e6:.1f} MB)")
    for vi in g["input"]:
        print(f"  input  {vi['name']}: {vi['shape']} ({proto.ONNX_TO_NP[vi['elem_type']].name})")
    for vi in g["output"]:
        print(f"  output {vi['name']}: {vi['shape']}")
    print("  ops:", ", ".join(f"{k}x{v}" for k, v in sorted(ops.items())))
    problems = check_model(m)
    for p in problems:
        print("PROBLEM:", p)
    if problems:
        return 1
    print("structure: OK")
    if not args.run:
        return 0

    dev = resolve_device(args.device)
    traced = {}
    if "traced_shapes=" in m.get("doc", ""):
        traced = json.loads(m["doc"].split("traced_shapes=", 1)[1])
    inputs = {vi["name"]: random_input(vi, args.seed + i, traced.get(vi["name"]))
              for i, vi in enumerate(g["input"])}
    out = runtime.run_model(buf, inputs, dev)
    finite = True
    for k, v in out.items():
        flat = v.double().reshape(-1)
        ok = bool(flat.isfinite().all())
        finite &= ok
        print(f"  ran {k} on {dev}: shape {tuple(v.shape)} mean {float(flat.mean()):+.4e} "
              f"std {float(flat.std(unbiased=False)):.4e} finite={ok}")
    if not finite:
        return 1
    print("run: OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
