#!/usr/bin/env python3
"""Where a served request's time goes on the GPU, for the PyTorch/CUDA port.

    python3 scripts/profile_torch_serving.py [--frames 1024] [--fused] [--bf16] [--out DIR]

Builds the seeded random full-width base-config deployment that
chip_smoke.py serves, warms EmoVITS(quantize=True) up through its
calibration requests, then traces one two-phase int8 and one two-phase float
request of about `--frames` frames with torch.profiler; with --fused, also
the same request through the fused pass with the int8 decoder
(`infer_fused`, VITS_TPU_FUSED_Q8=1), whose decoder runs over the frame
budget, and with the float decoder (the default of `infer`). With --bf16 the
engine serves in bf16 (`compute_dtype="bf16"`, K1's bf16 form). Prints, per
request: host latency,
device busy time (the union of kernel intervals), the device's idle share of
the latency, and the device time and launches by kernel group (the int8
chain kernel K1, cuBLAS/cuBLASLt GEMMs, cuDNN convolutions, everything
else), then the top kernels by device time. With --out, writes the chrome traces there. Needs
a CUDA device.
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

# name fragments, matched in this order (a cuDNN conv kernel's name may say
# "gemm" too, and an int8 GEMM's "xmma"); the top kernel names are printed
# beside the groups so the grouping can be read off
GROUPS = (("rb2_chain_q8 (K1)", ("rb2_chain_kernel", "rb2_split_kernel")),
          ("cuDNN conv", ("fprop", "conv", "cudnn", "winograd", "implicit")),
          ("int8 GEMM (_int_mm)", ("i16832gemm", "gemm_s8", "imma", "int8", "s8s8")),
          ("float GEMM", ("gemm", "cutlass", "xmma")))


def _group(name: str) -> str:
    low = name.lower()
    for label, keys in GROUPS:
        if any(k in low for k in keys):
            return label
    return "other (elementwise, copies, reductions)"


def _busy_us(events) -> float:
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy


def profile_request(fn, model, req, seed, label, out_dir):
    from torch.profiler import ProfilerActivity, profile
    spk, text, emo, rate = req
    np.random.seed(seed)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        wav, _ = fn(spk, text, emo, duration_rate=rate)
        ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        raise RuntimeError("the profiler recorded no device activity")
    busy_ms = _busy_us(kernels) / 1e3
    by_group, by_name, n_group = {}, {}, {}
    for e in kernels:
        d = e.time_range.end - e.time_range.start
        by_group[_group(e.name)] = by_group.get(_group(e.name), 0.0) + d
        n_group[_group(e.name)] = n_group.get(_group(e.name), 0) + 1
        by_name[e.name] = by_name.get(e.name, 0.0) + d
    total = sum(by_group.values())
    frames = len(wav) // model.hop_size
    print(f"[profile] {label}: {frames} frames, latency {ms:.2f} ms, device busy "
          f"{busy_ms:.2f} ms, device idle share {1 - busy_ms / ms:.3f}, "
          f"{len(kernels)} kernel launches")
    for g, us in sorted(by_group.items(), key=lambda kv: -kv[1]):
        print(f"[profile] {label}:   {g:42s} {us / 1e3:8.3f} ms  {100 * us / total:5.1f}%  "
              f"{n_group[g]:4d} launches")
    for n, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        print(f"[profile] {label}:   top  {us / 1e3:8.3f} ms  {n[:100]}")
    if out_dir:
        prof.export_chrome_trace(os.path.join(out_dir, f"trace_{label}.json"))
    return {"frames": frames, "latency_ms": ms, "busy_ms": busy_ms,
            "launches": len(kernels), "groups_ms": {g: us / 1e3 for g, us in by_group.items()},
            "groups_launches": n_group}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--frames", type=int, default=1024)
    ap.add_argument("--fused", action="store_true",
                    help="also trace the request through the fused pass, int8 decoder")
    ap.add_argument("--bf16", action="store_true", help="serve in bf16")
    ap.add_argument("--out", default=None, help="directory for chrome traces")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_serving: no CUDA device is available", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from vits_tpu_torch.config import default_config_path
    from vits_tpu_torch.infer import EmoVITS

    dev = torch.device("cuda", 0)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
    with open(default_config_path("base")) as f:
        hps_dict = json.load(f)
    rng = np.random.RandomState(cs.SEED)
    with tempfile.TemporaryDirectory() as d:
        model = EmoVITS(cs._write_checkpoint(d, hps_dict, cs.SEED), device=str(dev),
                        quantize=True, compute_dtype="bf16" if args.bf16 else "fp32")
    reqs = cs._requests(model, model.q8_calib_requests + 1, rng, dev)
    for i, (spk, text, emo, rate) in enumerate(reqs[:-1]):
        np.random.seed(cs.SEED + i)
        model._infer_two_phase(spk, text, emo, duration_rate=rate)
    if model.dec_q8 is None:
        raise RuntimeError("the int8 decoder did not pass its gate")
    spk, text, emo, _ = reqs[-1]
    with torch.inference_mode():
        _, _, logw, _ = model.synth.infer_p1(
            torch.from_numpy(text[None]).to(dev, model.compute_dtype),
            torch.from_numpy(emo[None]).to(dev, model.compute_dtype),
            torch.tensor([spk], device=dev))
    req = (spk, text, emo, args.frames / float(torch.exp(logw.float()).sum()))
    dec_q8 = model.dec_q8

    def use_int8(on: bool):
        model.dec_q8, model.quantize = (dec_q8, True) if on else (None, False)

    runs = [("int8", True, model._infer_two_phase), ("float", False, model._infer_two_phase)]
    if args.fused:
        os.environ["VITS_TPU_FUSED_Q8"] = "1"
        runs += [("fused-int8", True, model.infer_fused),
                 ("fused-float", False, model.infer_fused)]
        print(f"[profile] fused budget {model.fused_frames(len(req[1]), req[3])} frames")
    res = {}
    prefix = "bf16-" if args.bf16 else ""
    for label, on, fn in runs:
        label = prefix + label
        use_int8(on)
        for _ in range(2):  # warm this path at this request's shapes
            np.random.seed(7)
            fn(*req[:3], duration_rate=req[3])
        res[label] = profile_request(fn, model, req, 7, label, args.out)
    use_int8(True)
    print(json.dumps({"profile": res, "card": cs.card_line()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
