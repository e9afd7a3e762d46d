"""The lower-precision control and the planted faults of a cell, on the card
at the cell's own size: the frozen reference put in the program's place,
computed one precision below the configuration's, and compared with the
plain reference by the numbers the cell's runs compare.

    python3 benchmark/control.py --workload <cell> --seeds 11,12,13 [--fault half_batch]

base-serve-b1: the reference with TF32 on (the configuration serves fp32
with TF32 off) serves a seeded sample of the first block's requests, the
longest among them. adapt-batch-q8: the reference's decoder quantized to
int4 weights, TF32 on, serves the four longest batches. base-train-b32: the
reference's bf16 step with its compute copies rounded through float8 e4m3
first (base-train-ddp4: on 4 ranks, threads of one process, one a card);
`--fault half_batch` runs the plain step on the first half of each batch
instead, `--fault repeat` the plain step again (how far two runs of
the same step on the card drift apart). Prints one line of readings per seed; the benchmark's own
runs never run this."""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def tf32(on: bool):
    import torch
    torch.backends.cudnn.allow_tf32 = on
    torch.backends.cuda.matmul.allow_tf32 = on


def control_serve(cell, seed, dev):
    import numpy as np
    from benchmark.harness import check as C
    from benchmark.harness import common
    from benchmark.harness.serve import FUSED_FRAMES_PER_TOKEN, engine_ring
    from benchmark.harness.traffic import hps_of, make_requests
    from benchmark.harness.weights import build_serving_model
    tf, cfg = cell["traffic_file"], cell["config_file"]
    hps = hps_of(common.hparams(cfg))
    ref = build_serving_model(hps, seed, dev, cfg["assumed"])
    ring = engine_ring(hps)
    reqs = make_requests(tf, seed, hps.data.text_channels, hps.data.n_speakers)[:tf["block"]]
    sample = C.sample_served([{"req": r} for r in reqs], tf["check"]["sample"], seed,
                             key=lambda s: s["req"]["tokens"])
    tf32(True)
    for s in sample:
        r = s["req"]
        x_pad = C.quantize(r["tokens"], 32, 384)
        x = np.zeros((1, x_pad, r["text"].shape[1]), np.float32)
        x[0, :r["tokens"]] = r["text"]
        _, _, logw, _, x_mask = C.ref_phase1(ref, x, [r["tokens"]], r["emo"][None],
                                             [r["spk"]], dev)
        import torch
        w = torch.ceil((torch.exp(logw) * x_mask).float())[0, :r["tokens"], 0]
        frames = max(int(w.sum()), 1)
        s["wav"], _ = C.ref_request(ref, hps, ring, r, frames, FUSED_FRAMES_PER_TOKEN, dev)
    tf32(False)
    return C.compare_served(ref, hps, ring, sample, FUSED_FRAMES_PER_TOKEN, dev)


def control_batch(cell, seed, dev):
    import torch
    from benchmark.harness import batch as D
    from benchmark.harness import common
    from benchmark.harness.traffic import hps_of, make_requests
    from benchmark.harness.weights import build_serving_model
    from benchmark.reference import quant
    from benchmark.reference.seq import infer_path
    tf, cfg = cell["traffic_file"], cell["config_file"]
    hps = hps_of(common.hparams(cfg))
    assumed = cfg["assumed"]
    tf32(True)
    ref = build_serving_model(hps, seed, dev, assumed)
    ring = D.noise_ring(hps, seed, dev)
    quant.WEIGHT_QMAX = 7
    dec = D.quantize_on(ref, hps, D.calibration_batch(hps, tf, seed), ring, dev,
                        tf["frame_quantum"], infer_path)
    quant.WEIGHT_QMAX = 127
    reqs = make_requests(tf, seed, hps.data.text_channels, hps.data.n_speakers)
    batches = D.make_batches(reqs, tf["batch"], tf["text_quantum"], seed)
    batches = sorted(batches, key=lambda b: -int(b["lens"].sum()))[:tf["check"]["sample"]]
    phases = D.Phases(ref, dec, ring, hps, tf["frame_quantum"], dev, False, infer_path)
    done = []
    with torch.no_grad():
        for b in batches:
            wavs, y_len, T_y = phases(b)
            done.append({"batch": b, "wavs": wavs, "y_len": y_len, "T_y": T_y})
    tf32(False)
    del ref, dec, phases
    return D.compare_batches(hps, seed, assumed, tf, done, dev)


def control_train(cell, seed, dev, fault):
    from benchmark.harness import train as D
    from benchmark.reference import step
    workdir = tempfile.mkdtemp(prefix="bench-control-")
    world = int(cell["traffic_file"].get("ranks", 1))
    try:
        hps_dict = D.corpus_and_hps(cell, seed, workdir)
        if fault == "half_batch":
            prog = D.reference_steps(hps_dict, dev, D.CHECK_STEPS, world=world, fault=lambda b: {
                k: v[:v.shape[0] // 2] for k, v in b.items()})
        elif fault == "repeat":  # the reference against itself: the card's own spread
            prog = D.reference_steps(hps_dict, dev, D.CHECK_STEPS, world=world)
        else:
            import torch
            step.CAST_VIA = torch.float8_e4m3fn
            prog = D.reference_steps(hps_dict, dev, D.CHECK_STEPS, world=world)
            step.CAST_VIA = None
        ref = D.reference_steps(hps_dict, dev, D.CHECK_STEPS, world=world)
        return D.compare_steps(prog, ref)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--fault", default=None, choices=(None, "half_batch", "repeat"))
    args = p.parse_args(argv)
    from benchmark.harness import common
    cell = common.load_cell(args.workload)
    common.prepare_environment()
    common.require_cards(cell["chips"])
    import torch
    dev = torch.device("cuda")
    driver = cell["traffic_file"]["driver"]
    for seed in (int(s) for s in args.seeds.split(",")):
        if driver == "serve":
            r = control_serve(cell, seed, dev)
        elif driver == "batch":
            r = control_batch(cell, seed, dev)
        else:
            r = control_train(cell, seed, dev, args.fault)
        print(json.dumps({"workload": args.workload, "seed": seed, "fault": args.fault,
                          "readings": r}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
