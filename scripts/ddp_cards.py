#!/usr/bin/env python3
"""Data-parallel training and the tensor-parallel decoder of the PyTorch/CUDA
port across the host's cards.

    python3 scripts/ddp_cards.py [--ranks 4,2]
    python3 scripts/ddp_cards.py --tp 4

With --tp N (and no --ranks) it runs chip_smoke.py's `[tp]` sharded decode
(`tp_sharded`) instead, on N ranks with the decoder split over all N (NCCL,
one rank a card, where the host has N cards): the base config at full width,
infer_p2 at (T_x 48, T_y 384) and (125, 1000) against the one-process
infer_p2 (atol 2e-4, rtol 2e-3), the ranks' outputs equal, each rank's
decoder parameters, the sharded and one-process ms and the gathers' ms.

Runs chip_smoke.py's `[ddp]` phase once for each rank count of --ranks
(default: one rank a card): the K2 kernel built, then torchrun's ranks
(`chip_smoke.py --ddp-rank`), NCCL where every rank has a card of its own,
gloo where ranks share one. Each run holds the N-rank step at N x 8
against the float64 step of one process on the concatenated batch: the
N-rank float64 step with cuDNN and without within 1e-9 relative, and the
N-rank fp32 step without cuDNN within the fp32 tolerance; then it
trains the base config at
full width with -d, batch 32 a rank, for 4 fp32 and 4 bf16 steps (digests,
rank 0's files, K2 bit-exact), prints each rank's step ms, gradient
all-reduce ms, global audio-s/s and peak memory beside the card's name and
power limit, and resumes the bf16 run in one process. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", default=None,
                    help="comma-separated rank counts (default: the host's card count)")
    ap.add_argument("--tp", default=None,
                    help="comma-separated rank counts of the tensor-parallel decode")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ddp_cards: no CUDA device is available", file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    counts = ([int(r) for r in args.ranks.split(",")] if args.ranks
              else [torch.cuda.device_count()])
    cs.log(f"[cards] {cs.card_line()} x {torch.cuda.device_count()}")
    for ranks in [int(r) for r in args.tp.split(",")] if args.tp else []:
        start = time.perf_counter()
        with tempfile.TemporaryDirectory() as workdir:
            err = cs.tp_sharded(workdir, ranks, ranks)
        cs.log(f"[cards] tp over {ranks} ranks: {time.perf_counter() - start:.1f} s, "
               f"max_abs_err {err:.3e}")
    if args.tp and not args.ranks:
        return 0
    cs.phase_build()
    dev = torch.device("cuda", 0)
    for ranks in counts:
        cs.DDP_RANKS = ranks
        start = time.perf_counter()
        with tempfile.TemporaryDirectory() as workdir:
            launches, err = cs.phase_ddp(dev, workdir)
        cs.log(f"[cards] {ranks} ranks: {time.perf_counter() - start:.1f} s, K2 launches "
               f"{launches} (max_abs_err {err:.1e})")
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
