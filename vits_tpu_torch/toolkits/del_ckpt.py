"""Checkpoint garbage collection (counterpart of
vits_tpu/toolkits/del_ckpt.py): keep the newest N G/D/P checkpoints per run
dir, optionally looping.

    python -m vits_tpu_torch.toolkits.del_ckpt logs/<name> [--keep 5] [--interval 0]
"""

from __future__ import annotations

import argparse
import time

from vits_tpu_torch.utils.checkpoint import prune_checkpoints


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("dirs", nargs="+")
    parser.add_argument("--keep", "-k", type=int, default=5)
    parser.add_argument("--interval", "-i", type=int, default=0,
                        help="loop every N seconds (0 = run once)")
    args = parser.parse_args(argv)
    while True:
        for d in args.dirs:
            for regex in ("G_*.npz", "D_*.npz", "P_*.npz"):
                prune_checkpoints(d, keep=args.keep, regex=regex)
        if args.interval <= 0:
            break
        time.sleep(args.interval)


if __name__ == "__main__":
    main()
