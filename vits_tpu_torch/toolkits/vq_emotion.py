"""Nearest-centroid emotion quantization (counterpart of
vits_tpu/toolkits/vq_emotion.py): each .emo vector listed in an scp is
replaced by its nearest centre of a bank, written beside it as `.vq`.

    python -m vits_tpu_torch.toolkits.vq_emotion <bank.emo> <emo.scp>

The nearest centre is found in float64 by squared Euclidean distance, the
first of equal distances winning, as scipy.cluster.vq.vq picks it.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch


def quantize(emo: np.ndarray, centers: np.ndarray) -> np.ndarray:
    """emo (1024,) or (1, 1024); centers (K, 1024) -> the nearest centre,
    (1, 1024) float32."""
    e = torch.from_numpy(np.asarray(emo, np.float64).reshape(1, -1))
    c = torch.from_numpy(np.asarray(centers, np.float64))
    code = int(torch.argmin(torch.sum(torch.square(c - e), dim=1)))
    return centers[code:code + 1].astype(np.float32)


def main(argv=None):
    parser = argparse.ArgumentParser(description="VQ .emo files against a bank.")
    parser.add_argument("clusterfn", type=str)
    parser.add_argument("scpfn", type=str)
    args = parser.parse_args(argv)
    centers = np.fromfile(args.clusterfn, np.float32).reshape(-1, 1024)
    with open(args.scpfn, "rt") as f:
        for emofn in f:
            emofn = emofn.strip()
            if not emofn or emofn[0] == "#":
                continue
            emo = np.fromfile(emofn, dtype=np.float32).reshape(1, 1024)
            quantize(emo, centers).tofile(emofn + ".vq")
            print(f"Output to {emofn}.vq")


if __name__ == "__main__":
    main()
