"""K-means emotion clustering into a per-speaker emotion bank (counterpart
of vits_tpu/toolkits/cluster_emotion.py): at most 10k vectors after a seeded
shuffle, the farthest (1 - keep) fraction from the global mean trimmed,
scipy's k-means with the same seed, centroids sorted by their distance to
the mean, a float32 (K, 1024) bank.

    python -m vits_tpu_torch.toolkits.cluster_emotion <k> <scp of .emo paths> <out.emo> [keep]
"""

from __future__ import annotations

import argparse
from typing import Sequence

import numpy as np
from scipy.cluster.vq import kmeans


def cluster_emotions(emo_paths: Sequence[str], k: int = 3,
                     keep_fraction: float = 0.9, seed: int = 0) -> np.ndarray:
    """Returns the (K, 1024) centroid bank sorted by distance to the mean."""
    emo = np.stack([np.fromfile(p, dtype=np.float32)[:1024] for p in emo_paths])
    rng = np.random.RandomState(seed)
    rng.shuffle(emo)
    emo = emo[:10000]
    mean = np.mean(emo)
    if 0 < keep_fraction < 1.0 and len(emo) > 1:
        dist = np.linalg.norm(emo - mean, 2, -1)
        emo = emo[np.argsort(dist)][:max(1, int(keep_fraction * len(emo)))]
    center, _ = kmeans(emo.astype(np.float64), min(k, len(emo)), seed=seed)
    dist = np.linalg.norm(center - mean, 2, -1)
    return center[np.argsort(dist)].astype(np.float32)


def main(argv=None):
    parser = argparse.ArgumentParser(description="Cluster .emo files into a bank.")
    parser.add_argument("k", type=int)
    parser.add_argument("scpfn", type=str)
    parser.add_argument("outfn", type=str)
    parser.add_argument("keep", type=float, nargs="?", default=0.9)
    args = parser.parse_args(argv)
    with open(args.scpfn, "rt") as f:
        paths = [line.strip() for line in f if line.strip() and line.strip()[0] != "#"]
    bank = cluster_emotions(paths, args.k, args.keep)
    bank.tofile(args.outfn)
    print(f"saved {bank.shape} to {args.outfn}")


if __name__ == "__main__":
    main()
