"""Stacked pcolor plots of binary float feature files (counterpart of
vits_tpu/toolkits/plot_mels.py). matplotlib is imported when the tool runs,
not with the package.

    python -m vits_tpu_torch.toolkits.plot_mels <dim> <out.png> <a.bin> [<b.bin> ...]
"""

from __future__ import annotations

import argparse

import numpy as np


def main(argv=None):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    parser = argparse.ArgumentParser()
    parser.add_argument("dim", type=int)
    parser.add_argument("outfn", type=str)
    parser.add_argument("binfns", nargs="+")
    args = parser.parse_args(argv)

    fig, axes = plt.subplots(len(args.binfns), 1, squeeze=False)
    for ax, fn in zip(axes[:, 0], args.binfns):
        mel = np.fromfile(fn, dtype=np.float32).reshape(-1, args.dim)
        ax.pcolor(mel.T)
        ax.set_title(fn, fontsize=6)
    plt.tight_layout()
    plt.savefig(args.outfn, dpi=150)
    plt.close(fig)
    print(f"saved {args.outfn}")


if __name__ == "__main__":
    main()
