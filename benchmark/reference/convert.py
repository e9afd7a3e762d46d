"""The port's `state_dict` -> the JAX package's parameter tree, the layout of
the checkpoints the port's serving engine reads: a frozen copy of the port's
`convert.params_to_jax` and the layout rules it needs.

The JAX tree's keys mirror the port's module paths; only the leaf names and
layouts differ: Dense "w" (in, out) <- weight (out, in); Conv1d "w" (k, in,
out) <- weight (out, in, k); ConvTranspose "w" (k, in, out) <- weight (in, out,
k) (under "ups"); weight norm "g"/"v", spectral norm "w_orig"/"u", "b" <- bias,
Embedding "embedding" <- weight; other leaves unchanged.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

TRANSPOSED = "ups"  # the decoder's transposed convs sit at dec.ups.<i>


def _is_transposed(path) -> bool:
    return len(path) >= 2 and path[-2] == TRANSPOSED


def _kernel_to_jax(path, arr: np.ndarray) -> np.ndarray:
    if arr.ndim == 2:
        return arr.T
    if arr.ndim == 3:
        return arr.transpose(2, 0, 1) if _is_transposed(path) else arr.transpose(2, 1, 0)
    if arr.ndim == 4:
        return arr.transpose(2, 3, 1, 0)
    raise ValueError(f"{'.'.join(path)}: unexpected kernel rank {arr.ndim}")


def params_to_jax(state: Dict[str, torch.Tensor]) -> Dict:
    """The port's state dict -> a JAX parameter tree of numpy arrays:
    `weight_g`/`weight_v` become {"g", "v"}
    (a training state goes back to the JAX package's training tree),
    `weight_orig`/`weight_u` {"w_orig", "u"}, a plain `weight` "w" (or
    "embedding" under emb_g, and "weight" for Swish's 1-D scalar)."""
    kernels = {"weight_v": "v", "weight_orig": "w_orig", "weight": "w"}
    tree: Dict[str, Any] = {}
    for key, t in state.items():
        parts = key.split(".")
        path, name = tuple(parts[:-1]), parts[-1]
        arr = t.detach().cpu().float().numpy()
        if name in kernels and (name != "weight" or (arr.ndim >= 2
                                                     and path[-1:] != ("emb_g",))):
            leaf = kernels[name]
            arr = _kernel_to_jax(path, arr)
        elif name == "weight_g":
            leaf = "g"
            arr = arr.reshape(1, -1, 1) if _is_transposed(path) else arr.reshape(-1)
        elif name == "weight":  # the speaker embedding's table, or Swish's scalar
            leaf = "embedding" if path[-1:] == ("emb_g",) else "weight"
        elif name == "bias":
            leaf = "b"
        elif name == "weight_u":
            leaf = "u"
        else:
            leaf = name
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = arr.copy()  # C order, a 0-d leaf kept 0-d
    return tree
