"""Weights across the two packages: a JAX parameter tree (nested dicts of
arrays, from `Synthesizer.init_params` or a checkpoint) <-> the port's
`state_dict`.

The JAX tree's keys mirror the port's module paths; only the leaf names and
layouts differ (the torch layouts of vits_tpu/utils/torch_compat.py):

  JAX leaf                          port
  Dense "w"          (in, out)      weight (out, in)
  Conv1d "w"         (k, in, out)   weight (out, in, k)
  ConvTranspose "w"  (k, in, out)   weight (in, out, k)      (under "ups")
  "b"                               bias
  Embedding "embedding" (n, d)      weight (n, d)
  "gamma", "beta", "alpha"          unchanged

Weight-norm {"g", "v"} pairs are folded first (`fold_weight_norm`). The
posterior encoder "enc_q" is training-only and has no counterpart yet.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch
from torch import nn

from vits_tpu_torch.nn.core import fold_weight_norm

TRAINING_ONLY = ("enc_q",)
TRANSPOSED = "ups"  # the decoder's transposed convs sit at dec.ups.<i>


def _is_transposed(path) -> bool:
    return len(path) >= 2 and path[-2] == TRANSPOSED


def _to_torch_layout(path, leaf: str, arr: np.ndarray):
    if leaf == "w":
        name = "weight"
        if arr.ndim == 2:
            arr = arr.T
        elif arr.ndim == 3:
            arr = arr.transpose(1, 2, 0) if _is_transposed(path) else arr.transpose(2, 1, 0)
        else:
            raise ValueError(f"{'.'.join(path)}: unexpected kernel rank {arr.ndim}")
    elif leaf == "b":
        name = "bias"
    elif leaf == "embedding":
        name = "weight"
    else:
        name = leaf
    return name, np.ascontiguousarray(arr)


def params_from_jax(tree: Dict[str, Any], model: Optional[nn.Module] = None):
    """JAX parameter tree -> the port's state dict (CPU float tensors). With
    `model`, load it with `load_state_dict(strict=True)` and return the model."""
    tree = {k: v for k, v in tree.items() if k not in TRAINING_ONLY}
    state: Dict[str, torch.Tensor] = {}

    def rec(node, path):
        for k, v in node.items():
            if isinstance(v, dict):
                rec(v, path + (k,))
            else:
                name, arr = _to_torch_layout(path, k, np.asarray(v, np.float32))
                state[".".join(path + (name,))] = torch.tensor(arr)

    rec(fold_weight_norm(tree), ())
    if model is None:
        return state
    model.load_state_dict(state, strict=True)
    return model


def params_to_jax(state: Dict[str, torch.Tensor]) -> Dict:
    """The port's state dict -> a (folded) JAX parameter tree of numpy arrays,
    the inverse of `params_from_jax`; used to write checkpoints the JAX
    package's format reads."""
    tree: Dict[str, Any] = {}
    for key, t in state.items():
        parts = key.split(".")
        path, name = parts[:-1], parts[-1]
        arr = t.detach().cpu().float().numpy()
        if name == "weight" and arr.ndim >= 2:
            leaf = "w"
            if arr.ndim == 2:
                if path[-1:] == ["emb_g"]:
                    leaf = "embedding"
                else:
                    arr = arr.T
            elif _is_transposed(path):
                arr = arr.transpose(2, 0, 1)
            else:
                arr = arr.transpose(2, 1, 0)
        elif name == "bias":
            leaf = "b"
        else:
            leaf = name
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = np.ascontiguousarray(arr)
    return tree
