"""Weights across the two packages: a JAX parameter tree (nested dicts of
arrays, from `init_params`, a checkpoint or a training state) <-> the port's
`state_dict`.

The JAX tree's keys mirror the port's module paths; only the leaf names and
layouts differ (the torch layouts of vits_tpu/utils/torch_compat.py):

  JAX leaf                              port
  Dense "w"          (in, out)          weight (out, in)
  Conv1d "w"         (k, in/groups, out) weight (out, in/groups, k)
  ConvTranspose "w"  (k, in, out)       weight (in, out, k)       (under "ups")
  Conv2d "w"         (kh, kw, in, out)  weight (out, in, kh, kw)
  weight norm "v"    as "w"             weight_v
  weight norm "g"    (out,); (1, in, 1) for ConvTranspose
                                        weight_g (n, 1, ...), dim 0 kept
  "b"                                   bias
  Embedding "embedding" (n, d)          weight (n, d)
  "gamma", "beta", "alpha"              unchanged

A {"g", "v"} pair goes to `weight_g`/`weight_v` when the target model has
them (a training model, `Synthesizer.from_hps(hps, train=True)`, the
discriminators) and is folded into `weight` otherwise (serving). The
posterior encoder "enc_q" is dropped for a model without one. The
discriminator tree is {"discriminators": {"0": S, "1".."5": P}}.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Set

import numpy as np
import torch
from torch import nn

from vits_tpu_torch.nn.core import wn_kernel

TRAINING_ONLY = ("enc_q",)
TRANSPOSED = "ups"  # the decoder's transposed convs sit at dec.ups.<i>


def _is_transposed(path) -> bool:
    return len(path) >= 2 and path[-2] == TRANSPOSED


def _kernel_to_torch(path, arr: np.ndarray) -> np.ndarray:
    if arr.ndim == 2:
        return arr.T
    if arr.ndim == 3:
        return arr.transpose(1, 2, 0) if _is_transposed(path) else arr.transpose(2, 1, 0)
    if arr.ndim == 4:
        return arr.transpose(3, 2, 0, 1)
    raise ValueError(f"{'.'.join(path)}: unexpected kernel rank {arr.ndim}")


def _kernel_to_jax(path, arr: np.ndarray) -> np.ndarray:
    if arr.ndim == 2:
        return arr.T
    if arr.ndim == 3:
        return arr.transpose(2, 0, 1) if _is_transposed(path) else arr.transpose(2, 1, 0)
    if arr.ndim == 4:
        return arr.transpose(2, 3, 1, 0)
    raise ValueError(f"{'.'.join(path)}: unexpected kernel rank {arr.ndim}")


def state_from_jax(tree: Dict[str, Any], keys: Optional[Set[str]] = None
                   ) -> Dict[str, torch.Tensor]:
    """JAX parameter tree -> the port's state-dict entries (CPU float32
    tensors). `keys`: the target model's state-dict keys; a weight-norm pair
    stays a pair where they hold `<path>.weight_v`, and enc_q is dropped
    where they hold none of it. Without `keys` every pair is folded."""
    if keys is not None and not any(k.split(".")[0] in TRAINING_ONLY for k in keys):
        tree = {k: v for k, v in tree.items() if k not in TRAINING_ONLY}
    state: Dict[str, torch.Tensor] = {}

    def put(path, name, arr):
        state[".".join(path + (name,))] = torch.tensor(np.ascontiguousarray(arr))

    def rec(node, path):
        if "v" in node and "g" in node:
            v = np.asarray(node["v"], np.float32)
            if keys is not None and ".".join(path + ("weight_v",)) in keys:
                put(path, "weight_v", _kernel_to_torch(path, v))
                g = np.asarray(node["g"], np.float32).reshape(-1, *([1] * (v.ndim - 1)))
                put(path, "weight_g", g)
            else:
                put(path, "weight", _kernel_to_torch(path, wn_kernel(node)))
            node = {k: x for k, x in node.items() if k not in ("g", "v")}
        for k, v in node.items():
            if isinstance(v, dict):
                rec(v, path + (k,))
                continue
            arr = np.asarray(v, np.float32)
            if k == "w":
                put(path, "weight", _kernel_to_torch(path, arr))
            elif k == "b":
                put(path, "bias", arr)
            elif k == "embedding":
                put(path, "weight", arr)
            else:
                put(path, k, arr)

    rec(tree, ())
    return state


def params_from_jax(tree: Dict[str, Any], model: Optional[nn.Module] = None):
    """JAX parameter tree -> the port's state dict (CPU float tensors), every
    weight-norm pair folded. With `model`, the pairs follow the model (see
    `state_from_jax`), the model is loaded with `load_state_dict(strict=True)`
    and returned."""
    if model is None:
        return state_from_jax(tree)
    model.load_state_dict(state_from_jax(tree, set(model.state_dict())), strict=True)
    return model


def params_to_jax(state: Dict[str, torch.Tensor]) -> Dict:
    """The port's state dict -> a JAX parameter tree of numpy arrays, the
    inverse of `params_from_jax`: `weight_g`/`weight_v` become {"g", "v"}
    (a training state goes back to the JAX package's training tree), a
    plain `weight` becomes "w" (or "embedding" under emb_g)."""
    tree: Dict[str, Any] = {}
    for key, t in state.items():
        parts = key.split(".")
        path, name = tuple(parts[:-1]), parts[-1]
        arr = t.detach().cpu().float().numpy()
        if name == "weight_v" or (name == "weight" and arr.ndim >= 2 and path[-1:] != ("emb_g",)):
            leaf = "v" if name == "weight_v" else "w"
            arr = _kernel_to_jax(path, arr)
        elif name == "weight_g":
            leaf = "g"
            arr = arr.reshape(1, -1, 1) if _is_transposed(path) else arr.reshape(-1)
        elif name == "weight":
            leaf = "embedding"
        elif name == "bias":
            leaf = "b"
        else:
            leaf = name
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = arr.copy()  # C order, a 0-d leaf kept 0-d
    return tree
