"""Reference PyTorch checkpoints -> the JAX package's parameter tree (own
copy of the load half of vits_tpu/utils/torch_compat.py, in numpy).

The reference ships `.pth` files holding `{"model": state_dict, ...}`. The
JAX parameter tree mirrors the reference's module paths (for example
`enc_p.encoder.attn_layers.0.conv_q`), so loading is a per-leaf rename and
layout transpose into a template tree:

  torch layout                         JAX tree
  Linear        (out, in)           -> (in, out)
  Conv1d        (out, in/groups, k) -> (k, in/groups, out)
  ConvTranspose (in, out, k)        -> (k, in, out)
  Conv2d        (out, in, kh, kw)   -> (kh, kw, in, out)
  weight_g      (out, 1, ...)       -> the template's g shape (reshape only)
  LayerNorm w/b (nn.LayerNorm)      -> gamma/beta
  Embedding     (n, d)              -> (n, d)

The filled tree goes through `vits_tpu_torch.convert.params_from_jax` as a
`.npz` tree does, which folds the weight-norm (g, v) pairs for serving.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, Mapping

import numpy as np
import torch

from vits_tpu_torch.convert import params_to_jax
from vits_tpu_torch.utils.summary import logger


def _to_numpy(t) -> np.ndarray:
    if isinstance(t, np.ndarray):
        return t
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    return np.asarray(t)


def _convert(key: str, arr: np.ndarray, target_shape) -> np.ndarray:
    if key.endswith("weight_g"):
        return arr.reshape(target_shape)  # norm scales: reshape only
    if arr.ndim <= 1:
        return arr.reshape(target_shape)
    if arr.ndim == 2:
        return arr.transpose(1, 0)
    if arr.ndim == 3:
        if ".ups." in key and key.endswith(("weight", "weight_v")):
            return arr.transpose(2, 0, 1)  # ConvTranspose (in,out,k)->(k,in,out)
        return arr.transpose(2, 1, 0)      # Conv1d (out,in,k)->(k,in,out)
    if arr.ndim == 4:
        return arr.transpose(2, 3, 1, 0)   # Conv2d
    raise ValueError(f"cannot convert {key} with shape {arr.shape} -> {target_shape}")


_LEAF_MAP = {"weight_g": "g", "weight_v": "v",
             "gamma": "gamma", "beta": "beta", "m": "m", "logs": "logs"}


def _resolve_leaf_name(node: Mapping[str, Any], torch_leaf: str) -> str:
    if torch_leaf == "bias":
        return "beta" if ("beta" in node and "b" not in node) else "b"
    if torch_leaf in _LEAF_MAP:
        return _LEAF_MAP[torch_leaf]
    if torch_leaf == "weight":
        if "gamma" in node:      # nn.LayerNorm weight
            return "gamma"
        if "embedding" in node:  # nn.Embedding weight, no transpose
            return "embedding"
        if "weight" in node:     # Swish learned scalar
            return "weight"
        if "v" in node:          # plain torch weight loaded into a weight-norm slot
            return "v"
        return "w"
    return torch_leaf


def params_template(hps) -> Dict[str, Any]:
    """The JAX parameter tree of `hps`'s synthesizer (posterior encoder and
    weight-norm g/v pairs included, as `init_params` gives it) with zero
    leaves: the slots a reference state_dict fills. Built from the port's
    training model on the meta device, so no weights are initialised."""
    from vits_tpu_torch.models.synthesizer import Synthesizer
    with torch.device("meta"):
        model = Synthesizer.from_hps(hps, train=True)
    return params_to_jax({k: torch.zeros(v.shape) for k, v in model.state_dict().items()})


def load_torch_state_dict(state_dict: Mapping[str, Any], target_params: Dict[str, Any],
                          strict: bool = False, verbose: bool = False) -> Dict[str, Any]:
    """Fill a copy of target_params from a torch state_dict.

    Missing keys keep the template's values (zeros from `params_template`)
    and are logged, as the reference's tolerant key-union merge keeps a
    model's own values. Unknown torch keys raise only when strict."""
    params = copy.deepcopy(target_params)
    filled = set()
    for key, tensor in state_dict.items():
        arr = _to_numpy(tensor)
        path = key.split(".")
        node = params
        ok = True
        for seg in path[:-1]:
            if not isinstance(node, Mapping) or seg not in node:
                ok = False
                break
            node = node[seg]
        if ok:
            leaf = _resolve_leaf_name(node, path[-1])
            ok = isinstance(node, Mapping) and leaf in node
        if not ok:
            msg = f"torch key {key} has no target slot"
            if strict:
                raise KeyError(msg)
            if verbose:
                print(msg)
            continue
        tgt = node[leaf]
        if leaf == "embedding":
            conv = arr.reshape(np.shape(tgt))
        else:
            conv = _convert(key, arr, np.shape(tgt))
        node[leaf] = np.asarray(conv, dtype=np.asarray(tgt).dtype)
        filled.add((tuple(path[:-1]), leaf))
    missing = sorted(_leaf_paths(params) - filled)
    if missing:
        logger.warning("%d parameter(s) missing from the torch state_dict keep the "
                       "template's values, e.g. %s", len(missing),
                       ".".join(missing[0][0] + (missing[0][1],)))
    if verbose:
        print(f"loaded {len(filled)}/{len(state_dict)} torch tensors")
    return params


def _leaf_paths(tree, prefix=()):
    out = set()
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out |= _leaf_paths(v, prefix + (k,))
        else:
            out.add((prefix, k))
    return out


def load_torch_checkpoint(path: str, target_params: Dict[str, Any], **kw) -> Dict[str, Any]:
    """Load a reference .pth checkpoint file ({'model': state_dict, ...});
    tensors and plain containers only (`weights_only`)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    state = ckpt.get("model", ckpt)
    return load_torch_state_dict(state, target_params, **kw)
