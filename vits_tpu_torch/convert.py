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
  spectral norm "w_orig" as "w"         weight_orig
  spectral norm "u"  (out,)             weight_u (a buffer)
  "b"                                   bias
  Embedding "embedding" (n, d)          weight (n, d)
  "gamma", "beta", "alpha"              unchanged

A {"g", "v"} pair goes to `weight_g`/`weight_v` when the target model has
them (a training model, `Synthesizer.from_hps(hps, train=True)`, the
discriminators) and is folded into `weight` otherwise (serving). The
posterior encoder "enc_q" is dropped for a model without one. The
discriminator tree is {"discriminators": {"0": S, "1".."5": P}} (the MPD)
or {"mwd": {"discriminators": {i: {"convs": ...}}}, "mfd": ...} (the MRD);
the duration discriminator's {"pre_x", "pre_d", "convs": {"0".."3"}, "out"}.

Optimizer state (`optimizer_to_jax` / `optimizer_from_jax`): the JAX
package's optax `inject_hyperparams` AdamW or RAdam state (both keep their
count and moments at the same places), path-flattened as its checkpoints
hold it, <-> `torch.optim.AdamW`'s or `torch.optim.RAdam`'s:

  "0"                    the inject count          the step count
  "1": {"learning_rate"} the last update's lr      param_groups' lr
  "3": {"0": {"0"        Adam's count              each state's "step"
              "1": tree  mu                        "exp_avg"
              "2": tree  nu                        "exp_avg_sq"},
        "1", "2"         empty states (the decay, which is stateless, and
                         the lr scale), written as "__empty__" markers

Each moment takes its parameter's layout transform. A parameter without
torch state (torch makes it at the first step) is written as zeros with
count 0. The JAX tree holds moments for every spectral-norm u as well,
exactly zero there (u is outside the gradient); the port writes zeros in
those places and ignores them on read.
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
        state[".".join(path + (name,))] = torch.tensor(np.array(arr, order="C"))  # 0-d kept

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
            if k in ("w", "w_orig"):
                put(path, "weight" if k == "w" else "weight_orig", _kernel_to_torch(path, arr))
            elif k == "u":
                put(path, "weight_u", arr)
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
    (a training state goes back to the JAX package's training tree),
    `weight_orig`/`weight_u` {"w_orig", "u"}, a plain `weight` "w" (or
    "embedding" under emb_g)."""
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
        elif name == "weight":
            leaf = "embedding"
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


def optimizer_to_jax(opt: torch.optim.Optimizer, model: nn.Module) -> Dict:
    """The AdamW or RAdam state `opt` keeps for `model`'s parameters, as the
    JAX package's optimizer tree (numpy, its layouts), with zero moments for
    the spectral-norm u buffers."""
    mu, nu, counts = {}, {}, set()
    for name, p in model.named_parameters():
        st = opt.state.get(p, {})
        if st:
            counts.add(int(st["step"]))
            mu[name], nu[name] = st["exp_avg"], st["exp_avg_sq"]
        else:
            counts.add(0)
            mu[name] = nu[name] = torch.zeros_like(p)
    for name, b in model.named_buffers():
        if name.endswith("weight_u"):
            mu[name] = nu[name] = torch.zeros_like(b)
    if len(counts) != 1:
        raise ValueError(f"the parameters' step counts differ: {sorted(counts)}")
    count = np.asarray(counts.pop(), np.int32)
    empty = {"__empty__": np.zeros(0)}
    return {"0": count.copy(),
            "1": {"learning_rate": np.asarray(opt.param_groups[0]["lr"], np.float32)},
            "3": {"0": {"0": count, "1": params_to_jax(mu), "2": params_to_jax(nu)},
                  "1": dict(empty), "2": dict(empty)}}


def optimizer_from_jax(tree: Dict, opt: torch.optim.Optimizer, model: nn.Module):
    """Set `opt`'s state for `model`'s parameters from a JAX optimizer tree
    (`optimizer_to_jax`'s layout): each moment in its parameter's layout,
    on its device, the step count and the learning rate."""
    adam = tree["3"]["0"]
    keys = set(model.state_dict())
    mu, nu = state_from_jax(adam["1"], keys), state_from_jax(adam["2"], keys)
    step = float(np.asarray(adam["0"]))
    for name, p in model.named_parameters():
        opt.state[p] = {"step": torch.tensor(step, dtype=torch.float32),
                        "exp_avg": mu[name].reshape(p.shape).to(p.device, p.dtype),
                        "exp_avg_sq": nu[name].reshape(p.shape).to(p.device, p.dtype)}
    for group in opt.param_groups:
        group["lr"] = float(np.asarray(tree["1"]["learning_rate"]))
