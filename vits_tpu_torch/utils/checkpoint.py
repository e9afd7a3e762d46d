"""Checkpoint files of the JAX package (counterpart of the npz half of
vits_tpu/utils/checkpoint.py): a `.npz` of path-flattened parameter leaves,
keys joined by "//", plus `__step__` / `__epoch__` scalars. Read and written
with numpy alone; the nested dicts feed `vits_tpu_torch.convert`."""

from __future__ import annotations

import os
from typing import Any, Dict, Tuple

import numpy as np

from vits_tpu_torch.utils.summary import logger

SEP = "//"


def unflatten(flat: Dict[str, np.ndarray]) -> Dict[str, Any]:
    """{"a//b//c": leaf} -> {"a": {"b": {"c": leaf}}}. The None / empty-list
    markers carry no array and are dropped (parameter trees have none)."""
    tree: Dict[str, Any] = {}
    for key, arr in flat.items():
        parts = key.split(SEP)
        if parts[-1] in ("__none__", "__empty__"):
            continue
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = arr
    return tree


def read_checkpoint(path: str) -> Tuple[Dict[str, Any], int, int]:
    """Returns (state tree of numpy arrays, step, epoch)."""
    with np.load(path, allow_pickle=False) as z:
        flat = {k: z[k] for k in z.files}
    step = int(flat.pop("__step__", 0))
    epoch = int(flat.pop("__epoch__", 1))
    extra = [k for k in flat if k.startswith("__extra__")]
    for k in extra:
        flat.pop(k)
    logger.info("Read checkpoint '%s' (step %d)", path, step)
    return unflatten(flat), step, epoch


def _flatten(tree, prefix="") -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        key = f"{prefix}{SEP}{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(_flatten(v, key))
        else:
            out[key] = np.asarray(v)
    return out


def write_checkpoint(path: str, tree: Dict[str, Any], step: int = 0, epoch: int = 1):
    """Write a nested dict of arrays in the same flat-path npz format."""
    flat = _flatten(tree)
    flat["__step__"] = np.asarray(step)
    flat["__epoch__"] = np.asarray(epoch)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **flat)
    os.replace(tmp, path)
