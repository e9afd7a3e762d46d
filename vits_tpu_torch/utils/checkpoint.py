"""Checkpoint files of the JAX package (counterpart of
vits_tpu/utils/checkpoint.py): a `.npz` of path-flattened leaves, keys
joined by "//", plus `__step__` / `__epoch__` scalars and optional
`__extra__//<name>` entries; an empty node is written as
`<path>//__empty__`. Trees are nested dicts of numpy arrays in the JAX
package's layout (`vits_tpu_torch.convert` maps them to and from the port's
modules and optimizers), so either package reads the other's files.

`load_checkpoint` merges a file into a template tree as the JAX package
does: a leaf missing from the file, or of another shape, keeps the
template's value and is logged. `latest_checkpoint_path` sorts by the
digits of the file name; `greedy_soup` averages the last checkpoints;
`prune_checkpoints` keeps the newest.
"""

from __future__ import annotations

import glob
import os
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from vits_tpu_torch.utils.summary import logger

SEP = "//"
MARKERS = ("__none__", "__empty__")


def unflatten(flat: Dict[str, np.ndarray]) -> Dict[str, Any]:
    """{"a//b//c": leaf} -> {"a": {"b": {"c": leaf}}}. The None / empty
    markers carry no array and are dropped."""
    tree: Dict[str, Any] = {}
    for key, arr in flat.items():
        parts = key.split(SEP)
        if parts[-1] in MARKERS:
            continue
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = arr
    return tree


def _read_flat(path: str) -> Tuple[Dict[str, np.ndarray], int, int]:
    with np.load(path, allow_pickle=False) as z:
        flat = {k: z[k] for k in z.files}
    step = int(flat.pop("__step__", 0))
    epoch = int(flat.pop("__epoch__", 1))
    return flat, step, epoch


def read_checkpoint(path: str) -> Tuple[Dict[str, Any], int, int]:
    """Returns (the whole state tree of numpy arrays, step, epoch)."""
    flat, step, epoch = _read_flat(path)
    flat = {k: v for k, v in flat.items() if not k.startswith("__extra__")}
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


def save_checkpoint(path: str, tree: Dict[str, Any], step: int = 0, epoch: int = 1,
                    extra: Optional[Dict[str, Any]] = None):
    """Write a nested dict of arrays, atomically (a temporary file renamed
    over `path`)."""
    flat = _flatten(tree)
    flat["__step__"] = np.asarray(step)
    flat["__epoch__"] = np.asarray(epoch)
    for k, v in (extra or {}).items():
        flat[f"__extra__{SEP}{k}"] = np.asarray(v)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **flat)
    os.replace(tmp, path)
    logger.info("Saved checkpoint at step %d to %s", step, path)


def load_into(template: Dict[str, Any], flat: Dict[str, np.ndarray], prefix="") -> Dict:
    """Fill a template tree from a flat dict: a leaf missing from it, or of
    another shape, keeps the template's value (logged)."""
    if isinstance(template, dict):
        return {k: load_into(v, flat, f"{prefix}{SEP}{k}" if prefix else str(k))
                for k, v in template.items()}
    t = np.asarray(template)
    if prefix not in flat:
        logger.info("%s is not in the checkpoint", prefix)
        return template
    arr = flat[prefix]
    if arr.shape != t.shape:
        logger.info("%s: shape %s != %s; keeping current", prefix, arr.shape, t.shape)
        return template
    return np.asarray(arr, dtype=t.dtype)


def load_checkpoint(path: str, template: Dict[str, Any]):
    """Returns (the template filled from the file, step, epoch)."""
    flat, step, epoch = _read_flat(path)
    state = load_into(template, flat)
    logger.info("Loaded checkpoint '%s' (step %d)", path, step)
    return state, step, epoch


def checkpoint_paths_sorted(dir_path: str, regex: str = "G_*.npz") -> List[str]:
    f_list = glob.glob(os.path.join(dir_path, regex))
    f_list.sort(key=lambda f: int("".join(filter(str.isdigit, os.path.basename(f))) or 0))
    return f_list


def latest_checkpoint_path(dir_path: str, regex: str = "G_*.npz") -> Optional[str]:
    f_list = checkpoint_paths_sorted(dir_path, regex)
    return f_list[-1] if f_list else None


def _tree_map(fn, *trees):
    if isinstance(trees[0], dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def greedy_soup(paths: List[str], template: Dict[str, Any], greedy: int = 5):
    """The mean of the last `greedy` checkpoints' trees (each merged into
    `template`), summed in float64, in the template's dtypes."""
    paths = paths[-greedy:] if greedy > 0 else paths[-1:]
    acc = None
    for p in paths:
        state, _, _ = load_checkpoint(p, template)
        if acc is None:
            acc = _tree_map(lambda a: np.asarray(a, np.float64), state)
        else:
            acc = _tree_map(lambda a, b: a + np.asarray(b, np.float64), acc, state)
    n = len(paths)
    return _tree_map(lambda a, t: (a / n).astype(np.asarray(t).dtype), acc, template)


def prune_checkpoints(dir_path: str, keep: int = 5, regex: str = "G_*.npz"):
    """Delete all but the newest `keep` checkpoints matching `regex`."""
    paths = checkpoint_paths_sorted(dir_path, regex)
    for p in paths[:-keep] if keep > 0 else []:
        try:
            os.remove(p)
        except OSError:
            pass
