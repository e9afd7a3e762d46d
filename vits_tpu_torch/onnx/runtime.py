"""An evaluator of ONNX models on torch tensors (counterpart of
vits_tpu/onnx/runtime.py): the same op set, with the same semantics per
node, on an explicit device.

It is the check of an exported file that needs no onnxruntime: an
implementation of the ONNX op semantics that is independent of the
converter (vits_tpu_torch/onnx/convert.py), so a translation fault cannot
certify itself, and fast enough on the card to evaluate the full-width
graphs that the numpy evaluator takes minutes over.

Semantics follow the ONNX operator spec (opset 17), as the JAX package's
evaluator implements them: numpy-style broadcasting for elementwise ops,
Slice clamping (negative steps included), Reshape's 0 and -1 entries,
integer Div truncating toward zero. Conv, Einsum and MatMul accumulate in
float64 and return the inputs' dtype. An op outside the set raises, naming
it. Every tensor stays on the given device (`cuda` unless "cpu" is asked
for); the values of shape-like inputs (Reshape's shape, Slice's starts, ...)
are read to the host, as any evaluator must to size its outputs.
"""

from __future__ import annotations

from typing import Dict, Optional, Union

import numpy as np
import torch
import torch.nn.functional as F

from vits_tpu_torch.device import resolve_device
from vits_tpu_torch.onnx import proto

TORCH_OF = {
    proto.FLOAT: torch.float32, proto.DOUBLE: torch.float64, proto.FLOAT16: torch.float16,
    proto.INT8: torch.int8, proto.UINT8: torch.uint8, proto.INT16: torch.int16,
    proto.INT32: torch.int32, proto.INT64: torch.int64, proto.BOOL: torch.bool,
}


def _ints(t) -> list:
    return [int(v) for v in t.reshape(-1).tolist()]


def _slice(data, starts, ends, axes=None, steps=None):
    starts, ends = _ints(starts), _ints(ends)
    axes = list(range(len(starts))) if axes is None else _ints(axes)
    steps = [1] * len(starts) if steps is None else _ints(steps)
    for st, en, ax, sp in zip(starts, ends, axes, steps):
        ax = ax % data.dim()
        dim = data.shape[ax]
        if sp > 0:  # ONNX clamping: into [0, dim]
            st = min(max(st + dim if st < 0 else st, 0), dim)
            en = min(max(en + dim if en < 0 else en, 0), dim)
        else:  # into [0, dim - 1] for the start; an end below -dim runs off the front
            st = min(max(st + dim if st < 0 else st, 0), dim - 1)
            en = -1 if en < -dim else min(max(en + dim if en < 0 else en, -1), dim - 1)
        if sp == 1:
            data = data.narrow(ax, st, max(en - st, 0))
        else:
            idx = torch.arange(st, en, sp, device=data.device)
            data = data.index_select(ax, idx)
    return data


def _reshape(data, shape):
    out = [data.shape[i] if d == 0 else d for i, d in enumerate(_ints(shape))]
    return data.reshape(out)


def _unsqueeze(data, axes):
    rank = data.dim() + len(axes)
    for ax in sorted(a % rank for a in axes):
        data = data.unsqueeze(ax)
    return data


def _conv(x, w, b=None, dilations=None, group=1, pads=None, strides=None):
    if x.dim() != 3:
        raise NotImplementedError("only 1-D Conv is emitted")
    (d,), (s,) = dilations or [1], strides or [1]
    lo, hi = pads or [0, 0]
    y = F.conv1d(F.pad(x.double(), (lo, hi)), w.double(),
                 None if b is None else b.double(), stride=s, dilation=d, groups=group)
    return y.to(x.dtype)


def _gather(data, indices, axis=0):
    axis = axis % data.dim()
    idx = indices.long()
    idx = torch.where(idx < 0, idx + data.shape[axis], idx)
    out = data.index_select(axis, idx.reshape(-1))
    return out.reshape(data.shape[:axis] + idx.shape + data.shape[axis + 1:])


def _div(a, b):
    if a.dtype.is_floating_point or b.dtype.is_floating_point:
        return a / b
    return torch.div(a, b, rounding_mode="trunc")


def _binary(fn):
    def op(a, b):
        dt = torch.result_type(a, b)
        return fn(a.to(dt), b.to(dt))
    return op


_BINOPS = {
    "Add": torch.add, "Sub": torch.sub, "Mul": torch.mul, "Div": _div, "Pow": torch.pow,
    "Max": _binary(torch.maximum), "Min": _binary(torch.minimum),
    "Less": torch.lt, "LessOrEqual": torch.le, "Greater": torch.gt,
    "GreaterOrEqual": torch.ge, "Equal": torch.eq,
    "And": torch.logical_and, "Or": torch.logical_or, "Xor": torch.logical_xor,
}

_UNOPS = {
    "Exp": torch.exp, "Log": torch.log, "Tanh": torch.tanh, "Neg": torch.neg,
    "Sqrt": torch.sqrt, "Reciprocal": torch.reciprocal, "Abs": torch.abs,
    "Floor": torch.floor, "Ceil": torch.ceil, "Sign": torch.sign, "Not": torch.logical_not,
    "Identity": lambda x: x, "Sin": torch.sin, "Cos": torch.cos, "Sigmoid": torch.sigmoid,
    "Erf": torch.erf, "Round": torch.round,
}


def _reduce(fn, x, axes, keepdims):
    if axes is None:
        axes = list(range(x.dim()))
    return fn(x, dim=tuple(axes), keepdim=bool(keepdims)) if axes else x


def _eval_node(n: dict, iv: list):
    """Evaluate one parsed NodeProto on tensors."""
    op, at = n["op_type"], n["attrs"]
    if op in _BINOPS:
        return _BINOPS[op](iv[0], iv[1])
    if op in _UNOPS:
        return _UNOPS[op](iv[0])
    if op == "Where":
        return torch.where(iv[0], iv[1], iv[2])
    if op == "Cast":
        return iv[0].to(TORCH_OF[at["to"]])
    if op == "Reshape":
        return _reshape(iv[0], iv[1])
    if op == "Squeeze":
        rank = iv[0].dim()
        return iv[0].squeeze(tuple(a % rank for a in _ints(iv[1])))
    if op == "Unsqueeze":
        return _unsqueeze(iv[0], _ints(iv[1]))
    if op == "Transpose":
        perm = at.get("perm") or list(reversed(range(iv[0].dim())))
        return iv[0].permute(*perm)
    if op == "Expand":  # numpy-style broadcast of both shapes
        shape = torch.broadcast_shapes(iv[0].shape, tuple(_ints(iv[1])))
        return iv[0].expand(shape).clone()
    if op == "Slice":
        return _slice(iv[0], iv[1], iv[2], iv[3] if len(iv) > 3 else None,
                      iv[4] if len(iv) > 4 else None)
    if op == "Concat":
        return torch.cat(iv, dim=at["axis"])
    if op == "Pad":
        pads = _ints(iv[1])
        half = len(pads) // 2
        torch_pads = []
        for ax in reversed(range(half)):
            torch_pads += [pads[ax], pads[half + ax]]
        value = iv[2].item() if len(iv) > 2 and iv[2] is not None else 0
        return F.pad(iv[0], torch_pads, value=value)
    if op == "Einsum":
        return torch.einsum(at["equation"], *[v.double() for v in iv]).to(iv[0].dtype)
    if op == "MatMul":
        return torch.matmul(iv[0].double(), iv[1].double()).to(iv[0].dtype)
    if op == "Conv":
        return _conv(iv[0], iv[1], iv[2] if len(iv) > 2 else None,
                     dilations=at.get("dilations"), group=at.get("group", 1),
                     pads=at.get("pads"), strides=at.get("strides"))
    if op == "Gather":
        return _gather(iv[0], iv[1], axis=at.get("axis", 0))
    if op == "Shape":
        return torch.tensor(list(iv[0].shape), dtype=torch.int64, device=iv[0].device)
    if op == "ReduceSum":
        return _reduce(torch.sum, iv[0], _ints(iv[1]) if len(iv) > 1 else None,
                       at.get("keepdims", 1))
    if op == "ReduceMax":
        return _reduce(torch.amax, iv[0], at.get("axes"), at.get("keepdims", 1))
    if op == "ReduceMin":
        return _reduce(torch.amin, iv[0], at.get("axes"), at.get("keepdims", 1))
    if op == "CumSum":
        if at.get("reverse"):
            raise NotImplementedError("reverse CumSum")
        return torch.cumsum(iv[0], dim=int(iv[1].item()))
    if op == "Mod":
        return torch.fmod(iv[0], iv[1]) if at.get("fmod") else torch.remainder(iv[0], iv[1])
    if op == "Range":
        return torch.arange(iv[0].item(), iv[1].item(), iv[2].item(), dtype=iv[0].dtype,
                            device=iv[0].device)
    raise NotImplementedError(f"op {op}")


def to_tensor(value, device) -> torch.Tensor:
    """A numpy array or a tensor as a tensor on `device`."""
    if isinstance(value, torch.Tensor):
        return value.to(device)
    return torch.from_numpy(np.array(value, copy=True)).to(device)


@torch.no_grad()
def run_model(model_bytes: bytes, inputs: Dict[str, object],
              device: Optional[Union[str, torch.device]] = None) -> Dict[str, torch.Tensor]:
    """Evaluate a serialized ONNX model on `inputs` ({name: numpy array or
    tensor}) on `device` (`resolve_device`: cuda unless "cpu" is asked for).
    Returns {output name: tensor on that device}."""
    dev = resolve_device(device)
    g = proto.parse_model(model_bytes)["graph"]
    env = {k: to_tensor(v, dev) for k, v in inputs.items()}
    for t in g["initializer"]:
        env[t["name"]] = to_tensor(proto.tensor_to_np(t), dev)
    for vi in g["input"]:
        if vi["name"] not in env:
            raise ValueError(f"missing input {vi['name']}")
    for n in g["node"]:
        try:
            iv = [env[x] if x else None for x in n["input"]]
        except KeyError as e:
            raise KeyError(f"node {n['name']} ({n['op_type']}): missing input {e}")
        try:
            out = _eval_node(n, iv)
        except Exception as e:
            shapes = [None if v is None else tuple(v.shape) for v in iv]
            raise type(e)(f"node {n['name']} ({n['op_type']}) inputs {shapes} "
                          f"attrs {n['attrs']}: {e}") from e
        for name, o in zip(n["output"], out if isinstance(out, tuple) else (out,)):
            env[name] = o
    return {vi["name"]: env[vi["name"]] for vi in g["output"]}
