"""`torch.export` program -> ONNX graph (opset 17), written with the
dependency-free writer of `vits_tpu_torch.onnx.proto`.

The JAX package walks a jaxpr (vits_tpu/onnx/convert.py); this converter
walks the FX graph of an `ExportedProgram` instead, node by node. Design:

- Input: `torch.export.export` of the phase, then `run_decompositions()`,
  which leaves core ATen ops only.
- Lifted parameters, buffers and tensor constants are bound to numpy and
  become initializers (named by their module paths) where a node reads them.
  The exporter folds weight norm before tracing (`export_model`), as the
  JAX export folds it, so only plain kernels appear.
- A node whose inputs are all constants is evaluated at export time with
  torch on the host: layout ops (permute, view, slice, flip, cat, ...)
  always, any other op while its result stays within 4 MiB (`_FOLD_CAP`,
  the JAX converter's cap), so weight transposes and flips, the transposed
  convs' kernels and the position table's casts never reach the graph.
- Symbolic sizes: every symbolic dim of the trace is a sympy expression of
  the input sizes. Where a node needs one at run time (`sym_size`, a
  reshape or slice bound), it becomes `Shape` + `Gather` of the graph input
  that carries it. A reshape with
  a single symbolic entry writes it as -1; with more, its shape is a
  `Concat` of constants and run-time dims. So p1 stays length-dynamic.
- `_assert_tensor_metadata` and other no-op nodes are dropped; clone,
  alias and detach pass their input through.
- Every emitted node is an op of the JAX package's evaluator
  (vits_tpu/onnx/runtime.py), so both packages' evaluators run both
  packages' files. The ops that set lacks are lowered:
    softmax -> ReduceMax, Sub, Exp, ReduceSum, Div;
    layer norm -> ReduceSum means of x and of the squared deviation, Sqrt,
      Reciprocal, the affine;
    relu -> Max with 0; leaky_relu -> Where(x > 0, x, x * slope);
    addmm, bmm -> MatMul (+ Add);
    embedding -> Gather;
    flip -> Slice with step -1;
    full_like -> Expand of a scalar to the input's shape;
    the transposed conv (the decoder's upsamples) -> zero insertion
      (Unsqueeze, Pad, Reshape: u - 1 zeros after each frame) and a Conv
      with the kernel transposed and flipped at export time, padded k - 1 - p
      on the left and k - 1 - p - (u - 1) on the right (a padding past
      k - u, which no length-preserving upsample has, raises).
- An ATen op without a mapping raises, naming it. There is no fallback.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import operator
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import sympy
import torch
from torch.export.graph_signature import InputKind

from vits_tpu_torch.onnx import proto

# fold results larger than this (bytes) are emitted as nodes instead (they
# would bloat the file), as the JAX converter does
_FOLD_CAP = 1 << 22
_INT64_MAX = (1 << 63) - 1
_INT64_MIN = -(1 << 63)

aten = torch.ops.aten
# ops folded on constant inputs whatever the size: they move or cut data
_LAYOUT = {aten.permute.default, aten.view.default, aten.slice.Tensor,
           aten.unsqueeze.default, aten.flip.default, aten.cat.default,
           aten.embedding.default}
_PASS = {aten.clone.default, aten.alias.default, aten.detach.default,
         aten.lift_fresh_copy.default}
_DROP = {aten._assert_tensor_metadata.default, aten._assert_scalar.default,
         aten.sym_constrain_range_for_size.default}
_NP_OF = {torch.float32: np.float32, torch.float64: np.float64, torch.float16: np.float16,
          torch.int64: np.int64, torch.int32: np.int32, torch.int16: np.int16,
          torch.int8: np.int8, torch.uint8: np.uint8, torch.bool: np.bool_}


@dataclasses.dataclass
class Sym:
    """A tensor of the ONNX graph: its name, shape (ints, and sympy
    expressions for symbolic dims) and numpy dtype."""
    name: str
    shape: tuple
    dtype: Any


@dataclasses.dataclass(frozen=True)
class SymDim:
    """A symbolic size (a SymInt of the trace) as a sympy expression."""
    expr: Any


def _np_dtype(dt: torch.dtype):
    if dt not in _NP_OF:
        raise NotImplementedError(f"dtype {dt} has no ONNX mapping here")
    return np.dtype(_NP_OF[dt])


def _dim(d):
    """An int for a concrete size, else its sympy expression."""
    if isinstance(d, int):
        return d
    expr = d.node.expr
    return int(expr) if isinstance(expr, sympy.Integer) else expr


def _hint(d) -> int:
    return d if isinstance(d, int) else int(d.node.hint)


class Builder:
    """Nodes and initializers of the graph being written."""

    def __init__(self):
        self.nodes: List[bytes] = []
        self.initializers: List[bytes] = []
        self._small = {}
        self._large = {}
        self._n = 0

    def fresh(self, hint="v") -> str:
        self._n += 1
        return f"{hint}_{self._n}"

    def node(self, op: str, inputs, hint: Optional[str] = None, **attrs) -> str:
        out = self.fresh(hint or op.lower())
        self.nodes.append(proto.node(op, inputs, [out], name=self.fresh(op.lower()), **attrs))
        return out

    def initializer(self, arr: np.ndarray, hint="c") -> str:
        arr = np.asarray(arr, order="C")  # ascontiguousarray promotes 0-d
        if arr.nbytes <= 1024:  # small constants deduplicated by content
            key = (arr.dtype.str, arr.shape, hashlib.sha1(arr.tobytes()).hexdigest())
            cache = self._small
        else:  # large ones by identity
            key, cache = id(arr), self._large
        if key in cache:
            return cache[key][0]
        name = self.fresh(hint)
        self.initializers.append(proto.tensor_proto(name, arr))
        cache[key] = (name, arr)
        return name

    def ints(self, vals, hint="c") -> str:
        return self.initializer(np.asarray(vals, np.int64), hint)


class Converter:
    """Walks one decomposed ExportedProgram and writes its ONNX graph."""

    def __init__(self, ep, input_names: Sequence[str]):
        self.ep, self.b = ep, Builder()
        self.env: Dict[str, Any] = {}
        self.hints: Dict[int, str] = {}
        self.dims: Dict[Any, str] = {}    # sympy expression -> (1,) int64 tensor
        self.sources: Dict[Any, tuple] = {}  # symbol -> (input tensor name, axis)
        self.input_names = list(input_names)

    # ------------------------------------------------------------ values
    def const(self, v, dtype=None) -> str:
        """An initializer for a constant (array or Python scalar)."""
        arr = np.asarray(v) if dtype is None else np.asarray(v, dtype=dtype)
        return self.b.initializer(arr, self.hints.get(id(v), "c"))

    def name(self, v, dtype=None) -> str:
        if isinstance(v, Sym):
            if dtype is not None and np.dtype(dtype) != v.dtype:
                return self.b.node("Cast", [v.name], to=proto.NP_TO_ONNX[np.dtype(dtype)])
            return v.name
        if isinstance(v, SymDim):
            return self.dim(v.expr)
        return self.const(v, dtype)

    def dim(self, expr) -> str:
        """A (1,) int64 tensor holding the run-time value of the symbolic
        size `expr`, read from the graph input that carries it."""
        if expr in self.dims:
            return self.dims[expr]
        if not isinstance(expr, sympy.Symbol) or expr not in self.sources:
            raise NotImplementedError(f"symbolic size {expr} is not a size of any input")
        src, axis = self.sources[expr]
        shape = self.b.node("Shape", [src], "shape")
        out = self.b.node("Gather", [shape, self.b.ints([axis])], "dim", axis=0)
        self.dims[expr] = out
        return out

    def sym(self, node, name: str) -> Sym:
        v = node.meta["val"]
        return Sym(name, tuple(_dim(d) for d in v.shape), _np_dtype(v.dtype))

    def shape_tensor(self, entries) -> str:
        """Reshape's shape input from ints and sympy entries: one symbolic
        entry becomes -1, more a Concat of run-time dims."""
        sym = [i for i, e in enumerate(entries) if not isinstance(e, int)]
        if not sym:
            return self.b.ints(entries, "shape")
        if len(sym) == 1:
            return self.b.ints([-1 if i in sym else e for i, e in enumerate(entries)], "shape")
        parts = [self.dim(e) if not isinstance(e, int) else self.b.ints([e])
                 for e in entries]
        return self.b.node("Concat", parts, "shape", axis=0)

    def _arg(self, a):
        """An FX argument resolved to constants, Syms and SymDims."""
        if isinstance(a, torch.fx.Node):
            return self.env[a.name]
        if isinstance(a, (list, tuple)):
            return type(a)(self._arg(x) for x in a)
        if isinstance(a, (torch.SymInt,)):
            return SymDim(_dim(a))
        return a

    # ------------------------------------------------------------ the walk
    def run(self, output_names: Sequence[str]):
        sig = self.ep.graph_signature
        consts = {**self.ep.state_dict, **self.ep.constants}
        users = iter(self.input_names)
        lifted = {}
        for spec in sig.input_specs:
            if spec.kind == InputKind.USER_INPUT:
                continue
            if spec.kind not in (InputKind.PARAMETER, InputKind.BUFFER,
                                 InputKind.CONSTANT_TENSOR):
                raise NotImplementedError(f"input kind {spec.kind}")
            lifted[spec.arg.name] = spec.target
        outs = None
        for node in self.ep.graph.nodes:
            if node.op == "placeholder":
                if node.name in lifted:
                    target = lifted[node.name]
                    arr = consts[target].detach().cpu().numpy()
                    self.hints[id(arr)] = target.split(".", 1)[-1]
                    self.env[node.name] = arr
                else:
                    name = next(users)
                    s = self.sym(node, name)
                    for axis, d in enumerate(s.shape):
                        if isinstance(d, sympy.Symbol) and d not in self.sources:
                            self.sources[d] = (name, axis)
                    self.env[node.name] = s
            elif node.op == "call_function":
                self.env[node.name] = self.call(node)
            elif node.op == "output":
                outs = [self._arg(a) for a in node.args[0]]
            else:
                raise NotImplementedError(f"FX node kind {node.op}")
        if next(users, None) is not None:
            raise ValueError("more input names than the program has inputs")
        result = []
        for name, v in zip(output_names, outs):
            self.b.nodes.append(proto.node("Identity", [self.name(v)], [name],
                                           name=self.b.fresh("identity")))
            result.append(v)
        return result

    def call(self, node):
        t = node.target
        if t is operator.getitem:
            return self._arg(node.args[0])[node.args[1]]
        val = node.meta.get("val")
        if isinstance(val, torch.SymInt) or (isinstance(val, int) and t not in _DROP):
            d = _dim(val)
            return d if isinstance(d, int) else SymDim(d)
        if t in _DROP:
            return None
        args = [self._arg(a) for a in node.args]
        kwargs = {k: self._arg(v) for k, v in node.kwargs.items()}
        if t in _PASS:
            return args[0]
        if self._all_const(args, kwargs):
            folded = self._fold(node, t, args, kwargs)
            if folded is not None:
                return folded
        handler = None
        if isinstance(t, torch._ops.OpOverload) and str(t).startswith("aten."):
            handler = getattr(self, "h_" + str(t)[5:].replace(".", "_"), None)
        if handler is None:
            raise NotImplementedError(f"no ONNX mapping for ATen op {t}")
        return handler(node, *args, **kwargs)

    def _all_const(self, args, kwargs) -> bool:
        def const(a):
            if isinstance(a, (list, tuple)):
                return all(const(x) for x in a)
            return not isinstance(a, (Sym, SymDim))
        return const(args) and const(list(kwargs.values()))

    def _fold(self, node, t, args, kwargs):
        val = node.meta.get("val")
        vals = val if isinstance(val, (list, tuple)) else [val]
        nbytes = sum(v.numel() * v.element_size() for v in vals
                     if isinstance(v, torch.Tensor))
        if t not in _LAYOUT and nbytes > _FOLD_CAP:
            return None

        def host(a):
            if isinstance(a, np.ndarray):
                return torch.from_numpy(np.array(a))
            if isinstance(a, (list, tuple)):
                return type(a)(host(x) for x in a)
            if isinstance(a, torch.device):
                return torch.device("cpu")
            return a
        out = t(*host(args), **{k: host(v) for k, v in kwargs.items()})
        if isinstance(out, (list, tuple)):
            return type(out)(o.numpy() for o in out)
        return out.numpy()

    # ------------------------------------------------------------ emission
    # handlers for the core ATen ops of the two phases' graphs (both resblock
    # types and activations); any other op raises in `call`
    def emit(self, node, op: str, inputs, **attrs) -> Sym:
        return self.sym(node, self.b.node(op, inputs, **attrs))

    def _binary(self, node, op, a, b):
        dt = _np_dtype(node.meta["val"].dtype)
        return self.emit(node, op, [self.name(a, dt), self.name(b, dt)])

    def h_add_Tensor(self, node, a, b, alpha=1):
        if alpha != 1:
            raise NotImplementedError("aten.add with alpha")
        return self._binary(node, "Add", a, b)

    def h_sub_Tensor(self, node, a, b, alpha=1):
        if alpha != 1:
            raise NotImplementedError("aten.sub with alpha")
        return self._binary(node, "Sub", a, b)

    def h_mul_Tensor(self, node, a, b):
        return self._binary(node, "Mul", a, b)

    def h_div_Tensor(self, node, a, b, rounding_mode=None):
        if rounding_mode is not None:
            raise NotImplementedError(f"aten.div with rounding_mode={rounding_mode}")
        return self._binary(node, "Div", a, b)

    def h_exp_default(self, node, x):
        return self.emit(node, "Exp", [self.name(x)])

    def h_tanh_default(self, node, x):
        return self.emit(node, "Tanh", [self.name(x)])

    def h_sigmoid_default(self, node, x):
        return self.emit(node, "Sigmoid", [self.name(x)])

    def h_relu_default(self, node, x):
        return self.emit(node, "Max", [self.name(x), self.const(0, x.dtype)])

    def h_leaky_relu_default(self, node, x, slope=0.01):
        pos = self.b.node("Greater", [self.name(x), self.const(0, x.dtype)])
        neg = self.b.node("Mul", [self.name(x), self.const(slope, x.dtype)])
        return self.emit(node, "Where", [pos, self.name(x), neg])

    # shapes ------------------------------------------------------------------
    def h_permute_default(self, node, x, dims):
        rank = len(x.shape)
        return self.emit(node, "Transpose", [self.name(x)], perm=[d % rank for d in dims])

    def h_view_default(self, node, x, sizes):
        entries = [d.expr if isinstance(d, SymDim) else int(d) for d in sizes]
        return self.emit(node, "Reshape", [self.name(x), self.shape_tensor(entries)])

    def h_unsqueeze_default(self, node, x, dim):
        dim = dim % (len(x.shape) + 1)
        return self.emit(node, "Unsqueeze", [self.name(x), self.b.ints([dim], "axes")])

    def _bound(self, v, default):
        if v is None:
            return self.b.ints([default])
        if isinstance(v, SymDim):
            return self.dim(v.expr)
        return self.b.ints([min(int(v), _INT64_MAX)])

    def h_slice_Tensor(self, node, x, dim=0, start=None, end=None, step=1):
        dim = dim % len(x.shape)
        size = x.shape[dim]
        full = end is None or (end.expr == size if isinstance(end, SymDim) else
                               end >= _INT64_MAX or (isinstance(size, int) and end >= size))
        if start in (None, 0) and step == 1 and full:
            return x
        return self.emit(node, "Slice", [self.name(x), self._bound(start, 0),
                                         self._bound(end, _INT64_MAX),
                                         self.b.ints([dim], "axes"),
                                         self.b.ints([step], "steps")])

    def h_flip_default(self, node, x, dims):
        rank = len(x.shape)
        dims = [d % rank for d in dims]
        n = len(dims)
        return self.emit(node, "Slice", [self.name(x), self.b.ints([-1] * n, "starts"),
                                         self.b.ints([_INT64_MIN] * n, "ends"),
                                         self.b.ints(dims, "axes"),
                                         self.b.ints([-1] * n, "steps")])

    def h_cat_default(self, node, tensors, dim=0):
        dt = _np_dtype(node.meta["val"].dtype)
        rank = len(node.meta["val"].shape)
        return self.emit(node, "Concat", [self.name(t, dt) for t in tensors], axis=dim % rank)

    def h_full_like_default(self, node, x, value, **_):
        dt = _np_dtype(node.meta["val"].dtype)
        shape = self.b.node("Shape", [self.name(x)], "shape")
        return self.emit(node, "Expand", [self.const(value, dt), shape])

    # normalisations and contractions -----------------------------------------
    def h__softmax_default(self, node, x, dim, half_to_float=False):
        axis = dim % len(x.shape)
        m = self.b.node("ReduceMax", [self.name(x)], axes=[axis], keepdims=1)
        e = self.b.node("Exp", [self.b.node("Sub", [self.name(x), m])])
        s = self.b.node("ReduceSum", [e, self.b.ints([axis], "axes")], keepdims=1)
        return self.emit(node, "Div", [e, s])

    def h_native_layer_norm_default(self, node, x, normalized_shape, w, b, eps):
        rank, n = len(x.shape), len(normalized_shape)
        axes = self.b.ints(list(range(rank - n, rank)), "axes")
        count = self.const(float(np.prod(normalized_shape)), x.dtype)
        mean = self.b.node("Div", [self.b.node("ReduceSum", [self.name(x), axes], keepdims=1),
                                   count])
        d = self.b.node("Sub", [self.name(x), mean])
        var = self.b.node("Div", [self.b.node("ReduceSum", [self.b.node("Mul", [d, d]), axes],
                                              keepdims=1), count])
        rstd = self.b.node("Reciprocal", [self.b.node("Sqrt", [
            self.b.node("Add", [var, self.const(eps, x.dtype)])])])
        y = self.b.node("Mul", [d, rstd])
        if w is not None:
            y = self.b.node("Mul", [y, self.name(w, x.dtype)])
        if b is not None:
            y = self.b.node("Add", [y, self.name(b, x.dtype)])
        return [Sym(name, tuple(_dim(s) for s in v.shape), x.dtype)
                for name, v in zip((y, mean, rstd), node.meta["val"])]

    def h_addmm_default(self, node, bias, a, b, beta=1, alpha=1):
        if (beta, alpha) != (1, 1):
            raise NotImplementedError("aten.addmm with beta or alpha")
        dt = _np_dtype(node.meta["val"].dtype)
        mm = self.b.node("MatMul", [self.name(a, dt), self.name(b, dt)])
        return self.emit(node, "Add", [mm, self.name(bias, dt)])

    def h_bmm_default(self, node, a, b):
        return self._binary(node, "MatMul", a, b)

    def h_embedding_default(self, node, w, ids, *_):
        return self.emit(node, "Gather", [self.name(w), self.name(ids)], axis=0)

    def h_convolution_default(self, node, x, w, bias, stride, padding, dilation, transposed,
                              output_padding, groups):
        if len(stride) != 1:
            raise NotImplementedError(f"{len(stride)}-D convolution: only 1-D is emitted")
        if not isinstance(w, np.ndarray):
            raise NotImplementedError("a convolution whose kernel is not a constant")
        inputs = [self.name(x)]
        if not transposed:
            inputs.append(self.const(w))
            if bias is not None:
                inputs.append(self.name(bias, x.dtype))
            return self.emit(node, "Conv", inputs, dilations=list(dilation), group=int(groups),
                             pads=[padding[0], padding[0]], strides=list(stride))
        (u,), (p,), (op,), k = stride, padding, output_padding, w.shape[-1]
        left, right = k - 1 - p, k - 1 - p - (u - 1) + op
        if groups != 1 or dilation[0] != 1 or right < 0:
            raise NotImplementedError("a transposed conv with groups, dilation, or padding "
                                      "past k - u")
        x_name = inputs[0]
        if u > 1:  # u - 1 zeros after each frame
            rank = len(x.shape)
            x4 = self.b.node("Unsqueeze", [x_name, self.b.ints([rank], "axes")])
            pads = [0] * (rank + 1) + [0] * rank + [u - 1]
            x4 = self.b.node("Pad", [x4, self.b.ints(pads, "pads"), self.const(0, x.dtype)],
                             mode="constant")
            x_name = self.b.node("Reshape", [x4, self.b.ints([0, 0, -1], "shape")])
        kernel = np.ascontiguousarray(np.transpose(w, (1, 0, 2))[:, :, ::-1])
        self.hints[id(kernel)] = self.hints.get(id(w), "w") + ".as_conv"
        inputs = [x_name, self.const(kernel)]
        if bias is not None:
            inputs.append(self.name(bias, x.dtype))
        return self.emit(node, "Conv", inputs, dilations=[1], group=1, pads=[left, right],
                         strides=[1])


def convert_program(ep, input_names: Sequence[str], output_names: Sequence[str],
                    example_inputs: Sequence[torch.Tensor], dynamic_axes=None,
                    graph_name: str = "graph", doc: str = "") -> bytes:
    """Serialized ModelProto (opset 17, IR 8) of a decomposed ExportedProgram
    whose user inputs are `example_inputs` (their traced shapes; dims named
    in `dynamic_axes` {io name: {axis: dim_param}} are written symbolic in
    the I/O signature) and whose outputs are named `output_names`. The
    model's doc string records the traced input shapes (`traced_shapes=`),
    which `python -m vits_tpu_torch.onnx --run` reads."""
    dynamic_axes = dynamic_axes or {}
    conv = Converter(ep, input_names)
    outs = conv.run(output_names)
    b = conv.b

    def vi(name, shape, dtype):
        dims = list(shape)
        for ax, param in dynamic_axes.get(name, {}).items():
            dims[ax] = param
        return proto.value_info(name, proto.NP_TO_ONNX[np.dtype(dtype)], dims)

    out_specs = [n for n in ep.graph.nodes if n.op == "output"][0].args[0]
    outputs = []
    for name, o, spec in zip(output_names, outs, out_specs):
        if isinstance(o, Sym):
            shape = tuple(_hint(d) for d in spec.meta["val"].shape)
            outputs.append(vi(name, shape, o.dtype))
        else:
            outputs.append(vi(name, np.shape(o), np.asarray(o).dtype))
    inputs = [vi(n, tuple(x.shape), _np_dtype(x.dtype))
              for n, x in zip(input_names, example_inputs)]
    g = proto.graph(b.nodes, graph_name, inputs, outputs, b.initializers)
    traced = {n: [int(d) for d in x.shape] for n, x in zip(input_names, example_inputs)}
    return proto.model(g, opset=17, doc=f"{doc}traced_shapes=" + json.dumps(traced))
