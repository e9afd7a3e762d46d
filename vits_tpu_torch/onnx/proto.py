"""Minimal, dependency-free ONNX protobuf writer and reader (the port's own
copy of vits_tpu/onnx/proto.py, numpy and `struct` only).

Neither `onnx` nor `protobuf` is needed: this module encodes the protobuf
wire format by hand for the subset of `onnx.proto` (ModelProto et al.) the
exporter emits. Field numbers follow the public ONNX schema (onnx/onnx.proto,
IR version 8); `tools/onnx_subset.proto` mirrors the same subset so
`protoc --decode` can validate the encoding independently. The wire format
is the JAX package's byte for byte: either package's reader parses the
other's files.

Wire format: tag = (field_number << 3) | wire_type; wire types 0 = varint,
1 = 64-bit, 2 = length-delimited, 5 = 32-bit. Repeated numeric fields are
written packed (valid for any protobuf parser).
"""

from __future__ import annotations

import struct

import numpy as np

# --- TensorProto.DataType enum (onnx.proto) ---
FLOAT, UINT8, INT8, UINT16, INT16, INT32, INT64 = 1, 2, 3, 4, 5, 6, 7
STRING, BOOL, FLOAT16, DOUBLE, UINT32, UINT64, _, BFLOAT16 = 8, 9, 10, 11, 12, 13, 14, 16

NP_TO_ONNX = {
    np.dtype(np.float32): FLOAT, np.dtype(np.float64): DOUBLE,
    np.dtype(np.float16): FLOAT16, np.dtype(np.int8): INT8,
    np.dtype(np.uint8): UINT8, np.dtype(np.int16): INT16,
    np.dtype(np.int32): INT32, np.dtype(np.int64): INT64,
    np.dtype(np.bool_): BOOL, np.dtype(np.uint32): UINT32,
    np.dtype(np.uint64): UINT64,
}
ONNX_TO_NP = {v: k for k, v in NP_TO_ONNX.items()}

# AttributeProto.AttributeType
AT_FLOAT, AT_INT, AT_STRING, AT_TENSOR, AT_GRAPH = 1, 2, 3, 4, 5
AT_FLOATS, AT_INTS, AT_STRINGS = 6, 7, 8


# ---------------------------------------------------------------- encoding

def _varint(n: int) -> bytes:
    if n < 0:
        n += 1 << 64  # two's-complement, 10 bytes
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _tag(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _len_field(field: int, payload: bytes) -> bytes:
    return _tag(field, 2) + _varint(len(payload)) + payload


def _str_field(field: int, s) -> bytes:
    if isinstance(s, str):
        s = s.encode()
    return _len_field(field, s)


def _int_field(field: int, n: int) -> bytes:
    return _tag(field, 0) + _varint(n)


def _float_field(field: int, f: float) -> bytes:
    return _tag(field, 5) + struct.pack("<f", f)


def _packed_ints(field: int, vals) -> bytes:
    payload = b"".join(_varint(int(v)) for v in vals)
    return _len_field(field, payload)


def _packed_floats(field: int, vals) -> bytes:
    return _len_field(field, struct.pack(f"<{len(vals)}f", *vals))


# ---------------------------------------------------------------- messages

def tensor_proto(name: str, arr: np.ndarray) -> bytes:
    # NB: np.ascontiguousarray would promote 0-d arrays to 1-d
    arr = np.asarray(arr, order="C")
    dt = NP_TO_ONNX[arr.dtype]
    msg = b""
    if arr.ndim:
        msg += _packed_ints(1, arr.shape)  # dims
    msg += _int_field(2, dt)  # data_type
    msg += _str_field(8, name)
    msg += _len_field(9, arr.tobytes())  # raw_data (little-endian per spec)
    return msg


def _tensor_shape(dims) -> bytes:
    # TensorShapeProto: repeated Dimension dim = 1;
    # Dimension: oneof { int64 dim_value = 1; string dim_param = 2; }
    out = b""
    for d in dims:
        if isinstance(d, str):
            dim = _str_field(2, d)
        else:
            dim = _int_field(1, int(d))
        out += _len_field(1, dim)
    return out


def value_info(name: str, elem_type: int, dims) -> bytes:
    # TypeProto.Tensor { elem_type = 1; shape = 2 }
    ttype = _int_field(1, elem_type) + _len_field(2, _tensor_shape(dims))
    tproto = _len_field(1, ttype)  # TypeProto.tensor_type = 1
    return _str_field(1, name) + _len_field(2, tproto)


def attribute(name: str, value) -> bytes:
    msg = _str_field(1, name)
    if isinstance(value, bool):
        msg += _int_field(3, int(value)) + _int_field(20, AT_INT)
    elif isinstance(value, int):
        msg += _int_field(3, value) + _int_field(20, AT_INT)
    elif isinstance(value, float):
        msg += _float_field(2, value) + _int_field(20, AT_FLOAT)
    elif isinstance(value, (str, bytes)):
        msg += _str_field(4, value) + _int_field(20, AT_STRING)
    elif isinstance(value, np.ndarray):
        msg += _len_field(5, tensor_proto("", value)) + _int_field(20, AT_TENSOR)
    elif isinstance(value, (list, tuple)):
        if value and isinstance(value[0], float):
            msg += _packed_floats(7, value) + _int_field(20, AT_FLOATS)
        else:
            msg += _packed_ints(8, value) + _int_field(20, AT_INTS)
    else:
        raise TypeError(f"attribute {name}: {type(value)}")
    return msg


def node(op_type: str, inputs, outputs, name: str = "", **attrs) -> bytes:
    msg = b""
    for i in inputs:
        msg += _str_field(1, i)
    for o in outputs:
        msg += _str_field(2, o)
    if name:
        msg += _str_field(3, name)
    msg += _str_field(4, op_type)
    for k in sorted(attrs):
        if attrs[k] is not None:
            msg += _len_field(5, attribute(k, attrs[k]))
    return msg


def graph(nodes, name, inputs, outputs, initializers, value_infos=()) -> bytes:
    # joined once: appending to one bytes object would copy the whole
    # message for every initializer (hundreds of MB at full width)
    parts = [_len_field(1, n) for n in nodes]
    parts.append(_str_field(2, name))
    parts += [_len_field(5, t) for t in initializers]
    parts += [_len_field(11, vi) for vi in inputs]
    parts += [_len_field(12, vi) for vi in outputs]
    parts += [_len_field(13, vi) for vi in value_infos]
    return b"".join(parts)


def model(graph_bytes: bytes, opset: int = 17, producer: str = "vits_tpu_torch",
          ir_version: int = 8, doc: str = "") -> bytes:
    opset_id = _str_field(1, "") + _int_field(2, opset)
    parts = [_int_field(1, ir_version), _str_field(2, producer), _len_field(7, graph_bytes),
             _len_field(8, opset_id)]
    if doc:
        parts.append(_str_field(6, doc))
    return b"".join(parts)


# ---------------------------------------------------------------- decoding
# A reader for the same subset: used by the runtime (onnx/runtime.py), the
# CLI's check and the round-trip tests. Returns plain dicts.

def _read_varint(buf, i):
    n = shift = 0
    while True:
        b = buf[i]
        i += 1
        n |= (b & 0x7F) << shift
        if not b & 0x80:
            return n, i
        shift += 7


def _scan(buf):
    """Yield (field, wire, value-or-bytes) triples of one message."""
    i = 0
    while i < len(buf):
        key, i = _read_varint(buf, i)
        field, wire = key >> 3, key & 7
        if wire == 0:
            v, i = _read_varint(buf, i)
        elif wire == 2:
            ln, i = _read_varint(buf, i)
            v = buf[i:i + ln]
            i += ln
        elif wire == 5:
            v = struct.unpack("<f", buf[i:i + 4])[0]
            i += 4
        elif wire == 1:
            v = struct.unpack("<d", buf[i:i + 8])[0]
            i += 8
        else:
            raise ValueError(f"wire type {wire}")
        yield field, wire, v


def _unpack_ints(v, wire):
    if wire == 0:
        return [v]
    out, i = [], 0
    while i < len(v):
        n, i = _read_varint(v, i)
        out.append(n)
    return out


def _signed(n):
    return n - (1 << 64) if n >= 1 << 63 else n


def parse_tensor(buf) -> dict:
    t = {"dims": [], "name": "", "raw": b"", "data_type": FLOAT}
    for f, w, v in _scan(buf):
        if f == 1:
            t["dims"] += [_signed(x) for x in _unpack_ints(v, w)]
        elif f == 2:
            t["data_type"] = v
        elif f == 8:
            t["name"] = v.decode()
        elif f == 9:
            t["raw"] = v
    return t


def tensor_to_np(t: dict) -> np.ndarray:
    dt = ONNX_TO_NP[t["data_type"]]
    return np.frombuffer(t["raw"], dt).reshape(t["dims"]).copy()


def parse_attribute(buf) -> tuple:
    name, atype, vals = "", None, {}
    for f, w, v in _scan(buf):
        if f == 1:
            name = v.decode()
        elif f == 2:
            vals["f"] = v
        elif f == 3:
            vals["i"] = _signed(v)
        elif f == 4:
            vals["s"] = v
        elif f == 5:
            vals["t"] = parse_tensor(v)
        elif f == 7:
            vals["floats"] = (list(struct.unpack(f"<{len(v) // 4}f", v))
                              if w == 2 else [v])
        elif f == 8:
            vals["ints"] = [_signed(x) for x in _unpack_ints(v, w)]
        elif f == 20:
            atype = v
    if atype == AT_FLOAT:
        return name, vals.get("f", 0.0)
    if atype == AT_INT:
        return name, vals.get("i", 0)
    if atype == AT_STRING:
        return name, vals.get("s", b"").decode()
    if atype == AT_TENSOR:
        return name, tensor_to_np(vals["t"])
    if atype == AT_FLOATS:
        return name, vals.get("floats", [])
    if atype == AT_INTS:
        return name, vals.get("ints", [])
    raise ValueError(f"attribute type {atype}")


def parse_node(buf) -> dict:
    n = {"input": [], "output": [], "op_type": "", "name": "", "attrs": {}}
    for f, w, v in _scan(buf):
        if f == 1:
            n["input"].append(v.decode())
        elif f == 2:
            n["output"].append(v.decode())
        elif f == 3:
            n["name"] = v.decode()
        elif f == 4:
            n["op_type"] = v.decode()
        elif f == 5:
            k, av = parse_attribute(v)
            n["attrs"][k] = av
    return n


def parse_value_info(buf) -> dict:
    vi = {"name": "", "elem_type": None, "shape": []}
    for f, w, v in _scan(buf):
        if f == 1:
            vi["name"] = v.decode()
        elif f == 2:
            for f2, _, v2 in _scan(v):
                if f2 == 1:  # tensor_type
                    for f3, w3, v3 in _scan(v2):
                        if f3 == 1:
                            vi["elem_type"] = v3
                        elif f3 == 2:
                            for f4, _, v4 in _scan(v3):
                                if f4 == 1:
                                    dim = None
                                    for f5, w5, v5 in _scan(v4):
                                        if f5 == 1:
                                            dim = _signed(v5)
                                        elif f5 == 2:
                                            dim = v5.decode()
                                    vi["shape"].append(dim)
    return vi


def parse_graph(buf) -> dict:
    g = {"node": [], "name": "", "initializer": [], "input": [], "output": [],
         "value_info": []}
    for f, w, v in _scan(buf):
        if f == 1:
            g["node"].append(parse_node(v))
        elif f == 2:
            g["name"] = v.decode()
        elif f == 5:
            g["initializer"].append(parse_tensor(v))
        elif f == 11:
            g["input"].append(parse_value_info(v))
        elif f == 12:
            g["output"].append(parse_value_info(v))
        elif f == 13:
            g["value_info"].append(parse_value_info(v))
    return g


def parse_model(buf) -> dict:
    m = {"ir_version": None, "producer": "", "graph": None, "opset": None,
         "doc": ""}
    for f, w, v in _scan(buf):
        if f == 1:
            m["ir_version"] = v
        elif f == 2:
            m["producer"] = v.decode()
        elif f == 6:
            m["doc"] = v.decode()
        elif f == 7:
            m["graph"] = parse_graph(v)
        elif f == 8:
            for f2, w2, v2 in _scan(v):
                if f2 == 2:
                    m["opset"] = v2
    return m
