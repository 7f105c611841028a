"""Pure-Python ONNX protobuf wire-format reader.

The port's own copy of ``flexflow_tpu/frontends/onnx_wire.py`` (numpy
only). Reference: python/flexflow/onnx/model.py consumes the `onnx`
package's generated protobuf bindings. That package is not a dependency
here, so this module reads the ONNX wire format directly — a minimal
protobuf decoder over the PUBLIC onnx.proto3 schema (field numbers
below are the schema's, stable by protobuf compatibility rules)
covering what the importer needs: ModelProto -> GraphProto -> nodes
(op_type, inputs, outputs, attributes), initializers (TensorProto with
raw_data or packed typed data), and graph inputs with static shapes.

Protobuf wire format: each field is a varint tag `(field_no << 3) |
wire_type`; wire types: 0 = varint, 1 = 64-bit, 2 = length-delimited
(submessages, strings, packed repeated scalars), 5 = 32-bit.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Tuple

import numpy as np

# --- generic protobuf scanning -----------------------------------------


def _varint(buf: bytes, pos: int) -> Tuple[int, int]:
    out = 0
    shift = 0
    while True:
        if pos >= len(buf):
            raise ValueError("truncated protobuf: buffer ends mid-varint")
        b = buf[pos]
        pos += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out, pos
        shift += 7
        if shift > 70:
            raise ValueError("malformed varint")


def _fields(buf: bytes):
    """Yield (field_no, wire_type, value); value is int (wire 0/1/5 —
    1/5 returned as raw little-endian ints) or bytes (wire 2)."""
    pos = 0
    n = len(buf)
    while pos < n:
        tag, pos = _varint(buf, pos)
        field_no, wt = tag >> 3, tag & 7
        if wt == 0:
            val, pos = _varint(buf, pos)
        elif wt == 1:
            val = int.from_bytes(buf[pos:pos + 8], "little")
            pos += 8
        elif wt == 5:
            val = int.from_bytes(buf[pos:pos + 4], "little")
            pos += 4
        elif wt == 2:
            ln, pos = _varint(buf, pos)
            if ln > n - pos:
                # a silent short slice would drop trailing nodes/
                # initializers of a truncated download — fail loudly
                raise ValueError(
                    f"truncated protobuf: field {field_no} declares "
                    f"{ln} bytes, {n - pos} remain")
            val = buf[pos:pos + ln]
            pos += ln
        else:
            raise ValueError(f"unsupported wire type {wt} (group fields "
                             f"were removed from proto3)")
        yield field_no, wt, val


def _signed(v: int) -> int:
    """int64 varints are two's-complement on the wire."""
    return v - (1 << 64) if v >= (1 << 63) else v


def _f32(v: int) -> float:
    return struct.unpack("<f", v.to_bytes(4, "little"))[0]


def _packed_or_scalar(acc: list, wt, val, fmt=None, unsigned=False):
    """Repeated scalar field: packed (wire 2) or one-per-entry; `fmt`
    set for fixed-width (float/double) elements, varints otherwise.
    `unsigned` skips the two's-complement reinterpretation (uint64_data
    values >= 2^63 are NOT negative int64s)."""
    conv = (lambda v: v) if unsigned else _signed
    if wt == 2:
        if fmt:  # fixed-width packed
            acc.extend(x[0] for x in struct.iter_unpack(fmt, val))
        else:  # packed varints
            pos = 0
            while pos < len(val):
                v, pos = _varint(val, pos)
                acc.append(conv(v))
    elif fmt:
        acc.append(struct.unpack(fmt, val.to_bytes(
            8 if fmt[1] in "dq" else 4, "little"))[0])
    else:
        acc.append(conv(val))


# --- ONNX messages -----------------------------------------------------

# TensorProto.DataType -> numpy dtype (onnx.proto3 enum)
TENSOR_DTYPES = {
    1: np.float32, 2: np.uint8, 3: np.int8, 4: np.uint16, 5: np.int16,
    6: np.int32, 7: np.int64, 9: np.bool_, 10: np.float16,
    11: np.float64, 12: np.uint32, 13: np.uint64,
}


def parse_tensor(buf: bytes) -> Tuple[str, np.ndarray]:
    """TensorProto: dims=1, data_type=2, float_data=4, int32_data=5,
    string_data=6, int64_data=7, name=8, raw_data=9, double_data=10,
    uint64_data=11."""
    dims: List[int] = []
    data_type = 0
    name = ""
    raw = None
    floats: list = []
    i32: list = []
    i64: list = []
    f64: list = []
    u64: list = []
    for fno, wt, val in _fields(buf):
        if fno == 1:
            _packed_or_scalar(dims, wt, val)
        elif fno == 2:
            data_type = val
        elif fno == 4:
            _packed_or_scalar(floats, wt, val, "<f")
        elif fno == 5:
            _packed_or_scalar(i32, wt, val)
        elif fno == 7:
            _packed_or_scalar(i64, wt, val)
        elif fno == 8:
            name = val.decode()
        elif fno == 9:
            raw = bytes(val)
        elif fno == 10:
            _packed_or_scalar(f64, wt, val, "<d")
        elif fno == 11:
            _packed_or_scalar(u64, wt, val, unsigned=True)
        elif fno == 6:
            raise NotImplementedError(
                f"ONNX string tensors are unsupported ({name!r})")
    if data_type not in TENSOR_DTYPES:
        raise NotImplementedError(
            f"ONNX tensor {name!r}: data_type {data_type} unsupported "
            f"(bfloat16/string/complex need the onnx package)")
    dtype = np.dtype(TENSOR_DTYPES[data_type])
    if raw is not None:
        arr = np.frombuffer(raw, dtype=dtype.newbyteorder("<"))
        arr = arr.astype(dtype)
    elif floats:
        arr = np.asarray(floats, np.float32).astype(dtype)
    elif i64:
        arr = np.asarray(i64, np.int64).astype(dtype)
    elif i32:
        # int32_data also carries (u)int8/16/bool/float16 per the schema
        base = np.asarray(i32, np.int32)
        arr = (base.astype(np.uint16).view(np.float16)
               if dtype == np.float16 else base.astype(dtype))
    elif f64:
        arr = np.asarray(f64, np.float64).astype(dtype)
    elif u64:
        arr = np.asarray(u64, np.uint64).astype(dtype)
    else:
        arr = np.zeros(0, dtype)
    return name, arr.reshape([int(d) for d in dims])


def parse_attribute(buf: bytes):
    """AttributeProto: name=1, f=2, i=3, s=4, t=5, g=6, floats=7,
    ints=8, strings=9, type=20. Returns (name, python value)."""
    name = ""
    atype = 0
    f = i = s = t = None
    floats: list = []
    ints: list = []
    strings: list = []
    for fno, wt, val in _fields(buf):
        if fno == 1:
            name = val.decode()
        elif fno == 2:
            f = _f32(val)
        elif fno == 3:
            i = _signed(val)
        elif fno == 4:
            s = val
        elif fno == 5:
            t = parse_tensor(val)[1]
        elif fno == 6:
            raise NotImplementedError(
                f"ONNX attribute {name!r}: GRAPH attributes (If/Loop "
                f"subgraphs) are unsupported")
        elif fno == 7:
            _packed_or_scalar(floats, wt, val, "<f")
        elif fno == 8:
            _packed_or_scalar(ints, wt, val)
        elif fno == 9:
            strings.append(val)
        elif fno == 20:
            atype = val
    # AttributeProto.type disambiguates (FLOAT=1 INT=2 STRING=3 TENSOR=4
    # FLOATS=6 INTS=7 STRINGS=8); fall back to whichever field is set
    # for writers that omit it
    by_type = {1: f, 2: i, 3: s.decode() if s is not None else None,
               4: t, 6: floats, 7: ints,
               8: [x.decode() for x in strings]}
    if atype in by_type:
        return name, by_type[atype]
    if atype:  # set but outside the supported set (GRAPH(S)=5/10, etc.)
        raise NotImplementedError(
            f"ONNX attribute {name!r}: AttributeProto.type {atype} "
            f"unsupported")
    for v in (i, f, t):
        if v is not None:
            return name, v
    if s is not None:
        return name, s.decode()
    for v in (ints, floats):
        if v:
            return name, v
    if strings:
        return name, [x.decode() for x in strings]
    return name, None


def parse_node(buf: bytes) -> Dict:
    """NodeProto: input=1, output=2, name=3, op_type=4, attribute=5."""
    node = {"input": [], "output": [], "name": "", "op_type": "",
            "attrs": {}}
    for fno, wt, val in _fields(buf):
        if fno == 1:
            node["input"].append(val.decode())
        elif fno == 2:
            node["output"].append(val.decode())
        elif fno == 3:
            node["name"] = val.decode()
        elif fno == 4:
            node["op_type"] = val.decode()
        elif fno == 5:
            k, v = parse_attribute(val)
            node["attrs"][k] = v
    return node


def _parse_shape(buf: bytes) -> List:
    """TensorShapeProto: dim=1 (dim_value=1 | dim_param=2)."""
    dims = []
    for fno, _wt, val in _fields(buf):
        if fno == 1:
            d = None
            for f2, _w2, v2 in _fields(val):
                if f2 == 1:
                    d = _signed(v2)
                elif f2 == 2 and d is None:
                    d = v2.decode()  # symbolic dim
            dims.append(d)
    return dims


def _parse_value_info(buf: bytes) -> Dict:
    """ValueInfoProto: name=1, type=2; TypeProto.tensor_type=1 with
    elem_type=1, shape=2."""
    out = {"name": "", "elem_type": 0, "shape": []}
    for fno, _wt, val in _fields(buf):
        if fno == 1:
            out["name"] = val.decode()
        elif fno == 2:
            for f2, _w2, v2 in _fields(val):
                if f2 == 1:  # tensor_type
                    for f3, _w3, v3 in _fields(v2):
                        if f3 == 1:
                            out["elem_type"] = v3
                        elif f3 == 2:
                            out["shape"] = _parse_shape(v3)
    return out


def parse_graph(buf: bytes) -> Dict:
    """GraphProto: node=1, name=2, initializer=5, input=11, output=12."""
    g = {"nodes": [], "name": "", "initializers": {}, "inputs": [],
         "outputs": []}
    for fno, _wt, val in _fields(buf):
        if fno == 1:
            g["nodes"].append(parse_node(val))
        elif fno == 2:
            g["name"] = val.decode()
        elif fno == 5:
            name, arr = parse_tensor(val)
            g["initializers"][name] = arr
        elif fno == 11:
            g["inputs"].append(_parse_value_info(val))
        elif fno == 12:
            g["outputs"].append(_parse_value_info(val))
        elif fno == 15:
            raise NotImplementedError(
                "sparse_initializer needs the onnx package")
    return g


def parse_model(data: bytes) -> Dict:
    """ModelProto: ir_version=1, producer_name=2, graph=7,
    opset_import=8 (domain=1, version=2)."""
    model = {"ir_version": 0, "producer_name": "", "graph": None,
             "opset": {}}
    for fno, _wt, val in _fields(data):
        if fno == 1:
            model["ir_version"] = val
        elif fno == 2:
            model["producer_name"] = val.decode()
        elif fno == 7:
            model["graph"] = parse_graph(val)
        elif fno == 8:
            dom, ver = "", 0
            for f2, _w2, v2 in _fields(val):
                if f2 == 1:
                    dom = v2.decode()
                elif f2 == 2:
                    ver = v2
            model["opset"][dom] = ver
    if model["graph"] is None:
        raise ValueError("not an ONNX ModelProto: no graph field")
    return model


def load_model(path_or_bytes) -> Dict:
    """Read a .onnx file (or proto bytes) into the parsed-model dict."""
    if isinstance(path_or_bytes, bytes):
        return parse_model(path_or_bytes)
    with open(path_or_bytes, "rb") as f:
        return parse_model(f.read())
