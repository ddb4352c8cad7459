"""Minimal ONNX reader: initializers straight from the protobuf (port of
skyrim_tpu/weights/onnx_io.py, numpy only).

Pangu, FuXi and FengWu are distributed as ONNX artifacts.  This module
lets the weight converters ingest those artifacts directly — no onnx
package, no onnxruntime, no hand pre-export step — by decoding the
protobuf wire format of the two messages that matter:

- ``ModelProto.graph`` (field 7) → ``GraphProto``
- ``GraphProto.initializer`` (field 5, repeated ``TensorProto``) and
  ``GraphProto.node`` (field 1) Constant nodes carrying a tensor
  attribute (some exporters store weights that way)
- ``TensorProto``: dims (1), data_type (2), float_data (4),
  int32_data (5 — packed storage for fp16/bf16/int8/uint8/bool/int32),
  int64_data (7), name (8), raw_data (9), double_data (10),
  uint64_data (11), external_data (13) + data_location (14) for the
  >2 GB external-data layout big exports use

Only reading is production; :func:`build_onnx` writes a minimal model
(initializers, optionally a node topology) so tests can round-trip
synthetic artifacts.
"""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np

# TensorProto.DataType → numpy
_DTYPES = {
    1: np.float32,
    2: np.uint8,
    3: np.int8,
    4: np.uint16,
    5: np.int16,
    6: np.int32,
    7: np.int64,
    9: np.bool_,
    10: np.float16,
    11: np.float64,
    12: np.uint32,
    13: np.uint64,
}
_BFLOAT16 = 16


def _read_varint(buf: memoryview, pos: int) -> tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 70:
            raise ValueError("varint overflow (corrupt protobuf)")


def _fields(buf: memoryview):
    """Yield (field_number, wire_type, value_or_span) over a message.

    wire 0 → int, wire 1 → 8 bytes, wire 2 → memoryview, wire 5 → 4 bytes.
    """
    pos = 0
    n = len(buf)
    while pos < n:
        key, pos = _read_varint(buf, pos)
        field, wire = key >> 3, key & 7
        if wire == 0:
            val, pos = _read_varint(buf, pos)
        elif wire == 1:
            val = buf[pos : pos + 8]
            pos += 8
        elif wire == 2:
            ln, pos = _read_varint(buf, pos)
            val = buf[pos : pos + ln]
            pos += ln
        elif wire == 5:
            val = buf[pos : pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, val


def _parse_packed_varints(buf: memoryview) -> list[int]:
    out = []
    pos = 0
    while pos < len(buf):
        v, pos = _read_varint(buf, pos)
        out.append(v)
    return out


def _zigzag_signed(v: int, bits: int = 64) -> int:
    """int64 fields are two's-complement varints (NOT zigzag) in proto3."""
    if v >= 1 << (bits - 1):
        v -= 1 << bits
    return v


def _parse_tensor(buf: memoryview, base_dir: Path | None):
    dims: list[int] = []
    data_type = 1
    name = ""
    raw = None
    float_data: list[float] = []
    int_data: list[int] = []
    int32_data: list[int] = []
    double_data: list[float] = []
    uint64_data: list[int] = []
    external: dict[str, str] = {}
    location = 0
    for field, wire, val in _fields(buf):
        if field == 1:  # dims (repeated int64)
            if wire == 0:
                dims.append(_zigzag_signed(val))
            else:
                dims.extend(_zigzag_signed(v) for v in _parse_packed_varints(val))
        elif field == 2 and wire == 0:
            data_type = val
        elif field == 4:  # float_data
            if wire == 5:
                float_data.append(struct.unpack("<f", bytes(val))[0])
            elif wire == 2:
                float_data.extend(
                    struct.unpack(f"<{len(val) // 4}f", bytes(val))
                )
        elif field == 5:  # int32_data — standard non-raw storage for
            # int32/int16/int8/uint8/bool/float16/bfloat16 initializers.
            # Negative int32 is 64-bit sign-extended on the wire (proto3),
            # so decode at full width; the astype below truncates.
            if wire == 0:
                int32_data.append(_zigzag_signed(val, 64))
            else:
                int32_data.extend(
                    _zigzag_signed(v, 64) for v in _parse_packed_varints(val)
                )
        elif field == 7:  # int64_data
            if wire == 0:
                int_data.append(_zigzag_signed(val))
            else:
                int_data.extend(_zigzag_signed(v) for v in _parse_packed_varints(val))
        elif field == 10:  # double_data
            if wire == 1:
                double_data.append(struct.unpack("<d", bytes(val))[0])
            elif wire == 2:
                double_data.extend(
                    struct.unpack(f"<{len(val) // 8}d", bytes(val))
                )
        elif field == 11:  # uint64_data
            if wire == 0:
                uint64_data.append(val)
            else:
                uint64_data.extend(_parse_packed_varints(val))
        elif field == 8 and wire == 2:
            name = bytes(val).decode("utf-8")
        elif field == 9 and wire == 2:
            raw = val
        elif field == 13 and wire == 2:  # external_data: StringStringEntryProto
            k = v = ""
            for f2, w2, v2 in _fields(val):
                if f2 == 1 and w2 == 2:
                    k = bytes(v2).decode()
                elif f2 == 2 and w2 == 2:
                    v = bytes(v2).decode()
            external[k] = v
        elif field == 14 and wire == 0:
            location = val  # 1 = EXTERNAL

    if location == 1 or (external and raw is None):
        if base_dir is None:
            raise ValueError(f"tensor {name!r} uses external data but no base dir given")
        loc = external.get("location")
        if not loc:
            raise ValueError(f"tensor {name!r}: external data without location")
        offset = int(external.get("offset", 0))
        length = int(external.get("length", -1))
        with open(base_dir / loc, "rb") as fh:
            fh.seek(offset)
            raw = fh.read() if length < 0 else fh.read(length)

    shape = tuple(dims)
    if raw is not None:
        if data_type == _BFLOAT16:
            u16 = np.frombuffer(raw, np.uint16)
            arr = (u16.astype(np.uint32) << 16).view(np.float32).astype(np.float32)
        else:
            np_dtype = _DTYPES.get(data_type)
            if np_dtype is None:
                raise ValueError(f"tensor {name!r}: unsupported data_type {data_type}")
            arr = np.frombuffer(bytes(raw), np_dtype)
    elif float_data:
        arr = np.asarray(float_data, np.float32)
    elif int_data:
        arr = np.asarray(int_data, _DTYPES.get(data_type, np.int64))
    elif int32_data:
        # int32_data carries several dtypes; float16/bfloat16 store the
        # raw 16-bit pattern in the low half of each int32
        if data_type == 10:  # float16
            arr = (
                np.asarray(int32_data, np.int64)
                .astype(np.uint16)
                .view(np.float16)
                .astype(np.float32)
            )
        elif data_type == _BFLOAT16:
            u16 = np.asarray(int32_data, np.int64).astype(np.uint16)
            arr = (u16.astype(np.uint32) << 16).view(np.float32)
        else:
            arr = np.asarray(int32_data, np.int64).astype(
                _DTYPES.get(data_type, np.int32)
            )
    elif double_data:
        arr = np.asarray(double_data, np.float64)
    elif uint64_data:
        arr = np.asarray(uint64_data, np.uint64)
    elif shape and int(np.prod(shape)) > 0:
        # a non-empty tensor with no recognized payload means an
        # unhandled storage field — loading zeros would silently produce
        # garbage forecasts downstream, so refuse
        raise ValueError(
            f"tensor {name!r}: no recognized data field "
            f"(dims={shape}, data_type={data_type})"
        )
    else:
        arr = np.zeros(shape, _DTYPES.get(data_type, np.float32))
    return name, arr.reshape(shape) if shape else arr


def _parse_constant_node(buf: memoryview, base_dir: Path | None):
    """NodeProto: op_type (4), output (2, repeated), attribute (5).
    Returns (output_name, tensor) for Constant nodes with a tensor attr."""
    op_type = ""
    outputs: list[str] = []
    tensor = None
    for field, wire, val in _fields(buf):
        if field == 4 and wire == 2:
            op_type = bytes(val).decode()
        elif field == 2 and wire == 2:
            outputs.append(bytes(val).decode())
        elif field == 5 and wire == 2:
            # AttributeProto: name (1), t (5, TensorProto)
            for f2, w2, v2 in _fields(val):
                if f2 == 5 and w2 == 2:
                    _, tensor = _parse_tensor(v2, base_dir)
    if op_type == "Constant" and outputs and tensor is not None:
        return outputs[0], tensor
    return None


def read_onnx_initializers(
    path: str | Path, include_constants: bool = True
) -> dict[str, np.ndarray]:
    """All weight tensors of an ONNX model as {name: ndarray}.

    Follows external-data references relative to the model file's
    directory (the layout >2 GB exports like FuXi use).
    """
    path = Path(path)
    return read_onnx_initializers_from_bytes(
        path.read_bytes(), base_dir=path.parent, include_constants=include_constants
    )


def read_onnx_initializers_from_bytes(
    data: bytes, base_dir: Path | None = None, include_constants: bool = True
) -> dict[str, np.ndarray]:
    data = memoryview(data)
    out: dict[str, np.ndarray] = {}
    for field, wire, val in _fields(data):
        if field == 7 and wire == 2:  # ModelProto.graph
            for f2, w2, v2 in _fields(val):
                if f2 == 5 and w2 == 2:  # initializer
                    name, arr = _parse_tensor(v2, base_dir)
                    out[name] = arr
                elif include_constants and f2 == 1 and w2 == 2:  # node
                    got = _parse_constant_node(v2, base_dir)
                    if got is not None:
                        out[got[0]] = got[1]
    if not out:
        raise ValueError("no initializers found (not an ONNX model?)")
    return out


def _parse_node(buf: memoryview):
    """NodeProto topology: input (1), output (2), name (3), op_type (4)."""
    inputs: list[str] = []
    outputs: list[str] = []
    name = ""
    op_type = ""
    for field, wire, val in _fields(buf):
        if field == 1 and wire == 2:
            inputs.append(bytes(val).decode())
        elif field == 2 and wire == 2:
            outputs.append(bytes(val).decode())
        elif field == 3 and wire == 2:
            name = bytes(val).decode()
        elif field == 4 and wire == 2:
            op_type = bytes(val).decode()
    return {"op_type": op_type, "name": name, "inputs": inputs, "outputs": outputs}


def _valueinfo_name(buf: memoryview) -> str:
    for field, wire, val in _fields(buf):
        if field == 1 and wire == 2:
            return bytes(val).decode()
    return ""


def read_onnx_graph(path: str | Path) -> dict:
    path = Path(path)
    return read_onnx_graph_from_bytes(path.read_bytes(), base_dir=path.parent)


def read_onnx_graph_from_bytes(data: bytes, base_dir: Path | None = None) -> dict:
    """Full graph topology for the exporter-name rename pass
    (weights/onnx_rename.py): initializers + node list (op_type, inputs,
    outputs, in serialized order — exporters emit topological order) +
    graph input/output names."""
    data = memoryview(data)
    out = {
        "initializers": {},
        "nodes": [],
        "inputs": [],
        "outputs": [],
    }
    for field, wire, val in _fields(data):
        if field == 7 and wire == 2:  # ModelProto.graph
            for f2, w2, v2 in _fields(val):
                if f2 == 5 and w2 == 2:  # initializer
                    name, arr = _parse_tensor(v2, base_dir)
                    out["initializers"][name] = arr
                elif f2 == 1 and w2 == 2:  # node
                    node = _parse_node(v2)
                    out["nodes"].append(node)
                    got = _parse_constant_node(v2, base_dir)
                    if got is not None:
                        out["initializers"][got[0]] = got[1]
                elif f2 == 11 and w2 == 2:  # graph input
                    out["inputs"].append(_valueinfo_name(v2))
                elif f2 == 12 and w2 == 2:  # graph output
                    out["outputs"].append(_valueinfo_name(v2))
    if not out["nodes"] and not out["initializers"]:
        raise ValueError("no graph content found (not an ONNX model?)")
    return out


# ---------------------------------------------------------------------------
# writer (tests only): a minimal ModelProto with just graph.initializer
# ---------------------------------------------------------------------------


def _varint(v: int) -> bytes:
    if v < 0:
        raise ValueError(f"varint value must be non-negative, got {v}")
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _tag(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _len_field(field: int, payload: bytes) -> bytes:
    return _tag(field, 2) + _varint(len(payload)) + payload


def _tensor_proto(name: str, arr: np.ndarray) -> bytes:
    arr = np.asarray(arr)
    rev = {v: k for k, v in _DTYPES.items()}
    dt = rev.get(arr.dtype.type)
    if dt is None:
        raise ValueError(f"unsupported dtype {arr.dtype}")
    body = b"".join(_tag(1, 0) + _varint(int(d)) for d in arr.shape)
    body += _tag(2, 0) + _varint(dt)
    body += _len_field(8, name.encode())
    body += _len_field(9, arr.tobytes())
    return body


def _node_proto(op_type: str, inputs, outputs, name: str = "") -> bytes:
    body = b"".join(_len_field(1, i.encode()) for i in inputs)
    body += b"".join(_len_field(2, o.encode()) for o in outputs)
    if name:
        body += _len_field(3, name.encode())
    body += _len_field(4, op_type.encode())
    return body


def build_onnx(
    tensors: dict[str, np.ndarray],
    nodes: list[tuple[str, list[str], list[str]]] | None = None,
    graph_inputs: tuple[str, ...] = (),
    graph_outputs: tuple[str, ...] = (),
) -> bytes:
    """Serialize {name: array} (+ optional (op_type, inputs, outputs)
    node topology) as a minimal ONNX ModelProto — lets tests synthesize
    exporter-shaped traced graphs for the rename pass."""
    graph = b"".join(
        _len_field(1, _node_proto(op, ins, outs)) for op, ins, outs in nodes or []
    )
    graph += b"".join(_len_field(5, _tensor_proto(n, a)) for n, a in tensors.items())
    graph += b"".join(
        _len_field(11, _len_field(1, n.encode())) for n in graph_inputs
    )
    graph += b"".join(
        _len_field(12, _len_field(1, n.encode())) for n in graph_outputs
    )
    model = _tag(1, 0) + _varint(8)  # ir_version
    model += _len_field(7, graph)
    return model
