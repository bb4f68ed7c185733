"""The weights of a UVR MDX ``.onnx`` file, without the ``onnx`` package.

Counterpart of ``rvc_tpu/compat/onnx_import.py``, with its own copy of the
protobuf reader: ModelProto -> graph (7) -> initializer (5) and node (1);
TensorProto {dims (1), data_type (2), float_data (4), name (8), raw_data
(9)}; NodeProto {input (1), output (2), op_type (4)}. The port runs the
network itself (``models.mdx_net.ConvTDFNetTrim``) and only needs the
weights, which ``convtdf_state_from_onnx`` maps onto the net's state_dict
names by one of two routes:

1. by name, where the exporter kept the torch names as initializer names;
2. by structure, where they are anonymous (``onnx::Conv_123``): the graph's
   nodes in trace order, their parameters bucketed by kind (Conv,
   ConvTranspose, MatMul/Gemm, a norm's scale and shift, BatchNorm's
   statistics) and zipped with the net's parameters of that kind in the
   order the net creates them, every shape checked.
"""
from __future__ import annotations

import re
import struct
from typing import Iterator

import numpy as np

_DTYPES = {
    1: np.float32,
    2: np.uint8,
    3: np.int8,
    6: np.int32,
    7: np.int64,
    10: np.float16,
    11: np.float64,
}


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


def _fields(buf: memoryview) -> Iterator[tuple[int, int, object]]:
    """(field_number, wire_type, value) over a protobuf message."""
    pos = 0
    n = len(buf)
    while pos < n:
        key, pos = _read_varint(buf, pos)
        field, wire = key >> 3, key & 7
        if wire == 0:  # varint
            val, pos = _read_varint(buf, pos)
        elif wire == 1:  # 64-bit
            val = bytes(buf[pos: pos + 8])
            pos += 8
        elif wire == 2:  # length-delimited
            ln, pos = _read_varint(buf, pos)
            val = buf[pos: pos + ln]
            pos += ln
        elif wire == 5:  # 32-bit
            val = bytes(buf[pos: pos + 4])
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, val


def _parse_tensor(buf: memoryview) -> tuple[str, np.ndarray]:
    dims: list[int] = []
    dtype = np.float32
    name = ""
    raw = None
    floats: list[float] = []
    for field, wire, val in _fields(buf):
        if field == 1 and wire == 0:
            dims.append(val)
        elif field == 1 and wire == 2:  # packed dims
            pos = 0
            while pos < len(val):
                d, pos = _read_varint(val, pos)
                dims.append(d)
        elif field == 2:
            dtype = _DTYPES.get(val, np.float32)
        elif field == 4 and wire == 2:  # packed float_data
            floats.extend(struct.unpack(f"<{len(val) // 4}f", bytes(val)))
        elif field == 4 and wire == 5:
            floats.append(struct.unpack("<f", val)[0])
        elif field == 8:
            name = bytes(val).decode()
        elif field == 9:
            raw = bytes(val)
    arr = np.frombuffer(raw, dtype=dtype) if raw is not None else np.asarray(floats, np.float32)
    if dims:
        arr = arr.reshape(dims)
    return name, arr


def _parse_node(buf: memoryview) -> tuple[str, list[str], list[str]]:
    """NodeProto -> (op_type, inputs, outputs)."""
    op = ""
    inputs: list[str] = []
    outputs: list[str] = []
    for field, wire, val in _fields(buf):
        if field == 1 and wire == 2:
            inputs.append(bytes(val).decode())
        elif field == 2 and wire == 2:
            outputs.append(bytes(val).decode())
        elif field == 4 and wire == 2:
            op = bytes(val).decode()
    return op, inputs, outputs


def read_onnx_graph(path: str):
    """(initializers {name: array}, nodes [(op_type, inputs, outputs)] in
    stored, that is trace, order) of an ``.onnx`` file."""
    with open(path, "rb") as f:
        data = memoryview(f.read())
    inits: dict[str, np.ndarray] = {}
    nodes: list[tuple[str, list[str], list[str]]] = []
    for field, wire, val in _fields(data):
        if field == 7 and wire == 2:  # ModelProto.graph
            for gfield, gwire, gval in _fields(val):
                if gfield == 5 and gwire == 2:  # GraphProto.initializer
                    name, arr = _parse_tensor(gval)
                    inits[name] = arr
                elif gfield == 1 and gwire == 2:  # GraphProto.node
                    nodes.append(_parse_node(gval))
    return inits, nodes


def read_onnx_initializers(path: str) -> dict[str, np.ndarray]:
    """Every initializer tensor of an ``.onnx`` file, by name."""
    return read_onnx_graph(path)[0]


# torch export names -> the port's: a Sequential wrapping the down/up and
# end convs drops its index (the JAX package's _MDX_RENAMES)
_MDX_NAMES = [
    (r"^(ds|us)\.(\d+)\.(\d+\.)?", r"\1.\2."),
    (r"^(first_conv|final_conv)\.(\d+\.)?", r"\1."),
]


def trace_order(model) -> Iterator[str]:
    """The net's parameter names in the order its forward creates them
    (``ConvTDFNetTrim``): the order the structural route zips in."""
    stats = ("running_mean", "running_var") if model.norm == "BatchNorm" else ()
    norm = ("weight", "bias", *stats) if model.norm != "none" else ()

    def dense(prefix):
        for b in range(model.l):
            p = f"{prefix}.blocks.{b}"
            yield f"{p}.shortcut.weight"
            yield from (f"{p}.tfc1.0.{leaf}" for leaf in norm)
            yield f"{p}.tfc1.2.weight"
            yield from (f"{p}.tdf.0.{leaf}" for leaf in norm)
            yield f"{p}.tdf.2.weight"
            yield from (f"{p}.tdf.3.{leaf}" for leaf in norm)
            yield f"{p}.tdf.5.weight"
            yield from (f"{p}.tfc2.0.{leaf}" for leaf in norm)
            yield f"{p}.tfc2.2.weight"

    n = model.num_blocks // 2
    yield "first_conv.weight"
    for i in range(n):
        yield from dense(f"ds_dense.{i}")
        yield f"ds.{i}.weight"
    yield from dense("mid_dense")
    for i in range(n):
        yield f"us.{i}.weight"
        yield from dense(f"us_dense.{i}")
    yield "final_conv.weight"


def _kind(name: str, ndim: int) -> str:
    if ndim == 4:
        return "convtr" if re.match(r"us\.\d+\.weight$", name) else "conv"
    if ndim == 2:
        return "linear"
    leaf = name.rsplit(".", 1)[-1]
    return {"weight": "nscale", "bias": "nbias", "running_mean": "nmean",
            "running_var": "nvar"}[leaf]


def convtdf_state_from_onnx(path: str, model) -> dict[str, np.ndarray]:
    """A UVR MDX ``.onnx`` -> ``{name: float32 array}`` for ``model``, a
    ``models.mdx_net.ConvTDFNetTrim`` (its shapes and order guide the
    structural route; ``load_state_dict`` checks the names)."""
    inits, nodes = read_onnx_graph(path)
    named = sum(1 for k in inits if "." in k and not k.startswith("onnx::"))
    if inits and named >= max(1, int(0.8 * len(inits))):
        sd = {}
        for k, v in inits.items():
            if k.endswith("num_batches_tracked"):
                continue
            for pat, rep in _MDX_NAMES:
                k = re.sub(pat, rep, k)
            sd[k] = np.asarray(v, np.float32)
        return sd

    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    ordered = list(trace_order(model))
    if set(ordered) != set(shapes):
        raise ValueError(f"parameter order does not cover the net: "
                         f"{sorted(set(ordered) ^ set(shapes))[:3]}")
    mine: dict[str, list[str]] = {}
    for name in ordered:
        mine.setdefault(_kind(name, len(shapes[name])), []).append(name)

    theirs: dict[str, list[np.ndarray]] = {}
    for op, inputs, _ in nodes:
        ws = [inits[i] for i in inputs if i in inits]
        if op == "Conv" and ws:
            theirs.setdefault("conv", []).append(ws[0])
        elif op == "ConvTranspose" and ws:
            theirs.setdefault("convtr", []).append(ws[0])
        elif op in ("MatMul", "Gemm") and ws:
            theirs.setdefault("linear", []).append(ws[0])
        elif op == "BatchNormalization" and len(ws) >= 4:
            for kind, w in zip(("nscale", "nbias", "nmean", "nvar"), ws):
                theirs.setdefault(kind, []).append(w)
        elif op == "Mul" and ws and ws[0].ndim >= 1:
            theirs.setdefault("nscale", []).append(ws[0].reshape(-1))
        elif op == "Add" and ws and ws[0].ndim >= 1:
            theirs.setdefault("nbias", []).append(ws[0].reshape(-1))

    sd = {}
    for kind, names in mine.items():
        avail = theirs.get(kind, [])
        if len(avail) != len(names):
            raise ValueError(f"structural mapping failed: {len(avail)} ONNX tensors vs "
                             f"{len(names)} parameters of kind {kind!r}")
        for name, arr in zip(names, avail):
            a = np.asarray(arr, np.float32)
            if kind == "linear" and a.shape[::-1] == shapes[name]:
                a = a.T  # ONNX MatMul stores (in, out); Linear's weight is (out, in)
            if a.shape != shapes[name]:
                raise ValueError(f"shape mismatch at {name}: onnx {a.shape} vs "
                                 f"expected {shapes[name]}")
            sd[name] = np.ascontiguousarray(a)
    return sd
