# Copy of vadc_tpu/export/onnx_extract.py (numpy only): the port imports nothing of vadc_tpu
# and keeps its own; tests/test_torch_copies.py holds it to the original.
"""Extract initializer tensors from .onnx files without the onnx package.

A minimal protobuf wire-format reader covering just what weight extraction
needs: ModelProto -> GraphProto -> TensorProto initializers, recursing into
If/Loop subgraphs (the official fused Silero models branch on sample rate).

This replaces the reference's dependency on onnxruntime for v4/v5 weights
(SURVEY.md §7 "hard parts": read the .onnx protobufs directly rather than
adding an inference-engine dependency).

Wire format: each field is a varint key (field_number << 3 | wire_type);
wire types used by ONNX: 0 = varint, 1 = 64-bit, 2 = length-delimited,
5 = 32-bit.
"""

from __future__ import annotations

from pathlib import Path
from typing import Iterator

import numpy as np

# TensorProto.DataType values we decode
_DTYPES = {
    1: np.dtype("<f4"),  # FLOAT
    2: np.dtype("<u1"),  # UINT8
    3: np.dtype("<i1"),  # INT8
    6: np.dtype("<i4"),  # INT32
    7: np.dtype("<i8"),  # INT64
    10: np.dtype("<f2"),  # FLOAT16
    11: np.dtype("<f8"),  # DOUBLE
    9: np.dtype("?"),  # BOOL
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


def _signed(v: int) -> int:
    """Protobuf int64 fields encode negatives as 10-byte two's-complement
    varints; fold back into Python's signed range (axis=-1 etc.)."""
    return v - (1 << 64) if v >= (1 << 63) else v


def _fields(buf: memoryview) -> Iterator[tuple[int, int, object]]:
    """Yield (field_number, wire_type, value) over a message buffer.
    Length-delimited values come back as memoryview slices."""
    pos = 0
    end = len(buf)
    while pos < end:
        key, pos = _read_varint(buf, pos)
        field, wire = key >> 3, key & 7
        if wire == 0:
            val, pos = _read_varint(buf, pos)
        elif wire == 1:
            val = bytes(buf[pos : pos + 8])
            pos += 8
        elif wire == 2:
            length, pos = _read_varint(buf, pos)
            val = buf[pos : pos + length]
            pos += length
        elif wire == 5:
            val = bytes(buf[pos : pos + 4])
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, val


def _parse_tensor(buf: memoryview) -> tuple[str, np.ndarray] | None:
    """TensorProto: dims=1, data_type=2, float_data=4, int32_data=5,
    int64_data=7, name=8, raw_data=9, double_data=10, uint64_data=11."""
    dims: list[int] = []
    dtype_code = 1
    name = ""
    raw: bytes | None = None
    typed: list[float | int] = []
    typed_kind = None
    for field, wire, val in _fields(buf):
        if field == 1 and wire == 0:
            dims.append(val)
        elif field == 1 and wire == 2:  # packed dims
            pos = 0
            mv = val
            while pos < len(mv):
                d, pos = _read_varint(mv, pos)
                dims.append(d)
        elif field == 2 and wire == 0:
            dtype_code = val
        elif field == 8 and wire == 2:
            name = bytes(val).decode("utf-8")
        elif field == 9 and wire == 2:
            raw = bytes(val)
        elif field == 4:  # float_data (packed or repeated fixed32)
            data = bytes(val) if wire == 2 else val
            typed.extend(np.frombuffer(data, dtype="<f4"))
            typed_kind = np.dtype("<f4")
        elif field == 7:  # int64_data (packed varints or single varint)
            if wire == 0:
                typed.append(_signed(val))
            else:
                pos = 0
                while pos < len(val):
                    v, pos = _read_varint(val, pos)
                    typed.append(_signed(v))
            typed_kind = np.dtype("<i8")
        elif field == 5:  # int32_data (also carries int8/16/uint8/16/bool)
            if wire == 0:
                typed.append(_signed(val))
            else:
                pos = 0
                while pos < len(val):
                    v, pos = _read_varint(val, pos)
                    typed.append(_signed(v))
            typed_kind = np.dtype("<i4")
        elif field == 10:  # double_data (packed or repeated fixed64)
            data = bytes(val) if wire == 2 else val
            typed.extend(np.frombuffer(data, dtype="<f8"))
            typed_kind = np.dtype("<f8")
        elif field == 11:  # uint64_data (packed varints or single varint)
            if wire == 0:
                typed.append(val)
            else:
                pos = 0
                while pos < len(val):
                    v, pos = _read_varint(val, pos)
                    typed.append(v)
            typed_kind = np.dtype("<u8")
    dtype = _DTYPES.get(dtype_code)
    if dtype is None:
        return None
    if raw is not None:
        arr = np.frombuffer(raw, dtype=dtype)
    elif typed_kind is not None:
        # typed storage is a CONTAINER (int32_data also carries
        # int8/16/uint8/16/bool) — the declared data_type is the dtype
        arr = np.asarray(typed, dtype=typed_kind).astype(dtype, copy=False)
    else:
        arr = np.zeros(0, dtype=dtype)
    try:
        arr = arr.reshape(dims)
    except ValueError:
        return None
    return name, arr


def _walk_graph(buf: memoryview, out: dict[str, np.ndarray], prefix: str = "") -> None:
    """GraphProto: node=1, initializer=5. Recurse into node attribute
    subgraphs (AttributeProto g=6, graphs=11)."""
    for field, wire, val in _fields(buf):
        if wire != 2:
            continue
        if field == 5:  # initializer
            parsed = _parse_tensor(val)
            if parsed is not None:
                name, arr = parsed
                out[prefix + name] = arr
        elif field == 1:  # node -> attributes (field 5) -> subgraphs
            for nfield, nwire, nval in _fields(val):
                if nfield == 5 and nwire == 2:  # AttributeProto
                    for afield, awire, aval in _fields(nval):
                        if awire == 2 and afield in (6, 11):  # g / graphs
                            _walk_graph(aval, out, prefix)


class OnnxNode:
    """op_type + inputs/outputs + attributes (ints/floats/strings/tensors)
    + subgraphs."""

    __slots__ = ("op_type", "name", "inputs", "outputs", "subgraphs", "attrs")

    def __init__(self):
        self.op_type = ""
        self.name = ""
        self.inputs: list[str] = []
        self.outputs: list[str] = []
        self.subgraphs: list["OnnxGraph"] = []
        self.attrs: dict[str, object] = {}

    def __repr__(self):
        return f"<{self.op_type} {self.inputs} -> {self.outputs}>"


class OnnxGraph:
    """Nodes in graph order plus initializers and declared graph I/O names,
    with nested subgraphs. Nodes are topologically ordered per the ONNX
    spec, so execution is a single in-order pass."""

    __slots__ = (
        "name",
        "nodes",
        "initializers",
        "inputs",
        "outputs",
        "input_shapes",
    )

    def __init__(self):
        self.name = ""
        self.nodes: list[OnnxNode] = []
        self.initializers: dict[str, np.ndarray] = {}
        self.inputs: list[str] = []
        self.outputs: list[str] = []
        # declared input shapes: name -> tuple of dims (int for fixed,
        # None for symbolic/dynamic) — what the reference's ORT backend
        # probes for batch/sequence restrictions (onnx_helpers.c:192-275)
        self.input_shapes: dict[str, tuple] = {}

    def all_initializers(self) -> dict[str, np.ndarray]:
        out = dict(self.initializers)
        for node in self.nodes:
            for sub in node.subgraphs:
                out.update(sub.all_initializers())
        return out


def _parse_node(buf: memoryview) -> OnnxNode:
    """NodeProto: input=1, output=2, name=3, op_type=4, attribute=5."""
    node = OnnxNode()
    for field, wire, val in _fields(buf):
        if wire != 2:
            continue
        if field == 1:
            node.inputs.append(bytes(val).decode("utf-8"))
        elif field == 2:
            node.outputs.append(bytes(val).decode("utf-8"))
        elif field == 3:
            node.name = bytes(val).decode("utf-8")
        elif field == 4:
            node.op_type = bytes(val).decode("utf-8")
        elif field == 5:
            # AttributeProto: name=1, f=2, i=3, s=4, t=5, g=6, floats=7,
            # ints=8, graphs=11
            aname = None
            aint = None
            aints: list[int] = []
            astr = None
            afloat = None
            afloats: list[float] = []
            atensor = None
            agraph = None
            for afield, awire, aval in _fields(val):
                if afield == 1 and awire == 2:
                    aname = bytes(aval).decode("utf-8")
                elif afield == 2 and awire == 5:
                    afloat = float(np.frombuffer(aval, "<f4")[0])
                elif afield == 4 and awire == 2:
                    astr = bytes(aval).decode("utf-8", "replace")
                elif afield == 3 and awire == 0:
                    aint = _signed(aval)
                elif afield == 5 and awire == 2:  # t: TensorProto
                    parsed = _parse_tensor(aval)
                    if parsed is not None:
                        atensor = parsed[1]
                elif afield == 7:
                    if awire == 5:
                        afloats.append(float(np.frombuffer(aval, "<f4")[0]))
                    else:  # packed
                        afloats.extend(
                            np.frombuffer(bytes(aval), "<f4").tolist()
                        )
                elif afield == 8:
                    if awire == 0:
                        aints.append(_signed(aval))
                    else:  # packed
                        pos = 0
                        while pos < len(aval):
                            v, pos = _read_varint(aval, pos)
                            aints.append(_signed(v))
                elif awire == 2 and afield in (6, 11):
                    agraph = _parse_graph(aval)
                    node.subgraphs.append(agraph)
            if aname is not None:
                if agraph is not None:
                    # named subgraph attribute (then_branch / else_branch /
                    # body) — the executor selects branches by this name
                    node.attrs[aname] = agraph
                elif atensor is not None:
                    node.attrs[aname] = atensor
                elif astr is not None:
                    node.attrs[aname] = astr
                elif afloats:
                    node.attrs[aname] = afloats
                elif afloat is not None:
                    node.attrs[aname] = afloat
                else:
                    node.attrs[aname] = aints if aints else aint
    return node


def _value_info_name(buf: memoryview) -> str:
    """ValueInfoProto: name=1."""
    for field, wire, val in _fields(buf):
        if field == 1 and wire == 2:
            return bytes(val).decode("utf-8")
    return ""


def _value_info_shape(buf: memoryview) -> tuple | None:
    """ValueInfoProto -> declared tensor shape, or None when absent.

    ValueInfoProto.type=2 (TypeProto) -> tensor_type=1 (TypeProto.Tensor)
    -> shape=2 (TensorShapeProto) -> dim=1 (Dimension: dim_value=1,
    dim_param=2). Fixed dims come back as ints, symbolic ones as None."""
    for field, wire, val in _fields(buf):
        if field != 2 or wire != 2:
            continue
        for tfield, twire, tval in _fields(val):
            if tfield != 1 or twire != 2:
                continue
            for sfield, swire, sval in _fields(tval):
                if sfield != 2 or swire != 2:
                    continue
                dims: list[int | None] = []
                for dfield, dwire, dval in _fields(sval):
                    if dfield != 1 or dwire != 2:
                        continue
                    dim: int | None = None
                    for ffield, fwire, fval in _fields(dval):
                        if ffield == 1 and fwire == 0:
                            dim = _signed(fval)
                    dims.append(dim)
                return tuple(dims)
    return None


def _parse_graph(buf: memoryview) -> OnnxGraph:
    """GraphProto: node=1, name=2, initializer=5, input=11, output=12."""
    graph = OnnxGraph()
    for field, wire, val in _fields(buf):
        if wire != 2:
            continue
        if field == 1:
            graph.nodes.append(_parse_node(val))
        elif field == 2:
            graph.name = bytes(val).decode("utf-8")
        elif field == 5:
            parsed = _parse_tensor(val)
            if parsed is not None:
                graph.initializers[parsed[0]] = parsed[1]
        elif field == 11:
            name = _value_info_name(val)
            graph.inputs.append(name)
            shape = _value_info_shape(val)
            if shape is not None:
                graph.input_shapes[name] = shape
        elif field == 12:
            graph.outputs.append(_value_info_name(val))
    return graph


def parse_model(path: str | Path) -> OnnxGraph:
    """Parse an .onnx file into its top-level graph (with nested subgraphs)."""
    data = memoryview(Path(path).read_bytes())
    for field, wire, val in _fields(data):
        if field == 7 and wire == 2:
            return _parse_graph(val)
    raise ValueError(f"{path}: no graph found")


def lstm_hidden_sizes(graph: OnnxGraph) -> set[int]:
    """Hidden size of every LSTM node (subgraphs included). The
    ``hidden_size`` attribute is OPTIONAL in the ONNX spec, so fall back to
    the recurrence tensor R [num_dirs, 4H, H] (LSTM input 2) when a
    re-export omits it — the executor itself infers it the same way."""
    init = graph.all_initializers()
    sizes: set[int] = set()

    def walk(g: OnnxGraph) -> None:
        for node in g.nodes:
            if node.op_type == "LSTM":
                hs = node.attrs.get("hidden_size")
                if hs is not None:
                    sizes.add(int(hs))
                elif len(node.inputs) >= 3 and node.inputs[2] in init:
                    r = init[node.inputs[2]]
                    if r.ndim == 3:
                        sizes.add(int(r.shape[2]))
            for sub in node.subgraphs:
                walk(sub)

    walk(graph)
    return sizes


def classify_model(path: str | Path) -> str:
    """Positively classify an .onnx file as 'v3', 'v4', or 'v5' from graph
    markers, mirroring the reference's runtime introspection
    (onnx_helpers.c:154-161: LSTM hidden size 128 => v5, else v3/v4;
    onnx_helpers.c:314-357: scalar sr input => fused v4/v5 model).

    Raises ValueError("unrecognized model graph (...)") for anything that
    doesn't carry the markers — corrupt files included — so the CLI can
    print the one-line diagnosis it promises instead of an unrelated
    extraction error."""
    try:
        graph = parse_model(path)
    except Exception as e:
        raise ValueError(
            f"unrecognized model graph (not parseable as ONNX: {e})"
        ) from None

    hidden_sizes = lstm_hidden_sizes(graph)
    has_sr_input = any(n in ("sr", "sample_rate") for n in graph.inputs)
    if 128 in hidden_sizes:
        return "v5"
    if 64 in hidden_sizes:
        return "v4" if has_sr_input else "v3"
    # weight-archive-style .onnx without executable nodes (e.g. a stripped
    # re-export): classify by the jit parameter names that survive export
    init_names = graph.all_initializers().keys()
    if any("reparam_conv" in n for n in init_names):
        return "v5"
    raise ValueError(
        "unrecognized model graph (no Silero LSTM marker: "
        f"hidden sizes {sorted(hidden_sizes) or 'none'}, "
        f"inputs {graph.inputs})"
    )


def extract_initializers(path: str | Path) -> dict[str, np.ndarray]:
    """All initializer tensors of an .onnx model (including If/Loop
    subgraphs), keyed by initializer name."""
    data = memoryview(Path(path).read_bytes())
    out: dict[str, np.ndarray] = {}
    for field, wire, val in _fields(data):
        if field == 7 and wire == 2:  # ModelProto.graph
            _walk_graph(val, out)
    return out
