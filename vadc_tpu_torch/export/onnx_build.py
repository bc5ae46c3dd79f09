"""Minimal ONNX writer + an executable official-topology Silero v5 builder.

The writer is the serialization mirror of onnx_extract's reader: enough of
the protobuf wire format to emit graphs with nodes, attributes (ints,
floats, strings, tensors, subgraphs), initializers, and declared I/O. No
dependency on the `onnx` package (not present in this environment, and
torch.onnx.export requires it).

`build_silero_v5_onnx` assembles a COMPLETE executable fused v5 model —
Pad(reflect) -> STFT Conv -> magnitude -> 4 reparam convs -> LSTM ->
decoder, both sample-rate branches behind an If on the scalar `sr` input,
official jit initializer names — from runtime weight archives. With the
random-weight archives from models/synthetic.py this gives CI a
*behavior-level* v5 oracle: the numpy graph executor (onnx_exec) runs this
graph through standard ONNX op semantics (including the ONNX LSTM's i,o,f,c
gate order), so a JAX-forward mismatch exposes weight-layout or topology
mistakes that weight-roundtrip tests cannot see. The day real v5 weights
appear, tools/validate_v5.py runs the same harness against the official
file unchanged (reference analogue: onnx_helpers.c:532-549 executes the
graph through ORT).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

# ---- wire-format primitives ------------------------------------------------


def _varint(v: int) -> bytes:
    if v < 0:
        v += 1 << 64  # two's-complement 10-byte form (negative axes etc.)
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        out.append(b | (0x80 if v else 0))
        if not v:
            return bytes(out)


def _key(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _len_field(field: int, payload: bytes) -> bytes:
    return _key(field, 2) + _varint(len(payload)) + payload


_TENSOR_DTYPE = {
    np.dtype("float32"): 1,
    np.dtype("int64"): 7,
    np.dtype("float64"): 11,
    np.dtype("int32"): 6,
    np.dtype("bool"): 9,
}


def tensor_proto(name: str, arr: np.ndarray) -> bytes:
    """TensorProto: dims=1, data_type=2, name=8, raw_data=9."""
    arr = np.asarray(arr)
    code = _TENSOR_DTYPE[arr.dtype]
    out = b""
    for d in arr.shape:
        out += _key(1, 0) + _varint(d)
    out += _key(2, 0) + _varint(code)
    if name:
        out += _len_field(8, name.encode())
    out += _len_field(9, arr.tobytes())
    return out


class SubGraph:
    """Marker wrapping already-serialized GraphProto bytes for graph attrs."""

    def __init__(self, data: bytes):
        self.data = data


def _attribute(name: str, val) -> bytes:
    """AttributeProto: name=1, f=2, i=3, s=4, t=5, g=6, ints=8."""
    out = _len_field(1, name.encode())
    if isinstance(val, SubGraph):
        out += _len_field(6, val.data)
    elif isinstance(val, np.ndarray):
        out += _len_field(5, tensor_proto("", val))
    elif isinstance(val, str):
        out += _len_field(4, val.encode())
    elif isinstance(val, float):
        out += _key(2, 5) + np.float32(val).tobytes()
    elif isinstance(val, (list, tuple)):
        for v in val:
            out += _key(8, 0) + _varint(int(v))
    elif isinstance(val, (int, np.integer)):
        out += _key(3, 0) + _varint(int(val))
    else:
        raise TypeError(f"unsupported attribute {name}={val!r}")
    return out


def node(op_type: str, inputs: list[str], outputs: list[str], **attrs) -> bytes:
    """NodeProto: input=1, output=2, op_type=4, attribute=5."""
    out = b""
    for i in inputs:
        out += _len_field(1, i.encode())
    for o in outputs:
        out += _len_field(2, o.encode())
    out += _len_field(4, op_type.encode())
    for aname, aval in attrs.items():
        out += _len_field(5, _attribute(aname, aval))
    return out


def graph(
    nodes: list[bytes],
    *,
    name: str = "g",
    inputs: list[str] = (),
    outputs: list[str] = (),
    initializers: dict[str, np.ndarray] | None = None,
) -> bytes:
    """GraphProto: node=1, name=2, initializer=5, input=11, output=12."""
    out = b""
    for n in nodes:
        out += _len_field(1, n)
    out += _len_field(2, name.encode())
    for iname, arr in (initializers or {}).items():
        out += _len_field(5, tensor_proto(iname, arr))
    for i in inputs:
        out += _len_field(11, _len_field(1, i.encode()))
    for o in outputs:
        out += _len_field(12, _len_field(1, o.encode()))
    return out


def model(graph_bytes: bytes, *, opset: int = 17) -> bytes:
    """ModelProto: ir_version=1, opset_import=8 (version=2), graph=7."""
    out = _key(1, 0) + _varint(8)  # ir_version 8
    out += _len_field(8, _key(2, 0) + _varint(opset))
    out += _len_field(7, graph_bytes)
    return out


# ---- executable fused Silero v5 -------------------------------------------


def _onnx_lstm_weights(fused_w: np.ndarray, fused_b: np.ndarray):
    """Runtime archive LSTM (torch gate order i,f,g,o; fused [4H, I+H];
    pre-summed bias) -> ONNX LSTM W/R/B (gate order i,o,f,c; B = Wb|Rb)."""
    w = np.asarray(fused_w)[0]  # [512, 256]
    b = np.asarray(fused_b)[0]  # [512]
    hidden = w.shape[0] // 4
    i, f, g, o = (w[k * hidden : (k + 1) * hidden] for k in range(4))
    reord = np.concatenate([i, o, f, g], axis=0)
    bi, bf, bg, bo = (b[k * hidden : (k + 1) * hidden] for k in range(4))
    b_reord = np.concatenate([bi, bo, bf, bg])
    W = reord[:, : w.shape[1] - hidden][None]  # [1, 4H, I]
    R = reord[:, w.shape[1] - hidden :][None]  # [1, 4H, H]
    B = np.concatenate([b_reord, np.zeros_like(b_reord)])[None]  # [1, 8H]
    return W.astype(np.float32), R.astype(np.float32), B.astype(np.float32)


def _v5_branch(archive: dict, prefix: str, *, hop: int, pad_right: int) -> bytes:
    """One sample-rate branch: the official v5 math over the enclosing
    scope's `input` [B, ctx+window] and `state` [2, B, 128]."""
    cutoff = archive["forward_basis_buffer"].shape[0] // 2
    n = lambda s: f"{prefix}{s}"  # noqa: E731 — branch-local namespacing
    init = {
        n("stft.forward_basis_buffer"): np.asarray(
            archive["forward_basis_buffer"], np.float32
        ),
        n("pads"): np.asarray([0, 0, 0, pad_right], np.int64),
        n("re_start"): np.asarray([0], np.int64),
        n("re_end"): np.asarray([cutoff], np.int64),
        n("im_end"): np.asarray([2 * cutoff], np.int64),
        n("ax1"): np.asarray([1], np.int64),
        n("h_start"): np.asarray([0], np.int64),
        n("h_end"): np.asarray([1], np.int64),
        n("c_end"): np.asarray([2], np.int64),
        n("ax0"): np.asarray([0], np.int64),
    }
    for i in range(4):
        init[n(f"encoder.{i}.reparam_conv.weight")] = np.asarray(
            archive[f"enc{i + 1}.weight"], np.float32
        )
        init[n(f"encoder.{i}.reparam_conv.bias")] = np.asarray(
            archive[f"enc{i + 1}.bias"], np.float32
        )
    # official jit names for the torch-order pair (what the extractor reads)
    w = np.asarray(archive["weights"])[0]
    init[n("decoder.rnn.weight_ih_l0")] = w[:, :128].copy()
    init[n("decoder.rnn.weight_hh_l0")] = w[:, 128:].copy()
    init[n("decoder.rnn.bias_ih_l0")] = np.asarray(archive["biases"])[0].copy()
    init[n("decoder.rnn.bias_hh_l0")] = np.zeros(512, np.float32)
    # ONNX-order weights actually consumed by the LSTM node
    W, R, B = _onnx_lstm_weights(archive["weights"], archive["biases"])
    init[n("lstm.W")] = W
    init[n("lstm.R")] = R
    init[n("lstm.B")] = B
    dec_w = np.asarray(archive["decoder_weights"], np.float32).reshape(1, 128, 1)
    init[n("decoder.decoder.2.weight")] = dec_w
    init[n("decoder.decoder.2.bias")] = np.asarray(
        archive["decoder_biases"], np.float32
    )

    nodes = [
        node("Pad", ["input", n("pads")], [n("padded")], mode="reflect"),
        node("Unsqueeze", [n("padded"), n("ax1")], [n("x3d")]),
        node(
            "Conv",
            [n("x3d"), n("stft.forward_basis_buffer")],
            [n("spect")],
            kernel_shape=[2 * hop],
            strides=[hop],
            pads=[0, 0],
        ),
        node(
            "Slice",
            [n("spect"), n("re_start"), n("re_end"), n("ax1")],
            [n("re")],
        ),
        node(
            "Slice",
            [n("spect"), n("re_end"), n("im_end"), n("ax1")],
            [n("im")],
        ),
        node("Mul", [n("re"), n("re")], [n("re2")]),
        node("Mul", [n("im"), n("im")], [n("im2")]),
        node("Add", [n("re2"), n("im2")], [n("power")]),
        node("Sqrt", [n("power")], [n("mag")]),
    ]
    x = n("mag")
    for i, stride in enumerate((1, 2, 2, 1)):
        nodes += [
            node(
                "Conv",
                [x, n(f"encoder.{i}.reparam_conv.weight"), n(f"encoder.{i}.reparam_conv.bias")],
                [n(f"enc{i}")],
                kernel_shape=[3],
                strides=[stride],
                pads=[1, 1],
            ),
            node("Relu", [n(f"enc{i}")], [n(f"enc{i}r")]),
        ]
        x = n(f"enc{i}r")
    nodes += [
        # [B, 128, T] -> [T, B, 128] (ONNX LSTM layout)
        node("Transpose", [x], [n("lstm_in")], perm=[2, 0, 1]),
        node("Slice", ["state", n("h_start"), n("h_end"), n("ax0")], [n("h0")]),
        node("Slice", ["state", n("h_end"), n("c_end"), n("ax0")], [n("c0")]),
        node(
            "LSTM",
            [n("lstm_in"), n("lstm.W"), n("lstm.R"), n("lstm.B"), "", n("h0"), n("c0")],
            [n("Y"), n("Yh"), n("Yc")],
            hidden_size=128,
        ),
        node("Squeeze", [n("Y"), n("ax1")], [n("seq")]),  # [T, B, 128]
        node("Transpose", [n("seq")], [n("btf")], perm=[1, 2, 0]),  # [B,128,T]
        node("Relu", [n("btf")], [n("dec_in")]),
        node(
            "Conv",
            [n("dec_in"), n("decoder.decoder.2.weight"), n("decoder.decoder.2.bias")],
            [n("logits")],
            kernel_shape=[1],
            strides=[1],
            pads=[0, 0],
        ),
        node("Sigmoid", [n("logits")], [n("probs_t")]),
        node("ReduceMean", [n("probs_t")], [n("out")], axes=[2], keepdims=0),
        node("Concat", [n("Yh"), n("Yc")], [n("staten")], axis=0),
    ]
    return graph(
        nodes,
        name=prefix.rstrip("."),
        outputs=[n("out"), n("staten")],
        initializers=init,
    )


def build_silero_v5_onnx(
    path: str | Path, archive_16k: dict, archive_8k: dict
) -> None:
    """Write an executable fused v5 model: If(sr == 16000) selects the
    branch, official input/output naming (input, state, sr -> output,
    stateN)."""
    b16 = _v5_branch(archive_16k, "_model.", hop=128, pad_right=64)
    b8 = _v5_branch(archive_8k, "_model_8k.", hop=64, pad_right=32)
    top = graph(
        [
            node("Equal", ["sr", "sixteen_k"], ["is_16k"]),
            node(
                "If",
                ["is_16k"],
                ["output", "stateN"],
                then_branch=SubGraph(b16),
                else_branch=SubGraph(b8),
            ),
        ],
        name="silero_v5",
        inputs=["input", "state", "sr"],
        outputs=["output", "stateN"],
        initializers={"sixteen_k": np.asarray(16000, np.int64)},
    )
    Path(path).write_bytes(model(top))
