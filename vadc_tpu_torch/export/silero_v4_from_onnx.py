# Copy of vadc_tpu/export/silero_v4_from_onnx.py (numpy only): the port imports nothing of vadc_tpu
# and keeps its own; tests/test_torch_copies.py holds it to the original.
"""Silero v4 weight extraction from the official fused .onnx model.

The official v4 model is a single ONNX graph with a top-level If branching on
sample rate (16 kHz branch: stage-3 conv stride 2, matching encoder(is_v4=
True, sr=16000), reference silero_vad.py:175-178). BatchNorm is constant-
folded into the 1x1 convs at export time, so the extracted archive has no
batch_norm tensors and the runtime skips that step.

Extraction is graph-aware, not name-based (initializers are anonymous
numeric names): Conv nodes are walked in graph order and classified by
shape/group/stride; the pointwise-vs-projection ambiguity inside a ConvBlock
is resolved by dataflow (the pointwise conv consumes the depthwise ReLU
output; the projection consumes the block input). ONNX LSTM weights use gate
order i,o,f,c and separate W/R/B — converted to the fused torch-order
(i,f,g,o) ih|hh layout the runtime's LSTM cell expects.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from vadc_tpu_torch.export.onnx_extract import OnnxGraph, OnnxNode, parse_model
from vadc_tpu_torch.io.testtensor import save_testtensor

# ONNX LSTM gate blocks [i, o, f, c] -> torch/fused order [i, f, g(=c), o]
_ONNX_TO_TORCH_GATES = (0, 2, 3, 1)


def _reorder_gates(mat: np.ndarray, hidden: int) -> np.ndarray:
    blocks = [mat[g * hidden : (g + 1) * hidden] for g in _ONNX_TO_TORCH_GATES]
    return np.concatenate(blocks, axis=0)


def convert_onnx_lstm(W: np.ndarray, R: np.ndarray, B: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """ONNX LSTM (W [1,4H,I], R [1,4H,H], B [1,8H], gates iofc) ->
    (fused weights [4H, I+H], fused bias [4H]) in torch gate order."""
    hidden = R.shape[-1]
    w = _reorder_gates(W[0], hidden)
    r = _reorder_gates(R[0], hidden)
    wb = _reorder_gates(B[0, : 4 * hidden], hidden)
    rb = _reorder_gates(B[0, 4 * hidden :], hidden)
    return np.concatenate([w, r], axis=-1), wb + rb


def _find_lstm_stacks(graph: OnnxGraph) -> list[list[OnnxNode]]:
    """Collect per-subgraph LSTM node lists (the model duplicates the LSTM
    stack across inner If branches)."""
    stacks: list[list[OnnxNode]] = []

    def walk(g: OnnxGraph):
        local = [n for n in g.nodes if n.op_type == "LSTM"]
        if local:
            stacks.append(local)
        for n in g.nodes:
            for s in n.subgraphs:
                walk(s)

    walk(graph)
    return stacks


def select_branch(model: OnnxGraph, sample_rate: int) -> OnnxGraph:
    """Pick the sample-rate branch of the top-level If: the 16 kHz branch is
    the one whose third stage conv (the 12th 1x1 conv) has stride 2."""
    top_if = next(n for n in model.nodes if n.op_type == "If")
    candidates = []
    for branch in top_if.subgraphs:
        convs = [n for n in branch.nodes if n.op_type == "Conv"]
        stage3_stride = convs[12].attrs.get("strides", [1])[0]
        candidates.append((stage3_stride, branch))
    candidates.sort()  # stride 1 first
    if sample_rate == 16000:
        return candidates[-1][1]
    return candidates[0][1]


def extract_silero_v4(
    path: str | Path, sample_rate: int = 16000
) -> dict[str, np.ndarray]:
    """Build the v4 weight archive from the official fused silero_vad_v4.onnx."""
    model = parse_model(path)
    branch = select_branch(model, sample_rate)
    inits = {**model.initializers, **branch.all_initializers()}

    def weight(node: OnnxNode, idx: int = 1) -> np.ndarray:
        return inits[node.inputs[idx]]

    convs = [n for n in branch.nodes if n.op_type == "Conv"]
    assert len(convs) == 18, f"expected 18 convs, got {len(convs)}"
    assert weight(convs[0]).shape[-1] == 256, "conv 0 should be the STFT basis"

    archive: dict[str, np.ndarray] = {
        "forward_basis_buffer": weight(convs[0]),
    }

    # Fixed conv layout of the v4 trace (verified by shape/group asserts):
    # per stage: dw, pw, [proj], stage conv; stage 3 has no projection.
    # convs[1] is the adaptive-norm 7-tap smoother (weights are the fixed
    # constants baked into the runtime; not archived).
    stage_slices = {
        1: (2, 3, 4, 5),  # dw, pw, proj, conv
        2: (6, 7, 8, 9),
        3: (10, 11, None, 12),
        4: (13, 14, 15, 16),
    }
    for stage, (dw_i, pw_i, proj_i, conv_i) in stage_slices.items():
        prefix = f"stage{stage}."
        dw, stage_conv = convs[dw_i], convs[conv_i]
        assert dw.attrs.get("group", 1) > 1, f"stage {stage}: conv {dw_i} not depthwise"
        assert weight(dw).shape[-1] == 5, f"stage {stage}: dw kernel != 5"
        cw = weight(stage_conv)
        assert cw.shape[0] == cw.shape[1] and cw.shape[-1] == 1, (
            f"stage {stage}: conv {conv_i} not a square 1x1 conv"
        )
        if proj_i is not None:
            # Disambiguate pw vs proj by dataflow: the projection consumes
            # the block input (= the dw conv's input tensor).
            a, b = convs[pw_i], convs[proj_i]
            if a.inputs[0] == dw.inputs[0]:
                proj, pw = a, b
            else:
                pw, proj = a, b
            archive[prefix + "proj_weights"] = weight(proj)
            archive[prefix + "proj_biases"] = weight(proj, 2)
        else:
            pw = convs[pw_i]
        archive[prefix + "dw_conv_weights"] = weight(dw)
        archive[prefix + "dw_conv_biases"] = weight(dw, 2)
        archive[prefix + "pw_conv_weights"] = weight(pw)
        archive[prefix + "pw_conv_biases"] = weight(pw, 2)
        archive[prefix + "conv_weights"] = cw
        archive[prefix + "conv_biases"] = weight(stage_conv, 2)

    decoder = convs[17]
    archive["decoder_weights"] = weight(decoder)
    archive["decoder_biases"] = weight(decoder, 2)

    # LSTM: 2 layers; the stack is duplicated across inner If branches with
    # separate initializer copies — verify the copies agree, then fuse.
    stacks = _find_lstm_stacks(branch)
    assert stacks and all(len(s) == 2 for s in stacks), "expected 2-layer LSTM stacks"
    first = stacks[0]
    for other in stacks[1:]:
        for a, b in zip(first, other):
            for idx in (1, 2, 3):
                np.testing.assert_array_equal(weight(a, idx), weight(b, idx))
    ws, bs = [], []
    for node in first:
        w, b = convert_onnx_lstm(weight(node, 1), weight(node, 2), weight(node, 3))
        ws.append(w)
        bs.append(b)
    archive["weights"] = np.stack(ws)
    archive["biases"] = np.stack(bs)
    # record which branch this is so the runtime picks the right strides
    archive["meta.sample_rate"] = np.asarray([float(sample_rate)], np.float32)
    return archive


def export_v4(onnx_path: str | Path, out_path: str | Path, sample_rate: int = 16000) -> None:
    save_testtensor(out_path, extract_silero_v4(onnx_path, sample_rate))
