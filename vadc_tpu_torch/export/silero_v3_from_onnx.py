# Copy of vadc_tpu/export/silero_v3_from_onnx.py (numpy only): the port imports nothing of vadc_tpu
# and keeps its own; tests/test_torch_copies.py holds it to the original.
"""Silero v3 weight extraction from the official .onnx model.

The official v3 export names its conv-block weights, biases, and norms, but
the transformer matmul weights (QKV / out_proj / linear1 / linear2), the
strided stage convs, and the LSTM tensors are anonymous initializers; batch
norm is constant-folded into the stage convs. This extractor combines:

  * named initializers for the conv blocks, norms, attention/linear biases,
    decoder, STFT basis;
  * anonymous MatMul weights taken in graph order (per layer: QKV, out_proj,
    linear1, linear2 — MatMul stores them [in, out], transposed here to the
    torch [out, in] convention; identified per layer by shape);
  * anonymous square 1x1 stage convs in graph order (BN pre-folded, so the
    archive carries no batch_norm tensors and the runtime skips that step);
  * ONNX LSTM tensors converted from iofc W/R/B to the fused torch-order
    layout (shared with the v4 extractor).

Verified against the tracked golden archive: every named tensor and every
recovered matmul/LSTM tensor is bit-identical to
testdata/silero_v31_16k.testtensor (the .onnx ships the same v3.1 16k
weights; only the BN-folded stage convs differ, by construction).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from vadc_tpu_torch.export.onnx_extract import parse_model
from vadc_tpu_torch.export.silero_v4_from_onnx import convert_onnx_lstm
from vadc_tpu_torch.io.testtensor import save_testtensor

# named-initializer prefixes per encoder stage (stage 1's conv block is the
# standalone first_layer module)
_STAGE_PREFIXES = (
    ("first_layer.0.", "encoder.0."),
    ("encoder.4.0.", "encoder.5."),
    ("encoder.9.0.", "encoder.10."),
    ("encoder.14.0.", "encoder.15."),
)
_HAS_PROJ = (True, True, False, True)


def extract_silero_v3(path: str | Path) -> dict[str, np.ndarray]:
    model = parse_model(path)
    inits = model.all_initializers()

    archive: dict[str, np.ndarray] = {
        "forward_basis_buffer": inits["feature_extractor.forward_basis_buffer"]
    }

    # anonymous transformer matmul weights, in graph order
    matmul_w = [
        inits[n.inputs[1]]
        for n in model.nodes
        if n.op_type == "MatMul" and n.inputs[1] in inits
    ]
    assert len(matmul_w) == 16, f"expected 16 weighted MatMuls, got {len(matmul_w)}"

    # anonymous square 1x1 stage convs, in graph order
    stage_convs = [
        (inits[n.inputs[1]], inits[n.inputs[2]] if len(n.inputs) > 2 else None)
        for n in model.nodes
        if n.op_type == "Conv"
        and n.inputs[1] in inits
        and n.inputs[1].isdigit()
        and inits[n.inputs[1]].shape[-1] == 1
        and inits[n.inputs[1]].shape[0] == inits[n.inputs[1]].shape[1]
    ]
    assert len(stage_convs) == 4, f"expected 4 stage convs, got {len(stage_convs)}"

    for i, ((cb_prefix, tl_prefix), has_proj) in enumerate(
        zip(_STAGE_PREFIXES, _HAS_PROJ)
    ):
        out = f"transformer_l{i + 1}."
        archive[out + "dw_conv_weights"] = inits[cb_prefix + "dw_conv.0.weight"]
        archive[out + "dw_conv_biases"] = inits[cb_prefix + "dw_conv.0.bias"]
        archive[out + "pw_conv_weights"] = inits[cb_prefix + "pw_conv.0.weight"]
        archive[out + "pw_conv_biases"] = inits[cb_prefix + "pw_conv.0.bias"]
        if has_proj:
            archive[out + "proj_weights"] = inits[cb_prefix + "proj.weight"]
            archive[out + "proj_biases"] = inits[cb_prefix + "proj.bias"]
        qkv, att_proj, lin1, lin2 = matmul_w[i * 4 : (i + 1) * 4]
        archive[out + "attention_weights"] = np.ascontiguousarray(qkv.T)
        archive[out + "attention_proj_weights"] = np.ascontiguousarray(att_proj.T)
        archive[out + "linear1_weights"] = np.ascontiguousarray(lin1.T)
        archive[out + "linear2_weights"] = np.ascontiguousarray(lin2.T)
        for name in (
            "attention.QKV.bias",
            "attention.out_proj.bias",
            "linear1.bias",
            "linear2.bias",
            "norm1.weight",
            "norm1.bias",
            "norm2.weight",
            "norm2.bias",
        ):
            out_key = (
                name.replace("attention.QKV.bias", "attention_biases")
                .replace("attention.out_proj.bias", "attention_proj_biases")
                .replace("linear1.bias", "linear1_biases")
                .replace("linear2.bias", "linear2_biases")
                .replace("norm1.weight", "norm1_weights")
                .replace("norm1.bias", "norm1_biases")
                .replace("norm2.weight", "norm2_weights")
                .replace("norm2.bias", "norm2_biases")
            )
            archive[out + out_key] = inits[tl_prefix + name]
        conv_w, conv_b = stage_convs[i]
        archive[out + "conv_weights"] = conv_w
        assert conv_b is not None, f"stage {i + 1} conv has no bias"
        archive[out + "conv_biases"] = conv_b
        # batch norm is folded into the stage conv by the official export

    # LSTM: two stacked 1-layer ONNX LSTM nodes in graph order
    lstm_nodes = [n for n in model.nodes if n.op_type == "LSTM"]
    assert len(lstm_nodes) == 2, f"expected 2 LSTM nodes, got {len(lstm_nodes)}"
    ws, bs = [], []
    for node in lstm_nodes:
        w, b = convert_onnx_lstm(
            inits[node.inputs[1]], inits[node.inputs[2]], inits[node.inputs[3]]
        )
        ws.append(w)
        bs.append(b)
    archive["weights"] = np.stack(ws)
    archive["biases"] = np.stack(bs)

    archive["decoder_weights"] = inits["decoder.1.weight"]
    archive["decoder_biases"] = inits["decoder.1.bias"]
    return archive


def export_v3(onnx_path: str | Path, out_path: str | Path) -> None:
    save_testtensor(out_path, extract_silero_v3(onnx_path))
