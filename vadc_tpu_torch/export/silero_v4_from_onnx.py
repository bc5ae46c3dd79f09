# Copy of the part of vadc_tpu/export/silero_v4_from_onnx.py (numpy only) that
# the v3 extractor needs: the port imports nothing of vadc_tpu and keeps its
# own; tests/test_torch_copies.py holds it to the original.
"""The ONNX LSTM tensor conversion shared by the v3 and v4 extractors.

The v4 extractor itself (branch selection, graph walk) waits for the port's
v4/v5 .onnx loading (ROADMAP.md, Queue 1)."""

from __future__ import annotations

import numpy as np

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
