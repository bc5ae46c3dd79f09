# Copy of vadc_tpu/engine/onnx_backend.py (numpy only): the port imports nothing of vadc_tpu
# and keeps its own; tests/test_torch_copies.py holds it to the original.
"""Executor-backed ONNX runner: run ANY Silero-shaped .onnx, introspected.

The reference's ORT backend can execute arbitrary official or re-exported
Silero models, reading each model's restrictions from the graph at runtime
(batch restriction onnx_helpers.c:192-227, sequence restriction :230-275,
output rank :277-312, sr input :314-357, LSTM hidden size :359-410). The
extraction path (models/weights.load_params) covers the three known
architectures with full TPU speed; THIS backend covers the long tail — a
re-exported graph whose topology deviates from the known shapes — by
executing the graph itself with the numpy executor (export/onnx_exec).

Semantics: chunks are processed sequentially with LSTM state threaded
chunk-to-chunk — the C backend's flatten-to-one-sequence contract
(lstm.c:275-277), which the CLI's golden tests pin. (The reference's ORT
path at batch>1 instead gives each batch row its previous same-row state —
the documented stale-probability quirk, vadc.c:88-99; sequential batch-1
processing is the quirk-free limit both backends agree on.)

This is a correctness/compatibility path (CPU-speed, ~30 ms per chunk for
v3), not the production TPU path; the CLI selects it via --onnx_exec or
falls back to it when a recognized graph defeats weight extraction.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from vadc_tpu_torch.export.onnx_exec import OnnxExecutor
from vadc_tpu_torch.export.onnx_extract import parse_model


class ModelRestrictions(NamedTuple):
    """What the graph declares about itself (onnx_helpers.c:192-410)."""

    batch: int  # -1 unrestricted, else the fixed batch the graph demands
    sequence: int  # -1 unrestricted, else fixed chunk samples
    has_sr_input: bool
    hidden: int  # LSTM hidden size: 64 (v3/v4) or 128 (v5)
    num_state_inputs: int  # 2 (h,c) or 1 (fused v5 state)
    prob_rank3: bool  # v3-style [B,2,1] output (prob at index 1)


def introspect(model) -> ModelRestrictions:
    """Read the graph's declared restrictions. `model` is a path or an
    already-parsed OnnxGraph (so the runner parses the file exactly once)."""
    from vadc_tpu_torch.export.onnx_extract import OnnxGraph, lstm_hidden_sizes

    graph = model if isinstance(model, OnnxGraph) else parse_model(model)
    init = set(graph.all_initializers())
    real_inputs = [n for n in graph.inputs if n not in init]
    shapes = {n: graph.input_shapes.get(n) for n in real_inputs}

    sr = any(n in ("sr", "sample_rate") for n in real_inputs)
    state_names = [n for n in real_inputs[1:] if n not in ("sr", "sample_rate")]

    hidden = 64
    hidden_sizes = lstm_hidden_sizes(graph)
    if hidden_sizes:
        hidden = max(hidden_sizes)
    elif state_names and shapes.get(state_names[0]):
        hidden = shapes[state_names[0]][-1] or 64

    # batch restriction: fixed input dim 0, and additionally batch 1 when
    # the LSTM state is not minibatch-aware (onnx_helpers.c:146-151)
    audio_shape = shapes.get(real_inputs[0]) if real_inputs else None
    batch = -1
    if audio_shape and len(audio_shape) >= 1 and audio_shape[0] is not None:
        batch = int(audio_shape[0])
    for sn in state_names:
        s = shapes.get(sn)
        if s and len(s) >= 2 and s[1] == 1:
            batch = 1
    sequence = -1
    if audio_shape and len(audio_shape) >= 2 and audio_shape[1] is not None:
        sequence = int(audio_shape[1])

    return ModelRestrictions(
        batch=batch,
        sequence=sequence,
        has_sr_input=sr,
        hidden=hidden,
        num_state_inputs=len(state_names),
        prob_rank3=hidden == 64 and not sr,  # v3-style export
    )


class OnnxExecRunner:
    """MinibatchRunner-compatible driver over the numpy graph executor.

    Exposes the same surface the CLI uses: `.module.SAMPLE_RATE`,
    `.chunk_samples` (clamped against the graph's declared restriction),
    and `process_window(window) -> probs`.
    """

    class _Module:
        SAMPLE_RATE = 16000

    def __init__(
        self,
        path,
        *,
        chunk_samples: int = 1536,
        sample_rate: int = 16000,
    ):
        self.path = path
        self.executor = OnnxExecutor.from_path(path)
        self.restrictions = introspect(self.executor.graph)
        r = self.restrictions
        self.sample_rate = sample_rate
        self.module = self._Module()
        self.module.SAMPLE_RATE = sample_rate
        # v5-style models carry raw-audio context between chunks
        self.is_v5 = r.hidden == 128
        context = (64 if sample_rate == 16000 else 32) if self.is_v5 else 0
        if r.sequence > 0:
            # a graph's declared input length INCLUDES the v5 context
            # prefix (the reference feeds 512+64=576 per chunk,
            # vadc.c:117-140, onnx_helpers.c:158-160) — the fresh samples
            # consumed per chunk are the declared length minus the carried
            # context, or _run_chunk would overfeed the declared shape and
            # advance at the wrong cadence
            self.chunk_samples = r.sequence - context
            if self.chunk_samples <= 0:
                from vadc_tpu_torch.export.onnx_exec import OnnxExecError

                raise OnnxExecError(
                    f"declared sequence {r.sequence} is not longer than "
                    f"the v5 context prefix ({context})"
                )
        else:
            # dynamic graph: apply the introspected family's chunk contract
            # (v5 fixed 512/256, v3/v4 multiples of 256 in [512, 1536] —
            # vadc.h:85-94), not the caller's raw wish
            from vadc_tpu_torch.models.weights import clamp_sequence_count

            if self.is_v5:
                family = "v5" if sample_rate == 16000 else "v5_8k"
            else:
                family = "v3" if sample_rate == 16000 else "v4_8k"
            self.chunk_samples = clamp_sequence_count(family, chunk_samples)
        self.context_samples = context
        layers = 1 if self.is_v5 else 2
        self._h = np.zeros((layers, 1, r.hidden), np.float32)
        self._c = np.zeros((layers, 1, r.hidden), np.float32)
        self._context = np.zeros((1, self.context_samples), np.float32)

    def _run_chunk(self, chunk: np.ndarray) -> float:
        """One [seq]-sample chunk through the graph; state threads."""
        from vadc_tpu_torch.export.onnx_exec import run_silero_onnx

        if self.is_v5:
            audio = np.concatenate([self._context[0], chunk])[None]
            self._context = chunk[None, -self.context_samples :]
        else:
            audio = chunk[None]
        out, self._h, self._c = run_silero_onnx(
            self.path,
            audio,
            state=(self._h, self._c),
            sample_rate=self.sample_rate if self.restrictions.has_sr_input else None,
            executor=self.executor,
        )
        # Branch on the ACTUAL output rank, exactly like the reference
        # (onnx_helpers.c:277-312): rank 3 => v3-style [B,2,1], prob at
        # index 1 (vadc.c:704-713); anything else => prob at index 0.
        # restrictions.prob_rank3 is the static prediction; a re-exported
        # graph whose output shape deviates must not crash mid-stream.
        if out.ndim == 3:
            return float(out[0, 1, 0])
        return float(np.ravel(out)[0])

    def process_window(self, window: np.ndarray) -> np.ndarray:
        window = np.asarray(window, np.float32)
        n = len(window) // self.chunk_samples
        probs = np.empty(n, np.float32)
        for i in range(n):
            probs[i] = self._run_chunk(
                window[i * self.chunk_samples : (i + 1) * self.chunk_samples]
            )
        return probs
