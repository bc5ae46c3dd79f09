"""Vectorized hysteresis FSM: segment many streams on the device.

Counterpart of vadc_tpu/engine/vectorized_segmenter.py. The FSM itself
lives in kernels/fsm.py: `fsm_step` and `segment_batch`, torch ops on [B]
state tensors, are its plain version, which the CPU runs; on a card
`fsm_scan` advances every stream over a whole slab in one kernel launch
(the same transitions, events and state, bit for bit). Their names are
imported here, where the engine's callers find them.

Used by the offline corpus path (cli/batch.py): probabilities [B, T] in,
per-chunk "segment closed here" events out; pad/merge and emission stay on
the host (they touch only the few closed segments, not every chunk).
`BatchSegmenter.feed` and `.finish` are the spans `segmenter.feed` and
`segmenter.finish` (tracing.zone); the counter `segmenter.columns` counts
the chunk columns fed, each one FSM step over every stream.
"""

from __future__ import annotations

from collections import deque

import numpy as np
import torch

from vadc_tpu_torch import tracing
from vadc_tpu_torch.cli.segmenter import SegmenterConfig
# fsm_step and segment_batch too: the engine's callers find the FSM here
from vadc_tpu_torch.kernels.fsm import (
    FsmState, fsm_scan, fsm_step, init_fsm_state, segment_batch,
)
from vadc_tpu_torch.runtime import resolve_device

#: slabs whose events' readback `feed` defers: it enqueues the FSM and an
#: asynchronous copy into pinned memory, and reads slab k's events while
#: slab k + 2 is computing
PENDING_SLABS = 2


def _to_host(t: torch.Tensor) -> tuple[torch.Tensor, torch.cuda.Event | None]:
    """Start the copy of a tensor to the host. A CUDA tensor goes into pinned
    memory with a non-blocking copy and a CUDA event recorded behind it, so
    the reader waits on that event and not on the whole device; a CPU tensor
    is returned as it is."""
    if not t.is_cuda:
        return t, None
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    done = torch.cuda.Event()
    done.record(torch.cuda.current_stream(t.device))
    return host, done


class BatchSegmenter:
    """Incremental multi-stream segmentation over probability slabs.

    Feed probabilities in [B, T_slab] slabs (any slab sizes). The per-chunk
    FSM runs on `device` (`fsm_scan`: one kernel launch a slab on a card,
    `segment_batch`'s torch ops on the CPU); only the sparse events come to
    the host. `finish` applies the EOF snap for still-open segments and the
    pad/merge pass. Semantics match the scalar CLI Segmenter."""

    def __init__(self, config: SegmenterConfig, n_streams: int, *, device, valid_chunks=None):
        self.config = config
        self.n_streams = n_streams
        self.device = resolve_device(device)
        # per-stream real chunk counts for zero-padded grids: chunks at
        # grid index >= valid are masked OUT of the FSM (state freezes at
        # each stream's true EOF). Without this a pad chunk can confirm a
        # tentative close that the scalar segmenter — fed only the real
        # prefix — would instead resolve with the reference's EOF snap.
        self._valid = None if valid_chunks is None else np.asarray(valid_chunks, np.int64)
        self._valid_dev = (
            None if self._valid is None
            else torch.as_tensor(self._valid, dtype=torch.int32, device=self.device)
        )
        self._state = init_fsm_state(n_streams, self.device)
        self._raw: list[list[tuple[int, int]]] = [[] for _ in range(n_streams)]
        self._pending: deque = deque()

    def feed(self, probs) -> None:
        """probs [B, T]: a tensor on the segmenter's device, or array-like."""
        with tracing.zone("segmenter.feed"):
            probs = torch.as_tensor(probs, dtype=torch.float32).to(self.device)
            cfg = self.config
            # one [3, T, B] int32 tensor of events: one copy to the host,
            # no sync yet
            self._state, events = fsm_scan(
                probs,
                self._state,
                threshold=cfg.threshold,
                neg_threshold=cfg.neg_threshold,
                min_silence_chunks=cfg.min_silence_chunks,
                min_speech_chunks=cfg.min_speech_chunks,
                valid_chunks=self._valid_dev,
            )
            self._pending.append(_to_host(events))
            tracing.count("segmenter.columns", probs.shape[1])
            self._drain(keep=PENDING_SLABS)

    def _drain(self, keep: int = 0) -> None:
        """Read the deferred slabs' events, oldest first, until `keep` remain."""
        while len(self._pending) > keep:
            host, done = self._pending.popleft()
            if done is not None:
                done.synchronize()  # the sync point: this slab's copy, not the device
            closed, seg_start, seg_end = host.numpy()  # each [T, B]
            for t, i in zip(*np.nonzero(closed)):
                self._raw[i].append((int(seg_start[t, i]), int(seg_end[t, i])))

    def state_dict(self) -> dict:
        """Complete resumable state: the FSM fields ([B] tensors on the
        segmenter's device), the global index of the next chunk and the
        closed segments awaiting pad/merge. Slabs whose readback `feed`
        still defers are read first, so their events are in it."""
        self._drain()
        return {
            "triggered": self._state.triggered,
            "speech_start": self._state.speech_start,
            "temp_end": self._state.temp_end,
            "chunk_index": self._state.chunk_index,
            "raw_segments": [list(r) for r in self._raw],
        }

    def load_state_dict(self, d: dict) -> None:
        """Replace the whole state with a `state_dict`'s (tensors or arrays
        on any device; the FSM fields go to the segmenter's device). Events
        of slabs fed before and not yet read are dropped with the rest."""
        def field(name, dtype):
            return torch.as_tensor(d[name]).to(device=self.device, dtype=dtype)

        self._state = FsmState(
            triggered=field("triggered", torch.bool),
            speech_start=field("speech_start", torch.int32),
            temp_end=field("temp_end", torch.int32),
            chunk_index=int(d["chunk_index"]),
        )
        self._raw = [list(r) for r in d["raw_segments"]]
        self._pending.clear()

    def finish(self, valid_chunks=None) -> list[list[tuple[float, float]]]:
        """valid_chunks: per-stream real chunk counts (for zero-padded batch
        grids); segments are clamped to each stream's real extent and the
        reference's EOF snap applies at it (vadc.c:1005-1027)."""
        with tracing.zone("segmenter.finish"):
            self._drain()
            cfg = self.config
            triggered = self._state.triggered.cpu().numpy()
            open_start = self._state.speech_start.cpu().numpy()
            if valid_chunks is None:
                valid_chunks = (
                    self._valid if self._valid is not None
                    else [self._state.chunk_index] * self.n_streams
                )
            elif self._valid is not None:
                mismatched = [
                    (i, int(v), int(w))
                    for i, (v, w) in enumerate(zip(valid_chunks, self._valid))
                    if int(v) != int(w)
                ]
                if mismatched:
                    raise ValueError(
                        "finish(valid_chunks=...) disagrees with the "
                        f"constructor's valid_chunks at streams {mismatched[:4]}"
                    )
            out: list[list[tuple[float, float]]] = []
            spc = cfg.seconds_per_chunk
            pad = cfg.speech_pad_s
            for i in range(self.n_streams):
                valid = int(valid_chunks[i])
                last_chunk = valid - 1
                # with constructor valid_chunks the FSM never saw pad chunks,
                # so raw events already lie within real data; the filter/clamp
                # stays as a guard for callers that pad without masking
                raw = [(s, min(e, last_chunk)) for s, e in self._raw[i] if s < valid]
                if triggered[i] and int(open_start[i]) < valid:
                    if last_chunk - int(open_start[i]) > cfg.min_speech_chunks:
                        raw.append((int(open_start[i]), last_chunk))
                merged: list[tuple[float, float]] = []
                for start_c, end_c in raw:
                    start_s = max(start_c * spc - pad, 0.0)
                    end_s = end_c * spc + pad
                    if merged and merged[-1][1] >= start_s:
                        merged[-1] = (merged[-1][0], end_s)
                    else:
                        merged.append((start_s, end_s))
                out.append(merged)
            return out


def collect_segments(
    probs, config: SegmenterConfig, *, device
) -> list[list[tuple[float, float]]]:
    """One-shot offline segmentation: probabilities [B, T] -> padded and
    merged (start_s, end_s) segments per stream."""
    probs = torch.as_tensor(probs, dtype=torch.float32)
    seg = BatchSegmenter(config, probs.shape[0], device=device)
    seg.feed(probs)
    return seg.finish()
