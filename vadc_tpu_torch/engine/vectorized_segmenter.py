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
the chunk columns fed, each one FSM step over every stream, and
`segmenter.kernel_columns` (counted by fsm_scan) those the kernel stepped.
"""

from __future__ import annotations

from collections import deque

import numpy as np
import torch

from vadc_tpu_torch import native, tracing
from vadc_tpu_torch.cli.segmenter import SegmenterConfig
# fsm_step and segment_batch too: the engine's callers find the FSM here
from vadc_tpu_torch.kernels.fsm import (
    FsmState, fsm_scan, fsm_step, init_fsm_state, segment_batch,
)
from vadc_tpu_torch.runtime import resolve_device

BACKENDS = ("auto", "native", "device")


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
    FSM runs on `device` (backend "device": one `fsm_scan` kernel a slab on
    a card, `segment_batch`'s torch ops on the CPU; only the sparse events
    come to the host) or in the native C++ kernel on the host
    (backend "native": the probabilities come to the host in one transfer;
    "auto" takes it when the native library is available); `finish` applies
    the EOF snap for still-open segments and the pad/merge pass. Semantics
    match the scalar CLI Segmenter."""

    def __init__(
        self,
        config: SegmenterConfig,
        n_streams: int,
        *,
        device,
        backend: str = "auto",
        pending_depth: int = 0,
        valid_chunks=None,
    ):
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend {backend!r}")
        self.config = config
        self.n_streams = n_streams
        self.device = resolve_device(device)
        # per-stream real chunk counts for zero-padded grids: chunks at
        # grid index >= valid are masked OUT of the FSM (state freezes at
        # each stream's true EOF). Without this a pad chunk can confirm a
        # tentative close that the scalar segmenter — fed only the real
        # prefix — would instead resolve with the reference's EOF snap.
        self._valid = None if valid_chunks is None else np.asarray(valid_chunks, np.int64)
        self._fed_chunks = 0  # global grid offset of the next slab
        self._raw: list[list[tuple[int, int]]] = [[] for _ in range(n_streams)]
        # pending_depth > 0 defers the device->host readback by that many
        # feed() calls: feed only enqueues the FSM and an asynchronous copy
        # into pinned memory, and slab k's results are read while slab
        # k+depth is already computing.
        self.pending_depth = pending_depth
        self._pending: deque = deque()
        if backend == "native" or (backend == "auto" and native.available()):
            self._native = native.NativeFsm(
                n_streams,
                threshold=config.threshold,
                neg_threshold=config.neg_threshold,
                min_silence_chunks=config.min_silence_chunks,
                min_speech_chunks=config.min_speech_chunks,
            )
            self.state = None
        else:
            self._native = None
            self.state = init_fsm_state(n_streams, self.device)
            self._valid_dev = (
                None if self._valid is None
                else torch.as_tensor(self._valid, dtype=torch.int32, device=self.device)
            )

    def feed(self, probs) -> None:
        """probs [B, T]: a tensor on the segmenter's device, or array-like."""
        with tracing.zone("segmenter.feed"):
            probs = torch.as_tensor(probs, dtype=torch.float32).to(self.device)
            if self._native is not None:
                # defer only the device->host probability pull; the C++ FSM
                # must still see slabs in order, so draining is FIFO
                self._pending.append((*_to_host(probs), self._fed_chunks))
            else:
                cfg = self.config
                # on a card one kernel launch for the whole slab, on the CPU
                # segment_batch; one [3, T, B] int32 tensor of events either
                # way: one copy to the host, no sync yet
                self.state, events = fsm_scan(
                    probs,
                    self.state,
                    threshold=cfg.threshold,
                    neg_threshold=cfg.neg_threshold,
                    min_silence_chunks=cfg.min_silence_chunks,
                    min_speech_chunks=cfg.min_speech_chunks,
                    valid_chunks=self._valid_dev,
                )
                self._pending.append(_to_host(events))
            self._fed_chunks += probs.shape[1]
            tracing.count("segmenter.columns", probs.shape[1])
            while len(self._pending) > self.pending_depth:
                self._drain_one()

    def _drain_one(self) -> None:
        host, done, *rest = self._pending.popleft()
        if done is not None:
            done.synchronize()  # the sync point: this slab's copy, not the device
        if self._native is not None:
            (offset,) = rest
            probs = np.ascontiguousarray(host.numpy(), np.float32)
            t = probs.shape[1]
            if self._valid is None:
                subslabs = [(0, t, None)]
            else:
                # the native active mask is per-stream per-FEED: split the
                # slab at every stream EOF it contains, so within each
                # sub-slab every stream is uniformly active or frozen.
                # Total extra feeds across a whole run are bounded by the
                # number of distinct stream lengths.
                cuts = np.unique(np.clip(self._valid - offset, 0, t))
                cuts = [int(c) for c in cuts if 0 < c < t]
                bounds = [0, *cuts, t]
                subslabs = [
                    (a, b, (self._valid > offset + a).astype(np.uint8))
                    for a, b in zip(bounds[:-1], bounds[1:])
                ]
            for a, b, active in subslabs:
                for i, start, end in self._native.feed(probs[:, a:b], active=active):
                    self._raw[i].append((start, end))
            return
        closed, seg_start, seg_end = host.numpy()  # each [T, B]
        if not closed.any():
            return
        times, streams = np.nonzero(closed)
        for t, i in zip(times, streams):
            self._raw[i].append((int(seg_start[t, i]), int(seg_end[t, i])))

    def finish(self, valid_chunks=None) -> list[list[tuple[float, float]]]:
        """valid_chunks: per-stream real chunk counts (for zero-padded batch
        grids); segments are clamped to each stream's real extent and the
        reference's EOF snap applies at it (vadc.c:1005-1027)."""
        with tracing.zone("segmenter.finish"):
            while self._pending:
                self._drain_one()
            cfg = self.config
            if self._native is not None:
                triggered = self._native.triggered.astype(bool)
                open_start = self._native.speech_start
                total_chunks = int(self._native.chunk_index.max()) if self.n_streams else 0
            else:
                triggered = self.state.triggered.cpu().numpy()
                open_start = self.state.speech_start.cpu().numpy()
                total_chunks = self.state.chunk_index
            if valid_chunks is None:
                valid_chunks = (
                    self._valid if self._valid is not None else [total_chunks] * self.n_streams
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
