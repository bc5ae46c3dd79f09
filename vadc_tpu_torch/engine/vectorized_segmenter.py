"""Vectorized hysteresis FSM: segment many streams on the device.

Counterpart of vadc_tpu/engine/vectorized_segmenter.py. Same transition
semantics as the host Segmenter (and the reference's feed_probability,
vadc.c:165-221), as torch ops on int32/bool state tensors of [B]:
`torch.where` replaces the branches, so the whole batch advances in a
handful of elementwise ops per chunk, with no host synchronisation inside a
slab.

Used by the offline corpus path (cli/batch.py): probabilities [B, T] in,
per-chunk "segment closed here" events out; pad/merge and emission stay on
the host (they touch only the few closed segments, not every chunk).
"""

from __future__ import annotations

from collections import deque
from typing import NamedTuple

import numpy as np
import torch

from vadc_tpu_torch import native
from vadc_tpu_torch.cli.segmenter import SegmenterConfig
from vadc_tpu_torch.runtime import resolve_device

BACKENDS = ("auto", "native", "device")


class FsmState(NamedTuple):
    triggered: torch.Tensor  # bool [B]
    speech_start: torch.Tensor  # int32 [B]
    temp_end: torch.Tensor  # int32 [B]
    chunk_index: int  # the next chunk's global index, the same for every stream


def init_fsm_state(n_streams: int, device="cpu") -> FsmState:
    return FsmState(
        triggered=torch.zeros(n_streams, dtype=torch.bool, device=device),
        speech_start=torch.zeros(n_streams, dtype=torch.int32, device=device),
        temp_end=torch.zeros(n_streams, dtype=torch.int32, device=device),
        chunk_index=0,
    )


def fsm_step(
    state: FsmState,
    prob: torch.Tensor,
    *,
    threshold: float,
    neg_threshold: float,
    min_silence_chunks: int,
    min_speech_chunks: int,
    active: torch.Tensor | None = None,
) -> tuple[FsmState, tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
    """Advance every stream's FSM one chunk.

    prob: float32 [B]. active (optional bool [B]): streams marked False keep
    their state untouched and emit nothing — zero-padded grid chunks must be
    invisible to the FSM (a pad chunk advancing it can close a segment the
    scalar segmenter, fed only the real prefix, would EOF-snap instead).
    Returns (new state, (closed [B] bool, seg_start [B], seg_end [B])).
    """
    idx = state.chunk_index
    above = prob >= threshold
    below_neg = prob < neg_threshold
    zero = torch.zeros_like(state.temp_end)

    # prob >= threshold cancels a tentative end
    temp_end = torch.where(above, zero, state.temp_end)

    # not triggered and above -> trigger
    newly_triggered = ~state.triggered & above
    speech_start = torch.where(newly_triggered, idx, state.speech_start)
    triggered = state.triggered | newly_triggered

    # triggered and below neg_threshold -> tentative end, maybe close
    tentative = state.triggered & below_neg
    temp_end = torch.where(tentative & (temp_end == 0), idx, temp_end)
    closing = tentative & (idx - temp_end >= min_silence_chunks)
    long_enough = temp_end - speech_start >= min_speech_chunks
    closed = closing & long_enough
    seg_start = speech_start
    seg_end = temp_end

    # reset on close (valid or discarded)
    triggered = triggered & ~closing
    speech_start = torch.where(closing, zero, speech_start)
    temp_end = torch.where(closing, zero, temp_end)

    if active is not None:
        triggered = torch.where(active, triggered, state.triggered)
        speech_start = torch.where(active, speech_start, state.speech_start)
        temp_end = torch.where(active, temp_end, state.temp_end)
        closed = closed & active

    return (
        FsmState(triggered, speech_start, temp_end, idx + 1),
        (closed, seg_start, seg_end),
    )


def segment_batch(
    probs: torch.Tensor,
    *,
    threshold: float,
    neg_threshold: float,
    min_silence_chunks: int,
    min_speech_chunks: int,
    state: FsmState | None = None,
    valid_chunks: torch.Tensor | None = None,
) -> tuple[FsmState, tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
    """Run the FSM over probs [B, T], on the device the probabilities lie on.

    valid_chunks (optional int [B], on that device): each stream's real
    chunk count in a zero-padded grid — chunks at global index >= valid are
    masked out of the FSM (state freezes at the stream's true EOF, exactly
    what BatchSegmenter.finish's EOF snap needs).
    Returns (final state, (closed [T, B], seg_start [T, B], seg_end [T, B])).
    """
    if state is None:
        state = init_fsm_state(probs.shape[0], probs.device)
    closed, starts, ends = [], [], []
    for t in range(probs.shape[1]):
        state, (c, s, e) = fsm_step(
            state,
            probs[:, t],
            threshold=threshold,
            neg_threshold=neg_threshold,
            min_silence_chunks=min_silence_chunks,
            min_speech_chunks=min_speech_chunks,
            active=None if valid_chunks is None else state.chunk_index < valid_chunks,
        )
        closed.append(c)
        starts.append(s)
        ends.append(e)
    return state, (torch.stack(closed), torch.stack(starts), torch.stack(ends))


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
    FSM runs on `device` as torch ops (backend "device": only the sparse
    events come to the host) or in the native C++ kernel on the host
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
        probs = torch.as_tensor(probs, dtype=torch.float32).to(self.device)
        if self._native is not None:
            # defer only the device->host probability pull; the C++ FSM
            # must still see slabs in order, so draining is FIFO
            self._pending.append((*_to_host(probs), self._fed_chunks))
        else:
            cfg = self.config
            self.state, (closed, seg_start, seg_end) = segment_batch(
                probs,
                threshold=cfg.threshold,
                neg_threshold=cfg.neg_threshold,
                min_silence_chunks=cfg.min_silence_chunks,
                min_speech_chunks=cfg.min_speech_chunks,
                state=self.state,
                valid_chunks=self._valid_dev,
            )
            # one [3, T, B] int32 tensor: one copy to the host, no sync yet
            events = torch.stack([closed.to(torch.int32), seg_start, seg_end])
            self._pending.append(_to_host(events))
        self._fed_chunks += probs.shape[1]
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
