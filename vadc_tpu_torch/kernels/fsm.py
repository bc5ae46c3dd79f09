"""The batch segmenter's hysteresis FSM over a whole slab: its plain version
and one CUDA kernel.

Counterpart of the FSM of vadc_tpu/engine/vectorized_segmenter.py. Same
transition semantics as the host Segmenter (and the reference's
feed_probability, vadc.c:165-221), as torch ops on int32/bool state tensors
of [B]: `torch.where` replaces the branches, so the whole batch advances in
a handful of elementwise ops per chunk (`fsm_step`), with no host
synchronisation inside a slab (`segment_batch`). That is the plain version,
which the CPU runs: about 30 launches from the host a chunk column on a
card.

No kernel of the JAX package is its counterpart: there the FSM is a
`lax.scan`, which XLA runs as one loop on the device. On a card `fsm_scan`
launches `csrc/fsm_scan.cu` once a slab instead, whose header says what
bounds it: one thread a stream walks the slab's columns with the FSM's
state in registers, the transitions `fsm_step`'s in its order, and writes
the events engine/vectorized_segmenter.py's `BatchSegmenter.feed` copies to
the host, in segment_batch's layout and bits. Each launch counts its
columns under the tracing counter `segmenter.kernel_columns`.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from vadc_tpu_torch import tracing
from vadc_tpu_torch.kernels import _build
from vadc_tpu_torch.runtime import on_device


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


def fsm_scan(
    probs: torch.Tensor,
    state: FsmState,
    *,
    threshold: float,
    neg_threshold: float,
    min_silence_chunks: int,
    min_speech_chunks: int,
    valid_chunks: torch.Tensor | None = None,
):
    """probs [B, T] fp32 and the FsmState before them -> (the FsmState after
    them, events [3, T, B] int32: closed, seg_start and seg_end, each [T, B]
    as `segment_batch` returns them). valid_chunks (optional int32 [B]): a
    stream's chunks at global index >= valid are masked out, as there.

    A CPU tensor takes the plain version, `segment_batch`; a CUDA tensor
    launches the kernel (built at first use) or raises, and counts its
    columns as `segmenter.kernel_columns`. The kernel writes the new state
    into new tensors, as the plain version returns new ones: a state
    captured before the call (engine/checkpoint.py) stays as it was."""
    if probs.device.type == "cpu":
        state, (closed, starts, ends) = segment_batch(
            probs, threshold=threshold, neg_threshold=neg_threshold,
            min_silence_chunks=min_silence_chunks, min_speech_chunks=min_speech_chunks,
            state=state, valid_chunks=valid_chunks,
        )
        return state, torch.stack([closed.to(torch.int32), starts, ends])
    _check(probs, state, valid_chunks)
    batch, n_cols = probs.shape
    device = probs.device
    events = torch.empty(3, n_cols, batch, dtype=torch.int32, device=device)
    triggered = torch.empty_like(state.triggered)
    speech_start = torch.empty_like(state.speech_start)
    temp_end = torch.empty_like(state.temp_end)
    with on_device(device):
        status = _build.library().vadc_fsm_scan(
            probs.data_ptr(), probs.stride(0), probs.stride(1), batch, n_cols,
            threshold, neg_threshold, min_silence_chunks, min_speech_chunks, state.chunk_index,
            None if valid_chunks is None else valid_chunks.data_ptr(),
            state.triggered.data_ptr(), state.speech_start.data_ptr(), state.temp_end.data_ptr(),
            triggered.data_ptr(), speech_start.data_ptr(), temp_end.data_ptr(),
            events.data_ptr(), torch.cuda.current_stream(device).cuda_stream,
        )
    _build.check(status, "fsm_scan")
    fsm_scan.launches += 1
    tracing.count("segmenter.kernel_columns", n_cols)
    new_state = state._replace(triggered=triggered, speech_start=speech_start, temp_end=temp_end,
                               chunk_index=state.chunk_index + n_cols)
    return new_state, events


#: kernel launches since the count was last set to 0
fsm_scan.launches = 0


def _check(probs: torch.Tensor, state: FsmState, valid_chunks) -> None:
    if probs.device.type != "cuda":
        raise ValueError(f"fsm_scan: unsupported device {probs.device}")
    if probs.dtype != torch.float32:
        raise TypeError(f"fsm_scan: probs must be float32, got {probs.dtype}")
    if probs.dim() != 2 or probs.numel() == 0:
        raise ValueError(f"fsm_scan: probs must be a non-empty [B, T], got {tuple(probs.shape)}")
    batch, n_cols = probs.shape
    expected = (("triggered", torch.bool), ("speech_start", torch.int32),
                ("temp_end", torch.int32))
    tensors = [(name, getattr(state, name), dtype) for name, dtype in expected]
    if valid_chunks is not None:
        tensors.append(("valid_chunks", valid_chunks, torch.int32))
    for name, t, dtype in tensors:
        if t.device != probs.device or t.dtype != dtype or t.shape != (batch,) \
                or not t.is_contiguous():
            raise ValueError(
                f"fsm_scan: {name} must be a contiguous {dtype} [{batch}] on {probs.device}, "
                f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    if not 0 <= state.chunk_index <= 2**31 - 1 - n_cols:
        raise ValueError(f"fsm_scan: chunk index {state.chunk_index} + {n_cols} columns "
                         "does not fit in int32")
