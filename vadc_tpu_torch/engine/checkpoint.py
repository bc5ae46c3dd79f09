"""Checkpoint / resume of streaming inference state.

Counterpart of vadc_tpu/engine/checkpoint.py, with the same bytes: for the
same state `EngineCheckpoint.to_bytes` writes the tensors the JAX package
writes, under the same names and in the same order, so a checkpoint of
either package loads in the other.

The resumable state of a batch of streams (SURVEY §5.4): LSTM h/c, the v5
audio context, the segmentation FSM fields {triggered, speech_start,
temp_end} (vadc.h:110-115), the buffered pending segment (vadc.c:831) and
the chunk index (vadc.c:829); for the serving daemon also each slot's
rendered but unsent output bytes. A stop BETWEEN a segment close and its
pad/merge neither drops nor double-emits the held segment.

Serialization is the .testtensor container (io/testtensor.py), with
integer state stored as float32 (small counters and flags, exactly
representable below 2^24; to_bytes refuses a value past that).

A state sharded over devices (engine/shard.py) is saved whole, gathered.
A state sharded over processes (engine/distributed.py) is not: each
process saves its own slice to its own file (`save_sharded`, `load_sharded`,
the JAX package's file names and bytes), and EngineCheckpoint refuses such a
state whole.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from vadc_tpu_torch.engine.runner import StreamState
from vadc_tpu_torch.engine.vectorized_segmenter import BatchSegmenter, FsmState
from vadc_tpu_torch.io.testtensor import load_testtensor_bytes, save_testtensor_bytes


def _host(x) -> np.ndarray:
    """A tensor on any device (or an array) as a host numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _addressable(state) -> None:
    """Refuse one process's slice of a state sharded over processes, with
    the pointed diagnosis of the JAX package's `_host`: written whole it
    would look like a checkpoint of every stream."""
    if getattr(state, "n_processes", 1) > 1:
        raise ValueError(
            "model state is sharded across processes; checkpoint each "
            "process's own slice: engine.local_state(state) -> "
            "EngineCheckpoint, or use checkpoint.save_sharded/load_sharded"
        )


def _tensor(arr: np.ndarray, dtype: torch.dtype, device) -> torch.Tensor:
    return torch.from_numpy(np.array(arr, copy=True)).to(device=device, dtype=dtype)


@dataclass
class EngineCheckpoint:
    """Complete resumable state of a batch of streams.

    raw_segments: per-stream closed segments awaiting pad/merge at finish
    (BatchSegmenter accumulation, the batched analogue of the reference's
    buffered segment). pending: per-stream held merge candidate (the host
    Segmenter / server slot `pending`, vadc.c:831). chunk_indices: per-stream
    chunk counters when streams advance independently (the server's
    per-slot native FSM, the JAX package's native BatchSegmenter).
    sendbuf: per-stream rendered but unsent output bytes (the serving
    daemon's outbox under client backpressure), re-delivered to the
    reconnecting client after a restore."""

    family: str
    model_state: StreamState
    fsm_state: FsmState | None = None
    chunk_index: int = 0
    raw_segments: list[list[tuple[int, int]]] | None = None
    pending: list[tuple[int, int] | None] | None = None
    chunk_indices: np.ndarray | None = None
    sendbuf: list[bytes] | None = None

    def to_bytes(self) -> bytes:
        _addressable(self.model_state)
        tensors: dict[str, np.ndarray] = {
            # header carries family id (ascii codes) and chunk index
            "meta.family": np.frombuffer(self.family.encode("ascii"), dtype=np.uint8).astype(
                np.float32
            ),
            "meta.chunk_index": np.asarray([self.chunk_index], np.float32),
            "model.h": _host(self.model_state.h),
            "model.c": _host(self.model_state.c),
        }
        if self.model_state.context is not None:
            tensors["model.context"] = _host(self.model_state.context)
        if self.fsm_state is not None:
            tensors["fsm.triggered"] = _host(self.fsm_state.triggered).astype(np.float32)
            tensors["fsm.speech_start"] = _host(self.fsm_state.speech_start).astype(np.float32)
            tensors["fsm.temp_end"] = _host(self.fsm_state.temp_end).astype(np.float32)
        if self.chunk_indices is not None:
            tensors["fsm.chunk_indices"] = np.asarray(self.chunk_indices, np.float32)
        if self.raw_segments is not None:
            rows = [(i, s, e) for i, segs in enumerate(self.raw_segments) for (s, e) in segs]
            tensors["seg.raw"] = np.asarray(rows, np.float32).reshape(-1, 3)
            tensors["seg.n_streams"] = np.asarray([len(self.raw_segments)], np.float32)
        if self.pending is not None:
            rows = [(0.0, 0.0, 0.0) if p is None else (1.0, p[0], p[1]) for p in self.pending]
            tensors["seg.pending"] = np.asarray(rows, np.float32).reshape(-1, 3)
        if self.sendbuf is not None:
            tensors["seg.sendbuf_lens"] = np.asarray([len(b) for b in self.sendbuf], np.float32)
            tensors["seg.sendbuf_data"] = np.frombuffer(b"".join(self.sendbuf), np.uint8).astype(
                np.float32
            )
        # The container stores integer state as float32, exact only below
        # 2^24. A stream that has run ~18.6 days of 96 ms chunks crosses
        # that on its chunk counter: fail LOUDLY here rather than silently
        # rounding a counter and corrupting the resumed stream's timeline.
        for k, arr in tensors.items():
            if k == "model.h" or k == "model.c" or k == "model.context":
                continue  # genuine float payloads
            if arr.size and float(np.abs(arr).max()) >= 2**24:
                raise ValueError(
                    f"checkpoint field {k!r} holds a value >= 2^24, beyond "
                    "float32's exact-integer range — the stream has outrun "
                    "the serializable counter bound; restart its timeline "
                    "before checkpointing"
                )
        return save_testtensor_bytes(tensors)

    @classmethod
    def from_bytes(cls, data: bytes, device="cpu") -> "EngineCheckpoint":
        """The checkpoint with its model state (and FSM fields) as tensors
        on `device`."""
        t = load_testtensor_bytes(data)
        family = bytes(t["meta.family"].astype(np.uint8)).decode("ascii")
        context = (
            _tensor(t["model.context"], torch.float32, device) if "model.context" in t else None
        )
        model_state = StreamState(
            _tensor(t["model.h"], torch.float32, device),
            _tensor(t["model.c"], torch.float32, device),
            context,
        )
        chunk_index = int(t["meta.chunk_index"][0])
        fsm = None
        if "fsm.triggered" in t:
            fsm = FsmState(
                triggered=_tensor(t["fsm.triggered"], torch.bool, device),
                speech_start=_tensor(t["fsm.speech_start"], torch.int32, device),
                temp_end=_tensor(t["fsm.temp_end"], torch.int32, device),
                chunk_index=chunk_index,
            )
        chunk_indices = (
            t["fsm.chunk_indices"].astype(np.int32) if "fsm.chunk_indices" in t else None
        )
        raw_segments = None
        if "seg.raw" in t:
            n = int(t["seg.n_streams"][0])
            raw_segments = [[] for _ in range(n)]
            for i, s, e in t["seg.raw"].reshape(-1, 3):
                raw_segments[int(i)].append((int(s), int(e)))
        pending = None
        if "seg.pending" in t:
            pending = [
                (int(s), int(e)) if has else None for has, s, e in t["seg.pending"].reshape(-1, 3)
            ]
        sendbuf = None
        if "seg.sendbuf_lens" in t:
            blob = bytes(t["seg.sendbuf_data"].astype(np.uint8))
            sendbuf, off = [], 0
            for ln in t["seg.sendbuf_lens"].astype(np.int64):
                sendbuf.append(blob[off : off + ln])
                off += ln
        return cls(
            family=family,
            model_state=model_state,
            fsm_state=fsm,
            chunk_index=chunk_index,
            raw_segments=raw_segments,
            pending=pending,
            chunk_indices=chunk_indices,
            sendbuf=sendbuf,
        )

    # -- BatchSegmenter capture/restore ----------------------------------

    @classmethod
    def capture(
        cls,
        family: str,
        model_state: StreamState,
        segmenter: BatchSegmenter,
        *,
        pending: list[tuple[int, int] | None] | None = None,
    ) -> "EngineCheckpoint":
        """Snapshot engine + segmentation state, INCLUDING the accumulated
        raw segments awaiting pad/merge (and per-slot pending segments when
        the caller holds them, e.g. the serving daemon): the segmenter's
        `state_dict`."""
        d = segmenter.state_dict()
        fsm = FsmState(d["triggered"], d["speech_start"], d["temp_end"], d["chunk_index"])
        return cls(
            family=family,
            model_state=model_state,
            fsm_state=fsm,
            chunk_index=fsm.chunk_index,
            raw_segments=d["raw_segments"],
            pending=pending,
        )

    def restore_segmenter(self, segmenter: BatchSegmenter) -> None:
        """Load the FSM fields and the accumulated raw segments into a fresh
        BatchSegmenter (its `load_state_dict`). A capture of per-stream
        chunk counters (the JAX package's native FSM) resumes at the
        largest, `chunk_index`."""
        if self.fsm_state is None:
            raise ValueError("checkpoint has no segmentation state")
        fsm = self.fsm_state
        raw = self.raw_segments if self.raw_segments is not None else [[]] * len(fsm.triggered)
        segmenter.load_state_dict({
            "triggered": fsm.triggered,
            "speech_start": fsm.speech_start,
            "temp_end": fsm.temp_end,
            "chunk_index": self.chunk_index,
            "raw_segments": raw,
        })

    def save(self, path: str | Path) -> None:
        Path(path).write_bytes(self.to_bytes())

    @classmethod
    def load(cls, path: str | Path, device="cpu") -> "EngineCheckpoint":
        return cls.from_bytes(Path(path).read_bytes(), device)


# -- multi-process sharded checkpointing ---------------------------------
#
# A MultiHostStreamEngine's state is one slice per process: each process
# saves ITS OWN stream slice, no cross-process traffic, to
# `<prefix>.proc<i>of<n>.testtensor`, and restores it symmetrically. The
# host-side segmentation state (BatchSegmenter raw segments, pending merges)
# is per process by construction, since each process segments only the
# streams it feeds, so it rides in the same file.


def shard_path(prefix: str | Path, process_id: int, n_processes: int) -> Path:
    """The file of one process's slice of a checkpoint sharded over
    processes (the JAX package's name, `<prefix>.proc<i>of<n>.testtensor`)."""
    return Path(f"{prefix}.proc{process_id}of{n_processes}.testtensor")


def save_sharded(
    engine,
    state,
    prefix: str | Path,
    *,
    segmenter: BatchSegmenter | None = None,
    pending: list[tuple[int, int] | None] | None = None,
) -> Path:
    """Checkpoint this process's slice of a MultiHostStreamEngine.

    Every process must call this (with its own engine and segmenter): the
    processes meet at a barrier before and after, so every file under the
    shared `prefix` is of one step and all are written when any call
    returns."""
    engine.barrier()
    local = engine.local_state(state)
    family = engine.runner.family
    if segmenter is not None:
        ckpt = EngineCheckpoint.capture(family, local, segmenter, pending=pending)
    else:
        ckpt = EngineCheckpoint(family, local, pending=pending)
    path = shard_path(prefix, engine.process_id, engine.n_processes)
    ckpt.save(path)
    engine.barrier()
    return path


def load_sharded(engine, prefix: str | Path):
    """Load this process's slice and rebuild the engine's state from it.

    Returns (state, checkpoint); the checkpoint carries the segmentation
    fields for `restore_segmenter` on this process's BatchSegmenter. The
    saved process count must match the running cluster (a resharding
    restore would silently misassign streams to processes)."""
    path = shard_path(prefix, engine.process_id, engine.n_processes)
    if not path.exists():
        existing = sorted(Path(path).parent.glob(f"{Path(prefix).name}.proc*"))
        raise FileNotFoundError(
            f"{path} not found — saved layout differs from the running "
            f"cluster ({engine.n_processes} processes); on disk: "
            f"{[p.name for p in existing] or 'nothing'}"
        )
    ckpt = EngineCheckpoint.load(path)
    return engine.state_from_local(ckpt.model_state), ckpt
