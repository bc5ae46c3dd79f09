# Copy of vadc_tpu/native.py (numpy only): the port imports nothing of vadc_tpu
# and keeps its own; tests/test_torch_copies.py holds it to the original.
"""ctypes bindings for the native runtime kernels (native/vadc_native.cpp).

Every entry point has a pure-numpy fallback so the framework works without
the compiled library; the native path removes the Python loop from the
host-side hot paths (PCM conversion, batched segmentation FSM). The library
is auto-built with `make -C native` on first use if a compiler is available.
"""

from __future__ import annotations

import ctypes
import subprocess
from pathlib import Path

import numpy as np

_NATIVE_DIR = Path(__file__).resolve().parent.parent / "native"
_LIB_PATH = _NATIVE_DIR / "libvadc_native.so"

_lib = None
_load_attempted = False


def _try_load() -> ctypes.CDLL | None:
    global _lib, _load_attempted
    if _load_attempted:
        return _lib
    _load_attempted = True
    if not _LIB_PATH.exists() and (_NATIVE_DIR / "Makefile").exists():
        try:
            subprocess.run(
                ["make", "-C", str(_NATIVE_DIR)],
                check=True,
                capture_output=True,
                timeout=120,
            )
        except Exception:
            return None
    if not _LIB_PATH.exists():
        return None
    try:
        lib = ctypes.CDLL(str(_LIB_PATH))
    except OSError:
        return None

    i64, i32, f32 = ctypes.c_int64, ctypes.c_int32, ctypes.c_float
    p_i16 = np.ctypeslib.ndpointer(np.int16, flags="C_CONTIGUOUS")
    p_f32 = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    p_i32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")

    lib.vadc_s16le_to_f32.argtypes = [p_i16, p_f32, i64]
    lib.vadc_f32_to_s16le.argtypes = [p_f32, p_i16, i64]
    lib.vadc_frame_s16le.restype = i64
    lib.vadc_frame_s16le.argtypes = [p_i16, i64, p_f32, i64, i64]
    lib.vadc_fsm_feed.restype = i64
    lib.vadc_fsm_feed.argtypes = [
        p_f32, i64, i64, f32, f32, i32, i32,
        p_i32, p_i32, p_i32, p_i32, ctypes.c_void_p,
        p_i32, p_i32, p_i32, i64,
    ]
    p_u8 = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    c_int = ctypes.c_int
    lib.vadc_pool_create.restype = ctypes.c_void_p
    lib.vadc_pool_create.argtypes = [c_int, c_int, c_int, c_int]
    lib.vadc_pool_add_fd.restype = c_int
    lib.vadc_pool_add_fd.argtypes = [ctypes.c_void_p, c_int, c_int]
    lib.vadc_pool_start.restype = c_int
    lib.vadc_pool_start.argtypes = [ctypes.c_void_p]
    lib.vadc_pool_gather.restype = i64
    lib.vadc_pool_gather.argtypes = [
        ctypes.c_void_p, p_i16, p_u8, ctypes.POINTER(ctypes.c_int64),
    ]
    lib.vadc_pool_stream_done.restype = c_int
    lib.vadc_pool_stream_done.argtypes = [ctypes.c_void_p, c_int]
    lib.vadc_pool_destroy.argtypes = [ctypes.c_void_p]
    _lib = lib
    return _lib


def available() -> bool:
    return _try_load() is not None


def s16le_to_f32(samples: np.ndarray) -> np.ndarray:
    samples = np.ascontiguousarray(samples, np.int16)
    lib = _try_load()
    out = np.empty(samples.shape, np.float32)
    if lib is None:
        np.divide(samples, 32768.0, out=out)
    else:
        lib.vadc_s16le_to_f32(samples.ravel(), out.ravel(), samples.size)
    return out


def frame_s16le(samples: np.ndarray, chunk_samples: int) -> np.ndarray:
    """s16 samples -> zero-padded [rows, chunk_samples] f32 matrix."""
    samples = np.ascontiguousarray(samples, np.int16)
    rows = -(-samples.size // chunk_samples) if samples.size else 0
    out = np.zeros((rows, chunk_samples), np.float32)
    if rows == 0:
        return out
    lib = _try_load()
    if lib is None:
        flat = samples.astype(np.float32) / 32768.0
        out.ravel()[: samples.size] = flat
    else:
        lib.vadc_frame_s16le(samples, samples.size, out, chunk_samples, rows)
    return out


class StreamPool:
    """GIL-free multi-stream PCM ingest (native/stream_pool.cpp).

    Background C++ reader threads (streams sharded by index over
    `reader_threads` pollers; 0 = auto from core count) drain N non-blocking
    fds (pipes/sockets/files) into per-stream chunk rings; `gather()` pops
    one chunk per ready stream into a [N, chunk] batch for the next device
    step. Requires the native library (no Python fallback — it exists to
    take ingest off the GIL)."""

    def __init__(
        self,
        n_streams: int,
        chunk_samples: int,
        *,
        ring_chunks: int = 64,
        reader_threads: int = 0,
    ):
        lib = _try_load()
        if lib is None:
            raise RuntimeError("native library unavailable; build with make -C native")
        self._lib = lib
        self.n_streams = n_streams
        self.chunk_samples = chunk_samples
        self._pool = lib.vadc_pool_create(
            n_streams, chunk_samples, ring_chunks, reader_threads
        )
        if not self._pool:
            raise RuntimeError("vadc_pool_create failed")
        self._started = False

    def _handle(self):
        # use-after-close must be a catchable Python error, not a NULL
        # pointer handed to C (which segfaults the whole process — e.g. an
        # engine tick racing another thread's shutdown)
        pool = self._pool
        if not pool:
            raise RuntimeError("StreamPool is closed")
        return pool

    def add_fd(self, stream_idx: int, fd: int) -> None:
        if self._lib.vadc_pool_add_fd(self._handle(), stream_idx, fd):
            raise ValueError(f"bad stream index {stream_idx}")

    def start(self) -> None:
        self._lib.vadc_pool_start(self._handle())
        self._started = True

    def gather(self) -> tuple[np.ndarray, np.ndarray, int, int]:
        """Returns (batch [N, chunk] RAW s16, ready [N] uint8, ready_count,
        backlog). ready: 1 = full chunk, 2 = zero-padded EOF tail, 0 =
        nothing new (rows with 0 are untouched/stale). backlog = streams
        that STILL hold a completed chunk after this drain, i.e. streams
        the engine is a full tick behind on — the catch-up-tick trigger
        (see vadc_pool_gather in native/stream_pool.cpp for why this is
        counted in-drain rather than probed with a second gather).

        The batch stays int16 deliberately: /32768 is a power-of-two scale,
        so converting ON DEVICE is bit-identical to host conversion while
        halving the host->device transfer per tick — the binding cost at
        the 1024-stream serving scale (see native/stream_pool.cpp)."""
        out = np.zeros((self.n_streams, self.chunk_samples), np.int16)
        ready = np.zeros(self.n_streams, np.uint8)
        backlog = ctypes.c_int64(0)
        count = self._lib.vadc_pool_gather(
            self._handle(), out, ready, ctypes.byref(backlog)
        )
        return out, ready, int(count), int(backlog.value)

    def stream_done(self, idx: int) -> bool:
        return bool(self._lib.vadc_pool_stream_done(self._handle(), idx))

    def close(self) -> None:
        if self._pool:
            self._lib.vadc_pool_destroy(self._pool)
            self._pool = None

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.close()


class NativeFsm:
    """Batched host-side segmentation FSM backed by the C++ kernel (numpy
    fallback when unavailable). Mirrors the semantics of the device FSM in
    vadc_tpu_torch.engine.vectorized_segmenter and the scalar CLI Segmenter."""

    def __init__(self, n_streams: int, *, threshold: float, neg_threshold: float,
                 min_silence_chunks: int, min_speech_chunks: int):
        self.n = n_streams
        self.threshold = float(threshold)
        self.neg_threshold = float(neg_threshold)
        self.min_silence = int(min_silence_chunks)
        self.min_speech = int(min_speech_chunks)
        self.triggered = np.zeros(n_streams, np.int32)
        self.speech_start = np.zeros(n_streams, np.int32)
        self.temp_end = np.zeros(n_streams, np.int32)
        # per-stream chunk counters: streams may be ragged/stalled
        self.chunk_index = np.zeros(n_streams, np.int32)

    def feed(
        self, probs: np.ndarray, active: np.ndarray | None = None
    ) -> list[tuple[int, int, int]]:
        """probs: [B, T]. active (optional bool/uint8 [B]): streams marked 0
        are skipped entirely (no state or index advance). Returns closed
        segments as (stream, start, end) in per-stream chunk units."""
        probs = np.ascontiguousarray(probs, np.float32)
        b, t = probs.shape
        assert b == self.n
        if active is not None:
            active = np.ascontiguousarray(active, np.uint8)
        lib = _try_load()
        if lib is not None:
            import ctypes

            max_events = b * (t // max(self.min_speech + self.min_silence, 1) + 2)
            ev_s = np.empty(max_events, np.int32)
            ev_a = np.empty(max_events, np.int32)
            ev_b = np.empty(max_events, np.int32)
            active_ptr = (
                active.ctypes.data_as(ctypes.c_void_p) if active is not None else None
            )
            count = lib.vadc_fsm_feed(
                probs, b, t, self.threshold, self.neg_threshold,
                self.min_silence, self.min_speech,
                self.triggered, self.speech_start, self.temp_end,
                self.chunk_index, active_ptr, ev_s, ev_a, ev_b, max_events,
            )
            order = np.lexsort((ev_s[:count],))  # keep deterministic order
            return [
                (int(ev_s[i]), int(ev_a[i]), int(ev_b[i])) for i in order
            ]
        # numpy fallback (vectorized over streams, loop over time)
        act = (
            np.ones(b, bool) if active is None else active.astype(bool)
        )
        events = []
        for j in range(t):
            idx = self.chunk_index + j
            p = probs[:, j]
            above = act & (p >= self.threshold)
            below = act & (p < self.neg_threshold)
            self.temp_end[above & (self.temp_end > 0)] = 0
            newly = (~self.triggered.astype(bool)) & above
            self.speech_start[newly] = idx[newly]
            self.triggered[newly] = 1
            tent = self.triggered.astype(bool) & below
            fresh = tent & (self.temp_end == 0)
            self.temp_end[fresh] = idx[fresh]
            closing = tent & (idx - self.temp_end >= self.min_silence)
            for s in np.nonzero(closing)[0]:
                if self.temp_end[s] - self.speech_start[s] >= self.min_speech:
                    events.append(
                        (int(s), int(self.speech_start[s]), int(self.temp_end[s]))
                    )
                self.triggered[s] = 0
                self.speech_start[s] = 0
                self.temp_end[s] = 0
        self.chunk_index[act] += t
        return events
