# Copy of vadc_tpu/io/pcm.py (numpy only): the port imports nothing of vadc_tpu
# and keeps its own; tests/test_torch_copies.py holds it to the original.
"""PCM conversion and buffered window reading.

Replicates the reference ingest contract (vadc.c:852-999): raw mono 16 kHz
s16le, converted to f32 by /32768, windows zero-padded at the tail. The
window reader loops until the requested byte count is filled or EOF — the
same full-buffer refill discipline as the reference's Buffered_Stream
(refill_HANDLE, vadc.c:492-529).
"""

from __future__ import annotations

import enum
from typing import BinaryIO, Callable, Iterator

import numpy as np

SAMPLE_RATE = 16000
BYTES_PER_SAMPLE = 2


class BSError(enum.IntEnum):
    """Latched stream error kinds (reference BS_Error, vadc.c:404-414)."""

    NoError = 0
    Error = 1
    EndOfFile = 2
    Memory = 3
    CantOpenFile = 4


class BufferedStream:
    """Pull-based full-window refill with error latching and a deterministic
    zero drain (reference Buffered_Stream, vadc.c:401-529).

    Each `refill()` returns (window_bytes, error_code). While healthy it
    reads a full window (short only when data ran out mid-window — that
    partial window is returned with NoError, exactly like the reference's
    partial-read path). The refill that finds no data at all latches an
    error kind — EndOfFile on clean EOF, Error on an OS read failure or a
    nonzero source exit — and from then on every refill returns an all-zero
    window with the latched code (refill_zeros, vadc.c:439-448), so any
    consumer that keeps pulling drains deterministically.

    `eof_error_check` lets a source refine the latched kind at EOF (the
    ffmpeg source reports Error when the decoder exited nonzero — the case
    the reference cannot distinguish from clean EOF)."""

    def __init__(
        self,
        stream: BinaryIO,
        window_bytes: int,
        *,
        eof_error_check: Callable[[], "BSError | None"] | None = None,
    ):
        self._stream = stream
        self._window_bytes = window_bytes
        self._eof_error_check = eof_error_check
        self.error_code = BSError.NoError

    def _fail(self, code: BSError) -> tuple[bytes, BSError]:
        self.error_code = code
        return b"\x00" * self._window_bytes, code

    def refill(self) -> tuple[bytes, BSError]:
        if self.error_code != BSError.NoError:  # latched: zero drain
            return b"\x00" * self._window_bytes, self.error_code
        try:
            data = read_full(self._stream, self._window_bytes)
        except OSError:
            return self._fail(BSError.Error)
        if not data:
            code = BSError.EndOfFile
            if self._eof_error_check is not None:
                code = self._eof_error_check() or BSError.EndOfFile
            return self._fail(code)
        return data, BSError.NoError


def s16le_to_f32(data: bytes) -> np.ndarray:
    """s16le bytes -> float32 in [-1, 1) via /32768 (vadc.c:873-901)."""
    samples = np.frombuffer(data, dtype="<i2")
    return samples.astype(np.float32) / 32768.0


def f32_to_s16le(samples: np.ndarray) -> bytes:
    """float32 -> s16le bytes with clipping (test/bench helper)."""
    clipped = np.clip(np.asarray(samples, np.float64) * 32768.0, -32768, 32767)
    return clipped.astype("<i2").tobytes()


def read_full(stream: BinaryIO, nbytes: int) -> bytes:
    """Read exactly nbytes unless EOF intervenes (may return short/empty)."""
    chunks: list[bytes] = []
    remaining = nbytes
    while remaining > 0:
        part = stream.read(remaining)
        if not part:
            break
        chunks.append(part)
        remaining -= len(part)
    return b"".join(chunks)


def iter_sample_windows(
    stream: BinaryIO, window_samples: int
) -> Iterator[tuple[np.ndarray, int]]:
    """Yield (f32 window zero-padded to window_samples, valid_sample_count).

    Terminates after the first short window (EOF), matching the reference
    main loop: a partial final window is processed, then the stream ends.
    """
    window_bytes = window_samples * BYTES_PER_SAMPLE
    while True:
        data = read_full(stream, window_bytes)
        if not data:
            return
        if len(data) % BYTES_PER_SAMPLE:
            data = data[: len(data) - 1]  # drop trailing odd byte
        samples = s16le_to_f32(data)
        valid = samples.shape[0]
        if valid < window_samples:
            padded = np.zeros(window_samples, np.float32)
            padded[:valid] = samples
            yield padded, valid
            return
        yield samples, valid
