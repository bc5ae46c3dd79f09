# Copy of vadc_tpu/io/wav.py (numpy only): the port imports nothing of vadc_tpu
# and keeps its own; tests/test_torch_copies.py holds it to the original.
"""Native RIFF/WAVE ingestion.

The reference can only ingest raw s16le PCM directly; every container
format goes through a spawned ffmpeg (`vadc.c:531-608`). This module
makes `vadc file.wav` work with no external decoder: it parses the RIFF
chunk list, decodes the common PCM encodings, downmixes to mono, and
resamples to the model rate (io/resample.py) — presenting the result as
the same read()-able stream of mono s16le bytes the ingest loop already
consumes, so everything downstream of the Buffered_Stream is unchanged.

Supported encodings: PCM 8-bit unsigned, 16/24/32-bit signed, IEEE
float32/float64, ITU-T G.711 mu-law/A-law (the 8 kHz telephony codecs —
the natural material for the 8 kHz model families), IMA/DVI ADPCM
(4-bit block codec: dictaphones, embedded recorders), and
WAVE_FORMAT_EXTENSIBLE wrapping any of those. Any other codec
(MS ADPCM, mp3-in-wav, ...) raises WavFormatError with a one-line
diagnosis naming the tag — those still need ffmpeg.
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass
from typing import BinaryIO

import numpy as np

from vadc_tpu_torch.io.pcm import read_full
from vadc_tpu_torch.io.resample import PolyphaseResampler

WAVE_FORMAT_PCM = 0x0001
WAVE_FORMAT_IEEE_FLOAT = 0x0003
WAVE_FORMAT_ALAW = 0x0006
WAVE_FORMAT_MULAW = 0x0007
WAVE_FORMAT_IMA_ADPCM = 0x0011  # aka DVI ADPCM
WAVE_FORMAT_EXTENSIBLE = 0xFFFE

# decodable (format_tag, bits) -> numpy dtype of the container
_CODECS = {
    (WAVE_FORMAT_PCM, 8): np.uint8,  # 8-bit wav is unsigned, offset 128
    (WAVE_FORMAT_PCM, 16): np.dtype("<i2"),
    (WAVE_FORMAT_PCM, 24): None,  # no 24-bit dtype; widened by hand
    (WAVE_FORMAT_PCM, 32): np.dtype("<i4"),
    (WAVE_FORMAT_IEEE_FLOAT, 32): np.dtype("<f4"),
    (WAVE_FORMAT_IEEE_FLOAT, 64): np.dtype("<f8"),
    (WAVE_FORMAT_ALAW, 8): np.uint8,  # G.711, decoded via LUT
    (WAVE_FORMAT_MULAW, 8): np.uint8,
    (WAVE_FORMAT_IMA_ADPCM, 4): None,  # block codec; _decode_ima_blocks
}

# IMA/DVI ADPCM quantizer tables (IMA ADPCM spec; identical values to
# the classic Intel/DVI reference implementation)
_IMA_STEPS = np.array([
    7, 8, 9, 10, 11, 12, 13, 14, 16, 17, 19, 21, 23, 25, 28, 31, 34, 37,
    41, 45, 50, 55, 60, 66, 73, 80, 88, 97, 107, 118, 130, 143, 157, 173,
    190, 209, 230, 253, 279, 307, 337, 371, 408, 449, 494, 544, 598, 658,
    724, 796, 876, 963, 1060, 1166, 1282, 1411, 1552, 1707, 1878, 2066,
    2272, 2499, 2749, 3024, 3327, 3660, 4026, 4428, 4871, 5358, 5894,
    6484, 7132, 7845, 8630, 9493, 10442, 11487, 12635, 13899, 15289,
    16818, 18500, 20350, 22385, 24623, 27086, 29794, 32767,
], np.int32)
_IMA_INDEX_ADJ = np.array([-1, -1, -1, -1, 2, 4, 6, 8], np.int32)


def _ima_expand(nibbles: np.ndarray, pred: np.ndarray,
                index: np.ndarray) -> np.ndarray:
    """Run the IMA ADPCM recurrence: nibbles [..., K] with initial
    predictor/step-index arrays [...] -> samples [..., K] (int32 in
    s16 range). Vectorized over the leading axes; the K axis is the
    inherently sequential part (one step per encoded nibble)."""
    nibbles = nibbles.astype(np.int32)
    pred = pred.astype(np.int32).copy()
    index = np.clip(index.astype(np.int32), 0, 88)
    out = np.empty(nibbles.shape, np.int32)
    for i in range(nibbles.shape[-1]):
        n = nibbles[..., i]
        step = _IMA_STEPS[index]
        diff = (step >> 3)
        diff += np.where(n & 4, step, 0)
        diff += np.where(n & 2, step >> 1, 0)
        diff += np.where(n & 1, step >> 2, 0)
        pred = np.where(n & 8, pred - diff, pred + diff)
        pred = np.clip(pred, -32768, 32767)
        index = np.clip(index + _IMA_INDEX_ADJ[n & 7], 0, 88)
        out[..., i] = pred
    return out


def _decode_ima_blocks(raw: bytes, fmt: "WavFormat") -> np.ndarray:
    """Decode whole IMA ADPCM blocks (plus an optional trailing short
    block from a truncated stream) to float32 mono. Block layout per
    channel: 4-byte header {int16 predictor, uint8 step index, pad},
    then channel-interleaved 4-byte groups of 8 nibbles (low first).
    The header predictor is the block's first sample."""
    ba, ch = fmt.block_align, fmt.channels
    pieces = []
    nfull = len(raw) // ba
    if nfull:
        pieces.append((np.frombuffer(raw[: nfull * ba], np.uint8)
                       .reshape(nfull, ba), fmt.samples_per_block))
    tail = raw[nfull * ba:]
    tail_len = 4 * ch + (len(tail) - 4 * ch) // (4 * ch) * (4 * ch)
    if len(tail) >= 8 * ch:  # header + at least one group per channel
        pieces.append((np.frombuffer(tail[:tail_len], np.uint8)
                       .reshape(1, tail_len), fmt.samples_per_block))
    mono = []
    for blocks, spb_cap in pieces:
        nb, L = blocks.shape
        hdr = blocks[:, : 4 * ch].reshape(nb, ch, 4).astype(np.int32)
        pred = ((hdr[:, :, 0] | (hdr[:, :, 1] << 8)) ^ 0x8000) - 0x8000
        index = hdr[:, :, 2]
        groups = (L - 4 * ch) // (4 * ch)
        data = blocks[:, 4 * ch: 4 * ch + groups * 4 * ch].reshape(
            nb, groups, ch, 4
        )
        # low nibble first within each byte
        nib = np.stack([data & 0x0F, data >> 4], axis=-1).reshape(
            nb, groups, ch, 8
        )
        nib = nib.transpose(0, 2, 1, 3).reshape(nb, ch, groups * 8)
        samples = np.concatenate(
            [pred[:, :, None], _ima_expand(nib, pred, index)], axis=-1
        )
        samples = samples[:, :, : spb_cap or samples.shape[-1]]
        s = samples.mean(axis=1) if ch > 1 else samples[:, 0]
        mono.append(s.reshape(-1).astype(np.float32) / 32768.0)
    if not mono:
        return np.empty(0, np.float32)
    return np.concatenate(mono)


def _g711_tables() -> tuple[np.ndarray, np.ndarray]:
    """Build the 256-entry G.711 expansion tables (ITU-T G.711 segmented
    companding; same linear values as the classic Sun ulaw2linear /
    alaw2linear, i.e. 16-bit-domain magnitudes up to 32124 / 32256)."""
    codes = np.arange(256, dtype=np.uint16)
    # mu-law: complement, then mantissa/exponent expansion around bias 0x84
    u = codes ^ 0xFF
    t = (((u & 0x0F) << 3) + 0x84).astype(np.int32) << ((u >> 4) & 0x07)
    ulaw = np.where(u & 0x80, 0x84 - t, t - 0x84).astype(np.float32)
    # A-law: even-bit inversion, segment 0/1 special-cased
    a = codes ^ 0x55
    seg = (a >> 4) & 0x07
    t = ((a & 0x0F) << 4).astype(np.int32)
    t = np.where(seg == 0, t + 8, (t + 0x108) << np.maximum(seg - 1, 0))
    alaw = np.where(a & 0x80, t, -t).astype(np.float32)
    return ulaw / 32768.0, alaw / 32768.0


_ULAW_F32, _ALAW_F32 = _g711_tables()


class WavFormatError(ValueError):
    pass


@dataclass
class WavFormat:
    format_tag: int
    channels: int
    sample_rate: int
    bits_per_sample: int
    data_bytes: int  # size of the data chunk; may exceed the actual file
    block_align: int = 0  # bytes per coded block (block codecs only)
    samples_per_block: int = 0  # frames per coded block (block codecs)
    total_frames: int = 0  # from the 'fact' chunk; 0 = unknown

    @property
    def bytes_per_frame(self) -> int:
        return self.channels * self.bits_per_sample // 8

    @property
    def is_block_codec(self) -> bool:
        return self.format_tag == WAVE_FORMAT_IMA_ADPCM

    @property
    def codec_name(self) -> str:
        return {
            WAVE_FORMAT_IEEE_FLOAT: "float",
            WAVE_FORMAT_ALAW: "g711-alaw",
            WAVE_FORMAT_MULAW: "g711-ulaw",
            WAVE_FORMAT_IMA_ADPCM: "ima-adpcm",
        }.get(self.format_tag, "pcm")


def is_riff_wave(head: bytes) -> bool:
    """Magic sniff over the first 12 bytes."""
    return len(head) >= 12 and head[:4] == b"RIFF" and head[8:12] == b"WAVE"


def sniff_media_head(path) -> tuple[bool, bytes]:
    """(is_regular_file, first-12-bytes) for a media input path — the one
    shared magic-sniff policy for the CLI and the Python API.

    Only REGULAR files are probed: a FIFO/process-substitution input must
    reach ffmpeg with its bytes untouched (a probe read would consume
    them), and a URL-scheme pseudo-path ffmpeg speaks (https://, rtmp://,
    pipe:, concat:, ...) fails os.stat but returns (False, b"") so it
    falls through to ffmpeg verbatim. Raises OSError for an unreadable
    real path (reference: CantOpenFile, vadc.c:404-414)."""
    import os
    import re
    import stat as stat_mod

    try:
        is_regular = stat_mod.S_ISREG(os.stat(path).st_mode)
        head = b""
        if is_regular:
            with open(path, "rb") as probe:
                head = probe.read(12)
    except OSError:
        if re.match(r"^[A-Za-z][A-Za-z0-9+.-]*:", str(path)):
            return False, b""
        raise
    return is_regular, head


def read_wav_header(stream: BinaryIO) -> WavFormat:
    """Parse the RIFF chunk list up to and including the 'data' chunk
    header, leaving the stream positioned at the first audio byte.

    Tolerates the chunks real encoders emit (fact, LIST, cue, bext, ...)
    by skipping them; requires fmt before data, as the spec does."""
    head = read_full(stream, 12)
    if not is_riff_wave(head):
        raise WavFormatError("not a RIFF/WAVE file")
    fmt: WavFormat | None = None
    total_frames = 0
    while True:
        hdr = read_full(stream, 8)
        if len(hdr) < 8:
            raise WavFormatError(
                "no 'data' chunk" if fmt else "no 'fmt ' chunk"
            )
        cid, size = struct.unpack("<4sI", hdr)
        if cid == b"fmt ":
            # A valid fmt chunk is <= ~64 bytes (EXTENSIBLE is 40); a huge
            # declared size is attacker-controlled garbage — refuse instead
            # of buffering up to 4 GB of client bytes. Read the RIFF pad
            # byte on odd sizes so later chunk headers stay aligned.
            if size > 1 << 16:
                raise WavFormatError(f"oversized 'fmt ' chunk ({size} bytes)")
            body = read_full(stream, size + (size & 1))[:size]
            if len(body) < 16:
                raise WavFormatError("truncated 'fmt ' chunk")
            tag, ch, sr, _brate, balign, bits = struct.unpack(
                "<HHIIHH", body[:16]
            )
            # Samples union / wSamplesPerBlock for block codecs (same
            # uint16 slot as wValidBitsPerSample in EXTENSIBLE)
            ext_samples = 0
            if len(body) >= 20:
                (cb_size,) = struct.unpack("<H", body[16:18])
                if cb_size >= 2:
                    (ext_samples,) = struct.unpack("<H", body[18:20])
            if tag == WAVE_FORMAT_EXTENSIBLE:
                # SubFormat GUID starts with the real 16-bit tag
                if len(body) < 26:
                    raise WavFormatError("truncated extensible 'fmt ' chunk")
                (ext_size,) = struct.unpack("<H", body[16:18])
                if ext_size < 22 or len(body) < 40:
                    raise WavFormatError("truncated extensible 'fmt ' chunk")
                (tag,) = struct.unpack("<H", body[24:26])
            if ch < 1:
                raise WavFormatError("zero channels")
            if sr < 1:
                raise WavFormatError("zero sample rate")
            fmt = WavFormat(tag, ch, sr, bits, 0, block_align=balign)
            if fmt.is_block_codec:
                if balign < 8 * ch:
                    raise WavFormatError(
                        f"bad ADPCM block size ({balign})"
                    )
                derived = (balign - 4 * ch) * 2 // ch + 1
                fmt.samples_per_block = (
                    ext_samples if 0 < ext_samples <= derived else derived
                )
        elif cid == b"fact" and size >= 4:
            if size > 1 << 16:
                raise WavFormatError(f"oversized 'fact' chunk ({size} bytes)")
            body = read_full(stream, size + (size & 1))
            if len(body) >= 4:
                (total_frames,) = struct.unpack("<I", body[:4])
        elif cid == b"data":
            if fmt is None:
                raise WavFormatError("'data' chunk before 'fmt '")
            # size 0 / 0xFFFFFFFF: stream-written files; read until EOF
            fmt.data_bytes = (
                size if size not in (0, 0xFFFFFFFF) else (1 << 62)
            )
            fmt.total_frames = total_frames
            if (fmt.format_tag, fmt.bits_per_sample) not in _CODECS:
                raise WavFormatError(
                    f"unsupported wav codec (format_tag={fmt.format_tag}, "
                    f"bits={fmt.bits_per_sample}); decode with ffmpeg"
                )
            return fmt
        else:
            # skip unknown chunk (word-aligned: odd sizes carry a pad
            # byte); read-discard rather than seek so pipes work too
            _discard(stream, size + (size & 1))


def _discard(stream: BinaryIO, nbytes: int) -> None:
    while nbytes > 0:
        got = stream.read(min(nbytes, 1 << 20))
        if not got:
            return
        nbytes -= len(got)


def _decode_frames(raw: bytes, fmt: WavFormat) -> np.ndarray:
    """Raw interleaved frames -> float32 mono in [-1, 1] (channel mean —
    the same downmix ffmpeg's `-ac 1` pan performs)."""
    if fmt.is_block_codec:
        return _decode_ima_blocks(raw, fmt)
    bpf = fmt.bytes_per_frame
    usable = len(raw) - len(raw) % bpf
    if usable == 0:
        return np.empty(0, np.float32)
    raw = raw[:usable]
    key = (fmt.format_tag, fmt.bits_per_sample)
    if key == (WAVE_FORMAT_PCM, 24):
        b = np.frombuffer(raw, np.uint8).reshape(-1, 3)
        x = (
            b[:, 0].astype(np.int32)
            | (b[:, 1].astype(np.int32) << 8)
            | (b[:, 2].astype(np.int32) << 16)
        )
        x = (x ^ 0x800000) - 0x800000  # sign-extend 24 -> 32
        samples = x.astype(np.float32) / 8388608.0
    else:
        x = np.frombuffer(raw, _CODECS[key])
        if key == (WAVE_FORMAT_MULAW, 8):
            samples = _ULAW_F32[x]
        elif key == (WAVE_FORMAT_ALAW, 8):
            samples = _ALAW_F32[x]
        elif key == (WAVE_FORMAT_PCM, 8):
            samples = (x.astype(np.float32) - 128.0) / 128.0
        elif key == (WAVE_FORMAT_PCM, 16):
            samples = x.astype(np.float32) / 32768.0
        elif key == (WAVE_FORMAT_PCM, 32):
            samples = x.astype(np.float32) / 2147483648.0
        else:  # float32/float64
            samples = x.astype(np.float32)
    if fmt.channels > 1:
        samples = samples.reshape(-1, fmt.channels).mean(axis=1)
    return samples


def _quantize_s16le(samples: np.ndarray) -> bytes:
    """Quantize to the pipeline's wire format (the inverse of the ingest
    /32768 contract), rounding and clipping like ffmpeg's s16 packer.
    (Distinct from pcm.f32_to_s16le, a truncating test helper.)"""
    scaled = np.rint(np.asarray(samples, np.float32) * 32768.0)
    return np.clip(scaled, -32768, 32767).astype("<i2").tobytes()


def write_wav(path, samples_s16: np.ndarray, sample_rate: int = 16000) -> None:
    """Minimal 16-bit mono PCM wav writer (the parser's inverse) — lets
    tools emit playable audio without ffmpeg (cli/cut.py)."""
    pcm = np.asarray(samples_s16, "<i2").tobytes()
    fmt = struct.pack(
        "<HHIIHH", WAVE_FORMAT_PCM, 1, sample_rate, sample_rate * 2, 2, 16
    )
    # RIFF size = everything after the size field itself:
    # "WAVE" (4) + fmt header+body (8+16) + data header (8) + payload
    with open(path, "wb") as fh:
        fh.write(b"RIFF" + struct.pack("<I", 36 + len(pcm)) + b"WAVE")
        fh.write(b"fmt " + struct.pack("<I", 16) + fmt)
        fh.write(b"data" + struct.pack("<I", len(pcm)) + pcm)


class PrependStream:
    """Serve pre-read sniff bytes back ahead of the underlying stream —
    lets the CLI peek stdin's magic without losing the bytes (stdin pipes
    cannot seek)."""

    def __init__(self, head: bytes, stream: BinaryIO):
        self._head = head
        self._stream = stream

    def read(self, n: int = -1) -> bytes:
        if self._head:
            if n is None or n < 0:
                out, self._head = self._head, b""
                return out + self._stream.read(-1)
            out, self._head = self._head[:n], self._head[n:]
            if len(out) < n:
                out += self._stream.read(n - len(out))
            return out
        return self._stream.read(n)

    def seekable(self) -> bool:
        return False


def read_file_s16(path, target_rate: int = 16000) -> np.ndarray:
    """Whole-file convenience loader: returns mono s16 samples at
    target_rate from either a RIFF/WAVE file (native decode/downmix/
    resample) or a raw s16le file (sniffed by magic). Used by the batch
    corpus CLI and the Python API so every file-taking surface accepts
    .wav uniformly."""
    with open(path, "rb") as fh:
        head = fh.read(12)
    if is_riff_wave(head):
        with WavSource(str(path), target_rate=target_rate) as src:
            raw = src.read(-1)
        # the mono-16k passthrough branch is a pure byte copy, so an
        # odd-length (truncated) data chunk must be frame-trimmed here
        # like the raw branch below, or frombuffer raises
        return np.frombuffer(raw[: len(raw) - len(raw) % 2], "<i2")
    with open(path, "rb") as fh:
        raw = fh.read()
    return np.frombuffer(raw[: len(raw) - len(raw) % 2], "<i2")


class WavSource:
    """Context manager yielding a read()-able stream of mono s16le at
    target_rate — the drop-in counterpart of FFmpegSource for .wav input.

    Takes a filename (opened and owned) or an already-open binary stream
    (borrowed — pipes and sockets work: chunk skipping and seeking are
    read-based, and partial pipe reads that split a multi-channel frame
    are carried to the next block). The 16 kHz mono s16 fast path is a
    pure byte passthrough (bit-exact with feeding the payload on stdin);
    everything else goes through decode -> downmix -> polyphase resample
    -> s16 quantize, block by block, so arbitrarily long input streams
    in constant memory.

    start_seconds skips input frames (the reference delegates this to
    ffmpeg's -ss, vadc.c:537-538)."""

    _BLOCK_FRAMES = 65536

    def __init__(
        self,
        source: str | BinaryIO,
        *,
        target_rate: int = 16000,
        start_seconds: float = 0.0,
    ):
        self._source = source
        self._owned = isinstance(source, (str, bytes, os.PathLike))
        self._target_rate = int(target_rate)
        self._start_seconds = float(start_seconds)
        self._fh: BinaryIO | None = None

    def __enter__(self) -> "WavSource":
        fh = open(self._source, "rb") if self._owned else self._source
        try:
            self._fmt = read_wav_header(fh)
        except Exception:
            if self._owned:
                fh.close()
            raise
        self._fh = fh
        fmt = self._fmt
        self._left = fmt.data_bytes
        # alignment unit of the coded stream: a frame for sample codecs,
        # a coded block for block codecs (IMA ADPCM)
        if fmt.is_block_codec:
            self._unit = fmt.block_align
            self._frames_per_unit = fmt.samples_per_block
        else:
            self._unit = fmt.bytes_per_frame
            self._frames_per_unit = 1
        self._drop_frames = 0  # decoded frames to drop (sub-unit seek)
        # honor the 'fact' frame count only for block codecs, where the
        # final block is zero-padded to full size by standard writers
        self._frames_left = (
            fmt.total_frames
            if fmt.is_block_codec and fmt.total_frames
            else None
        )
        if self._start_seconds > 0:
            skip = int(self._start_seconds * fmt.sample_rate)
            units = skip // self._frames_per_unit
            skip_bytes = min(units * self._unit, fmt.data_bytes)
            if fh.seekable():
                fh.seek(skip_bytes, 1)
            else:
                _discard(fh, skip_bytes)
            self._left -= skip_bytes
            skipped = (skip_bytes // self._unit) * self._frames_per_unit
            self._drop_frames = skip - skipped
            if self._frames_left is not None:
                # dropped sub-unit frames are consumed real frames too
                self._frames_left = max(self._frames_left - skip, 0)
        self._passthrough = (
            fmt.format_tag == WAVE_FORMAT_PCM
            and fmt.bits_per_sample == 16
            and fmt.channels == 1
            and fmt.sample_rate == self._target_rate
        )
        if not self._passthrough:
            self._resampler = PolyphaseResampler(
                fmt.sample_rate, self._target_rate
            )
        self._pending = b""  # partial frame carried between pipe reads
        self._out = bytearray()
        self._eof = False
        return self

    def __exit__(self, *exc) -> None:
        if self._fh is not None:
            if self._owned:
                self._fh.close()
            self._fh = None

    @property
    def format(self) -> WavFormat:
        return self._fmt

    def _pump(self) -> None:
        """Decode one input block into the output byte buffer."""
        assert self._fh is not None
        units = max(self._BLOCK_FRAMES // self._frames_per_unit, 1)
        want = min(self._left, units * self._unit)
        raw = self._fh.read(want) if want > 0 else b""
        if raw:
            self._left -= len(raw)
        if self._passthrough:
            if raw:
                self._out += raw
            else:
                self._eof = True
            return
        if raw:
            raw = self._pending + raw
            cut = len(raw) - len(raw) % self._unit
            self._pending = raw[cut:]
            raw = raw[:cut]
        elif self._pending and self._fmt.is_block_codec:
            # stream exhausted with a truncated final block: decode
            # what its nibbles cover
            raw, self._pending = self._pending, b""
        else:
            self._out += _quantize_s16le(self._resampler.flush())
            self._eof = True
            return
        if raw:  # may be empty while a partial unit accumulates
            mono = self._trim(_decode_frames(raw, self._fmt))
            self._out += _quantize_s16le(self._resampler.process(mono))

    def _trim(self, mono: np.ndarray) -> np.ndarray:
        """Apply the sub-unit seek drop and the 'fact' total-frame cap."""
        if self._drop_frames:
            take = min(self._drop_frames, len(mono))
            mono = mono[take:]
            self._drop_frames -= take
        if self._frames_left is not None:
            mono = mono[: self._frames_left]
            self._frames_left -= len(mono)
        return mono

    def read(self, n: int = -1) -> bytes:
        if n is None or n < 0:
            while not self._eof:
                self._pump()
            out = bytes(self._out)
            self._out.clear()
            return out
        while len(self._out) < n and not self._eof:
            self._pump()
        out = bytes(self._out[:n])
        del self._out[:n]
        return out
