# Copy of vadc_tpu/cli/segmenter.py (numpy only): the port imports nothing of vadc_tpu
# and keeps its own; tests/test_torch_copies.py holds it to the original.
"""Hysteresis speech-segmentation state machine.

Semantics match the reference exactly (feed_probability vadc.c:165-221,
emit/combine vadc.c:223-299, EOF snap vadc.c:1005-1027):

  * enter speech when probability >= threshold;
  * once triggered, a probability < neg_threshold starts a tentative end;
    the segment closes only after >= min_silence_chunks below neg_threshold
    (any prob >= threshold in between cancels the tentative end);
  * segments shorter than min_speech_chunks are discarded;
  * emitted segments are padded by +-speech_pad seconds and merged with the
    next segment when the padded ranges touch.

The FSM runs on host per emitted probability (it is O(1) per chunk); a
vectorized on-device variant for batched offline runs lives in
vadc_tpu_torch.engine.vectorized_segmenter.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, Iterator


def duration_ms_to_chunks(duration_ms: float, chunk_duration_ms: float) -> int:
    """Round a millisecond duration to whole chunks, minimum 1
    (reference vadc.c:756-768)."""
    chunks = int(duration_ms / chunk_duration_ms + 0.5)
    return max(chunks, 1)


@dataclass
class Segment:
    """Speech segment in chunk units (inclusive start, exclusive end)."""

    start_chunk: int
    end_chunk: int


@dataclass
class SegmenterConfig:
    threshold: float = 0.5
    neg_threshold: float = 0.35
    min_silence_chunks: int = 2
    min_speech_chunks: int = 3
    speech_pad_s: float = 0.030
    seconds_per_chunk: float = 0.096

    @classmethod
    def from_ms(
        cls,
        *,
        chunk_samples: int,
        sample_rate: int = 16000,
        min_silence_ms: float = 200.0,
        min_speech_ms: float = 250.0,
        threshold: float = 0.5,
        neg_threshold_relative: float = 0.15,
        speech_pad_ms: float = 30.0,
    ) -> "SegmenterConfig":
        chunk_ms = chunk_samples / sample_rate * 1000.0
        return cls(
            threshold=threshold,
            neg_threshold=threshold - neg_threshold_relative,
            min_silence_chunks=duration_ms_to_chunks(min_silence_ms, chunk_ms),
            min_speech_chunks=duration_ms_to_chunks(min_speech_ms, chunk_ms),
            speech_pad_s=speech_pad_ms / 1000.0,
            seconds_per_chunk=chunk_samples / sample_rate,
        )


@dataclass
class FeedState:
    """Resumable per-stream FSM state (reference vadc.h:110-115)."""

    triggered: bool = False
    current_speech_start: int = 0
    temp_end: int = 0


class Segmenter:
    """Stateful prob->segment FSM with pad/merge, one stream.

    Feed probabilities in chunk order with `feed`; call `finish` at EOF.
    Produces (start_seconds, end_seconds) tuples, padded and merged.
    """

    def __init__(self, config: SegmenterConfig):
        self.config = config
        self.state = FeedState()
        self.chunk_index = 0
        self._pending: Segment | None = None

    def feed(self, probability: float) -> Iterator[tuple[float, float]]:
        cfg = self.config
        st = self.state
        idx = self.chunk_index
        self.chunk_index += 1

        raw: Segment | None = None
        if probability >= cfg.threshold and st.temp_end > 0:
            st.temp_end = 0
        if not st.triggered:
            if probability >= cfg.threshold:
                st.triggered = True
                st.current_speech_start = idx
        elif probability < cfg.neg_threshold:
            if st.temp_end == 0:
                st.temp_end = idx
            if idx - st.temp_end >= cfg.min_silence_chunks:
                if st.temp_end - st.current_speech_start >= cfg.min_speech_chunks:
                    raw = Segment(st.current_speech_start, st.temp_end)
                st.current_speech_start = 0
                st.temp_end = 0
                st.triggered = False

        if raw is not None:
            yield from self._combine_or_hold(raw)

    def finish(self) -> Iterator[tuple[float, float]]:
        """EOF: snap a still-open segment to the audio end (vadc.c:1005-1027),
        then flush the pending merged segment."""
        cfg = self.config
        st = self.state
        if st.triggered:
            last_chunk = self.chunk_index - 1
            if last_chunk - st.current_speech_start > cfg.min_speech_chunks:
                yield from self._combine_or_hold(
                    Segment(st.current_speech_start, last_chunk)
                )
            st.triggered = False
        if self._pending is not None:
            yield self._padded(self._pending)
            self._pending = None

    def _combine_or_hold(self, seg: Segment) -> Iterator[tuple[float, float]]:
        cfg = self.config
        if self._pending is None:
            self._pending = seg
            return
        pending_end_padded = self._pending.end_chunk * cfg.seconds_per_chunk + cfg.speech_pad_s
        new_start_padded = max(
            seg.start_chunk * cfg.seconds_per_chunk - cfg.speech_pad_s, 0.0
        )
        if pending_end_padded >= new_start_padded:
            self._pending = Segment(self._pending.start_chunk, seg.end_chunk)
        else:
            yield self._padded(self._pending)
            self._pending = seg

    def _padded(self, seg: Segment) -> tuple[float, float]:
        cfg = self.config
        start = max(seg.start_chunk * cfg.seconds_per_chunk - cfg.speech_pad_s, 0.0)
        end = seg.end_chunk * cfg.seconds_per_chunk + cfg.speech_pad_s
        return (start, end)

    # -- resumable state (SURVEY §5.4: FSM fields + chunk index + the
    #    buffered pending segment, vadc.h:110-115 / vadc.c:829-831) --------

    def state_dict(self) -> dict:
        """Complete resumable state. Captures the held merge candidate, so a
        stop/resume BETWEEN a segment close and its pad/merge emits exactly
        what an uninterrupted run would."""
        return {
            "triggered": self.state.triggered,
            "current_speech_start": self.state.current_speech_start,
            "temp_end": self.state.temp_end,
            "chunk_index": self.chunk_index,
            "pending": None
            if self._pending is None
            else (self._pending.start_chunk, self._pending.end_chunk),
        }

    def load_state_dict(self, d: dict) -> None:
        self.state = FeedState(
            triggered=bool(d["triggered"]),
            current_speech_start=int(d["current_speech_start"]),
            temp_end=int(d["temp_end"]),
        )
        self.chunk_index = int(d["chunk_index"])
        p = d.get("pending")
        self._pending = None if p is None else Segment(int(p[0]), int(p[1]))


def segment_probabilities(
    probabilities: Iterable[float], config: SegmenterConfig
) -> list[tuple[float, float]]:
    """Run the FSM over a complete probability sequence (offline helper)."""
    seg = Segmenter(config)
    out: list[tuple[float, float]] = []
    for p in probabilities:
        out.extend(seg.feed(float(p)))
    out.extend(seg.finish())
    return out


def format_segment_seconds(start: float, end: float) -> str:
    return f"{start:.2f},{end:.2f}"


def format_segment_centiseconds(start: float, end: float) -> str:
    return f"{int(start * 100.0 + 0.5)},{int(end * 100.0 + 0.5)}"


def slice_segments(samples, segments, sample_rate: int):
    """Concatenate the sample ranges of `segments` (seconds) out of a 1-D
    array — the cutting primitive shared by cli/cut.py, the batch CLI's
    --cut_dir, and api.cut_speech_samples. Dtype-preserving."""
    import numpy as np

    samples = np.asarray(samples)
    pieces = []
    for start_s, end_s in segments:
        a = max(0, int(round(start_s * sample_rate)))
        b = min(len(samples), int(round(end_s * sample_rate)))
        if b > a:
            pieces.append(samples[a:b])
    if not pieces:
        return np.empty(0, samples.dtype)
    return np.concatenate(pieces)
