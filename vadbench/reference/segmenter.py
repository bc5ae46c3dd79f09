"""Plain segmenter: chunk probabilities -> the CLI's segment lines.

A frozen copy of the port's hysteresis state machine with its pad and
merge (the `vadc` reference's feed_probability, emit/combine and EOF snap),
which also says after which chunk each line becomes final: a line is
written when the next segment that does not merge with it closes, or at
the end of the stream. The benchmark times a served line from that chunk.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass

import numpy as np

EOF = -1  # the emit chunk of a line that the end of the stream writes


@dataclass(frozen=True)
class Config:
    threshold: float = 0.5
    neg_threshold: float = 0.35
    min_silence_chunks: int = 2
    min_speech_chunks: int = 3
    speech_pad_s: float = 0.030
    seconds_per_chunk: float = 0.096

    @classmethod
    def for_chunk(cls, chunk_samples: int, sample_rate: int) -> "Config":
        """The CLI's defaults: min silence 200 ms, min speech 250 ms,
        threshold 0.5, negative threshold 0.5 - 0.15, pad 30 ms."""
        chunk_ms = chunk_samples / sample_rate * 1000.0
        return cls(
            min_silence_chunks=max(int(200.0 / chunk_ms + 0.5), 1),
            min_speech_chunks=max(int(250.0 / chunk_ms + 0.5), 1),
            seconds_per_chunk=chunk_samples / sample_rate,
        )


def lines(probs, cfg: Config) -> list[tuple[str, int]]:
    """[(line, emit chunk)] of one stream's probabilities, EOF included;
    the emit chunk is EOF for lines the end of the stream writes."""
    out: list[tuple[str, int]] = []
    pending = None
    triggered, start, temp_end = False, 0, 0

    def text(seg):
        s = max(seg[0] * cfg.seconds_per_chunk - cfg.speech_pad_s, 0.0)
        e = seg[1] * cfg.seconds_per_chunk + cfg.speech_pad_s
        return f"{s:.2f},{e:.2f}"

    def combine(seg, at):
        nonlocal pending
        if pending is None:
            pending = seg
            return
        pend_end = pending[1] * cfg.seconds_per_chunk + cfg.speech_pad_s
        new_start = max(seg[0] * cfg.seconds_per_chunk - cfg.speech_pad_s, 0.0)
        if pend_end >= new_start:
            pending = (pending[0], seg[1])
        else:
            out.append((text(pending), at))
            pending = seg

    for idx, p in enumerate(np.asarray(probs, np.float64).tolist()):
        if p >= cfg.threshold and temp_end > 0:
            temp_end = 0
        if not triggered:
            if p >= cfg.threshold:
                triggered, start = True, idx
        elif p < cfg.neg_threshold:
            if temp_end == 0:
                temp_end = idx
            if idx - temp_end >= cfg.min_silence_chunks:
                if temp_end - start >= cfg.min_speech_chunks:
                    combine((start, temp_end), idx)
                triggered, start, temp_end = False, 0, 0
    n = len(probs)
    if triggered and (n - 1) - start > cfg.min_speech_chunks:
        combine((start, n - 1), EOF)
    if pending is not None:
        out.append((text(pending), EOF))
    return out


def match(got: list[str], probs, cfg: Config, bound: float, max_flips: int = 10):
    """The emit chunks of `got` if the plain segmenter gives exactly those
    lines from `probs`, where each probability within `bound` of a threshold
    may fall on either side of it (the program's probabilities may differ
    from the reference's by up to `bound`); else None."""
    want = lines(probs, cfg)
    if [t for t, _ in want] == got:
        return [c for _, c in want]
    p = np.asarray(probs, np.float64)
    near = []
    for thr in (cfg.threshold, cfg.neg_threshold):
        near += [(int(i), thr) for i in np.flatnonzero(np.abs(p - thr) <= bound)]
    if not near:
        return None
    if len(near) <= max_flips:
        choices = itertools.chain.from_iterable(
            itertools.combinations(near, k) for k in range(1, len(near) + 1))
    else:
        choices = ([x] for x in near)
    for flips in choices:
        q = p.copy()
        for i, thr in flips:
            q[i] = thr - 1e-9 if q[i] >= thr else thr
        want = lines(q, cfg)
        if [t for t, _ in want] == got:
            return [c for _, c in want]
    return None
