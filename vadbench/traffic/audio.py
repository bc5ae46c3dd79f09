"""Seeded speech-like audio for the benchmark's traffic.

`voiced` and `silence` are frozen copies of the port's synthetic speech
generator (24 harmonics under three formant envelopes, a 3 Hz syllabic
envelope and a breath floor: the Silero models answer it with p near 0.95
in voice and near 0 in the gaps). A `Library` holds a few dozen such pieces
made once from the seed, as s16 bytes at a few gain levels; each stream
(a corpus file) is a seeded sequence of pauses and voiced
pieces drawn from it. The set of piece durations is the same for every
seed (evenly spaced over the traffic's ranges), and the seed chooses their
pitch, phase, gain and order, so every seed carries the same work.
"""

from __future__ import annotations

import numpy as np

SR = 16000


def voiced(duration_s: float, f0: float, sr: int = SR, *, amplitude: float = 0.3,
           phase_seed: int = 0, breath: float = 2e-3) -> np.ndarray:
    """Speech-like signal: harmonics of f0 under formant envelopes near
    500/1500/2500 Hz, a syllabic envelope and an aspiration floor."""
    t = np.arange(int(duration_s * sr)) / sr
    sig = np.zeros_like(t)
    rng = np.random.default_rng(phase_seed)
    phases = np.arange(25, dtype=np.float64) + rng.uniform(-0.3, 0.3, 25)
    for k in range(1, 25):
        f = k * f0
        if f >= sr / 2:
            break
        w = (np.exp(-(((f - 500) / 400) ** 2)) + 0.7 * np.exp(-(((f - 1500) / 500) ** 2))
             + 0.3 * np.exp(-(((f - 2500) / 700) ** 2)))
        sig += w * np.sin(2 * np.pi * f * t + phases[k])
    env = 0.5 * (1 + np.sin(2 * np.pi * 3.0 * t - np.pi / 2))
    sig *= env
    peak = np.abs(sig).max()
    if peak > 0:
        sig = amplitude * sig / peak
    if breath > 0:
        sig += (breath * amplitude) * env * rng.normal(size=len(t))
    return sig.astype(np.float32)


def silence(duration_s: float, sr: int = SR, *, noise: float = 0.001, seed: int = 1) -> np.ndarray:
    """Near-silence: low-level white noise."""
    rng = np.random.default_rng(seed)
    return (noise * rng.normal(size=int(duration_s * sr))).astype(np.float32)


def to_s16(audio: np.ndarray) -> np.ndarray:
    return np.clip(np.round(audio * 32768.0), -32768, 32767).astype("<i2")


class Library:
    """The pieces of one seed: `voiced[i][g]` and `pauses[i][g]` are s16le
    bytes of piece i at gain level g."""

    def __init__(self, seed: int, p: dict):
        rng = np.random.default_rng([seed, 0])
        gains = np.geomspace(p["gain_min"], p["gain_max"], p["gain_levels"])
        v_durs = rng.permutation(np.linspace(*p["voiced_s"], p["voiced_pieces"]))
        p_durs = rng.permutation(np.linspace(*p["pause_s"], p["pause_pieces"]))
        self.voiced, self.pauses = [], []
        for i, dur in enumerate(v_durs):
            f0 = float(rng.uniform(*p["f0_hz"]))
            piece = voiced(float(dur), f0, amplitude=0.3, phase_seed=int(rng.integers(2**31)))
            self.voiced.append([to_s16(piece * g).tobytes() for g in gains])
        for i, dur in enumerate(p_durs):
            piece = silence(float(dur), seed=int(rng.integers(2**31)))
            self.pauses.append([to_s16(piece * g).tobytes() for g in gains])
        self.gain_levels = len(gains)


class Stream:
    """One stream's bytes: pause, voiced, pause, voiced, ... from the
    library, each piece chosen by the stream's own generator, at the
    stream's gain level. `take(n)` returns the next n bytes."""

    def __init__(self, lib: Library, seed: int, index: int):
        self.lib = lib
        self.rng = np.random.default_rng([seed, 1, index])
        self.gain = int(self.rng.integers(lib.gain_levels))
        self.voiced_next = bool(self.rng.integers(2))
        self.piece, self.off = b"", 0

    def _next_piece(self) -> bytes:
        group = self.lib.voiced if self.voiced_next else self.lib.pauses
        self.voiced_next = not self.voiced_next
        return group[int(self.rng.integers(len(group)))][self.gain]

    def take(self, n: int) -> bytes:
        end = self.off + n
        if end <= len(self.piece):
            out = self.piece[self.off : end]
            self.off = end
            return out
        parts = [self.piece[self.off :]]
        need = n - len(parts[0])
        while True:
            self.piece = self._next_piece()
            if need <= len(self.piece):
                parts.append(self.piece[:need])
                self.off = need
                return b"".join(parts)
            parts.append(self.piece)
            need -= len(self.piece)


def stream_bytes(lib: Library, seed: int, index: int, n: int) -> bytes:
    """The first n bytes of stream `index`."""
    return Stream(lib, seed, index).take(n)
