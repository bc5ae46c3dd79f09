# Copy of vadc_tpu/io/synthaudio.py (numpy only): the port imports nothing of
# vadc_tpu and keeps its own; tests/test_torch_copies.py holds it to the original.
"""Synthetic speech-like audio with KNOWN ground truth.

No real recordings exist in this environment (README "Real-recording e2e"),
so quality evaluation uses synthesized utterances the Silero models
genuinely respond to: a harmonic stack shaped by formant-like spectral
envelopes and a syllabic amplitude modulation (p ≈ 0.95 voiced, ≈ 0.00 on
silence for v3.1). The generator returns exact voiced intervals, giving the
accuracy evaluator (tools/accuracy_eval.py) frame-level ground truth — the
role the reference's RED.s16le fixtures play for its e2e test
(test.c:1970-2196), plus labels, which those fixtures lack.
"""

from __future__ import annotations

import numpy as np

__all__ = ["voiced", "silence", "utterance_track"]


def voiced(
    duration_s: float,
    f0: float = 120.0,
    sr: int = 16000,
    *,
    syllable_hz: float = 3.0,
    amplitude: float = 0.3,
    phase_seed: int = 0,
    breath: float = 2e-3,
) -> np.ndarray:
    """Speech-like signal: 24 harmonics of f0 weighted by three formant
    envelopes (~500/1500/2500 Hz), syllabically amplitude-modulated, plus a
    broadband aspiration floor `breath` (relative to peak, default ~-54 dB).

    The aspiration floor is not decoration: real speech always carries
    broadband excitation, and a PURE harmonic stack is numerically
    pathological for Silero's front-end — inter-harmonic STFT bins cancel
    to the rounding floor, where log1p(2^20*x) amplifies ANY
    summation-order difference into O(1) feature changes (measured: even
    the bf16_3x tier's probabilities then deviate up to 0.29 from fp32,
    and probabilities are not comparable across implementations at all).
    With the floor the material is both realistic and well-conditioned;
    set breath=0 to reproduce the pathological stress case deliberately."""
    t = np.arange(int(duration_s * sr)) / sr
    sig = np.zeros_like(t)
    rng = np.random.default_rng(phase_seed)
    # Quasi-ALIGNED harmonic phases (k + small jitter), not uniform-random:
    # voiced speech has glottal-pulse structure — harmonics roughly cohere
    # at each pulse — and Silero keys on it. Fully random phases turn the
    # same spectrum into babble-like noise and halve the model's peak
    # probability (measured: p 0.95 -> 0.26-0.49), which is correct model
    # behavior but wrong ground truth for an accuracy evaluation.
    phases = np.arange(25, dtype=np.float64) + rng.uniform(-0.3, 0.3, 25)
    for k in range(1, 25):
        f = k * f0
        if f >= sr / 2:
            break
        w = (
            np.exp(-(((f - 500) / 400) ** 2))
            + 0.7 * np.exp(-(((f - 1500) / 500) ** 2))
            + 0.3 * np.exp(-(((f - 2500) / 700) ** 2))
        )
        sig += w * np.sin(2 * np.pi * f * t + phases[k])
    # syllabic envelope starts/ends near zero so interval edges are clean
    env = 0.5 * (1 + np.sin(2 * np.pi * syllable_hz * t - np.pi / 2))
    sig *= env
    peak = np.abs(sig).max()
    if peak > 0:
        sig = amplitude * sig / peak
    if breath > 0:
        # envelope-shaped so interval edges stay exactly at the gap boundary
        sig += (breath * amplitude) * env * rng.normal(size=len(t))
    return sig.astype(np.float32)


def silence(
    duration_s: float, sr: int = 16000, *, noise: float = 0.001, seed: int = 1
) -> np.ndarray:
    """Near-silence: low-level white noise."""
    rng = np.random.default_rng(seed)
    return (noise * rng.normal(size=int(duration_s * sr))).astype(np.float32)


def utterance_track(
    n_utterances: int = 10,
    *,
    sr: int = 16000,
    seed: int = 0,
    min_speech_s: float = 0.6,
    max_speech_s: float = 3.5,
    min_gap_s: float = 0.8,
    max_gap_s: float = 2.5,
    f0_range: tuple[float, float] = (140.0, 210.0),
    amplitude_range: tuple[float, float] = (0.25, 0.5),
    noise: float = 0.001,
    breath: float = 2e-3,
) -> tuple[np.ndarray, list[tuple[float, float]]]:
    """A track of alternating silence gaps and voiced utterances with varied
    pitch/level/duration. Returns (float32 audio, [(start_s, end_s), ...])
    where the intervals are the EXACT voiced spans.

    Default ranges sit inside Silero's operating point so ground truth =
    detectable speech. Measured sensitivity of the real v3.1 weights on
    this material: peak probability declines with PITCH for stationary
    synthetic voicing — f0 100-136 Hz peaks at p 0.27-0.53 (sub-threshold)
    where f0 ≥ 140 Hz reliably clears 0.5; adding f0 drift/vibrato helps
    some low-pitch cases and hurts others (measured both directions).
    That is model behavior, not pipeline error, so the default corpus
    stays ≥ 140 Hz; widen the ranges to deliberately create borderline
    material."""
    rng = np.random.default_rng(seed)
    pieces: list[np.ndarray] = []
    truth: list[tuple[float, float]] = []
    # the cursor advances by the ACTUAL sample count of each appended piece
    # (each generator truncates to int(duration*sr)); accumulating float
    # durations instead would drift the "exact" ground truth by up to one
    # sample per piece (~20 samples over a default track)
    cursor = 0
    for i in range(n_utterances):
        gap = float(rng.uniform(min_gap_s, max_gap_s))
        pieces.append(silence(gap, sr, noise=noise, seed=seed * 1000 + i))
        cursor += len(pieces[-1])
        dur = float(rng.uniform(min_speech_s, max_speech_s))
        f0 = float(rng.uniform(*f0_range))
        amp = float(rng.uniform(*amplitude_range))
        pieces.append(
            voiced(dur, f0, sr, amplitude=amp, phase_seed=seed * 1000 + i,
                   breath=breath)
        )
        truth.append((cursor / sr, (cursor + len(pieces[-1])) / sr))
        cursor += len(pieces[-1])
    tail = float(rng.uniform(min_gap_s, max_gap_s))
    pieces.append(silence(tail, sr, noise=noise, seed=seed * 1000 + n_utterances))
    return np.concatenate(pieces), truth
