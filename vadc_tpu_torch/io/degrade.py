"""Audio degradations and speech-like confusers for robustness evaluation.

Where VAD tiers and model families actually diverge is not clean speech
but degraded channels: reverberation, telephone band-limiting, clipping,
lossy codec round-trips, and speech-shaped background (babble, music).
These transforms preserve the generator's ground-truth intervals by
construction — each maps the voiced spans through a known, label-safe
operation — so tools/accuracy_eval.py can score the full pipeline on a
degradation matrix with exact labels. The reference has nothing in this
category (its e2e test replays its own recorded outputs, test.c:2027-2196).

Codec round-trips reuse the production G.711/IMA decode paths in io/wav.py
(the encoder here is the matching spec-shaped inverse), so the matrix also
exercises the real ingestion decoders end to end.
"""

from __future__ import annotations

import numpy as np

from vadc_tpu_torch.io.wav import (
    _ALAW_F32,
    _IMA_INDEX_ADJ,
    _IMA_STEPS,
    _ULAW_F32,
    _ima_expand,
)

__all__ = [
    "reverb",
    "bandlimit",
    "clip",
    "g711_roundtrip",
    "adpcm_roundtrip",
    "babble",
    "music",
    "mix_background",
]


# -- channel degradations -------------------------------------------------


def synthetic_rir(
    sr: int, rt60_s: float = 0.4, *, seed: int = 0, n_early: int = 6
) -> np.ndarray:
    """Synthetic room impulse response: unit direct path, a few sparse
    early reflections inside the first 50 ms, and an exponentially decaying
    Gaussian tail calibrated so energy falls 60 dB at rt60_s."""
    n = max(1, int(rt60_s * sr))
    rng = np.random.default_rng(seed)
    t = np.arange(n) / sr
    # e^{-2 tau t} energy decay; 60 dB at rt60: tau = ln(1000)/rt60
    tau = np.log(1000.0) / rt60_s
    rir = rng.normal(size=n).astype(np.float32) * np.exp(-tau * t).astype(
        np.float32
    )
    rir *= 0.3 / max(float(np.abs(rir).max()), 1e-12)
    rir[0] = 1.0  # direct path
    # early reflections live in the first 50 ms, clamped to the RIR length
    # so very short rt60 values stay valid (no index past n, and lo < hi)
    hi = min(int(0.05 * sr), n)
    lo = min(int(0.005 * sr), max(hi - 1, 1))
    if hi > lo:
        early = rng.integers(lo, hi, n_early)
        rir[early] += rng.uniform(0.2, 0.5, n_early).astype(
            np.float32
        ) * np.sign(rng.normal(size=n_early)).astype(np.float32)
    return rir


def reverb(
    audio: np.ndarray,
    sr: int,
    rt60_s: float = 0.4,
    *,
    wet: float = 0.6,
    seed: int = 0,
) -> np.ndarray:
    """Convolve with a synthetic RIR; output trimmed to the input length so
    ground-truth intervals stay aligned (the decay tail past each utterance
    is genuine reverberant speech energy — score with a collar that
    absorbs it, as for any hysteresis edge)."""
    rir = synthetic_rir(sr, rt60_s, seed=seed)
    n = len(audio)
    spec = np.fft.rfft(audio, n + len(rir) - 1) * np.fft.rfft(
        rir, n + len(rir) - 1
    )
    out = np.fft.irfft(spec, n + len(rir) - 1)[:n].astype(np.float32)
    mixed = (1.0 - wet) * audio + wet * out
    peak = float(np.abs(mixed).max())
    if peak > 1.0:
        mixed = mixed / peak
    return mixed.astype(np.float32)


def bandlimit(
    audio: np.ndarray,
    sr: int,
    low_hz: float = 300.0,
    high_hz: float = 3400.0,
) -> np.ndarray:
    """Telephone-channel band-limit (FFT brickwall 300-3400 Hz default)."""
    spec = np.fft.rfft(audio)
    f = np.fft.rfftfreq(len(audio), 1.0 / sr)
    spec[(f < low_hz) | (f > high_hz)] = 0.0
    return np.fft.irfft(spec, len(audio)).astype(np.float32)


def clip(audio: np.ndarray, headroom: float = 0.25) -> np.ndarray:
    """Hard clipping: saturate at `headroom` x peak (0.25 = 12 dB of
    overdrive), keeping the original peak level."""
    peak = float(np.abs(audio).max()) or 1.0
    lim = headroom * peak
    return np.clip(audio, -lim, lim).astype(np.float32) * (peak / lim)


# -- codec round-trips (production decoders, spec-shaped encoders) --------


def _nearest_code_encoder(decode_table: np.ndarray):
    """Encode by nearest decoded value — exact for G.711, which is defined
    by its 256-entry expansion table."""
    order = np.argsort(decode_table, kind="stable")
    sorted_vals = decode_table[order]
    mids = (sorted_vals[1:] + sorted_vals[:-1]) / 2.0

    def encode(x: np.ndarray) -> np.ndarray:
        return order[np.searchsorted(mids, x)].astype(np.uint8)

    return encode


_ULAW_ENC = _nearest_code_encoder(_ULAW_F32)
_ALAW_ENC = _nearest_code_encoder(_ALAW_F32)


def g711_roundtrip(audio: np.ndarray, *, law: str = "mu") -> np.ndarray:
    """G.711 companding round-trip through the production decode tables
    (io/wav._g711_tables): float32 -> 8-bit code -> float32."""
    table = _ULAW_F32 if law == "mu" else _ALAW_F32
    enc = _ULAW_ENC if law == "mu" else _ALAW_ENC
    x = np.clip(audio, -1.0, 1.0).astype(np.float32)
    return table[enc(x)].astype(np.float32)


def adpcm_roundtrip(audio: np.ndarray) -> np.ndarray:
    """IMA ADPCM (4-bit) round-trip: spec-shaped encoder here, decoded by
    the production recurrence (io/wav._ima_expand). ~4 kB/s at 8 kHz —
    the harshest common telephony storage codec."""
    s16 = np.clip(np.round(audio * 32768.0), -32768, 32767).astype(np.int32)
    if len(s16) < 2:
        return audio.astype(np.float32)
    nibbles = np.empty(len(s16) - 1, np.int32)
    pred, index = int(s16[0]), 0
    steps, adj = _IMA_STEPS, _IMA_INDEX_ADJ
    for i, s in enumerate(s16[1:]):
        step = int(steps[index])
        diff = int(s) - pred
        nib = 8 if diff < 0 else 0
        diff = abs(diff)
        if diff >= step:
            nib |= 4
            diff -= step
        if diff >= step >> 1:
            nib |= 2
            diff -= step >> 1
        if diff >= step >> 2:
            nib |= 1
        d = step >> 3
        if nib & 4:
            d += step
        if nib & 2:
            d += step >> 1
        if nib & 1:
            d += step >> 2
        pred = max(-32768, min(32767, pred - d if nib & 8 else pred + d))
        index = max(0, min(88, index + int(adj[nib & 7])))
        nibbles[i] = nib
    decoded = _ima_expand(
        nibbles[None], np.asarray([int(s16[0])]), np.asarray([0])
    )[0]
    out = np.concatenate([[float(s16[0])], decoded.astype(np.float32)])
    return (out / 32768.0).astype(np.float32)


# -- speech-like confusers -------------------------------------------------


def babble(
    duration_s: float, sr: int = 16000, *, n_talkers: int = 8, seed: int = 0
) -> np.ndarray:
    """Multi-talker babble: overlapping voiced utterances at random pitches
    and incoherent syllabic phases. Dense overlap removes the single-talker
    modulation structure VADs key on; used as BACKGROUND via
    mix_background (babble is speech — as foreground it would be)."""
    from vadc_tpu_torch.io.synthaudio import voiced

    rng = np.random.default_rng(seed)
    n = int(duration_s * sr)
    out = np.zeros(n, np.float32)
    for k in range(n_talkers):
        f0 = float(rng.uniform(90.0, 240.0))
        syl = float(rng.uniform(2.0, 5.0))
        v = voiced(
            duration_s,
            f0,
            sr,
            syllable_hz=syl,
            phase_seed=seed * 131 + k,
            amplitude=1.0,
        )[:n]
        # random circular shift decorrelates the syllabic envelopes
        out += np.roll(v, int(rng.integers(0, max(1, n))))
    peak = float(np.abs(out).max()) or 1.0
    return (out / peak).astype(np.float32)


def music(duration_s: float, sr: int = 16000, *, seed: int = 0) -> np.ndarray:
    """Sustained chord progression: steady harmonic stacks WITHOUT syllabic
    amplitude modulation (2 s chords, slow 0.5 Hz swell). Spectrally rich
    like voicing but temporally flat — the classic VAD confuser."""
    rng = np.random.default_rng(seed)
    n = int(duration_s * sr)
    t = np.arange(n) / sr
    out = np.zeros(n, np.float32)
    chord_len = int(2.0 * sr)
    roots = rng.uniform(110.0, 220.0, max(1, n // chord_len + 1))
    for ci, root in enumerate(roots):
        sl = slice(ci * chord_len, min(n, (ci + 1) * chord_len))
        if sl.start >= n:
            break
        tt = t[sl]
        seg = np.zeros(sl.stop - sl.start, np.float64)
        for ratio in (1.0, 1.25, 1.5, 2.0):  # major triad + octave
            f = root * ratio
            for h in range(1, 6):  # a few harmonics per note
                if f * h >= sr / 2:
                    break
                seg += (0.5**h) * np.sin(
                    2 * np.pi * f * h * tt + rng.uniform(0, 2 * np.pi)
                )
        out[sl] = seg.astype(np.float32)
    swell = 0.75 + 0.25 * np.sin(2 * np.pi * 0.5 * t)
    out *= swell.astype(np.float32)
    peak = float(np.abs(out).max()) or 1.0
    return (out / peak).astype(np.float32)


def mix_background(
    audio: np.ndarray,
    truth: list[tuple[float, float]],
    background: np.ndarray,
    snr_db: float,
    sr: int,
) -> np.ndarray:
    """Mix a confuser under the whole track at a calibrated SNR measured
    against voiced-region power (same convention as accuracy_eval's
    mix_noise). Ground truth is unchanged: background babble/music below
    the foreground is noise, not labeled speech."""
    bg = background
    reps = int(np.ceil(len(audio) / len(bg)))
    bg = np.tile(bg, reps)[: len(audio)]
    mask = np.zeros(len(audio), bool)
    for s, e in truth:
        mask[int(s * sr) : int(e * sr)] = True
    if not mask.any():
        # No labeled speech to calibrate against (np.mean of the empty
        # slice would be NaN and poison the whole mix); fall back to
        # whole-track power so silence-only material still gets a
        # sensibly-scaled background.
        mask[:] = True
    p_sig = float(np.mean(audio[mask] ** 2))
    p_bg = p_sig / (10.0 ** (snr_db / 10.0))
    bg = bg * np.sqrt(p_bg / max(float(np.mean(bg**2)), 1e-20))
    return (audio + bg).astype(np.float32)
