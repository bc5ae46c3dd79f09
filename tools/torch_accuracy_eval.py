"""VAD detection-accuracy evaluation of the PyTorch/CUDA port against known
ground truth: the counterpart of tools/accuracy_eval.py, with its
functions, flags and output, through vadc_tpu_torch.api on a device.

Scores the FULL pipeline (model + hysteresis segmentation, the exact CLI
path) on synthesized utterance tracks whose voiced intervals are known
exactly (vadc_tpu_torch/io/synthaudio.py). Two scores:

* frame-level precision/recall/F1 at 10 ms resolution, with a NIST-style
  boundary collar (frames within ±collar of a true boundary are excluded —
  hysteresis and ±speech_pad make exact edges undefined by design);
* segment-level precision/recall (detected <-> truth matched at IoU ≥ 0.5).

It doubles as the tier-regression check: `--all_tiers` scores every
precision tier and exits 1 unless all score as faithful does. The
degradation matrix (`--degradation_matrix`) runs over
vadc_tpu_torch/io/degrade.py. The scoring functions are this tool's own
copies of accuracy_eval.py's; nothing of JAX or of vadc_tpu is imported.

Usage: python tools/torch_accuracy_eval.py [--device cuda|cpu]
         [--utterances 20] [--seed 0]
         [--precision faithful | --all_tiers] [--model PATH]
         [--collar_ms 200] [--sr 16000|8000]
         [--snr_sweep [--noise_color white|pink]]   # robustness curve
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

FRAME_S = 0.01


def frame_labels(
    intervals: list[tuple[float, float]], total_s: float
) -> np.ndarray:
    n = int(round(total_s / FRAME_S))
    lab = np.zeros(n, bool)
    for s, e in intervals:
        lab[int(round(s / FRAME_S)) : int(round(e / FRAME_S))] = True
    return lab


def collar_mask(
    truth: list[tuple[float, float]], total_s: float, collar_s: float
) -> np.ndarray:
    """True for frames that COUNT (outside ±collar of any true boundary)."""
    n = int(round(total_s / FRAME_S))
    keep = np.ones(n, bool)
    for s, e in truth:
        for b in (s, e):
            lo = max(0, int(round((b - collar_s) / FRAME_S)))
            hi = min(n, int(round((b + collar_s) / FRAME_S)))
            keep[lo:hi] = False
    return keep


def score_frames(
    truth: list[tuple[float, float]],
    detected: list[tuple[float, float]],
    total_s: float,
    collar_s: float,
) -> dict:
    t = frame_labels(truth, total_s)
    d = frame_labels(detected, total_s)
    keep = collar_mask(truth, total_s, collar_s)
    t, d = t[keep], d[keep]
    tp = int((t & d).sum())
    fp = int((~t & d).sum())
    fn = int((t & ~d).sum())
    prec = tp / (tp + fp) if tp + fp else 1.0
    rec = tp / (tp + fn) if tp + fn else 1.0
    f1 = 2 * prec * rec / (prec + rec) if prec + rec else 0.0
    return {
        "frame_precision": round(prec, 4),
        "frame_recall": round(rec, 4),
        "frame_f1": round(f1, 4),
        "frames_scored": int(keep.sum()),
        "frames_excluded_collar": int((~keep).sum()),
    }


def score_segments(
    truth: list[tuple[float, float]], detected: list[tuple[float, float]]
) -> dict:
    def iou(a, b):
        inter = max(0.0, min(a[1], b[1]) - max(a[0], b[0]))
        union = max(a[1], b[1]) - min(a[0], b[0])
        return inter / union if union else 0.0

    matched_t: set[int] = set()
    matched_d: set[int] = set()
    for di, d in enumerate(detected):
        best, best_i = 0.0, -1
        for ti, t in enumerate(truth):
            if ti in matched_t:
                continue
            v = iou(d, t)
            if v > best:
                best, best_i = v, ti
        if best >= 0.5:
            matched_t.add(best_i)
            matched_d.add(di)
    prec = len(matched_d) / len(detected) if detected else 1.0
    rec = len(matched_t) / len(truth) if truth else 1.0
    return {
        "segments_truth": len(truth),
        "segments_detected": len(detected),
        "segments_matched": len(matched_t),
        "segment_precision": round(prec, 4),
        "segment_recall": round(rec, 4),
    }


def evaluate(
    *,
    n_utterances: int = 20,
    seed: int = 0,
    precision: str = "faithful",
    model: str | None = None,
    collar_ms: float = 200.0,
    sample_rate: int = 16000,
    device="cuda",
) -> dict:
    from vadc_tpu_torch import api
    from vadc_tpu_torch.io.synthaudio import utterance_track

    audio, truth = utterance_track(n_utterances, seed=seed, sr=sample_rate)
    total_s = len(audio) / sample_rate
    detected = api.detect_speech_samples(
        audio, precision=precision, model=model, device=device
    )
    out = {
        "utterances": n_utterances,
        "seed": seed,
        "precision": precision,
        "sample_rate": sample_rate,
        "audio_seconds": round(total_s, 2),
        "collar_ms": collar_ms,
    }
    out.update(score_frames(truth, detected, total_s, collar_ms / 1000.0))
    out.update(score_segments(truth, detected))
    return out


def sweep_thresholds(
    *,
    n_utterances: int = 20,
    seed: int = 0,
    precision: str = "faithful",
    model: str | None = None,
    collar_ms: float = 200.0,
    sample_rate: int = 16000,
    thresholds=tuple(round(0.20 + 0.05 * i, 2) for i in range(13)),
    device="cuda",
) -> dict:
    """Score the full operating-point range on ONE set of probabilities.

    The model runs once; each threshold re-runs only the host-side
    hysteresis FSM (CLI semantics: neg_threshold_relative scales with the
    threshold). The width of the F1>=0.99 plateau is the decision margin
    that makes tier probability deviations (<=2.7e-2 turbo) irrelevant
    away from the plateau edges."""
    from vadc_tpu_torch import api
    from vadc_tpu_torch.cli.segmenter import SegmenterConfig, segment_probabilities
    from vadc_tpu_torch.io.synthaudio import utterance_track

    audio, truth = utterance_track(n_utterances, seed=seed, sr=sample_rate)
    total_s = len(audio) / sample_rate
    probs = api.speech_probabilities(
        audio, precision=precision, model=model, device=device
    )
    runner, seq = api._get_runner(model, 1536, precision, device)
    window = getattr(runner.module, "WINDOW_SAMPLES", seq)
    emit = len(audio) // window
    points = []
    for t in thresholds:
        config = SegmenterConfig.from_ms(
            chunk_samples=window,
            sample_rate=getattr(runner.module, "SAMPLE_RATE", sample_rate),
            threshold=t,
        )
        detected = segment_probabilities(probs[:emit], config)
        row = {"threshold": t}
        row.update(score_frames(truth, detected, total_s, collar_ms / 1000.0))
        row.update(score_segments(truth, detected))
        points.append(row)
    ok = [p["threshold"] for p in points if p["frame_f1"] >= 0.99
          and p["segment_precision"] == 1.0 and p["segment_recall"] == 1.0]
    return {
        "utterances": n_utterances,
        "seed": seed,
        "precision": precision,
        "sample_rate": sample_rate,
        "points": points,
        "plateau_f1_0.99": [min(ok), max(ok)] if ok else None,
    }


def mix_noise(
    audio: np.ndarray,
    truth: list[tuple[float, float]],
    snr_db: float,
    sr: int,
    *,
    seed: int = 99,
    color: str = "white",
) -> np.ndarray:
    """Add calibrated noise over the WHOLE track. SNR is measured against
    the mean power of the voiced regions only (the quantity a detector
    actually competes with), so 0 dB means noise as loud as the speech."""
    rng = np.random.default_rng(seed)
    noise = rng.normal(size=len(audio)).astype(np.float32)
    if color == "pink":
        spec = np.fft.rfft(noise)
        f = np.fft.rfftfreq(len(noise), 1.0 / sr)
        f[0] = f[1]
        spec /= np.sqrt(f)
        noise = np.fft.irfft(spec, len(noise)).astype(np.float32)
    mask = np.zeros(len(audio), bool)
    for s, e in truth:
        mask[int(s * sr) : int(e * sr)] = True
    p_sig = float(np.mean(audio[mask] ** 2))
    p_noise = p_sig / (10.0 ** (snr_db / 10.0))
    noise *= np.sqrt(p_noise / float(np.mean(noise**2)))
    return (audio + noise).astype(np.float32)


def snr_sweep(
    *,
    n_utterances: int = 20,
    seed: int = 0,
    precision: str = "faithful",
    model: str | None = None,
    collar_ms: float = 200.0,
    sample_rate: int = 16000,
    snrs_db=(30.0, 20.0, 15.0, 10.0, 5.0, 0.0),
    color: str = "white",
    device="cuda",
) -> dict:
    """Detection quality vs additive-noise SNR — the robustness curve.

    The reference has no such measurement; the published Silero models are
    noise-trained, so the curve should stay near-perfect well below 20 dB
    and roll off gracefully. Also doubles as a tier-robustness check under
    adverse input: run with --precision turbo and compare."""
    from vadc_tpu_torch import api
    from vadc_tpu_torch.io.synthaudio import utterance_track

    audio, truth = utterance_track(n_utterances, seed=seed, sr=sample_rate)
    total_s = len(audio) / sample_rate
    points = []
    for snr in snrs_db:
        noisy = mix_noise(
            audio, truth, snr, sample_rate, seed=seed + 977, color=color
        )
        detected = api.detect_speech_samples(
            noisy, precision=precision, model=model, device=device
        )
        row = {"snr_db": snr}
        row.update(score_frames(truth, detected, total_s, collar_ms / 1000.0))
        row.update(score_segments(truth, detected))
        points.append(row)
    return {
        "utterances": n_utterances,
        "seed": seed,
        "precision": precision,
        "sample_rate": sample_rate,
        "noise_color": color,
        "points": points,
    }


def _degradations(sr: int, seed: int):
    """The robustness matrix: (name, transform(audio, truth) -> audio).
    Ground truth is preserved by construction for every entry (confusers
    mix UNDER the foreground at calibrated SNR; codecs are lossy but
    label-safe; reverb trims to input length)."""
    from vadc_tpu_torch.io import degrade

    return [
        ("clean", lambda a, t: a),
        ("reverb_rt60_0.4s", lambda a, t: degrade.reverb(a, sr, 0.4, seed=seed)),
        ("reverb_rt60_0.8s", lambda a, t: degrade.reverb(a, sr, 0.8, seed=seed)),
        # two band-limits separate channel coloration from fundamental
        # removal: the telephone band (300-3400) cuts the generator's
        # 140-210 Hz f0 entirely, and v3.1 stops detecting the synthetic
        # harmonic stack without its fundamental (measured: frame recall
        # 0.05, precision still 1.0 — no false alarms). Real telephony
        # speech carries formant-transition cues the stationary synthetic
        # lacks; the 8 kHz families are the product answer for that band.
        ("bandlimit_300_3400", lambda a, t: degrade.bandlimit(a, sr)),
        ("bandlimit_100_7000",
         lambda a, t: degrade.bandlimit(a, sr, 100.0, min(7000.0, sr / 2 - 1))),
        ("clip_12dB", lambda a, t: degrade.clip(a, 0.25)),
        ("g711_mu", lambda a, t: degrade.g711_roundtrip(a, law="mu")),
        ("g711_a", lambda a, t: degrade.g711_roundtrip(a, law="a")),
        ("ima_adpcm", lambda a, t: degrade.adpcm_roundtrip(a)),
        (
            "babble_10dB",
            lambda a, t: degrade.mix_background(
                a, t, degrade.babble(10.0, sr, seed=seed + 7), 10.0, sr
            ),
        ),
        (
            "music_10dB",
            lambda a, t: degrade.mix_background(
                a, t, degrade.music(10.0, sr, seed=seed + 8), 10.0, sr
            ),
        ),
    ]


def degradation_matrix(
    *,
    n_utterances: int = 8,
    seed: int = 0,
    precisions=("faithful",),
    model: str | None = None,
    collar_ms: float = 200.0,
    sample_rate: int = 16000,
    device="cuda",
) -> dict:
    """Score the full pipeline per tier x degradation.

    This is where tier deviation claims earn their keep: a tier is
    'decision-compatible' only if it scores like faithful across the whole
    matrix, not just on clean material. Reverb rows use a collar wide
    enough to absorb the physical decay tail (see degrade.reverb)."""
    from vadc_tpu_torch import api
    from vadc_tpu_torch.io.synthaudio import utterance_track

    audio, truth = utterance_track(n_utterances, seed=seed, sr=sample_rate)
    total_s = len(audio) / sample_rate
    rows = []
    for name, transform in _degradations(sample_rate, seed):
        degraded = transform(audio, truth)
        collar = collar_ms / 1000.0
        if name.startswith("reverb"):
            rt60 = float(name.rsplit("_", 1)[1][:-1])
            collar = max(collar, rt60)  # decay tail is real speech energy
        for precision in precisions:
            detected = api.detect_speech_samples(
                degraded, precision=precision, model=model, device=device
            )
            row = {"degradation": name, "precision": precision,
                   "collar_ms": round(collar * 1000.0, 1)}
            row.update(score_frames(truth, detected, total_s, collar))
            row.update(score_segments(truth, detected))
            rows.append(row)
    return {
        "utterances": n_utterances,
        "seed": seed,
        "sample_rate": sample_rate,
        "rows": rows,
    }


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--utterances", type=int, default=20)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--precision", default="faithful",
                   choices=("faithful", "balanced", "fast", "turbo"))
    p.add_argument("--all_tiers", action="store_true",
                   help="evaluate every tier and assert identical decisions")
    p.add_argument("--sweep", action="store_true",
                   help="score the 0.20-0.80 threshold range on one set of "
                        "probabilities; reports the F1>=0.99 plateau")
    p.add_argument("--snr_sweep", action="store_true",
                   help="score at additive-noise SNRs 30..0 dB (vs voiced-"
                        "region power); the detection-robustness curve")
    p.add_argument("--degradation_matrix", action="store_true",
                   help="score per tier x degradation (reverb, band-limit, "
                        "clipping, G.711/ADPCM round-trips, babble/music "
                        "background)")
    p.add_argument("--noise_color", default="white",
                   choices=("white", "pink"))
    p.add_argument("--model", default=None)
    p.add_argument("--collar_ms", type=float, default=200.0)
    p.add_argument("--sr", type=int, default=16000, choices=(16000, 8000),
                   help="generator sample rate (8000 for the *_8k families)")
    p.add_argument("--device", default="cuda",
                   help="cuda (the default: the card, or exit 1 without one) or cpu")
    args = p.parse_args(argv)

    from vadc_tpu_torch.runtime import NoCudaDeviceError, resolve_device

    try:
        device = resolve_device(args.device)
    except NoCudaDeviceError as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1
    if args.degradation_matrix:
        tiers = (
            ("faithful", "balanced", "fast", "turbo")
            if args.all_tiers
            else (args.precision,)
        )
        print(json.dumps(degradation_matrix(
            n_utterances=args.utterances, seed=args.seed,
            precisions=tiers, model=args.model,
            collar_ms=args.collar_ms, sample_rate=args.sr, device=device,
        ), indent=2))
        return 0
    if args.snr_sweep:
        print(json.dumps(snr_sweep(
            n_utterances=args.utterances, seed=args.seed,
            precision=args.precision, model=args.model,
            collar_ms=args.collar_ms, sample_rate=args.sr,
            color=args.noise_color, device=device,
        ), indent=2))
        return 0
    if args.sweep:
        print(json.dumps(sweep_thresholds(
            n_utterances=args.utterances, seed=args.seed,
            precision=args.precision, model=args.model,
            collar_ms=args.collar_ms, sample_rate=args.sr, device=device,
        ), indent=2))
        return 0
    if args.all_tiers:
        results = {
            tier: evaluate(
                n_utterances=args.utterances, seed=args.seed,
                precision=tier, model=args.model, collar_ms=args.collar_ms,
                sample_rate=args.sr, device=device,
            )
            for tier in ("faithful", "balanced", "fast", "turbo")
        }
        keys = ("frame_f1", "segment_precision", "segment_recall")
        agree = all(
            all(results[t][k] == results["faithful"][k] for k in keys)
            for t in results
        )
        print(json.dumps({"tiers": results, "tiers_agree": agree}, indent=2))
        return 0 if agree else 1
    print(json.dumps(evaluate(
        n_utterances=args.utterances, seed=args.seed,
        precision=args.precision, model=args.model, collar_ms=args.collar_ms,
        sample_rate=args.sr, device=device,
    ), indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
