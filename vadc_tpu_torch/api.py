"""High-level Python API on the PyTorch/CUDA port: the programmatic
equivalent of the CLI. Counterpart of vadc_tpu/api.py.

    from vadc_tpu_torch import api

    segments = api.detect_speech("talk.mp3")            # via ffmpeg
    segments = api.detect_speech_samples(f32_audio)     # 16 kHz mono floats
    probs = api.speech_probabilities(f32_audio)         # one per 96 ms chunk

Every helper runs on the card (`device="cuda"`) unless the caller passes
`device="cpu"`; without a card it raises runtime.NoCudaDeviceError and never
runs on the CPU instead. The model runs in-process (the role of the
reference's Python pipeline wrapper, vadc.py:14-126, without a subprocess).

The JAX package pads the scan to a power of two of chunks so that XLA
compiles one program per bucket; the port compiles nothing per shape and
scans the chunks the audio has. The scan is causal, so the probabilities of
the real chunks are the same either way.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from vadc_tpu_torch.cli.segmenter import SegmenterConfig, segment_probabilities

_DEFAULT_RUNNERS: dict = {}


def _weights_path(model: str | None) -> Path:
    from vadc_tpu_torch.models.weights import DEFAULT_WEIGHTS

    path = Path(model) if model else DEFAULT_WEIGHTS
    if not path.exists():
        raise FileNotFoundError(f"no weight archive at {path}")
    return path


def _get_runner(model: str | None, sequence_count: int, precision: str = "faithful",
                device="cuda"):
    """(StreamRunner, chunk samples) of the model on the device, cached by
    weight path, chunk size, tier and device."""
    from vadc_tpu_torch.engine.runner import StreamRunner
    from vadc_tpu_torch.models.weights import clamp_sequence_count, load_params
    from vadc_tpu_torch.runtime import resolve_device

    path = _weights_path(model)
    device = resolve_device(device)
    key = (str(path), sequence_count, precision, str(device))
    if key not in _DEFAULT_RUNNERS:
        family, params = load_params(path, device=device)
        seq = clamp_sequence_count(family, sequence_count)
        _DEFAULT_RUNNERS[key] = (
            StreamRunner(family, params, device=device, precision=precision),
            seq,
        )
    return _DEFAULT_RUNNERS[key]


def _sample_rate(runner) -> int:
    return getattr(runner.module, "SAMPLE_RATE", 16000)


def speech_probabilities(
    samples: np.ndarray,
    *,
    model: str | None = None,
    sequence_count: int = 1536,
    precision: str = "faithful",
    device="cuda",
) -> np.ndarray:
    """Per-chunk speech probabilities for mono float32 samples at the
    model's rate (16 kHz; 8 kHz for the _8k families).

    precision: 'faithful' (fp32), or one of the bf16 tiers 'balanced',
    'fast', 'turbo' (kernels/tier_check.py holds their deviation on speech
    per family)."""
    runner, seq = _get_runner(model, sequence_count, precision, device)
    # v5 families scan fixed windows (512 @ 16 kHz / 256 @ 8 kHz); the
    # carried context is attached inside the runner
    window = getattr(runner.module, "WINDOW_SAMPLES", seq)
    samples = np.asarray(samples, np.float32).ravel()
    n_chunks = -(-len(samples) // window)
    if n_chunks == 0:
        return np.zeros(0, np.float32)
    padded = np.zeros(n_chunks * window, np.float32)
    padded[: len(samples)] = samples
    chunks = torch.from_numpy(padded.reshape(1, n_chunks, window)).to(runner.device)
    probs, _ = runner.scan(chunks, runner.init_state(1))
    return probs[0].cpu().numpy()


def detect_speech_samples(
    samples: np.ndarray,
    *,
    model: str | None = None,
    sequence_count: int = 1536,
    precision: str = "faithful",
    device="cuda",
    min_silence_ms: float = 200.0,
    min_speech_ms: float = 250.0,
    threshold: float = 0.5,
    neg_threshold_relative: float = 0.15,
    speech_pad_ms: float = 30.0,
) -> list[tuple[float, float]]:
    """Speech segments (start_s, end_s) for mono float32 samples at the
    model's rate."""
    runner, seq = _get_runner(model, sequence_count, precision, device)
    window = getattr(runner.module, "WINDOW_SAMPLES", seq)
    probs = speech_probabilities(
        samples, model=model, sequence_count=sequence_count, precision=precision, device=device
    )
    config = SegmenterConfig.from_ms(
        chunk_samples=window,
        sample_rate=_sample_rate(runner),
        min_silence_ms=min_silence_ms,
        min_speech_ms=min_speech_ms,
        threshold=threshold,
        neg_threshold_relative=neg_threshold_relative,
        speech_pad_ms=speech_pad_ms,
    )
    # emit only full chunks (reference floor semantics, vadc.c:964)
    emit = len(np.asarray(samples).ravel()) // window
    return segment_probabilities(probs[:emit], config)


def stream_segments(
    stream,
    *,
    model: str | None = None,
    sequence_count: int = 1536,
    precision: str = "faithful",
    device="cuda",
    min_silence_ms: float = 200.0,
    min_speech_ms: float = 250.0,
    threshold: float = 0.5,
    neg_threshold_relative: float = 0.15,
    speech_pad_ms: float = 30.0,
):
    """Incrementally yield (start_s, end_s) segments from a binary stream of
    s16le mono PCM at the model's sample rate (16 kHz; 8 kHz for the _8k
    families): the generator form of the CLI loop (MinibatchRunner over
    windows of cli.main.WINDOW_CHUNKS chunks), for library users consuming
    live pipes and sockets. The model loads (and a missing card raises)
    when the call is made, before the first segment is asked for."""
    from vadc_tpu_torch.cli.main import WINDOW_CHUNKS
    from vadc_tpu_torch.cli.segmenter import Segmenter
    from vadc_tpu_torch.engine.runner import MinibatchRunner
    from vadc_tpu_torch.models.weights import clamp_sequence_count, load_params
    from vadc_tpu_torch.runtime import resolve_device

    path = _weights_path(model)
    device = resolve_device(device)
    family, params = load_params(path, device=device)
    seq = clamp_sequence_count(family, sequence_count)
    runner = MinibatchRunner(family, params, batch_size=WINDOW_CHUNKS, chunk_samples=seq,
                             device=device, precision=precision)
    config = SegmenterConfig.from_ms(
        chunk_samples=seq,
        # 8 kHz families: chunk seconds and ms->chunk thresholds are on
        # the model's time base, not 16 kHz
        sample_rate=_sample_rate(runner),
        min_silence_ms=min_silence_ms,
        min_speech_ms=min_speech_ms,
        threshold=threshold,
        neg_threshold_relative=neg_threshold_relative,
        speech_pad_ms=speech_pad_ms,
    )
    return _segments_of(stream, runner, Segmenter(config), seq * WINDOW_CHUNKS)


def _segments_of(stream, runner, segmenter, window_samples: int):
    from vadc_tpu_torch.io.pcm import iter_sample_windows

    seq = runner.chunk_samples
    for window, valid in iter_sample_windows(stream, window_samples):
        probs = runner.process_window(window)
        # floor emit semantics, unconditionally (reference vadc.c:964)
        emit = valid // seq
        for prob in probs[:emit]:
            yield from segmenter.feed(prob)
    yield from segmenter.finish()


def cut_speech_samples(
    samples: np.ndarray, *, sample_rate: int | None = None, **kwargs
) -> np.ndarray:
    """Concatenate only the speech ranges of mono float32 audio at the
    model's sample rate: the library form of cli/cut.py. kwargs as
    detect_speech_samples. sample_rate defaults to the model's rate (8000
    for the _8k families): segment times are true seconds, so slicing at
    any other rate would cut the wrong sample ranges."""
    from vadc_tpu_torch.cli.segmenter import slice_segments

    if sample_rate is None:
        runner, _ = _get_runner(
            kwargs.get("model"),
            kwargs.get("sequence_count", 1536),
            kwargs.get("precision", "faithful"),
            kwargs.get("device", "cuda"),
        )
        sample_rate = _sample_rate(runner)
    samples = np.asarray(samples, np.float32).ravel()
    segments = detect_speech_samples(samples, **kwargs)
    return slice_segments(samples, segments, sample_rate)


def detect_speech(
    filename: str | Path,
    *,
    audio_source: int = 0,
    start_seconds: float = 0.0,
    **kwargs,
) -> list[tuple[float, float]]:
    """Speech segments for any media file (.wav decoded natively with
    downmix and resampling to the model's rate; anything else via ffmpeg).
    kwargs as detect_speech_samples."""
    from vadc_tpu_torch.io.pcm import s16le_to_f32
    from vadc_tpu_torch.io.wav import WavSource, is_riff_wave, sniff_media_head

    _is_regular, head = sniff_media_head(filename)
    # decode at the MODEL's rate (8 kHz families take 8 kHz input)
    runner, _ = _get_runner(
        kwargs.get("model"),
        kwargs.get("sequence_count", 1536),
        kwargs.get("precision", "faithful"),
        kwargs.get("device", "cuda"),
    )
    model_sr = _sample_rate(runner)
    if is_riff_wave(head):
        with WavSource(str(filename), target_rate=model_sr, start_seconds=start_seconds) as stream:
            samples = s16le_to_f32(stream.read(-1))
    else:
        from vadc_tpu_torch.io.ffmpeg import FFmpegSource

        with FFmpegSource(
            str(filename),
            audio_source=audio_source,
            start_seconds=start_seconds,
            sample_rate=model_sr,
        ) as stream:
            samples = s16le_to_f32(stream.read())
    return detect_speech_samples(samples, **kwargs)
