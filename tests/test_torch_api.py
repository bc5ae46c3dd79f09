"""The port's Python API (vadc_tpu_torch/api.py) against the JAX package's
(vadc_tpu/api.py) on the CPU (`device="cpu"`).

The cases of tests/test_api.py, each run through both APIs on the same
seeded audio. On speech tracks with a noise floor (io/synthaudio.py)
probabilities are held at the whole-model bound 1e-4 for Silero v3.1 and
v4 (log1p(2^20 x) amplifies both packages' fp32 spectrum rounding at
near-zero bins: tests/test_torch_fused_audio.py) and 1e-5 for the
synthetic v5 weights (tests/test_torch_v5.py). tests/test_api.py's own
material is a pure harmonic stack whose inter-harmonic bins cancel to the
rounding floor: there v3.1's probabilities are held at the README's
full-model bound 1e-3, as tests/test_torch_cli.py holds the CLI's on such
a file (measured here: 1.4e-4). Segments, cut samples and the generator's
segments are required identical. A bf16 tier is held
to faithful by kernels/tier_check.SPEECH_BOUND. With `device="cuda"` and
no card every helper raises runtime.NoCudaDeviceError.

Not ported: test_pack_roundtrip waits for export/pack.py (ROADMAP.md,
Queue 1 item 5), and test_testtensor_fuzz's parser is the port's copy of
io/testtensor.py, held to the original by tests/test_torch_copies.py (its
fuzz is repeated below on the copy).
"""

import io
import struct
import wave

import numpy as np
import pytest

from tests.conftest import assert_close
from tests.torch_port_util import DATA, V31_ARCHIVE
from tests.torch_port_util import jax_cache_kept, single_torch_thread  # noqa: F401
from vadc_tpu import api as japi
from vadc_tpu.io.pcm import f32_to_s16le, s16le_to_f32
from vadc_tpu_torch import api
from vadc_tpu_torch.runtime import NoCudaDeviceError

pytestmark = pytest.mark.usefixtures("jax_cache_kept")

V31 = str(V31_ARCHIVE)
V4 = str(DATA / "silero_v4_16k.testtensor")
V4_8K = str(DATA / "silero_v4_8k.testtensor")
TOL_PROBS = {"v3": 1e-4, "v4": 1e-4, "v4_8k": 1e-4, "v5": 1e-5, "v5_8k": 1e-5}
TOL_HARMONIC = 1e-3


def _speechlike(duration_s, f0=120.0, sr=16000):
    """tests/test_api.py's speech-like signal."""
    t = np.arange(int(duration_s * sr)) / sr
    sig = np.zeros_like(t)
    for k in range(1, 25):
        f = k * f0
        w = np.exp(-(((f - 500) / 400) ** 2)) + 0.7 * np.exp(-(((f - 1500) / 500) ** 2))
        sig += w * np.sin(2 * np.pi * f * t + k)
    sig *= 0.5 * (1 + np.sin(2 * np.pi * 3.0 * t - np.pi / 2))
    return (0.3 * sig / np.abs(sig).max()).astype(np.float32)


def _material(sr: int = 16000) -> np.ndarray:
    """1 s of noise floor, 2 s of speech, 1 s of noise floor, s16 round
    tripped (the quantization dither keeps the model in distribution)."""
    sil = (np.random.default_rng(0).normal(size=sr) * 0.001).astype(np.float32)
    return s16le_to_f32(f32_to_s16le(np.concatenate([sil, _speechlike(2.0, sr=sr), sil])))


@pytest.fixture(scope="module")
def audio():
    return _material()


@pytest.fixture(scope="module")
def v5_models(tmp_path_factory):
    """The synthetic v5 archives (16 and 8 kHz), written once."""
    from vadc_tpu.io.testtensor import save_testtensor
    from vadc_tpu_torch.models.synthetic import random_v5_8k_archive, random_v5_archive

    root = tmp_path_factory.mktemp("v5")
    paths = {"v5": str(root / "v5.testtensor"), "v5_8k": str(root / "v5_8k.testtensor")}
    save_testtensor(paths["v5"], random_v5_archive(0))
    save_testtensor(paths["v5_8k"], random_v5_8k_archive(1))
    return paths


def test_speech_probabilities_and_segments(audio):
    probs = api.speech_probabilities(audio, model=V31, device="cpu")
    assert probs.dtype == np.float32 and probs.shape[0] == -(-len(audio) // 1536)
    assert probs[:8].max() < 0.3 and probs[12:28].max() > 0.8
    assert_close(probs, japi.speech_probabilities(audio, model=V31), TOL_HARMONIC, "probs")

    segs = api.detect_speech_samples(audio, model=V31, device="cpu")
    assert len(segs) == 1
    start, end = segs[0]
    assert 0.5 < start < 1.6 and 2.6 < end < 3.6, segs
    assert segs == japi.detect_speech_samples(audio, model=V31)


@pytest.mark.parametrize("family", ["v3", "v4", "v4_8k", "v5", "v5_8k"])
def test_speech_probabilities_of_every_family(family, v5_models):
    """Silero v3.1 and v4 (bundled weights) and v5 (synthetic weights), each
    on a speech track at its own rate, against the JAX API: probabilities
    and segments."""
    from vadc_tpu_torch.io.synthaudio import utterance_track

    model = {"v3": V31, "v4": V4, "v4_8k": V4_8K, **v5_models}[family]
    sr = 8000 if family.endswith("_8k") else 16000
    track, _ = utterance_track(4, sr=sr, seed=3)
    track = track.astype(np.float32)
    probs = api.speech_probabilities(track, model=model, device="cpu")
    want = japi.speech_probabilities(track, model=model)
    assert probs.shape == want.shape
    assert_close(probs, want, TOL_PROBS[family], f"{family} probs")
    assert (api.detect_speech_samples(track, model=model, device="cpu")
            == japi.detect_speech_samples(track, model=model))


def test_empty_audio():
    assert api.speech_probabilities(np.zeros(0, np.float32), model=V31, device="cpu").size == 0
    assert api.detect_speech_samples(np.zeros(0, np.float32), model=V31, device="cpu") == []


def test_stream_segments_generator(audio):
    """The generator gives detect_speech_samples' segments, and the JAX
    generator's."""
    pcm = f32_to_s16le(audio)
    segs = list(api.stream_segments(io.BytesIO(pcm), model=V31, device="cpu"))
    want = api.detect_speech_samples(s16le_to_f32(pcm), model=V31, device="cpu")
    assert len(segs) == len(want) == 1
    assert segs[0] == pytest.approx(want[0], abs=1e-6)
    assert segs == list(japi.stream_segments(io.BytesIO(pcm), model=V31))


def test_testtensor_fuzz():
    """The port's parser rejects, and never crashes on, malformed archives,
    as the original does for the same blobs."""
    from vadc_tpu.io import testtensor as jtt
    from vadc_tpu_torch.io import testtensor as ttt

    good = ttt.save_testtensor_bytes({"a": np.ones((2, 3), np.float32)})
    rng = np.random.default_rng(0)
    for _ in range(200):
        blob = bytearray(good)
        for _ in range(rng.integers(1, 6)):
            blob[rng.integers(0, len(blob))] = rng.integers(0, 256)
        outcome = []
        for mod in (jtt, ttt):
            try:
                outcome.append(sorted(mod.load_testtensor_bytes(bytes(blob))))
            except (ValueError, UnicodeDecodeError, struct.error) as e:
                outcome.append(type(e).__name__)
        assert outcome[0] == outcome[1]


@pytest.mark.parametrize("precision", ["fast"])
def test_bf16_tier_bounded_deviation(precision):
    """A bf16 tier through the API: within the family's SPEECH_BOUND of
    faithful on a speech track with its aspiration floor, with the same
    segments (tests/test_torch_tiers.py's track)."""
    from vadc_tpu_torch.io.synthaudio import utterance_track
    from vadc_tpu_torch.kernels.tier_check import SPEECH_BOUND

    track, _ = utterance_track(4, seed=7)
    track = track.astype(np.float32)
    faithful = api.speech_probabilities(track, model=V31, device="cpu")
    tier = api.speech_probabilities(track, model=V31, device="cpu", precision=precision)
    dev = float(np.abs(tier - faithful).max())
    assert 0 < dev <= SPEECH_BOUND["v3"][precision], dev
    assert (api.detect_speech_samples(track, model=V31, device="cpu", precision=precision)
            == api.detect_speech_samples(track, model=V31, device="cpu"))


def _write_wav(path, audio: np.ndarray, rate: int) -> None:
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes(f32_to_s16le(audio))


@pytest.mark.parametrize("rate", [16000, 44100])
def test_detect_speech_wav_file(rate, tmp_path):
    """detect_speech on a .wav path goes through the native decoder (and
    its resampler at 44.1 kHz): the JAX API's segments."""
    sil = (np.random.default_rng(0).normal(size=rate) * 0.001).astype(np.float32)
    path = tmp_path / "speech.wav"
    _write_wav(path, np.concatenate([sil, _speechlike(2.0, sr=rate), sil]), rate)
    segs = api.detect_speech(path, model=V31, device="cpu")
    assert len(segs) == 1
    start, end = segs[0]
    assert 0.5 < start < 1.6 and 2.6 < end < 3.6, segs
    assert segs == japi.detect_speech(path, model=V31)


def test_cut_speech_samples(audio):
    kept = api.cut_speech_samples(audio, model=V31, device="cpu")
    assert 1.8 * 16000 < len(kept) < 2.7 * 16000
    np.testing.assert_array_equal(kept, japi.cut_speech_samples(audio, model=V31))
    assert api.cut_speech_samples(np.zeros(32000, np.float32), model=V31, device="cpu").size == 0


def test_cut_speech_samples_slices_at_model_rate():
    """8 kHz families: segment times are true seconds, so the slicer uses
    the model's rate (8000)."""
    audio = np.concatenate([
        (np.random.default_rng(0).normal(size=8000) * 0.001).astype(np.float32),
        _speechlike(2.0, sr=8000),
        (np.random.default_rng(0).normal(size=8000) * 0.001).astype(np.float32)])
    kept = api.cut_speech_samples(audio, model=V4_8K, device="cpu")
    assert 1.7 * 8000 < len(kept) < 2.9 * 8000, len(kept)
    np.testing.assert_array_equal(kept, japi.cut_speech_samples(audio, model=V4_8K))


def test_stream_segments_8k_time_base():
    """8 kHz families: the generator's clock runs on the model's rate; it
    agrees with detect_speech_samples and with the JAX generator."""
    pcm = f32_to_s16le(_material(8000))
    segs = list(api.stream_segments(io.BytesIO(pcm), model=V4_8K, device="cpu"))
    want = api.detect_speech_samples(s16le_to_f32(pcm), model=V4_8K, device="cpu")
    assert len(segs) == len(want) == 1
    assert segs[0] == pytest.approx(want[0], abs=1e-6)
    start, end = segs[0]
    assert 0.5 < start < 1.6 and 2.4 < end < 3.7, segs
    assert segs == list(japi.stream_segments(io.BytesIO(pcm), model=V4_8K))


@pytest.mark.parametrize("helper", ["speech_probabilities", "detect_speech_samples",
                                    "stream_segments", "cut_speech_samples", "detect_speech"])
def test_every_helper_needs_a_card_by_default(helper, monkeypatch, tmp_path):
    """device defaults to cuda: without a card each helper raises
    NoCudaDeviceError (it never runs on the CPU instead)."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    audio = np.zeros(16000, np.float32)
    wav = tmp_path / "x.wav"
    _write_wav(wav, audio, 16000)
    call = {"speech_probabilities": lambda: api.speech_probabilities(audio, model=V31),
            "detect_speech_samples": lambda: api.detect_speech_samples(audio, model=V31),
            "stream_segments": lambda: api.stream_segments(io.BytesIO(b"\0\0" * 1536), model=V31),
            "cut_speech_samples": lambda: api.cut_speech_samples(audio, model=V31),
            "detect_speech": lambda: api.detect_speech(wav, model=V31)}[helper]
    with pytest.raises(NoCudaDeviceError, match="--device cpu"):
        call()


def test_runner_cache_is_keyed_by_path_chunk_tier_and_device():
    a = api._get_runner(V31, 1536, "faithful", "cpu")
    assert api._get_runner(V31, 1536, "faithful", "cpu") is a
    b = api._get_runner(V31, 1024, "faithful", "cpu")
    c = api._get_runner(V31, 1536, "fast", "cpu")
    assert b is not a and b[1] == 1024 and c is not a and c[0].precision == "fast"
    assert a[0].device.type == "cpu"
    with pytest.raises(FileNotFoundError, match="no weight archive"):
        api._get_runner("/nonexistent/w.testtensor", 1536, "faithful", "cpu")
