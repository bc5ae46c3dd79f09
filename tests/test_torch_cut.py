"""The port's native silence cutter (vadc_tpu_torch/cli/cut.py, script
vadc-torch-cut, `--device cpu`) against the JAX package's
(`python -m vadc_tpu.cli.cut`, called in-process) on the same inputs.

The seven cases of tests/test_cut.py. Output files are required equal byte
for byte (the kept samples are slices of the input at the segments, and
the segments are identical), and every one-line error is the JAX tool's
line. Without a card, `--device cuda` (the default) exits 1 with a one-line
error and writes nothing.
"""

import numpy as np
import pytest

from tests.torch_port_util import V31_ARCHIVE, DATA
from tests.torch_port_util import jax_cache_kept, single_torch_thread  # noqa: F401
from vadc_tpu.cli import cut as jcut
from vadc_tpu.io.pcm import f32_to_s16le
from vadc_tpu_torch.cli import cut
from vadc_tpu_torch.io.wav import WavSource, write_wav

pytestmark = pytest.mark.usefixtures("jax_cache_kept")

MODEL = ["--model", str(V31_ARCHIVE)]


def _speechlike(duration_s, f0=120.0, sr=16000):
    """tests/test_cut.py's speech-like signal."""
    t = np.arange(int(duration_s * sr)) / sr
    sig = np.zeros_like(t)
    for k in range(1, 25):
        f = k * f0
        w = np.exp(-(((f - 500) / 400) ** 2)) + 0.7 * np.exp(-(((f - 1500) / 500) ** 2))
        sig += w * np.sin(2 * np.pi * f * t + k)
    sig *= 0.5 * (1 + np.sin(2 * np.pi * 3.0 * t - np.pi / 2))
    return (0.3 * sig / np.abs(sig).max()).astype(np.float32)


def _sil(d, sr=16000):
    return (np.random.default_rng(1).normal(size=int(d * sr)) * 0.001).astype(np.float32)


@pytest.fixture(scope="module")
def material():
    return np.concatenate([_sil(1), _speechlike(2), _sil(1)])


def _both(argv_of, capsys):
    """Run the JAX tool and the port's on the argv `argv_of(tag)` gives
    (tag "jax" or "port"); returns ((rc, stderr) of JAX, of the port)."""
    out = []
    for tag, main, extra in (("jax", jcut.main, []), ("port", cut.main, ["--device", "cpu"])):
        rc = main([*argv_of(tag), *extra])
        out.append((rc, capsys.readouterr().err))
    return out


def test_cut_wav_to_wav(tmp_path, capsys, material):
    src = tmp_path / "in.wav"
    write_wav(src, (material * 32767).astype("<i2"))
    (rc_j, err_j), (rc, err) = _both(
        lambda tag: [str(src), str(tmp_path / f"{tag}.wav"), "--stats", *MODEL], capsys)
    assert rc == rc_j == 0
    assert "kept" in err and "1 segment(s)" in err and err == err_j
    out = (tmp_path / "port.wav").read_bytes()
    assert out == (tmp_path / "jax.wav").read_bytes()
    with WavSource(str(tmp_path / "port.wav")) as s:
        kept = np.frombuffer(s.read(-1), "<i2")
    # speech spans [1, 3] s; the FSM pads +-30 ms and quantizes to 96 ms
    # chunks, so the kept span is ~2 s with up to 2 chunks of slack a side
    assert 1.8 * 16000 < len(kept) < 2.7 * 16000
    # the kept audio is the loud part (the silence floor's mean is ~26)
    assert np.abs(kept.astype(np.float32)).mean() > 200


def test_cut_raw_to_raw(tmp_path, capsys, material):
    src = tmp_path / "in.s16le"
    src.write_bytes(f32_to_s16le(material))
    (rc_j, _), (rc, _) = _both(lambda tag: [str(src), str(tmp_path / f"{tag}.s16le"), *MODEL],
                               capsys)
    assert rc == rc_j == 0
    out = (tmp_path / "port.s16le").read_bytes()
    assert out == (tmp_path / "jax.s16le").read_bytes()
    assert 1.8 * 16000 < len(out) // 2 < 2.7 * 16000


def test_cut_silence_only_produces_empty_output(tmp_path, capsys):
    src = tmp_path / "sil.wav"
    write_wav(src, (_sil(3) * 32767).astype("<i2"))
    (rc_j, err_j), (rc, err) = _both(
        lambda tag: [str(src), str(tmp_path / f"{tag}.wav"), "--stats", *MODEL], capsys)
    assert rc == rc_j == 0 and "0 segment(s)" in err and err == err_j
    assert (tmp_path / "port.wav").read_bytes() == (tmp_path / "jax.wav").read_bytes()
    with WavSource(str(tmp_path / "port.wav")) as s:
        assert s.read(-1) == b""


def test_cut_missing_input_one_line_error(tmp_path, capsys):
    (rc_j, err_j), (rc, err) = _both(
        lambda tag: [str(tmp_path / "nope.wav"), str(tmp_path / f"{tag}.wav"), *MODEL], capsys)
    assert rc == rc_j == 1
    assert "BS_Error_CantOpenFile" in err and err.count("\n") == 1
    assert err == err_j


def test_write_wav_roundtrip(tmp_path):
    """The port's write_wav writes the JAX package's bytes and reads back."""
    from vadc_tpu.io.wav import write_wav as jwrite

    samples = np.arange(-100, 100, dtype="<i2")
    write_wav(tmp_path / "rt.wav", samples, sample_rate=8000)
    jwrite(tmp_path / "jax.wav", samples, sample_rate=8000)
    assert (tmp_path / "rt.wav").read_bytes() == (tmp_path / "jax.wav").read_bytes()
    with WavSource(str(tmp_path / "rt.wav"), target_rate=8000) as s:
        assert s.format.sample_rate == 8000
        assert np.array_equal(np.frombuffer(s.read(-1), "<i2"), samples)


def test_cut_malformed_wav_one_line_error(tmp_path, capsys):
    bad = tmp_path / "bad.wav"
    bad.write_bytes(b"RIFF\x10\x00\x00\x00WAVEjunk")
    (rc_j, err_j), (rc, err) = _both(
        lambda tag: [str(bad), str(tmp_path / f"{tag}.wav"), *MODEL], capsys)
    assert rc == rc_j == 1
    assert "BS_Error_CantOpenFile" in err and err.count("\n") == 1 and err == err_j


def test_cut_unwritable_output_fails_fast(tmp_path, capsys):
    src = tmp_path / "in.wav"
    write_wav(src, np.zeros(1600, "<i2"))
    (rc_j, err_j), (rc, err) = _both(
        lambda tag: [str(src), str(tmp_path / "no" / tag / "out.wav"), *MODEL], capsys)
    assert rc == rc_j == 1
    assert "cannot write output" in err and err.count("\n") == 1


def test_cut_8k_model_on_a_44k_wav(tmp_path, capsys):
    """The 8 kHz v4 model decodes a 44.1 kHz wav to its own rate and cuts
    at 8 kHz: the JAX tool's bytes."""
    audio = np.concatenate([_sil(1, 44100), _speechlike(2, sr=44100), _sil(1, 44100)])
    src = tmp_path / "in.wav"
    write_wav(src, (audio * 32767).astype("<i2"), sample_rate=44100)
    model = ["--model", str(DATA / "silero_v4_8k.testtensor")]
    (rc_j, _), (rc, _) = _both(
        lambda tag: [str(src), str(tmp_path / f"{tag}.s16le"), *model], capsys)
    assert rc == rc_j == 0
    out = (tmp_path / "port.s16le").read_bytes()
    assert out == (tmp_path / "jax.s16le").read_bytes() and len(out) > 1.5 * 8000 * 2


def test_cut_without_a_card_exits_1(tmp_path, capsys, monkeypatch):
    """--device defaults to cuda: without a card, one `Error:` line, exit 1,
    and no output file."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    src = tmp_path / "in.wav"
    write_wav(src, np.zeros(1600, "<i2"))
    assert cut.main([str(src), str(tmp_path / "out.wav"), *MODEL]) == 1
    err = capsys.readouterr().err
    assert err.startswith("Error: ") and "no CUDA device" in err and err.count("\n") == 1
    assert not (tmp_path / "out.wav").exists()
