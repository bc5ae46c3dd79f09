"""The port's vadc CLI (`vadc_tpu_torch.cli.main`, --device cpu) against
vadc_tpu's on the same input: the verify recipe's synthetic file (two
voiced spans in near-silence, 12 s), as raw s16le on stdin and as a wav
file, in segment mode and with --raw_probabilities.

Segment lines must be identical. Raw probabilities agree to 1e-3, the
README's full-model bound: this file's voiced spans are pure harmonic
stacks, whose inter-harmonic STFT bins cancel to the fp32 rounding floor,
where the adaptive normalization's log1p(2^20 x) magnifies each package's
own rounding (see tests/test_torch_model.py). Measured on the CPU: 1.9e-4.
The port on the card against the port on the CPU, on the same file, is
held to 1e-4 by chip_smoke.py.

The other families on the same file: v4 (official weights) prints the JAX
CLI's segments, `1.99,5.21` and `6.98,10.21`, and v4_8k, given the file
as a 16 kHz .wav that both packages resample to 8 kHz natively, prints
the JAX CLI's segments too. v5 and v5_8k (synthetic weights, written to a
.testtensor) print raw probabilities within 1e-4 of the JAX CLI's
(measured 2e-6, at the six decimals the CLI prints: v5 has no log1p in
its front-end).
"""

import io
import sys
import wave

import numpy as np
import pytest
import torch

import jax

from tests.conftest import assert_close
from tests.torch_port_util import DATA, single_torch_thread  # noqa: F401
from vadc_tpu.cli import main as jax_cli
from vadc_tpu_torch.cli import main as port_cli

SR = 16000
TOL_PROBS = 1e-3
TOL_V5 = 1e-4
# jax settings the JAX CLI's compile-cache setup overwrites in-process
_JAX_CACHE_SETTINGS = (
    "jax_compilation_cache_dir",
    "jax_persistent_cache_min_compile_time_secs",
    "jax_persistent_cache_min_entry_size_bytes",
)


def _voiced(dur: float, f0: float = 120.0) -> np.ndarray:
    t = np.arange(int(dur * SR)) / SR
    sig = np.zeros_like(t)
    for k in range(1, 25):
        f = k * f0
        w = (np.exp(-(((f - 500) / 400) ** 2)) + 0.7 * np.exp(-(((f - 1500) / 500) ** 2))
             + 0.3 * np.exp(-(((f - 2500) / 700) ** 2)))
        sig += w * np.sin(2 * np.pi * f * t + k)
    sig *= 0.5 * (1 + np.sin(2 * np.pi * 3.0 * t - np.pi / 2))
    return 0.3 * sig / np.abs(sig).max()


def _silence(dur: float) -> np.ndarray:
    return 0.001 * np.random.default_rng(1).normal(size=int(dur * SR))


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    audio = np.concatenate([_silence(2), _voiced(3), _silence(2), _voiced(3, 180), _silence(2)])
    pcm = np.clip(audio * 32768, -32768, 32767).astype("<i2").tobytes()
    wav_path = tmp_path_factory.mktemp("cli") / "synthetic.wav"
    with wave.open(str(wav_path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(SR)
        w.writeframes(pcm)
    return pcm, wav_path


def _run(cli, argv, stdin: bytes, capsys, monkeypatch) -> tuple[int, str, str]:
    monkeypatch.setattr(sys, "stdin", io.TextIOWrapper(io.BytesIO(stdin)))
    capsys.readouterr()
    rc = cli.main(argv)
    out, err = capsys.readouterr()
    return rc, out, err


@pytest.fixture(scope="module")
def restore_jax_cache_settings():
    """The JAX CLI points jax's compile cache at VADC_TPU_CACHE_DIR (else a
    directory under HOME): keep it on the suite's own cache, and put the
    settings back afterwards."""
    saved = {name: getattr(jax.config, name) for name in _JAX_CACHE_SETTINGS}
    with pytest.MonkeyPatch.context() as mp:
        if saved["jax_compilation_cache_dir"]:
            mp.setenv("VADC_TPU_CACHE_DIR", saved["jax_compilation_cache_dir"])
        yield
    for name, value in saved.items():
        jax.config.update(name, value)


@pytest.mark.parametrize("source", ["s16le", "wav"])
@pytest.mark.parametrize("mode", ["segments", "raw"])
def test_cli_stdout_matches_jax(inputs, source, mode, capsys, monkeypatch,
                                restore_jax_cache_settings):
    pcm, wav_path = inputs
    argv = [str(wav_path)] if source == "wav" else []
    if mode == "raw":
        argv.append("--raw_probabilities")
    stdin = b"" if source == "wav" else pcm
    rc_j, out_j, err_j = _run(jax_cli, argv, stdin, capsys, monkeypatch)
    rc_t, out_t, err_t = _run(port_cli, argv + ["--device", "cpu"], stdin, capsys, monkeypatch)
    assert rc_j == 0, err_j
    assert rc_t == 0, err_t
    if mode == "segments":
        assert out_t == out_j
        assert len(out_t.split()) == 2, out_t  # the two voiced spans
    else:
        p_t = np.array([float(v) for v in out_t.split()])
        p_j = np.array([float(v) for v in out_j.split()])
        assert p_t.shape == p_j.shape == (12 * SR // 1536,)
        assert_close(p_t, p_j, TOL_PROBS, f"{source} raw probabilities")


@pytest.mark.parametrize("family,source", [("v4", "s16le"), ("v4", "wav"), ("v4_8k", "wav")])
def test_v4_cli_prints_the_jax_segments(inputs, family, source, capsys, monkeypatch,
                                        restore_jax_cache_settings):
    pcm, wav_path = inputs
    archive = DATA / ("silero_v4_16k.testtensor" if family == "v4" else "silero_v4_8k.testtensor")
    argv = ["--model", str(archive)] + ([str(wav_path)] if source == "wav" else [])
    stdin = b"" if source == "wav" else pcm
    rc_j, out_j, err_j = _run(jax_cli, argv, stdin, capsys, monkeypatch)
    rc_t, out_t, err_t = _run(port_cli, argv + ["--device", "cpu"], stdin, capsys, monkeypatch)
    assert rc_j == 0, err_j
    assert rc_t == 0, err_t
    assert out_t == out_j
    if family == "v4":
        assert out_t == "1.99,5.21\n6.98,10.21\n"
    else:
        assert "-> 8000 Hz mono" in err_t and len(out_t.split()) == 2, (out_t, err_t)


@pytest.mark.parametrize("family,source", [("v5", "s16le"), ("v5_8k", "wav")])
def test_v5_cli_raw_probabilities_match_jax(inputs, tmp_path, family, source, capsys,
                                            monkeypatch, restore_jax_cache_settings):
    from vadc_tpu.io.testtensor import save_testtensor
    from vadc_tpu_torch.models.synthetic import random_v5_8k_archive, random_v5_archive

    pcm, wav_path = inputs
    archive = tmp_path / f"{family}.testtensor"
    save_testtensor(archive, random_v5_archive(0) if family == "v5" else random_v5_8k_archive(1))
    argv = ["--model", str(archive), "--raw_probabilities"]
    argv += [str(wav_path)] if source == "wav" else []
    stdin = b"" if source == "wav" else pcm
    rc_j, out_j, err_j = _run(jax_cli, argv, stdin, capsys, monkeypatch)
    rc_t, out_t, err_t = _run(port_cli, argv + ["--device", "cpu"], stdin, capsys, monkeypatch)
    assert rc_j == 0, err_j
    assert rc_t == 0, err_t
    assert ("Model arch is Silero v5" in err_t) == (family == "v5")
    p_t = np.array([float(v) for v in out_t.split()])
    p_j = np.array([float(v) for v in out_j.split()])
    chunk, rate = (512, SR) if family == "v5" else (256, SR // 2)
    assert p_t.shape == p_j.shape == (12 * rate // chunk,)
    assert_close(p_t, p_j, TOL_V5, f"{family} raw probabilities")


def test_empty_stdin_exits_0_with_no_output(capsys, monkeypatch):
    rc, out, _ = _run(port_cli, ["--device", "cpu"], b"", capsys, monkeypatch)
    assert rc == 0 and out == ""


def test_no_card_is_an_error_not_a_cpu_run(capsys, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; the no-card error cannot show")
    rc, out, err = _run(port_cli, [], b"\0\0" * 1536, capsys, monkeypatch)
    assert rc == 1 and out == ""
    lines = err.strip().splitlines()
    assert len(lines) == 1 and lines[0].startswith("Error: no CUDA device"), err


def test_unported_tier_is_an_error(capsys, monkeypatch):
    """A bf16 tier runs Silero v3.1 (the default model); the v4 model
    refuses it in one line naming the ROADMAP item."""
    rc, out, err = _run(port_cli, ["--device", "cpu", "--precision", "fast"], b"",
                        capsys, monkeypatch)
    assert rc == 0 and out == ""
    rc, out, err = _run(port_cli, ["--device", "cpu", "--precision", "fast", "--model",
                                   str(DATA / "silero_v4_16k.testtensor")], b"",
                        capsys, monkeypatch)
    assert rc == 1 and out == "" and "ROADMAP" in err and "'bf16 tiers: v4 and v5'" in err


@pytest.mark.parametrize("tier", ["balanced", "fast", "turbo"])
def test_bf16_tiers_print_the_faithful_segments(capsys, monkeypatch, tier):
    """Each tier on synthetic speech with its aspiration floor
    (vadc_tpu/io/synthaudio.py; tests/test_torch_tiers.py says why this
    track): the faithful tier's segment lines; --raw_probabilities at fast
    and turbo says on stderr that probabilities deviate from fp32. (On the
    pure harmonics of `inputs`, which have no noise floor, turbo's bf16
    STFT moves a borderline chunk, as the JAX package's does.)"""
    from vadc_tpu.io.synthaudio import utterance_track

    track, _ = utterance_track(4, seed=7)
    pcm = np.clip(track * 32768, -32768, 32767).astype("<i2").tobytes()
    rc, want, _ = _run(port_cli, ["--device", "cpu"], pcm, capsys, monkeypatch)
    rc_t, got, err = _run(port_cli, ["--device", "cpu", "--precision", tier], pcm, capsys,
                          monkeypatch)
    assert rc == rc_t == 0 and got == want and want.count("\n") >= 3
    rc, raw, err = _run(port_cli, ["--device", "cpu", "--precision", tier, "--raw_probabilities"],
                        pcm[: 2 * 1536 * 10], capsys, monkeypatch)
    assert rc == 0 and len(raw.split()) == 10
    assert ("note: --raw_probabilities at --precision" in err) == (tier != "balanced")
