"""Fused v4/v5 .onnx graphs in the port: weight extraction at the sample rate
asked for (`models.weights.load_params(..., sample_rate)`), the CLI's --sr
and --onnx_exec, and its fallback to the graph executor when extraction
fails (on the CPU only; on a CUDA device the same failure exits 1).

A complete fused v5 graph (both sample-rate branches) is built inside the
repository by vadc_tpu/export/onnx_build.py from the synthetic v5
archives; the JAX package loads and executes the same file. No v4 .onnx is
in the repository, so the v4 case skips until one is added under
vadc_tpu/data. Extraction and the executor are numpy in both packages:
arrays and printed lines are required equal."""

import io
import sys

import numpy as np
import pytest
import torch

from tests.torch_port_util import DATA, single_torch_thread  # noqa: F401
from vadc_tpu.cli import main as jax_cli
from vadc_tpu.export.onnx_build import build_silero_v5_onnx
from vadc_tpu.models import weights as JW
from vadc_tpu.models.synthetic import random_v5_8k_archive, random_v5_archive
from vadc_tpu_torch.cli import main as port_cli
from vadc_tpu_torch.models import weights as TW

V4_ONNX = DATA / "silero_vad_v4.onnx"


@pytest.fixture(scope="module")
def v5_onnx(tmp_path_factory):
    path = tmp_path_factory.mktemp("onnx") / "silero_v5_synthetic.onnx"
    build_silero_v5_onnx(path, random_v5_archive(0), random_v5_8k_archive(1))
    return path


def _leaves(tree, prefix=""):
    """(path, numpy array) of every leaf of a param tree (dicts, lists,
    tensors or arrays), in a fixed order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}.{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}[{i}]")
    else:
        yield prefix, np.asarray(tree.numpy() if isinstance(tree, torch.Tensor) else tree)


@pytest.mark.parametrize("sample_rate,family", [(16000, "v5"), (8000, "v5_8k")])
def test_v5_graph_loads_at_each_rate_with_the_jax_packages_arrays(v5_onnx, sample_rate, family):
    got_family, tp = TW.load_params(v5_onnx, sample_rate=sample_rate)
    want_family, jp = JW.load_params(v5_onnx, sample_rate=sample_rate)
    assert got_family == want_family == family
    got, want = list(_leaves(tp)), list(_leaves(jp))
    assert [k for k, _ in got] == [k for k, _ in want] and len(got) > 10
    for (k, a), (_, b) in zip(got, want):
        assert a.shape == b.shape and np.array_equal(a, b.astype(a.dtype)), k


def test_v4_graph_loads_at_each_rate_with_the_jax_packages_arrays():
    if not V4_ONNX.exists():
        pytest.skip(f"no v4 .onnx in the repository ({V4_ONNX.name} under vadc_tpu/data)")
    for sample_rate, family in ((16000, "v4"), (8000, "v4_8k")):
        got_family, tp = TW.load_params(V4_ONNX, sample_rate=sample_rate)
        want_family, jp = JW.load_params(V4_ONNX, sample_rate=sample_rate)
        assert got_family == want_family == family
        for (k, a), (_, b) in zip(_leaves(tp), _leaves(jp)):
            assert np.array_equal(a, b.astype(a.dtype)), k


def _run(cli, argv, stdin_bytes, capsys, monkeypatch):
    monkeypatch.setattr(sys, "stdin", io.TextIOWrapper(io.BytesIO(stdin_bytes)))
    rc = cli.main(argv)
    out, err = capsys.readouterr()
    return rc, out, err


def _pcm(seconds: float, sample_rate: int, seed: int = 0) -> bytes:
    """Noise with a louder tonal middle third, as s16le."""
    rng = np.random.default_rng(seed)
    n = int(seconds * sample_rate)
    x = 0.01 * rng.normal(size=n)
    t = np.arange(n // 3) / sample_rate
    x[n // 3 : n // 3 + t.size] += 0.3 * np.sin(2 * np.pi * 220 * t) * np.sin(2 * np.pi * 3 * t)
    return np.clip(x * 32767, -32768, 32767).astype("<i2").tobytes()


@pytest.mark.parametrize("sample_rate", [16000, 8000])
def test_onnx_exec_prints_the_jax_clis_lines(v5_onnx, sample_rate, capsys, monkeypatch):
    pcm = _pcm(1.0, sample_rate)
    argv = ["--model", str(v5_onnx), "--onnx_exec", "--sr", str(sample_rate), "--raw_probabilities"]
    rc_j, out_j, _ = _run(jax_cli, argv, pcm, capsys, monkeypatch)
    rc_t, out_t, err_t = _run(port_cli, [*argv, "--device", "cpu"], pcm, capsys, monkeypatch)
    assert rc_j == rc_t == 0
    assert out_t == out_j and len(out_t.splitlines()) >= 25
    assert "graph introspection: " in err_t and "on the host" in err_t
    # extraction then the port's own forward give close probabilities
    rc_x, out_x, _ = _run(port_cli, ["--model", str(v5_onnx), "--sr", str(sample_rate),
                                     "--raw_probabilities", "--device", "cpu"],
                          pcm, capsys, monkeypatch)
    assert rc_x == 0
    a = np.array(out_x.split(), np.float64)
    b = np.array(out_t.split(), np.float64)
    assert a.shape == b.shape and np.abs(a - b).max() < 1e-5


def test_sr_is_ignored_for_an_archive_of_the_other_rate(capsys, monkeypatch):
    rc, out, err = _run(port_cli, ["--device", "cpu", "--sr", "8000"], _pcm(0.5, 16000),
                        capsys, monkeypatch)
    assert rc == 0
    assert "note: --sr 8000 ignored" in err and "16000 Hz model" in err


def test_onnx_exec_needs_an_onnx_model(capsys, monkeypatch):
    rc, out, err = _run(port_cli, ["--device", "cpu", "--onnx_exec"], b"", capsys, monkeypatch)
    assert rc == 1 and out == "" and "--onnx_exec requires --model" in err


@pytest.fixture
def extraction_fails(monkeypatch):
    """The v5 extractor raising, as it does for a re-exported graph whose
    tensors deviate from the official layout."""
    from vadc_tpu_torch.export import silero_v5_from_onnx

    def fail(path, sample_rate=16000):
        raise ValueError("unrecognized weight archive layout")

    monkeypatch.setattr(silero_v5_from_onnx, "extract_silero_v5", fail)


def test_extraction_failure_falls_back_to_the_executor_on_the_cpu(
        v5_onnx, extraction_fails, capsys, monkeypatch):
    pcm = _pcm(0.5, 16000)
    rc, out, err = _run(port_cli, ["--model", str(v5_onnx), "--raw_probabilities",
                                   "--device", "cpu"], pcm, capsys, monkeypatch)
    assert rc == 0 and "falling back to the numpy graph executor" in err
    rc, want, _ = _run(port_cli, ["--model", str(v5_onnx), "--onnx_exec", "--raw_probabilities",
                                  "--device", "cpu"], pcm, capsys, monkeypatch)
    assert rc == 0 and out == want and out


def test_extraction_failure_exits_1_on_a_cuda_device(
        v5_onnx, extraction_fails, capsys, monkeypatch):
    """With the card asked for, the failure is an error naming the
    extraction error and --onnx_exec: the executor would run on the host."""
    from vadc_tpu_torch import runtime

    monkeypatch.setattr(runtime, "resolve_device", lambda device: torch.device("cuda"))
    rc, out, err = _run(port_cli, ["--model", str(v5_onnx)], _pcm(0.5, 16000), capsys, monkeypatch)
    assert rc == 1 and out == ""
    lines = err.strip().splitlines()
    assert len(lines) == 1 and lines[0].startswith("Error: weight extraction failed")
    assert "unrecognized weight archive layout" in lines[0] and "--onnx_exec" in lines[0]
