"""The port's profiling zones and traces (vadc_tpu_torch/tracing.py) on the
CPU: the JAX package's zone names on the plain v3.1 path, the kernels'
names around them, a Chrome trace written where VADC_TPU_PROFILE or the
argument says, and nothing at all without a profile."""

import json
import re

import numpy as np
import pytest
import torch

from tests.torch_port_util import jax_and_port_params
from tests.torch_port_util import single_torch_thread  # noqa: F401
from vadc_tpu_torch import tracing
from vadc_tpu_torch.engine.runner import StreamRunner

PLAIN_ZONES = {"stft", "adaptive_norm", "encoder_layer_1", "encoder_layer_2", "encoder_layer_3",
               "encoder_layer_4", "lstm", "decoder"}


@pytest.fixture(scope="module")
def params():
    return jax_and_port_params()[1]


def _names(outdir) -> set[str]:
    (trace,) = list(outdir.glob("vadc_trace_*.json"))
    return {e.get("name") for e in json.loads(trace.read_text())["traceEvents"]}


def _chunks(shape) -> np.ndarray:
    return (0.1 * np.random.default_rng(0).normal(size=shape)).astype(np.float32)


def test_zone_outside_a_profile_is_the_shared_null_context():
    first, second = tracing.zone("stft"), tracing.zone("decoder")
    assert first is second
    with first:
        pass
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        assert tracing.zone("stft") is not first


def test_step_on_the_plain_path_records_the_jax_zones(params, tmp_path):
    """A v3.1 step on the CPU: the kernel's name (forward_fused) around its
    plain version's stages, which carry the JAX package's zone names."""
    runner = StreamRunner("v3", params, device="cpu")
    state = runner.init_state(2)
    with tracing.profile(str(tmp_path)):
        runner.step(_chunks((2, 1536)), state)
    names = _names(tmp_path)
    assert PLAIN_ZONES | {"forward_fused"} <= names, sorted(n for n in names if n)


def test_scan_records_the_slab_kernels_names(params, tmp_path):
    runner = StreamRunner("v3", params, device="cpu")
    with tracing.profile(str(tmp_path)):
        runner.scan(_chunks((2, 2, 1536)), runner.init_state(2))
    names = _names(tmp_path)
    assert {"encode_fused_audio", "lstm_decoder_fused", "stft", "encoder_layer_4"} <= names


def test_plain_model_path_records_the_jax_zones(params, tmp_path):
    from vadc_tpu_torch.models import silero_v31

    h, c = silero_v31.init_state(2)
    with tracing.profile(str(tmp_path)):
        silero_v31.forward_reference(params, torch.from_numpy(_chunks((2, 1536))), h, c)
    assert PLAIN_ZONES <= _names(tmp_path)


def test_profile_reads_the_variable(params, tmp_path, monkeypatch):
    monkeypatch.setenv("VADC_TPU_PROFILE", str(tmp_path / "env"))
    runner = StreamRunner("v3", params, device="cpu")
    with tracing.profile():
        runner.step(_chunks((1, 1536)), runner.init_state(1))
    (trace,) = list((tmp_path / "env").iterdir())
    assert re.fullmatch(r"vadc_trace_\d+_\d+\.json", trace.name)
    assert "forward_fused" in _names(tmp_path / "env")


def test_profile_without_the_variable_is_a_noop(params, tmp_path, monkeypatch):
    monkeypatch.delenv("VADC_TPU_PROFILE", raising=False)
    monkeypatch.chdir(tmp_path)
    null = tracing.zone("stft")
    runner = StreamRunner("v3", params, device="cpu")
    state = runner.init_state(1)
    with tracing.profile():
        assert not torch.autograd._profiler_enabled()
        assert tracing.zone("lstm") is null
        runner.step(_chunks((1, 1536)), state)
    assert not list(tmp_path.iterdir())
