"""The port's spans, counters and traces (vadc_tpu_torch/tracing.py) on the
CPU: the JAX package's zone names on the plain v3.1 path, the kernels'
names around them, a Chrome trace and its counters written where
VADC_TPU_PROFILE or the argument says, and nothing at all with the recorder
off; inside `record()` the spans' parents and jobs, the bounded buffer, and
the batch CLI's span tree and read counter, its lines the same on and off."""

import io
import json
import re
import threading
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from tests.torch_port_util import V31_ARCHIVE, jax_and_port_params, speech
from tests.torch_port_util import single_torch_thread  # noqa: F401
from vadc_tpu_torch import tracing
from vadc_tpu_torch.engine.runner import StreamRunner

PLAIN_ZONES = {"stft", "adaptive_norm", "encoder_layer_1", "encoder_layer_2", "encoder_layer_3",
               "encoder_layer_4", "lstm", "decoder"}
#: the batch CLI's spans: name -> the name of its parent
BATCH_TREE = {"batch.open": "batch.job", "batch.pin": "batch.job", "batch.read": "batch.job",
              "batch.grid": "batch.job", "batch.slab": "batch.job", "segmenter.feed": "batch.job",
              "segmenter.finish": "batch.job", "batch.output": "batch.job"}


@pytest.fixture(scope="module")
def params():
    return jax_and_port_params()[1]


@pytest.fixture(autouse=True)
def empty_recorder():
    tracing.clear()
    yield
    tracing.clear()


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


def test_off_the_recorder_records_nothing(params):
    runner = StreamRunner("v3", params, device="cpu")
    null = tracing.zone("batch.job", job=True)
    assert null is tracing.zone("other")
    with null:
        tracing.count("batch.read_bytes", 10)
        runner.scan(_chunks((2, 2, 1536)), runner.init_state(2))
    assert tracing.spans() == [] and tracing.counters() == {}


def _step(params):
    runner = StreamRunner("v3", params, device="cpu")
    runner.step(_chunks((2, 1536)), runner.init_state(2))


def _scan(params):
    runner = StreamRunner("v3", params, device="cpu")
    runner.scan(_chunks((2, 2, 1536)), runner.init_state(2))


def _plain_model(params):
    from vadc_tpu_torch.models import silero_v31

    h, c = silero_v31.init_state(2)
    silero_v31.forward_reference(params, torch.from_numpy(_chunks((2, 1536))), h, c)


@pytest.mark.parametrize("path,want", [
    # a v3.1 step on the CPU: the kernel's name (forward_fused) around its
    # plain version's stages, which carry the JAX package's zone names
    (_step, PLAIN_ZONES | {"forward_fused"}),
    (_scan, {"encode_fused_audio", "lstm_decoder_fused", "stft", "encoder_layer_4"}),
    (_plain_model, PLAIN_ZONES),
], ids=["step_on_the_plain_path", "scan_the_slab_kernels", "plain_model_path"])
def test_the_trace_names_the_zones(params, tmp_path, path, want):
    with tracing.profile(str(tmp_path)):
        path(params)
    names = _names(tmp_path)
    assert want <= names, sorted(n for n in names if n)
    # the profiler turned the recorder on: the same names as spans
    assert want <= {s.name for s in tracing.spans()}


def test_profile_reads_the_variable(params, tmp_path, monkeypatch):
    monkeypatch.setenv("VADC_TPU_PROFILE", str(tmp_path / "env"))
    runner = StreamRunner("v3", params, device="cpu")
    with tracing.profile():
        runner.step(_chunks((1, 1536)), runner.init_state(1))
        tracing.count("n", 3)
    counters, trace = sorted((tmp_path / "env").iterdir())
    assert re.fullmatch(r"vadc_counters_\d+_\d+\.json", counters.name)
    assert re.fullmatch(r"vadc_trace_\d+_\d+\.json", trace.name)
    assert "forward_fused" in _names(tmp_path / "env")
    assert json.loads(counters.read_text()) == {"n": 3}


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


def test_record_gives_parents_and_jobs():
    with tracing.record():
        with tracing.zone("free"):
            tracing.count("c", 1)
        for _ in range(2):
            with tracing.zone("job", job=True):
                with tracing.zone("a"):
                    with tracing.zone("b"):
                        tracing.count("c", 5)
                with tracing.zone("a"):
                    pass
        # another thread's zones have their own stack: no parent, job 0
        def other_thread():
            with tracing.zone("thread"):
                pass

        worker = threading.Thread(target=other_thread)
        worker.start()
        worker.join(timeout=10)
        assert not worker.is_alive()
    assert tracing.zone("x") is tracing.zone("y")  # off again
    spans = tracing.spans()
    by_index = {s.index: s for s in spans}
    assert [s.name for s in spans] == ["free", "b", "a", "a", "job", "b", "a", "a", "job",
                                       "thread"]
    free, jobs, thread = spans[0], [s for s in spans if s.name == "job"], spans[-1]
    assert (free.parent, free.job) == (-1, 0) and (thread.parent, thread.job) == (-1, 0)
    assert jobs[0].job != jobs[1].job and 0 not in {j.job for j in jobs}
    for s in spans:
        if s.name == "a":
            assert by_index[s.parent].name == "job" and s.job == by_index[s.parent].job
        if s.name == "b":
            assert by_index[s.parent].name == "a" and s.job == by_index[s.parent].job
        assert s.start_ns <= s.end_ns
        if s.parent >= 0:
            parent = by_index[s.parent]
            assert parent.start_ns <= s.start_ns and s.end_ns <= parent.end_ns
    assert tracing.counters() == {"c": 11}
    assert tracing.counters(jobs[0].job) == {"c": 5} and tracing.counters(0) == {"c": 1}


def test_the_span_buffer_is_bounded():
    with tracing.record():
        for _ in range(tracing.MAX_SPANS + 7):
            with tracing.zone("s"):
                pass
    spans = tracing.spans()
    assert len(spans) == tracing.MAX_SPANS
    assert spans[-1].index - spans[0].index == tracing.MAX_SPANS - 1


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Three raw s16le files of synthetic speech: 5.3, 7 and 3.1 s."""
    root = tmp_path_factory.mktemp("corpus")
    paths = []
    for i, secs in enumerate((5.3, 7.0, 3.1)):
        n = int(secs * 16000)
        pcm = np.clip(speech(n // 1536 + 1, seed=60 + i).ravel()[:n] * 32768, -32768,
                      32767).astype("<i2")
        pcm.tofile(root / f"s{i}.s16le")
        paths.append(str(root / f"s{i}.s16le"))
    return paths


def _batch(paths, *extra) -> str:
    from vadc_tpu_torch.cli import batch

    out = io.StringIO()
    with redirect_stdout(out):
        assert batch.main([*paths, "--model", str(V31_ARCHIVE), "--device", "cpu",
                           "--slab_chunks", "16", *extra]) == 0
    return out.getvalue()


@pytest.fixture(scope="module")
def batch_runs(corpus):
    """The batch CLI over the corpus with the recorder off, then on: (lines
    off, lines on, the spans and the counters of the recorded run)."""
    tracing.clear()
    off = _batch(corpus)
    assert tracing.spans() == []
    with tracing.record():
        on = _batch(corpus)
    recorded = tracing.spans(), tracing.counters()
    tracing.clear()
    return off, on, *recorded


def test_batch_cli_span_tree_and_read_counter(corpus, batch_runs):
    import os

    _off, _on, spans, counters = batch_runs
    (job,) = [s for s in spans if s.name == "batch.job"]
    assert job.parent == -1 and job.job > 0
    assert {s.job for s in spans} == {job.job}
    by_index = {s.index: s for s in spans}
    named = [s for s in spans if s.name in BATCH_TREE]
    for s in named:
        assert by_index[s.parent].name == BATCH_TREE[s.name], s
        assert job.start_ns <= s.start_ns <= s.end_ns <= job.end_ns
    counts = {name: sum(s.name == name for s in named) for name in BATCH_TREE}
    t_chunks = -(-int(7.0 * 16000) // 1536)
    n_slabs = -(-t_chunks // 16)
    assert counts == {**{name: 1 for name in BATCH_TREE}, "batch.slab": n_slabs,
                      "segmenter.feed": n_slabs}
    # the phases in the order the CLI runs them, the slab kernels inside the slabs
    order = [s.name for s in sorted(named, key=lambda s: s.start_ns)]
    assert order[:4] == ["batch.open", "batch.pin", "batch.read", "batch.grid"]
    assert order[4:-2] == ["batch.slab", "segmenter.feed"] * n_slabs
    assert order[-2:] == ["segmenter.finish", "batch.output"]
    for s in spans:
        if s.name == "encode_fused_audio":
            assert by_index[s.parent].name == "batch.slab"
    # segmenter.columns: the chunk columns fed, every slab's 16
    assert counters == {"batch.read_bytes": sum(os.path.getsize(p) for p in corpus),
                        "batch.read_direct_files": len(corpus),
                        "segmenter.columns": 16 * n_slabs}


def test_batch_cli_lines_are_the_same_with_the_recorder_on(batch_runs):
    off, on, _spans, _counters = batch_runs
    assert off and on == off


def test_batch_cli_traces_under_the_variable(corpus, tmp_path, monkeypatch):
    """VADC_TPU_PROFILE on the batch CLI: one trace with the job's spans and
    one counters file beside it."""
    import os

    monkeypatch.setenv("VADC_TPU_PROFILE", str(tmp_path))
    _batch(corpus[:2])
    names = _names(tmp_path)
    assert {"batch.job", *BATCH_TREE, "encode_fused_audio"} <= names
    (counters,) = list(tmp_path.glob("vadc_counters_*.json"))
    assert json.loads(counters.read_text()) == {
        "batch.read_bytes": sum(os.path.getsize(p) for p in corpus[:2]),
        "batch.read_direct_files": 2, "segmenter.columns": 16 * 5}


def test_batch_cli_counts_a_wav_input_apart(corpus, tmp_path):
    """A .wav input is decoded and copied into its runs: its samples' bytes
    count in `batch.read_bytes`, the file not in `batch.read_direct_files`.
    A raw file's odd trailing byte is not read."""
    import os

    from vadc_tpu_torch.io.wav import read_file_s16, write_wav

    wav, odd = tmp_path / "s1.wav", tmp_path / "odd.s16le"
    write_wav(wav, np.fromfile(corpus[1], "<i2"), sample_rate=16000)
    odd.write_bytes(open(corpus[2], "rb").read() + b"\x01")
    with tracing.record():
        _batch([corpus[0], str(wav), str(odd)])
    assert tracing.counters() == {
        "batch.read_bytes": os.path.getsize(corpus[0]) + read_file_s16(wav).nbytes
        + os.path.getsize(corpus[2]),
        "batch.read_direct_files": 2, "segmenter.columns": 16 * 5}
