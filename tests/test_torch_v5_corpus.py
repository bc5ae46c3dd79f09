"""Silero v5 16 kHz through the port's batch CLI against the benchmark's
plain v5 reference (vadbench/reference/silero_v5.py), on the CPU.

Six speech-like files of 3-9 s, none a whole number of 512-sample chunks,
at `--slab_chunks 16`, so each stream's 64-sample context and LSTM state
cross slab edges and the last chunk is a partial one. The probabilities the
CLI hands `BatchSegmenter.feed` lie within TOL of the reference's, and its
lines are the plain segmenter's on the reference's probabilities. TOL is
fp32's: the two sum the spectrum's, the convs' and the gates' products in
other orders (the port's convs as three shifted products, the reference's
as torch's conv1d), and the LSTM carries that rounding over a file's up to
280 chunks; 1e-5 is about fifty times fp32's epsilon, and a walk of the
same equations met it with 1.7e-6 on such files. The comparison is tight:
the bf16 fast tier, the reference without its context and the LSTM state
dropped at each slab each break it.
"""

import ast
import contextlib
import io
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from vadbench import harness, run
from vadbench.reference import segmenter as seg
from vadbench.reference import silero_v5
from vadbench.traffic import audio
from vadc_tpu_torch import tracing
from vadc_tpu_torch.cli import batch
from vadc_tpu_torch.engine import shard, vectorized_segmenter
from vadc_tpu_torch.io.testtensor import load_testtensor
from vadc_tpu_torch.models.synthetic import random_v5_archive

ROOT = Path(__file__).resolve().parent.parent
CONFIG = harness._json(ROOT / "vadbench/configs/silero_v5_16k.json")
ARCHIVE = ROOT / CONFIG["weights"]
CHUNK, RATE = CONFIG["chunk_samples"], CONFIG["sample_rate"]
TOL = 1e-5
LIB = {"voiced_s": [0.5, 2.0], "pause_s": [0.3, 1.0], "voiced_pieces": 6, "pause_pieces": 4,
       "f0_hz": [140.0, 210.0], "gain_min": 0.5, "gain_max": 1.5, "gain_levels": 3}
#: samples of each file: 3-9 s, none a multiple of 512
LENGTHS = [48_011, 144_000 - 77, 81_237, 112_901, 60_005, 130_333]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("v5corpus")
    lib = audio.Library(25, LIB)
    paths, pcm = [], np.zeros((len(LENGTHS), -(-max(LENGTHS) // CHUNK) * CHUNK), np.int16)
    for i, n in enumerate(LENGTHS):
        assert n % CHUNK
        pcm[i, :n] = np.frombuffer(audio.stream_bytes(lib, 25, i, 2 * n), "<i2")
        paths.append(str(d / f"{i}.s16le"))
        pcm[i, :n].tofile(paths[-1])
    return paths, pcm


def _reference(pcm: np.ndarray) -> np.ndarray:
    params = silero_v5.load_params("v5", ARCHIVE, "cpu")
    return silero_v5.stream_probs(params, torch.from_numpy(pcm.astype(np.float32) / 32768.0),
                                  CHUNK).numpy()


def _cli(paths: list[str], *extra: str) -> tuple[np.ndarray, list[list[str]]]:
    """The batch CLI on the CPU at 16-chunk slabs -> (the probabilities it
    fed its segmenter, [streams, columns]; each file's lines)."""
    fed = []
    inner = vectorized_segmenter.BatchSegmenter.feed

    def feed(self, probs):
        fed.append(torch.as_tensor(probs).clone())
        return inner(self, probs)

    out = io.StringIO()
    vectorized_segmenter.BatchSegmenter.feed = feed
    try:
        with contextlib.redirect_stdout(out):
            rc = batch.main([*paths, "--model", str(ARCHIVE), "--device", "cpu",
                             "--slab_chunks", "16", *extra])
    finally:
        vectorized_segmenter.BatchSegmenter.feed = inner
    assert rc == 0
    lines = [[] for _ in paths]
    for line in out.getvalue().splitlines():
        path, _, text = line.partition("\t")
        lines[paths.index(path)].append(text)
    return torch.cat(fed, dim=1).numpy(), lines


def _gap(got: np.ndarray, want: np.ndarray) -> float:
    gaps = [np.abs(got[i, :k] - want[i, :k]).max() for i, k in
            enumerate(-(-np.array(LENGTHS) // CHUNK))]
    return float(max(gaps))


def test_the_cli_gives_the_references_probabilities_and_lines(corpus):
    paths, pcm = corpus
    want = _reference(pcm)
    got, lines = _cli(paths)
    assert got.shape[1] >= want.shape[1] > 16  # several slabs
    assert want.max() > 0.7 and want.min() < 0.3 and (want > 0.5).mean() > 0.05
    assert _gap(got, want) < TOL
    cfg = seg.Config.for_chunk(CHUNK, RATE)
    for i, n in enumerate(LENGTHS):
        assert seg.match(lines[i], want[i, : n // CHUNK], cfg, TOL) is not None
    assert sum(map(len, lines)) >= len(paths)  # the FSM opens and closes segments


def _context_zeroed(monkeypatch):
    inner = silero_v5.chunk_inputs

    def zeroed(x, chunk):
        out = inner(x, chunk).clone()
        out[..., : silero_v5.CONTEXT] = 0
        return out

    monkeypatch.setattr(silero_v5, "chunk_inputs", zeroed)


def _state_dropped_each_slab(monkeypatch):
    inner = shard.ShardedStreamRunner.scan

    def scan(self, chunks, state):
        for s in state.shards:
            s.h.zero_()
            s.c.zero_()
        return inner(self, chunks, state)

    monkeypatch.setattr(shard.ShardedStreamRunner, "scan", scan)


@pytest.mark.parametrize("fault", ["precision_fast", "reference_context_zeroed",
                                   "lstm_state_reset_each_slab"])
def test_the_comparison_is_tight(corpus, monkeypatch, fault):
    paths, pcm = corpus
    extra = ("--precision", "fast") if fault == "precision_fast" else ()
    if fault == "reference_context_zeroed":
        _context_zeroed(monkeypatch)
    if fault == "lstm_state_reset_each_slab":
        _state_dropped_each_slab(monkeypatch)
    want = _reference(pcm)
    got, _ = _cli(paths, *extra)
    assert _gap(got, want) > 10 * TOL


def test_the_committed_archive_is_the_seeded_one():
    got, want = load_testtensor(str(ARCHIVE)), random_v5_archive(0)
    assert list(got) == list(want)
    for name, arr in want.items():
        assert got[name].dtype == np.float32 and got[name].shape == arr.shape
        assert got[name].tobytes() == arr.tobytes(), name


def test_the_reference_imports_no_jax_and_nothing_of_either_package():
    tree = ast.parse((ROOT / "vadbench/reference/silero_v5.py").read_text())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    names += [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.module]
    assert names and not [m for m in names if m.split(".")[0] in ("jax", "vadc_tpu",
                                                                   "vadc_tpu_torch")]
    probe = ("import sys; import vadbench.reference.silero_v5; "
             "print(sorted({m.split('.')[0] for m in sys.modules} & "
             "{'jax', 'jaxlib', 'vadc_tpu', 'vadc_tpu_torch'}))")
    out = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "[]"


def test_the_count_of_a_chunk_is_v5s():
    from vadbench.families import v5
    from vadbench.metrics import counts

    assert [tuple(c) for c in CONFIG["encoder"]["convs"]] == list(v5.CONVS)
    assert CONFIG["lstm"] == {"layers": v5.LSTM_LAYERS, "hidden": v5.HIDDEN}
    # spectrum 4 frames x 129 bins x 256 taps x 2 bases (and the magnitudes),
    # convs 2.3.in.out at 4, 2, 1, 1 frames, one gate product, the decoder
    want = (4 * (2 * 2 * 256 * 129 + 4 * 129) + 6 * (129 * 128 * 4 + 128 * 64 * 2 + 64 * 64
                                                     + 64 * 128) + 2 * 512 * 256 + 2 * 128)
    assert counts.model_flops_per_chunk(CONFIG) == want
    # the kernels' counts at the shapes their call sites record for v5
    f, nbytes = counts.stft_magnitude(2048, 576, 0, 64, 128)
    assert f == counts.spectrum_flops(2048 * 4)
    assert nbytes == 4 * (2048 * 576 + 2 * 256 * 129 + 2048 * 4 * 129)
    f, nbytes = counts.lstm_fused(512, 64, 128, 1, 128)
    assert f == 512 * 64 * 2 * 256 * 512
    assert nbytes == 4 * (2 * 512 * 64 * 128 + 4 * 512 * 128 + 512 * 256 + 512)


def test_the_cell_runs_and_its_readers_read_the_new_spans(monkeypatch):
    jobs = []
    inner_main, inner_feed = batch.main, vectorized_segmenter.BatchSegmenter.feed

    def main(argv):
        jobs.append([])
        return inner_main(argv)

    def feed(self, probs):
        jobs[-1].append(int(probs.shape[1]))
        return inner_feed(self, probs)

    monkeypatch.setattr(batch, "main", main)
    monkeypatch.setattr(vectorized_segmenter.BatchSegmenter, "feed", feed)
    tracing.clear()
    # one thread: beside the suite's other workers a job then takes its 0.2 s
    # (many threads each spinning on a shared CPU took past the window)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        line = run.run_cell("v5.corpus.512", 2**31 + 25, 4.0, True, device="cpu",
                            overrides={"files": 3, "file_s": [3.0, 5.0], "sample_streams": 2},
                            t_process=time.monotonic())
    finally:
        torch.set_num_threads(threads)
    assert line["correct"] is True and line["checks"]["prob_gap_max"]["value"] < TOL
    got = {k: v["value"] for k, v in line["metrics"].items()}
    assert 0 < got["corpus_v5_convs_share"] < 100 and got["corpus_fsm_us_per_column"] > 0
    # the traced job (the one after the warm-up) counted the columns it fed
    roots = [s for s in tracing.spans() if s.name == "batch.job"]
    assert len(roots) == 1 and len(jobs) >= 2
    assert tracing.counters(roots[0].job)["segmenter.columns"] == sum(jobs[1]) > 0
    names = {s.name for s in tracing.spans() if s.job == roots[0].job}
    assert {"v5.context", "v5.spectrum", "v5.convs", "encode", "segmenter.feed"} <= names
