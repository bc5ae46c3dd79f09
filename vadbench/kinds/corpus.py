"""Corpora through the port's batch CLI (`vadc_tpu_torch.cli.batch.main`).

Set-up writes the corpus from the seed (raw s16le files in a temporary
directory under TMPDIR) and runs one whole warm-up job over it, so every
shape, the pinned host memory and the kernels are in place before the
window. The window runs the job, one whole CLI invocation over every file
with the CLI's defaults, back to back; each job's stdout goes to a file.

What is compared, once the window has closed: every job's lines, file by
file, against the plain segmenter on the reference's probabilities of that
file; and, for a seeded sample of files (the longest among them), the
probabilities the CLI's slab scans handed its segmenter (captured by
wrapping `BatchSegmenter.feed`) against the reference's.

The control (`control`) hands the CLI's segmenter the plain reference's
probabilities of each slab in TF32 in place of the program's, so that the
same comparison judges it.
"""

from __future__ import annotations

import contextlib
import os
import shutil
import sys
import tempfile
import time

import numpy as np

from vadbench import harness
from vadbench.metrics import counts
from vadbench.reference import segmenter as seg
from vadbench.traffic.audio import Library, Stream


def file_lengths(seed: int, tr: dict, rate: int) -> np.ndarray:
    """Samples of each file: evenly spaced over the mix's range, in an
    order drawn from the seed (every seed carries the same audio)."""
    lo, hi = tr["file_s"]
    lengths = np.round(np.linspace(lo, hi, tr["files"]) * rate).astype(np.int64)
    return np.random.default_rng([seed, 4]).permutation(lengths)


def sample_files(seed: int, samples: np.ndarray, k: int) -> np.ndarray:
    """The files whose probabilities are compared: the longest and others
    drawn from the seed."""
    rng = np.random.default_rng([seed, 5])
    drawn = rng.choice(len(samples), size=min(k, len(samples)) - 1, replace=False)
    return np.unique(np.append(drawn, np.argmax(samples)))


def corpus_pcm(seed: int, tr: dict, rate: int, chunk: int) -> np.ndarray:
    """[files, max chunks * chunk] s16: the corpus as written, zero padded."""
    lib = Library(seed, tr["library"])
    samples = file_lengths(seed, tr, rate)
    out = np.zeros((len(samples), int(-(-samples.max() // chunk)) * chunk), np.int16)
    for i, n in enumerate(samples):
        out[i, :n] = np.frombuffer(Stream(lib, seed, i).take(2 * int(n)), "<i2")
    return out


def write_corpus(seed: int, tr: dict, rate: int, directory: str) -> list[str]:
    lib = Library(seed, tr["library"])
    paths = []
    for i, n in enumerate(file_lengths(seed, tr, rate)):
        path = os.path.join(directory, f"{i:04d}.s16le")
        with open(path, "wb") as f:
            f.write(Stream(lib, seed, i).take(2 * int(n)))
        paths.append(path)
    return paths


def _lines_by_file(text: str, paths: list[str]) -> list[list[str]]:
    index = {p: i for i, p in enumerate(paths)}
    out = [[] for _ in paths]
    for line in text.splitlines():
        path, _, seg_text = line.partition("\t")
        out[index[path]].append(seg_text)
    return out


def reference_probs(cfg: dict, paths: list[str], samples: np.ndarray, device: str,
                    tf32: bool = False):
    """The plain reference's probability of every chunk of every file
    (read back from the files), [files, max chunks], on `device`."""
    import torch

    chunk = cfg["chunk_samples"]
    ref = harness.reference(cfg)
    params = ref.load_params(cfg["family"], harness.ROOT / cfg["weights"], device)
    k_max = int(-(-samples.max() // chunk))
    pcm = np.zeros((len(paths), k_max * chunk), np.int16)
    for i, path in enumerate(paths):
        pcm[i, : samples[i]] = np.fromfile(path, "<i2")
    audio = torch.from_numpy(pcm).to(device).float().div_(32768.0)
    del pcm
    return ref.stream_probs(params, audio, chunk, tf32=tf32)


def run(cell: harness.Cell, seed: int, seconds: float, trace: bool, device: str,
        t_process: float, control: bool = False) -> dict:
    import torch

    # set-up by part: the process's start (interpreter, torch, CUDA), the
    # port's CUDA library (built in a checkout's first run), the corpus, the
    # profiler's first start (traced runs), the warm-up job
    t = time.monotonic()
    parts = {"process_start_s": t - t_process}
    if device != "cpu":
        from vadc_tpu_torch.kernels import _build

        _build.library()  # the port's CUDA library: built in a checkout's first run
        parts["kernel_library_s"] = time.monotonic() - t
    from vadc_tpu_torch.cli import batch
    from vadc_tpu_torch.engine import shard, vectorized_segmenter

    cfg, tr = cell.config, cell.traffic
    chunk, rate = cfg["chunk_samples"], cfg["sample_rate"]
    archive = harness.ROOT / cfg["weights"]
    tmp = tempfile.mkdtemp(prefix="vadbench_corpus_")
    record = harness.Record()
    try:
        t = time.monotonic()
        paths = write_corpus(seed, tr, rate, tmp)
        parts["corpus_write_s"] = time.monotonic() - t
        samples = file_lengths(seed, tr, rate)
        audio_s = float(samples.sum()) / rate
        chunks = int(np.sum(-(-samples // chunk)))
        sample = sample_files(seed, samples, tr["sample_streams"])
        argv = [*paths, "--model", str(archive), *tr["cli_args"]]
        if cfg["precision"] != "faithful":
            argv += ["--precision", cfg["precision"]]
        if device == "cpu":
            argv += ["--device", "cpu"]

        in_place = None
        if control:  # the control's probabilities, before the window
            in_place = reference_probs(cfg, paths, samples, device, tf32=True).float()
        captured: list = []
        column = [0]
        index = {}
        inner_feed = vectorized_segmenter.BatchSegmenter.feed

        def feed(self, probs):
            if in_place is not None:
                c0, width = column[0], probs.shape[1]
                column[0] += width
                have = in_place[:, c0 : c0 + width].to(probs.device)
                probs = torch.nn.functional.pad(
                    have, (0, width - have.shape[1], 0, probs.shape[0] - have.shape[0]))
            if torch.is_tensor(probs):
                idx = index.get(probs.device)
                if idx is None:
                    idx = index[probs.device] = torch.as_tensor(sample, device=probs.device)
                captured[-1].append(probs.index_select(0, idx))
            return inner_feed(self, probs)

        vectorized_segmenter.BatchSegmenter.feed = feed
        record.restore_later(vectorized_segmenter.BatchSegmenter, "feed", inner_feed)
        dtrace = None
        if trace:
            record.install_call_sites()
            record.span(batch, "main", "corpus CLI: main (params, grid, pinned slabs, output)")
            record.span(batch, "load_streams", "corpus CLI: load_streams")
            record.span(shard.ShardedStreamRunner, "scan", "corpus CLI: slab scan (launch)")
            record.span(vectorized_segmenter.BatchSegmenter, "feed", "corpus CLI: segmenter feed")
            record.span(vectorized_segmenter.BatchSegmenter, "finish",
                        "corpus CLI: segmenter finish")
            if device != "cpu":
                dtrace = harness.DeviceTrace(torch.device(device))

        def job(k: int) -> tuple[float, float]:
            captured.append([])
            column[0] = 0
            out = os.path.join(tmp, f"job{k}.txt")
            with open(out, "w") as f, contextlib.redirect_stdout(f):
                t_a = time.monotonic()
                rc = batch.main(argv)
                t_b = time.monotonic()
            if rc != 0:
                raise RuntimeError(f"the batch CLI exited {rc}")
            return t_a, t_b

        if dtrace:
            t = time.monotonic()
            dtrace.warm()
            parts["profiler_warm_s"] = time.monotonic() - t
        t = time.monotonic()
        job(-1)  # warm-up: every shape of the window, the pinned memory, the kernels
        ws = time.monotonic()
        parts["warmup_job_s"] = ws - t
        setup_s = ws - t_process
        we = ws + seconds
        times = []
        while time.monotonic() < we:
            k = len(times)
            if dtrace and k == 0:
                dtrace.begin()
                record.on = True
            times.append(job(k))
            if dtrace and k == 0:
                record.on = False
                dtrace.end()
        if dtrace:
            dtrace.collect()
        done = [t for t in times if t[1] <= we]
        if not done:
            raise RuntimeError("no job completed inside the window")
        elapsed = done[-1][1] - ws
        print(f"vadbench: set-up {setup_s:.3f} s "
              f"({', '.join(f'{k} {v:.3f}' for k, v in parts.items())}); jobs (s) "
              f"{[round(b - a, 4) for a, b in times]}", file=sys.stderr)
        record.uninstall()
        memory_peak = int(torch.cuda.max_memory_allocated()) if device != "cpu" else 0
        got_probs = [torch.cat(c, dim=1).cpu().numpy() for c in captured[1:]]
        captured.clear()
        index.clear()
        in_place = None
        if device != "cpu":
            torch.cuda.empty_cache()

        # the reference over every file
        probs_ref = reference_probs(cfg, paths, samples, device).cpu().numpy()
        full = samples // chunk  # the CLI emits whole chunks only

        scfg = seg.Config.for_chunk(chunk, rate)
        bound = cell.limits["prob_gap_max"]
        wrong_files, wrong_all, gap = 0, 0, 0.0
        judged: dict = {}
        for k in range(len(times)):
            text = open(os.path.join(tmp, f"job{k}.txt")).read()
            if text not in judged:
                got = _lines_by_file(text, paths)
                judged[text] = sum(seg.match(got[i], probs_ref[i, : full[i]], scfg, bound) is None
                                   for i in range(len(paths)))
            wrong_all += judged[text]
            if k < len(done):
                wrong_files += judged[text]
            if k < len(got_probs):
                have = got_probs[k]
                for j, i in enumerate(sample):
                    n_valid = int(-(-samples[i] // chunk))
                    if have.shape[1] < n_valid:
                        gap = float("inf")
                        continue
                    diff = np.abs(have[j, :n_valid].astype(np.float64) - probs_ref[i, :n_valid])
                    gap = max(gap, float(diff.max()))
        checks = {"lines_wrong": (wrong_all, cell.limits["lines_wrong"]),
                  "prob_gap_max": (gap, bound)}
        job0 = times[0]
        load = [e - s for label, s, e in record.spans
                if label == "corpus CLI: load_streams" and job0[0] <= s <= job0[1]]
        run_record = {
            "window_s": elapsed,
            "jobs": len(done),
            "job_s": [b - a for a, b in done],
            "chunks": chunks * len(done),
            "load_share": (sum(load) / (job0[1] - job0[0])) if trace and load else None,
            "trace": dtrace,
            "calls": record.calls,
            "config": cfg,
            "model_flops_per_chunk": counts.model_flops_per_chunk(cfg),
        }
        return {
            "correct": all(v <= lim for v, lim in checks.values()),
            "attempted": len(done) * len(paths),
            "failed": wrong_files,
            "end_to_end": {"corpus_audio_s_per_s": audio_s * len(done) / elapsed,
                           "setup_s": setup_s},
            "memory_peak_bytes": memory_peak,
            "setup_parts": parts,
            "checks": checks,
            "run": run_record,
            "breakdown": dtrace.breakdown(record.spans, "between jobs") if dtrace else None,
        }
    finally:
        record.uninstall()
        shutil.rmtree(tmp, ignore_errors=True)
