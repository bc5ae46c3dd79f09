"""Spans, counters and traces: counterpart of vadc_tpu/tracing.py, the role
Tracy zones play in the reference (SURVEY.md §5.1), and the program's one
recorder of where its time goes.

  * `zone(name)`: a span, used as a context manager. While the recorder is
    on it records the name, its start and end on `time.monotonic_ns()`,
    the index of its parent span (the innermost zone open on the same
    thread, -1 for none) and a job id, into a bounded buffer that
    `spans()` reads. `zone(name, job=True)` opens a job: it draws a new job
    id, which every zone opened inside it shares (a zone outside any job
    has job 0). While a torch profiler runs the zone is also a
    `torch.profiler.record_function`, so its name shows in the trace beside
    the kernels it launched. With the recorder off it returns one shared
    null context and costs a flag test.
  * `count(name, n)`: adds n to the counter `name` of the current job;
    `counters()` reads the totals. Off, it returns at once.
  * The recorder is on while a torch profiler runs (`profile` below, the
    caller's own `torch.profiler.profile`, one with device activity only)
    and inside `record()`. `clear()` empties the spans and the counters.
  * `profile(outdir)`: traces the enclosed block with torch.profiler (CPU,
    and CUDA activity where there is a card) and writes it into `outdir` in
    Chrome's trace format (chrome://tracing, Perfetto), beside it the
    counters counted inside the block. Without `outdir` the
    VADC_TPU_PROFILE environment variable names the directory, as in the
    JAX package; with neither it is a no-op.

Each module that opens zones or counts names them in its own docstring
(models/silero_v31.py also those of its kernels' plain versions); README
says which metrics read them.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import json
import os
import threading
import time
from typing import NamedTuple

import torch

#: spans kept; the oldest go first
MAX_SPANS = 1 << 16

_NULL = contextlib.nullcontext()
_profiler_enabled = torch.autograd._profiler_enabled
_clock = time.monotonic_ns
_recording = 0  # open record() blocks
_spans: collections.deque = collections.deque(maxlen=MAX_SPANS)
_counters: dict = {}  # (name, job) -> total
_index = itertools.count()
_jobs = itertools.count(1)
_lock = threading.Lock()
_local = threading.local()


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    index: int
    parent: int  # the parent's index, -1 for none
    job: int  # 0 outside any job


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Zone:
    __slots__ = ("name", "new_job", "profiling", "function", "index", "parent", "job", "start")

    def __init__(self, name: str, new_job: bool, profiling: bool):
        self.name, self.new_job, self.profiling = name, new_job, profiling

    def __enter__(self):
        if self.profiling:
            self.function = torch.profiler.record_function(self.name)
            self.function.__enter__()
        stack = _stack()
        outer = stack[-1] if stack else None
        self.index = next(_index)
        self.parent = -1 if outer is None else outer.index
        self.job = next(_jobs) if self.new_job else (0 if outer is None else outer.job)
        stack.append(self)
        self.start = _clock()
        return self

    def __exit__(self, *exc):
        end = _clock()
        _stack().remove(self)
        _spans.append(Span(self.name, self.start, end, self.index, self.parent, self.job))
        if self.profiling:
            self.function.__exit__(*exc)
        return False


def zone(name: str, *, job: bool = False):
    """A span `name` (a context manager); `job` opens a job of its own."""
    profiling = _profiler_enabled()
    if not (profiling or _recording):
        return _NULL
    return _Zone(name, job, profiling)


def count(name: str, n: int) -> None:
    """Add n to the counter `name` of the current job."""
    if not (_recording or _profiler_enabled()):
        return
    stack = _stack()
    key = (name, stack[-1].job if stack else 0)
    with _lock:
        _counters[key] = _counters.get(key, 0) + n


@contextlib.contextmanager
def record():
    """Turn the recorder on inside the block (no profiler needed)."""
    global _recording
    _recording += 1
    try:
        yield
    finally:
        _recording -= 1


def spans() -> list[Span]:
    """The recorded spans, in the order they ended."""
    return list(_spans)


def counters(job: int | None = None) -> dict[str, int]:
    """The counters' totals: over every job, or of the job `job`."""
    out: dict = {}
    with _lock:
        items = list(_counters.items())
    for (name, j), n in items:
        if job is None or j == job:
            out[name] = out.get(name, 0) + n
    return out


def clear() -> None:
    _spans.clear()
    with _lock:
        _counters.clear()


@contextlib.contextmanager
def profile(outdir: str | None = None):
    """Trace the enclosed block into `outdir` (else $VADC_TPU_PROFILE; a
    no-op with neither): the trace as `vadc_trace_<pid>_<ns>.json` and the
    counters counted inside the block as `vadc_counters_<pid>_<ns>.json`."""
    outdir = outdir or os.environ.get("VADC_TPU_PROFILE")
    if not outdir:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(outdir, exist_ok=True)
    before = counters()
    with torch.profiler.profile(activities=activities) as prof:
        yield
    counted = {k: n - before.get(k, 0) for k, n in counters().items() if n != before.get(k, 0)}
    stem = f"{os.getpid()}_{time.time_ns()}"
    prof.export_chrome_trace(os.path.join(outdir, f"vadc_trace_{stem}.json"))
    with open(os.path.join(outdir, f"vadc_counters_{stem}.json"), "w") as f:
        json.dump(counted, f, indent=1, sort_keys=True)
