"""The program's own spans and counters (`vadc_tpu_torch.tracing`), for the
per-layer readers of a traced corpus run.

The recorder is on while the traced job runs (`tracing.record()`, and on a
card its profiler), so after the run `tracing.spans()` holds that job: the
last `batch.job` span that lies in the traced window, with its child spans
(the batch CLI's phases, the segmenter's calls) and its counters. Spans
are on `time.monotonic_ns()`, the clock `harness.DeviceTrace` maps the
device's events onto, so the device's idle gaps fall under the spans the
host was in. A program without the recorder (an older commit) gives no
job, and the readers give None.
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass


@dataclass
class Job:
    start: float  # seconds, monotonic clock
    end: float
    children: list  # (name, start, end) of the job's child spans, by start
    counters: dict

    @property
    def wall(self) -> float:
        return self.end - self.start

    def time_in(self, name: str) -> float:
        """Seconds in the child spans `name`."""
        return sum(e - s for n, s, e in self.children if n == name)

    def idle_under(self, trace, name: str | None) -> float:
        """Seconds of device idle time inside the job whose gap (cut to the
        job) has its midpoint in a child span `name`, or, with None, in no
        child span. The gaps are `trace.idle_gaps()`, the rule of
        `DeviceTrace.breakdown`."""
        starts = [s for _n, s, _e in self.children]
        total = 0.0
        for g0, g1 in trace.idle_gaps():
            a, b = max(g0, self.start), min(g1, self.end)
            if b <= a:
                continue
            mid = 0.5 * (a + b)
            j = bisect.bisect_right(starts, mid) - 1
            under = self.children[j][0] if j >= 0 and mid <= self.children[j][2] else None
            if under == name:
                total += b - a
        return total


def job(run: dict) -> Job | None:
    """The last batch CLI job inside the traced window (the run's
    `traced_window`, else the device trace's), or None."""
    trace = run.get("trace")
    t_begin, t_end = run.get("traced_window") or (
        (trace.t_begin, trace.t_end) if trace is not None else (None, None))
    if t_begin is None:
        return None
    try:
        from vadc_tpu_torch import tracing
    except ImportError:
        return None
    spans_of, counters_of = getattr(tracing, "spans", None), getattr(tracing, "counters", None)
    if spans_of is None or counters_of is None:
        return None
    spans = spans_of()
    jobs = [s for s in spans if s.name == "batch.job"
            and t_begin <= s.start_ns * 1e-9 and s.end_ns * 1e-9 <= t_end]
    if not jobs:
        return None
    root = max(jobs, key=lambda s: s.start_ns)
    children = sorted(((s.name, s.start_ns * 1e-9, s.end_ns * 1e-9) for s in spans
                       if s.parent == root.index and s.job == root.job), key=lambda c: c[1])
    return Job(root.start_ns * 1e-9, root.end_ns * 1e-9, children, counters_of(root.job))


def share(run: dict, name: str) -> float | None:
    """The job's time in the child spans `name` over the job's, %."""
    j = job(run)
    return None if j is None or j.wall <= 0 else 100.0 * j.time_in(name) / j.wall


def idle_share(run: dict, name: str | None) -> float | None:
    """The job's device idle time under the child spans `name` (None: under
    none) over the job's time, %."""
    j = job(run)
    if j is None or j.wall <= 0 or run.get("trace") is None:
        return None
    return 100.0 * j.idle_under(run["trace"], name) / j.wall
