"""The seven readers of the program's own spans and counters
(`vadbench/program_spans.py`) on hand-made spans and a hand-made device
trace, their values worked by hand; and None where the traced window holds
no job, where there is no trace, and where the program has no recorder."""

import pytest

from vadbench import harness
from vadc_tpu_torch import tracing

READERS = ("corpus_read_share", "corpus_grid_share", "corpus_pin_share", "corpus_read_gb_per_s",
           "corpus_fsm_idle_share", "corpus_idle_outside_spans_share", "corpus_slab_share")
S = 1_000_000_000  # ns a second


class _Trace(harness.DeviceTrace):
    def __init__(self, events, t0, t1):  # no card: the arithmetic alone
        self.events, self.t_begin, self.t_end, self.prof = events, t0, t1, None


def _spans():
    """An earlier job (0.2-0.9 s) and the last job in the window (1-5 s):
    read 0.8 s, grid 0.6, pin 0.4, two slabs and two feeds, finish, output;
    a span nested in a slab; a job that ends after the window."""
    out = []

    def span(name, t0, t1, parent, job):
        out.append(tracing.Span(name, round(t0 * S), round(t1 * S), len(out), parent, job))
        return len(out) - 1

    early = span("batch.job", 0.2, 0.9, -1, 1)
    span("batch.read", 0.2, 0.8, early, 1)
    last = span("batch.job", 1.0, 5.0, -1, 2)
    for name, t0, t1 in (("batch.read", 1.0, 1.8), ("batch.grid", 1.8, 2.4),
                         ("batch.pin", 2.4, 2.8), ("batch.slab", 2.9, 3.2),
                         ("segmenter.feed", 3.2, 3.6), ("batch.slab", 3.6, 3.9),
                         ("segmenter.feed", 3.9, 4.3), ("segmenter.finish", 4.3, 4.4),
                         ("batch.output", 4.45, 4.55)):
        index = span(name, t0, t1, last, 2)
        if name == "batch.slab" and t0 == 2.9:
            span("encode_fused_audio", 2.95, 3.05, index, 2)
    span("batch.job", 9.5, 10.5, -1, 3)
    return out


COUNTERS = {1: {"batch.read_bytes": 5}, 2: {"batch.read_bytes": 1_600_000_000}}

#: device busy: [1.05, 1.10] [2.70, 2.82] [2.85, 2.95] [3.0, 3.25] [3.3, 3.35]
#: [3.5, 3.7] [4.0, 4.05] [4.2, 4.25]; the window 0-10 s
EVENTS = [("k", s, e - s) for s, e in ((1.05, 1.10), (2.70, 2.82), (2.85, 2.95), (3.0, 3.25),
                                        (3.3, 3.35), (3.5, 3.7), (4.0, 4.05), (4.2, 4.25))]


@pytest.fixture
def program(monkeypatch):
    monkeypatch.setattr(tracing, "spans", _spans)
    monkeypatch.setattr(tracing, "counters", lambda job=None: dict(COUNTERS.get(job, {})))


def _read(name, trace):
    return harness.metric_reader(name)({"trace": trace})


def test_readers_by_hand(program):
    trace = _Trace(EVENTS, 0.0, 10.0)
    # the last job: 4 s
    assert _read("corpus_read_share", trace) == pytest.approx(100 * 0.8 / 4)
    assert _read("corpus_grid_share", trace) == pytest.approx(100 * 0.6 / 4)
    assert _read("corpus_pin_share", trace) == pytest.approx(100 * 0.4 / 4)
    assert _read("corpus_read_gb_per_s", trace) == pytest.approx(1.6e9 / 0.8 / 1e9)
    # two slabs of 0.3 s; the span nested in the first is not a child
    assert _read("corpus_slab_share", trace) == pytest.approx(100 * 0.6 / 4)
    # the idle gaps cut to the job, by midpoint: [1.0, 1.05] read, [1.10,
    # 2.70] grid, [2.82, 2.85] none (2.835 between pin and slab), [2.95,
    # 3.0] slab, [3.25, 3.3] and [3.35, 3.5] feed, [3.7, 4.0] slab (3.85),
    # [4.05, 4.2] feed, [4.25, 5.0] none (4.625 after the output)
    assert _read("corpus_fsm_idle_share", trace) == pytest.approx(100 * (0.05 + 0.15 + 0.15) / 4)
    assert _read("corpus_idle_outside_spans_share", trace) == pytest.approx(
        100 * (0.03 + 0.75) / 4)


def test_the_window_picks_the_job(program):
    # the window 0-1 s holds only the earlier job: read 0.6 s of 0.7, 5 bytes
    trace = _Trace([], 0.0, 1.0)
    assert _read("corpus_read_share", trace) == pytest.approx(100 * 0.6 / 0.7)
    assert _read("corpus_read_gb_per_s", trace) == pytest.approx(5 / 0.6 / 1e9)
    assert _read("corpus_pin_share", trace) == 0.0
    # no device event: all of it idle, under the read (0.2-0.8 s: midpoint 0.55)
    assert _read("corpus_fsm_idle_share", trace) == 0.0
    assert _read("corpus_idle_outside_spans_share", trace) == 0.0


@pytest.mark.parametrize("name", READERS)
def test_none_without_a_job_in_the_window(program, name):
    assert _read(name, _Trace(EVENTS, 5.5, 10.0)) is None  # the last job ends after it
    assert _read(name, None) is None


def test_host_spans_read_without_a_device_trace(program):
    # a traced run on the CPU: the job's own stretch, no device events
    run = {"trace": None, "traced_window": (0.95, 5.05)}
    assert harness.metric_reader("corpus_slab_share")(run) == pytest.approx(100 * 0.6 / 4)
    assert harness.metric_reader("corpus_read_share")(run) == pytest.approx(100 * 0.8 / 4)
    assert harness.metric_reader("corpus_fsm_idle_share")(run) is None


@pytest.mark.parametrize("name", READERS)
def test_none_from_a_program_without_the_recorder(monkeypatch, name):
    monkeypatch.delattr(tracing, "spans")
    assert _read(name, _Trace(EVENTS, 0.0, 10.0)) is None
