"""The reader of the v5 convs' kernel's roofline (roofline.v5_convs): its
count of a chunk against the count worked by hand, and its arithmetic on a
made-up trace and a recorded job, with and without the program's counter."""

import time

import pytest

from vadbench import harness
from vadbench.harness import DeviceTrace
from vadbench.metrics import counts

READER = harness._metric_module(harness.HERE / "metrics" / "roofline.v5_convs.py")
NAME = "void (anonymous namespace)::v5_convs::v5_convs_kernel<129, 0>(float const*, int)"


class _Trace(DeviceTrace):
    def __init__(self, events, t0, t1):  # no card: the arithmetic alone
        self.events, self.t_begin, self.t_end, self.prof = events, t0, t1, None


def test_a_chunks_count_by_hand():
    # the taps that read a real frame: 10 of conv 1's 12 (4 frames), 5 of
    # conv 2's 6 (2 frames), 2 of conv 3's 3, 1 of conv 4's 3; the spectrum
    # [4, 129] in, 128 features out
    cfg = harness.cell("v5.corpus.512").config
    macs = 10 * 129 * 128 + 5 * 128 * 64 + 2 * 64 * 64 + 1 * 64 * 128
    assert macs == 222_464
    assert READER.chunk_counts(cfg) == (2.0 * macs, 4.0 * (4 * 129 + 128))


def _run(rows, events):
    from vadc_tpu_torch import tracing

    tracing.clear()
    t0 = time.monotonic()
    with tracing.record(), tracing.zone("batch.job", job=True):
        if rows:
            tracing.count("v5.conv_rows", rows)
    t1 = time.monotonic()
    return {"trace": _Trace(events, t0, t1 + 1.0), "traced_window": (t0, t1 + 1.0),
            "config": harness.cell("v5.corpus.512").config}


def test_the_share_from_the_counter_and_the_kernels_events():
    from vadc_tpu_torch import tracing

    rows = 4096 * 296
    flops, nbytes = READER.chunk_counts(harness.cell("v5.corpus.512").config)
    least = counts.bound_s(rows * flops, rows * nbytes)
    try:
        run = _run(rows, [(NAME, 0.0, least), (NAME, 0.1, 3 * least), ("other_kernel", 0.2, 1.0)])
        assert READER.read(run) == pytest.approx(25.0)
        # a program without the counter (the kernel's parent) gives None
        assert READER.read(_run(0, [(NAME, 0.0, least)])) is None
        # and so does a trace without the kernel's events
        assert READER.read(_run(rows, [("other_kernel", 0.0, 1.0)])) is None
        assert READER.read({"trace": None}) is None
    finally:
        tracing.clear()
