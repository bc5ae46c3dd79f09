"""The v5_convs kernel's share of its roofline in the traced job, %: the
chunk rows the job ran through it (the program's counter `v5.conv_rows`)
times a chunk's operations and bytes, over the device time of the kernel's
events (its __global__ name). A chunk's count comes from the
configuration's `encoder.convs`, `stft.frames` and padding, over the taps
that read a real frame (not the pad's zeros): 2 flops a multiply-add, the
spectrum in and the features out in fp32. A program without the counter
gives None."""

import re

from vadbench.metrics import counts
from vadbench.program_spans import job

KERNEL = re.compile(r"\bv5_convs_kernel\b")


def chunk_counts(config: dict) -> tuple[float, float]:
    """(flops, bytes) of the convs on one chunk."""
    enc, frames = config["encoder"], config["stft"]["frames"]
    pad, macs, n = enc["padding"], 0, frames
    for cin, cout, k, stride in enc["convs"]:
        out = (n + 2 * pad - k) // stride + 1
        taps = sum(0 <= f * stride + t - pad < n for f in range(out) for t in range(k))
        macs += taps * cin * cout
        n = out
    return 2.0 * macs, 4.0 * (frames * enc["convs"][0][0] + n * enc["convs"][-1][1])


def read(run):
    j, trace = job(run), run.get("trace")
    rows = None if j is None else j.counters.get("v5.conv_rows")
    if not rows or trace is None:
        return None
    events = [d for name, _s, d in trace.events if KERNEL.search(name)]
    if sum(events) <= 0:
        return None
    flops, nbytes = chunk_counts(run["config"])
    return 100.0 * counts.bound_s(rows * flops, rows * nbytes) / sum(events)
