"""What the per-layer readers share: a kernel's roofline share from the
traced stretch, and the device's idle share."""

from __future__ import annotations

import re

from vadbench.metrics import counts

#: device kernel names of each of the port's kernel wrappers (its CUDA
#: entry points' __global__ functions; the recurrent wrappers launch one of
#: several variants)
KERNEL_NAMES = {
    "encode_fused_audio": r"\bsilero_v31_encode_audio_kernel\b",
    "stft_magnitude": r"\bstft_magnitude(_mma)?_kernel\b",
    "lstm_fused": r"\b(lstm_kernel|lstm_mma_kernel|input_gates_kernel|input_gates_mma_kernel"
                  r"|wavefront2_kernel|wavefront3_kernel|wavefront_mma_kernel|cluster1_kernel"
                  r"|cluster_mma_kernel)\b",
}
KERNEL_NAMES["lstm_decoder_fused"] = KERNEL_NAMES["lstm_fused"]


def roofline(run: dict, kernel: str, pattern: str | None = None, count=None) -> float | None:
    """100 x the least time the card could take for the calls recorded in
    the traced stretch (each call's bound from its launched shape) over the
    device time of their kernels; None where the stretch recorded no call
    or fewer kernel events than calls (the profiler lost some). A reader of
    a kernel not in the tables gives its device names' `pattern` and its
    `count(shape) -> (flops, bytes)`."""
    trace, shapes = run.get("trace"), run.get("calls", {}).get(kernel)
    if trace is None or not shapes:
        return None
    pattern = re.compile(pattern or KERNEL_NAMES[kernel])
    count = count or counts.KERNELS[kernel]
    events = [d for name, _s, d in trace.events if pattern.search(name)]
    if len(events) < len(shapes) or sum(events) <= 0:
        return None
    least = sum(counts.bound_s(*count(shape)) for shape in shapes)
    return 100.0 * least / sum(events)


def idle_share(run: dict) -> float | None:
    trace = run.get("trace")
    if trace is None or trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s() / trace.window_s)
