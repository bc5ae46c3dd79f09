"""Profiling zones and traces: counterpart of vadc_tpu/tracing.py, the role
Tracy zones play in the reference (SURVEY.md §5.1).

  * `zone(name)`: a named range, usable as a context manager. While a
    torch profiler runs (`profile` below, or the caller's own
    `torch.profiler.profile`) it is `torch.profiler.record_function` plus,
    on a machine with a card, an NVTX range, so the name shows in the trace
    beside the kernels it launched. Otherwise it returns one shared null
    context and costs a flag test: the v3.1 step is one kernel launch.
  * `profile(outdir)`: traces the enclosed block with torch.profiler (CPU,
    and CUDA activity where there is a card) and writes it into `outdir` in
    Chrome's trace format (chrome://tracing, Perfetto). Without `outdir`
    the VADC_TPU_PROFILE environment variable names the directory, as in
    the JAX package; with neither it is a no-op.

The zones are the JAX package's, on the Silero v3.1 model only: `stft`,
`adaptive_norm`, `encoder_layer_1`..`4`, `lstm` and `decoder` on the plain
path (the kernels' plain versions, which the CPU runs), and on the kernel
path the kernel's name (`forward_fused`, `encode_fused_audio`,
`lstm_decoder_fused`), around the plain stages on the CPU.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch

_NULL = contextlib.nullcontext()


def zone(name: str):
    """Named profiling zone (usable as a context manager)."""
    if not torch.autograd._profiler_enabled():
        return _NULL
    return _zone(name)


@contextlib.contextmanager
def _zone(name: str):
    with torch.profiler.record_function(name):
        if not torch.cuda.is_available():
            yield
            return
        torch.cuda.nvtx.range_push(name)
        try:
            yield
        finally:
            torch.cuda.nvtx.range_pop()


@contextlib.contextmanager
def profile(outdir: str | None = None):
    """Trace the enclosed block into `outdir` (else $VADC_TPU_PROFILE; a
    no-op with neither). The trace is one `vadc_trace_<pid>_<ns>.json`."""
    outdir = outdir or os.environ.get("VADC_TPU_PROFILE")
    if not outdir:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(outdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(
        os.path.join(outdir, f"vadc_trace_{os.getpid()}_{time.time_ns()}.json")
    )
