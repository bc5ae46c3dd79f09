"""The model's flops on the audio chunks of the jobs completed in the
window (grid padding excluded) over the window's time, as a share of the
card's fp32 peak, %."""

from vadbench.metrics import counts


def read(run):
    if not run.get("chunks"):
        return None
    rate = run["chunks"] * counts.model_flops_per_chunk(run["config"]) / run["window_s"]
    return 100.0 * rate / counts.PEAK_FP32_FLOPS
