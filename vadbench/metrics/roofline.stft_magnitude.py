"""The stft_magnitude kernel's share of its roofline in the traced stretch, %."""

from vadbench.metrics.shared import roofline


def read(run):
    return roofline(run, "stft_magnitude")
