"""The lstm_decoder_fused kernel's share of its roofline in the traced stretch, %."""

from vadbench.metrics.shared import roofline


def read(run):
    return roofline(run, "lstm_decoder_fused")
