"""The share of the traced stretch of a corpus cell in which no kernel,
copy or fill ran on the card, % (the union of the device events' spans)."""

from vadbench.metrics.shared import idle_share


def read(run):
    return idle_share(run)
