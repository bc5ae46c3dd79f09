"""The card's idle time in the traced job whose gap lies (by its
midpoint) in the vectorized segmenter's feeds (the program's span
`segmenter.feed`: the FSM's per-chunk launches, the event copy, the drain)
over the job's time (`batch.job`), %."""

from vadbench.program_spans import idle_share


def read(run):
    return idle_share(run, "segmenter.feed")
