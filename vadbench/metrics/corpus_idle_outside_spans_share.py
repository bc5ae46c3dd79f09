"""The card's idle time in the traced job whose gap lies (by its
midpoint) under none of the job's child spans, over the job's time
(`batch.job`), %: what the program's spans do not explain yet."""

from vadbench.program_spans import idle_share


def read(run):
    return idle_share(run, None)
