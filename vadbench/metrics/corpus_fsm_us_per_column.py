"""The traced job's time in the vectorized segmenter's feeds (the
program's spans `segmenter.feed`) per chunk column fed (its counter
`segmenter.columns`: one FSM step over every stream), us. A program
without the counter gives None."""

from vadbench.program_spans import job


def read(run):
    j = job(run)
    columns = None if j is None else j.counters.get("segmenter.columns")
    return 1e6 * j.time_in("segmenter.feed") / columns if columns else None
