"""The traced job's time building the int16 [B, T_max, chunk] grid (the
program's span `batch.grid`, in `cli/batch.py: load_streams`) over the
job's time (`batch.job`), %."""

from vadbench.program_spans import share


def read(run):
    return share(run, "batch.grid")
