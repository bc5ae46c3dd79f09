"""The traced job's time reading the corpus files (the program's span
`batch.read`, in `cli/batch.py: load_streams`) over the job's time
(`batch.job`), %."""

from vadbench.program_spans import share


def read(run):
    return share(run, "batch.read")
