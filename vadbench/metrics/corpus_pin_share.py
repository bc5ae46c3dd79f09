"""The traced job's time allocating, zeroing and filling the pinned slabs
(the program's span `batch.pin`, in `cli/batch.py: main`) over the job's
time (`batch.job`), %."""

from vadbench.program_spans import share


def read(run):
    return share(run, "batch.pin")
