"""The traced job's time taking the slab-major int16 buffer [n_slabs, B,
slab, chunk], uninitialised and pinned on a card (the program's span
`batch.pin`, in `cli/batch.py: load_streams`: `slab_buffer`, which after
the first job takes the block back from torch's pinned-memory cache) over
the job's time (`batch.job`), %."""

from vadbench.program_spans import share


def read(run):
    return share(run, "batch.pin")
