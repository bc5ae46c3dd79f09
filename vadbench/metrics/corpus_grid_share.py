"""The traced job's time zeroing the padding of the slab buffer (the
program's span `batch.grid`, in `cli/batch.py: load_streams`: every sample
past a file's end, and the rows of the silent streams that pad the stream
count) over the job's time (`batch.job`), %. The name is the span's from
before the files were read straight into the slab buffer, when it built an
int16 [B, T_max, chunk] grid."""

from vadbench.program_spans import share


def read(run):
    return share(run, "batch.grid")
