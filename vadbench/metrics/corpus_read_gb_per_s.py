"""The rate of the traced job's file reads: the bytes the reads returned
(the program's counter `batch.read_bytes`) over the time in its span
`batch.read`, GB/s (1e9 bytes)."""

from vadbench.program_spans import job


def read(run):
    j = job(run)
    if j is None:
        return None
    seconds, nbytes = j.time_in("batch.read"), j.counters.get("batch.read_bytes")
    return None if not nbytes or seconds <= 0 else nbytes / seconds / 1e9
