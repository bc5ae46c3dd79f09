"""The traced job's time in v5's four convs (the program's spans
`v5.convs`, in `models/silero_v5.py: encode`, at any depth under the job:
inside `batch.slab`'s `encode`, once a piece of chunks) over the job's
time (`batch.job`), %. A program without the span gives None."""

from vadbench.program_spans import job


def read(run):
    j = job(run)
    if j is None or j.wall <= 0:
        return None
    from vadc_tpu_torch import tracing

    convs = [s.end_ns - s.start_ns for s in tracing.spans() if s.name == "v5.convs"
             and j.start <= s.start_ns * 1e-9 and s.end_ns * 1e-9 <= j.end]
    return 100.0 * sum(convs) * 1e-9 / j.wall if convs else None
