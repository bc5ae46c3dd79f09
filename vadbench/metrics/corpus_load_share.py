"""The traced job's time inside `cli/batch.py: load_streams` (reading the
files, the int16 chunk grid) over the job's time, %."""


def read(run):
    share = run.get("load_share")
    return None if share is None else 100.0 * share
