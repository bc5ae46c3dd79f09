"""The traced job's time inside `cli/batch.py: load_streams` (the files
opened and sized, the pinned slab buffer taken, each file read into its
runs of the buffer, the padding zeroed: the whole host ingest), wrapped
from outside the program, over the job's time, %."""


def read(run):
    share = run.get("load_share")
    return None if share is None else 100.0 * share
