"""The traced job's time in the slab loop (the program's spans
`batch.slab`, in `cli/batch.py: _main`: the next slab's copies enqueued,
the dequant on each shard's card, `ShardedStreamRunner.scan` launching
the shards one after another and its join) over the job's time
(`batch.job`), %. On several cards it shows whether the launch in turn
from one host thread scales."""

from vadbench.program_spans import share


def read(run):
    return share(run, "batch.slab")
