"""Multi-process scale-out: torch.distributed wiring and per-process
stream feeding.

Counterpart of vadc_tpu/engine/distributed.py. The model's only parallel
axis is the stream batch, and streams never communicate: the step has no
collective, in the JAX package and here. Each process ingests its own
streams and runs them on a ShardedStreamRunner over its own devices; no
state or probability ever crosses processes. The process group only
coordinates: the processes agree on the layout when the engine is built
and meet at a barrier around a sharded checkpoint save
(engine/checkpoint.py: save_sharded), with small host tensors.

Launch (one process per host or per group of cards, same program):

    VADC_COORDINATOR=host0:7654 VADC_NUM_PROCESSES=4 VADC_PROCESS_ID=$i \\
        python my_serving_app.py

    # in the app:
    from vadc_tpu_torch.engine import distributed
    distributed.initialize()            # reads the env (or pass explicitly)
    engine = distributed.MultiHostStreamEngine("v3", params, devices=["cuda:0", "cuda:1"])
    state = engine.init_state(total_streams)
    probs_local, state = engine.step(local_chunks, state)  # B/n_processes here

tools/torch_multidevice_dryrun.py runs it end to end (2 processes x 2
devices on one machine).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from vadc_tpu_torch.engine.runner import StreamState
from vadc_tpu_torch.engine.shard import ShardedState, ShardedStreamRunner


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> None:
    """Wire this process into the cluster (torch.distributed's process
    group). Arguments default to the VADC_COORDINATOR (host:port of process
    0's rendezvous), VADC_NUM_PROCESSES and VADC_PROCESS_ID environment
    variables, the JAX package's. Nothing discovers a cluster: all three
    must be given one way or the other."""
    import torch.distributed as dist

    coordinator_address = coordinator_address or os.environ.get("VADC_COORDINATOR")
    if num_processes is None and "VADC_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["VADC_NUM_PROCESSES"])
    if process_id is None and "VADC_PROCESS_ID" in os.environ:
        process_id = int(os.environ["VADC_PROCESS_ID"])
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError(
            "distributed.initialize needs the coordinator's host:port, the number of "
            "processes and this process's id (VADC_COORDINATOR, VADC_NUM_PROCESSES, "
            "VADC_PROCESS_ID)"
        )
    # gloo, on the CPU and on the card: the group carries only the layout
    # check and the barriers, small host tensors, never a device tensor.
    # NCCL would refuse two ranks on one card ("Duplicate GPU detected"),
    # the only multi-process layout a one-card machine has.
    dist.init_process_group(
        "gloo",
        init_method=f"tcp://{coordinator_address}",
        world_size=num_processes,
        rank=process_id,
    )


def _group():
    import torch.distributed as dist

    return dist if dist.is_available() and dist.is_initialized() else None


class MultiHostStreamEngine:
    """A ShardedStreamRunner over this process's devices, with per-process
    feeding: each process passes only its local streams' chunks to
    `step`/`scan` ([B_total / n_processes, ...], stream order = process
    order) and gets only its local streams' probabilities back, as numpy
    arrays. Every process builds its engine collectively (the layout
    check is a collective) with the same number of devices."""

    def __init__(self, family: str, params: dict, *, precision: str = "faithful", devices=None):
        self.runner = ShardedStreamRunner(family, params, devices, precision=precision)
        group = _group()
        self.n_processes = group.get_world_size() if group else 1
        self.process_id = group.get_rank() if group else 0
        if group is not None:
            counts = [torch.zeros(1, dtype=torch.int64) for _ in range(self.n_processes)]
            group.all_gather(counts, torch.tensor([self.runner.n_shards]))
            counts = [int(x) for x in counts]
            if len(set(counts)) != 1:
                raise ValueError(f"the processes shard over different device counts: {counts}")

    def barrier(self) -> None:
        """Every process reaches this point before any goes on (no-op in a
        single process)."""
        group = _group()
        if group is not None and self.n_processes > 1:
            group.barrier()

    def init_state(self, total_streams: int) -> ShardedState:
        """This process's slice of a zero state of `total_streams` streams."""
        n_devices = self.n_processes * self.runner.n_shards
        if total_streams % n_devices:
            raise ValueError(
                f"n_streams {total_streams} must divide over {n_devices} devices "
                f"({self.n_processes} processes x {self.runner.n_shards})"
            )
        state = self.runner.init_state(total_streams // self.n_processes)
        state.n_processes = self.n_processes
        return state

    def step(self, local_chunks, state: ShardedState) -> tuple[np.ndarray, ShardedState]:
        """local_chunks [B_local, chunk] -> (local probs [B_local], state)."""
        probs, state = self.runner.step(local_chunks, state)
        return probs.cpu().numpy(), state

    def scan(self, local_chunks, state: ShardedState) -> tuple[np.ndarray, ShardedState]:
        """local_chunks [B_local, T, chunk] -> (local probs [B_local, T], state)."""
        probs, state = self.runner.scan(local_chunks, state)
        return probs.cpu().numpy(), state

    # -- checkpointing (this process's streams only) -----------------------

    def local_state(self, state: ShardedState) -> StreamState:
        """This process's stream slice of the model state as host tensors,
        no cross-process traffic. Feed it to EngineCheckpoint: each process
        checkpoints its own slice (see checkpoint.save_sharded)."""
        context = state.context
        return StreamState(state.h.cpu(), state.c.cpu(), None if context is None else context.cpu())

    def state_from_local(self, local: StreamState) -> ShardedState:
        """The engine's state from this process's slice (the inverse of
        local_state), on this process's devices."""
        state = self.runner.scatter_state(local)
        state.n_processes = self.n_processes
        return state
