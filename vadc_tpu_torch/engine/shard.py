"""Stream sharding: the batch of independent streams split over devices.

Counterpart of vadc_tpu/engine/shard.py. The model is ~200 KB and is
replicated; the only sharded axis is the stream batch. Streams never
communicate, so no step has a collective and the shards never exchange a
byte. The JAX package shards a jitted step over a device mesh; here each
entry of a device list gets its own `StreamRunner` and, on a card, a CUDA
stream of its own. `step` and `scan` launch the shards one after another
from the calling thread (the launches are asynchronous, so the shards run
concurrently on their streams) and join every shard's stream into the
caller's current streams by an event before they return.

A device may be repeated (`["cuda:0", "cuda:0"]`, `["cpu"] * 8`): one card
or the CPU then exercises the split, the per-shard streams and the merge,
as the JAX tests' virtual CPU devices do for the mesh. A lone shard has no
stream of its own: it runs on the caller's, as a StreamRunner does. The
shards of one card share one Params; what the kernels derive from it is
complete before another shard's stream can read it (`Params.derived`).

Every shard operation starts on its stream after the caller's work on that
device (the stream waits on the caller's current stream) and every public
call ends with the caller's current streams waiting on the shards'. So the
caller sees the state and the probabilities as one consistent view on its
own streams, and may read or write them there between calls.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass

import torch

from vadc_tpu_torch.engine.runner import StreamRunner, StreamState, get_family_module, params_to
from vadc_tpu_torch.runtime import require_cuda, resolve_device

_NO_STREAM = contextlib.nullcontext()


def stream_devices(devices=None) -> list[torch.device]:
    """The devices to shard streams over (the counterpart of
    `make_stream_mesh`): every visible CUDA device by default, else those
    given, repeats allowed. Each is resolved: a CUDA device that is asked
    for and absent raises NoCudaDeviceError."""
    if devices is None:
        require_cuda()
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    resolved = [resolve_device(d) for d in devices]
    if not resolved:
        raise ValueError("no devices to shard streams over")
    return resolved


@contextlib.contextmanager
def _on_stream(stream: torch.cuda.Stream):
    stream.wait_stream(torch.cuda.current_stream(stream.device))
    with torch.cuda.device(stream.device), torch.cuda.stream(stream):
        yield


def _cat(parts: list, dim: int):
    if parts[0] is None:
        return None
    dev = parts[0].device
    return torch.cat([p.to(dev) for p in parts], dim=dim)


@dataclass
class ShardedState:
    """The state of a ShardedStreamRunner: one StreamState per shard, shard
    k's streams on shard k's device. `h`, `c` and `context` read the whole
    batch gathered onto the first shard's device: copies, for reading (the
    shards are the state). `n_processes` > 1 marks one process's slice of a
    state sharded over processes (engine/distributed.py), which a
    checkpoint refuses to take whole (checkpoint.save_sharded takes it)."""

    shards: list[StreamState]
    n_processes: int = 1

    @property
    def n_streams(self) -> int:
        return sum(s.n_streams for s in self.shards)

    @property
    def h(self) -> torch.Tensor:
        return _cat([s.h for s in self.shards], 1)

    @property
    def c(self) -> torch.Tensor:
        return _cat([s.c for s in self.shards], 1)

    @property
    def context(self) -> torch.Tensor | None:
        return _cat([s.context for s in self.shards], 0)


class ShardedStreamRunner:
    """StreamRunner with the batch dimension sharded over a list of devices.

    The params are moved once per distinct device (`params_to`), so a
    repeated device shares one Params and what the kernels derive from it.
    Shard k owns streams [k*B/n, (k+1)*B/n); n_streams must be a multiple
    of the number of devices."""

    def __init__(self, family: str, params: dict, devices, *, precision: str = "faithful"):
        self.family = family
        self.precision = precision
        self.module = get_family_module(family)
        self.devices = stream_devices(devices)
        moved: dict = {}
        self.runners = []
        for dev in self.devices:
            if dev not in moved:
                moved[dev] = params_to(params, dev)
            self.runners.append(StreamRunner(family, moved[dev], device=dev, precision=precision))
        alone = len(self.devices) == 1
        self.streams = [torch.cuda.Stream(dev) if dev.type == "cuda" and not alone else None
                        for dev in self.devices]

    @property
    def n_shards(self) -> int:
        return len(self.devices)

    def on_shard(self, k: int):
        """A context for work on shard k: its device current and its stream
        the current one, after the caller's work on that device (a lone
        shard: the caller's stream, as it is)."""
        stream = self.streams[k]
        return _NO_STREAM if stream is None else _on_stream(stream)

    def join(self) -> None:
        """The caller's current streams (of each shard's device and of the
        first device, where the results are gathered) wait on every
        shard's stream."""
        first = self.devices[0]
        for stream in self.streams:
            if stream is None:
                continue
            torch.cuda.current_stream(stream.device).wait_stream(stream)
            if first.type == "cuda" and first != stream.device:
                torch.cuda.current_stream(first).wait_stream(stream)

    def init_state(self, n_streams: int) -> ShardedState:
        # ValueError, not assert: a count from the user must be refused
        # under python -O too
        if n_streams % self.n_shards:
            raise ValueError(f"n_streams {n_streams} must divide over {self.n_shards} devices")
        per = n_streams // self.n_shards
        shards = []
        for k, runner in enumerate(self.runners):
            with self.on_shard(k):
                shards.append(runner.init_state(per))
        self.join()
        return ShardedState(shards)

    def scatter_state(self, whole: StreamState) -> ShardedState:
        """A state of this runner holding `whole` (a StreamState of all the
        streams, on any device): each shard's rows copied to its device."""
        state = self.init_state(whole.n_streams)
        per = whole.n_streams // self.n_shards
        for k, shard in enumerate(state.shards):
            rows = slice(k * per, (k + 1) * per)
            with self.on_shard(k):
                shard.h.copy_(whole.h[:, rows])
                shard.c.copy_(whole.c[:, rows])
                if shard.context is not None:
                    shard.context.copy_(whole.context[rows])
        self.join()
        return state

    def _split(self, chunks) -> list:
        """chunks [B, ...] (an array or a tensor on any device) -> the
        shards' rows, B/n each."""
        n = chunks.shape[0]
        if n % self.n_shards:
            raise ValueError(f"{n} streams do not divide over {self.n_shards} devices")
        per = n // self.n_shards
        return [chunks[k * per : (k + 1) * per] for k in range(self.n_shards)]

    def step(self, chunks, state: ShardedState) -> tuple[torch.Tensor, ShardedState]:
        """chunks [B, chunk] -> (probs [B] on the first device, state); the
        state is updated in place. `chunks` may also be the list of the
        shards' rows, each on its shard's device."""
        return self._run(chunks, state, lambda r, x, st: r.step_into(x, st, st))

    def scan(self, chunks, state: ShardedState) -> tuple[torch.Tensor, ShardedState]:
        """chunks [B, T, chunk] -> (probs [B, T] on the first device, final
        state), T steps in order; the state is updated in place."""
        return self._run(chunks, state, lambda r, x, st: r.scan(x, st)[0])

    def _run(self, chunks, state: ShardedState, fn):
        parts = chunks if isinstance(chunks, (list, tuple)) else self._split(chunks)
        if len(parts) != self.n_shards or len(state.shards) != self.n_shards:
            raise ValueError(f"{len(parts)} inputs and {len(state.shards)} states for "
                             f"{self.n_shards} shards")
        outs = []
        for k, (runner, part, shard) in enumerate(zip(self.runners, parts, state.shards)):
            stream = self.streams[k]
            with self.on_shard(k):
                if isinstance(part, torch.Tensor) and stream is not None \
                        and part.device == stream.device:
                    part.record_stream(stream)  # the caller's tensor, read on this stream
                outs.append(fn(runner, part, shard))
        self.join()
        return self._gather(outs), state

    def _gather(self, outs: list) -> torch.Tensor:
        """The shards' outputs in stream order on the first device, read on
        the caller's streams (joined)."""
        for out, stream in zip(outs, self.streams):
            if stream is not None:
                # allocated on the shard's stream, read on the caller's
                out.record_stream(torch.cuda.current_stream(stream.device))
        return outs[0] if len(outs) == 1 else _cat(outs, 0)
