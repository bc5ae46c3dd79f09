"""Model runners: the per-chunk step, its scan, and the minibatch runner.

Counterpart of vadc_tpu/engine/runner.py, for the five families: v3
(Silero v3.1), v4 and v4_8k, v5 and v5_8k:

  * `StreamRunner.step` — one chunk per stream for a batch of B independent
    streams (the realtime serving hot path); `StreamRunner.scan` — T chunks
    of each stream in order: the family's slab scan, `forward_scan` (the
    encoders of all B*T chunks at once, then one kernel through each
    stream's chunks).
  * `MinibatchRunner` — the reference driver's semantics for ONE stream: a
    window of N consecutive chunks through the model with the LSTM state
    threading chunk to chunk (process_chunks, vadc.c:56-103); the CLI's
    runner.

The v5 families carry a raw-audio context between chunks (the last 64
samples of a chunk, 32 at 8 kHz, prefix the next); both runners attach it
before the model sees the audio, and a scan hands it to `forward_scan`.
The JAX package's chunk-blocked scan (`_scan_tblock`, behind its
`scan_block_chunks`) is ported as every family's `forward_scan`; one kernel
walks all the chunks, so there is no block size to choose.

Every runner takes its device explicitly. On a CUDA device the model runs
through the package's CUDA kernels, with that device made current for the
call (`runtime.on_device`: the kernels' C entries act on the current
device); on the CPU through their plain versions. Every runner takes its precision tier too (`nn.precision`), and
every family runs all four (`runtime.check_precision` refuses an unknown
one).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from vadc_tpu_torch.models import silero_v4, silero_v5, silero_v31
from vadc_tpu_torch.models.weights import Params
from vadc_tpu_torch.nn.precision import tier_of
from vadc_tpu_torch.runtime import check_precision, on_device, resolve_device

_FAMILIES = {
    "v3": silero_v31,
    "v4": silero_v4,
    "v4_8k": silero_v4.v4_8k,
    "v5": silero_v5,
    "v5_8k": silero_v5.v5_8k,
}


def get_family_module(family: str):
    try:
        return _FAMILIES[family]
    except KeyError:
        raise ValueError(f"unknown model family {family!r}") from None


@dataclass
class StreamState:
    """Per-stream recurrent state of a batch of streams: the complete
    resumable inference state (reference silero.h:36-37, vadc.c:124)."""

    h: torch.Tensor  # [L, B, H]
    c: torch.Tensor  # [L, B, H]
    context: torch.Tensor | None = None  # [B, ctx], the v5 families only

    @property
    def n_streams(self) -> int:
        return self.h.shape[1]


def init_stream_state(family: str, n_streams: int, device="cpu") -> StreamState:
    mod = get_family_module(family)
    h, c = mod.init_state(n_streams, device)
    # the v5 families carry a raw-audio context tail between chunks
    ctx = mod.init_context(n_streams, device) if hasattr(mod, "init_context") else None
    return StreamState(h, c, ctx)


def params_to(params: dict, device: torch.device) -> Params:
    """The param tree with every leaf on `device`, as a Params; the same
    object when it is a Params there already (so what the kernels derived
    from it stays cached)."""

    def leaves(node):
        if isinstance(node, dict):
            for v in node.values():
                yield from leaves(v)
        elif isinstance(node, (list, tuple)):
            for v in node:
                yield from leaves(v)
        else:
            yield node

    if all(t.device == device for t in leaves(params)):
        return params if isinstance(params, Params) else Params(params)

    def move(node):
        if isinstance(node, dict):
            return {k: move(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [move(v) for v in node]
        return node.to(device)

    return Params(move(params))


def _as_audio(chunks, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(chunks, dtype=torch.float32).to(device)


def _tier(family: str, precision: str):
    """The model functions' tier argument (every family takes one)."""
    check_precision(precision, family)
    return tier_of(precision)


class StreamRunner:
    """Batched independent-stream inference for one model family on one
    device, at one precision tier."""

    def __init__(self, family: str, params: dict, *, device, precision: str = "faithful"):
        self.tier = _tier(family, precision)
        self.family = family
        self.module = get_family_module(family)
        self.precision = precision
        self.device = resolve_device(device)
        self.params = params_to(params, self.device)

    def init_state(self, n_streams: int) -> StreamState:
        return init_stream_state(self.family, n_streams, self.device)

    def step(self, chunks, state: StreamState) -> tuple[torch.Tensor, StreamState]:
        """chunks: [B, chunk_samples] new audio -> (probs [B], state).

        The state is updated IN PLACE and returned: the kernel writes hn, cn
        over h, c, and the chunks' tails over a v5 context. This is the
        counterpart of the JAX runner's donated state buffers; callers
        treat the passed-in state as consumed."""
        return self.step_into(chunks, state, state), state

    def step_into(self, chunks, state: StreamState, out: StreamState) -> torch.Tensor:
        """One step that writes the new state into `out` (h, c and a v5
        context, tensors of the state's shapes) and returns probs [B].
        `out` may be `state` (the in-place `step`); a distinct `out` keeps
        the old state, as the server's masked merge needs."""
        with on_device(self.device):
            audio = _as_audio(chunks, self.device)
            if state.context is not None:
                audio, tail = self.module.attach_context(audio, state.context)
                out.context.copy_(tail)
            probs, _, _ = self.module.forward(
                self.params, audio, state.h, state.c, hn=out.h, cn=out.c, tier=self.tier
            )
        return probs

    def scan(self, chunks, state: StreamState) -> tuple[torch.Tensor, StreamState]:
        """chunks: [B, T, chunk_samples] -> (probs [B, T], final state),
        T steps in order; the state is updated in place as in `step`."""
        with on_device(self.device):
            audio = _as_audio(chunks, self.device)
            kw = dict(hn=state.h, cn=state.c, tier=self.tier)
            if state.context is None:
                probs = self.module.forward_scan(self.params, audio, state.h, state.c, **kw)[0]
            else:
                probs = self.module.forward_scan(self.params, audio, state.h, state.c,
                                                 state.context, context_out=state.context, **kw)[0]
        return probs, state


class MinibatchRunner:
    """Reference-parity single-stream driver: batches of consecutive chunks
    through the model with the state threading chunk to chunk, rotated
    between batches."""

    def __init__(
        self,
        family: str,
        params: dict,
        *,
        batch_size: int,
        chunk_samples: int,
        device,
        precision: str = "faithful",
    ):
        self.tier = _tier(family, precision)
        self.family = family
        self.module = get_family_module(family)
        self.precision = precision
        self.device = resolve_device(device)
        self.params = params_to(params, self.device)
        self.batch_size = batch_size
        self.chunk_samples = chunk_samples
        mod = self.module
        self.h, self.c = mod.init_state(1, self.device)
        self.context = mod.init_context(1, self.device) if hasattr(mod, "init_context") else None

    def _forward(self, chunks: torch.Tensor):
        with on_device(self.device):
            if self.context is None:
                return self.module.forward_minibatched(
                    self.params, chunks, self.h, self.c, self.tier
                )
            # per-chunk context prefix: chunk i gets the tail of chunk i-1,
            # chunk 0 the carried context (process_chunks_v5, vadc.c:105-162)
            inp, tail = self.module.attach_contexts(chunks[None], self.context)
            self.context = tail.clone()
            return self.module.forward_minibatched(self.params, inp[0], self.h, self.c, self.tier)

    def process_window(self, samples) -> list[float]:
        """Process a window of samples (zero-padded multiple of the chunk
        size), returning one probability per chunk in the window."""
        n_chunks = samples.shape[0] // self.chunk_samples
        chunks = _as_audio(samples, self.device).reshape(n_chunks, self.chunk_samples)
        probs_out: list[float] = []
        for off in range(0, n_chunks, self.batch_size):
            batch = chunks[off : off + self.batch_size]
            if batch.shape[0] < self.batch_size:
                batch = torch.nn.functional.pad(batch, (0, 0, 0, self.batch_size - batch.shape[0]))
            probs, self.h, self.c = self._forward(batch)
            # one device -> host copy per batch
            probs_out.extend(np.asarray(probs.cpu()).tolist())
        # A short final batch is zero-padded up to batch_size; the padded
        # entries advance the LSTM state (reference stale-probability
        # semantics, vadc.c:88-99) but are not probabilities of real
        # chunks: never return more than one probability per chunk.
        return probs_out[:n_chunks]
