#!/usr/bin/env python3
"""Profile one StreamRunner step, one server tick and one slab scan of the
PyTorch/CUDA port on one card.

    python3 chip_profile.py

Runs 20 steps of `StreamRunner.step` over 2048 streams of 1536-sample
chunks of synthetic speech (chip_smoke.speech_chunks, seed 300) with the
LSTM state carried, under torch.profiler, after 10 warm-up steps; then 20
`_tick`s of a 2048-slot v3.1 server (vadc_tpu_torch.server, every slot
active, the same audio as s16) the same way; then 20 `StreamRunner.scan`s of
one corpus slab, 64 streams x 64 chunks (the slab route: the front-end,
encode_fused_audio and one lstm_decoder_fused). Prints for each:
  - host wall ms per call with the profiler on, the device's busy ms per
    call (the sum of the CUDA kernel and copy times), device events per
    call, and the idle share 1 - busy / wall;
  - the 30 device events that take the most time, per call;
  - host wall ms per call of the same loop without the profiler.
Then the step kernel's time by phase (`phase_split`): a second library of
the same source, built with -DVADC_PHASE_PROBE, stamps clock64() at every
phase boundary in the first 512 blocks; printed per phase as the mean over
those blocks, in microseconds (cycles scaled by each block's own span on the
card's nanosecond timer) and as a share of the block's life, at B=2048 x
1536 (all blocks resident together with their neighbours) and at B=4 (one
block alone). The package's own library carries no stamp.
Imports nothing of JAX. Exits 1 without a card.
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent))

BATCH = 2048
CHUNK = 1536
STEPS = 20
SLAB_STREAMS, SLAB_CHUNKS = 64, 64  # one slab of the offline corpus path


def profile_calls(label: str, call, shape: str = f"B={BATCH} x {CHUNK}") -> bool:
    """STEPS calls under torch.profiler, then STEPS without it; prints the
    device time per call by event. False when the profiler saw no device
    time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(STEPS):
            call()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue  # the CPU-side op rows would count their kernels twice
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = e.self_cuda_time_total
        rows.append((dev_us, e.key, e.count))
    rows.sort(reverse=True)
    busy_us = sum(r[0] for r in rows)
    if busy_us <= 0:
        print(f"chip_profile: the profiler recorded no device time for {label}", file=sys.stderr)
        return False
    print(f"{label} {shape}: wall {wall * 1e3 / STEPS:.4f} ms/call "
          f"(host clock, profiler on), device busy {busy_us / 1e3 / STEPS:.4f} ms/call in "
          f"{sum(r[2] for r in rows) // STEPS} device events, idle share "
          f"{1 - busy_us / 1e6 / wall:.3f}")
    for dev_us, key, count in rows[:30]:
        print(f"  {dev_us / STEPS:9.1f} us/call  {count // STEPS:4d}x  {key[:110]}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(STEPS):
        call()
    torch.cuda.synchronize()
    print(f"{label}: wall without profiler {(time.perf_counter() - t0) * 1e3 / STEPS:.4f} ms/call")
    return True


def phase_split(params, audio, label: str) -> None:
    """One launch of the stamped step kernel over `audio` [B, S] from a zero
    state; prints the mean time of each phase over the stamped blocks."""
    import ctypes

    import torch

    from vadc_tpu_torch.kernels import _build
    from vadc_tpu_torch.kernels.silero_v31_fused import forward_fused, step_args
    from vadc_tpu_torch.models import silero_v31

    lib = _build.probe_library()
    n_blocks, n_slots = ctypes.c_int(), ctypes.c_int()
    lib.vadc_phase_probe_shape(ctypes.byref(n_blocks), ctypes.byref(n_slots))
    n_blocks, n_slots = n_blocks.value, n_slots.value
    batch = audio.shape[0]
    h, c = silero_v31.init_state(batch, audio.device)
    probs = torch.empty(batch, device=audio.device)
    hn, cn = torch.empty_like(h), torch.empty_like(c)
    for _ in range(3):  # the last launch's stamps are read
        args = step_args(params, audio, h, c, probs, hn, cn)
        _build.check(lib.vadc_silero_v31_fused_audio(*args), "probe step")
    clocks = np.zeros((n_blocks, n_slots), np.int64)
    ids = np.zeros((n_blocks, n_slots), np.int32)
    counts = np.zeros(n_blocks, np.int32)
    ns = np.zeros((n_blocks, 2), np.uint64)
    status = lib.vadc_phase_probe_read(clocks.ctypes.data, ids.ctypes.data, counts.ctypes.data,
                                       ns.ctypes.data)
    _build.check(status, "probe read")
    if not torch.equal(forward_fused(params, audio, h, c)[0], probs):
        raise AssertionError("the stamped kernel's probabilities differ from the package's")
    blocks = min(n_blocks, -(-batch // 4))  # NB = 4 streams a block
    n = int(counts[0])
    if not all(int(counts[b]) == n and (ids[b, :n] == ids[0, :n]).all() for b in range(blocks)):
        raise AssertionError("blocks stamped different phase sequences")
    span_cycles = (clocks[:blocks, n - 1] - clocks[:blocks, 0]).astype(np.float64)
    span_us = (ns[:blocks, 1] - ns[:blocks, 0]).astype(np.float64) / 1e3
    us = np.diff(clocks[:blocks, :n], axis=1) * (span_us / span_cycles)[:, None]
    mean_us = us.mean(axis=0)
    total = float(span_us.mean())
    print(f"phase split of the step kernel, {label}: {blocks} blocks stamped, a block lives "
          f"{total:.1f} us (min {span_us.min():.1f}, max {span_us.max():.1f}), "
          f"{span_cycles.mean() / total:.0f} cycles a us")
    rows, stage = [], 0  # (encoder stage or 0, phase name, us)
    for i, t in enumerate(mean_us):
        name = _build.PHASES[ids[0, i + 1]]
        if name == "proj":
            stage += 1
        elif name.startswith("lstm"):
            stage = 0
        rows.append((stage, name, float(t)))
        print(f"  {f'stage {stage} ' if stage else ''}{name:28s} {t:9.2f} us  {100 * t / total:5.1f} %")
    groups = {"spectrum": ("spectrum",), "normalization": ("log1p", "mean, subtract, state"),
              "products": ("proj", "pw", "qkv", "out_proj", "lin1", "lin2", "conv1x1"),
              "depthwise": ("depthwise",), "attention": ("scores", "softmax", "mix"),
              "layer norms": ("layer_norm 1", "layer_norm 2"),
              "lstm": ("lstm input half", "lstm"), "decoder, stores": ("decoder, stores",)}
    for group, names in groups.items():
        t = sum(us for _, name, us in rows if name in names)
        print(f"  sum {group} ({', '.join(names)}): {t:.2f} us, {100 * t / total:.1f} %")
    for st in range(1, 5):
        t = sum(us for stage, _, us in rows if stage == st)
        print(f"  sum encoder stage {st}: {t:.2f} us, {100 * t / total:.1f} %")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_profile: no CUDA device is visible to PyTorch", file=sys.stderr)
        return 1
    import chip_smoke
    from vadc_tpu_torch.cli.main import DEFAULT_WEIGHTS
    from vadc_tpu_torch.engine.runner import StreamRunner
    from vadc_tpu_torch.models.weights import load_params
    from vadc_tpu_torch.runtime import require_cuda

    print(f"card: {chip_smoke.nvidia_smi()}", flush=True)
    device = require_cuda()
    _, params = load_params(DEFAULT_WEIGHTS, device=device)
    audio = torch.from_numpy(chip_smoke.speech_chunks(BATCH, CHUNK, seed=300)).to(device)
    runner = StreamRunner("v3", params, device=device)
    state = runner.init_state(BATCH)
    for _ in range(10):
        runner.step(audio, state)
    torch.cuda.synchronize()

    if not profile_calls("StreamRunner.step", lambda: runner.step(audio, state)):
        return 1

    from vadc_tpu_torch.server import VadServer

    server = VadServer(port=0, max_streams=BATCH, device=device)
    try:
        batch = (audio.cpu().numpy() * 32768).clip(-32768, 32767).astype(np.int16)
        on, off = np.ones(BATCH, bool), np.zeros(BATCH, bool)
        for _ in range(10):
            server._tick(batch, on, off)
        if not profile_calls("server _tick", lambda: server._tick(batch, on, off)):
            return 1
    finally:
        server.pool.close()

    slab = torch.from_numpy(
        chip_smoke.speech_chunks(SLAB_STREAMS * SLAB_CHUNKS, CHUNK, seed=301)
    ).to(device).reshape(SLAB_STREAMS, SLAB_CHUNKS, CHUNK)
    slab_state = runner.init_state(SLAB_STREAMS)
    for _ in range(5):
        runner.scan(slab, slab_state)
    if not profile_calls("StreamRunner.scan (one slab)", lambda: runner.scan(slab, slab_state),
                         shape=f"B={SLAB_STREAMS} x K={SLAB_CHUNKS} x {CHUNK}"):
        return 1
    phase_split(params, audio, f"B={BATCH} x {CHUNK}")
    phase_split(params, audio[:4], f"B=4 x {CHUNK} (one block alone)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
