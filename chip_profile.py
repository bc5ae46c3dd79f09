#!/usr/bin/env python3
"""Profile one StreamRunner step of the PyTorch/CUDA port on one card.

    python3 chip_profile.py

Runs 20 steps of `StreamRunner.step` over 2048 streams of 1536-sample
chunks of synthetic speech (chip_smoke.speech_chunks, seed 300) with the
LSTM state carried, under torch.profiler, after 10 warm-up steps. Prints:
  - host wall ms per step with the profiler on, the device's busy ms per
    step (the sum of CUDA kernel times), kernels per step, and the idle
    share 1 - busy / wall;
  - the 30 kernels that take the most device time, per step;
  - host wall ms per step of the same loop without the profiler.
Imports nothing of JAX. Exits 1 without a card.
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

BATCH = 2048
CHUNK = 1536
STEPS = 20


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

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

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(STEPS):
            runner.step(audio, state)
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
        print("chip_profile: the profiler recorded no device time", file=sys.stderr)
        return 1
    print(f"B={BATCH} x {CHUNK}: wall {wall * 1e3 / STEPS:.4f} ms/step "
          f"(host clock, profiler on), device busy {busy_us / 1e3 / STEPS:.4f} ms/step in "
          f"{sum(r[2] for r in rows) // STEPS} kernels, idle share {1 - busy_us / 1e6 / wall:.3f}")
    for dev_us, key, count in rows[:30]:
        print(f"  {dev_us / STEPS:9.1f} us/step  {count // STEPS:4d}x  {key[:110]}")

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(STEPS):
        runner.step(audio, state)
    torch.cuda.synchronize()
    print(f"wall without profiler {(time.perf_counter() - t0) * 1e3 / STEPS:.4f} ms/step")
    return 0


if __name__ == "__main__":
    sys.exit(main())
