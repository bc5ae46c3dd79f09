#!/usr/bin/env python3
"""Time the two recurrent kernels of the PyTorch/CUDA port through their
wrappers, in the tree of the current directory, on one NVIDIA card.

    cd <a checkout> && python3 <path to>/chip_ab.py

To compare two commits on one card, unpack each with `git archive` into a
directory of its own and run this script from each in turns on one card,
one run right after the other (parent, change, change, parent): it imports
`vadc_tpu_torch` from the current directory, whichever tree that is, builds
that tree's kernels and prints one line: the directory's name, then ms per
call (CUDA events, seeded random inputs: the times do not depend on the
values) of `lstm_fused` at the v4 (H=64, L=2) and v5 (H=128, L=1) steps at
B=2048 and CLI windows at B=1, and of `lstm_decoder_fused` at B=2048 x K=1
and K=8, a 64 x 64 corpus slab and the CLI's window of 96 chunks, T=7 frames
a chunk. Imports nothing of JAX. Exits 1 without a card.
"""

from __future__ import annotations

import os
import sys

SEED = 0
# (label, hidden, layers, batch, steps)
LSTM_SHAPES = (("v4", 64, 2, 2048, 3), ("v4", 64, 2, 2048, 1), ("v5", 128, 1, 2048, 1),
               ("v4", 64, 2, 1, 288), ("v5", 128, 1, 1, 96))
# (batch, chunks) at 7 frames a chunk
DECODER_SHAPES = ((2048, 1), (2048, 8), (64, 64), (1, 96))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_ab: no CUDA device is visible to PyTorch", file=sys.stderr)
        return 1
    sys.path.insert(0, os.getcwd())
    from vadc_tpu_torch.kernels.lstm import lstm_fused, transpose_weight
    from vadc_tpu_torch.kernels.lstm_decoder import lstm_decoder_fused

    def ms(fn, iters: int, warmup: int = 20) -> float:
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters

    device = torch.device("cuda")
    gen = torch.Generator(device=device).manual_seed(SEED)

    def rand(*shape, scale=1.0):
        return scale * torch.randn(*shape, device=device, generator=gen)

    out = []
    for name, hidden, layers, batch, seq in LSTM_SHAPES:
        w, b = rand(layers, 4 * hidden, 2 * hidden, scale=0.1), rand(layers, 4 * hidden, scale=0.1)
        wt = transpose_weight(w)
        x, h, c = rand(batch, seq, hidden), rand(layers, batch, hidden, scale=0.3), \
            rand(layers, batch, hidden)
        t = ms(lambda: lstm_fused(x, h, c, w, b, wt=wt), iters=200 if batch > 1 else 20)
        out.append(f"lstm_fused {name} B={batch} x T={seq}: {t:.4f}")
    w, b = rand(2, 256, 128, scale=0.1), rand(2, 256, scale=0.1)
    wt, dec_w, dec_b = transpose_weight(w), rand(2, 64), rand(2)
    for batch, chunks in DECODER_SHAPES:
        x, h, c = rand(batch, chunks, 7, 64), rand(2, batch, 64, scale=0.3), rand(2, batch, 64)
        t = ms(lambda: lstm_decoder_fused(x, h, c, w, b, dec_w, dec_b, wt=wt), iters=20)
        out.append(f"lstm_decoder_fused B={batch} x K={chunks} x T=7: {t:.4f}")
    print(f"{os.path.basename(os.getcwd())} ({torch.cuda.get_device_name(0)}), ms per call | "
          + "; ".join(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
