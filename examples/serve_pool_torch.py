"""Live multi-stream serving with the native ingest pool, on the PyTorch/CUDA port.

Counterpart of examples/serve_pool.py. Spawns N producer processes writing
s16le PCM into pipes (stand-ins for live network/microphone feeds), drains
them GIL-free through the C++ StreamPool, and advances the READY streams
each engine tick in one batched device step. Raw segment events print as
they close (file, start_s, end_s; not padded or merged); a segment still
open at the end prints nothing.

    python examples/serve_pool_torch.py a.s16le b.s16le c.s16le [--fast]
    python examples/serve_pool_torch.py --device cpu a.s16le b.s16le
"""

import argparse
import os
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument("files", nargs="+")
    parser.add_argument("--model", default=None)
    parser.add_argument("--fast", action="store_true")
    parser.add_argument("--device", default="cuda", help="torch device: cuda (default), cuda:N or cpu")
    return parser


def main(argv: list[str] | None = None) -> int:
    from vadc_tpu_torch.runtime import NoCudaDeviceError

    args = build_parser().parse_args(argv)
    try:
        return _main(args)
    except (FileNotFoundError, ValueError, NoCudaDeviceError) as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1


def _main(args) -> int:
    import torch

    from vadc_tpu_torch import native
    from vadc_tpu_torch.cli.segmenter import SegmenterConfig
    from vadc_tpu_torch.engine.runner import StreamRunner, masked_merge
    from vadc_tpu_torch.models.weights import DEFAULT_WEIGHTS, clamp_sequence_count, load_params
    from vadc_tpu_torch.runtime import resolve_device

    device = resolve_device(args.device)
    if not native.available():
        print("native library unavailable (make -C native)", file=sys.stderr)
        return 1

    family, params = load_params(Path(args.model) if args.model else DEFAULT_WEIGHTS, device=device)
    chunk = clamp_sequence_count(family, 1536)
    n = len(args.files)
    runner = StreamRunner(family, params, device=device, precision="fast" if args.fast else "faithful")
    # the step writes into `spare`; the masked merge keeps every idle
    # stream's previous state, then the two swap
    state, spare = runner.init_state(n), runner.init_state(n)
    cfg = SegmenterConfig.from_ms(chunk_samples=chunk)
    fsm = native.NativeFsm(
        n,
        threshold=cfg.threshold,
        neg_threshold=cfg.neg_threshold,
        min_silence_chunks=cfg.min_silence_chunks,
        min_speech_chunks=cfg.min_speech_chunks,
    )
    spc = cfg.seconds_per_chunk
    chunk_counts = np.zeros(n, np.int64)

    pool = native.StreamPool(n, chunk, ring_chunks=32)
    producers, read_fds = [], []
    done = False
    try:
        for i, path in enumerate(args.files):
            r, w = os.pipe()
            read_fds.append(r)
            pool.add_fd(i, r)
            # producer: cat the file into the pipe (a live feed stand-in)
            producers.append(subprocess.Popen(["cat", path], stdout=w, close_fds=True))
            os.close(w)
        pool.start()

        t0 = time.perf_counter()
        while True:
            batch, ready, count, _ = pool.gather()
            if count == 0:
                if all(pool.stream_done(i) for i in range(n)):
                    break
                time.sleep(0.002)
                continue
            mask = ready > 0
            # the pool gathers RAW s16 (half the host->device bytes); x / 32768
            # on the device is bit-identical to host conversion (a power of two)
            audio = torch.from_numpy(batch).to(device).float().mul_(1.0 / 32768.0)
            probs = runner.step_into(audio, state, spare)
            masked_merge(spare, state, torch.from_numpy(mask).to(device))
            state, spare = spare, state
            for stream, start, end in fsm.feed(probs.cpu().numpy()[:, None], active=mask):
                print(f"{args.files[stream]}\t{start * spc:.2f},{end * spc:.2f}")
            chunk_counts += mask
        wall = time.perf_counter() - t0
        done = True
    finally:
        for proc in producers:
            if not done:  # a producer blocked on a full pipe would never exit
                proc.kill()
            proc.wait()
        pool.close()  # the pool never closes the fds it was given
        for r in read_fds:
            os.close(r)
    total_audio = float(chunk_counts.sum()) * spc
    print(
        f"# {n} live streams, {total_audio:.0f} s audio in {wall:.2f} s "
        f"({total_audio / wall:.1f}x realtime aggregate)",
        file=sys.stderr,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
