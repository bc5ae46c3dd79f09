"""Realtime multi-stream serving demo on the PyTorch/CUDA port.

Counterpart of examples/serve_streams.py. Treats N s16le files as N live
audio streams, advancing all of them in lockstep one chunk per step
through a single batched device call (`StreamRunner.step`): per-stream
LSTM state lives on the device across steps, the segmentation FSM runs in
the native C++ kernel on the host, and raw segment events print as they
close (file, start_s, end_s; not padded or merged). Past a file's end its
row is zeros.

    python examples/serve_streams_torch.py a.s16le b.s16le c.s16le [--fast]
    python examples/serve_streams_torch.py --device cpu a.s16le b.s16le
"""

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument("files", nargs="+")
    parser.add_argument("--model", default=None)
    parser.add_argument("--fast", action="store_true", help="bf16 fast-math mode")
    parser.add_argument("--chunk", type=int, default=1536)
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
    from vadc_tpu_torch import native
    from vadc_tpu_torch.cli.segmenter import SegmenterConfig
    from vadc_tpu_torch.engine.runner import StreamRunner
    from vadc_tpu_torch.models.weights import DEFAULT_WEIGHTS, clamp_sequence_count, load_params
    from vadc_tpu_torch.runtime import resolve_device

    device = resolve_device(args.device)
    family, params = load_params(Path(args.model) if args.model else DEFAULT_WEIGHTS, device=device)
    chunk = clamp_sequence_count(family, args.chunk)

    # "live" sources: pre-framed files consumed one chunk per step
    frames = [
        native.frame_s16le(np.fromfile(p, dtype=np.int16), chunk) for p in args.files
    ]
    n = len(frames)
    t_max = max(f.shape[0] for f in frames)

    runner = StreamRunner(family, params, device=device, precision="fast" if args.fast else "faithful")
    state = runner.init_state(n)
    cfg = SegmenterConfig.from_ms(chunk_samples=chunk)
    fsm = native.NativeFsm(
        n,
        threshold=cfg.threshold,
        neg_threshold=cfg.neg_threshold,
        min_silence_chunks=cfg.min_silence_chunks,
        min_speech_chunks=cfg.min_speech_chunks,
    )

    spc = cfg.seconds_per_chunk
    t0 = time.perf_counter()
    batch = np.zeros((n, chunk), np.float32)
    for step in range(t_max):
        for i, f in enumerate(frames):
            batch[i] = f[step] if step < f.shape[0] else 0.0
        probs, state = runner.step(batch, state)
        for stream, start, end in fsm.feed(probs.cpu().numpy()[:, None]):
            print(f"{args.files[stream]}\t{start * spc:.2f},{end * spc:.2f}")
    wall = time.perf_counter() - t0
    audio_s = t_max * spc * n
    print(
        f"# {n} streams x {t_max} chunks ({audio_s:.0f} s audio) in {wall:.2f} s"
        f" = {audio_s / wall:.0f}x realtime aggregate",
        file=sys.stderr,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
