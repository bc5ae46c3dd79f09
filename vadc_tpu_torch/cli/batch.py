"""Offline corpus mode on the PyTorch/CUDA port: many audio files ->
timestamps, in one batched pass.

Counterpart of vadc_tpu/cli/batch.py. Every file is an independent stream
with its own LSTM state; the corpus is scanned on the device in time slabs
with the state carried from slab to slab, and the segmentation FSM runs
vectorized on the device. For Silero v3.1 a slab is one `forward_scan`: the
front-end and the encoder of every chunk of the slab at once, then one
kernel that walks each stream's chunks in order; the v4 and v5 families scan
a slab as a loop of steps. With --device cuda the streams are sharded over
every visible card (engine/shard.py, the JAX package's mesh over the
stream axis), the stream count padded to a multiple of the card count;
with --device cuda:N or cpu they run on that one device. The lines and cut
files do not depend on the sharding.

Usage:
    python -m vadc_tpu_torch.cli.batch FILE.s16le [FILE.s16le ...]
        [--model PATH] [--sequence_count N] [--slab_chunks N]
        [--min_silence MS] [--min_speech MS] [--threshold P]
        [--neg_threshold_relative P] [--speech_pad MS] [--stats]
        [--cut_dir DIR] [--device cuda|cpu] [--fast | --precision TIER]

Every family runs every precision tier (--fast is --precision fast).

Output (stdout): `<filename>\\t<start>,<end>` per segment. With --cut_dir,
additionally writes one speech-only file per input. Inputs are raw mono
model-rate s16le files or .wav at any rate/bits/channels (decoded natively).
With --device cuda (the default) and no card it exits 1 with a one-line
error; it never runs on the CPU instead.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from pathlib import Path

import numpy as np

from vadc_tpu_torch.runtime import PRECISIONS, NoCudaDeviceError


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="vadc-torch-batch", description=__doc__)
    p.add_argument("files", nargs="+", help="raw mono model-rate s16le files, or .wav")
    p.add_argument("--model", type=str, default=None)
    p.add_argument("--sequence_count", type=int, default=1536)
    p.add_argument("--slab_chunks", type=int, default=64,
                   help="chunks per device scan slab (memory/latency knob)")
    p.add_argument("--min_silence", type=float, default=200.0)
    p.add_argument("--min_speech", type=float, default=250.0)
    p.add_argument("--threshold", type=float, default=0.5)
    p.add_argument("--neg_threshold_relative", type=float, default=0.15)
    p.add_argument("--speech_pad", type=float, default=30.0)
    p.add_argument("--cut_dir", type=str, default=None,
                   help="also WRITE speech-only audio per input file into "
                        "this directory (wav for .wav inputs, raw s16le "
                        "otherwise): corpus-scale silence removal in the "
                        "same pass")
    p.add_argument("--stats", action="store_true")
    p.add_argument("--fast", action="store_true",
                   help="shorthand for --precision fast")
    p.add_argument("--precision", choices=PRECISIONS, default=None,
                   help="precision tier (default faithful, fp32); the bf16 tiers "
                        "balanced, fast and turbo run every family")
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (default: every visible card, the streams "
                        "sharded over them), cuda:N or cpu (that one device)")
    return p


def batch_devices(device: str) -> list:
    """The devices the corpus runs on: every visible card for 'cuda', else
    the one device named."""
    from vadc_tpu_torch.engine.shard import stream_devices

    return stream_devices(None if device == "cuda" else [device])


def load_streams(
    paths: list[str], chunk_samples: int, sample_rate: int = 16000
) -> tuple[np.ndarray, np.ndarray, list[np.ndarray]]:
    """Load s16le files into a zero-padded [B, T_max, chunk] grid.
    Returns (chunk grid, per-stream emitted chunk counts, the files' samples).

    The grid stays int16: the s16 -> f32/32768 conversion runs ON THE DEVICE
    per slab, so int16 is what crosses the host->device link (half the
    bytes), and no whole-corpus float conversion runs on the host."""
    from vadc_tpu_torch.io.wav import read_file_s16

    # raw s16le or .wav (sniffed by magic; wav decodes/downmixes/resamples
    # natively — the reference needs ffmpeg for any container input)
    audios = [read_file_s16(p, target_rate=sample_rate) for p in paths]
    valid = np.asarray([-(-len(a) // chunk_samples) for a in audios], np.int64)
    # emission parity with the streaming CLI: a trailing partial chunk is
    # model-processed but not emitted (vadc.c:964 floor semantics)
    emit_valid = np.asarray([len(a) // chunk_samples for a in audios], np.int64)
    t_max = int(valid.max())
    grid = np.zeros((len(audios), t_max, chunk_samples), np.int16)
    for i, a in enumerate(audios):
        n_full = len(a) // chunk_samples
        grid[i, :n_full] = a[: n_full * chunk_samples].reshape(-1, chunk_samples)
        rem = len(a) - n_full * chunk_samples
        if rem:
            grid[i, n_full, :rem] = a[n_full * chunk_samples :]
    return grid, emit_valid, audios


def main(argv: list[str] | None = None) -> int:
    try:
        return _main(argv)
    except (FileNotFoundError, ValueError, NotImplementedError, NoCudaDeviceError) as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1
    except BrokenPipeError:
        return 0
    except KeyboardInterrupt:
        return 130


def _main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)

    import torch

    from vadc_tpu_torch.cli.segmenter import SegmenterConfig, slice_segments
    from vadc_tpu_torch.engine.shard import ShardedStreamRunner
    from vadc_tpu_torch.engine.vectorized_segmenter import BatchSegmenter
    from vadc_tpu_torch.io.wav import write_wav
    from vadc_tpu_torch.models.weights import DEFAULT_WEIGHTS, clamp_sequence_count, load_params

    precision = "fast" if args.fast else (args.precision or "faithful")
    devices = batch_devices(args.device)
    device = devices[0]
    weights_path = Path(args.model) if args.model else DEFAULT_WEIGHTS
    if not weights_path.exists():
        raise FileNotFoundError(f"no weight archive at {weights_path}")
    family, params = load_params(weights_path, device=device)
    seq = clamp_sequence_count(family, int(args.sequence_count))
    runner = ShardedStreamRunner(family, params, devices, precision=precision)
    # the 8 kHz families take 8 kHz input (raw files are presumed at the
    # model rate, as on the streaming CLI; wav files resample to it) and
    # time chunks at their own rate
    model_sr = runner.module.SAMPLE_RATE

    t0 = time.perf_counter()
    grid, valid, audios = load_streams(args.files, seq, sample_rate=model_sr)
    n_files, t_chunks = grid.shape[:2]
    slab = max(1, min(args.slab_chunks, t_chunks))
    n_slabs = -(-t_chunks // slab)
    # pad the stream count to a multiple of the device count with silent
    # streams that emit nothing (valid 0)
    n_streams = -(-n_files // runner.n_shards) * runner.n_shards
    valid_all = np.concatenate([valid, np.zeros(n_streams - n_files, valid.dtype)])

    # The corpus slab by slab, [n_slabs, B, slab, chunk] int16 with the time
    # axis zero-padded to a slab multiple, in pinned host memory when the
    # devices are cards: each shard's rows of a slab are then one contiguous
    # run that an asynchronous copy takes to its device.
    on_card = device.type == "cuda"
    slabs = torch.zeros((n_slabs, n_streams, slab, seq), dtype=torch.int16, pin_memory=on_card)
    slabs_np = slabs.numpy()
    for k in range(n_slabs):
        piece = grid[:, k * slab : (k + 1) * slab]
        slabs_np[k, :n_files, : piece.shape[1]] = piece
    del grid

    state = runner.init_state(n_streams)
    seg_config = SegmenterConfig.from_ms(
        chunk_samples=seq,
        sample_rate=model_sr,
        min_silence_ms=args.min_silence,
        min_speech_ms=args.min_speech,
        threshold=args.threshold,
        neg_threshold_relative=args.neg_threshold_relative,
        speech_pad_ms=args.speech_pad,
    )
    # device backend: only the sparse closed-segment events cross the
    # device->host boundary per slab. pending_depth=2 defers each slab's
    # event readback until two more slabs have been enqueued, so the
    # readback overlaps the next slabs' transfer and compute.
    # the vectorized FSM runs on the first device over the gathered slab
    # probabilities of every stream
    segmenter = BatchSegmenter(
        seg_config, n_streams, device=device, backend="device", pending_depth=2,
        # mask each file's zero-padded tail out of the FSM: pad chunks
        # must not confirm closes the scalar segmenter would EOF-snap
        valid_chunks=valid_all,
    )

    # double-buffered host->device pipeline: slab k+1's copies (a shard's
    # rows to its device each) are enqueued on copy streams before slab k's
    # scan, so the links and the cards work concurrently (the reference's
    # single-thread loop, vadc.c:852-999, is their sum). The s16 -> f32
    # conversion runs on each shard's device, on its stream (reference
    # vadc.c:873-901 does it on the host).
    per = n_streams // runner.n_shards
    copy_streams = [torch.cuda.Stream(d) if on_card else None for d in runner.devices]

    def h2d(k: int) -> list:
        parts = []
        for j, (dev, stream) in enumerate(zip(runner.devices, copy_streams)):
            rows = slabs[k, j * per : (j + 1) * per]
            if stream is None:
                parts.append((rows, None))
                continue
            with torch.cuda.stream(stream):
                copied = torch.cuda.Event()
                parts.append((rows.to(dev, non_blocking=True), copied))
                copied.record(stream)
        return parts

    def dequant(parts: list) -> list:
        audio = []
        for j, (s16, copied) in enumerate(parts):
            with runner.on_shard(j):
                if copied is not None:
                    compute = torch.cuda.current_stream(s16.device)
                    compute.wait_event(copied)
                    s16.record_stream(compute)
                audio.append(s16.to(torch.float32) * (1.0 / 32768.0))
        return audio

    pending = h2d(0) if n_slabs else None
    for k in range(n_slabs):
        nxt = h2d(k + 1) if k + 1 < n_slabs else None
        probs, state = runner.scan(dequant(pending), state)
        segmenter.feed(probs)
        pending = nxt

    segments = segmenter.finish(valid_chunks=valid_all)[:n_files]
    for path, segs in zip(args.files, segments):
        for start, end in segs:
            sys.stdout.write(f"{path}\t{start:.2f},{end:.2f}\n")
    sys.stdout.flush()

    if args.cut_dir is not None:
        # corpus-scale silence removal: slice the kept ranges out of the
        # already-loaded samples and write one speech-only file per input
        os.makedirs(args.cut_dir, exist_ok=True)
        written: set[str] = set()
        for path, samples, segs in zip(args.files, audios, segments):
            kept = slice_segments(samples, segs, model_sr)
            name = Path(path).name
            if name in written:  # same basename from different directories
                stem, dot, ext = name.partition(".")
                i = 1
                while f"{stem}_{i}{dot}{ext}" in written:
                    i += 1
                name = f"{stem}_{i}{dot}{ext}"
            written.add(name)
            out = Path(args.cut_dir) / name
            if name.lower().endswith(".wav"):
                write_wav(out, kept, sample_rate=model_sr)
            else:
                out.write_bytes(np.asarray(kept, "<i2").tobytes())

    if args.stats:
        wall = time.perf_counter() - t0
        total_audio = float(valid.sum()) * seq / model_sr
        print(
            f"{n_files} files, {total_audio:.1f} s audio in {wall:.2f} s "
            f"({total_audio / wall:.1f}x realtime)",
            file=sys.stderr,
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
