"""Offline corpus mode on the PyTorch/CUDA port: many audio files ->
timestamps, in one batched pass.

Counterpart of vadc_tpu/cli/batch.py. Every file is an independent stream
with its own LSTM state; the corpus is scanned on the device in time slabs
with the state carried from slab to slab, and the segmentation FSM runs
vectorized on the device. A slab is one `forward_scan` of the family: the
front-end and the encoder of every chunk of the slab at once (v3.1's
`encode_fused_audio`; for v4 and v5, `stft_magnitude` and torch-op convs in
pieces of chunks, models/slab.py, v5 with each chunk's 64-sample context
attached), then one kernel that walks each stream's chunks in order
(v3.1's `lstm_decoder_fused`; `lstm_fused` and the decoder). With --device
cuda the streams are sharded over every visible card (engine/shard.py, the
JAX package's mesh over the stream axis), the stream count padded to a
multiple of the card count; with --device cuda:N or cpu they run on that
one device. The lines and cut files do not depend on the sharding.

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
error; it never runs on the CPU instead. With VADC_TPU_PROFILE=<dir> the
run writes a torch.profiler trace and its counters there (tracing.py).

Spans (tracing.zone, recorded while a profiler runs or inside
tracing.record()): `batch.job` around the whole run, in it, from
`load_streams`, `batch.open` (the files opened and sized: `fstat`, the
12-byte RIFF sniff, a .wav input decoded), `batch.pin` (the slab buffer
taken: uninitialised, from torch's pinned-memory cache after the first
job), `batch.read` (the files read into it; the counters `batch.read_bytes`,
the samples' bytes, and `batch.read_direct_files`, the raw files read
straight into their runs, as against a .wav input's decoded copy) and
`batch.grid` (the padding zeroed: past each file's last sample, and the
silent streams); then one `batch.slab` a slab (the next slab's copies
enqueued, the dequant, the scan, with the model's zones in it: v5's
`v5.context`, `v5.spectrum` and `v5.convs`, models/silero_v5.py), the
segmenter's `segmenter.feed` (the counters `segmenter.columns`: the chunk
columns fed, and `segmenter.kernel_columns`: those its kernel stepped, on a
card every one) and `segmenter.finish`, and `batch.output` (the lines and the
cut files).
"""

from __future__ import annotations

import argparse
import os
import resource
import sys
import time
from pathlib import Path

import numpy as np

from vadc_tpu_torch import tracing
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


def slab_buffer(shape: tuple, pin: bool):
    """The slab-major int16 host buffer, uninitialised: pinned for the
    cards, where a job after the first takes the block back from torch's
    pinned-memory cache with the samples of the job before still in it."""
    import torch

    return torch.empty(shape, dtype=torch.int16, pin_memory=pin)


#: buffers one preadv takes (Linux's UIO_MAXIOV)
MAX_IOV = 1024


def _read_runs(fd: int, runs: list, path: str) -> int:
    """Read the file from its start into the buffers `runs`, in order,
    until they are full; a file that ends first is an error. Returns the
    bytes read."""
    want, got = sum(len(r) for r in runs), 0
    while runs:
        step = os.preadv(fd, runs[:MAX_IOV], got)
        if not step:
            raise ValueError(f"{path}: the file shrank while it was read ({got} of {want} bytes)")
        got += step
        while runs and step >= len(runs[0]):
            step -= len(runs.pop(0))
        if step:
            runs[0] = runs[0][step:]
    return got


def load_streams(
    paths: list[str], chunk_samples: int, sample_rate: int = 16000, *,
    slab_chunks: int = 64, shards: int = 1, pin: bool = False,
) -> tuple:
    """Read the files straight into the slab-major buffer that the
    host->device copies read from: int16 [n_slabs, n_streams, slab, chunk],
    the time axis zero-padded to a whole number of slabs and the stream
    count to a multiple of `shards` with silent streams. File i's samples
    of slab k are the one contiguous run `slabs[k, i]`, so a raw file is
    read by one `preadv` into its runs, in order, and nothing but the
    padding is written besides. A .wav input (RIFF magic) is decoded
    (downmixed, resampled to `sample_rate`) and copied into its runs.
    Returns (slabs, per-file emitted chunk counts, per-file sample counts).

    The samples stay int16: the s16 -> f32/32768 conversion runs ON THE
    DEVICE per slab, so int16 is what crosses the host->device link (half
    the bytes), and no whole-corpus float conversion runs on the host."""
    from vadc_tpu_torch.io.wav import is_riff_wave, read_file_s16

    lengths = np.zeros(len(paths), np.int64)
    decoded = {}  # a .wav input's samples, by file
    fds = {}  # raw files held open from their sizing to their read
    keep_open = resource.getrlimit(resource.RLIMIT_NOFILE)[0] // 2
    try:
        with tracing.zone("batch.open"):
            for i, path in enumerate(paths):
                fds[i] = os.open(path, os.O_RDONLY)
                size = os.fstat(fds[i]).st_size
                if is_riff_wave(os.pread(fds[i], 12, 0)):
                    decoded[i] = read_file_s16(path, target_rate=sample_rate)
                    size = 2 * len(decoded[i])
                if i in decoded or len(fds) > keep_open:
                    os.close(fds.pop(i))
                # a raw file's odd trailing byte is dropped
                lengths[i] = size // 2
        valid = -(-lengths // chunk_samples)
        # emission parity with the streaming CLI: a trailing partial chunk is
        # model-processed but not emitted (vadc.c:964 floor semantics)
        emit_valid = lengths // chunk_samples
        t_max = int(valid.max())
        slab = max(1, min(slab_chunks, t_max))
        n_slabs = -(-t_max // slab)
        n_streams = -(-len(paths) // shards) * shards
        run = slab * chunk_samples

        with tracing.zone("batch.pin"):
            slabs = slab_buffer((n_slabs, n_streams, slab, chunk_samples), pin)
        runs = slabs.numpy().reshape(n_slabs, n_streams, run)
        with tracing.zone("batch.read"):
            read = 0
            for i, path in enumerate(paths):
                n = int(lengths[i])
                if i in decoded:
                    for k in range(0, n, run):
                        runs[k // run, i, : min(run, n - k)] = decoded[i][k : k + run]
                    read += 2 * n
                    continue
                fd = fds.pop(i, None)
                if fd is None:
                    fd = os.open(path, os.O_RDONLY)
                try:
                    read += _read_runs(fd, [memoryview(runs[k // run, i, : min(run, n - k)])
                                            .cast("B") for k in range(0, n, run)], path)
                finally:
                    os.close(fd)
            tracing.count("batch.read_bytes", read)
            tracing.count("batch.read_direct_files", len(paths) - len(decoded))
    finally:
        for fd in fds.values():
            os.close(fd)
    with tracing.zone("batch.grid"):
        # the buffer may hold an earlier job's samples: every sample past a
        # file's end, and the silent streams, are zeroed
        for i, n in enumerate(lengths):
            k, rem = divmod(int(n), run)
            if rem:
                runs[k, i, rem:] = 0
                k += 1
            runs[k:, i] = 0
        runs[:, len(paths):] = 0
    return slabs, emit_valid, lengths


def main(argv: list[str] | None = None) -> int:
    try:
        with tracing.profile(), tracing.zone("batch.job", job=True):
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
    # The corpus slab by slab, [n_slabs, B, slab, chunk] int16, in pinned
    # host memory when the devices are cards: each shard's rows of a slab
    # are then one contiguous run that an asynchronous copy takes to its
    # device. The stream count is padded to a multiple of the device count
    # with silent streams that emit nothing (valid 0).
    on_card = device.type == "cuda"
    slabs, valid, lengths = load_streams(args.files, seq, sample_rate=model_sr,
                                         slab_chunks=args.slab_chunks,
                                         shards=runner.n_shards, pin=on_card)
    n_files = len(args.files)
    n_slabs, n_streams = slabs.shape[:2]
    valid_all = np.concatenate([valid, np.zeros(n_streams - n_files, valid.dtype)])

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
    # probabilities of every stream, on a card one kernel launch a slab
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
        with tracing.zone("batch.slab"):
            nxt = h2d(k + 1) if k + 1 < n_slabs else None
            probs, state = runner.scan(dequant(pending), state)
        segmenter.feed(probs)
        pending = nxt

    segments = segmenter.finish(valid_chunks=valid_all)[:n_files]
    with tracing.zone("batch.output"):
        for path, segs in zip(args.files, segments):
            for start, end in segs:
                sys.stdout.write(f"{path}\t{start:.2f},{end:.2f}\n")
        sys.stdout.flush()

        if args.cut_dir is not None:
            # corpus-scale silence removal: slice the kept ranges out of each
            # file's runs of the slabs and write one speech-only file per input
            os.makedirs(args.cut_dir, exist_ok=True)
            written: set[str] = set()
            runs = slabs.numpy()
            for i, (path, segs) in enumerate(zip(args.files, segments)):
                samples = runs[:, i].reshape(-1)[: lengths[i]]
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
