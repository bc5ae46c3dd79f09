"""Cut silence out of an audio file natively, on the PyTorch/CUDA port: no
ffmpeg round trip. Counterpart of vadc_tpu/cli/cut.py (script vadc-torch-cut).

The reference's silence-removal story is a three-stage pipeline (vadc ->
filter_script.c -> ffmpeg re-encode, see silenceremove.bat and
README.md:139-149 in the reference). With the native wav codec (io/wav.py)
the whole thing collapses into one tool:

    python -m vadc_tpu_torch.cli.cut noisy.wav clean.wav
    python -m vadc_tpu_torch.cli.cut raw.s16le clean.s16le --threshold 0.6 --device cpu

Input: .wav (any rate/bits/channels, decoded and resampled natively) or raw
model-rate mono s16le (sniffed by magic, not extension). Output format
picked by extension: .wav -> 16-bit mono wav at the model rate, anything
else -> raw s16le. Segment selection uses the same hysteresis FSM and flags
as the main CLI, through the port's api; kept ranges are the padded and
merged segments, cut at sample precision. --device defaults to cuda; with
no card the tool exits 1 with a one-line error and never runs on the CPU
instead.

The ffmpeg filterscript path (cli/filter_script.py) remains for
re-encoding compressed formats; this tool is the zero-dependency fast path
for PCM material.
"""

from __future__ import annotations

import argparse
import sys

from vadc_tpu_torch.runtime import PRECISIONS


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="vadc-torch-cut",
        description="Remove non-speech audio from a file using Silero VAD "
        "on PyTorch and CUDA (native decode; no ffmpeg).",
    )
    p.add_argument("input", help=".wav or raw model-rate mono s16le")
    p.add_argument("output", help="output path (.wav -> wav, else raw s16le)")
    p.add_argument("--min_silence", type=float, default=200.0)
    p.add_argument("--min_speech", type=float, default=250.0)
    p.add_argument("--threshold", type=float, default=0.5)
    p.add_argument("--neg_threshold_relative", type=float, default=0.15)
    p.add_argument("--speech_pad", type=float, default=30.0)
    p.add_argument("--sequence_count", type=int, default=1536)
    p.add_argument("--model", default=None)
    p.add_argument("--precision", default="faithful", choices=PRECISIONS)
    p.add_argument("--stats", action="store_true",
                   help="print kept/total durations to stderr")
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (default), cuda:N or cpu")
    return p


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)

    import numpy as np

    from vadc_tpu_torch import api
    from vadc_tpu_torch.cli.segmenter import slice_segments
    from vadc_tpu_torch.io.wav import read_file_s16, write_wav

    try:
        # api._get_runner caches the loaded weights, so the
        # detect_speech_samples call below reuses this runner
        runner, _seq = api._get_runner(args.model, args.sequence_count, args.precision,
                                       args.device)
    except (FileNotFoundError, ValueError, RuntimeError) as e:
        # RuntimeError: runtime.NoCudaDeviceError, or a device torch refuses
        print(f"Error: {e}", file=sys.stderr)
        return 1
    model_sr = getattr(runner.module, "SAMPLE_RATE", 16000)

    # fail fast on an unwritable output BEFORE the (expensive) inference;
    # append mode probes writability without truncating an existing file
    try:
        with open(args.output, "ab"):
            pass
    except OSError as e:
        print(f"Error: cannot write output ({e})", file=sys.stderr)
        return 1

    try:
        samples = read_file_s16(args.input, target_rate=model_sr)
    except (OSError, ValueError) as e:
        # ValueError covers WavFormatError (malformed/unsupported wav)
        print(f"Error: BS_Error_CantOpenFile ({e})", file=sys.stderr)
        return 1

    segments = api.detect_speech_samples(
        samples.astype(np.float32) / 32768.0,
        model=args.model,
        sequence_count=args.sequence_count,
        precision=args.precision,
        device=args.device,
        min_silence_ms=args.min_silence,
        min_speech_ms=args.min_speech,
        threshold=args.threshold,
        neg_threshold_relative=args.neg_threshold_relative,
        speech_pad_ms=args.speech_pad,
    )
    kept = slice_segments(samples, segments, model_sr)

    if args.output.lower().endswith(".wav"):
        write_wav(args.output, kept, sample_rate=model_sr)
    else:
        with open(args.output, "wb") as fh:
            fh.write(np.asarray(kept, "<i2").tobytes())

    if args.stats:
        total = len(samples) / model_sr
        kept_s = len(kept) / model_sr
        pct = 100.0 * kept_s / total if total else 0.0
        print(
            f"kept {kept_s:.2f}s of {total:.2f}s ({pct:.1f}%) across "
            f"{len(segments)} segment(s)",
            file=sys.stderr,
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
