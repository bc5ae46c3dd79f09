"""vadc-compatible command line on the PyTorch/CUDA port: audio in (s16le PCM
on stdin, .wav decoded natively, any other media file via ffmpeg), speech
segment timestamps out on stdout.

Counterpart of vadc_tpu/cli/main.py with the reference's 13 flags
(vadc.c:1110-1124):

    vadc [file] [--min_silence MS] [--min_speech MS] [--threshold P]
         [--neg_threshold_relative P] [--speech_pad MS] [--batch N]
         [--sequence_count N] [--audio_source N] [--start_seconds S]
         [--raw_probabilities] [--stats] [--output_centi_seconds]
         [--model PATH]

plus [--precision faithful] (the only tier ported so far) and
[--device cuda|cpu] (default cuda). With --device cuda and no card the CLI
exits 1 with a one-line error; it never runs on the CPU instead.

--model takes a .testtensor archive of any family (v3, v4, v4_8k, v5,
v5_8k) or a plain v3 .onnx graph. The 8 kHz families segment at 8 kHz and
decode wav input to 8 kHz; raw PCM on stdin is taken to be at the model's
rate.

Ingest, segmentation and stats are the port's copies of the JAX package's
numpy-only modules (io/, cli/segmenter.py, cli/stats.py).
Output discipline: stdout carries only data; everything else goes to stderr.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

from vadc_tpu_torch.cli.segmenter import (
    Segmenter,
    SegmenterConfig,
    format_segment_centiseconds,
    format_segment_seconds,
)
from vadc_tpu_torch.cli.stats import Stats
from vadc_tpu_torch.io.ffmpeg import FFmpegSource
from vadc_tpu_torch.io.pcm import BYTES_PER_SAMPLE, BSError, BufferedStream, s16le_to_f32
from vadc_tpu_torch.io.wav import PrependStream, WavFormatError, WavSource, is_riff_wave, sniff_media_head
from vadc_tpu_torch.models.weights import DEFAULT_WEIGHTS
from vadc_tpu_torch.runtime import PRECISIONS, NoCudaDeviceError

# Window of chunks processed per refill (reference vadc.c:799: 96 chunks).
WINDOW_CHUNKS = 96


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="vadc-torch",
        description="Streaming voice activity detection (Silero VAD v3.1, v4, "
        "v5) on PyTorch and CUDA.",
    )
    p.add_argument("filename", nargs="?", default=None,
                   help="input media file (.wav decoded natively; anything "
                        "else via ffmpeg); omit to read raw s16le 16 kHz "
                        "mono PCM from stdin")
    p.add_argument("--min_silence", type=float, default=200.0,
                   help="minimum silence duration in ms to close a segment")
    p.add_argument("--min_speech", type=float, default=250.0,
                   help="minimum speech duration in ms to keep a segment")
    p.add_argument("--threshold", type=float, default=0.5,
                   help="speech trigger probability threshold")
    p.add_argument("--neg_threshold_relative", type=float, default=0.15,
                   help="exit threshold = threshold - this value")
    p.add_argument("--speech_pad", type=float, default=30.0,
                   help="pad emitted segments by this many ms on both sides")
    p.add_argument("--batch", type=int, default=96,
                   help="chunks per model batch")
    p.add_argument("--sequence_count", type=int, default=1536,
                   help="chunk size in samples (multiple of 256 in [512,1536])")
    p.add_argument("--audio_source", type=int, default=0,
                   help="audio stream index for ffmpeg -map")
    p.add_argument("--start_seconds", type=float, default=0.0,
                   help="seek offset")
    p.add_argument("--raw_probabilities", action="store_true",
                   help="print one probability per chunk instead of segments")
    p.add_argument("--stats", action="store_true",
                   help="print realtime-factor stats to stderr")
    p.add_argument("--output_centi_seconds", action="store_true",
                   help="print integer centiseconds instead of seconds")
    p.add_argument("--model", type=str, default=None,
                   help="path to a .testtensor archive of any family (v3, "
                        "v4, v4_8k, v5, v5_8k) or a v3 .onnx graph "
                        "(default: bundled Silero v3.1 16k)")
    p.add_argument("--precision", choices=PRECISIONS, default="faithful",
                   help="precision tier; only faithful (fp32) is ported")
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (default), cuda:N or cpu")
    return p


def main(argv: list[str] | None = None) -> int:
    try:
        return _main(argv)
    except (FileNotFoundError, ValueError, NotImplementedError, NoCudaDeviceError) as e:
        # one-line errors for the common failure modes (missing model file,
        # unported family or tier, no card), as the reference does
        print(f"Error: {e}", file=sys.stderr)
        return 1
    except BrokenPipeError:
        return 0
    except KeyboardInterrupt:
        return 130


def _main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)

    from vadc_tpu_torch.engine.runner import MinibatchRunner
    from vadc_tpu_torch.models.weights import clamp_sequence_count, load_params
    from vadc_tpu_torch.runtime import check_precision, resolve_device

    check_precision(args.precision)
    device = resolve_device(args.device)
    weights_path = Path(args.model) if args.model else DEFAULT_WEIGHTS
    if not weights_path.exists():
        raise FileNotFoundError(f"no weight archive at {weights_path}")
    family, params = load_params(weights_path, device=device)
    if family == "v5":
        print("Model arch is Silero v5", file=sys.stderr)
    seq = clamp_sequence_count(family, int(args.sequence_count))
    print(f"Running with batch size {args.batch}", file=sys.stderr)
    print(f"Running with sequence count {seq}", file=sys.stderr)
    runner = MinibatchRunner(
        family, params, batch_size=int(args.batch), chunk_samples=seq,
        device=device, precision=args.precision,
    )
    # the 8 kHz families time chunks (and decode wav input) at their own rate
    model_sr = runner.module.SAMPLE_RATE
    seg_config = SegmenterConfig.from_ms(
        chunk_samples=seq,
        sample_rate=model_sr,
        min_silence_ms=args.min_silence,
        min_speech_ms=args.min_speech,
        threshold=args.threshold,
        neg_threshold_relative=args.neg_threshold_relative,
        speech_pad_ms=args.speech_pad,
    )
    segmenter = Segmenter(seg_config)
    stats = Stats(output_enabled=args.stats, sample_rate=model_sr)
    fmt = format_segment_centiseconds if args.output_centi_seconds else format_segment_seconds

    def emit(start: float, end: float) -> None:
        stats.add_speech(start, end)
        sys.stdout.write(fmt(start, end) + "\n")
        sys.stdout.flush()
        stats.print_line()

    window_samples = seq * WINDOW_CHUNKS
    stream_failed = False

    def run(stream, eof_error_check=None) -> None:
        """Ingest loop over a latched-error BufferedStream (reference
        vadc.c:852-999); a latched failure other than the clean EndOfFile
        makes the process exit nonzero."""
        nonlocal stream_failed
        bs = BufferedStream(stream, window_samples * BYTES_PER_SAMPLE,
                            eof_error_check=eof_error_check)
        while True:
            data, err = bs.refill()
            if err != BSError.NoError:
                print(f"Error: BS_Error_{err.name}", file=sys.stderr)
                if err != BSError.EndOfFile:
                    stream_failed = True
                break
            if len(data) % BYTES_PER_SAMPLE:
                data = data[:-1]  # drop trailing odd byte
            samples = s16le_to_f32(data)
            valid = samples.shape[0]
            stats.add_samples(valid)
            if valid < window_samples:
                window = np.zeros(window_samples, np.float32)
                window[:valid] = samples
            else:
                window = samples
            probs = runner.process_window(window)
            # floor(values_read / input_count) probabilities per window (the
            # reference's emit rule, vadc.c:964): the zero-padded remainder
            # of a short window advances state but is never emitted
            for prob in probs[: valid // seq]:
                if args.raw_probabilities:
                    sys.stdout.write(f"{prob:f}\n")
                else:
                    for s, e in segmenter.feed(prob):
                        emit(s, e)
            if args.raw_probabilities:
                sys.stdout.flush()
            stats.print_line()

    def run_wav(source, where: str, start_seconds: float = 0.0,
                can_fall_back: bool = False) -> int | None:
        """Native wav branch; None when the header is unsupported and a
        file input can retry through ffmpeg."""
        wav = WavSource(source, target_rate=model_sr, start_seconds=start_seconds)
        try:
            stream = wav.__enter__()
        except WavFormatError as e:
            if can_fall_back:
                print(f"note: native wav decode unavailable ({e}); "
                      "falling back to ffmpeg", file=sys.stderr)
                return None
            print(f"Error: BS_Error_CantOpenFile ({e})", file=sys.stderr)
            return 1
        try:
            f = wav.format
            print(f"wav input{where}: {f.sample_rate} Hz, {f.channels} ch, "
                  f"{f.bits_per_sample}-bit {f.codec_name} -> {model_sr} Hz mono "
                  "(native decode)", file=sys.stderr)
            run(stream)
        except WavFormatError as e:
            print(f"Error: BS_Error_CantOpenFile ({e})", file=sys.stderr)
            return 1
        finally:
            wav.__exit__(None, None, None)
        return 0

    if args.filename:
        try:
            _is_regular, head = sniff_media_head(args.filename)
        except OSError as e:
            print(f"Error: BS_Error_CantOpenFile ({e})", file=sys.stderr)
            return 1
        use_ffmpeg = not is_riff_wave(head)
        if not use_ffmpeg:
            if args.audio_source:
                print("note: --audio_source ignored for wav input "
                      "(single audio stream)", file=sys.stderr)
            rc = run_wav(args.filename, "", start_seconds=args.start_seconds,
                         can_fall_back=True)
            if rc is None:
                use_ffmpeg = True
            elif rc:
                return rc
        if use_ffmpeg:
            source = FFmpegSource(args.filename, audio_source=args.audio_source,
                                  start_seconds=args.start_seconds, sample_rate=model_sr)
            try:
                with source as stream:
                    run(stream, eof_error_check=source.eof_error_kind)
            except FileNotFoundError:
                print("Error: BS_Error_CantOpenFile (ffmpeg not found — non-wav "
                      "inputs need ffmpeg on PATH; .wav decodes natively)",
                      file=sys.stderr)
                return 1
    else:
        # stdin: raw s16le by contract, but a RIFF header is sniffed and the
        # wav decoded natively
        head = sys.stdin.buffer.read(12)
        if is_riff_wave(head):
            if args.audio_source:
                print("note: --audio_source ignored for wav input "
                      "(single audio stream)", file=sys.stderr)
            rc = run_wav(PrependStream(head, sys.stdin.buffer), " on stdin",
                         start_seconds=args.start_seconds)
            if rc:
                return rc
        else:
            run(PrependStream(head, sys.stdin.buffer))

    if not args.raw_probabilities:
        for s, e in segmenter.finish():
            emit(s, e)
    stats.print_line(final=True)
    return 1 if stream_failed else 0


if __name__ == "__main__":
    sys.exit(main())
