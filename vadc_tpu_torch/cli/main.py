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

plus the JAX CLI's [--precision faithful|balanced|fast|turbo] (the bf16
tiers for Silero v3.1; v4 and v5 run faithful only), [--sr 16000|8000] and
[--onnx_exec], and [--device cuda|cpu] (default cuda). With --device cuda
and no card the CLI exits 1 with a one-line error; it never runs on the CPU
instead.

--model takes a .testtensor archive of any family (v3, v4, v4_8k, v5,
v5_8k) or an .onnx graph: a plain v3 graph, or a fused v4/v5 graph whose
--sr branch is extracted. The 8 kHz families segment at 8 kHz and decode
wav input to 8 kHz; raw PCM on stdin is taken to be at the model's rate.
--onnx_exec runs the .onnx graph itself through the numpy graph executor,
on the host whatever --device says (the reference's CPU-speed
compatibility path). When a recognized graph defeats weight extraction the
CLI falls back to that executor with --device cpu; with --device cuda it
exits 1 instead of running on the host.

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
# What --raw_probabilities at fast/turbo says of the deviation from fp32:
# the port's own measurement on the card, with the card named (chip_smoke.py's
# survey of twelve synthetic speech tracks, the largest deviation of each tier)
RAW_NOTE = {"fast": "up to 2.2e-2", "turbo": "up to 1.7e-1"}
RAW_NOTE_CARD = "over 12 synthetic speech tracks on an NVIDIA H100 80GB HBM3 at 700.00 W"


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
                        "v4, v4_8k, v5, v5_8k) or an .onnx graph "
                        "(default: bundled Silero v3.1 16k)")
    p.add_argument("--precision", choices=PRECISIONS, default="faithful",
                   help="precision tier (default faithful, fp32); the bf16 "
                        "tiers balanced, fast and turbo run Silero v3.1")
    p.add_argument("--sr", type=int, choices=(16000, 8000), default=None,
                   help="sample-rate branch of fused v4/v5 .onnx models "
                        "(they carry both). Testtensor archives carry their "
                        "own rate")
    p.add_argument("--onnx_exec", action="store_true",
                   help="run the .onnx graph itself through the numpy graph "
                        "executor, on the host (CPU-speed compatibility "
                        "path). Also the fallback, with --device cpu, when a "
                        "recognized graph defeats weight extraction")
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


def _make_exec_runner(weights_path: Path, args):
    """The numpy graph executor's runner (engine/onnx_backend), clamping
    --sequence_count against the graph's declared restriction."""
    from vadc_tpu_torch.engine.onnx_backend import OnnxExecRunner

    runner = OnnxExecRunner(
        weights_path, chunk_samples=int(args.sequence_count), sample_rate=int(args.sr or 16000)
    )
    r = runner.restrictions
    print(
        "graph introspection: "
        f"batch={'unrestricted' if r.batch < 0 else r.batch}, "
        f"sequence={'unrestricted' if r.sequence < 0 else r.sequence}, "
        f"hidden={r.hidden}, sr_input={r.has_sr_input}",
        file=sys.stderr,
    )
    print("graph executor: numpy on the host, whatever --device says "
          "(CPU-speed compatibility path)", file=sys.stderr)
    return runner


def _load_or_fall_back(weights_path: Path, args, device):
    """(family, params, None) from the weight extractors, or (None, None,
    runner) of the graph executor when a recognized .onnx graph defeats
    extraction and the device is the CPU (vadc_tpu/cli/main.py's fallback).
    On a CUDA device that failure is an error: the card was asked for."""
    from vadc_tpu_torch.models.weights import load_params

    try:
        family, params = load_params(weights_path, device=device,
                                     sample_rate=int(args.sr or 16000))
        return family, params, None
    except Exception as e:
        if weights_path.suffix.lower() != ".onnx":
            raise
        from vadc_tpu_torch.export.onnx_extract import classify_model

        try:
            classify_model(weights_path)
        except ValueError:
            raise e from None  # not a graph of a known family: that error
        if device.type != "cpu":
            raise ValueError(
                f"weight extraction failed ({type(e).__name__}: {e}); the numpy "
                "graph executor runs on the host, not on the card: pass --onnx_exec "
                "(or --device cpu) to run it"
            ) from None
        print(f"weight extraction failed ({type(e).__name__}: {e}); falling back "
              "to the numpy graph executor (slow path, --onnx_exec)", file=sys.stderr)
        return None, None, _make_exec_runner(weights_path, args)


def _main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)

    from vadc_tpu_torch.engine.runner import MinibatchRunner
    from vadc_tpu_torch.models.weights import clamp_sequence_count
    from vadc_tpu_torch.runtime import resolve_device

    device = resolve_device(args.device)
    weights_path = Path(args.model) if args.model else DEFAULT_WEIGHTS
    if not weights_path.exists():
        raise FileNotFoundError(f"no weight archive at {weights_path}")
    runner = None
    if args.onnx_exec:
        if weights_path.suffix.lower() != ".onnx":
            raise ValueError("--onnx_exec requires --model <file.onnx>")
        runner = _make_exec_runner(weights_path, args)
    else:
        family, params, runner = _load_or_fall_back(weights_path, args, device)
    if runner is None:
        if family == "v5":
            print("Model arch is Silero v5", file=sys.stderr)
        seq = clamp_sequence_count(family, int(args.sequence_count))
        print(f"Running with batch size {args.batch}", file=sys.stderr)
        print(f"Running with sequence count {seq}", file=sys.stderr)
        runner = MinibatchRunner(
            family, params, batch_size=int(args.batch), chunk_samples=seq,
            device=device, precision=args.precision,
        )
    else:
        seq = runner.chunk_samples
        print(f"Running with sequence count {seq} (graph-executor backend)", file=sys.stderr)
    if args.raw_probabilities and args.precision in ("fast", "turbo"):
        print(f"note: --raw_probabilities at --precision {args.precision}: "
              f"probabilities deviate from fp32 on speech material ({RAW_NOTE[args.precision]} "
              f"{RAW_NOTE_CARD}); use "
              "balanced or faithful for probability-faithful output", file=sys.stderr)
    # the 8 kHz families time chunks (and decode wav input) at their own rate
    model_sr = runner.module.SAMPLE_RATE
    if args.sr and model_sr != args.sr:
        print(f"note: --sr {args.sr} ignored — this weight archive is a {model_sr} Hz "
              "model (the flag selects the branch of fused .onnx models)", file=sys.stderr)
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
