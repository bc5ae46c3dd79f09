"""Long-stream soak of the PyTorch/CUDA port: the counterpart of
tools/soak.py. Minutes to hours of audio through the CLI's window loop with
a memory-growth bound — the claim behind "unbounded audio length" (constant
host RSS, device state of fixed shape).

Streams synthetic audio window by window through MinibatchRunner +
Segmenter exactly like vadc_tpu_torch/cli/main.py's loop (no subprocess),
and reports throughput plus RSS at warm-up and at the end. Exits 1 if RSS
grew more than --max_growth_mb after warm-up. Runs on the card unless
`--device cpu` is given (without a card it exits 1 with one line).
Imports nothing of JAX or of vadc_tpu.

    python tools/torch_soak.py --minutes 60 [--precision fast] [--batch 96]
    python tools/torch_soak.py --device cpu --minutes 0.2   # host smoke
"""

from __future__ import annotations

import argparse
import resource
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def rss_mb() -> float:
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0


def soak(*, minutes: float = 60.0, precision: str = "fast", batch: int = 96,
         sequence_count: int = 1536, model: str | None = None, warmup_windows: int = 5,
         device="cuda") -> dict:
    """The soak's loop; returns its numbers (audio seconds, wall seconds,
    realtime factor, segments, windows, RSS at warm-up and at the end)."""
    from vadc_tpu_torch.cli.main import WINDOW_CHUNKS
    from vadc_tpu_torch.cli.segmenter import Segmenter, SegmenterConfig
    from vadc_tpu_torch.engine.runner import MinibatchRunner
    from vadc_tpu_torch.io.synthaudio import voiced
    from vadc_tpu_torch.models.weights import DEFAULT_WEIGHTS, clamp_sequence_count, load_params
    from vadc_tpu_torch.runtime import resolve_device

    device = resolve_device(device)
    family, params = load_params(Path(model) if model else DEFAULT_WEIGHTS, device=device)
    seq = clamp_sequence_count(family, sequence_count)
    runner = MinibatchRunner(family, params, batch_size=batch, chunk_samples=seq, device=device,
                             precision=precision)
    model_sr = getattr(runner.module, "SAMPLE_RATE", 16000)
    seg = Segmenter(SegmenterConfig.from_ms(chunk_samples=seq, sample_rate=model_sr))
    window = seq * WINDOW_CHUNKS
    total_windows = max(int(minutes * 60 * model_sr / window) + 1, warmup_windows + 2)

    rng = np.random.default_rng(0)
    # alternating noise/speech windows so the FSM opens and closes
    # segments continuously (exercises the emit path, not just the model)
    speech = voiced(window / model_sr, sr=model_sr)[:window].astype(np.float32)
    n_seg = 0
    rss_warm = None
    t0 = time.perf_counter()
    for w in range(total_windows):
        if w % 3 == 2:
            x = speech
        else:
            x = (0.02 * rng.normal(size=window)).astype(np.float32)
        for prob in runner.process_window(x):
            n_seg += sum(1 for _ in seg.feed(prob))
        if w + 1 == warmup_windows:
            rss_warm = rss_mb()
    dt = time.perf_counter() - t0
    audio_s = total_windows * window / model_sr
    rss_end = rss_mb()
    return {"family": family, "precision": precision, "device": str(device),
            "windows": total_windows, "audio_seconds": audio_s, "wall_seconds": dt,
            "realtime_x": audio_s / dt, "segments": n_seg, "rss_warm_mb": rss_warm,
            "rss_end_mb": rss_end, "rss_growth_mb": rss_end - rss_warm}


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--minutes", type=float, default=60.0)
    p.add_argument("--precision", default="fast",
                   choices=("faithful", "balanced", "fast", "turbo"))
    p.add_argument("--batch", type=int, default=96)
    p.add_argument("--sequence_count", type=int, default=1536)
    p.add_argument("--model", default=None)
    p.add_argument("--max_growth_mb", type=float, default=64.0,
                   help="fail if RSS grows more than this after warmup")
    p.add_argument("--warmup_windows", type=int, default=5)
    p.add_argument("--device", default="cuda",
                   help="cuda (the default: the card, or exit 1 without one) or cpu")
    args = p.parse_args(argv)

    from vadc_tpu_torch.runtime import NoCudaDeviceError

    try:
        r = soak(minutes=args.minutes, precision=args.precision, batch=args.batch,
                 sequence_count=args.sequence_count, model=args.model,
                 warmup_windows=args.warmup_windows, device=args.device)
    except NoCudaDeviceError as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1
    print(
        f"soak: {r['audio_seconds'] / 60:.1f} min audio in {r['wall_seconds']:.1f} s "
        f"({r['realtime_x']:.1f}x realtime, single stream, {r['device']}), "
        f"{r['segments']} segments, RSS {r['rss_warm_mb']:.0f} -> {r['rss_end_mb']:.0f} MB "
        f"(growth {r['rss_growth_mb']:.1f} MB after warmup)",
        file=sys.stderr,
    )
    if r["rss_growth_mb"] > args.max_growth_mb:
        print(f"FAIL: RSS grew {r['rss_growth_mb']:.1f} MB > {args.max_growth_mb} MB",
              file=sys.stderr)
        return 1
    print("SOAK PASSED", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
