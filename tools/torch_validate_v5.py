"""One-command validation harness for a Silero v5 .onnx file on the
PyTorch/CUDA port: the counterpart of tools/validate_v5.py.

    python tools/torch_validate_v5.py /path/to/silero_vad_v5.onnx

It runs, for BOTH sample-rate branches (16 kHz and 8 kHz):
  1. marker-based classification (must say v5 — onnx_helpers.c:154-161);
  2. weight extraction into the runtime archive schema;
  3. the numpy ONNX graph executor on random audio with LSTM state threaded
     across consecutive chunks (the role ORT plays for the reference,
     onnx_helpers.c:532-549);
  4. the port's forward (`silero_v5.forward`, `v5_8k.forward`) on the same
     audio and state, on the device: on the card it launches the
     stft_magnitude and lstm_fused kernels;
and prints a per-chunk probability fidelity report with the reference
harness's error-magnitude buckets (test.c:70-130). Exit code 0 iff every
probability matches within --atol (default 1e-5), 2 when one does not or
the graph is no v5 graph, 1 when the file is missing or no card is there.

Runs on the card unless `--device cpu` is given. Imports nothing of JAX or
of vadc_tpu. tests/test_torch_tools_stages.py runs it end to end against
an executable synthetic official-topology v5 graph (export/onnx_build.py).

Importable: validate(path, atol, chunks=4, device=...) returns True iff
every chunk matched.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np


def bucket(err: float) -> str:
    if err == 0.0:
        return "zero"
    for exp in range(-10, 1):
        if err <= 10.0**exp:
            return f"<=1e{exp}"
    return "above 1"


def validate(path: Path, atol: float, chunks: int = 4, batch: int = 3, device="cuda") -> bool:
    import torch

    from vadc_tpu_torch.export.onnx_exec import OnnxExecutor, run_silero_onnx
    from vadc_tpu_torch.export.onnx_extract import classify_model
    from vadc_tpu_torch.export.silero_v5_from_onnx import extract_silero_v5
    from vadc_tpu_torch.models import silero_v5
    from vadc_tpu_torch.models.weights import load_params_from_tensors
    from vadc_tpu_torch.runtime import on_device, resolve_device

    device = resolve_device(device)
    family = classify_model(path)
    print(f"classified: {family}")
    if family != "v5":
        print(f"FAIL: expected a v5 graph, got {family}", file=sys.stderr)
        return False

    ok = True
    executor = OnnxExecutor.from_path(path)  # parse the protobuf once
    for sr in (16000, 8000):
        fam, params = load_params_from_tensors(extract_silero_v5(path, sr), device=device)
        mod = silero_v5 if sr == 16000 else silero_v5.v5_8k
        window = mod.WINDOW_SAMPLES + mod.CONTEXT_SAMPLES
        rng = np.random.default_rng(42)
        h = np.zeros((1, batch, 128), np.float32)
        c = np.zeros((1, batch, 128), np.float32)
        ht, ct = torch.from_numpy(h).to(device), torch.from_numpy(c).to(device)
        print(f"-- {sr} Hz branch (family {fam}, {chunks} chunks x batch {batch})")
        for step in range(chunks):
            audio = (0.2 * rng.normal(size=(batch, window))).astype(np.float32)
            out, h, c = run_silero_onnx(
                path, audio, state=(h, c), sample_rate=sr, executor=executor
            )
            with on_device(device), torch.no_grad():
                p, ht, ct = mod.forward(params, torch.from_numpy(audio).to(device), ht, ct)
            err = float(np.max(np.abs(p.cpu().numpy().ravel() - out.ravel())))
            status = "ok" if err <= atol else "FAIL"
            print(f"  chunk {step}: max prob error {err:.3e}  [{bucket(err)}]  {status}")
            ok &= err <= atol
    return ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("model", type=Path, help="path to silero_vad_v5.onnx")
    ap.add_argument("--atol", type=float, default=1e-5)
    ap.add_argument("--chunks", type=int, default=4)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default: the card, or exit 1 without one) or cpu")
    args = ap.parse_args(argv)

    from vadc_tpu_torch.runtime import NoCudaDeviceError, resolve_device

    try:
        device = resolve_device(args.device)
    except NoCudaDeviceError as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1
    if not args.model.exists():
        print(f"Error: {args.model} not found", file=sys.stderr)
        return 1
    ok = validate(args.model, args.atol, chunks=args.chunks, device=device)
    print("V5 VALIDATION " + ("PASSED" if ok else "FAILED"))
    return 0 if ok else 2


if __name__ == "__main__":
    sys.exit(main())
