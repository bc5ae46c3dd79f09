#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (vadc_tpu_torch) once on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code 1):
  1. the card's name and power limit; build the CUDA kernels from
     vadc_tpu_torch/kernels/csrc/ with nvcc for sm_90a;
  2. each kernel against its plain PyTorch version on the card, with
     Silero v3.1 weights and synthetic speech: B=2048 chunks of 1536
     samples, B=1, B=37 (a ragged last block), 512-sample chunks;
  3. the main path: StreamRunner.scan over 2048 streams x 8 chunks on the
     card against the same on the CPU (plain versions), then the vadc CLI
     on a 13 s synthetic file with --device cuda and --device cpu
     (identical segments, raw probabilities within 1e-4). The kernels'
     launch counts are set to 0 just before and must be > 0 just after;
  4. timings with CUDA events: each kernel against its plain version, and
     ms per chunk-step of the whole step at batch 2048.

Prints a JSON line of per-kernel results, then as its last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Imports nothing of JAX. Needs one card; exits 1 without one.
"""

from __future__ import annotations

import contextlib
import io
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SR = 16000
B_MAIN = 2048
CHUNK = 1536
SCAN_CHUNKS = 8
SEED = 0
# kernel vs plain on the card: both are fp32; they differ only in the order
# of the sums (tiled FMAs vs cuBLAS) and in expf/tanh implementations
TOL_DOTMAG_REL = 1e-5  # of the largest magnitude
# probs 1e-5. The state passes 14 recurrent cell updates (7 frames x 2
# layers), each an fp32 sum of 128 products: summed in another order, h
# moves by ~1e-5 over 2048 streams (measured on an H100: kernel 1.2e-5; the
# plain version on the card against itself on the CPU, logged beside each
# check, is of the same order), so h and c are held to 5e-5, c relative to
# its largest value (c is an unbounded running sum).
TOL_FUSED = {"probs": 1e-5, "hn": 5e-5, "cn": 5e-5}
# port on the card vs port on the CPU, through the whole model
TOL_PATH = 1e-4


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def voiced(duration_s: float, f0: float = 120.0, amplitude: float = 0.3,
           breath: float = 0.0, rng: np.random.Generator | None = None) -> np.ndarray:
    """Speech-like signal that Silero v3.1 reads as speech: 24 harmonics of
    f0 under three formant envelopes (~500/1500/2500 Hz), a 3 Hz syllabic
    envelope, and optionally a broadband breath floor (relative to the
    peak) that keeps the bins between harmonics off the rounding floor."""
    t = np.arange(int(duration_s * SR)) / SR
    sig = np.zeros_like(t)
    for k in range(1, 25):
        f = k * f0
        w = (np.exp(-((f - 500) / 400) ** 2) + 0.7 * np.exp(-((f - 1500) / 500) ** 2)
             + 0.3 * np.exp(-((f - 2500) / 700) ** 2))
        sig += w * np.sin(2 * np.pi * f * t + k)
    env = 0.5 * (1 + np.sin(2 * np.pi * 3.0 * t - np.pi / 2))
    sig = amplitude * sig * env / np.abs(sig * env).max()
    if breath > 0:
        sig += breath * amplitude * env * rng.normal(size=len(t))
    return sig


def speech_chunks(n: int, chunk: int, seed: int = SEED) -> np.ndarray:
    """n chunks of synthetic speech from `seed`: near-silent gaps of
    0.8-2.5 s and voiced spans of 0.6-3.5 s at f0 140-210 Hz, level
    0.25-0.5, with a breath floor of 2e-3."""
    rng = np.random.default_rng(seed)
    need = n * chunk
    pieces, total = [], 0
    while total < need:
        gap = 0.001 * rng.normal(size=int(rng.uniform(0.8, 2.5) * SR))
        span = voiced(rng.uniform(0.6, 3.5), rng.uniform(140, 210), rng.uniform(0.25, 0.5),
                      breath=2e-3, rng=rng)
        pieces += [gap, span]
        total += len(gap) + len(span)
    return np.concatenate(pieces)[:need].reshape(n, chunk).astype(np.float32)


def max_abs(a, b) -> float:
    return float((a.double() - b.double()).abs().max().item())


def require(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def cuda_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean time of one call of fn on the card, from CUDA events around
    `iters` calls after `warmup` calls."""
    import torch

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


def cuda_ms_pair(a, b) -> tuple[float, float]:
    """Times of a and b taken in turns (a, b, b, a), each the mean of its
    two runs, so a drift of the card's clocks falls on both alike."""
    a1, b1, b2, a2 = cuda_ms(a), cuda_ms(b), cuda_ms(b), cuda_ms(a)
    return (a1 + a2) / 2, (b1 + b2) / 2


def phase_build() -> float:
    from vadc_tpu_torch.kernels import _build

    t0 = time.perf_counter()
    _build.library()
    seconds = time.perf_counter() - t0
    log(f"build: {seconds:.2f} s, nvcc {' '.join(_build.NVCC_FLAGS)}")
    log(f"build: sources {[str(p.relative_to(ROOT)) for p in _build.sources()]}")
    log(f"build: library {_build.build_info['path']}")
    for line in _build.build_info["log"].splitlines():
        if "registers" in line or "smem" in line or "spill" in line or "Compiling" in line:
            log(f"  ptxas: {line.strip()}")
    return seconds


def check_dot_magnitude(params, audio, label: str) -> float:
    from vadc_tpu_torch.kernels.stft_dotmag import (
        dot_magnitude, dot_magnitude_reference, split_basis,
    )
    from vadc_tpu_torch.models import silero_v31
    from vadc_tpu_torch.nn import functional as F

    import torch

    frames = F.frame(
        F.reflect_pad_last(audio, silero_v31.STFT_PAD, silero_v31.STFT_PAD), 256, silero_v31.STFT_HOP
    )
    wr, wi = split_basis(params["stft_basis"])
    out = dot_magnitude(frames, wr, wi)
    ref = dot_magnitude_reference(frames, wr, wi)
    torch.cuda.synchronize()
    require(out.shape == ref.shape, f"dot_magnitude shape {tuple(out.shape)} vs {tuple(ref.shape)}")
    require(bool(torch.isfinite(out).all()), "dot_magnitude: non-finite output")
    err = max_abs(out, ref)
    rel = err / float(ref.abs().max().item())
    log(f"dot_magnitude {label}: shape {tuple(out.shape)} max abs err {err:.3e}, "
        f"relative to max magnitude {rel:.3e} (bound {TOL_DOTMAG_REL:g})")
    require(rel <= TOL_DOTMAG_REL, f"dot_magnitude {label}: relative error {rel:.3e}")
    return err


def check_fused(params, audio, label: str) -> float:
    import torch

    from vadc_tpu_torch.engine.runner import params_to
    from vadc_tpu_torch.kernels.silero_v31_fused2d import (
        forward_fused2d, forward_fused2d_reference,
    )
    from vadc_tpu_torch.models import silero_v31

    b = audio.shape[0]
    feats = silero_v31.features(params, audio)
    # a realistic carried state: one plain step on other audio first
    h0, c0 = silero_v31.init_state(b, audio.device)
    _, h, c = forward_fused2d_reference(params, feats.flip(0).contiguous(), h0, c0)
    probs, hn, cn = forward_fused2d(params, feats, h, c)
    p_ref, h_ref, c_ref = forward_fused2d_reference(params, feats, h, c)
    torch.cuda.synchronize()
    # the rounding floor: the plain version on the CPU against itself on the card
    cpu_params = params_to(params, torch.device("cpu"))
    floor = forward_fused2d_reference(cpu_params, feats.cpu(), h.cpu(), c.cpu())
    errs, bounds, floors = {}, {}, {}
    for i, (name, got, want) in enumerate(
        (("probs", probs, p_ref), ("hn", hn, h_ref), ("cn", cn, c_ref))
    ):
        require(got.shape == want.shape, f"fused {label} {name} shape {tuple(got.shape)}")
        require(bool(torch.isfinite(got).all()), f"fused {label} {name}: non-finite output")
        errs[name] = max_abs(got, want)
        floors[name] = max_abs(floor[i], want.cpu())
        # probs lie in [0, 1] and h in [-1, 1]; the cell state c is an
        # unbounded running sum, so its bound scales with its largest value
        bounds[name] = TOL_FUSED[name] * max(1.0, float(want.abs().max().item()))
    log(f"fused encoder/LSTM/decoder {label}: max abs err "
        + ", ".join(f"{k} {v:.3e} (bound {bounds[k]:.3e}, plain card vs CPU {floors[k]:.3e})"
                    for k, v in errs.items()))
    for name in errs:
        require(errs[name] <= bounds[name], f"fused {label}: {name} {errs[name]:.3e}")
    return max(errs.values())


def phase_kernels(params, device) -> dict:
    import torch

    audio = torch.from_numpy(speech_chunks(B_MAIN, CHUNK)).to(device)
    errs = {
        "dot_magnitude": check_dot_magnitude(params, audio, f"B={B_MAIN} x {CHUNK}"),
        "silero_v31_fused": check_fused(params, audio, f"B={B_MAIN} x {CHUNK}"),
    }
    for b in (1, 37):
        check_dot_magnitude(params, audio[:b], f"B={b} x {CHUNK}")
        check_fused(params, audio[:b], f"B={b} x {CHUNK}")
    short = audio[:, :512].contiguous()
    check_dot_magnitude(params, short, f"B={B_MAIN} x 512")
    check_fused(params, short, f"B={B_MAIN} x 512")
    return errs


def synthetic_file(path: Path) -> None:
    """The verify recipe's file: two voiced spans, about 13 s."""

    def sil(d):
        return 0.001 * np.random.default_rng(1).normal(size=int(d * SR))

    audio = np.concatenate([sil(2), voiced(3), sil(2), voiced(3, 180), sil(2)])
    np.clip(audio * 32768, -32768, 32767).astype("<i2").tofile(path)


def run_cli(argv: list[str], stdin_path: Path) -> str:
    """The CLI in this process on a file as stdin; logs its wall time per
    second of audio (weight loading and the build included)."""
    from vadc_tpu_torch.cli import main as cli

    out, err = io.StringIO(), io.StringIO()
    saved = sys.stdin
    t0 = time.perf_counter()
    with open(stdin_path, "rb") as f:
        sys.stdin = io.TextIOWrapper(f)
        try:
            with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
                rc = cli.main(argv)
        finally:
            sys.stdin = saved
    seconds = time.perf_counter() - t0
    audio_s = stdin_path.stat().st_size / 2 / 16000
    require(rc == 0, f"CLI {argv} exited {rc}: {err.getvalue()}")
    log(f"CLI {' '.join(argv)}: {audio_s:.2f} s of audio in {seconds:.3f} s "
        f"(realtime factor {audio_s / seconds:.1f}x)")
    return out.getvalue()


def phase_main_path(params, device) -> dict:
    import torch

    from vadc_tpu_torch.engine.runner import StreamRunner
    from vadc_tpu_torch.kernels.silero_v31_fused2d import forward_fused2d
    from vadc_tpu_torch.kernels.stft_dotmag import dot_magnitude

    chunks = speech_chunks(B_MAIN * SCAN_CHUNKS, CHUNK, seed=SEED + 100)
    chunks = chunks.reshape(B_MAIN, SCAN_CHUNKS, CHUNK)

    dot_magnitude.launches = 0
    forward_fused2d.launches = 0
    gpu = StreamRunner("v3", params, device=device)
    state = gpu.init_state(B_MAIN)
    probs_gpu, state = gpu.scan(chunks, state)
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        pcm = Path(tmp) / "synthetic.s16le"
        synthetic_file(pcm)
        seg_gpu = run_cli(["--device", "cuda"], pcm)
        raw_gpu = run_cli(["--device", "cuda", "--raw_probabilities"], pcm)
        launches = {
            "dot_magnitude": dot_magnitude.launches,
            "silero_v31_fused": forward_fused2d.launches,
        }
        seg_cpu = run_cli(["--device", "cpu"], pcm)
        raw_cpu = run_cli(["--device", "cpu", "--raw_probabilities"], pcm)
    log(f"main path launches (scan {B_MAIN}x{SCAN_CHUNKS} + 2 CLI runs): {launches}")
    for name, n in launches.items():
        require(n > 0, f"{name}: no launch on the main path")

    t0 = time.perf_counter()
    cpu = StreamRunner("v3", params, device="cpu")
    cstate = cpu.init_state(B_MAIN)
    probs_cpu, cstate = cpu.scan(chunks, cstate)
    log(f"plain CPU scan {B_MAIN}x{SCAN_CHUNKS}: {time.perf_counter() - t0:.1f} s")
    require(probs_gpu.shape == (B_MAIN, SCAN_CHUNKS), f"scan probs shape {tuple(probs_gpu.shape)}")
    require(bool(torch.isfinite(probs_gpu).all()), "scan: non-finite probabilities")
    errs = {
        "probs": max_abs(probs_gpu.cpu(), probs_cpu),
        "h": max_abs(state.h.cpu(), cstate.h),
        "c": max_abs(state.c.cpu(), cstate.c),
    }
    # the cell state is an unbounded running sum: its bound scales with it
    bounds = {"probs": TOL_PATH, "h": TOL_PATH,
              "c": TOL_PATH * max(1.0, float(cstate.c.abs().max().item()))}
    log("scan card vs CPU: max abs err "
        + ", ".join(f"{k} {v:.3e} (bound {bounds[k]:.3e})" for k, v in errs.items())
        + f"; speech share p>0.5: {float((probs_gpu > 0.5).float().mean()):.3f}")
    for k in errs:
        require(errs[k] <= bounds[k], f"scan card vs CPU: {k} {errs[k]:.3e}")

    log(f"CLI segments --device cuda: {seg_gpu.split()}")
    log(f"CLI segments --device cpu:  {seg_cpu.split()}")
    require(seg_gpu == seg_cpu, "CLI segments differ between cuda and cpu")
    require(len(seg_gpu.split()) == 2, f"expected 2 segments, got {seg_gpu!r}")
    pg = np.array([float(x) for x in raw_gpu.split()])
    pc = np.array([float(x) for x in raw_cpu.split()])
    require(pg.shape == pc.shape and pg.size > 0, f"raw probabilities {pg.shape} vs {pc.shape}")
    raw_err = float(np.abs(pg - pc).max())
    log(f"CLI raw probabilities: {pg.size} chunks, max abs diff cuda vs cpu {raw_err:.3e} "
        f"(bound {TOL_PATH:g})")
    require(raw_err <= TOL_PATH, f"CLI raw probabilities differ by {raw_err}")
    return launches


def phase_timing(params, device) -> dict:
    import torch

    from vadc_tpu_torch.engine.runner import StreamRunner
    from vadc_tpu_torch.kernels.silero_v31_fused2d import (
        forward_fused2d, forward_fused2d_reference,
    )
    from vadc_tpu_torch.kernels.stft_dotmag import (
        dot_magnitude, dot_magnitude_reference, split_basis,
    )
    from vadc_tpu_torch.models import silero_v31
    from vadc_tpu_torch.nn import functional as F

    audio = torch.from_numpy(speech_chunks(B_MAIN, CHUNK, seed=SEED + 200)).to(device)
    frames = F.frame(
        F.reflect_pad_last(audio, silero_v31.STFT_PAD, silero_v31.STFT_PAD), 256, silero_v31.STFT_HOP
    )
    wr, wi = split_basis(params["stft_basis"])
    feats = silero_v31.features(params, audio)
    h, c = silero_v31.init_state(B_MAIN, device)
    t = {
        "dot_magnitude": cuda_ms_pair(
            lambda: dot_magnitude(frames, wr, wi),
            lambda: dot_magnitude_reference(frames, wr, wi),
        ),
        "silero_v31_fused": cuda_ms_pair(
            lambda: forward_fused2d(params, feats, h, c),
            lambda: forward_fused2d_reference(params, feats, h, c),
        ),
    }
    for name, (k, p) in t.items():
        log(f"time {name} B={B_MAIN}: kernel {k:.4f} ms, plain {p:.4f} ms")
    front_ms = cuda_ms(lambda: silero_v31.features(params, audio))
    runner = StreamRunner("v3", params, device=device)
    state = runner.init_state(B_MAIN)
    step_ms, plain_ms = cuda_ms_pair(
        lambda: runner.step(audio, state),
        lambda: silero_v31.forward_reference(params, audio, h, c),
    )
    log(f"front-end (reflect pad, unfold, dot_magnitude kernel, adaptive norm) "
        f"B={B_MAIN}: {front_ms:.4f} ms")
    log(f"ms per chunk-step B={B_MAIN}x{CHUNK}: kernels {step_ms:.4f} ms, plain {plain_ms:.4f} ms; "
        f"realtime streams at the kernel rate: {B_MAIN * (CHUNK / 16000) / (step_ms / 1000):.0f}")
    return {"kernels": t, "step_ms": step_ms, "plain_step_ms": plain_ms}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible to PyTorch", file=sys.stderr)
        return 1
    from vadc_tpu_torch.models.weights import load_params
    from vadc_tpu_torch.runtime import require_cuda
    from vadc_tpu_torch.cli.main import DEFAULT_WEIGHTS

    smi = nvidia_smi()
    log(f"card: {smi}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")
    device = require_cuda()
    phase_build()
    _, params = load_params(DEFAULT_WEIGHTS, device=device)

    errs = phase_kernels(params, device)
    launches = phase_main_path(params, device)
    timing = phase_timing(params, device)

    sources = {
        "dot_magnitude": ("vadc_tpu_torch/kernels/csrc/stft_dotmag.cu",
                          "vadc_tpu/kernels/stft_dotmag.py:56"),
        "silero_v31_fused": ("vadc_tpu_torch/kernels/csrc/silero_v31_fused.cu",
                             "vadc_tpu/kernels/silero_v31_fused2d.py:232"),
    }
    kernels = []
    for name, (src, replaces) in sources.items():
        ms, plain_ms = timing["kernels"][name]
        entry = {"name": name, "route": "cuda", "source": src, "replaces": replaces,
                 "launches": launches[name], "max_abs_err": errs[name],
                 "ms": ms, "plain_ms": plain_ms}
        if name == "silero_v31_fused":
            entry["also_replaces"] = "vadc_tpu/kernels/silero_v31_fused3d.py:178"
        kernels.append(entry)
    log(json.dumps({"kernels": kernels}))
    log(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
