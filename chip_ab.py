#!/usr/bin/env python3
"""Time the kernels of the PyTorch/CUDA port through their wrappers, and the
v3.1 paths built on them, in the tree of the current directory, on one
NVIDIA card.

    cd <a checkout> && python3 <path to>/chip_ab.py

To compare two commits on one card, unpack each with `git archive` into a
directory of its own and run this script from each in turns on one card,
one run right after the other (parent, change, change, parent): it imports
`vadc_tpu_torch` from the current directory, whichever tree that is, builds
that tree's kernels and prints one line: the directory's name, the card and
its power limit, then ms per call (CUDA events; the timer and the seeded
speech are chip_smoke.py's, taken from beside this script):

  - the fused v3.1 kernels: `forward_fused` at B = 2048, 64, 1 x 1536 samples
    and 2048 x 512; `forward_fused2d` at 2048 x 25 frames; `encode_fused` at
    4096 rows; `encode_fused_audio` at 4096 and 16384 rows (where the tree
    has that entry);
  - the spectrum kernels `dot_magnitude` and `stft_magnitude` at 2048 x 1536
    (the v3.1 geometry, pads 128/128); `stft_magnitude` at the geometries of
    the four v4/v5 families at B = 2048 (v4 x 1536, v4_8k x 768, v5 x 576
    and v5_8k x 288, the context attached) and at the v4 CLI window (96 x
    1536), and its digests there (chip_smoke.stft_digests); beside them, as
    a yardstick of the product alone, cuBLAS's fp32 `torch.matmul` of the
    contiguous frames [rows, 256] with the bases [256, 258] (no TF32; no
    magnitude, the [rows, 258] product written out) at the v4 and the v3.1
    shapes;
  - the v4 and v5 `StreamRunner.step` at B = 2048, and the v4 CLI window
    (`silero_v4.forward_minibatched`, 96 chunks of one stream);
  - the v3.1 paths: `StreamRunner.scan` over a 64 x 64 and a 2048 x 8 slab,
    the loop of 8 `StreamRunner.step` at B = 2048, and the CLI's window
    (`forward_minibatched`, 96 chunks of one stream);
  - the recurrent kernels: `lstm_fused` at the v4 (H=64, L=2) and v5 (H=128,
    L=1) steps at B=2048 and CLI windows at B=1, `lstm_decoder_fused` at
    B=2048 x K=1 and K=8, a 64 x 64 corpus slab and the CLI's window of 96
    chunks, T=7 frames a chunk (seeded random inputs: the times do not
    depend on the values);
  - in a tree with the bf16 tiers (`vadc_tpu_torch.nn.precision`), each of
    balanced, fast and turbo: `forward_fused` at B = 2048 and 1 x 1536,
    `forward_fused2d` at 2048 x 25 frames, `encode_fused_audio` at 4096
    rows, `dot_magnitude` at 2048 x 1536, the v3.1 `StreamRunner.step` at
    B = 2048, the 64 x 64 and 2048 x 8 slabs, the CLI's window and the
    server's `_tick` at 2048 slots at the tier, `stft_magnitude` at the four
    family geometries (B = 2048) at the products' mode the tier gives each
    family, and the tier instances of the recurrent kernels, each weight
    packed once as the tree packs it for the tier: `lstm_fused` at v4 B=2048
    x T=3, v4 B=1 x T=288 and v5 B=2048 x T=1, `lstm_decoder_fused` at 64 x
    64 x 7 and 2048 x 8 x 7.

With `--probes`, only the two probes of tools/tpu_check.py
(`kernels/probes.py`: `bf16_dot`, `bf16_dot_wgmma`, `concat_dot`), from a
library of the tree's `csrc/probes.cu` alone: at the probe's own shapes
([2, 8, 48] x [48, 16]; x [8, 4, 64], h [8, 64], w [128, 32]) and at the v4
gate product's (2048 x 128 x 256; x [2048, 3, 64], h [2048, 64]), each by
its device time (torch.profiler over 50 calls, the median of three) and by
CUDA events around back-to-back calls.

Imports nothing of JAX. Exits 1 without a card.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys
from pathlib import Path

SEED = 0
CHUNK = 1536
# (label, hidden, layers, batch, steps)
LSTM_SHAPES = (("v4", 64, 2, 2048, 3), ("v4", 64, 2, 2048, 1), ("v5", 128, 1, 2048, 1),
               ("v4", 64, 2, 1, 288), ("v5", 128, 1, 1, 96))
# (batch, chunks) at 7 frames a chunk
DECODER_SHAPES = ((2048, 1), (2048, 8), (64, 64), (1, 96))
# the recurrent kernels' tier instances: lstm_fused's (label, hidden, layers,
# batch, steps) and lstm_decoder_fused's (batch, chunks) at 7 frames a chunk
TIER_LSTM_SHAPES = (("v4", 64, 2, 2048, 3), ("v4", 64, 2, 1, 288), ("v5", 128, 1, 2048, 1))
TIER_DECODER_SHAPES = ((64, 64), (2048, 8))
# (batch, samples) of forward_fused
STEP_SHAPES = ((2048, 1536), (64, 1536), (1, 1536), (2048, 512))
# (streams, chunks) of StreamRunner.scan
SLAB_SHAPES = ((64, 64), (2048, 8))
ENCODE_AUDIO_ROWS = (4096, 16384)
CLI_WINDOW = 96


def device_ms(fn, iters: int = 50) -> float:
    """Device time of one call of fn: the busy time of its kernels under
    torch.profiler over `iters` calls after a warm-up (0.0 when the profiler
    saw none)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    busy = sum(getattr(e, "self_device_time_total", 0.0) for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA)
    return busy / 1e3 / iters


def probes(chip_smoke) -> None:
    """The --probes line (module docstring)."""
    import ctypes

    import numpy as np
    import torch

    from vadc_tpu_torch.kernels import _build
    from vadc_tpu_torch.kernels import probes as P

    entries = ("vadc_bf16_dot", "vadc_bf16_dot_wgmma", "vadc_concat_dot")
    _build._lib = _build._bind(ctypes.CDLL(str(_build.build((), ("probes.cu", "errors.cu")))),
                               entries)
    device = torch.device("cuda")
    rng = np.random.default_rng(SEED)

    def t(*shape, scale=1.0, dtype=torch.float32):
        return torch.from_numpy((rng.normal(size=shape) * scale).astype(np.float32)).to(device, dtype)

    bf16 = {"probe": (torch.full((2, 8, 48), 0.5, dtype=torch.bfloat16, device=device),
                      torch.full((48, 16), 0.25, dtype=torch.bfloat16, device=device)),
            "gate": (t(2048, 128, dtype=torch.bfloat16),
                     t(128, 256, scale=128 ** -0.5, dtype=torch.bfloat16))}
    concat = {"probe": (t(8, 4, 64), 1, t(8, 64), t(128, 32)),
              "gate": (t(2048, 3, 64, scale=0.09), 1, t(2048, 64, scale=0.09),
                       t(128, 256, scale=0.09))}
    calls = []
    for shape in ("probe", "gate"):
        x, w = bf16[shape]
        calls += [(f"bf16_dot {shape}", lambda x=x, w=w: P.bf16_dot(x, w)),
                  (f"bf16_dot_wgmma {shape}", lambda x=x, w=w: P.bf16_dot_wgmma(x, w))]
        calls.append((f"concat_dot {shape}", lambda a=concat[shape]: P.concat_dot(*a)))
    out = []
    for label, call in calls:
        dev = sorted(device_ms(call) for _ in range(3))[1]
        out.append(f"{label}: {dev:.4f} ({chip_smoke.cuda_ms(call):.4f} events)")
    print(f"{os.path.basename(os.getcwd())} | {chip_smoke.nvidia_smi()} | probes, ms device time "
          "(CUDA events back to back) | " + " | ".join(out), flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_ab: no CUDA device is visible to PyTorch", file=sys.stderr)
        return 1
    # the package of the tree under test; chip_smoke.py from beside this
    # script, whichever tree the current directory is
    sys.path.insert(0, os.getcwd())
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parent / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke"] = chip_smoke
    spec.loader.exec_module(chip_smoke)
    if sys.argv[1:] == ["--probes"]:
        probes(chip_smoke)
        return 0
    from vadc_tpu_torch.cli.main import DEFAULT_WEIGHTS
    from vadc_tpu_torch.engine.runner import StreamRunner
    from vadc_tpu_torch.kernels import silero_v31_fused as KA
    from vadc_tpu_torch.kernels import lstm as KL
    from vadc_tpu_torch.kernels import lstm_decoder as KD
    from vadc_tpu_torch.kernels.lstm import lstm_fused, transpose_weight
    from vadc_tpu_torch.kernels.lstm_decoder import lstm_decoder_fused
    from vadc_tpu_torch.kernels.silero_v31_fused2d import encode_fused, forward_fused2d
    from vadc_tpu_torch.kernels.stft_dotmag import dot_magnitude
    from vadc_tpu_torch.kernels.stft_mag import split_basis_of, stft_magnitude
    from vadc_tpu_torch.models import silero_v31
    from vadc_tpu_torch.models.weights import load_params
    from vadc_tpu_torch.nn import functional as F

    ms = chip_smoke.cuda_ms
    device = torch.device("cuda")
    gen = torch.Generator(device=device).manual_seed(SEED)

    def rand(*shape, scale=1.0):
        return scale * torch.randn(*shape, device=device, generator=gen)

    def speech(n, samples, seed):
        return torch.from_numpy(chip_smoke.speech_chunks(n, samples, seed=seed)).to(device)

    _, params = load_params(DEFAULT_WEIGHTS, device=device)
    out = []

    for batch, samples in STEP_SHAPES:
        audio = speech(batch, samples, SEED + 1)
        h, c = silero_v31.init_state(batch, device)
        t = ms(lambda: KA.forward_fused(params, audio, h, c))
        out.append(f"forward_fused B={batch} x {samples}: {t:.4f}")
    feats = 2.0 * rand(4096, 25, 129)
    h, c = silero_v31.init_state(2048, device)
    t = ms(lambda: forward_fused2d(params, feats[:2048], h, c))
    out.append(f"forward_fused2d B=2048 x 25: {t:.4f}")
    t = ms(lambda: encode_fused(params, feats))
    out.append(f"encode_fused 4096 rows x 25: {t:.4f}")
    big = speech(max(ENCODE_AUDIO_ROWS), CHUNK, SEED + 2)
    if hasattr(KA, "encode_fused_audio"):
        for rows in ENCODE_AUDIO_ROWS:
            t = ms(lambda: KA.encode_fused_audio(params, big[:rows]), iters=20)
            out.append(f"encode_fused_audio {rows} rows x {CHUNK}: {t:.4f}")

    audio = big[:2048]
    wr, wi = split_basis_of(params)
    frames = F.frame(F.reflect_pad_last(audio, 128, 128), 256, 64)
    t = ms(lambda: dot_magnitude(frames, wr, wi))
    out.append(f"dot_magnitude B=2048 x {CHUNK}: {t:.4f}")
    t = ms(lambda: stft_magnitude(audio, wr, wi, pad_left=128, pad_right=128, hop=64))
    out.append(f"stft_magnitude B=2048 x {CHUNK}: {t:.4f}")
    torch.backends.cuda.matmul.allow_tf32 = False
    product = torch.cat([wr, wi], dim=1)  # [256, 258]
    rows = frames.reshape(-1, 256).contiguous()
    t = ms(lambda: torch.matmul(rows, product))
    out.append(f"cuBLAS product only, {rows.shape[0]} rows (v3.1): {t:.4f}")

    _, models = chip_smoke.family_models(device)
    for family, (module, p) in models.items():
        samples, kw = chip_smoke.stft_geometry(family, module)
        fam_audio = speech(2048, samples, SEED + 3)
        fwr, fwi = split_basis_of(p)
        t = ms(lambda: stft_magnitude(fam_audio, fwr, fwi, **kw))
        out.append(f"stft_magnitude {family} B=2048 x {samples}: {t:.4f}")
        if family == "v4":
            rows = F.frame(F.reflect_pad_last(fam_audio, kw["pad_left"], kw["pad_right"]), 256,
                           kw["hop"]).reshape(-1, 256).contiguous()
            t = ms(lambda: torch.matmul(rows, torch.cat([fwr, fwi], dim=1)))
            out.append(f"cuBLAS product only, {rows.shape[0]} rows (v4): {t:.4f}")
            window = fam_audio[:CLI_WINDOW]
            t = ms(lambda: stft_magnitude(window, fwr, fwi, **kw))
            out.append(f"stft_magnitude v4 CLI window {CLI_WINDOW} x {samples}: {t:.4f}")
    out.append("stft_magnitude digests " + json.dumps(chip_smoke.stft_digests(models, device)))

    runner = StreamRunner("v3", params, device=device)
    for streams, chunks in SLAB_SHAPES:
        slab = big[: streams * chunks].reshape(streams, chunks, CHUNK)
        state = runner.init_state(streams)
        t = ms(lambda: runner.scan(slab, state), iters=10)
        out.append(f"scan {streams} x {chunks}: {t:.4f}")
    slab = big[: 2048 * 8].reshape(2048, 8, CHUNK)
    state = runner.init_state(2048)

    def steps():
        for k in range(8):
            runner.step(slab[:, k], state)

    out.append(f"8 steps B=2048: {ms(steps, iters=10):.4f}")
    window = big[:CLI_WINDOW]
    h, c = silero_v31.init_state(1, device)
    t = ms(lambda: silero_v31.forward_minibatched(params, window, h, c), iters=10)
    out.append(f"CLI window {CLI_WINDOW} x {CHUNK}: {t:.4f}")
    for family in ("v4", "v5"):
        module, p = models[family]
        chunk = chip_smoke.V4_CHUNK if family == "v4" else chip_smoke.V5_CHUNK
        fam_runner = StreamRunner(family, p, device=device)
        fam_state = fam_runner.init_state(2048)
        chunks = speech(2048, chunk, SEED + 4)
        t = ms(lambda: fam_runner.step(chunks, fam_state), iters=20)
        out.append(f"step {family} B=2048 x {chunk}: {t:.4f}")
    module, p = models["v4"]
    window = speech(CLI_WINDOW, chip_smoke.V4_CHUNK, SEED + 5)
    h, c = module.init_state(1, device)
    t = ms(lambda: module.forward_minibatched(p, window, h, c), iters=20)
    out.append(f"v4 CLI window {CLI_WINDOW} x {chip_smoke.V4_CHUNK}: {t:.4f}")

    for name, hidden, layers, batch, seq in LSTM_SHAPES:
        w, b = rand(layers, 4 * hidden, 2 * hidden, scale=0.1), rand(layers, 4 * hidden, scale=0.1)
        wt = transpose_weight(w)
        x, h, c = rand(batch, seq, hidden), rand(layers, batch, hidden, scale=0.3), \
            rand(layers, batch, hidden)
        t = ms(lambda: lstm_fused(x, h, c, w, b, wt=wt), iters=200 if batch > 1 else 20, warmup=20)
        out.append(f"lstm_fused {name} B={batch} x T={seq}: {t:.4f}")
    w, b = rand(2, 256, 128, scale=0.1), rand(2, 256, scale=0.1)
    wt, dec_w, dec_b = transpose_weight(w), rand(2, 64), rand(2)
    for batch, chunks in DECODER_SHAPES:
        x, h, c = rand(batch, chunks, 7, 64), rand(2, batch, 64, scale=0.3), rand(2, batch, 64)
        t = ms(lambda: lstm_decoder_fused(x, h, c, w, b, dec_w, dec_b, wt=wt), iters=20, warmup=20)
        out.append(f"lstm_decoder_fused B={batch} x K={chunks} x T=7: {t:.4f}")
    if importlib.util.find_spec("vadc_tpu_torch.nn.precision") is not None:
        from vadc_tpu_torch.nn.precision import TIERS

        audio = big[:2048]
        h, c = silero_v31.init_state(2048, device)
        h1, c1 = silero_v31.init_state(1, device)
        x, hs, cs = rand(64, 64, 7, 64), rand(2, 64, 64, scale=0.3), rand(2, 64, 64)

        def packed(w, tier, kernel):
            """The weight the tree's tier instance of `kernel` (a module with
            the kernel's wrapper) reads, packed once."""
            if hasattr(kernel, "kernel_weight"):
                return kernel.kernel_weight(w, TIERS[tier])
            return transpose_weight(w, TIERS[tier].products)

        lstm_in = {}
        for name, hidden, layers, batch, seq in TIER_LSTM_SHAPES:
            lstm_in[name, batch, seq] = (
                rand(layers, 4 * hidden, 2 * hidden, scale=0.1), rand(layers, 4 * hidden, scale=0.1),
                rand(batch, seq, hidden), rand(layers, batch, hidden, scale=0.3),
                rand(layers, batch, hidden))
        dec_in = {(batch, chunks): (rand(batch, chunks, 7, 64), rand(2, batch, 64, scale=0.3),
                                    rand(2, batch, 64)) for batch, chunks in TIER_DECODER_SHAPES}
        for tier in ("balanced", "fast", "turbo"):
            t_runner = StreamRunner("v3", params, device=device, precision=tier)
            feats = silero_v31.features(params, audio, tier)
            step_state = t_runner.init_state(2048)
            times = {
                "forward_fused B=2048": ms(lambda: KA.forward_fused(params, audio, h, c, tier=tier)),
                "forward_fused B=1": ms(lambda: KA.forward_fused(params, audio[:1], h1, c1, tier=tier)),
                "forward_fused2d B=2048 x 25": ms(
                    lambda: forward_fused2d(params, feats, h, c, tier=tier)),
                "encode_fused_audio 4096 rows": ms(
                    lambda: KA.encode_fused_audio(params, big[:4096], tier), iters=20),
                "dot_magnitude B=2048": ms(lambda: dot_magnitude(frames, wr, wi, tier)),
                "step B=2048": ms(lambda: t_runner.step(audio, step_state), iters=20),
                "CLI window": ms(lambda: silero_v31.forward_minibatched(
                    params, big[:CLI_WINDOW], h1, c1, tier), iters=10),
            }
            for streams, chunks in SLAB_SHAPES:
                slab = big[: streams * chunks].reshape(streams, chunks, CHUNK)
                state = t_runner.init_state(streams)
                times[f"scan {streams} x {chunks}"] = ms(lambda: t_runner.scan(slab, state), iters=10)
            times["_tick 2048 slots"] = chip_smoke.time_ticks(
                str(DEFAULT_WEIGHTS), device, f"v3.1 {tier}", tier)[0]
            for (name, batch, seq), (w, b, x1, h1_, c1_) in lstm_in.items():
                wt = packed(w, tier, KL)
                times[f"lstm_fused {name} B={batch} x T={seq}"] = ms(
                    lambda: lstm_fused(x1, h1_, c1_, w, b, wt=wt, tier=tier),
                    iters=200 if batch > 1 else 20, warmup=20)
            wt = packed(params["lstm_w"], tier, KD)
            for (batch, chunks), (x1, h1_, c1_) in dec_in.items():
                times[f"lstm_decoder_fused {batch} x {chunks} x 7"] = ms(
                    lambda: lstm_decoder_fused(x1, h1_, c1_, params["lstm_w"], params["lstm_b"],
                                               params["dec_w"], params["dec_b"], wt=wt, tier=tier),
                    iters=20, warmup=20)
            # stft_magnitude's instance of each products' mode the tier gives a family
            for family, (module, p) in models.items():
                mode = chip_smoke.stft_mode_of(family, tier)
                samples, kw = chip_smoke.stft_geometry(family, module)
                fam_audio = speech(2048, samples, SEED + 3)
                fwr, fwi = split_basis_of(p)
                times[f"stft_magnitude {family} B=2048 x {samples} ({mode})"] = ms(
                    lambda: stft_magnitude(fam_audio, fwr, fwi, **kw, mode=mode))
            out += [f"{name} [{TIERS[tier]}]: {t:.4f}" for name, t in times.items()]
    print(f"{os.path.basename(os.getcwd())} ({chip_smoke.nvidia_smi()}), ms per call | "
          + "; ".join(out), flush=True)
    # registers, spills and stack of the spectrum, fused and recurrent
    # kernels, from nvcc -Xptxas -v
    from vadc_tpu_torch.kernels import _build

    unit, ptxas = "", []
    for line in _build.build_info.get("log", "").splitlines():
        if line.startswith("Compiling "):
            unit = line.split()[1]
        elif unit.startswith(("stft_", "silero_v31_fused", "lstm")) and (
                "registers" in line or "spill" in line or "entry function" in line):
            ptxas.append(f"{unit}: {line.strip()}")
    print(f"{os.path.basename(os.getcwd())} ptxas | " + " | ".join(ptxas), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
