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
    `encode_fused_audio` at 4096 rows, `dot_magnitude` at 2048 x 1536,
    `lstm_decoder_fused` at 64 x 64 x 7, the 64 x 64 and 2048 x 8 slabs and
    the CLI's window at the tier.

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
# (batch, samples) of forward_fused
STEP_SHAPES = ((2048, 1536), (64, 1536), (1, 1536), (2048, 512))
# (streams, chunks) of StreamRunner.scan
SLAB_SHAPES = ((64, 64), (2048, 8))
ENCODE_AUDIO_ROWS = (4096, 16384)
CLI_WINDOW = 96


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
    from vadc_tpu_torch.cli.main import DEFAULT_WEIGHTS
    from vadc_tpu_torch.engine.runner import StreamRunner
    from vadc_tpu_torch.kernels import silero_v31_fused as KA
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
        for tier in ("balanced", "fast", "turbo"):
            t_runner = StreamRunner("v3", params, device=device, precision=tier)
            times = {
                "forward_fused B=2048": ms(lambda: KA.forward_fused(params, audio, h, c, tier=tier)),
                "forward_fused B=1": ms(lambda: KA.forward_fused(params, audio[:1], h1, c1, tier=tier)),
                "encode_fused_audio 4096 rows": ms(
                    lambda: KA.encode_fused_audio(params, big[:4096], tier), iters=20),
                "dot_magnitude B=2048": ms(lambda: dot_magnitude(frames, wr, wi, tier)),
                "lstm_decoder_fused 64 x 64 x 7": ms(
                    lambda: lstm_decoder_fused(x, hs, cs, params["lstm_w"], params["lstm_b"],
                                               params["dec_w"], params["dec_b"], tier=tier),
                    iters=20, warmup=20),
                "CLI window": ms(lambda: silero_v31.forward_minibatched(
                    params, big[:CLI_WINDOW], h1, c1, tier), iters=10),
            }
            for streams, chunks in SLAB_SHAPES:
                slab = big[: streams * chunks].reshape(streams, chunks, CHUNK)
                state = t_runner.init_state(streams)
                times[f"scan {streams} x {chunks}"] = ms(lambda: t_runner.scan(slab, state), iters=10)
            out += [f"{name} [{TIERS[tier]}]: {t:.4f}" for name, t in times.items()]
    print(f"{os.path.basename(os.getcwd())} ({chip_smoke.nvidia_smi()}), ms per call | "
          + "; ".join(out), flush=True)
    # registers, spills and stack of the spectrum kernels, from nvcc -Xptxas -v
    from vadc_tpu_torch.kernels import _build

    unit, ptxas = "", []
    for line in _build.build_info.get("log", "").splitlines():
        if line.startswith("Compiling "):
            unit = line.split()[1]
        elif unit.startswith(("stft_", "silero_v31_fused_audio")) and (
                "registers" in line or "spill" in line or "entry function" in line):
            ptxas.append(f"{unit}: {line.strip()}")
    print(f"{os.path.basename(os.getcwd())} ptxas | " + " | ".join(ptxas), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
