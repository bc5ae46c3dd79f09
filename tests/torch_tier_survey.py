"""The bf16 tiers on speech, on the CPU, over many tracks, for every family:
where the bounds of tests/test_torch_tiers.py, tests/test_torch_tiers_v45.py
and vadc_tpu_torch/kernels/tier_check.py (SPEECH_BOUND, JAX_TIER_BOUND)
come from.

    python -m tests.torch_tier_survey [--seeds 12] [--families v3 v4 v4_8k v5 v5_8k]

For each track vadc_tpu.io.synthaudio.utterance_track(4, seed) at the
family's rate (16 kHz; 8 kHz for v4_8k and v5_8k), one stream of the
family's chunks (v3.1 and v4 1536 samples, v4_8k 768, v5 512, v5_8k 256;
v5's chunks with their carried context), and each tier, the largest
difference of the probabilities:

  * port: the port's plain versions at the tier against the port's faithful;
  * jax: the JAX package's StreamRunner at the tier against its faithful (on
    the CPU its products run in fp32, so only turbo's bf16 spectrum and
    storage, v5's bf16 spectrum from fast on and the tanh/log1p forms show);
  * port-jax: the port against the JAX package at the same tier;
  * fp32 stft: the port's tier with its spectrum computed in fp32, against
    the port's faithful (what the tier's spectrum adds; v3.1 and v4, whose
    spectrum feeds log1p(2^20 x)).

A "(segments)" mark says the segments differ from faithful's; "=jax" that
they equal the JAX package's segments at the tier. v5 and v5_8k run the
synthetic weights of the official shapes (vadc_tpu_torch.models.synthetic).
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

import jax.numpy as jnp

from tests.torch_port_util import DATA, jax_and_port_params
from vadc_tpu.engine import runner as JR
from vadc_tpu.io.synthaudio import utterance_track
from vadc_tpu_torch.cli.segmenter import Segmenter, SegmenterConfig
from vadc_tpu_torch.engine.runner import get_family_module
from vadc_tpu_torch.nn.precision import tier_of

TIERS = ("balanced", "fast", "turbo")
FAMILIES = ("v3", "v4", "v4_8k", "v5", "v5_8k")
#: family -> (sample rate, chunk samples, carried context samples)
GEOMETRY = {"v3": (16000, 1536, 0), "v4": (16000, 1536, 0), "v4_8k": (8000, 768, 0),
            "v5": (16000, 512, 64), "v5_8k": (8000, 256, 32)}


def family_params(family: str):
    """(JAX param tree, the port's) of a family: the bundled archives of v3.1
    and v4, the synthetic archives of v5 (the seeds of tests/test_torch_v5.py)."""
    if family == "v3":
        return jax_and_port_params()
    from vadc_tpu.io.testtensor import load_testtensor
    from vadc_tpu.models import synthetic as JS
    from vadc_tpu.models import weights as JW
    from vadc_tpu_torch.models import synthetic as TS
    from vadc_tpu_torch.models import weights as TW

    if family.startswith("v4"):
        name = "silero_v4_16k.testtensor" if family == "v4" else "silero_v4_8k.testtensor"
        j_arch = t_arch = load_testtensor(DATA / name)
    elif family == "v5":
        j_arch, t_arch = JS.random_v5_archive(0), TS.random_v5_archive(0)
    else:
        j_arch, t_arch = JS.random_v5_8k_archive(1), TS.random_v5_8k_archive(1)
    return JW.load_params_from_tensors(j_arch)[1], TW.load_params_from_tensors(t_arch)[1]


def track(family: str, seed: int) -> np.ndarray:
    """The whole chunks of the speech track of `seed` at the family's rate:
    [1, N, chunk] fp32."""
    sr, chunk, _ = GEOMETRY[family]
    audio, _ = utterance_track(4, sr=sr, seed=seed)
    n = len(audio) // chunk
    return audio[: n * chunk].reshape(1, n, chunk).astype(np.float32)


def with_context(chunks: np.ndarray, ctx: int) -> np.ndarray:
    """[N, chunk] -> [N, ctx + chunk]: each chunk prefixed with the tail of
    the one before (zeros before the first), as the runners attach it."""
    if not ctx:
        return chunks
    tails = np.concatenate([np.zeros((1, ctx), np.float32), chunks[:-1, -ctx:]])
    return np.concatenate([tails, chunks], axis=1)


def segments(probs, family: str = "v3") -> list:
    sr, chunk, _ = GEOMETRY[family]
    seg = Segmenter(SegmenterConfig.from_ms(chunk_samples=chunk, sample_rate=sr))
    out = []
    for p in np.asarray(probs, np.float64).ravel():
        out.extend(seg.feed(float(p)))
    return out + list(seg.finish())


def survey(family: str, seeds: int) -> dict:
    """Prints one line a track; returns tier -> column -> the largest
    reading over the tracks."""
    jp, tp = family_params(family)
    module = get_family_module(family)
    ctx = GEOMETRY[family][2]

    def port(audio, tier):
        h, c = module.init_state(1)
        return module.forward_minibatched_reference(tp, audio, h, c, tier)[0].numpy().astype(
            np.float64)

    def jax(chunks, tier):
        runner = JR.StreamRunner(family, jp, precision=tier)
        return np.asarray(runner.scan(jnp.asarray(chunks), runner.init_state(1))[0], np.float64)[0]

    worst = {t: dict.fromkeys(("port", "jax", "port-jax", "fp32 stft"), 0.0) for t in TIERS}
    for seed in range(seeds):
        chunks = track(family, seed)
        audio = torch.from_numpy(with_context(chunks[0], ctx))
        p_f, j_f = port(audio, "faithful"), jax(chunks, "faithful")
        n = chunks.shape[1]
        line = [f"{family} seed {seed} ({n} chunks, {len(segments(p_f, family))} segments): "
                f"port-jax faithful {np.abs(p_f - j_f).max():.2e}"]
        for tier in TIERS:
            p_t, j_t = port(audio, tier), jax(chunks, tier)
            devs = {"port": np.abs(p_t - p_f).max(), "jax": np.abs(j_t - j_f).max(),
                    "port-jax": np.abs(p_t - j_t).max()}
            if not family.startswith("v5"):
                p_s = port(audio, dataclasses.replace(tier_of(tier), stft="fp32"))
                devs["fp32 stft"] = np.abs(p_s - p_f).max()
            for k, v in devs.items():
                worst[tier][k] = max(worst[tier][k], float(v))
            seg_t = segments(p_t, family)
            mark = ("" if seg_t == segments(p_f, family) else " (segments)") + (
                " =jax" if seg_t == segments(j_t, family) else " !=jax")
            line.append(f"{tier}: " + ", ".join(f"{k} {v:.2e}" for k, v in devs.items()) + mark)
        print(" | ".join(line), flush=True)
    for tier, w in worst.items():
        print(f"{family} largest over seeds 0-{seeds - 1}, {tier}: "
              + ", ".join(f"{k} {v:.3e}" for k, v in w.items()
                          if k != "fp32 stft" or not family.startswith("v5")), flush=True)
    return worst


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, default=12, help="tracks 0..N-1")
    ap.add_argument("--families", nargs="+", default=list(FAMILIES), choices=FAMILIES)
    args = ap.parse_args()
    torch.set_num_threads(2)
    for family in args.families:
        survey(family, args.seeds)


if __name__ == "__main__":
    main()
