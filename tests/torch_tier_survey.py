"""The bf16 tiers on speech, on the CPU, over many tracks: where the bounds of
tests/test_torch_tiers.py and vadc_tpu_torch/kernels/tier_check.py
(SPEECH_BOUND, JAX_TIER_BOUND) come from.

    python -m tests.torch_tier_survey [--seeds 12]

For each track vadc_tpu.io.synthaudio.utterance_track(4, seed), one stream
of 1536-sample chunks, and each tier, the largest difference of the
probabilities:

  * port: the port's plain versions at the tier against the port's faithful;
  * jax: the JAX package's StreamRunner at the tier against its faithful (on
    the CPU its products run in fp32, so only turbo's bf16 spectrum and
    storage and the tanh/log1p forms show);
  * port-jax: the port against the JAX package at the same tier;
  * fp32 stft: the port's tier with its spectrum computed in fp32, against
    the port's faithful (what the tier's spectrum adds).

A "(segments)" mark says the segments differ from faithful's; "=jax" that
they equal the JAX package's segments at the tier.
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

import jax.numpy as jnp

from tests.torch_port_util import jax_and_port_params
from vadc_tpu.engine import runner as JR
from vadc_tpu.io.synthaudio import utterance_track
from vadc_tpu_torch.cli.segmenter import Segmenter, SegmenterConfig
from vadc_tpu_torch.models import silero_v31 as TM
from vadc_tpu_torch.nn.precision import tier_of

TIERS = ("balanced", "fast", "turbo")


def segments(probs) -> list:
    seg = Segmenter(SegmenterConfig.from_ms(chunk_samples=1536, sample_rate=16000))
    out = []
    for p in np.asarray(probs, np.float64).ravel():
        out.extend(seg.feed(float(p)))
    return out + list(seg.finish())


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, default=12, help="tracks 0..N-1")
    args = ap.parse_args()
    torch.set_num_threads(2)
    jp, tp = jax_and_port_params()

    def port(audio, tier):
        h, c = TM.init_state(1)
        return TM.forward_minibatched_reference(tp, audio, h, c, tier)[0].numpy().astype(np.float64)

    def jax(track, tier):
        runner = JR.StreamRunner("v3", jp, precision=tier)
        return np.asarray(runner.scan(jnp.asarray(track), runner.init_state(1))[0], np.float64)[0]

    worst = {t: dict.fromkeys(("port", "jax", "port-jax", "fp32 stft"), 0.0) for t in TIERS}
    for seed in range(args.seeds):
        speech, _ = utterance_track(4, seed=seed)
        n = len(speech) // 1536
        track = speech[: n * 1536].reshape(1, n, 1536).astype(np.float32)
        audio = torch.from_numpy(track[0])
        p_f, j_f = port(audio, "faithful"), jax(track, "faithful")
        line = [f"seed {seed} ({n} chunks, {len(segments(p_f))} segments): port-jax faithful "
                f"{np.abs(p_f - j_f).max():.2e}"]
        for tier in TIERS:
            p_t, j_t = port(audio, tier), jax(track, tier)
            p_s = port(audio, dataclasses.replace(tier_of(tier), stft="fp32"))
            devs = {"port": np.abs(p_t - p_f).max(), "jax": np.abs(j_t - j_f).max(),
                    "port-jax": np.abs(p_t - j_t).max(), "fp32 stft": np.abs(p_s - p_f).max()}
            for k, v in devs.items():
                worst[tier][k] = max(worst[tier][k], float(v))
            mark = ("" if segments(p_t) == segments(p_f) else " (segments)") + (
                " =jax" if segments(p_t) == segments(j_t) else " !=jax")
            line.append(f"{tier}: " + ", ".join(f"{k} {v:.2e}" for k, v in devs.items()) + mark)
        print(" | ".join(line), flush=True)
    for tier, w in worst.items():
        print(f"largest over seeds 0-{args.seeds - 1}, {tier}: "
              + ", ".join(f"{k} {v:.3e}" for k, v in w.items()))


if __name__ == "__main__":
    main()
