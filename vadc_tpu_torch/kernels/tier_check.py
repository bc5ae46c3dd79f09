"""How a bf16 tier's kernel instance is held to its plain version at the
same tier, and how far each tier may move each family's probabilities on
speech: the one place chip_smoke.py and the `cuda`-marked tests take these
limits from. Arithmetic on tensors that are already computed; nothing here
launches a kernel.

A tier instance and its plain version are not bit-equal. They sum in other
orders, a difference of 1e-7 between two sums can flip an activation's bf16
rounding (by 2^-8 of it), and the stream's later values carry the flip on.
Flips are rare, so the largest difference tells little: one flip in a
stream of 2048 reaches 0.13 on h at turbo. The share of outputs that differ
by more than TAU[tier] does tell a right instance from a wrong one. Readings
on an NVIDIA H100 80GB HBM3 at 700 W, at B=2048 x 1536 and 2048 x 512, the
plain version fed the kernel's own spectrum (chip_smoke.py, check_tier):

  * fast and turbo, TAU 1e-4. Right instances: probabilities, h and c at
    most 0.075 (fast forward_fused, h), the encoder's output 0.038,
    lstm_decoder_fused 0.0007. Wrong ones: the faithful instances on the
    same inputs (check_tier's control) read at least 0.586, 0.302 and
    0.247; a fast build whose LSTMs left h unrounded in their recurrent
    products (in the step kernel, layer 0's only) read 0.35 to 0.39, and
    broke the largest-difference limits at B=1 and B=37 too.
  * balanced, TAU 1e-5. Right instances: at most 0.027 and 0.067 (the
    encoder). The faithful instance reads at least 0.210 on forward_fused
    and 0.233 on encode_fused_audio, where its spectrum and its log1p
    differ too; on forward_fused2d and lstm_decoder_fused, where only the
    products differ, 0 to 0.063, inside the limits. A bf16_3x product is
    within 2^-17 of the fp32 one, and no check of the outputs tells the two
    apart.

The v4/v5 paths' instances (readings on the same card, chip_smoke.py:
check_stft_magnitude_tier, check_lstm_tier): stft_magnitude's spectrum at
most 1.05e-6 of its largest value at bf16_3x and 4.7e-7 at bf16; the fp32
instance against the bf16 plain version (the control) 1.6e-3 to 2.2e-3,
against the bf16_3x one 3.1e-6 to 4.6e-6, which no limit can tell from a
right instance. lstm_fused at balanced at most 5.7e-6 with no output above
1e-5; at fast and turbo, whose LSTM arithmetic is one (the same bits on the
same inputs), y 2.3e-3, h 1.4e-3, c 2.9e-4, at 2048 streams a share of at
most 0.0002 above 1e-4, and the faithful instance (the control) 0.37 to
0.70 of its outputs. Their limits are one class a kernel, fast and turbo
the same.

The largest differences are held too, at three times the largest reading
of each batch class, rounded up. B=1 has no flip in its readings. B=37 and
the batches of 2048 do. lstm_decoder_fused has a class of its own, and so
have the v4/v5 paths' kernels, stft_magnitude (the spectrum's largest
difference relative to its largest value, at every geometry and batch)
and lstm_fused (y, h and c at v4 B=2048 x T=3 and B=1 x T=288, v5 B=2048 x
T=1 and B=1 x T=96). Shares are held only where there are many streams
(SHARE_MIN_BATCH).
"""

from __future__ import annotations

#: an output differs when |kernel - plain| exceeds this: c relative to
#: max(1, its largest value), the spectrum relative to its largest value
TAU = {"balanced": 1e-5, "fast": 1e-4, "turbo": 1e-4}
#: the largest share of outputs that may differ: "state" is probabilities,
#: h and c of forward_fused and forward_fused2d, "enc" the encoder's output
#: of encode_fused_audio, "lstm" lstm_decoder_fused's probabilities, h and c
SHARE = {"balanced": {"state": 0.15, "enc": 0.15, "lstm": 0.02, "lstm_fused": 0.02},
         "fast": {"state": 0.25, "enc": 0.12, "lstm": 0.02, "lstm_fused": 0.02},
         "turbo": {"state": 0.25, "enc": 0.12, "lstm": 0.02, "lstm_fused": 0.02}}
#: shares are held from this many streams on
SHARE_MIN_BATCH = 1024
#: the kernels whose limits are a class of their own, at every batch
OWN_CLASS = {"lstm_decoder_fused": "lstm", "stft_magnitude": "stft_magnitude",
             "lstm_fused": "lstm_fused"}
#: the largest difference by tier and batch class ("1", "small": below
#: SHARE_MIN_BATCH, "large"; "lstm": lstm_decoder_fused at every batch),
#: three times the largest reading of the class, rounded up
MAX = {
    "balanced": {
        "1": {"probs": 1e-6, "h": 1e-4, "c": 2e-5, "enc": 2e-4, "mag": 5e-6},
        "small": {"probs": 2.5e-5, "h": 3.5e-4, "c": 6e-5, "enc": 4e-4, "mag": 5e-6},
        "large": {"probs": 2e-4, "h": 1.5e-3, "c": 5e-4, "enc": 3e-3, "mag": 5e-6},
        "lstm": {"probs": 1.5e-5, "h": 6e-5, "c": 2e-5},
        "stft_magnitude": {"mag": 3.5e-6},
        "lstm_fused": {"y": 2e-5, "h": 2e-5, "c": 1.5e-5},
    },
    "fast": {
        "1": {"probs": 1e-6, "h": 2e-6, "c": 1e-6, "enc": 2e-6, "mag": 5e-6},
        "small": {"probs": 3.5e-3, "h": 5e-2, "c": 7e-3, "enc": 0.11, "mag": 5e-6},
        "large": {"probs": 2e-2, "h": 0.2, "c": 6e-2, "enc": 0.6, "mag": 5e-6},
        "lstm": {"probs": 2.5e-4, "h": 3e-3, "c": 4.5e-3},
        "stft_magnitude": {"mag": 3.5e-6},
        "lstm_fused": {"y": 7.5e-3, "h": 4.5e-3, "c": 9e-4},
    },
    "turbo": {
        "1": {"probs": 1e-6, "h": 1e-6, "c": 1e-6, "enc": 1e-6, "mag": 1e-6},
        "small": {"probs": 9e-3, "h": 0.25, "c": 3e-2, "enc": 0.25, "mag": 1e-6},
        "large": {"probs": 3.5e-2, "h": 0.4, "c": 8e-2, "enc": 0.6, "mag": 1e-6},
        "lstm": {"probs": 1.5e-6, "h": 9e-3, "c": 1e-3},
        "stft_magnitude": {"mag": 1.5e-6},
        "lstm_fused": {"y": 7.5e-3, "h": 4.5e-3, "c": 9e-4},
    },
}
#: the v4/v5 paths at a tier, the card's kernels against the CPU's plain
#: versions (chip_smoke.py: StreamRunner.scan over 256 streams x 8 chunks,
#: MinibatchRunner over a 96-chunk window, the v4 CLI's raw probabilities):
#: probabilities, h, and c relative to max(1, its largest value), three
#: times the largest reading on an H100, rounded up (balanced 3.1e-5,
#: 2.4e-4, 3.6e-5; fast 2.3e-3, 1.1e-2, 1.1e-3; turbo 9.7e-4, 6.1e-3,
#: 8.8e-4)
PATH_MAX = {"balanced": {"probs": 1e-4, "h": 7.5e-4, "c": 1.1e-4},
            "fast": {"probs": 7e-3, "h": 3.5e-2, "c": 3.5e-3},
            "turbo": {"probs": 3e-3, "h": 2e-2, "c": 3e-3}}
#: each family's largest deviation from faithful on speech at each tier
#: (vadc_tpu_torch.io.synthaudio.utterance_track(4, seed) at the family's
#: rate, one stream, seeds 0-11; tests/torch_tier_survey.py), rounded up.
#: v3 (Silero v3.1): the port's plain versions on the CPU read at most
#: 1.25e-3 (balanced), 2.38e-2 (fast) and 1.64e-1 (turbo); the kernels on an
#: H100 read 1.19e-3, 2.22e-2 and 1.68e-1. The others, the CPU's plain
#: versions / the kernels on the same H100 (chip_smoke.py:
#: tier_on_speech_v45): v4 2.47e-4 / 2.48e-4, 6.37e-3 / 6.19e-3, 7.07e-2 /
#: 7.06e-2; v4_8k 2.07e-3 / 2.07e-3, 8.63e-3 / 8.57e-3, 5.54e-2 / 5.54e-2;
#: v5 (synthetic weights) 8.20e-5 / 7.34e-5, 2.52e-2 / 2.52e-2, 4.98e-2 /
#: 4.98e-2; v5_8k (synthetic weights) 4.97e-5 / 5.56e-5, 2.08e-2 / 2.08e-2,
#: 2.05e-2 / 2.05e-2.
SPEECH_BOUND = {
    "v3": {"balanced": 1.5e-3, "fast": 3e-2, "turbo": 2e-1},
    "v4": {"balanced": 3e-4, "fast": 8e-3, "turbo": 8.5e-2},
    "v4_8k": {"balanced": 2.5e-3, "fast": 1e-2, "turbo": 7e-2},
    "v5": {"balanced": 1e-4, "fast": 3e-2, "turbo": 6e-2},
    "v5_8k": {"balanced": 6e-5, "fast": 2.5e-2, "turbo": 2.5e-2},
}

#: v5 at faithful on shards of a card against the unsharded runner, B=2048, a
#: step and the 8 steps after it (chip_smoke.py: v5_within_bound): the
#: largest difference of the probabilities and of the state (h and c). The
#: encoder's k3 convs are torch.matmul products, whose algorithm cuBLAS
#: picks by the number of rows, so a shard's half of the streams sums in
#: another order; the spectrum and LSTM kernels give each shard's rows the
#: whole batch's bits. Readings on an NVIDIA H100 80GB HBM3 at 700 W, 2
#: shards of the card: after the step 8.9e-7 and 8.4e-6 with the shards'
#: first step run one after the other, 1.25e-6 and 1.09e-5 with the two at
#: once; after the 9 steps 1.49e-6 and 1.53e-5. Controls,
#: half the streams through the kernels at the fast tier: 2.5e-2 and 0.57
#: (must break the limits); through the plain versions: 2.6e-6 and 2.1e-5,
#: too close to the sound run for a limit that holds in every run.
#:
#: "family/tier": the v4/v5 slab scan (models/slab.py, StreamRunner.scan)
#: against the loop of StreamRunner.step on the same chunks, where the card
#: gives other bits (chip_smoke.py: check_slab_v45), the same two
#: readings. The scan runs the step's encoder over pieces of 8 chunks of
#: every stream, and its torch ops are cuBLAS products (the conv stages'
#: linears, v4's 7-tap smoothing, the 64 -> 1 decoder), whose algorithm
#: cuBLAS picks by the number of rows; stft_magnitude over a piece gives
#: each chunk's bits, and one lstm_fused call over the steps' own features
#: gives the loop's state. Three times the largest reading over seeded
#: speech slabs of 2048 x 8 and 64 x 64 on an NVIDIA H100 80GB HBM3 at
#: 700 W, rounded up; the readings (probs, state), and in brackets the
#: control, the first half of the streams at another tier (faithful,
#: balanced and turbo: fast; fast: turbo), which must break the bound:
#:   v4 faithful 1.07e-6, 3.50e-5 (6.2e-3, 0.127); balanced 5.72e-6,
#:   1.41e-4 (6.3e-3, 0.126); fast 1.32e-3, 1.85e-2 (7.2e-2, 0.943); turbo
#:   1.19e-3, 1.80e-2 (7.2e-2, 0.943);
#:   v4_8k faithful 8.94e-7, 5.72e-5 (6.2e-3, 0.184); balanced 9.15e-6,
#:   1.49e-4 (6.3e-3, 0.185); fast 7.10e-4, 2.27e-2 (4.4e-2, 1.46); turbo
#:   1.03e-3, 2.69e-2 (4.4e-2, 1.46);
#:   v5 faithful 1.91e-6, 1.11e-4 (2.4e-2, 1.15), beyond SHARD_BOUND["v5"]
#:   over 64 steps of 64 streams (its c grows to larger values than over
#:   the 9 steps behind that bound); balanced 1.72e-5, 2.04e-4 (2.4e-2,
#:   1.15); fast 6.90e-4, 9.08e-3 (3.3e-2, 1.02); turbo 3.44e-3, 2.95e-2
#:   (3.3e-2, 1.02);
#:   v5_8k faithful 1.01e-6, 1.34e-5 (1.3e-2, 0.517), within v5's bound,
#:   which holds it; balanced 6.97e-6, 2.30e-4 (1.3e-2, 0.517); fast
#:   1.05e-3, 8.27e-3 (1.9e-2, 0.365); turbo 5.86e-4, 2.78e-3 (1.9e-2,
#:   0.365).
#: At 2048 x 8 v5 and v5_8k give the loop's bits at every tier; every other
#: slab reads above.
SHARD_BOUND = {
    "v5": {"probs": 5e-6, "state": 5e-5},
    "v4/faithful": {"probs": 3.5e-6, "state": 1.1e-4},
    "v4/balanced": {"probs": 2e-5, "state": 4.5e-4},
    "v4/fast": {"probs": 4e-3, "state": 6e-2},
    "v4/turbo": {"probs": 4e-3, "state": 6e-2},
    "v4_8k/faithful": {"probs": 3e-6, "state": 2e-4},
    "v4_8k/balanced": {"probs": 3e-5, "state": 4.5e-4},
    "v4_8k/fast": {"probs": 2.5e-3, "state": 7e-2},
    "v4_8k/turbo": {"probs": 3.5e-3, "state": 8.5e-2},
    "v5/faithful": {"probs": 6e-6, "state": 3.5e-4},
    "v5/balanced": {"probs": 6e-5, "state": 6.5e-4},
    "v5/fast": {"probs": 2.5e-3, "state": 3e-2},
    "v5/turbo": {"probs": 1.1e-2, "state": 9e-2},
    "v5_8k/faithful": {"probs": 5e-6, "state": 5e-5},
    "v5_8k/balanced": {"probs": 2.5e-5, "state": 7e-4},
    "v5_8k/fast": {"probs": 3.5e-3, "state": 2.5e-2},
    "v5_8k/turbo": {"probs": 2e-3, "state": 9e-3},
}


def shard_bound(family: str, tier: str = "faithful") -> dict | None:
    """The SHARD_BOUND entry that holds a v4/v5 slab scan of `family` at
    `tier` where it misses the loop of steps' bits; None where there is
    none."""
    return SHARD_BOUND.get(f"{family}/{tier}")


def errors(got, want, tier: str, scale: float = 1.0) -> tuple[float, float]:
    """(the largest |got - want| / scale, the share of them above TAU[tier])."""
    err = (got.double() - want.double()).abs().flatten() / scale
    return float(err.max()), float((err > TAU[tier]).double().mean())


def state_errors(got, want, tier: str) -> dict:
    """errors() of (probs, h, c) against (probs, h, c), c relative to
    max(1, want's largest c): {"probs": ..., "h": ..., "c": ...}."""
    scale = max(1.0, float(want[2].abs().max()))
    return {out: errors(g, w, tier, scale if out == "c" else 1.0)
            for out, g, w in zip(("probs", "h", "c"), got, want)}


def breaches(tier: str, kernel: str, batch: int, errs: dict, envelope: bool = False) -> list:
    """The limits that `errs` (output -> (max, share), from errors or
    state_errors) break, as text; empty when within. `kernel` is
    forward_fused, encode_fused_audio, forward_fused2d, lstm_decoder_fused,
    dot_magnitude, stft_magnitude or lstm_fused. `envelope` holds the
    largest differences to the large batches' limits at every batch: for
    inputs other than chip_smoke.py's, whose readings set the tighter
    classes."""
    own = OWN_CLASS.get(kernel)
    cls = own or ("large" if envelope or batch >= SHARE_MIN_BATCH else
                  ("1" if batch == 1 else "small"))
    out = []
    for name, (largest, share) in errs.items():
        limit = MAX[tier][cls][name]
        if not largest <= limit:  # NaN breaks it too
            out.append(f"{kernel} {name}: largest difference {largest:.3e} > {limit:g}")
        if name != "mag" and batch >= SHARE_MIN_BATCH:
            most = SHARE[tier][own or ("enc" if name == "enc" else "state")]
            if share > most:
                out.append(f"{kernel} {name}: {share:.4f} of the outputs differ by more than "
                           f"{TAU[tier]:g} > {most:g}")
    return out
