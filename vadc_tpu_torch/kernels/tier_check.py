"""How a bf16 tier's kernel instance is held to its plain version at the
same tier, and how far each tier may move the v3.1 probabilities on speech:
the one place chip_smoke.py and the `cuda`-marked tests take these limits
from. Arithmetic on tensors that are already computed; nothing here
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

The largest differences are held too, at three times the largest reading
of each batch class, rounded up. B=1 has no flip in its readings. B=37 and
the batches of 2048 do. lstm_decoder_fused has a class of its own.
Shares are held only where there are many streams (SHARE_MIN_BATCH).
"""

from __future__ import annotations

#: an output differs when |kernel - plain| exceeds this: c relative to
#: max(1, its largest value), the spectrum relative to its largest value
TAU = {"balanced": 1e-5, "fast": 1e-4, "turbo": 1e-4}
#: the largest share of outputs that may differ: "state" is probabilities,
#: h and c of forward_fused and forward_fused2d, "enc" the encoder's output
#: of encode_fused_audio, "lstm" lstm_decoder_fused's probabilities, h and c
SHARE = {"balanced": {"state": 0.15, "enc": 0.15, "lstm": 0.02},
         "fast": {"state": 0.25, "enc": 0.12, "lstm": 0.02},
         "turbo": {"state": 0.25, "enc": 0.12, "lstm": 0.02}}
#: shares are held from this many streams on
SHARE_MIN_BATCH = 1024
#: the largest difference by tier and batch class ("1", "small": below
#: SHARE_MIN_BATCH, "large"; "lstm": lstm_decoder_fused at every batch),
#: three times the largest reading of the class, rounded up
MAX = {
    "balanced": {
        "1": {"probs": 1e-6, "h": 1e-4, "c": 2e-5, "enc": 2e-4, "mag": 5e-6},
        "small": {"probs": 2.5e-5, "h": 3.5e-4, "c": 6e-5, "enc": 4e-4, "mag": 5e-6},
        "large": {"probs": 2e-4, "h": 1.5e-3, "c": 5e-4, "enc": 3e-3, "mag": 5e-6},
        "lstm": {"probs": 1.5e-5, "h": 6e-5, "c": 2e-5},
    },
    "fast": {
        "1": {"probs": 1e-6, "h": 2e-6, "c": 1e-6, "enc": 2e-6, "mag": 5e-6},
        "small": {"probs": 3.5e-3, "h": 5e-2, "c": 7e-3, "enc": 0.11, "mag": 5e-6},
        "large": {"probs": 2e-2, "h": 0.2, "c": 6e-2, "enc": 0.6, "mag": 5e-6},
        "lstm": {"probs": 2.5e-4, "h": 3e-3, "c": 4.5e-3},
    },
    "turbo": {
        "1": {"probs": 1e-6, "h": 1e-6, "c": 1e-6, "enc": 1e-6, "mag": 1e-6},
        "small": {"probs": 9e-3, "h": 0.25, "c": 3e-2, "enc": 0.25, "mag": 1e-6},
        "large": {"probs": 3.5e-2, "h": 0.4, "c": 8e-2, "enc": 0.6, "mag": 1e-6},
        "lstm": {"probs": 1.5e-6, "h": 9e-3, "c": 1e-3},
    },
}
#: each tier's largest deviation from faithful on speech (StreamRunner over
#: vadc_tpu_torch.io.synthaudio.utterance_track(4, seed), one stream). The
#: port's plain versions on the CPU read at most 1.25e-3 (balanced), 2.38e-2
#: (fast) and 1.64e-1 (turbo) over seeds 0-11; the kernels on an H100 read
#: 1.19e-3, 2.22e-2 and 1.68e-1. Rounded up.
SPEECH_BOUND = {"balanced": 1.5e-3, "fast": 3e-2, "turbo": 2e-1}


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
    forward_fused, encode_fused_audio, forward_fused2d, lstm_decoder_fused
    or dot_magnitude. `envelope` holds the largest differences to the large
    batches' limits at every batch: for inputs other than chip_smoke.py's,
    whose readings set the tighter classes."""
    lstm = kernel == "lstm_decoder_fused"
    cls = "lstm" if lstm else ("large" if envelope or batch >= SHARE_MIN_BATCH else
                               ("1" if batch == 1 else "small"))
    out = []
    for name, (largest, share) in errs.items():
        limit = MAX[tier][cls][name]
        if not largest <= limit:  # NaN breaks it too
            out.append(f"{kernel} {name}: largest difference {largest:.3e} > {limit:g}")
        if name != "mag" and batch >= SHARE_MIN_BATCH:
            most = SHARE[tier]["lstm" if lstm else ("enc" if name == "enc" else "state")]
            if share > most:
                out.append(f"{kernel} {name}: {share:.4f} of the outputs differ by more than "
                           f"{TAU[tier]:g} > {most:g}")
    return out
