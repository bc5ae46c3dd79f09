"""The four precision tiers, as arguments.

Counterpart of `PRECISION_MODES` in vadc_tpu/nn/functional.py. The JAX
package selects a tier with a context (`precision_mode`) that sets module
globals at trace time, and on the CPU, where XLA ignores matmul precision
flags, its tiers compute in fp32. The port passes the tier down explicitly
(a `Tier`, never a global) and emulates the TPU arithmetic that the JAX
package documents for it, so the CPU and the card compute the same thing:

  tier      products        v3.1/v4 STFT       v5 STFT  tanh      log1p    encoder storage
  faithful  fp32            fp32               fp32     exp form  series   fp32
  balanced  bf16_3x         bf16_3x            bf16_3x  exp form  builtin  fp32
  fast      bf16 operands   bf16_3x (fp32 in)  bf16     builtin   builtin  fp32
  turbo     bf16 operands   bf16 operands      bf16     builtin   builtin  bf16

The products are every linear, conv tap, LSTM gate and decoder product, with
fp32 sums; bf16_3x is hi*hi + hi*lo + lo*hi.

The STFT's column follows the JAX package's `_stft_precision`: where the
spectrum feeds log1p(2^20 x) (v3.1 and v4, `log_sensitive`), fast keeps it
at bf16_3x on fp32 samples, since the log would amplify bf16's noise floor
at near-zero bins; v5's spectrum feeds convs directly and takes bf16
operands from fast on (`stft_mode`).

hi = bf16(x) and lo = bf16(x - hi), both rounded to nearest even (on the
card __float2bfloat16_rn). A product of bf16 values is exact in fp32, so a
plain version computes each product as an fp32 `matmul` of bf16-rounded
values (never a bf16 `matmul`: cuBLAS may reduce bf16 in reduced precision,
and the CPU's bf16 GEMM is other arithmetic). Turbo's bf16 storage is
emulated by rounding an fp32 value where the JAX package stores bf16
(`store`): v3.1's encoder, v4's spectrum channel, normalized half and conv
stages, v5's spectrum and convs. The softmax and layer-norm statistics, the
attention's two sums, the LSTM (its input promoted to fp32, as the JAX
package's concatenate with h does), the decoder and the state stay fp32.

The adaptive normalization's 7-tap smoothing, a product of each frame's
window of means with one vector of taps, stays fp32 at every tier. XLA
reduces a dot with a vector operand to an elementwise product and a sum,
outside the matmul precision; what the JAX package recorded on a TPU agrees
with that and not with bf16 taps: on its own check material
(vadc_tpu/io/synthaudio.py utterance_track(4, seed=0), tools/tpu_check.py
`speech_*`) the JAX package recorded a fast-tier deviation of 7.4e-3 from
faithful; the port's plain versions measure 7.4e-3 with the smoothing in
fp32 and 2.5e-2 with its operands at bf16
(tests/test_torch_tiers.py::test_the_smoothing_product_stays_fp32_at_every_tier).

Every family runs every tier: Silero v3.1, v4 (16 and 8 kHz) and v5 (16
and 8 kHz).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class Tier:
    """What one tier does to the arithmetic. `index` is the instance of the
    CUDA kernels (their template parameter, csrc/tier.cuh)."""

    name: str
    index: int
    products: str  # "fp32", "bf16_3x" or "bf16"
    stft: str  # the log-sensitive (v3.1, v4) STFT's products: "fp32", "bf16_3x" or "bf16"
    exp_tanh: bool  # the exp-form tanh (else the builtin)
    series_log1p: bool  # the 1-ulp log1p series (else the builtin)
    bf16_storage: bool  # the encoder's activations stored as bf16

    def __str__(self) -> str:
        return self.name


FAITHFUL = Tier("faithful", 0, "fp32", "fp32", True, True, False)
BALANCED = Tier("balanced", 1, "bf16_3x", "bf16_3x", True, False, False)
FAST = Tier("fast", 2, "bf16", "bf16_3x", False, False, False)
TURBO = Tier("turbo", 3, "bf16", "bf16", False, False, True)

TIERS = {t.name: t for t in (FAITHFUL, BALANCED, FAST, TURBO)}


def tier_of(precision: str | Tier) -> Tier:
    """The Tier of a tier name (or the Tier itself)."""
    if isinstance(precision, Tier):
        return precision
    try:
        return TIERS[precision]
    except KeyError:
        raise ValueError(f"unknown precision {precision!r}") from None


def stft_mode(tier: Tier, log_sensitive: bool = True) -> str:
    """The STFT products' operands at the tier (the JAX package's
    `_stft_precision`): the tier's `stft` where log1p(2^20 x) follows (v3.1,
    v4), else (v5) bf16 wherever the tier's products are bf16."""
    if log_sensitive or tier.products != "bf16":
        return tier.stft
    return "bf16"


def bf16(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bf16 (nearest even), as fp32."""
    return x.to(torch.bfloat16).to(torch.float32)


def split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) = (bf16(x), bf16(x - hi)), both fp32."""
    hi = bf16(x)
    return hi, bf16(x - hi)


def matmul_at(a: torch.Tensor, b: torch.Tensor, mode: str) -> torch.Tensor:
    """a @ b with the operands of `mode` ("fp32", "bf16_3x", "bf16") and
    fp32 sums; bf16_3x adds its three products in the order written."""
    if mode == "fp32":
        return torch.matmul(a, b)
    if mode == "bf16":
        return torch.matmul(bf16(a), bf16(b))
    a_hi, a_lo = split(a)
    b_hi, b_lo = split(b)
    return torch.matmul(a_hi, b_hi) + torch.matmul(a_hi, b_lo) + torch.matmul(a_lo, b_hi)


def store(x: torch.Tensor, tier: Tier) -> torch.Tensor:
    """x as the tier stores an encoder activation: bf16-rounded in turbo."""
    return bf16(x) if tier.bf16_storage else x


def tanh_at(x: torch.Tensor, tier: Tier) -> torch.Tensor:
    """The tier's tanh: the exp form at faithful and balanced (vadc_tpu
    functional._tanh), the builtin at fast and turbo."""
    if tier.exp_tanh:
        e = torch.exp(-2.0 * torch.abs(x))
        return torch.sign(x) * (1.0 - e) / (1.0 + e)
    return torch.tanh(x)


def pack_operand(w: torch.Tensor, mode: str) -> torch.Tensor:
    """A weight as the CUDA kernels read it for products of `mode`
    (csrc/tier.cuh): fp32 as it is; bf16 rounded; bf16_3x as one 32-bit
    word a value, hi's bf16 bits in the upper half and lo's in the lower,
    held in an fp32 tensor of w's shape (read as a float, the word is within
    2^-8 of w, and it is never computed with as one)."""
    if mode == "fp32":
        return w
    if mode == "bf16":
        return bf16(w)
    hi, lo = split(w)
    words = (hi.view(torch.int32) & -65536) | ((lo.view(torch.int32) >> 16) & 0xFFFF)
    return words.view(torch.float32)
