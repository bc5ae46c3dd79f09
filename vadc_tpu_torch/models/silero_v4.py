"""Silero VAD v4 forward passes (16 kHz, and the 8 kHz branch as `v4_8k`).

Counterpart of vadc_tpu/models/silero_v4.py. v4 differs from v3.1
(reference Silero_V4, silero_vad.py:191-236):

    audio [B, S] --reflect pad 96/96, hop 64--> STFT magnitude [B, F, 129]
    -> adaptive audio normalization; cat([spect, normalized]) -> [B, F, 258]
    -> 4 conv stages (ConvBlock + strided 1x1 conv + BN + ReLU, no
       transformer), strides 2,2,2,1 at 16 kHz and 2,2,1,1 at 8 kHz
    -> 2-layer LSTM (hidden 64) -> decoder (relu, conv 64->1, sigmoid,
       frame mean) -> speech probability

Chunks are 512..1536 samples in steps of 256 at 16 kHz (256..768 in steps
of 128 at 8 kHz). `forward`, `forward_scan` and `forward_minibatched` go
through the two kernel wrappers `kernels.stft_mag.stft_magnitude` and
`kernels.lstm.lstm_fused`; the normalization, the conv stages and the
decoder are torch ops, as the JAX package leaves them to XLA. On a CPU
tensor the wrappers run their plain versions. `forward_scan` is the slab
scan behind `StreamRunner.scan` (models/slab.py: the encoder over the B*K
chunks, one `lstm_fused` through each stream's chunks). `forward_reference`,
`forward_scan_reference` and `forward_minibatched_reference` are the JAX
package's `forward`, chunk-blocked scan (`engine/runner._scan_tblock`) and
`forward_minibatched` in the plain ops of nn/functional, on any device.

Every function takes the precision tier (`nn.precision`; a name or a Tier,
default faithful), as the JAX package's model code computes at it under
`precision_mode`: the spectrum at the tier's log-sensitive STFT operands
(`stft_mode(tier, True)`: log1p(2^20 x) follows), every product (the conv
stages' linears, the LSTM's gates, the decoder) at the tier's, the tier's
tanh and log1p, and in turbo the spectrum channel, the normalized half and
every stage's output stored bf16; the LSTM, the decoder and the state stay
fp32. The two kernels run the tier's instances.
"""

from __future__ import annotations

import torch

from vadc_tpu_torch.kernels.lstm import lstm_fused, weight_of
from vadc_tpu_torch.kernels.stft_mag import split_basis_of, stft_magnitude
from vadc_tpu_torch.models import slab
from vadc_tpu_torch.models.weights import V4_STRIDES_16K, V4_STRIDES_8K, Params
from vadc_tpu_torch.nn import functional as F
from vadc_tpu_torch.nn.precision import FAITHFUL, Tier, stft_mode, store, tier_of

SAMPLE_RATE = 16000
NUM_LSTM_LAYERS = 2
HIDDEN = 64
STFT_PAD = 96
STFT_HOP = 64


def init_state(n_streams: int, device="cpu") -> tuple[torch.Tensor, torch.Tensor]:
    """Zero LSTM state for a batch of independent streams: (h, c) [2, B, 64]."""
    shape = (NUM_LSTM_LAYERS, n_streams, HIDDEN)
    return (
        torch.zeros(shape, dtype=torch.float32, device=device),
        torch.zeros(shape, dtype=torch.float32, device=device),
    )


def conv_stage(x: torch.Tensor, p: dict, *, stride: int, tier: Tier = FAITHFUL) -> torch.Tensor:
    """v4 encoder stage over [B, L, C] at the tier: ConvBlock -> strided 1x1
    conv -> BatchNorm (absent in folded archives) -> ReLU."""
    h = F.conv_block_nlc(
        x, p["dw_w"], p["dw_b"], p["pw_w"], p["pw_b"], p.get("proj_w"), p.get("proj_b"), tier
    )
    if stride != 1:
        h = h[:, ::stride, :]
    h = F.linear_at(h, p["conv_w"], p["conv_b"], tier)
    if "bn_w" in p:
        h = F.batch_norm1d_nlc(h, p["bn_mean"], p["bn_var"], p["bn_w"], p["bn_b"], tier)
    return torch.relu(h)


def encoder_input(spect: torch.Tensor, tier: Tier) -> torch.Tensor:
    """The first conv stage's input: cat([spect, its adaptive
    normalization]) -> [B, F, 258]."""
    normalized = F.adaptive_audio_normalization_nlc(spect, tier)
    return torch.cat([store(spect, tier), normalized], dim=-1)


def _encoder(params: dict, spect: torch.Tensor, sample_rate: int, tier: Tier) -> torch.Tensor:
    x = encoder_input(spect, tier)
    strides = V4_STRIDES_16K if sample_rate == 16000 else V4_STRIDES_8K
    for stage_params, stride in zip(params["stages"], strides):
        x = conv_stage(x, stage_params, stride=stride, tier=tier)
    return x


def spectrum(params: Params, audio: torch.Tensor, tier: Tier) -> torch.Tensor:
    """audio [B, S] -> STFT magnitude [B, F, 129]: the stft_magnitude
    kernel's instance of the tier's STFT operands."""
    wr, wi = split_basis_of(params)
    return stft_magnitude(audio, wr, wi, pad_left=STFT_PAD, pad_right=STFT_PAD, hop=STFT_HOP,
                          mode=stft_mode(tier))


def encode(
    params: Params, audio: torch.Tensor, *, sample_rate: int = 16000, tier: Tier | str = FAITHFUL
) -> torch.Tensor:
    """audio [B, S] -> features [B, T, 64] at the tier; the spectrum is the
    stft_magnitude kernel's instance of the tier's STFT operands."""
    tier = tier_of(tier)
    return _encoder(params, spectrum(params, audio, tier), sample_rate, tier)


def encode_reference(
    params: dict, audio: torch.Tensor, *, sample_rate: int = 16000, tier: Tier | str = FAITHFUL
) -> torch.Tensor:
    """Plain front-end + encoder at the tier (the JAX package's `encode`
    under `precision_mode(tier)`)."""
    tier = tier_of(tier)
    spect = F.stft_magnitude_nlc(
        audio, params["stft_basis"], pad_left=STFT_PAD, pad_right=STFT_PAD, hop=STFT_HOP,
        tier=tier,
    )
    return _encoder(params, spect, sample_rate, tier)


def _forward(params, audio, h, c, hn, cn, sample_rate, tier):
    tier = tier_of(tier)
    feats = encode(params, audio, sample_rate=sample_rate, tier=tier)
    out, hn, cn = lstm_fused(
        feats, h, c, params["lstm_w"], params["lstm_b"], hn=hn, cn=cn,
        wt=weight_of(params, tier), tier=tier,
    )
    return F.decoder_v5_nlc(out, params["dec_w"], params["dec_b"], tier), hn, cn


def _forward_minibatched(params, audio, h, c, sample_rate, tier):
    tier = tier_of(tier)
    feats = encode(params, audio, sample_rate=sample_rate, tier=tier)  # [N, T, 64]
    n, t, width = feats.shape
    # the N chunks' frames as one sequence: one launch at batch 1
    out, hn, cn = lstm_fused(
        feats.reshape(1, n * t, width), h, c, params["lstm_w"], params["lstm_b"],
        wt=weight_of(params, tier), tier=tier,
    )
    probs = F.decoder_v5_nlc(out.reshape(n, t, width), params["dec_w"], params["dec_b"], tier)
    return probs, hn, cn


def _forward_scan(params, audio, h, c, hn, cn, sample_rate, tier):
    tier = tier_of(tier)
    return slab.forward_scan(
        params, lambda rows: encode(params, rows, sample_rate=sample_rate, tier=tier), audio, h, c,
        hn, cn, tier,
    )


def _forward_scan_reference(params, audio, h, c, sample_rate, tier):
    tier = tier_of(tier)
    return slab.forward_scan_reference(
        params, lambda rows: encode_reference(params, rows, sample_rate=sample_rate, tier=tier),
        audio, h, c, tier,
    )


def _forward_reference(params, audio, h, c, sample_rate, tier):
    tier = tier_of(tier)
    feats = encode_reference(params, audio, sample_rate=sample_rate, tier=tier)
    out, hn, cn = F.lstm(feats, h, c, params["lstm_w"], params["lstm_b"], tier)
    return F.decoder_v5_nlc(out, params["dec_w"], params["dec_b"], tier), hn, cn


def _forward_minibatched_reference(params, audio, h, c, sample_rate, tier):
    tier = tier_of(tier)
    feats = encode_reference(params, audio, sample_rate=sample_rate, tier=tier)
    out, hn, cn = F.lstm_minibatched(feats, h, c, params["lstm_w"], params["lstm_b"], tier)
    return F.decoder_v5_nlc(out, params["dec_w"], params["dec_b"], tier), hn, cn


def forward(
    params: Params,
    audio: torch.Tensor,
    h: torch.Tensor,
    c: torch.Tensor,
    *,
    hn: torch.Tensor | None = None,
    cn: torch.Tensor | None = None,
    tier: Tier | str = FAITHFUL,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Batched independent-stream forward at the tier: audio [B, S]; h, c
    [2, B, 64] -> (probs [B], hn, cn). `hn`/`cn` may be `h`/`c` to update
    the state in place (see kernels.lstm.lstm_fused)."""
    return _forward(params, audio, h, c, hn, cn, SAMPLE_RATE, tier)


def forward_scan(
    params: Params,
    audio: torch.Tensor,
    h: torch.Tensor,
    c: torch.Tensor,
    *,
    hn: torch.Tensor | None = None,
    cn: torch.Tensor | None = None,
    tier: Tier | str = FAITHFUL,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """A slab of K consecutive chunks of each of B independent streams at
    the tier: audio [B, K, S]; h, c [2, B, 64] -> (probs [B, K], hn, cn),
    K calls of `forward` in order (models/slab.py). `hn`/`cn` may be
    `h`/`c` to update the state in place."""
    return _forward_scan(params, audio, h, c, hn, cn, SAMPLE_RATE, tier)


def forward_minibatched(
    params: Params, audio: torch.Tensor, h: torch.Tensor, c: torch.Tensor,
    tier: Tier | str = FAITHFUL,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Reference-parity forward at the tier: the N rows of audio [N, S] are
    consecutive chunks of ONE stream; h, c [2, 1, 64]. The N chunks' frames
    run through the LSTM as one sequence (nn.functional.lstm_minibatched),
    in one lstm_fused launch. Returns (probs [N], hn, cn)."""
    return _forward_minibatched(params, audio, h, c, SAMPLE_RATE, tier)


def forward_reference(
    params: dict, audio: torch.Tensor, h: torch.Tensor, c: torch.Tensor,
    tier: Tier | str = FAITHFUL,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain independent-stream forward (the JAX package's `forward`) at the
    tier."""
    return _forward_reference(params, audio, h, c, SAMPLE_RATE, tier)


def forward_scan_reference(
    params: dict, audio: torch.Tensor, h: torch.Tensor, c: torch.Tensor,
    tier: Tier | str = FAITHFUL,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain slab scan (the JAX package's `_scan_tblock`) at the tier:
    audio [B, K, S] -> (probs [B, K], hn, cn)."""
    return _forward_scan_reference(params, audio, h, c, SAMPLE_RATE, tier)


def forward_minibatched_reference(
    params: dict, audio: torch.Tensor, h: torch.Tensor, c: torch.Tensor,
    tier: Tier | str = FAITHFUL,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain minibatched forward (the JAX package's `forward_minibatched`)
    at the tier."""
    return _forward_minibatched_reference(params, audio, h, c, SAMPLE_RATE, tier)


class _V48k:
    """Module shim for the 8 kHz branch of the official v4 model (stage-3
    conv stride 1; chunk sizes are in 8 kHz samples), as in vadc_tpu."""

    SAMPLE_RATE = 8000
    NUM_LSTM_LAYERS = NUM_LSTM_LAYERS
    HIDDEN = HIDDEN
    init_state = staticmethod(init_state)

    @staticmethod
    def encode(params, audio, tier=FAITHFUL):
        return encode(params, audio, sample_rate=8000, tier=tier)

    @staticmethod
    def encode_reference(params, audio, tier=FAITHFUL):
        return encode_reference(params, audio, sample_rate=8000, tier=tier)

    @staticmethod
    def forward(params, audio, h, c, *, hn=None, cn=None, tier=FAITHFUL):
        return _forward(params, audio, h, c, hn, cn, 8000, tier)

    @staticmethod
    def forward_scan(params, audio, h, c, *, hn=None, cn=None, tier=FAITHFUL):
        # the 8 kHz encoder, with its own stage-3 stride, over the slab
        return _forward_scan(params, audio, h, c, hn, cn, 8000, tier)

    @staticmethod
    def forward_minibatched(params, audio, h, c, tier=FAITHFUL):
        return _forward_minibatched(params, audio, h, c, 8000, tier)

    @staticmethod
    def forward_reference(params, audio, h, c, tier=FAITHFUL):
        return _forward_reference(params, audio, h, c, 8000, tier)

    @staticmethod
    def forward_scan_reference(params, audio, h, c, tier=FAITHFUL):
        return _forward_scan_reference(params, audio, h, c, 8000, tier)

    @staticmethod
    def forward_minibatched_reference(params, audio, h, c, tier=FAITHFUL):
        return _forward_minibatched_reference(params, audio, h, c, 8000, tier)


v4_8k = _V48k()
