"""Silero VAD v5 forward passes (16 kHz, and the 8 kHz branch as `v5_8k`).

Counterpart of vadc_tpu/models/silero_v5.py (reference Silero_Vad_5,
silero_vad.py:367-433):

  * each 512-sample chunk is prefixed with the previous chunk's last 64
    samples (the context) -> 576-sample model input;
  * STFT magnitude: reflect pad right-only 64, hop 128 -> [B, 4, 129];
  * encoder: 4 reparameterized k3 convs (pad 1, strides 1, 2, 2, 1), each
    + ReLU -> [B, 1, 128];
  * 1-layer LSTM, hidden 128;
  * decoder: relu -> conv 128->1 -> sigmoid -> frame mean.

The 8 kHz branch (`v5_8k`) has the same encoder and LSTM at half-rate STFT
geometry: 256-sample chunks with a 32-sample context, n_fft 128 (65 bins),
right pad 32, hop 64. `forward` and `forward_minibatched` go through the
kernel wrappers `kernels.stft_mag.stft_magnitude` and
`kernels.lstm.lstm_fused`; the convs and the decoder are torch ops. The
`*_reference` forms are the JAX package's functions in the plain ops of
nn/functional. The context is the caller's: the runners attach it
(`attach_context`) before the model sees the audio.

Every function takes the precision tier (`nn.precision`; a name or a Tier,
default faithful), as the JAX package's model code computes at it under
`precision_mode`: the spectrum at `stft_mode(tier, log_sensitive=False)`
(no log follows: bf16 operands from fast on), every product (the convs'
taps, the LSTM's gates, the decoder) at the tier's, the tier's tanh, and in
turbo the spectrum and every conv's taps, partial sums and bias stored bf16;
the LSTM, the decoder and the state stay fp32. The two kernels run the
tier's instances.

Only synthetic weights of the official shapes exist in the repository
(models/synthetic.py); results on them are labelled so.
"""

from __future__ import annotations

import torch

from vadc_tpu_torch.kernels.lstm import lstm_fused, weight_of
from vadc_tpu_torch.kernels.stft_mag import split_basis_of, stft_magnitude
from vadc_tpu_torch.models.weights import Params
from vadc_tpu_torch.nn import functional as F
from vadc_tpu_torch.nn.precision import FAITHFUL, Tier, stft_mode, store, tier_of

SAMPLE_RATE = 16000
CONTEXT_SAMPLES = 64  # reference SILERO_V5_CONTEXT_SIZE (vadc.h:90)
WINDOW_SAMPLES = 512
NUM_LSTM_LAYERS = 1
HIDDEN = 128
STFT_PAD_RIGHT = 64
STFT_HOP = 128

ENCODER_STRIDES = (1, 2, 2, 1)


def init_state(n_streams: int, device="cpu") -> tuple[torch.Tensor, torch.Tensor]:
    """Zero LSTM state: (h, c) [1, B, 128]."""
    shape = (NUM_LSTM_LAYERS, n_streams, HIDDEN)
    return (
        torch.zeros(shape, dtype=torch.float32, device=device),
        torch.zeros(shape, dtype=torch.float32, device=device),
    )


def init_context(n_streams: int, device="cpu") -> torch.Tensor:
    """Zero audio context carried between consecutive chunks: [B, 64]."""
    return torch.zeros((n_streams, CONTEXT_SAMPLES), dtype=torch.float32, device=device)


def attach_context(
    chunks: torch.Tensor, context: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Prefix each chunk with the previous chunk's carried tail.

    chunks [B, window] new audio; context [B, ctx] (64 samples at 16 kHz,
    32 at 8 kHz). Returns (model input [B, ctx + window], the new context,
    a view of the chunks' tails). Reference: process_chunks_v5
    (vadc.c:105-162)."""
    return torch.cat([context, chunks], dim=-1), chunks[:, -context.shape[-1] :]


def conv_layer(x: torch.Tensor, p: dict, *, stride: int, tier: Tier) -> torch.Tensor:
    """One encoder layer over [B, L, C] at the tier: k3 conv (pad 1) ->
    ReLU."""
    return torch.relu(F.conv1d_nlc(x, p["w"], p["b"], stride=stride, padding=1, tier=tier))


def _convs(params: dict, spect: torch.Tensor, tier: Tier) -> torch.Tensor:
    x = store(spect, tier)  # turbo: the encoder starts in bf16
    for p, stride in zip(params["encoder"], ENCODER_STRIDES):
        x = conv_layer(x, p, stride=stride, tier=tier)
    return x


def spectrum(params: Params, audio: torch.Tensor, *, pad_right: int, hop: int,
             tier: Tier) -> torch.Tensor:
    """audio [B, ctx + window] -> STFT magnitude [B, frames, bins]: the
    stft_magnitude kernel's instance of the tier's v5 STFT operands (no
    left pad)."""
    wr, wi = split_basis_of(params)
    return stft_magnitude(audio, wr, wi, pad_left=0, pad_right=pad_right, hop=hop,
                          mode=stft_mode(tier, log_sensitive=False))


def encode(
    params: Params, audio: torch.Tensor, *, pad_right: int = STFT_PAD_RIGHT, hop: int = STFT_HOP,
    tier: Tier | str = FAITHFUL,
) -> torch.Tensor:
    """audio [B, ctx + window] -> features [B, frames, 128] at the tier; the
    spectrum is the stft_magnitude kernel's instance of the tier's v5 STFT
    operands (no left pad)."""
    tier = tier_of(tier)
    return _convs(params, spectrum(params, audio, pad_right=pad_right, hop=hop, tier=tier), tier)


def encode_reference(
    params: dict, audio: torch.Tensor, *, pad_right: int = STFT_PAD_RIGHT, hop: int = STFT_HOP,
    tier: Tier | str = FAITHFUL,
) -> torch.Tensor:
    """Plain front-end + encoder at the tier (the JAX package's `encode`
    under `precision_mode(tier)`)."""
    tier = tier_of(tier)
    spect = F.stft_magnitude_nlc(audio, params["stft_basis"], pad_left=0, pad_right=pad_right,
                                 hop=hop, tier=tier, log_sensitive=False)
    return _convs(params, spect, tier)


def _forward(params, audio, h, c, hn, cn, geometry, tier):
    tier = tier_of(tier)
    feats = encode(params, audio, **geometry, tier=tier)
    out, hn, cn = lstm_fused(
        feats, h, c, params["lstm_w"], params["lstm_b"], hn=hn, cn=cn,
        wt=weight_of(params, tier), tier=tier,
    )
    return F.decoder_v5_nlc(out, params["dec_w"], params["dec_b"], tier), hn, cn


def _forward_minibatched(params, audio, h, c, geometry, tier):
    tier = tier_of(tier)
    feats = encode(params, audio, **geometry, tier=tier)  # [N, T, 128]
    n, t, width = feats.shape
    # the N chunks' frames as one sequence: one launch at batch 1
    out, hn, cn = lstm_fused(
        feats.reshape(1, n * t, width), h, c, params["lstm_w"], params["lstm_b"],
        wt=weight_of(params, tier), tier=tier,
    )
    probs = F.decoder_v5_nlc(out.reshape(n, t, width), params["dec_w"], params["dec_b"], tier)
    return probs, hn, cn


def _forward_reference(params, audio, h, c, geometry, tier):
    tier = tier_of(tier)
    out, hn, cn = F.lstm(encode_reference(params, audio, **geometry, tier=tier), h, c,
                         params["lstm_w"], params["lstm_b"], tier)
    return F.decoder_v5_nlc(out, params["dec_w"], params["dec_b"], tier), hn, cn


def _forward_minibatched_reference(params, audio, h, c, geometry, tier):
    tier = tier_of(tier)
    out, hn, cn = F.lstm_minibatched(encode_reference(params, audio, **geometry, tier=tier), h, c,
                                     params["lstm_w"], params["lstm_b"], tier)
    return F.decoder_v5_nlc(out, params["dec_w"], params["dec_b"], tier), hn, cn


_GEOMETRY_16K = {"pad_right": STFT_PAD_RIGHT, "hop": STFT_HOP}


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
    """Independent-stream forward at the tier: audio [B, 576] (context
    attached); h, c [1, B, 128] -> (probs [B], hn, cn). `hn`/`cn` may be
    `h`/`c` to update the state in place."""
    return _forward(params, audio, h, c, hn, cn, _GEOMETRY_16K, tier)


def forward_minibatched(
    params: Params, audio: torch.Tensor, h: torch.Tensor, c: torch.Tensor,
    tier: Tier | str = FAITHFUL,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Consecutive chunks of ONE stream, each with its context attached:
    audio [N, 576]; h, c [1, 1, 128]. One lstm_fused launch over the N
    chunks' frames, at the tier. Returns (probs [N], hn, cn)."""
    return _forward_minibatched(params, audio, h, c, _GEOMETRY_16K, tier)


def forward_reference(params, audio, h, c, tier=FAITHFUL):
    """Plain independent-stream forward (the JAX package's `forward`) at the
    tier."""
    return _forward_reference(params, audio, h, c, _GEOMETRY_16K, tier)


def forward_minibatched_reference(params, audio, h, c, tier=FAITHFUL):
    """Plain minibatched forward (the JAX package's `forward_minibatched`)
    at the tier."""
    return _forward_minibatched_reference(params, audio, h, c, _GEOMETRY_16K, tier)


class _V58k:
    """Module shim for the 8 kHz branch of the official v5 model
    (`_model_8k`), as in vadc_tpu: 256-sample chunks, 32-sample context,
    n_fft 128, right pad 32, hop 64."""

    SAMPLE_RATE = 8000
    CONTEXT_SAMPLES = 32
    WINDOW_SAMPLES = 256
    NUM_LSTM_LAYERS = NUM_LSTM_LAYERS
    HIDDEN = HIDDEN
    STFT_PAD_RIGHT = 32
    STFT_HOP = 64
    _GEOMETRY = {"pad_right": STFT_PAD_RIGHT, "hop": STFT_HOP}

    init_state = staticmethod(init_state)
    attach_context = staticmethod(attach_context)

    @staticmethod
    def init_context(n_streams: int, device="cpu") -> torch.Tensor:
        return torch.zeros((n_streams, _V58k.CONTEXT_SAMPLES), dtype=torch.float32, device=device)

    @staticmethod
    def encode(params, audio, tier=FAITHFUL):
        return encode(params, audio, **_V58k._GEOMETRY, tier=tier)

    @staticmethod
    def encode_reference(params, audio, tier=FAITHFUL):
        return encode_reference(params, audio, **_V58k._GEOMETRY, tier=tier)

    @staticmethod
    def forward(params, audio, h, c, *, hn=None, cn=None, tier=FAITHFUL):
        return _forward(params, audio, h, c, hn, cn, _V58k._GEOMETRY, tier)

    @staticmethod
    def forward_minibatched(params, audio, h, c, tier=FAITHFUL):
        return _forward_minibatched(params, audio, h, c, _V58k._GEOMETRY, tier)

    @staticmethod
    def forward_reference(params, audio, h, c, tier=FAITHFUL):
        return _forward_reference(params, audio, h, c, _V58k._GEOMETRY, tier)

    @staticmethod
    def forward_minibatched_reference(params, audio, h, c, tier=FAITHFUL):
        return _forward_minibatched_reference(params, audio, h, c, _V58k._GEOMETRY, tier)


v5_8k = _V58k()
