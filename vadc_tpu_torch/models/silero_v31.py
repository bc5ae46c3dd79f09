"""Silero VAD v3.1 16 kHz forward passes.

Counterpart of vadc_tpu/models/silero_v31.py. Pipeline (reference
silero_v3.c:72-215; Silero_V3.forward, silero_vad.py:262-272):

    audio [B, S] --reflect pad 128/128, hop 64--> STFT magnitude [B, F, 129]
    -> adaptive audio normalization
    -> 4 encoder stages (ConvBlock + TransformerBlock + strided 1x1 conv + BN
       + ReLU), conv strides 2,2,1,1
    -> 2-layer LSTM (hidden 64) -> v3 decoder -> speech probability

Chunks are 512..1536 samples in steps of 256, which gives F = S/64 + 1 =
9, 13, 17, 21 or 25 frames.

Which path launches which kernel:

  * `forward`, the independent-stream step behind `StreamRunner.step/scan`
    (and so every server tick of a v3.1 model), is ONE kernel from raw
    audio: `kernels.silero_v31_fused.forward_fused` (STFT, adaptive
    normalization, encoder, LSTM, decoder).
  * `forward_scan`, the slab scan behind `StreamRunner.scan` (the offline
    corpus path), takes K chunks of each of B streams:
    `kernels.silero_v31_fused.encode_fused_audio` (the step kernel's own
    front-end and encoder, from raw audio) over all B*K chunks at once, then
    ONE call of `kernels.lstm_decoder.lstm_decoder_fused`, which walks the K
    chunks of each stream in order. Only the LSTM carries anything from
    chunk to chunk, so on the card the slab equals the loop of steps bit for
    bit.
  * `forward_minibatched`, the CLI's path through `MinibatchRunner`, is
    `forward_scan` at B = 1 over the window's N chunks.

Every function takes the precision tier (`nn.precision`: faithful,
balanced, fast, turbo; a name or a Tier, default faithful) and passes it to
every kernel it launches, each of which has an instance of each tier. On a
CUDA tensor the wrappers launch the CUDA kernels; on a CPU tensor they run
their plain versions. `forward_reference` and
`forward_minibatched_reference` are the JAX package's `forward` and
`forward_minibatched` written with the plain ops of nn/functional, on any
device.

Profiling zones (tracing.zone) sit where the JAX package puts them:
`stft`, `adaptive_norm`, `encoder_layer_1..4`, `lstm` and `decoder` on the
plain path; on the kernel path a zone is the kernel's name (`forward_fused`,
`encode_fused_audio`, `lstm_decoder_fused`), around its plain version's
zones on the CPU.
"""

from __future__ import annotations

import torch

from vadc_tpu_torch.kernels.lstm_decoder import lstm_decoder_fused
from vadc_tpu_torch.kernels.lstm_decoder import weight_of as lstm_weight_of
from vadc_tpu_torch.kernels.silero_v31_fused import encode_fused_audio, forward_fused
from vadc_tpu_torch.kernels.stft_dotmag import dot_magnitude
from vadc_tpu_torch.kernels.stft_mag import split_basis_of
from vadc_tpu_torch.models.weights import V3_STRIDES, Params
from vadc_tpu_torch.nn import functional as F
from vadc_tpu_torch.nn.precision import FAITHFUL, Tier, tier_of
from vadc_tpu_torch.tracing import zone

SAMPLE_RATE = 16000
CHUNK_SAMPLES_DEFAULT = 1536  # 96 ms; any multiple of 256 in [512, 1536]
NUM_LSTM_LAYERS = 2
HIDDEN = 64
STFT_PAD = 128
STFT_HOP = 64
# Rows (streams x chunks) of a slab that go through the front-end and the
# encoder in one launch. A larger slab is cut over rows, never over chunks.
SCAN_ROWS = 16384


def init_state(n_streams: int, device="cpu") -> tuple[torch.Tensor, torch.Tensor]:
    """Zero LSTM state for a batch of independent streams: (h, c) [2, B, 64]."""
    shape = (NUM_LSTM_LAYERS, n_streams, HIDDEN)
    return (
        torch.zeros(shape, dtype=torch.float32, device=device),
        torch.zeros(shape, dtype=torch.float32, device=device),
    )


def features(params: Params, audio: torch.Tensor, tier: Tier | str = FAITHFUL) -> torch.Tensor:
    """Front-end at the tier: audio [B, S] -> normalized features [B, F, 129].

    The framing is a view (reflect pad, then unfold); the spectrum product
    and its magnitude are the dot_magnitude kernel; the adaptive
    normalization stays in torch ops, as the JAX package leaves it to XLA.
    The front-end for callers of `forward_fused2d` and `encode_fused`; the
    model's own paths run theirs inside `forward_fused` and
    `encode_fused_audio`."""
    tier = tier_of(tier)
    basis = params["stft_basis"]
    frames = F.frame(F.reflect_pad_last(audio, STFT_PAD, STFT_PAD), basis.shape[1], STFT_HOP)
    wr, wi = split_basis_of(params)
    return F.adaptive_audio_normalization_nlc(dot_magnitude(frames, wr, wi, tier), tier)


def encode_nlc(params: dict, audio: torch.Tensor, tier: Tier | str = FAITHFUL) -> torch.Tensor:
    """Plain front-end + encoder at the tier: audio [B, S] -> features [B,
    T, 64] (the JAX package's `encode_nlc` under `precision_mode(tier)`)."""
    tier = tier_of(tier)
    with zone("stft"):
        spect = F.stft_magnitude_nlc(
            audio, params["stft_basis"], pad_left=STFT_PAD, pad_right=STFT_PAD, hop=STFT_HOP,
            tier=tier,
        )
    with zone("adaptive_norm"):
        x = F.adaptive_audio_normalization_nlc(spect, tier)
    for i, (layer_params, stride) in enumerate(zip(params["layers"], V3_STRIDES)):
        with zone(f"encoder_layer_{i + 1}"):
            x = F.transformer_layer_nlc(x, layer_params, stride=stride, tier=tier)
    return x


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
    """Batched independent-stream forward: audio [B, S]; h, c [2, B, 64]
    -> (probs [B], hn, cn). `hn`/`cn` may be `h`/`c` to update the state
    in place (see forward_fused)."""
    with zone("forward_fused"):
        return forward_fused(params, audio, h, c, hn=hn, cn=cn, tier=tier)


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
    """A slab of K consecutive chunks of each of B independent streams:
    audio [B, K, S]; h, c [2, B, 64] -> (probs [B, K], hn, cn), equal to K
    calls of `forward` in order (bit for bit on the card, where both run
    the same device code; to the rounding of the LSTM's sums on the CPU).

    The front-end and the encoder are per chunk, so they run over the B*K
    chunks as one batch; the LSTM and the decoder then walk each stream's K
    chunks in order in one kernel. `hn`/`cn` may be `h`/`c` to update the
    state in place. Both kernels run the tier's instance, which share its
    products and tanh, so the slab still equals the loop of steps."""
    tier = tier_of(tier)
    n_streams, n_chunks, samples = audio.shape
    flat = audio.reshape(n_streams * n_chunks, samples)
    with zone("encode_fused_audio"):
        pieces = [
            encode_fused_audio(params, flat[r0 : r0 + SCAN_ROWS], tier)
            for r0 in range(0, flat.shape[0], SCAN_ROWS)
        ]
    enc = pieces[0] if len(pieces) == 1 else torch.cat(pieces)
    x = enc.reshape(n_streams, n_chunks, enc.shape[1], HIDDEN)
    with zone("lstm_decoder_fused"):
        return lstm_decoder_fused(
            x, h, c, params["lstm_w"], params["lstm_b"], params["dec_w"], params["dec_b"],
            hn=hn, cn=cn, wt=lstm_weight_of(params, tier), tier=tier,
        )


def forward_minibatched(
    params: Params, audio: torch.Tensor, h: torch.Tensor, c: torch.Tensor,
    tier: Tier | str = FAITHFUL,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Reference-parity forward: the N rows of audio [N, S] are consecutive
    chunks of ONE stream; h, c [2, 1, 64]. Returns (probs [N], hn, cn).

    The JAX package flattens the N chunks' frames into one LSTM sequence
    (nn.functional.lstm_minibatched). Only the LSTM carries anything from
    chunk to chunk: the encoder and the decoder are per chunk. So this is
    the slab scan of one stream: the front-end and the encoder for all N
    chunks at once, then the LSTM and the decoder through the chunks in
    order in one launch. That is exactly the flattened-sequence semantics
    (forward_minibatched_reference computes it the flattened way)."""
    probs, hn, cn = forward_scan(params, audio[None], h, c, tier=tier)
    return probs[0], hn, cn


def forward_reference(
    params: dict, audio: torch.Tensor, h: torch.Tensor, c: torch.Tensor,
    tier: Tier | str = FAITHFUL,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain independent-stream forward (the JAX package's `forward`) at the
    tier."""
    tier = tier_of(tier)
    x = encode_nlc(params, audio, tier)
    with zone("lstm"):
        out, hn, cn = F.lstm(x, h, c, params["lstm_w"], params["lstm_b"], tier)
    with zone("decoder"):
        return F.decoder_v3_nlc(out, params["dec_w"], params["dec_b"], tier), hn, cn


def forward_minibatched_reference(
    params: dict, audio: torch.Tensor, h: torch.Tensor, c: torch.Tensor,
    tier: Tier | str = FAITHFUL,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain minibatched forward (the JAX package's `forward_minibatched`)
    at the tier: the N chunks' frames flattened into one LSTM sequence."""
    tier = tier_of(tier)
    out, hn, cn = F.lstm_minibatched(
        encode_nlc(params, audio, tier), h, c, params["lstm_w"], params["lstm_b"], tier
    )
    return F.decoder_v3_nlc(out, params["dec_w"], params["dec_b"], tier), hn, cn
