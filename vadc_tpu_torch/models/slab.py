"""The slab scan of the v4 and v5 families: K consecutive chunks of each of
B independent streams in one pass.

Counterpart of the JAX package's chunk-blocked scan
(vadc_tpu/engine/runner.py: `_scan_tblock`) for the families whose
front-end and encoder are torch ops around the `stft_magnitude` kernel.
Only the LSTM carries anything from chunk to chunk, so the encoder runs
over the B*K chunks as one batch (in pieces of whole chunks:
SCAN_PIECE_CHUNKS), then ONE `lstm_fused` call walks each stream's K*F
frames in order, and the decoder runs over every chunk at once. The JAX
function walks blocks of `tblock` chunks because XLA needs a fixed shape;
one kernel call walks all the chunks here, so there is no block argument.
The models' `forward_scan` (silero_v4, silero_v5 and their 8 kHz shims)
are this with their own encoder. Spans (tracing.zone): `encode` around the
encoder's pieces and `lstm_decoder` around the LSTM and the decoder.
"""

from __future__ import annotations

from collections.abc import Callable

import torch

from vadc_tpu_torch.kernels.lstm import lstm_fused, weight_of
from vadc_tpu_torch.models.weights import Params
from vadc_tpu_torch.nn import functional as F
from vadc_tpu_torch.nn.precision import Tier
from vadc_tpu_torch.tracing import zone

#: Chunks of every stream that one piece of the encoder takes. The pieces
#: are cut over chunks, never over streams, so a slab's piece count depends
#: on K alone: a scan sharded over n devices launches `stft_magnitude` n
#: times as often as the unsharded one (chip_smoke.py: require_scaled). At
#: the 2048 streams of the batch CLI and the server a piece is 16384 rows,
#: v3.1's SCAN_ROWS: v4's first stage then holds [16384, 24, 258] fp32
#: tensors (406 MB each), where one pass over a 2048 x 64 slab would hold
#: 3.2 GB each.
SCAN_PIECE_CHUNKS = 8

Encoder = Callable[[torch.Tensor], torch.Tensor]


def encode_slab(encode: Encoder, audio: torch.Tensor) -> torch.Tensor:
    """audio [B, K, S] -> features [B, K, F, C]: `encode` (rows [N, S] ->
    [N, F, C]) over pieces of SCAN_PIECE_CHUNKS chunks of every stream; the
    last piece takes what is left."""
    n_streams, n_chunks, samples = audio.shape
    pieces = []
    for k0 in range(0, n_chunks, SCAN_PIECE_CHUNKS):
        piece = audio[:, k0 : k0 + SCAN_PIECE_CHUNKS]
        feats = encode(piece.reshape(-1, samples))
        pieces.append(feats.reshape(n_streams, piece.shape[1], *feats.shape[1:]))
    return pieces[0] if len(pieces) == 1 else torch.cat(pieces, dim=1)


def forward_scan(
    params: Params, encode: Encoder, audio: torch.Tensor, h: torch.Tensor, c: torch.Tensor,
    hn: torch.Tensor | None, cn: torch.Tensor | None, tier: Tier,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """audio [B, K, S] (a v5 chunk with its context attached); h, c [L, B,
    H] -> (probs [B, K], hn, cn): `encode_slab`, one `lstm_fused` over the
    K*F frames of each stream, the decoder over the B*K chunks. `hn`/`cn`
    may be `h`/`c` to update the state in place."""
    with zone("encode"):
        feats = encode_slab(encode, audio)
    n_streams, n_chunks, frames, width = feats.shape
    with zone("lstm_decoder"):
        out, hn, cn = lstm_fused(
            feats.reshape(n_streams, n_chunks * frames, width), h, c, params["lstm_w"],
            params["lstm_b"], hn=hn, cn=cn, wt=weight_of(params, tier), tier=tier,
        )
        probs = F.decoder_v5_nlc(out.reshape(-1, frames, width), params["dec_w"],
                                 params["dec_b"], tier)
    return probs.reshape(n_streams, n_chunks), hn, cn


def forward_scan_reference(
    params: dict, encode_reference: Encoder, audio: torch.Tensor, h: torch.Tensor,
    c: torch.Tensor, tier: Tier,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The JAX package's `_scan_tblock` arithmetic in the plain ops, on any
    device: the plain encoder over all B*K chunks, `F.lstm` over each
    stream's K*F frames, the decoder."""
    n_streams, n_chunks, samples = audio.shape
    feats = encode_reference(audio.reshape(-1, samples))
    feats = feats.reshape(n_streams, n_chunks, *feats.shape[1:])
    out, hn, cn = F.lstm(feats.reshape(n_streams, -1, feats.shape[-1]), h, c, params["lstm_w"],
                         params["lstm_b"], tier)
    probs = F.decoder_v5_nlc(out.reshape(-1, *feats.shape[2:]), params["dec_w"],
                             params["dec_b"], tier)
    return probs.reshape(n_streams, n_chunks), hn, cn
