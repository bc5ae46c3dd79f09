"""The whole Silero v3.1 step from raw audio as one CUDA kernel.

Counterpart of vadc_tpu/kernels/silero_v31_fused.py (`forward_fused`): STFT
magnitude, adaptive normalization, the four encoder stages, the 2-layer
LSTM and the v3 decoder in one launch. The kernel is
`csrc/silero_v31_fused_audio.cu`; its header says what bounds it on an
H100 and how its design answers that. Its spectrum gives `dot_magnitude`'s
bits and its encoder, LSTM and decoder are the device code of
`forward_fused2d`'s kernel.

`encode_fused_audio` is the same source's second entry: the spectrum, the
normalization and the four encoder stages alone, storing the last stage's
output. The slab scan and the CLI's window run it over all their chunks at
once and hand its rows to `kernels.lstm_decoder.lstm_decoder_fused`, so a
slab gives the loop of steps bit for bit.

Both entries take the precision tier (`nn.precision`; default faithful)
and launch that instance, with the weights and the STFT basis packed for
it; the JAX package has no tier form of this kernel, so the instances are
held to the plain versions here at the same tier.

The JAX kernel splits each frame into 64-sample hop blocks because its
compiler could not stack overlapping frames; that is not semantics and is
not carried over. Unlike the JAX kernel, this one takes BN-folded archives
(no `bn_*` tensors, as in the official v3 `.onnx` extraction): the packed
weights of `pack_weights` give them scale 1 and shift 0.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from vadc_tpu_torch.kernels import _build
from vadc_tpu_torch.kernels.silero_v31_fused2d import (
    HIDDEN,
    N_FEAT,
    encode_fused_reference,
    forward_fused2d_reference,
    out_frames,
    pack_weights,
)
from vadc_tpu_torch.kernels.stft_mag import bins_ld, mma_ld, padded_basis_of
from vadc_tpu_torch.models.weights import Params
from vadc_tpu_torch.nn import functional as F
from vadc_tpu_torch.nn.precision import FAITHFUL, Tier, store, tier_of
from vadc_tpu_torch.tracing import zone

N_FFT = 256
HOP = 64
PAD = 128
MIN_SAMPLES, MAX_SAMPLES = 512, 1536  # multiples of 256: 9..25 frames


@functools.lru_cache(maxsize=None)
def _norm_weights(n_frames: int) -> tuple[np.ndarray, ctypes.Array]:
    norm_w = np.zeros(n_frames, np.float32)
    for f in range(n_frames):
        for k, tap in enumerate(F.ADAPTIVE_NORM_FILTER):
            j = f + k - 3
            if j < 0:
                j = -j
            elif j >= n_frames:
                j = 2 * n_frames - 2 - j
            norm_w[j] += tap
    norm_w = norm_w / n_frames
    norm_w.setflags(write=False)
    return norm_w, (ctypes.c_float * n_frames)(*norm_w.tolist())


BASIS_LD = bins_ld(N_FEAT)  # 129 bins padded to 132 (stft_block::Geometry::BINS_LD)


def norm_weights(n_frames: int) -> np.ndarray:
    """The adaptive normalization's smoothing collapsed to F weights
    (vadc_tpu/kernels/silero_v31_fused.py:270-279): the frame mean of the
    7-tap smoothing of the reflect-padded per-frame channel means equals
    sum_f norm_w[f] * mean[f]. fp32 [F], built once per F, read-only."""
    return _norm_weights(n_frames)[0]


def features_reference(
    params: dict, audio: torch.Tensor, tier: Tier | str = FAITHFUL,
    spectrum: torch.Tensor | None = None,
) -> torch.Tensor:
    """The kernels' front-end in plain ops at the tier: the STFT magnitude of
    nn/functional, log1p(2^20 x) (by the same series at faithful), the
    per-frame channel mean weighted by norm_weights (fp32 at every tier, as
    nn/functional's smoothing) and subtracted. audio [B, S] -> [B, F, 129],
    stored as the tier stores it. `spectrum` [B, F, 129], when given, stands
    in for the STFT magnitude: a kernel's own, so that the rest of the
    kernel is held to its plain version without the spectrum's rounding,
    which log1p(2^20 x) amplifies at near-zero bins."""
    tier = tier_of(tier)
    with zone("stft"):
        spect = spectrum if spectrum is not None else F.stft_magnitude_nlc(
            audio, params["stft_basis"], pad_left=PAD, pad_right=PAD, hop=HOP, tier=tier
        )
    with zone("adaptive_norm"):
        loge = F.log1p_at(spect * 1048576.0, tier)
        norm_w = torch.from_numpy(norm_weights(spect.shape[1]).copy()).to(audio.device)
        mean_mean = torch.sum(torch.mean(loge, dim=-1) * norm_w, dim=-1)
        return store(loge - mean_mean[:, None, None], tier)


def forward_fused_reference(
    params: dict, audio: torch.Tensor, h: torch.Tensor, c: torch.Tensor,
    tier: Tier | str = FAITHFUL, spectrum: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version: features_reference (from `spectrum` when given), then
    forward_fused2d_reference, at the tier. audio [B, S]; h, c [2, B, 64]
    -> (probs [B], hn, cn)."""
    tier = tier_of(tier)
    feats = features_reference(params, audio, tier, spectrum)
    return forward_fused2d_reference(params, feats, h, c, tier)


def encode_fused_audio_reference(
    params: dict, audio: torch.Tensor, tier: Tier | str = FAITHFUL,
    spectrum: torch.Tensor | None = None,
) -> torch.Tensor:
    """Plain version of encode_fused_audio: features_reference (from
    `spectrum` when given), then the four encoder stages, at the tier.
    audio [R, S] -> [R, T, 64]."""
    tier = tier_of(tier)
    return encode_fused_reference(params, features_reference(params, audio, tier, spectrum), tier)


def forward_fused(
    params: Params,
    audio: torch.Tensor,
    h: torch.Tensor,
    c: torch.Tensor,
    *,
    hn: torch.Tensor | None = None,
    cn: torch.Tensor | None = None,
    spectrum: torch.Tensor | None = None,
    tier: Tier | str = FAITHFUL,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The v3.1 model from raw audio, at the precision tier.

    audio [B, S], S a multiple of 256 in 512..1536 (rows may be strided,
    samples unit-stride); h, c [2, B, 64]. Returns (probs [B], hn, cn). The
    new state goes to `hn`/`cn` when given, which may BE `h`/`c` (updated in
    place); otherwise to new tensors. `spectrum`, a [B, F, 129] tensor on
    the card, also receives the kernel's STFT magnitudes (for checking them
    against dot_magnitude's). A CPU tensor takes the plain version; a CUDA
    tensor launches the kernel or raises."""
    _check_chunks(audio)
    tier = tier_of(tier)
    if audio.device.type == "cpu":
        probs, h_new, c_new = forward_fused_reference(params, audio, h, c, tier)
        if hn is not None:
            h_new = hn.copy_(h_new)
        if cn is not None:
            c_new = cn.copy_(c_new)
        return probs, h_new, c_new
    if hn is None:
        hn = torch.empty_like(h)
    if cn is None:
        cn = torch.empty_like(c)
    probs = torch.empty(audio.shape[0], dtype=torch.float32, device=audio.device)
    args = step_args(params, audio, h, c, probs, hn, cn, spectrum, tier)
    status = _build.library().vadc_silero_v31_fused_audio(*args)
    _build.check(status, "forward_fused")
    forward_fused.launches += 1
    return probs, hn, cn


#: kernel launches since the count was last set to 0
forward_fused.launches = 0


def step_args(params: Params, audio, h, c, probs, hn, cn, spectrum=None,
              tier: Tier = FAITHFUL) -> tuple:
    """Checks the tensors of one step and returns the arguments of the C
    entry vadc_silero_v31_fused_audio (chip_profile.py hands them to its
    stamped build of the same source)."""
    packed = pack_weights(params, tier)
    basis = padded_basis_of(params, tier.stft)
    _check("forward_fused", packed, audio, basis, tier, h, c, hn, cn, spectrum)
    batch, samples = audio.shape
    _, c_norm_w = _norm_weights(samples // HOP + 1)
    return (
        packed.buffer.data_ptr(), packed._c_offsets, len(packed.offsets),
        c_norm_w, len(c_norm_w), audio.data_ptr(), batch, audio.stride(0), samples,
        basis.data_ptr(), h.data_ptr(), c.data_ptr(),
        probs.data_ptr(), hn.data_ptr(), cn.data_ptr(),
        None if spectrum is None else spectrum.data_ptr(), tier.index,
        torch.cuda.current_stream(audio.device).cuda_stream,
    )


def encode_fused_audio(
    params: Params, audio: torch.Tensor, tier: Tier | str = FAITHFUL
) -> torch.Tensor:
    """The front-end and the four encoder stages from raw audio, the step
    kernel's own up to its LSTM, at the precision tier: audio [R, S], S a
    multiple of 256 in
    512..1536 (rows may be strided, samples unit-stride) -> [R, T, 64],
    T = 3..7. The rows are independent (R is streams x chunks on the slab
    route); `kernels.lstm_decoder.lstm_decoder_fused` on them gives
    forward_fused's bits. A CPU tensor takes the plain version; a CUDA
    tensor launches the kernel or raises."""
    _check_chunks(audio, "encode_fused_audio")
    tier = tier_of(tier)
    if audio.device.type == "cpu":
        return encode_fused_audio_reference(params, audio, tier)
    packed = pack_weights(params, tier)
    basis = padded_basis_of(params, tier.stft)
    _check("encode_fused_audio", packed, audio, basis, tier)
    rows, samples = audio.shape
    frames = samples // HOP + 1
    _, c_norm_w = _norm_weights(frames)
    out = torch.empty(rows, out_frames(frames), HIDDEN, dtype=torch.float32, device=audio.device)
    status = _build.library().vadc_silero_v31_encode_audio(
        packed.buffer.data_ptr(), packed._c_offsets, len(packed.offsets),
        c_norm_w, len(c_norm_w), audio.data_ptr(), rows, audio.stride(0), samples,
        basis.data_ptr(), out.data_ptr(), tier.index,
        torch.cuda.current_stream(audio.device).cuda_stream,
    )
    _build.check(status, "encode_fused_audio")
    encode_fused_audio.launches += 1
    return out


#: kernel launches since the count was last set to 0
encode_fused_audio.launches = 0


def _check_chunks(audio: torch.Tensor, who: str = "forward_fused") -> None:
    """The chunk sizes the model is defined for, on every device."""
    batch, samples = audio.shape if audio.dim() == 2 else (0, 0)
    if samples % 256 or not MIN_SAMPLES <= samples <= MAX_SAMPLES or batch < 1:
        raise ValueError(
            f"{who}: audio {tuple(audio.shape)} is not [B, S] with B >= 1 and S a "
            f"multiple of 256 in {MIN_SAMPLES}..{MAX_SAMPLES}"
        )


def _check(who, packed, audio, basis, tier, h=None, c=None, hn=None, cn=None,
           spectrum=None) -> None:
    """The tensors of one launch: the step's (state and, optionally, the
    spectrum copy) or the encoder entry's (audio and weights alone); the
    basis packed for the tier's STFT operands."""
    if audio.dim() != 2 or audio.stride(1) != 1 or (audio.shape[0] > 1 and
                                                    audio.stride(0) < audio.shape[1]):
        raise ValueError(
            f"{who}: audio must be [B, S] with unit-stride samples and rows that do not "
            f"overlap, got shape {tuple(audio.shape)} strides {audio.stride()}"
        )
    mma = tier.stft == "bf16_3x"  # the tensor-core spectrum's bases
    want = (N_FFT, mma_ld(N_FEAT)) if mma else (N_FFT, 2, BASIS_LD)
    dtype = torch.bfloat16 if mma else torch.float32
    if tuple(basis.shape) != want or basis.dtype != dtype or not basis.is_contiguous():
        raise ValueError(
            f"{who}: padded STFT basis {tuple(basis.shape)} {basis.dtype} is not a contiguous "
            f"{list(want)} {dtype} (the {tier} instance's)")
    if audio.dtype != torch.float32:
        raise TypeError(f"{who}: audio must be float32, got {audio.dtype}")
    if audio.device.type != "cuda":
        raise ValueError(f"{who}: unsupported device {audio.device}")
    if basis.device != audio.device:
        raise ValueError(f"{who}: basis on {basis.device}, audio on {audio.device}")
    batch, samples = audio.shape
    state_shape = (2, batch, HIDDEN)
    tensors = [("audio", audio), ("weights", packed.buffer)]
    if h is not None:
        tensors += [("h", h), ("c", c), ("hn", hn), ("cn", cn)]
    if spectrum is not None:
        tensors.append(("spectrum", spectrum))
        want = (batch, samples // HOP + 1, N_FEAT)
        if tuple(spectrum.shape) != want:
            raise ValueError(f"{who}: spectrum {tuple(spectrum.shape)} is not {want}")
    for name, t in tensors:
        if t.dtype != torch.float32:
            raise TypeError(f"{who}: {name} must be float32, got {t.dtype}")
        if t.device != audio.device:
            raise ValueError(f"{who}: {name} on {t.device}, audio on {audio.device}")
        if name != "audio" and not t.is_contiguous():
            raise ValueError(f"{who}: {name} must be contiguous")
        if name in ("h", "c", "hn", "cn") and tuple(t.shape) != state_shape:
            raise ValueError(f"{who}: {name} {tuple(t.shape)} is not {state_shape}")
