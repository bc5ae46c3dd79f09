"""The whole Silero v3.1 step from raw audio as one CUDA kernel.

Counterpart of vadc_tpu/kernels/silero_v31_fused.py (`forward_fused`): STFT
magnitude, adaptive normalization, the four encoder stages, the 2-layer
LSTM and the v3 decoder in one launch. The kernel is
`csrc/silero_v31_fused_audio.cu`; its header says what bounds it on an
H100 and how its design answers that. Its spectrum is the tile of
`dot_magnitude` (bit for bit) and its encoder, LSTM and decoder are the
device code of `forward_fused2d`'s kernel.

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
    forward_fused2d_reference,
    pack_weights,
)
from vadc_tpu_torch.kernels.stft_mag import split_basis_of
from vadc_tpu_torch.models.weights import Params
from vadc_tpu_torch.nn import functional as F

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


def norm_weights(n_frames: int) -> np.ndarray:
    """The adaptive normalization's smoothing collapsed to F weights
    (vadc_tpu/kernels/silero_v31_fused.py:270-279): the frame mean of the
    7-tap smoothing of the reflect-padded per-frame channel means equals
    sum_f norm_w[f] * mean[f]. fp32 [F], built once per F, read-only."""
    return _norm_weights(n_frames)[0]


def forward_fused_reference(
    params: dict, audio: torch.Tensor, h: torch.Tensor, c: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version: the STFT magnitude of nn/functional, log1p(2^20 x) by
    the same series, the per-frame channel mean weighted by norm_weights
    and subtracted, then forward_fused2d_reference. audio [B, S]; h, c
    [2, B, 64] -> (probs [B], hn, cn)."""
    spect = F.stft_magnitude_nlc(audio, params["stft_basis"], pad_left=PAD, pad_right=PAD, hop=HOP)
    loge = F.accurate_log1p(spect * 1048576.0)
    norm_w = torch.from_numpy(norm_weights(spect.shape[1]).copy()).to(audio.device)
    mean_mean = torch.sum(torch.mean(loge, dim=-1) * norm_w, dim=-1)
    return forward_fused2d_reference(params, loge - mean_mean[:, None, None], h, c)


def forward_fused(
    params: Params,
    audio: torch.Tensor,
    h: torch.Tensor,
    c: torch.Tensor,
    *,
    hn: torch.Tensor | None = None,
    cn: torch.Tensor | None = None,
    spectrum: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The v3.1 model from raw audio.

    audio [B, S], S a multiple of 256 in 512..1536 (rows may be strided,
    samples unit-stride); h, c [2, B, 64]. Returns (probs [B], hn, cn). The
    new state goes to `hn`/`cn` when given, which may BE `h`/`c` (updated in
    place); otherwise to new tensors. `spectrum`, a [B, F, 129] tensor on
    the card, also receives the kernel's STFT magnitudes (for checking them
    against dot_magnitude's). A CPU tensor takes the plain version; a CUDA
    tensor launches the kernel or raises."""
    _check_chunks(audio)
    if audio.device.type == "cpu":
        probs, h_new, c_new = forward_fused_reference(params, audio, h, c)
        if hn is not None:
            h_new = hn.copy_(h_new)
        if cn is not None:
            c_new = cn.copy_(c_new)
        return probs, h_new, c_new
    if hn is None:
        hn = torch.empty_like(h)
    if cn is None:
        cn = torch.empty_like(c)
    packed = pack_weights(params)
    wr, wi = split_basis_of(params)
    _check(packed, audio, wr, h, c, hn, cn, spectrum)
    batch, samples = audio.shape
    _, c_norm_w = _norm_weights(samples // HOP + 1)
    probs = torch.empty(batch, dtype=torch.float32, device=audio.device)
    lib = _build.library()
    status = lib.vadc_silero_v31_fused_audio(
        packed.buffer.data_ptr(), packed._c_offsets, len(packed.offsets),
        c_norm_w, len(c_norm_w), audio.data_ptr(), batch, audio.stride(0), samples,
        wr.data_ptr(), wi.data_ptr(), h.data_ptr(), c.data_ptr(),
        probs.data_ptr(), hn.data_ptr(), cn.data_ptr(),
        None if spectrum is None else spectrum.data_ptr(),
        torch.cuda.current_stream(audio.device).cuda_stream,
    )
    _build.check(status, "forward_fused")
    forward_fused.launches += 1
    return probs, hn, cn


#: kernel launches since the count was last set to 0
forward_fused.launches = 0


def _check_chunks(audio: torch.Tensor) -> None:
    """The chunk sizes the model is defined for, on every device."""
    batch, samples = audio.shape if audio.dim() == 2 else (0, 0)
    if samples % 256 or not MIN_SAMPLES <= samples <= MAX_SAMPLES or batch < 1:
        raise ValueError(
            f"forward_fused: audio {tuple(audio.shape)} is not [B, S] with B >= 1 and S a "
            f"multiple of 256 in {MIN_SAMPLES}..{MAX_SAMPLES}"
        )


def _check(packed, audio, wr, h, c, hn, cn, spectrum) -> None:
    if audio.device.type != "cuda":
        raise ValueError(f"forward_fused: unsupported device {audio.device}")
    if audio.dim() != 2 or audio.stride(1) != 1:
        raise ValueError(
            f"forward_fused: audio must be [B, S] with unit-stride samples, got shape "
            f"{tuple(audio.shape)} strides {audio.stride()}"
        )
    batch, samples = audio.shape
    if tuple(wr.shape) != (N_FFT, N_FEAT):
        raise ValueError(f"forward_fused: STFT basis {tuple(wr.shape)} is not [256, 129]")
    state_shape = (2, batch, HIDDEN)
    tensors = [("audio", audio), ("h", h), ("c", c), ("hn", hn), ("cn", cn),
               ("weights", packed.buffer), ("basis", wr)]
    if spectrum is not None:
        tensors.append(("spectrum", spectrum))
        want = (batch, samples // HOP + 1, N_FEAT)
        if tuple(spectrum.shape) != want:
            raise ValueError(f"forward_fused: spectrum {tuple(spectrum.shape)} is not {want}")
    for name, t in tensors:
        if t.dtype != torch.float32:
            raise TypeError(f"forward_fused: {name} must be float32, got {t.dtype}")
        if t.device != audio.device:
            raise ValueError(f"forward_fused: {name} on {t.device}, audio on {audio.device}")
        if name != "audio" and not t.is_contiguous():
            raise ValueError(f"forward_fused: {name} must be contiguous")
        if name in ("h", "c", "hn", "cn") and tuple(t.shape) != state_shape:
            raise ValueError(f"forward_fused: {name} {tuple(t.shape)} is not {state_shape}")
