"""STFT magnitude from raw audio: reflect pad, framing and the magnitude of
the spectrum product in one kernel.

Counterpart of vadc_tpu/kernels/stft_mag.py (`stft_magnitude_pallas`). The
CUDA kernel is `csrc/stft_mag.cu`; its header says what bounds it on an
H100 and how the pad and the framing become index arithmetic. The JAX
package keeps its Pallas kernel as an experiment off every model path; in
the port the v4 and v5 front-ends run this kernel. Its plain version is
`nn.functional.stft_magnitude_nlc`, the same function the port's CPU path
and the v3.1 tests use, so the port never differs from itself in STFT
rounding.
"""

from __future__ import annotations

import torch

from vadc_tpu_torch.kernels import _build
from vadc_tpu_torch.kernels.stft_dotmag import split_basis
from vadc_tpu_torch.nn import functional as F


def stft_magnitude_reference(
    audio: torch.Tensor, wr: torch.Tensor, wi: torch.Tensor, *, pad_left: int, pad_right: int,
    hop: int,
) -> torch.Tensor:
    """Plain version: reflect pad, unfold, sqrt((frames @ wr)^2 + (frames
    @ wi)^2), fp32 (nn.functional.stft_magnitude_nlc on the split basis)."""
    frames = F.frame(F.reflect_pad_last(audio, pad_left, pad_right), wr.shape[0], hop)
    return F.spectrum_magnitude(frames, wr, wi)


def split_basis_of(params) -> tuple[torch.Tensor, torch.Tensor]:
    """(wr, wi) of a Params' STFT basis, split once per Params object."""
    return params.derived("stft_split_basis", lambda: split_basis(params["stft_basis"]))


def stft_magnitude(
    audio: torch.Tensor, wr: torch.Tensor, wi: torch.Tensor, *, pad_left: int, pad_right: int,
    hop: int,
) -> torch.Tensor:
    """audio [B, S] x (wr, wi) [n_fft, cutoff] -> magnitude [B, F, cutoff],
    F = (S + pad_left + pad_right - n_fft) // hop + 1, fp32.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    (built at first use) or raises."""
    if audio.device.type == "cpu":
        return stft_magnitude_reference(audio, wr, wi, pad_left=pad_left, pad_right=pad_right, hop=hop)
    _check(audio, wr, wi, pad_left, pad_right, hop)
    batch, samples = audio.shape
    n_fft, cutoff = wr.shape
    n_frames = (samples + pad_left + pad_right - n_fft) // hop + 1
    out = torch.empty(batch, n_frames, cutoff, dtype=torch.float32, device=audio.device)
    lib = _build.library()
    status = lib.vadc_stft_magnitude(
        audio.data_ptr(), batch, audio.stride(0), samples, pad_left, pad_right, hop,
        wr.data_ptr(), wi.data_ptr(), n_fft, cutoff, out.data_ptr(),
        torch.cuda.current_stream(audio.device).cuda_stream,
    )
    _build.check(status, "stft_magnitude")
    stft_magnitude.launches += 1
    return out


#: kernel launches since the count was last set to 0
stft_magnitude.launches = 0


def _check(audio, wr, wi, pad_left: int, pad_right: int, hop: int) -> None:
    if audio.device.type != "cuda":
        raise ValueError(f"stft_magnitude: unsupported device {audio.device}")
    for name, t in (("audio", audio), ("wr", wr), ("wi", wi)):
        if t.dtype != torch.float32:
            raise TypeError(f"stft_magnitude: {name} must be float32, got {t.dtype}")
        if t.device != audio.device:
            raise ValueError(f"stft_magnitude: {name} on {t.device}, audio on {audio.device}")
    if audio.dim() != 2 or audio.stride(-1) != 1 or audio.numel() == 0:
        raise ValueError(
            "stft_magnitude: audio must be a non-empty [B, S] with a unit-stride last "
            f"dim, got shape {tuple(audio.shape)} strides {audio.stride()}"
        )
    if wr.dim() != 2 or wr.shape != wi.shape or not (wr.is_contiguous() and wi.is_contiguous()):
        raise ValueError(
            f"stft_magnitude: bases {tuple(wr.shape)}, {tuple(wi.shape)} must be one "
            "contiguous [n_fft, cutoff] shape"
        )
    samples = audio.shape[1]
    if not (0 <= pad_left < samples and 0 <= pad_right < samples) or hop < 1:
        # one reflection reaches back at most samples - 1
        raise ValueError(
            f"stft_magnitude: reflect pads {pad_left}/{pad_right} need chunks longer than "
            f"the pad, got {samples} samples (hop {hop})"
        )
    if samples + pad_left + pad_right < wr.shape[0]:
        raise ValueError(
            f"stft_magnitude: {samples} samples padded by {pad_left}/{pad_right} are "
            f"shorter than one {wr.shape[0]}-sample frame"
        )
