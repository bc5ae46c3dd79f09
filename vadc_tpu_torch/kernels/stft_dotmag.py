"""Spectrum dot + magnitude: the STFT's one large product with its
magnitude fused in, so the full spectrum never reaches device memory.

Counterpart of vadc_tpu/kernels/stft_dotmag.py (`dot_magnitude`,
`split_basis`). The CUDA kernel is `csrc/stft_dotmag.cu`; its header says
what bounds it on an H100 and how it is built. The JAX package routes only
its bf16 tiers through the Pallas kernel, for Mosaic speed reasons; the
function is the same, and the port runs it at the faithful tier in fp32.
"""

from __future__ import annotations

import torch

from vadc_tpu_torch.kernels import _build
from vadc_tpu_torch.nn import functional as F


def split_basis(basis: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """[2*cutoff, n_fft] Fourier basis (real rows, then imaginary) ->
    contiguous (wr, wi) [n_fft, cutoff] kernel operands."""
    cutoff = basis.shape[0] // 2
    return basis[:cutoff].T.contiguous(), basis[cutoff:].T.contiguous()


def dot_magnitude_reference(
    frames: torch.Tensor, wr: torch.Tensor, wi: torch.Tensor
) -> torch.Tensor:
    """Plain version: sqrt((frames @ wr)^2 + (frames @ wi)^2), fp32."""
    return F.spectrum_magnitude(frames, wr, wi)


def dot_magnitude(frames: torch.Tensor, wr: torch.Tensor, wi: torch.Tensor) -> torch.Tensor:
    """frames [B, F, n_fft] (or [rows, n_fft]) x (wr, wi) [n_fft, cutoff]
    -> magnitude [B, F, cutoff] (or [rows, cutoff]), fp32.

    frames may be a strided view, such as the unfold of the padded audio,
    as long as its last dim has unit stride: the kernel frames by address
    arithmetic. A CPU tensor takes the plain version; a CUDA tensor
    launches the kernel (built at first use) or raises."""
    if frames.dim() == 2:  # the JAX signature's [rows, n_fft]
        return dot_magnitude(frames[None], wr, wi)[0]
    if frames.device.type == "cpu":
        return dot_magnitude_reference(frames, wr, wi)
    _check(frames, wr, wi)
    n_fft, cutoff = wr.shape
    out = torch.empty(*frames.shape[:-1], cutoff, dtype=torch.float32, device=frames.device)
    lib = _build.library()
    status = lib.vadc_dot_magnitude(
        frames.data_ptr(), frames.shape[0], frames.shape[1], frames.stride(0), frames.stride(1),
        wr.data_ptr(), wi.data_ptr(), n_fft, cutoff, out.data_ptr(),
        torch.cuda.current_stream(frames.device).cuda_stream,
    )
    _build.check(status, "dot_magnitude")
    dot_magnitude.launches += 1
    return out


#: kernel launches since the count was last set to 0
dot_magnitude.launches = 0


def _check(frames: torch.Tensor, wr: torch.Tensor, wi: torch.Tensor) -> None:
    if frames.device.type != "cuda":
        raise ValueError(f"dot_magnitude: unsupported device {frames.device}")
    for name, t in (("frames", frames), ("wr", wr), ("wi", wi)):
        if t.dtype != torch.float32:
            raise TypeError(f"dot_magnitude: {name} must be float32, got {t.dtype}")
        if t.device != frames.device:
            raise ValueError(f"dot_magnitude: {name} on {t.device}, frames on {frames.device}")
    if frames.dim() != 3 or frames.stride(-1) != 1:
        raise ValueError(
            "dot_magnitude: frames must be [B, F, n_fft] with a "
            f"unit-stride last dim, got shape {tuple(frames.shape)} "
            f"strides {frames.stride()}"
        )
    if wr.dim() != 2 or wr.shape != wi.shape or wr.shape[0] != frames.shape[-1]:
        raise ValueError(
            f"dot_magnitude: bases {tuple(wr.shape)}, {tuple(wi.shape)} do not fit "
            f"frames of length {frames.shape[-1]}"
        )
    if not (wr.is_contiguous() and wi.is_contiguous()):
        raise ValueError("dot_magnitude: wr and wi must be contiguous")
    if frames.numel() == 0:
        raise ValueError("dot_magnitude: empty frames")
