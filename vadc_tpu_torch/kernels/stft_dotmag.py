"""Spectrum dot + magnitude: the STFT's one large product with its
magnitude fused in, so the full spectrum never reaches device memory.

Counterpart of vadc_tpu/kernels/stft_dotmag.py (`dot_magnitude`,
`split_basis`). The CUDA kernel is `csrc/stft_dotmag.cu`; its header says
what bounds it on an H100 and how it is built. The JAX package routes only
its bf16 tiers through the Pallas kernel, for Mosaic speed reasons; the port
has an instance of each tier (`nn.precision`: fp32 products at faithful,
bf16_3x on fp32 frames at balanced and fast, bf16 frames and bases at
turbo, the JAX package's own bf16-operand use) and `models.silero_v31.
features` passes its tier.

The spectrum kernels (this one, `stft_mag.stft_magnitude` and the v3.1 step
kernel) read the bases packed as `padded_basis` builds them; the wrappers
take (wr, wi) and pack them once per pair of tensors (`packed_basis`).
"""

from __future__ import annotations

import torch

from vadc_tpu_torch.kernels import _build
from vadc_tpu_torch.nn import functional as F
from vadc_tpu_torch.nn.precision import FAITHFUL, Tier, pack_operand, tier_of

#: (n_fft, cutoff) of the kernels' instances (csrc/stft_mag.cu,
#: csrc/stft_dotmag.cu) -> frame rows a block computes at once
ROWS_PASS = {(256, 129): 48, (128, 65): 96}


def split_basis(basis: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """[2*cutoff, n_fft] Fourier basis (real rows, then imaginary) ->
    contiguous (wr, wi) [n_fft, cutoff] kernel operands."""
    cutoff = basis.shape[0] // 2
    return basis[:cutoff].T.contiguous(), basis[cutoff:].T.contiguous()


def bins_ld(cutoff: int) -> int:
    """cutoff bins padded to a multiple of 4 (stft_block::Geometry::BINS_LD)."""
    return -(-cutoff // 4) * 4


def padded_basis(wr: torch.Tensor, wi: torch.Tensor, mode: str = "fp32") -> torch.Tensor:
    """(wr, wi) [n_fft, cutoff] -> [n_fft, 2, bins_ld(cutoff)]: tap k's real
    then imaginary basis row, each padded with zeros, so that a slice of
    taps is one contiguous run of 16-byte aligned rows; packed for products
    of `mode` (nn.precision.pack_operand; a zero packs as zero)."""
    n_fft, cutoff = wr.shape
    out = torch.zeros(n_fft, 2, bins_ld(cutoff), dtype=torch.float32, device=wr.device)
    out[:, 0, :cutoff] = pack_operand(wr, mode)
    out[:, 1, :cutoff] = pack_operand(wi, mode)
    return out


def packed_basis(
    wr: torch.Tensor, wi: torch.Tensor, who: str = "packed_basis", mode: str = "fp32"
) -> torch.Tensor:
    """padded_basis(wr, wi, mode), built once per pair of tensors and mode
    (again if either was written to since), after checking them: fp32, one
    [n_fft, cutoff] shape, one device. Kept on wr itself, so it lives as
    long as wr, and found again with one attribute read: the wrappers call
    this on every launch."""
    versions = (wr._version, wi._version)
    cache = getattr(wr, "_vadc_packed_basis", None)
    if cache is None:
        cache = wr._vadc_packed_basis = {}
    hit = cache.get(mode)
    if hit is None or hit[0] is not wi or hit[1] != versions:
        for name, t in (("wr", wr), ("wi", wi)):
            if t.dtype != torch.float32:
                raise TypeError(f"{who}: {name} must be float32, got {t.dtype}")
        if wr.dim() != 2 or wr.shape != wi.shape or wr.device != wi.device:
            raise ValueError(
                f"{who}: bases {tuple(wr.shape)} on {wr.device}, {tuple(wi.shape)} on "
                f"{wi.device} must be one [n_fft, cutoff] shape on one device"
            )
        hit = (wi, versions, padded_basis(wr, wi, mode))
        cache[mode] = hit
    return hit[2]


def check_geometry(who: str, n_fft: int, cutoff: int) -> None:
    """The (n_fft, cutoff) pairs the kernels are built for."""
    if (n_fft, cutoff) not in ROWS_PASS:
        raise ValueError(
            f"{who}: no kernel for n_fft {n_fft} with {cutoff} bins (it takes "
            + ", ".join(f"{n} with {c}" for n, c in ROWS_PASS) + ")"
        )


def dot_magnitude_reference(
    frames: torch.Tensor, wr: torch.Tensor, wi: torch.Tensor, tier: Tier = FAITHFUL
) -> torch.Tensor:
    """Plain version: sqrt((frames @ wr)^2 + (frames @ wi)^2), fp32 sums, the
    products at the tier's STFT operands."""
    return F.spectrum_magnitude(frames, wr, wi, tier_of(tier).stft)


def dot_magnitude(
    frames: torch.Tensor, wr: torch.Tensor, wi: torch.Tensor, tier: Tier | str = FAITHFUL
) -> torch.Tensor:
    """frames [B, F, n_fft] (or [rows, n_fft]) x (wr, wi) [n_fft, cutoff]
    -> magnitude [B, F, cutoff] (or [rows, cutoff]), fp32, the products at
    the tier's STFT operands (the bf16 tiers at n_fft 256 only).

    frames may be a strided view, such as the unfold of the padded audio,
    as long as its last dim has unit stride: the kernel frames by address
    arithmetic. A CPU tensor takes the plain version; a CUDA tensor
    launches the kernel (built at first use) or raises."""
    tier = tier_of(tier)
    if frames.dim() == 2:  # the JAX signature's [rows, n_fft]
        return dot_magnitude(frames[None], wr, wi, tier)[0]
    if frames.device.type == "cpu":
        return dot_magnitude_reference(frames, wr, wi, tier)
    _check(frames, wr, wi)
    n_fft, cutoff = wr.shape
    if tier is not FAITHFUL and (n_fft, cutoff) != (256, 129):
        raise ValueError(f"dot_magnitude: the {tier} instance takes n_fft 256 with 129 bins")
    basis = packed_basis(wr, wi, "dot_magnitude", tier.stft)
    out = torch.empty(*frames.shape[:-1], cutoff, dtype=torch.float32, device=frames.device)
    lib = _build.library()
    status = lib.vadc_dot_magnitude(
        frames.data_ptr(), frames.shape[0], frames.shape[1], frames.stride(0), frames.stride(1),
        basis.data_ptr(), n_fft, cutoff, out.data_ptr(), tier.index,
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
    if frames.numel() == 0:
        raise ValueError("dot_magnitude: empty frames")
    check_geometry("dot_magnitude", *wr.shape)
