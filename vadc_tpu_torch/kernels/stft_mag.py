"""STFT magnitude from raw audio: reflect pad, framing and the magnitude of
the spectrum product in one kernel.

Counterpart of vadc_tpu/kernels/stft_mag.py (`stft_magnitude_pallas`). The
CUDA kernel is `csrc/stft_mag.cu`; its header says what bounds it on an
H100 and how each stream's chunk is reflect-padded once into shared memory,
its frames then overlapping windows of it. A block owns a group of whole
streams; `launch_plan` chooses how many. The JAX
package keeps its Pallas kernel as an experiment off every model path; in
the port the v4 and v5 front-ends run this kernel. Its plain version is
`nn.functional.stft_magnitude_nlc`, the same function the port's CPU path
and the v3.1 tests use, so the port never differs from itself in STFT
rounding.

The products' operands are a `mode` (`nn.precision.stft_mode` of the tier
and the family: "fp32", "bf16_3x" or "bf16"), an instance of the kernel
each, the bases packed for it. The JAX package's Pallas kernel has no mode:
the instances are the counterparts of its models' spectrum at the tier.
"""

from __future__ import annotations

import functools

import torch

from vadc_tpu_torch.kernels import _build
from vadc_tpu_torch.kernels.stft_dotmag import (
    ROWS_PASS, bins_ld, check_geometry, mma_ld, packed_basis, padded_basis, split_basis,
)
from vadc_tpu_torch.nn import functional as F

#: the products' operand modes of the kernel's instances -> the C entry's
#: `mode` (csrc/tier.cuh: ProductMode)
MODES = {"fp32": 0, "bf16_3x": 1, "bf16": 2}

# the kernel's constants (csrc/stft_mag.cu): taps a slice, slices in the
# ring, and the shared memory of one block, and of each of two blocks on
# one SM (228 KB an SM, 1 KB of it the system's per block), on an H100
SLICE_TAPS, STAGES = 32, 2
SMEM_ONE_BLOCK = 232_448
SMEM_TWO_BLOCKS = 233_472 // 2 - 1024
# the tensor-core instances' (bf16_3x; csrc/stft_mag.cu: SpectrumMma256/128):
# rows a pass (4 m-tiles), taps a slice, slices in the ring
MMA_ROWS_PASS, MMA_SLICE_TAPS, MMA_STAGES = 64, 16, 2


def _mode_index(mode: str) -> int:
    try:
        return MODES[mode]
    except KeyError:
        raise ValueError(
            f"stft_magnitude: unknown mode {mode!r} (it takes {list(MODES)})"
        ) from None


def stft_magnitude_reference(
    audio: torch.Tensor, wr: torch.Tensor, wi: torch.Tensor, *, pad_left: int, pad_right: int,
    hop: int, mode: str = "fp32",
) -> torch.Tensor:
    """Plain version: reflect pad, unfold, sqrt((frames @ wr)^2 + (frames
    @ wi)^2), the products' operands of `mode`, fp32 sums
    (nn.functional.stft_magnitude_nlc on the split basis)."""
    _mode_index(mode)
    frames = F.frame(F.reflect_pad_last(audio, pad_left, pad_right), wr.shape[0], hop)
    return F.spectrum_magnitude(frames, wr, wi, mode)


def split_basis_of(params) -> tuple[torch.Tensor, torch.Tensor]:
    """(wr, wi) of a Params' STFT basis, split once per Params object."""
    return params.derived("stft_split_basis", lambda: split_basis(params["stft_basis"]))


def padded_basis_of(params, mode: str = "fp32") -> torch.Tensor:
    """The STFT bases as the spectrum kernels read them for products of
    `mode` (a tier's `stft`): stft_dotmag.padded_basis of the split bases.
    Built once per Params object and mode."""
    key = "stft_padded_basis" if mode == "fp32" else f"stft_padded_basis_{mode}"
    return params.derived(key, lambda: padded_basis(*split_basis_of(params), mode))


def staged_plane_ld(n_frames: int, hop: int, n_fft: int) -> int:
    """bf16 values of one stream's staged plane (hi or lo) in the tensor-core
    instances' shared memory: the padded samples its frames read, skewed by
    8 values a hop (stft_block::skewed_bf16), in whole 16 bytes, rounded up
    so that the next stream's skew runs on from this one's frames
    (csrc/stft_mag.cu: staged_plane_ld)."""
    staged = (n_frames - 1) * hop + n_fft
    length = -(-(staged - 1 + (staged - 1) // hop * 8 + 1) // 8) * 8
    return length + (n_frames * (hop + 8) - length) % 64


def staged_floats(n_frames: int, hop: int, n_fft: int) -> int:
    """Floats of one stream's staged chunk in the kernel's shared memory:
    the padded samples its frames read, skewed by one float per hop
    (stft_block::skewed_len), rounded up so that the next stream's skew
    runs on from this one's frames (csrc/stft_mag.cu: launch)."""
    staged = (n_frames - 1) * hop + n_fft
    length = staged + staged // hop + 1
    return length + (n_frames * (hop + 1) - length) % 32


@functools.lru_cache(maxsize=None)
def launch_plan(batch: int, n_frames: int, hop: int, n_fft: int, cutoff: int,
                sms: int, mode: str = "fp32") -> tuple[int, int]:
    """(streams a block owns, shared memory bytes of a block) of one launch
    of the instance of `mode` on a card of `sms` SMs. A block walks the
    bases once for each pass of rows over its streams' frames (ROWS_PASS
    on the CUDA-core tile, fp32 and bf16; MMA_ROWS_PASS on the tensor-core
    one, bf16_3x), and blocks on one SM share its arithmetic, so the plan
    minimizes the passes of the busiest SM, ceil(blocks / sms) x passes a
    block: streams whose rows fill whole passes, the fewest streams among
    equals."""
    _mode_index(mode)
    if mode != "bf16_3x":
        rows_pass = ROWS_PASS[(n_fft, cutoff)]
        # the ring of basis slices and a pass's magnitudes, then the chunks
        basis = 4 * (STAGES * SLICE_TAPS * 2 * bins_ld(cutoff) + rows_pass * cutoff)
        stream = 4 * staged_floats(n_frames, hop, n_fft)
    else:
        rows_pass = MMA_ROWS_PASS
        # the same, the chunks as hi and lo bf16 planes
        basis = 2 * MMA_STAGES * MMA_SLICE_TAPS * mma_ld(cutoff) + 4 * rows_pass * cutoff
        stream = 4 * staged_plane_ld(n_frames, hop, n_fft)
    if basis + stream > SMEM_ONE_BLOCK:
        raise ValueError(
            f"stft_magnitude: a chunk of {n_frames} frames does not fit in one block's "
            "shared memory"
        )
    best = None
    for streams in range(1, batch + 1):
        smem = basis + streams * stream
        if smem > (SMEM_TWO_BLOCKS if streams > 1 else SMEM_ONE_BLOCK):
            break
        cost = _ceil(_ceil(batch, streams), sms) * _ceil(streams * n_frames, rows_pass)
        if best is None or cost < best[0]:
            best = (cost, streams, smem)
    return best[1], best[2]


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def stft_magnitude(
    audio: torch.Tensor, wr: torch.Tensor, wi: torch.Tensor, *, pad_left: int, pad_right: int,
    hop: int, mode: str = "fp32",
) -> torch.Tensor:
    """audio [B, S] x (wr, wi) [n_fft, cutoff] -> magnitude [B, F, cutoff],
    F = (S + pad_left + pad_right - n_fft) // hop + 1, fp32; the products'
    operands of `mode` ("fp32", "bf16_3x", "bf16").

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    (built at first use) or raises."""
    mode_index = _mode_index(mode)
    if audio.device.type == "cpu":
        return stft_magnitude_reference(audio, wr, wi, pad_left=pad_left, pad_right=pad_right,
                                        hop=hop, mode=mode)
    _check(audio)
    basis = packed_basis(wr, wi, "stft_magnitude", mode)
    if basis.device != audio.device:
        raise ValueError(f"stft_magnitude: bases on {basis.device}, audio on {audio.device}")
    batch, samples = audio.shape
    n_fft, cutoff = wr.shape
    check_call_geometry(samples, n_fft, cutoff, pad_left, pad_right, hop)
    n_frames = (samples + pad_left + pad_right - n_fft) // hop + 1
    streams, _ = launch_plan(batch, n_frames, hop, n_fft, cutoff, _sm_count(audio.device), mode)
    out = torch.empty(batch, n_frames, cutoff, dtype=torch.float32, device=audio.device)
    lib = _build.library()
    status = lib.vadc_stft_magnitude(
        audio.data_ptr(), batch, audio.stride(0), samples, pad_left, pad_right, hop,
        basis.data_ptr(), n_fft, cutoff, streams, out.data_ptr(), mode_index,
        torch.cuda.current_stream(audio.device).cuda_stream,
    )
    _build.check(status, "stft_magnitude")
    stft_magnitude.launches += 1
    return out


#: kernel launches since the count was last set to 0
stft_magnitude.launches = 0


def _check(audio) -> None:
    if audio.device.type != "cuda":
        raise ValueError(f"stft_magnitude: unsupported device {audio.device}")
    if audio.dtype != torch.float32:
        raise TypeError(f"stft_magnitude: audio must be float32, got {audio.dtype}")
    if audio.dim() != 2 or audio.stride(-1) != 1 or audio.numel() == 0:
        raise ValueError(
            "stft_magnitude: audio must be a non-empty [B, S] with a unit-stride last "
            f"dim, got shape {tuple(audio.shape)} strides {audio.stride()}"
        )


@functools.lru_cache(maxsize=None)
def check_call_geometry(samples: int, n_fft: int, cutoff: int, pad_left: int, pad_right: int,
                        hop: int) -> None:
    """What the kernel takes of a call's shapes: one reflection a side,
    at least one frame, the Pallas kernel's whole hops, one of the
    kernel's (n_fft, cutoff) instances, hops of whole slices."""
    if not (0 <= pad_left < samples and 0 <= pad_right < samples) or hop < 1:
        # one reflection reaches back at most samples - 1
        raise ValueError(
            f"stft_magnitude: reflect pads {pad_left}/{pad_right} need chunks longer than "
            f"the pad, got {samples} samples (hop {hop})"
        )
    padded = samples + pad_left + pad_right
    if padded < n_fft:
        raise ValueError(
            f"stft_magnitude: {samples} samples padded by {pad_left}/{pad_right} are "
            f"shorter than one {n_fft}-sample frame"
        )
    # what the Pallas kernel refuses too: frames of whole hops, chunks of whole hops
    if n_fft % hop or padded % hop:
        raise ValueError(
            f"stft_magnitude: hop {hop} must divide n_fft {n_fft} and the padded chunk "
            f"({padded} samples)"
        )
    check_geometry("stft_magnitude", n_fft, cutoff)
    if hop % SLICE_TAPS:
        raise ValueError(f"stft_magnitude: hop {hop} is not a multiple of {SLICE_TAPS} taps")
