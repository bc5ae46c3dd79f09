"""Silero v5's four encoder convs (k3, pad 1, strides 1, 2, 2, 1, each with
its bias and a ReLU) in one CUDA kernel: the spectrum [rows, 4, C_in] to
the features [rows, 1, 128].

No kernel of the JAX package is its counterpart: there the convs are XLA
ops (vadc_tpu/models/silero_v5.py). The plain version is the port's own
chain, `models/silero_v5.py: _convs` (`nn.functional.conv1d_nlc`: three
shifted products a conv, summed in tap order), which the CPU runs and
`encode_reference` runs everywhere. On a card `v5_convs` launches
`csrc/v5_convs.cu` once a call instead, whose header says what bounds it
and how it keeps the convs' intermediates and weights out of device
memory: a block owns 32 whole chunks, so a chunk's bits do not depend on
the rows launched with it. `v5_convs.launches` counts the launches, and the
tracing counter `v5.conv_rows` the chunk rows they ran in the current job.

The widths come from the weights: C_in 129 at 16 kHz and 65 in the 8 kHz
branch (the first conv's), the other convs at their published widths. The
weights are packed once per Params and tier (`packed_weights_of`): each
conv's used taps (those through which some output frame reads a real
frame, not the pad's zeros) as slices of SLICE_FLOATS floats, a slice
[SLICE_FLOATS / C_out input channels][C_out] of one tap, the last slice of
a tap padded with zero channels; then the four biases. The products'
operands are the tier's (`nn.precision.pack_operand`), the biases stored as
the tier stores them (`nn.precision.store`).
"""

from __future__ import annotations

import torch

from vadc_tpu_torch import tracing
from vadc_tpu_torch.kernels import _build
from vadc_tpu_torch.nn.precision import FAITHFUL, Tier, pack_operand, store, tier_of

#: the kernel's constants (csrc/v5_convs.cu): floats a weight slice, the
#: spectrum frames a chunk, the convs' strides and output widths, and the
#: input widths (C_in) it is built for
SLICE_FLOATS = 2048
FRAMES = 4
STRIDES = (1, 2, 2, 1)
WIDTHS = (128, 64, 64, 128)
C_INS = (129, 65)


def used_taps(frames: int, stride: int) -> list[int]:
    """The taps of a k3 conv with pad 1 over `frames` input frames through
    which some output frame reads a real frame."""
    out = (frames - 1) // stride + 1
    return [t for t in range(3) if any(0 <= f * stride + t - 1 < frames for f in range(out))]


def packed_weights(params, tier: Tier) -> torch.Tensor:
    """The weight slices and the biases as csrc/v5_convs.cu reads them at
    the tier (the module's docstring gives the layout), on the weights'
    device."""
    mode, parts, frames = tier.products, [], FRAMES
    for p, stride in zip(params["encoder"], STRIDES):
        w = pack_operand(p["w"], mode)  # [C_out, C_in, 3]
        c_out, c_in, _ = w.shape
        per_slice = SLICE_FLOATS // c_out
        padded = -(-c_in // per_slice) * per_slice
        for t in used_taps(frames, stride):
            tap = torch.zeros(padded, c_out, dtype=torch.float32, device=w.device)
            tap[:c_in] = w[:, :, t].T
            parts.append(tap.reshape(-1))
        frames = (frames - 1) // stride + 1
    parts += [store(p["b"], tier) for p in params["encoder"]]
    return torch.cat(parts).contiguous()


def packed_weights_of(params, tier: Tier) -> torch.Tensor:
    """`packed_weights`, built once per Params object and tier."""
    return params.derived(f"v5_convs_{tier.name}", lambda: packed_weights(params, tier))


def v5_convs(params, spect: torch.Tensor, tier: Tier | str = FAITHFUL) -> torch.Tensor:
    """spect [rows, 4, C_in] fp32, contiguous -> features [rows, 1, 128]:
    the four convs of `params["encoder"]` at the tier, each with its bias
    and a ReLU.

    A CPU tensor takes the plain version (models/silero_v5.py: _convs); a
    CUDA tensor launches the kernel (built at first use) or raises."""
    tier = tier_of(tier)
    c_in = _check(params, spect)
    if spect.device.type == "cpu":
        # imported here: models/silero_v5.py imports this module
        from vadc_tpu_torch.models.silero_v5 import _convs

        return _convs(params, spect, tier)
    if spect.device.type != "cuda":
        raise ValueError(f"v5_convs: unsupported device {spect.device}")
    if spect.shape[1] != FRAMES:
        raise ValueError(f"v5_convs: the kernel takes {FRAMES} spectrum frames a chunk, "
                         f"got {spect.shape[1]}")
    packed = packed_weights_of(params, tier)
    if packed.device != spect.device:
        raise ValueError(f"v5_convs: weights on {packed.device}, spectrum on {spect.device}")
    rows = spect.shape[0]
    out = torch.empty(rows, 1, WIDTHS[-1], dtype=torch.float32, device=spect.device)
    status = _build.library().vadc_v5_convs(
        spect.data_ptr(), rows, c_in, packed.data_ptr(), out.data_ptr(), tier.index,
        torch.cuda.current_stream(spect.device).cuda_stream,
    )
    _build.check(status, "v5_convs")
    v5_convs.launches += 1
    tracing.count("v5.conv_rows", rows)
    return out


#: kernel launches since the count was last set to 0
v5_convs.launches = 0


def _check(params, spect: torch.Tensor) -> int:
    """C_in, after what either version takes of the call: a non-empty
    contiguous fp32 [rows, frames, C_in] with C_in the first conv's and one
    the kernel is built for, and the convs at the widths it runs (the
    kernel takes 4 frames; the plain version any number)."""
    shapes = [tuple(p["w"].shape) for p in params["encoder"]]
    c_in = shapes[0][1]
    want = [(WIDTHS[0], c_in, 3), *((o, i, 3) for i, o in zip(WIDTHS, WIDTHS[1:]))]
    if c_in not in C_INS or shapes != want:
        raise ValueError(f"v5_convs: conv weights {shapes}, not {want} with C_in in {C_INS}")
    if spect.dtype != torch.float32:
        raise TypeError(f"v5_convs: spectrum must be float32, got {spect.dtype}")
    if spect.dim() != 3 or spect.shape[0] == 0 or spect.shape[1] == 0 or spect.shape[2] != c_in:
        raise ValueError(f"v5_convs: spectrum must be [rows, frames, {c_in}], both >= 1, "
                         f"got {tuple(spect.shape)}")
    if not spect.is_contiguous():
        raise ValueError(f"v5_convs: spectrum must be contiguous, got strides {spect.stride()}")
    return c_in
