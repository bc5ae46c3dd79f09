"""Device selection, the numeric settings of the card, and the precision
tiers.

The port names its device explicitly everywhere (the counterpart of
`JAX_PLATFORMS` in the JAX package). A CUDA device that is asked for and
absent is an error, never a silent run on the CPU.
"""

from __future__ import annotations

import torch

#: precision tiers of the JAX package (vadc_tpu/nn/functional.py
#: PRECISION_MODES), defined for the port in nn/precision.py
PRECISIONS = ("faithful", "balanced", "fast", "turbo")


class NoCudaDeviceError(RuntimeError):
    """A CUDA device was requested but none is visible to PyTorch."""


def require_cuda() -> torch.device:
    """The current CUDA device, with TF32 off; raises when there is none.

    Every fp32 product stays full fp32 on the card: cuBLAS defaults to
    that, but cuDNN defaults to TF32 (about three decimal digits), which
    would break the faithful tier's 1e-4 contract, and the bf16 tiers'
    plain versions compute their products as fp32 products of bf16-rounded
    values. Both switches are set explicitly."""
    if not torch.cuda.is_available():
        raise NoCudaDeviceError(
            "no CUDA device is visible to PyTorch "
            f"(torch {torch.__version__}, built for CUDA {torch.version.cuda}); "
            "pass --device cpu to run on the CPU"
        )
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", torch.cuda.current_device())


def resolve_device(device: str | torch.device) -> torch.device:
    """'cpu' / 'cuda' / 'cuda:N' -> torch.device; CUDA goes through
    require_cuda so a missing card raises instead of falling back."""
    device = torch.device(device)
    if device.type == "cuda":
        require_cuda()
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    elif device.type != "cpu":
        raise ValueError(f"unsupported device {device}")
    return device


def check_precision(precision: str, family: str) -> None:
    """Raise for an unknown tier. Every family (Silero v3.1, v4 and v5, and
    the 8 kHz twins) runs all four, on every device; `family` names the
    model in the message."""
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r} for the {family} model "
                         f"(one of {', '.join(PRECISIONS)})")
