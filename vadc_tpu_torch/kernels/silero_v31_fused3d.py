"""Counterpart of vadc_tpu/kernels/silero_v31_fused3d.py (`forward_fused3d`).

The 3-D Pallas kernel computes the same function as the 2-D one; the two
differ only in what the TPU compiler could lower. On the card both entry
points run the one CUDA kernel of `csrc/silero_v31_fused.cu`, through
`silero_v31_fused2d.forward_fused2d` (whose launch count they share).
"""

from __future__ import annotations

import torch

from vadc_tpu_torch.kernels.silero_v31_fused2d import (
    forward_fused2d,
    forward_fused2d_reference,
)
from vadc_tpu_torch.nn.precision import FAITHFUL, Tier, tier_of


def forward_fused3d_reference(
    params: dict, feats: torch.Tensor, h: torch.Tensor, c: torch.Tensor, tier: Tier = FAITHFUL
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version (the same as forward_fused2d_reference)."""
    return forward_fused2d_reference(params, feats, h, c, tier_of(tier))


def forward_fused3d(
    params: dict,
    feats: torch.Tensor,
    h: torch.Tensor,
    c: torch.Tensor,
    *,
    hn: torch.Tensor | None = None,
    cn: torch.Tensor | None = None,
    tier: Tier | str = FAITHFUL,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """feats [B, S0, 129]; h, c [2, B, 64] -> (probs [B], hn, cn); see
    forward_fused2d for the state, device and tier rules."""
    return forward_fused2d(params, feats, h, c, hn=hn, cn=cn, tier=tier)
