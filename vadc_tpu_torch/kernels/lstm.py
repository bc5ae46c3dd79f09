"""Multi-layer LSTM over a whole sequence as one CUDA kernel.

Counterpart of vadc_tpu/kernels/lstm.py (`lstm_fused`, the kernel form of
nn.functional.lstm). The kernel is `csrc/lstm.cu`; its header says what
bounds it on an H100 and how its design answers that. The v4 (L=2, H=64)
and v5 (L=1, H=128) forwards run it: at batch B with T frames per chunk in
`forward`, and at batch 1 over the N chunks' frames flattened into one
sequence in `forward_minibatched`.
"""

from __future__ import annotations

import torch

from vadc_tpu_torch.kernels import _build
from vadc_tpu_torch.nn import functional as F

#: hidden sizes the kernel is built for (v4: 64, v5: 128)
HIDDEN_SIZES = (64, 128)


def transpose_weight(w: torch.Tensor) -> torch.Tensor:
    """Fused LSTM weight [L, 4H, 2H] -> the kernel's [L, 2H, 4H], contiguous,
    so neighbouring threads (gate columns) read neighbouring weights."""
    return w.transpose(1, 2).contiguous()


def transposed_weight_of(params) -> torch.Tensor:
    """The kernel's weight of a Params' LSTM, transposed once per Params."""
    return params.derived("lstm_wt", lambda: transpose_weight(params["lstm_w"]))


def lstm_fused_reference(
    x: torch.Tensor, h0: torch.Tensor, c0: torch.Tensor, w: torch.Tensor, b: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version: nn.functional.lstm. x [B, T, H]; h0, c0 [L, B, H];
    w [L, 4H, 2H]; b [L, 4H] -> (y [B, T, H], hn, cn)."""
    return F.lstm(x, h0, c0, w, b)


def lstm_fused(
    x: torch.Tensor,
    h0: torch.Tensor,
    c0: torch.Tensor,
    w: torch.Tensor,
    b: torch.Tensor,
    *,
    hn: torch.Tensor | None = None,
    cn: torch.Tensor | None = None,
    wt: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x [B, T, H]; h0, c0 [L, B, H]; w [L, 4H, 2H]; b [L, 4H] -> (y [B, T,
    H], hn, cn), the top layer's h at every step and the final state.

    The new state goes to `hn`/`cn` when given, which may BE `h0`/`c0` (the
    state is then updated in place); otherwise to new tensors. `wt` is
    `transpose_weight(w)` when the caller keeps it (models pass the one
    cached on their Params). A CPU tensor takes the plain version; a CUDA
    tensor launches the kernel or raises."""
    if x.device.type == "cpu":
        y, h_new, c_new = lstm_fused_reference(x, h0, c0, w, b)
        if hn is not None:
            h_new = hn.copy_(h_new)
        if cn is not None:
            c_new = cn.copy_(c_new)
        return y, h_new, c_new
    if wt is None:
        wt = transpose_weight(w)
    if hn is None:
        hn = torch.empty_like(h0)
    if cn is None:
        cn = torch.empty_like(c0)
    _check(x, h0, c0, wt, b, hn, cn)
    batch, seq, hidden = x.shape
    layers = wt.shape[0]
    y = torch.empty_like(x)
    lib = _build.library()
    status = lib.vadc_lstm_fused(
        x.data_ptr(), h0.data_ptr(), c0.data_ptr(), wt.data_ptr(), b.data_ptr(),
        y.data_ptr(), hn.data_ptr(), cn.data_ptr(), batch, seq, hidden, layers,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(status, "lstm_fused")
    lstm_fused.launches += 1
    return y, hn, cn


#: kernel launches since the count was last set to 0
lstm_fused.launches = 0


def _check(x, h0, c0, wt, b, hn, cn) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"lstm_fused: unsupported device {x.device}")
    if x.dim() != 3 or x.shape[2] not in HIDDEN_SIZES or x.shape[0] < 1 or x.shape[1] < 1:
        raise ValueError(
            f"lstm_fused: x must be [B, T, H] with H in {HIDDEN_SIZES}, got {tuple(x.shape)}"
        )
    batch, _, hidden = x.shape
    layers = wt.shape[0]
    state_shape = (layers, batch, hidden)
    shapes = {"wt": (layers, 2 * hidden, 4 * hidden), "b": (layers, 4 * hidden),
              "h0": state_shape, "c0": state_shape, "hn": state_shape, "cn": state_shape}
    for name, t in (("x", x), ("h0", h0), ("c0", c0), ("wt", wt), ("b", b), ("hn", hn),
                    ("cn", cn)):
        if t.dtype != torch.float32:
            raise TypeError(f"lstm_fused: {name} must be float32, got {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"lstm_fused: {name} on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"lstm_fused: {name} must be contiguous")
        if name in shapes and tuple(t.shape) != shapes[name]:
            raise ValueError(f"lstm_fused: {name} {tuple(t.shape)} is not {shapes[name]}")
