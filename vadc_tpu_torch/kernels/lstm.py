"""Multi-layer LSTM over a whole sequence as one CUDA kernel.

Counterpart of vadc_tpu/kernels/lstm.py (`lstm_fused`, the kernel form of
nn.functional.lstm). The kernel is `csrc/lstm.cu` in two variants that give
the same bits, streaming weights for one or two steps and resident weights
(`csrc/lstm_resident.cuh`) for more; the headers say what bounds each on an
H100 and how its design answers that, and `use_resident` here chooses
between them from the shapes alone. The v4 (L=2, H=64) and v5 (L=1, H=128)
forwards run it: at batch B with T frames per chunk in `forward`, and at
batch 1 over the N chunks' frames flattened into one sequence in
`forward_minibatched`.
"""

from __future__ import annotations

import ctypes

import torch

from vadc_tpu_torch.kernels import _build
from vadc_tpu_torch.nn import functional as F
from vadc_tpu_torch.nn.precision import pack_operand

#: hidden sizes the kernel is built for (v4: 64, v5: 128)
HIDDEN_SIZES = (64, 128)
#: (hidden, layers) the resident-weights variant is built for: v4's and v5's;
#: any other depth keeps the streaming-weights variant
RESIDENT_SHAPES = ((64, 2), (128, 1))


def transpose_weight(w: torch.Tensor) -> torch.Tensor:
    """Fused LSTM weight [L, 4H, 2H] -> the kernel's [L, 2H, 4H], contiguous,
    so neighbouring threads (gate columns) read neighbouring weights."""
    return w.transpose(1, 2).contiguous()


def transposed_weight_of(params, mode: str = "fp32") -> torch.Tensor:
    """The kernel's weight of a Params' LSTM, transposed once per Params and
    packed for products of `mode` (a tier's `products`; lstm_decoder.cu's
    resident instances read it so)."""
    key = "lstm_wt" if mode == "fp32" else f"lstm_wt_{mode}"
    return params.derived(key, lambda: pack_operand(transpose_weight(params["lstm_w"]), mode))


def lstm_fused_reference(
    x: torch.Tensor, h0: torch.Tensor, c0: torch.Tensor, w: torch.Tensor, b: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version: nn.functional.lstm. x [B, T, H]; h0, c0 [L, B, H];
    w [L, 4H, 2H]; b [L, 4H] -> (y [B, T, H], hn, cn)."""
    return F.lstm(x, h0, c0, w, b)


def lstm_hoisted_reference(
    x: torch.Tensor, h0: torch.Tensor, c0: torch.Tensor, w: torch.Tensor, b: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version in the resident variant's order: per layer, the input
    gate sums of ALL frames first (x . rows 0..H-1 of the layer's transposed
    weight), then the recurrence from them (+ h . rows H..2H-1, + bias; gate
    order i, f, g, o). Shapes as `lstm_fused_reference`."""
    hidden = x.shape[-1]
    wt = transpose_weight(w)
    seq, hn, cn = x, [], []
    for layer in range(wt.shape[0]):
        pre = torch.matmul(seq, wt[layer, :hidden])  # [B, T, 4H]
        w_rec = wt[layer, hidden:]
        h, c = h0[layer], c0[layer]
        outs = []
        for t in range(seq.shape[1]):
            i, f, g, o = (pre[:, t] + torch.matmul(h, w_rec) + b[layer]).chunk(4, dim=-1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * F.accurate_tanh(g)
            h = torch.sigmoid(o) * F.accurate_tanh(c)
            outs.append(h)
        seq = torch.stack(outs, dim=1)
        hn.append(h)
        cn.append(c)
    return seq, torch.stack(hn), torch.stack(cn)


#: The resident-weights variant takes a call of at least this many steps (T of
#: `lstm_fused`, K * T of `lstm_decoder_fused`) a stream; shorter ones keep the
#: streaming-weights variant, which has no pre-pass and no weights to load.
#: Measured by `chip_smoke.py` (its "time variants" lines) on an NVIDIA H100
#: 80GB HBM3, 700.00 W, streaming / resident ms at B = 1, 64, 2048:
#:   v4 (H=64, L=2)  T=1: 0.0192 / 0.0255, 0.0220 / 0.0381, 0.0270 / 0.0408
#:                   T=3: 0.0490 / 0.0300, 0.0495 / 0.0230, 0.0714 / 0.0620
#:   v5 (H=128, L=1) T=1: 0.0221 / 0.0358, 0.0226 / 0.0457, 0.0478 / 0.0607
#:                   T=2: 0.0343 / 0.0295, 0.0351 / 0.0361, 0.0837 / 0.0943
#:                   T=3: 0.0493 / 0.0335, 0.0502 / 0.0317, 0.1226 / 0.1186
#:   `lstm_decoder_fused` K=1 x T=7: 0.1479 / 0.0249, 0.1524 / 0.0233,
#:                   0.2516 / 0.1200
#: From 3 steps on the resident variant won at every batch measured; at 1 step
#: the streaming one did, and at 2 steps the two split by batch.
RESIDENT_MIN_STEPS = 3


def use_resident(batch: int, steps: int) -> bool:
    """Which variant of the two recurrent kernels runs `steps` steps of each
    of `batch` streams: from the shapes alone (the measured crossover lies at
    the same step count at every batch). Both give the same bits, so the
    choice cannot change a result."""
    return steps >= RESIDENT_MIN_STEPS


#: most bytes of scratch the resident variant asks for (its input gate sums,
#: 16 * H bytes a frame of a stream); a longer call walks the frames in passes
PRE_BYTES_MAX = 256 << 20


def pre_scratch(x: torch.Tensor, batch: int, steps: int, unit: int) -> torch.Tensor:
    """The resident variant's scratch for `steps` frames of `batch` streams
    of x's width: all rows, or as many as PRE_BYTES_MAX holds but at least
    `unit` frames of every stream."""
    hidden = x.shape[-1]
    rows = min(batch * steps, max(batch * unit, PRE_BYTES_MAX // (16 * hidden)))
    return torch.empty((rows, 4 * hidden), dtype=torch.float32, device=x.device)


def _launch_streaming(x, h0, c0, wt, b, y, hn, cn) -> int:
    """Launches the streaming-weights kernel; returns the kernels launched."""
    batch, seq, hidden = x.shape
    status = _build.library().vadc_lstm_fused(
        x.data_ptr(), h0.data_ptr(), c0.data_ptr(), wt.data_ptr(), b.data_ptr(),
        y.data_ptr(), hn.data_ptr(), cn.data_ptr(), batch, seq, hidden, wt.shape[0],
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(status, "lstm_fused")
    return 1


def _launch_resident(x, h0, c0, wt, b, y, hn, cn) -> int:
    """Launches the resident-weights variant: the pre-pass and the recurrent
    kernel, once for each pass over the scratch; returns the kernels
    launched."""
    batch, seq, hidden = x.shape
    pre = pre_scratch(x, batch, seq, 1)
    launched = ctypes.c_int(0)
    status = _build.library().vadc_lstm_fused_resident(
        x.data_ptr(), h0.data_ptr(), c0.data_ptr(), wt.data_ptr(), b.data_ptr(),
        pre.data_ptr(), pre.shape[0], y.data_ptr(), hn.data_ptr(), cn.data_ptr(), batch, seq,
        hidden, wt.shape[0], ctypes.byref(launched),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(status, "lstm_fused (resident)")
    return launched.value


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
    tensor launches the kernel (the variant `use_resident` names) or
    raises."""
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
    y = torch.empty_like(x)
    resident = (x.shape[2], wt.shape[0]) in RESIDENT_SHAPES and use_resident(*x.shape[:2])
    launch = _launch_resident if resident else _launch_streaming
    lstm_fused.launches += launch(x, h0, c0, wt, b, y, hn, cn)
    return y, hn, cn


#: kernels launched since the count was last set to 0: one a call of the
#: streaming variant, two a pass of the resident one (its pre-pass counts)
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
