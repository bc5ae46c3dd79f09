"""2-layer LSTM with the v3 decoder folded in, as one CUDA kernel.

Counterpart of vadc_tpu/kernels/lstm.py (`lstm_decoder_fused`). The kernel
is `csrc/lstm_decoder.cu` on the resident-weights kernels of
`csrc/lstm_resident.cuh` (a pre-pass, then the recurrent kernel); the
headers say what bounds them on an H100 and how the design answers that.
Beyond the JAX function (x [B, T, 64] -> probs [B]) it takes x [B, K, T,
64], K consecutive chunks of each stream, and walks them in order in one
launch with the state carried from chunk to chunk: the slab scan of the
offline corpus path (`models/silero_v31.forward_scan`) and the CLI's window
(`forward_minibatched`, B = 1) run it that way, after the encoders of all
the chunks ran at once (`silero_v31_fused.encode_fused_audio`).

It takes the precision tier (`nn.precision`; default faithful), an
instance each: the gate sums, the tanh and the decoder's product of the
tier, as the fused kernels' step LSTM computes them (at balanced and fast
the gate sums on the tensor cores, from `weight_of(params, tier)`; turbo
keeps the CUDA-core chains: `lstm.v31_gates_on_mma`), so a slab equals the
loop of steps at every tier.
"""

from __future__ import annotations

import ctypes

import torch

from vadc_tpu_torch.kernels import _build
from vadc_tpu_torch.kernels import lstm as KL
from vadc_tpu_torch.kernels.lstm import _streams, pre_scratch, v31_gates_on_mma
from vadc_tpu_torch.nn import functional as F
from vadc_tpu_torch.nn.precision import FAITHFUL, Tier, pack_operand, tier_of

HIDDEN = 64
LAYERS = 2


def weight_of(params, tier: Tier | str = FAITHFUL) -> torch.Tensor:
    """What the tier's instance reads as `wt`, built once per Params: the
    gate fragments where the tier's v3.1 LSTM runs on the tensor cores
    (`lstm.v31_gates_on_mma`: balanced, fast), else the transposed weight
    packed for the tier's products."""
    return KL.weight_of(params, tier, v31_gates_on_mma(tier))


def kernel_weight(w: torch.Tensor, tier: Tier | str) -> torch.Tensor:
    """weight_of's tensor for a bare weight w [2, 256, 128]."""
    tier = tier_of(tier)
    return KL.kernel_weight(w, tier, v31_gates_on_mma(tier))


def lstm_decoder_fused_reference(
    x: torch.Tensor,
    h0: torch.Tensor,
    c0: torch.Tensor,
    w: torch.Tensor,
    b: torch.Tensor,
    dec_w: torch.Tensor,
    dec_b: torch.Tensor,
    tier: Tier | str = FAITHFUL,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version: nn.functional.lstm then decoder_v3_nlc per chunk at
    the tier, the state threading from chunk to chunk. x [B, T, 64] ->
    probs [B]; x [B, K, T, 64] -> probs [B, K]; h0, c0 [2, B, 64]; w [2,
    256, 128]; b [2, 256]; dec_w [2, 64]; dec_b [2] -> (probs, hn, cn)."""
    tier = tier_of(tier)
    if x.dim() == 3:
        out, hn, cn = F.lstm(x, h0, c0, w, b, tier)
        return F.decoder_v3_nlc(out, dec_w, dec_b, tier), hn, cn
    hn, cn = h0, c0
    probs = []
    for k in range(x.shape[1]):
        out, hn, cn = F.lstm(x[:, k], hn, cn, w, b, tier)
        probs.append(F.decoder_v3_nlc(out, dec_w, dec_b, tier))
    return torch.stack(probs, dim=1), hn, cn


def _launch(x, h0, c0, wt, b, dec_w, dec_b, probs, hn, cn, tier=FAITHFUL) -> int:
    """Launches the kernel at the tier (wt and dec_w packed for it): the
    pre-pass and the recurrent kernel, once for each pass over the scratch;
    returns the kernels launched."""
    batch, frames = x.shape[0], x.shape[-2]
    chunks = x.shape[1] if x.dim() == 4 else 1
    pre = pre_scratch(x, batch, chunks * frames, frames)
    launched = ctypes.c_int(0)
    status = _build.library().vadc_lstm_decoder_fused_resident(
        x.data_ptr(), h0.data_ptr(), c0.data_ptr(), wt.data_ptr(), b.data_ptr(),
        dec_w.data_ptr(), dec_b.data_ptr(), pre.data_ptr(), pre.shape[0], probs.data_ptr(),
        hn.data_ptr(), cn.data_ptr(), batch, chunks, frames, tier.index, _streams(x, tier),
        ctypes.byref(launched), torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(status, "lstm_decoder_fused")
    return launched.value


def lstm_decoder_fused(
    x: torch.Tensor,
    h0: torch.Tensor,
    c0: torch.Tensor,
    w: torch.Tensor,
    b: torch.Tensor,
    dec_w: torch.Tensor,
    dec_b: torch.Tensor,
    *,
    hn: torch.Tensor | None = None,
    cn: torch.Tensor | None = None,
    wt: torch.Tensor | None = None,
    tier: Tier | str = FAITHFUL,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Encoder output, state and the LSTM's and decoder's weights -> (speech
    probabilities, hn, cn).

    x [B, T, 64] gives probs [B]. x [B, K, T, 64] gives probs [B, K]: the
    same computation for K chunks of each stream in order, the state carried
    from chunk to chunk and the decoder's frame mean taken per chunk; it
    equals K successive calls with x[:, k] bit for bit. h0, c0 [2, B, 64];
    w [2, 256, 128]; b [2, 256]; dec_w [2, 64]; dec_b [2].

    The new state goes to `hn`/`cn` when given, which may BE `h0`/`c0` (the
    state is then updated in place); otherwise to new tensors. `wt` is
    `kernel_weight(w, tier)` when the caller keeps it (`weight_of(params,
    tier)`). A CPU tensor takes the plain version; a CUDA tensor launches
    the tier's instance of the kernel or raises."""
    tier = tier_of(tier)
    if x.device.type == "cpu":
        probs, h_new, c_new = lstm_decoder_fused_reference(x, h0, c0, w, b, dec_w, dec_b, tier)
        if hn is not None:
            h_new = hn.copy_(h_new)
        if cn is not None:
            c_new = cn.copy_(c_new)
        return probs, h_new, c_new
    if wt is None:
        wt = kernel_weight(w, tier)
    dec_w = pack_operand(dec_w, tier.products)
    if hn is None:
        hn = torch.empty_like(h0)
    if cn is None:
        cn = torch.empty_like(c0)
    _check(x, h0, c0, wt, b, dec_w, dec_b, hn, cn, tier)
    probs = torch.empty(x.shape[:-2], dtype=torch.float32, device=x.device)
    lstm_decoder_fused.launches += _launch(x, h0, c0, wt, b, dec_w, dec_b, probs, hn, cn, tier)
    return probs, hn, cn


#: kernels launched since the count was last set to 0: two a pass over the
#: scratch (the pre-pass counts)
lstm_decoder_fused.launches = 0


def _check(x, h0, c0, wt, b, dec_w, dec_b, hn, cn, tier: Tier = FAITHFUL) -> None:
    if x.dim() not in (3, 4) or x.shape[-1] != HIDDEN or 0 in x.shape:
        raise ValueError(
            f"lstm_decoder_fused: x must be [B, T, {HIDDEN}] or [B, K, T, {HIDDEN}], "
            f"got {tuple(x.shape)}"
        )
    state_shape = (LAYERS, x.shape[0], HIDDEN)
    shapes = {"wt": KL.weight_shape(LAYERS, HIDDEN, tier, v31_gates_on_mma(tier)),
              "b": (LAYERS, 4 * HIDDEN),
              "dec_w": (2, HIDDEN), "dec_b": (2,),
              "h0": state_shape, "c0": state_shape, "hn": state_shape, "cn": state_shape}
    for name, t in (("x", x), ("h0", h0), ("c0", c0), ("wt", wt), ("b", b), ("dec_w", dec_w),
                    ("dec_b", dec_b), ("hn", hn), ("cn", cn)):
        if t.dtype != torch.float32:
            raise TypeError(f"lstm_decoder_fused: {name} must be float32, got {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"lstm_decoder_fused: {name} on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"lstm_decoder_fused: {name} must be contiguous")
        if name in shapes and tuple(t.shape) != shapes[name]:
            raise ValueError(f"lstm_decoder_fused: {name} {tuple(t.shape)} is not {shapes[name]}")
    if x.device.type != "cuda":
        raise ValueError(f"lstm_decoder_fused: unsupported device {x.device}")
    mode = getattr(wt, "_vadc_products", None)
    if mode != tier.products:
        raise ValueError(
            f"lstm_decoder_fused: the {tier} instance takes wt packed for {tier.products} "
            f"products (lstm_decoder.kernel_weight(w, {tier.name!r})), got one packed for {mode}"
        )
