"""Silero v3.1 encoder + LSTM + decoder as one CUDA kernel.

Counterpart of vadc_tpu/kernels/silero_v31_fused2d.py (`forward_fused2d`).
The kernel is `csrc/silero_v31_fused.cu`; its header says what bounds it on
an H100 and how its design answers that. The 2-D formulation of the Pallas
kernel (selection matmuls, block-diagonal masked attention) existed only
for the TPU compiler and is not carried over; the same kernel also serves
`silero_v31_fused3d.forward_fused3d`.

Unlike the JAX entry point, which runs the STFT and the adaptive
normalization itself, this one takes the normalized features: in the port
the front-end is `models/silero_v31.features` (the dot_magnitude kernel and
torch ops).

Both take the precision tier (`nn.precision`; default faithful) and launch
that instance of the kernel with the weights packed for it
(`pack_weights(params, tier)`); the fast instance is the port of
`forward_fused2d(fast=True)`. Their plain versions compute the same tier
with torch ops.

`encode_fused` is the same source's second entry: the four encoder stages
alone, storing the last stage's output. It is no port of a Pallas kernel
(the JAX package leaves `encode_nlc` to XLA). `lstm_decoder_fused` on its
rows gives `forward_fused2d`'s bits. The model's slab scan runs the
counterpart that starts from raw audio,
`kernels.silero_v31_fused.encode_fused_audio`; this one serves callers that
hold normalized features.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from vadc_tpu_torch.kernels import _build
from vadc_tpu_torch.kernels.lstm_decoder import kernel_weight
from vadc_tpu_torch.models.weights import V3_STRIDES, Params
from vadc_tpu_torch.nn import functional as F
from vadc_tpu_torch.nn.precision import (
    FAITHFUL, Tier, bf16, pack_operand, split, store, tier_of,
)
from vadc_tpu_torch.tracing import zone

HIDDEN = 64
N_FEAT = 129
MIN_FRAMES, MAX_FRAMES = 9, 25  # 512..1536-sample chunks
# (in, out) channels of the four encoder stages the kernel is built for
STAGE_WIDTHS = ((129, 16), (16, 32), (32, 32), (32, 64))

# Packed-buffer slots, in the order of StageSlot / TailSlot in the .cu file.
_STAGE_SLOTS = (
    "dw_w", "dw_b", "pw_w", "pw_b", "proj_w", "proj_b", "qkv_w", "qkv_b",
    "att_proj_w", "att_proj_b", "norm1_w", "norm1_b", "lin1_w", "lin1_b",
    "lin2_w", "lin2_b", "norm2_w", "norm2_b", "conv_w", "conv_b",
    "bn_scale", "bn_shift",
)
_TAIL_SLOTS = ("lstm_w0", "lstm_w1", "lstm_b0", "lstm_b1", "dec_w", "dec_b")
_ALIGN = 4  # floats: every packed tensor starts 16-byte aligned
# stored transposed ([in, out]; dw_w as [5, C]) so neighbouring threads of
# the kernel read neighbouring weights
_TRANSPOSED = {"dw_w", "pw_w", "proj_w", "qkv_w", "att_proj_w", "lin1_w", "lin2_w", "conv_w"}
# the weights of products, packed as the tier's operands (csrc/tier.cuh);
# the LSTM's two layers as lstm_decoder_fused reads them
# (lstm_decoder.kernel_weight: at balanced and fast their gate fragments,
# which csrc/lstm_mma.cuh reads)
_PRODUCTS = {"pw_w", "proj_w", "qkv_w", "att_proj_w", "lin1_w", "lin2_w", "conv_w", "dec_w"}
# the encoder's products, which the bf16 tiers run on the tensor cores
# (csrc/silero_v31_body.cuh: linear_mma) from fragment blocks
_FRAGMENTS = {"pw_w", "proj_w", "qkv_w", "att_proj_w", "lin1_w", "lin2_w", "conv_w"}
# what turbo's bf16 encoder ops read as bf16 (the JAX package's `astype`s)
_BF16_IN_TURBO = {"dw_w", "dw_b", "pw_b", "proj_b", "qkv_b", "att_proj_b", "lin1_b", "lin2_b",
                  "conv_b", "bn_scale", "bn_shift"}


def pack_fragments(wt: torch.Tensor, mode: str) -> torch.Tensor:
    """A product's transposed weight wt [K, N] (N a multiple of 8) as the
    bf16 tiers' tensor-core products read it (csrc/silero_v31_body.cuh:
    frag_words): K zero-padded to Kp, a multiple of 16; for each n8 tile j,
    each k16 step kb and each lane l (g = l // 4, t = l % 4) the mma.sync B
    fragment's two 32-bit words, rows k = 16 kb + 2t (+ 8) and k + 1 of
    column n = 8j + g as bf16 in the lower and the upper half; at bf16_3x
    (mode) hi = bf16(w) then lo = bf16(w - hi), four words a lane; at bf16
    the two of bf16(w). Returned flat, as an fp32 tensor of the words'
    bits: [N / 8, Kp / 16, 32, 2 or 4] words in that order."""
    k, n = wt.shape
    if n % 8:
        raise ValueError(f"pack_fragments: {n} columns are not whole n8 tiles")
    kp = -(-k // 16) * 16
    w = torch.zeros(kp, n, dtype=torch.float32, device=wt.device)
    w[:k] = wt
    planes = list(split(w)) if mode == "bf16_3x" else [bf16(w)]
    lane = torch.arange(32, device=wt.device)
    g, t = lane // 4, lane % 4
    rows = (16 * torch.arange(kp // 16, device=wt.device)[:, None, None]
            + 2 * t[None, :, None] + 8 * torch.arange(2, device=wt.device)[None, None, :])
    cols = 8 * torch.arange(n // 8, device=wt.device)[:, None, None, None] + g[None, None, :, None]
    words = []
    for plane in planes:
        bits = plane.to(torch.bfloat16).view(torch.int16).to(torch.int32) & 0xFFFF
        low, high = bits[rows[None], cols], bits[rows[None] + 1, cols]
        words.append(low | (high << 16))  # [N / 8, Kp / 16, 32, 2]
    return torch.cat(words, dim=-1).reshape(-1).view(torch.float32)


class PackedWeights:
    """All v3.1 weights the kernel reads, as one contiguous fp32 device
    buffer and an int32 offset table (-1 for stage 3's absent projection).
    Every tensor starts at a multiple of 4 floats (zeros between), so the
    kernel can copy a matrix to shared memory 16 bytes at a time.
    Batch norm is folded to scale = w / sqrt(var + eps), shift = b -
    mean * scale; a BN-folded archive gets scale 1, shift 0. At a bf16 tier
    the encoder's products' weights are packed as tensor-core fragments
    (pack_fragments), each LSTM layer as lstm_decoder_fused reads it
    (lstm_decoder.kernel_weight) and the decoder's as the tier's operands,
    and in turbo the weights of the bf16 encoder ops are rounded to bf16."""

    def __init__(self, params: dict, tier: Tier = FAITHFUL):
        pieces: list[torch.Tensor] = []
        offsets: list[int] = []
        cursor = 0

        def put(t: torch.Tensor | None, slot: str) -> None:
            nonlocal cursor
            if t is None:
                offsets.append(-1)
                return
            t = t.detach().to(torch.float32)
            if slot in _FRAGMENTS and tier.products != "fp32":
                t = pack_fragments(t, tier.products)
            elif slot in _PRODUCTS:
                t = pack_operand(t, tier.products)
            elif tier.bf16_storage and slot in _BF16_IN_TURBO:
                t = bf16(t)
            flat = t.reshape(-1)
            gap = -cursor % _ALIGN
            if gap:
                pieces.append(flat.new_zeros(gap))
                cursor += gap
            pieces.append(flat)
            offsets.append(cursor)
            cursor += flat.numel()

        layers = params["layers"]
        if len(layers) != len(STAGE_WIDTHS):
            raise ValueError(f"expected {len(STAGE_WIDTHS)} encoder stages, got {len(layers)}")
        for st, (p, (cin, cout)) in enumerate(zip(layers, STAGE_WIDTHS)):
            if tuple(p["pw_w"].shape) != (cout, cin) or tuple(p["dw_w"].shape) != (cin, 5):
                raise ValueError(
                    f"stage {st + 1}: weights {tuple(p['pw_w'].shape)} do not match the "
                    f"kernel's v3.1 widths {cin}->{cout}"
                )
            if ("proj_w" in p) != (cin != cout):
                raise ValueError(f"stage {st + 1}: projection presence does not match widths")
            scale, shift = _folded_bn(p)
            for slot in _STAGE_SLOTS:
                if slot == "bn_scale":
                    put(scale, slot)
                    continue
                if slot == "bn_shift":
                    put(shift, slot)
                    continue
                t = p.get(slot)
                put(t.T if (t is not None and slot in _TRANSPOSED) else t, slot)
        lstm_w, lstm_b = params["lstm_w"], params["lstm_b"]
        if tuple(lstm_w.shape) != (2, 4 * HIDDEN, 2 * HIDDEN):
            raise ValueError(f"lstm_w {tuple(lstm_w.shape)} is not [2, 256, 128]")
        for layer, slot in enumerate(("lstm_w0", "lstm_w1")):
            put(kernel_weight(lstm_w[layer : layer + 1].detach().float(), tier)[0], slot)
        put(lstm_b[0], "lstm_b0")
        put(lstm_b[1], "lstm_b1")
        put(params["dec_w"], "dec_w")
        put(params["dec_b"], "dec_b")
        assert len(offsets) == len(STAGE_WIDTHS) * len(_STAGE_SLOTS) + len(_TAIL_SLOTS)
        self.buffer = torch.cat(pieces).contiguous()
        self.offsets = np.asarray(offsets, np.int32)
        self._c_offsets = (ctypes.c_int * len(offsets))(*offsets)

    @property
    def device(self) -> torch.device:
        return self.buffer.device


def _folded_bn(p: dict) -> tuple[torch.Tensor, torch.Tensor]:
    if "bn_w" not in p:
        ones = torch.ones_like(p["conv_b"])
        return ones, torch.zeros_like(p["conv_b"])
    return F.folded_batch_norm(p["bn_mean"], p["bn_var"], p["bn_w"], p["bn_b"])


def pack_weights(params: Params, tier: Tier = FAITHFUL) -> PackedWeights:
    """The packed buffer of a param tree for a tier, built once per Params
    object and tier."""
    return params.derived(
        "silero_v31_fused" if tier is FAITHFUL else f"silero_v31_fused_{tier.name}",
        lambda: PackedWeights(params, tier),
    )


def forward_fused2d_reference(
    params: dict, feats: torch.Tensor, h: torch.Tensor, c: torch.Tensor,
    tier: Tier | str = FAITHFUL,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version: the four encoder stages, the LSTM and the v3 decoder
    of nn/functional at the tier. feats [B, S0, 129]; h, c [2, B, 64] ->
    (probs [B], hn, cn)."""
    tier = tier_of(tier)
    x = encode_fused_reference(params, feats, tier)
    with zone("lstm"):
        out, hn, cn = F.lstm(x, h, c, params["lstm_w"], params["lstm_b"], tier)
    with zone("decoder"):
        return F.decoder_v3_nlc(out, params["dec_w"], params["dec_b"], tier), hn, cn


def forward_fused2d(
    params: Params,
    feats: torch.Tensor,
    h: torch.Tensor,
    c: torch.Tensor,
    *,
    hn: torch.Tensor | None = None,
    cn: torch.Tensor | None = None,
    tier: Tier | str = FAITHFUL,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Encoder + LSTM + decoder over normalized features, at the precision
    tier.

    feats [B, S0, 129] with S0 in 9..25; h, c [2, B, 64]. Returns (probs
    [B], hn, cn). The new state goes to `hn`/`cn` when given, which may BE
    `h`/`c` (the state is then updated in place, as the JAX runner's
    donated buffers are); otherwise to new tensors. A CPU tensor takes the
    plain version; a CUDA tensor launches the kernel or raises."""
    tier = tier_of(tier)
    if feats.device.type == "cpu":
        probs, h_new, c_new = forward_fused2d_reference(params, feats, h, c, tier)
        if hn is not None:
            h_new = hn.copy_(h_new)
        if cn is not None:
            c_new = cn.copy_(c_new)
        return probs, h_new, c_new
    packed = pack_weights(params, tier)
    batch, seq0 = feats.shape[0], feats.shape[1]
    if hn is None:
        hn = torch.empty_like(h)
    if cn is None:
        cn = torch.empty_like(c)
    _check(packed, feats, h, c, hn, cn)
    probs = torch.empty(batch, dtype=torch.float32, device=feats.device)
    lib = _build.library()
    status = lib.vadc_silero_v31_fused(
        packed.buffer.data_ptr(), packed._c_offsets, len(packed.offsets),
        feats.data_ptr(), h.data_ptr(), c.data_ptr(),
        probs.data_ptr(), hn.data_ptr(), cn.data_ptr(),
        batch, seq0, tier.index, torch.cuda.current_stream(feats.device).cuda_stream,
    )
    _build.check(status, "forward_fused2d")
    forward_fused2d.launches += 1
    return probs, hn, cn


#: kernel launches since the count was last set to 0
forward_fused2d.launches = 0


def out_frames(seq0: int) -> int:
    """Frames after the four stages' strides (9..25 -> 3..7)."""
    for stride in V3_STRIDES:
        seq0 = -(-seq0 // stride)
    return seq0


def encode_fused_reference(
    params: dict, feats: torch.Tensor, tier: Tier | str = FAITHFUL
) -> torch.Tensor:
    """Plain version: the four encoder stages of nn/functional
    (`silero_v31.encode_nlc` after the normalization) at the tier, from the
    features as the tier stores them. feats [R, S0, 129] -> [R, T, 64]."""
    tier = tier_of(tier)
    x = store(feats, tier)
    for i, (p, stride) in enumerate(zip(params["layers"], V3_STRIDES)):
        with zone(f"encoder_layer_{i + 1}"):
            x = F.transformer_layer_nlc(x, p, stride=stride, tier=tier)
    return x


def encode_fused(params: Params, feats: torch.Tensor, tier: Tier | str = FAITHFUL) -> torch.Tensor:
    """The four encoder stages over normalized features at the precision
    tier: feats [R, S0, 129] with S0 in 9..25 -> [R, T, 64], T = 3..7. The
    rows are independent (R is streams x chunks on the slab route). A CPU
    tensor takes the plain version; a CUDA tensor launches the kernel or
    raises."""
    tier = tier_of(tier)
    if feats.device.type == "cpu":
        return encode_fused_reference(params, feats, tier)
    packed = pack_weights(params, tier)
    _check_feats("encode_fused", packed, feats)
    rows, seq0 = feats.shape[0], feats.shape[1]
    out = torch.empty(rows, out_frames(seq0), HIDDEN, dtype=torch.float32, device=feats.device)
    lib = _build.library()
    status = lib.vadc_silero_v31_encode(
        packed.buffer.data_ptr(), packed._c_offsets, len(packed.offsets),
        feats.data_ptr(), out.data_ptr(), rows, seq0, tier.index,
        torch.cuda.current_stream(feats.device).cuda_stream,
    )
    _build.check(status, "encode_fused")
    encode_fused.launches += 1
    return out


#: kernel launches since the count was last set to 0
encode_fused.launches = 0


def _check_feats(who: str, packed, feats) -> None:
    if feats.device.type != "cuda":
        raise ValueError(f"{who}: unsupported device {feats.device}")
    if feats.dim() != 3 or feats.shape[2] != N_FEAT:
        raise ValueError(f"{who}: feats must be [B, S0, 129], got {tuple(feats.shape)}")
    batch, seq0 = feats.shape[0], feats.shape[1]
    if not MIN_FRAMES <= seq0 <= MAX_FRAMES or batch < 1:
        raise ValueError(
            f"{who}: {seq0} frames (chunk of 512..1536 samples gives "
            f"{MIN_FRAMES}..{MAX_FRAMES}) and batch {batch}"
        )
    for name, t in (("feats", feats), ("weights", packed.buffer)):
        if t.dtype != torch.float32:
            raise TypeError(f"{who}: {name} must be float32, got {t.dtype}")
        if t.device != feats.device:
            raise ValueError(f"{who}: {name} on {t.device}, feats on {feats.device}")
        if not t.is_contiguous():
            raise ValueError(f"{who}: {name} must be contiguous")


def _check(packed, feats, h, c, hn, cn) -> None:
    _check_feats("forward_fused2d", packed, feats)
    state_shape = (2, feats.shape[0], HIDDEN)
    for name, t in (("h", h), ("c", c), ("hn", hn), ("cn", cn)):
        if t.dtype != torch.float32:
            raise TypeError(f"forward_fused2d: {name} must be float32, got {t.dtype}")
        if t.device != feats.device:
            raise ValueError(f"forward_fused2d: {name} on {t.device}, feats on {feats.device}")
        if not t.is_contiguous():
            raise ValueError(f"forward_fused2d: {name} must be contiguous")
        if tuple(t.shape) != state_shape:
            raise ValueError(f"forward_fused2d: {name} {tuple(t.shape)} is not {state_shape}")
