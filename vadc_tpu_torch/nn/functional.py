"""Plain PyTorch ops of the Silero channels-last pipelines (v3.1, v4, v5).

Counterpart of the NLC ops in vadc_tpu/nn/functional.py, with the same names
and layouts ([batch, length, channels]) so the tests compare like with like.
These are the plain versions that the CPU runs and that the CUDA kernels are
held against on the card.

Every op whose arithmetic a tier changes takes the precision tier as an
argument (a `nn.precision.Tier`, default faithful; never a module global):
the tier's products, tanh, log1p and, in turbo, bf16 storage of the
encoder's activations, as nn/precision.py defines them. At the faithful
tier every product runs in fp32 (on the card with TF32 off,
vadc_tpu_torch.runtime.require_cuda), and tanh and log1p are the accurate
forms the JAX package selects at that tier.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as tnf

from vadc_tpu_torch.nn.precision import (
    FAITHFUL, Tier, bf16, matmul_at, stft_mode, store, tanh_at,
)

# 7-tap smoothing filter of AdaptiveAudioNormalization (reference
# misc.c:5-13; the v3 checkpoint's `adaptive_normalization.filter_`).
ADAPTIVE_NORM_FILTER = (
    0.03663284704089164733887,
    0.11128076165914535522461,
    0.21674531698226928710938,
    0.27068215608596801757812,
    0.21674531698226928710938,
    0.11128076165914535522461,
    0.03663284704089164733887,
)

LAYER_NORM_EPS = 1e-5
BATCH_NORM_EPS = 1e-5


def linear(
    x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None, tier: Tier = FAITHFUL
) -> torch.Tensor:
    """`x @ w.T + b` with PyTorch weight convention w: [out, in], the
    product at the tier, fp32 out."""
    y = matmul_at(x, w.T, tier.products)
    if b is not None:
        y = y + b
    return y


def linear_at(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None, tier: Tier) -> torch.Tensor:
    """The encoder's linear: `linear`, and in turbo the JAX package's bf16
    result, bf16(bf16(x @ w.T) + bf16(b))."""
    if not tier.bf16_storage:
        return linear(x, w, b, tier)
    y = bf16(matmul_at(x, w.T, tier.products))
    return y if b is None else bf16(y + bf16(b))


def reflect_pad_last(x: torch.Tensor, left: int, right: int) -> torch.Tensor:
    """Reflect-pad the last dim (edge excluded, PyTorch 'reflect')."""
    lead = x.shape[:-1]
    flat = x.reshape(-1, 1, x.shape[-1])
    return tnf.pad(flat, (left, right), mode="reflect").reshape(*lead, -1)


def frame(x: torch.Tensor, frame_len: int, hop: int) -> torch.Tensor:
    """Overlapping frames of the last dim, [..., L] -> [..., F, frame_len]
    (a strided view, no copy)."""
    return x.unfold(-1, frame_len, hop)


def spectrum_magnitude(
    frames: torch.Tensor, wr: torch.Tensor, wi: torch.Tensor, mode: str = "fp32"
) -> torch.Tensor:
    """sqrt((frames @ wr)^2 + (frames @ wi)^2), fp32 sums: frames [...,
    n_fft], wr/wi [n_fft, cutoff] the real and imaginary halves of the
    basis, transposed; the products' operands of `mode` (a tier's `stft`)."""
    real = matmul_at(frames, wr, mode)
    imag = matmul_at(frames, wi, mode)
    return torch.sqrt(real * real + imag * imag)


def stft_magnitude_nlc(
    audio: torch.Tensor,
    basis: torch.Tensor,
    *,
    pad_left: int,
    pad_right: int,
    hop: int,
    tier: Tier = FAITHFUL,
    log_sensitive: bool = True,
) -> torch.Tensor:
    """STFT magnitude, frames-major: audio [B, S] -> [B, F, cutoff].

    basis: [2*cutoff, n_fft], real filters then imaginary, of any n_fft
    (256 at 16 kHz, 128 for v5's 8 kHz branch). Frames by unfold, then the
    product with each half and the magnitude, exactly as the dot_magnitude
    kernel's plain version computes it: log1p(2^20 x) downstream (v3, v4)
    turns any rounding difference at a near-zero bin into a large feature
    difference, so the two must not differ in rounding. This function is
    also the plain version of the stft_magnitude kernel. At a bf16 tier the
    products take the operands of `nn.precision.stft_mode(tier,
    log_sensitive)`, the JAX package's `_stft_precision`: where log1p(2^20
    x) follows (v3.1, v4) bf16_3x on fp32 samples at balanced and fast,
    since the log would amplify bf16's noise floor, and bf16 samples and
    basis at turbo; v5 (log_sensitive False) bf16 from fast on."""
    n_fft = basis.shape[1]
    cutoff = basis.shape[0] // 2
    frames = frame(reflect_pad_last(audio, pad_left, pad_right), n_fft, hop)
    return spectrum_magnitude(
        frames, basis[:cutoff].T.contiguous(), basis[cutoff:].T.contiguous(),
        stft_mode(tier, log_sensitive),
    )


def accurate_log1p(y: torch.Tensor) -> torch.Tensor:
    """fp32 log1p to ~1 ulp for y >= 0, the JAX package's construction op
    for op: z = 1+y split into 2^e * m with m in [sqrt(1/2), sqrt(2)) by
    bit manipulation, log(m) by the atanh series in t = (m-1)/(m+1), ln2
    applied as a hi/lo pair."""
    z = 1.0 + y
    bits = z.view(torch.int32)
    e = (bits >> 23) - 127
    m = ((bits & 0x007FFFFF) | 0x3F800000).view(torch.float32)
    big = m > 1.4142135
    m = torch.where(big, m * 0.5, m)
    e = (e + big.to(torch.int32)).to(torch.float32)
    t = (m - 1.0) / (m + 1.0)
    t2 = t * t
    poly = 1.0 + t2 * (
        1.0 / 3.0 + t2 * (0.2 + t2 * (1.0 / 7.0 + t2 * (1.0 / 9.0 + t2 * (1.0 / 11.0))))
    )
    log_m = 2.0 * t * poly
    ln2_hi = 0.693359375  # exact in fp32
    ln2_lo = -2.12194440e-4
    return e * ln2_hi + (log_m + e * ln2_lo)


def accurate_tanh(x: torch.Tensor) -> torch.Tensor:
    """fp32 tanh to ~2e-6 abs: sign(x) * (1 - e) / (1 + e), e = exp(-2|x|)."""
    return tanh_at(x, FAITHFUL)


def log1p_at(y: torch.Tensor, tier: Tier) -> torch.Tensor:
    """The tier's log1p: the 1-ulp series at faithful, the builtin at the
    bf16 tiers (vadc_tpu functional._log1p)."""
    return accurate_log1p(y) if tier.series_log1p else torch.log1p(y)


def adaptive_audio_normalization_nlc(spect: torch.Tensor, tier: Tier = FAITHFUL) -> torch.Tensor:
    """Adaptive normalization over [B, F, C] (channels last): log1p(2^20 x),
    per-frame channel mean, reflect-pad 3, 7-tap smoothing (fp32 at every
    tier: nn/precision.py), frame mean, subtracted from the whole
    spectrogram (reference misc.c:1-124); turbo stores the result as bf16,
    where its bf16 encoder begins."""
    spect_e = log1p_at(spect * 1048576.0, tier)
    mean = torch.mean(spect_e, dim=-1)  # [B, F]
    mean_padded = reflect_pad_last(mean, 3, 3)
    taps = torch.tensor(ADAPTIVE_NORM_FILTER, dtype=spect.dtype, device=spect.device)
    smoothed = torch.matmul(frame(mean_padded, 7, 1), taps)  # [B, F]
    mean_mean = torch.mean(smoothed, dim=-1)[:, None, None]
    return store(spect_e - mean_mean, tier)


def depthwise_conv5_nlc(
    x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, tier: Tier = FAITHFUL
) -> torch.Tensor:
    """Depthwise k5 pad2 conv over [B, L, C]; w [C, 5] (cross-correlation,
    five shifted scales summed in tap order). Elementwise, so fp32 at every
    tier but turbo, where each product and sum is a bf16 op."""
    xp = tnf.pad(x, (0, 0, 2, 2))
    length = x.shape[1]
    if tier.bf16_storage:
        w, b = bf16(w), bf16(b)
        y = bf16(xp[:, 0:length, :] * w[:, 0])
        for k in range(1, 5):
            y = bf16(y + bf16(xp[:, k : k + length, :] * w[:, k]))
        return bf16(y + b)
    y = xp[:, 0:length, :] * w[:, 0]
    for k in range(1, 5):
        y = y + xp[:, k : k + length, :] * w[:, k]
    return y + b


def conv_block_nlc(
    x: torch.Tensor,
    dw_w: torch.Tensor,
    dw_b: torch.Tensor,
    pw_w: torch.Tensor,
    pw_b: torch.Tensor,
    proj_w: torch.Tensor | None,
    proj_b: torch.Tensor | None,
    tier: Tier = FAITHFUL,
) -> torch.Tensor:
    """ConvBlock over [B, L, C]: relu(pw(relu(dw(x))) + proj(x)); the
    residual is the identity where the stage has no projection (stage 3)."""
    h = torch.relu(depthwise_conv5_nlc(x, dw_w, dw_b, tier))
    h = linear_at(h, pw_w, pw_b, tier)
    if proj_w is not None:
        h = store(h + linear_at(x, proj_w, proj_b, tier), tier)
    else:
        h = store(h + x, tier)
    return torch.relu(h)


def attention(
    x: torch.Tensor,
    qkv_w: torch.Tensor,
    qkv_b: torch.Tensor,
    proj_w: torch.Tensor,
    proj_b: torch.Tensor,
    *,
    n_heads: int = 2,
    tier: Tier = FAITHFUL,
) -> torch.Tensor:
    """Silero's 2-head self-attention over [B, S, D], k.q^T order.

    alpha = softmax(k @ q^T / sqrt(head_dim)) with the softmax over the q
    axis; out = alpha @ v. The score matrix is k-major, unlike the usual
    q-major form, and the two are not equivalent (silero_vad.py:102-124,
    reference transformer.c:13-153). qkv columns are [q | k | v], each split
    into heads by contiguous column blocks. The scores and the mix are fp32
    at every tier (the JAX package sums them elementwise, outside its matmul
    precision); turbo stores alpha and the heads' output as bf16."""
    bsz, seq, dim = x.shape
    head_dim = dim // n_heads
    qkv = linear_at(x, qkv_w, qkv_b, tier)

    def heads(t):  # [B, S, D] -> [B, H, S, hd]
        return t.reshape(bsz, seq, n_heads, head_dim).transpose(1, 2)

    q, k, v = (heads(t) for t in qkv.split(dim, dim=-1))
    scores = torch.matmul(k, q.transpose(-1, -2)) / math.sqrt(head_dim)  # [B, H, S(k), S(q)]
    alpha = store(torch.softmax(scores, dim=-1), tier)
    out = store(torch.matmul(alpha, v), tier)  # [B, H, S, hd]
    return linear_at(out.transpose(1, 2).reshape(bsz, seq, dim), proj_w, proj_b, tier)


def layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, tier: Tier = FAITHFUL) -> torch.Tensor:
    """LayerNorm over the last dim, eps 1e-5, biased variance; statistics in
    fp32 at every tier, the result stored as the tier stores it."""
    mean = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mean), dim=-1, keepdim=True)
    return store((x - mean) * torch.rsqrt(var + LAYER_NORM_EPS) * w + b, tier)


def transformer_block_nlc(x: torch.Tensor, p: dict, tier: Tier = FAITHFUL) -> torch.Tensor:
    """Post-norm transformer block over [B, S, C]:
    x + attn(x) -> LN1 -> + linear2(relu(linear1(.))) -> LN2."""
    att = attention(x, p["qkv_w"], p["qkv_b"], p["att_proj_w"], p["att_proj_b"], tier=tier)
    h = layer_norm(store(x + att, tier), p["norm1_w"], p["norm1_b"], tier)
    ff = torch.relu(linear_at(h, p["lin1_w"], p["lin1_b"], tier))
    ff = linear_at(ff, p["lin2_w"], p["lin2_b"], tier)
    return layer_norm(store(h + ff, tier), p["norm2_w"], p["norm2_b"], tier)


def transformer_layer_nlc(x: torch.Tensor, p: dict, *, stride: int, tier: Tier = FAITHFUL) -> torch.Tensor:
    """Encoder stage over [B, S, C]: ConvBlock -> TransformerBlock ->
    stride slicing -> 1x1 conv -> BatchNorm (absent in folded archives)
    -> ReLU. In turbo the batch norm is the JAX package's bf16 form: the
    affine folded in fp32, rounded, applied as two bf16 ops."""
    h = conv_block_nlc(
        x, p["dw_w"], p["dw_b"], p["pw_w"], p["pw_b"], p.get("proj_w"), p.get("proj_b"), tier
    )
    h = transformer_block_nlc(h, p, tier)
    if stride != 1:
        h = h[:, ::stride, :]
    h = linear_at(h, p["conv_w"], p["conv_b"], tier)
    if "bn_w" in p:
        h = batch_norm1d_nlc(h, p["bn_mean"], p["bn_var"], p["bn_w"], p["bn_b"], tier)
    return torch.relu(h)


def lstm_cell(
    x: torch.Tensor,
    h: torch.Tensor,
    c: torch.Tensor,
    w: torch.Tensor,
    b: torch.Tensor,
    tier: Tier = FAITHFUL,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One LSTM step. x, h, c: [B, H]; w: [4H, 2H] fused on cat[x, h];
    b: [4H] pre-summed ih+hh. Gate order i, f, g, o. The gates' product and
    tanh at the tier; the state fp32."""
    gates = matmul_at(torch.cat([x, h], dim=-1), w.T, tier.products) + b
    i, f, g, o = gates.chunk(4, dim=-1)
    c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * tanh_at(g, tier)
    h_new = torch.sigmoid(o) * tanh_at(c_new, tier)
    return h_new, c_new


def lstm(
    x: torch.Tensor,
    h0: torch.Tensor,
    c0: torch.Tensor,
    w: torch.Tensor,
    b: torch.Tensor,
    tier: Tier = FAITHFUL,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Multi-layer LSTM over [B, T, H]; h0, c0: [L, B, H]; w: [L, 4H, 2H];
    b: [L, 4H]. Returns (top-layer output [B, T, H], hn, cn)."""
    hs, cs = list(h0.unbind(0)), list(c0.unbind(0))
    outs = []
    for t in range(x.shape[1]):
        inp = x[:, t]
        for layer in range(w.shape[0]):
            hs[layer], cs[layer] = lstm_cell(inp, hs[layer], cs[layer], w[layer], b[layer], tier)
            inp = hs[layer]
        outs.append(inp)
    return torch.stack(outs, dim=1), torch.stack(hs), torch.stack(cs)


def lstm_minibatched(
    x: torch.Tensor,
    h0: torch.Tensor,
    c0: torch.Tensor,
    w: torch.Tensor,
    b: torch.Tensor,
    tier: Tier = FAITHFUL,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The reference's minibatched LSTM: the N chunks of ONE stream
    flattened into one sequence, so the state threads chunk to chunk.
    x: [N, T, H]; h0, c0: [L, 1, H] (reference lstm.c:228-341)."""
    n, t, feat = x.shape
    out, hn, cn = lstm(x.reshape(1, n * t, feat), h0, c0, w, b, tier)
    return out.reshape(n, t, feat), hn, cn


def conv1d_nlc(
    x: torch.Tensor,
    w: torch.Tensor,
    b: torch.Tensor | None,
    *,
    stride: int = 1,
    padding: int = 0,
    tier: Tier = FAITHFUL,
) -> torch.Tensor:
    """Small-kernel conv over [B, L, C]; w [O, C, K]. K shifted strided
    products at the tier summed in tap order, as the JAX package writes it
    (not torch's conv1d: cuDNN is no kernel of this repo, and it would sum
    in another order). In turbo, where x is stored bf16, each tap's product
    is a bf16 result, the taps are summed in bf16 and the bias is added in
    bf16, as the JAX package's ops on bf16 operands do."""
    k = w.shape[-1]
    if padding:
        x = tnf.pad(x, (0, 0, padding, padding))
    out_len = (x.shape[1] - k) // stride + 1
    y = None
    for tap in range(k):
        xs = x[:, tap : tap + (out_len - 1) * stride + 1 : stride, :]
        term = store(matmul_at(xs, w[:, :, tap].T, tier.products), tier)
        y = term if y is None else store(y + term, tier)
    if b is not None:
        y = store(y + store(b, tier), tier)
    return y


def folded_batch_norm(
    running_mean: torch.Tensor, running_var: torch.Tensor, w: torch.Tensor, b: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """An inference BatchNorm as one affine (scale, shift), folded in fp32:
    turbo's form of the norm and the v3.1 kernels' packed one."""
    scale = w * torch.rsqrt(running_var + BATCH_NORM_EPS)
    return scale, b - running_mean * scale


def batch_norm1d_nlc(
    x: torch.Tensor,
    running_mean: torch.Tensor,
    running_var: torch.Tensor,
    w: torch.Tensor,
    b: torch.Tensor,
    tier: Tier = FAITHFUL,
) -> torch.Tensor:
    """Inference BatchNorm over the channel (last) dim of [B, L, C]: fp32,
    and in turbo the JAX package's bf16 form, the affine folded in fp32,
    rounded, applied as two bf16 ops."""
    if tier.bf16_storage:
        scale, shift = folded_batch_norm(running_mean, running_var, w, b)
        return bf16(bf16(x * bf16(scale)) + bf16(shift))
    inv = torch.rsqrt(running_var + BATCH_NORM_EPS)
    return (x - running_mean) * inv * w + b


def decoder_v5_nlc(
    out: torch.Tensor, w: torch.Tensor, b: torch.Tensor, tier: Tier = FAITHFUL
) -> torch.Tensor:
    """v4/v5 decoder over LSTM output [B, T, H] -> probs [B]: relu, H->1
    projection at the tier, sigmoid, then the frame mean (the sigmoid comes
    first, silero_vad.py:331-341)."""
    logits = linear(torch.relu(out), w, b, tier)  # [B, T, 1]
    return torch.mean(torch.sigmoid(logits[:, :, 0]), dim=1)


def decoder_v3_nlc(
    out: torch.Tensor, w: torch.Tensor, b: torch.Tensor, tier: Tier = FAITHFUL
) -> torch.Tensor:
    """v3 decoder over LSTM output [B, T, H] -> probs [B]: relu, 64->2
    projection, frame mean, sigmoid, channel 1. At the bf16 tiers the frame
    mean of relu(out) comes first and then its product at the tier, as in
    the JAX package's fused kernel (dot(dec_acc / seq, dec_w),
    vadc_tpu/kernels/silero_v31_fused2d.py:224) and the port's kernels."""
    if tier.products == "fp32":
        logits = linear(torch.relu(out), w, b)  # [B, T, 2]
        return torch.sigmoid(torch.mean(logits, dim=1))[:, 1]
    return torch.sigmoid(linear(torch.mean(torch.relu(out), dim=1), w, b, tier))[:, 1]
