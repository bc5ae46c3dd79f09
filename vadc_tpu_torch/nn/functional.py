"""Plain PyTorch ops of the Silero channels-last pipelines (v3.1, v4, v5).

Counterpart of the NLC ops in vadc_tpu/nn/functional.py, with the same names
and layouts ([batch, length, channels]) so the tests compare like with like.
These are the plain versions that the CPU runs and that the CUDA kernels are
held against on the card.

Only the faithful tier exists here: every product runs in fp32 (on the card
with TF32 off, vadc_tpu_torch.runtime.require_cuda), tanh and log1p are the
accurate forms the JAX package selects at that tier. Precision is an
argument of the callers (runners, CLI), never a module global.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as tnf

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


def linear(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None) -> torch.Tensor:
    """`x @ w.T + b` with PyTorch weight convention w: [out, in]."""
    y = torch.matmul(x, w.T)
    if b is not None:
        y = y + b
    return y


def reflect_pad_last(x: torch.Tensor, left: int, right: int) -> torch.Tensor:
    """Reflect-pad the last dim (edge excluded, PyTorch 'reflect')."""
    lead = x.shape[:-1]
    flat = x.reshape(-1, 1, x.shape[-1])
    return tnf.pad(flat, (left, right), mode="reflect").reshape(*lead, -1)


def frame(x: torch.Tensor, frame_len: int, hop: int) -> torch.Tensor:
    """Overlapping frames of the last dim, [..., L] -> [..., F, frame_len]
    (a strided view, no copy)."""
    return x.unfold(-1, frame_len, hop)


def spectrum_magnitude(frames: torch.Tensor, wr: torch.Tensor, wi: torch.Tensor) -> torch.Tensor:
    """sqrt((frames @ wr)^2 + (frames @ wi)^2), fp32: frames [..., n_fft],
    wr/wi [n_fft, cutoff] the real and imaginary halves of the basis,
    transposed."""
    real = torch.matmul(frames, wr)
    imag = torch.matmul(frames, wi)
    return torch.sqrt(real * real + imag * imag)


def stft_magnitude_nlc(
    audio: torch.Tensor, basis: torch.Tensor, *, pad_left: int, pad_right: int, hop: int
) -> torch.Tensor:
    """STFT magnitude, frames-major: audio [B, S] -> [B, F, cutoff].

    basis: [2*cutoff, n_fft], real filters then imaginary, of any n_fft
    (256 at 16 kHz, 128 for v5's 8 kHz branch). Frames by unfold, then the
    product with each half and the magnitude, exactly as the dot_magnitude
    kernel's plain version computes it: log1p(2^20 x) downstream (v3, v4)
    turns any rounding difference at a near-zero bin into a large feature
    difference, so the two must not differ in rounding. This function is
    also the plain version of the stft_magnitude kernel."""
    n_fft = basis.shape[1]
    cutoff = basis.shape[0] // 2
    frames = frame(reflect_pad_last(audio, pad_left, pad_right), n_fft, hop)
    return spectrum_magnitude(frames, basis[:cutoff].T.contiguous(), basis[cutoff:].T.contiguous())


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
    e = torch.exp(-2.0 * torch.abs(x))
    return torch.sign(x) * (1.0 - e) / (1.0 + e)


def adaptive_audio_normalization_nlc(spect: torch.Tensor) -> torch.Tensor:
    """Adaptive normalization over [B, F, C] (channels last): log1p(2^20 x),
    per-frame channel mean, reflect-pad 3, 7-tap smoothing, frame mean,
    subtracted from the whole spectrogram (reference misc.c:1-124)."""
    spect_e = accurate_log1p(spect * 1048576.0)
    mean = torch.mean(spect_e, dim=-1)  # [B, F]
    mean_padded = reflect_pad_last(mean, 3, 3)
    taps = torch.tensor(ADAPTIVE_NORM_FILTER, dtype=spect.dtype, device=spect.device)
    smoothed = torch.matmul(frame(mean_padded, 7, 1), taps)  # [B, F]
    mean_mean = torch.mean(smoothed, dim=-1)[:, None, None]
    return spect_e - mean_mean


def depthwise_conv5_nlc(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise k5 pad2 conv over [B, L, C]; w [C, 5] (cross-correlation,
    five shifted scales summed in tap order)."""
    xp = tnf.pad(x, (0, 0, 2, 2))
    length = x.shape[1]
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
) -> torch.Tensor:
    """ConvBlock over [B, L, C]: relu(pw(relu(dw(x))) + proj(x)); the
    residual is the identity where the stage has no projection (stage 3)."""
    h = torch.relu(depthwise_conv5_nlc(x, dw_w, dw_b))
    h = linear(h, pw_w, pw_b)
    if proj_w is not None:
        h = h + linear(x, proj_w, proj_b)
    else:
        h = h + x
    return torch.relu(h)


def attention(
    x: torch.Tensor,
    qkv_w: torch.Tensor,
    qkv_b: torch.Tensor,
    proj_w: torch.Tensor,
    proj_b: torch.Tensor,
    *,
    n_heads: int = 2,
) -> torch.Tensor:
    """Silero's 2-head self-attention over [B, S, D], k.q^T order.

    alpha = softmax(k @ q^T / sqrt(head_dim)) with the softmax over the q
    axis; out = alpha @ v. The score matrix is k-major, unlike the usual
    q-major form, and the two are not equivalent (silero_vad.py:102-124,
    reference transformer.c:13-153). qkv columns are [q | k | v], each split
    into heads by contiguous column blocks."""
    bsz, seq, dim = x.shape
    head_dim = dim // n_heads
    qkv = linear(x, qkv_w, qkv_b)

    def heads(t):  # [B, S, D] -> [B, H, S, hd]
        return t.reshape(bsz, seq, n_heads, head_dim).transpose(1, 2)

    q, k, v = (heads(t) for t in qkv.split(dim, dim=-1))
    scores = torch.matmul(k, q.transpose(-1, -2)) / math.sqrt(head_dim)  # [B, H, S(k), S(q)]
    alpha = torch.softmax(scores, dim=-1)
    out = torch.matmul(alpha, v)  # [B, H, S, hd]
    return linear(out.transpose(1, 2).reshape(bsz, seq, dim), proj_w, proj_b)


def layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """LayerNorm over the last dim, eps 1e-5, biased variance."""
    mean = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mean), dim=-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + LAYER_NORM_EPS) * w + b


def transformer_block_nlc(x: torch.Tensor, p: dict) -> torch.Tensor:
    """Post-norm transformer block over [B, S, C]:
    x + attn(x) -> LN1 -> + linear2(relu(linear1(.))) -> LN2."""
    h = x + attention(x, p["qkv_w"], p["qkv_b"], p["att_proj_w"], p["att_proj_b"])
    h = layer_norm(h, p["norm1_w"], p["norm1_b"])
    ff = linear(torch.relu(linear(h, p["lin1_w"], p["lin1_b"])), p["lin2_w"], p["lin2_b"])
    return layer_norm(h + ff, p["norm2_w"], p["norm2_b"])


def transformer_layer_nlc(x: torch.Tensor, p: dict, *, stride: int) -> torch.Tensor:
    """Encoder stage over [B, S, C]: ConvBlock -> TransformerBlock ->
    stride slicing -> 1x1 conv -> BatchNorm (absent in folded archives)
    -> ReLU."""
    h = conv_block_nlc(
        x, p["dw_w"], p["dw_b"], p["pw_w"], p["pw_b"], p.get("proj_w"), p.get("proj_b")
    )
    h = transformer_block_nlc(h, p)
    if stride != 1:
        h = h[:, ::stride, :]
    h = linear(h, p["conv_w"], p["conv_b"])
    if "bn_w" in p:
        h = batch_norm1d_nlc(h, p["bn_mean"], p["bn_var"], p["bn_w"], p["bn_b"])
    return torch.relu(h)


def lstm_cell(
    x: torch.Tensor, h: torch.Tensor, c: torch.Tensor, w: torch.Tensor, b: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """One LSTM step. x, h, c: [B, H]; w: [4H, 2H] fused on cat[x, h];
    b: [4H] pre-summed ih+hh. Gate order i, f, g, o."""
    gates = torch.matmul(torch.cat([x, h], dim=-1), w.T) + b
    i, f, g, o = gates.chunk(4, dim=-1)
    c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * accurate_tanh(g)
    h_new = torch.sigmoid(o) * accurate_tanh(c_new)
    return h_new, c_new


def lstm(
    x: torch.Tensor, h0: torch.Tensor, c0: torch.Tensor, w: torch.Tensor, b: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Multi-layer LSTM over [B, T, H]; h0, c0: [L, B, H]; w: [L, 4H, 2H];
    b: [L, 4H]. Returns (top-layer output [B, T, H], hn, cn)."""
    hs, cs = list(h0.unbind(0)), list(c0.unbind(0))
    outs = []
    for t in range(x.shape[1]):
        inp = x[:, t]
        for layer in range(w.shape[0]):
            hs[layer], cs[layer] = lstm_cell(inp, hs[layer], cs[layer], w[layer], b[layer])
            inp = hs[layer]
        outs.append(inp)
    return torch.stack(outs, dim=1), torch.stack(hs), torch.stack(cs)


def lstm_minibatched(
    x: torch.Tensor, h0: torch.Tensor, c0: torch.Tensor, w: torch.Tensor, b: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The reference's minibatched LSTM: the N chunks of ONE stream
    flattened into one sequence, so the state threads chunk to chunk.
    x: [N, T, H]; h0, c0: [L, 1, H] (reference lstm.c:228-341)."""
    n, t, feat = x.shape
    out, hn, cn = lstm(x.reshape(1, n * t, feat), h0, c0, w, b)
    return out.reshape(n, t, feat), hn, cn


def conv1d_nlc(
    x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None, *, stride: int = 1, padding: int = 0
) -> torch.Tensor:
    """Small-kernel conv over [B, L, C]; w [O, C, K]. K shifted strided
    products summed in tap order, as the JAX package writes it (not
    torch's conv1d: cuDNN is no kernel of this repo, and it would sum in
    another order)."""
    k = w.shape[-1]
    if padding:
        x = tnf.pad(x, (0, 0, padding, padding))
    out_len = (x.shape[1] - k) // stride + 1
    y = None
    for tap in range(k):
        xs = x[:, tap : tap + (out_len - 1) * stride + 1 : stride, :]
        term = torch.matmul(xs, w[:, :, tap].T)
        y = term if y is None else y + term
    if b is not None:
        y = y + b
    return y


def batch_norm1d_nlc(
    x: torch.Tensor,
    running_mean: torch.Tensor,
    running_var: torch.Tensor,
    w: torch.Tensor,
    b: torch.Tensor,
) -> torch.Tensor:
    """Inference BatchNorm over the channel (last) dim of [B, L, C], fp32."""
    inv = torch.rsqrt(running_var + BATCH_NORM_EPS)
    return (x - running_mean) * inv * w + b


def decoder_v5_nlc(out: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """v4/v5 decoder over LSTM output [B, T, H] -> probs [B]: relu, H->1
    projection, sigmoid, then the frame mean (the sigmoid comes first,
    silero_vad.py:331-341)."""
    logits = linear(torch.relu(out), w, b)  # [B, T, 1]
    return torch.mean(torch.sigmoid(logits[:, :, 0]), dim=1)


def decoder_v3_nlc(out: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """v3 decoder over LSTM output [B, T, H] -> probs [B]: relu, 64->2
    projection, frame mean, sigmoid, channel 1."""
    logits = linear(torch.relu(out), w, b)  # [B, T, 2]
    return torch.sigmoid(torch.mean(logits, dim=1))[:, 1]
