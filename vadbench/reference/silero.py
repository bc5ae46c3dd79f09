"""Plain fp32 reference of Silero VAD v3.1 and v4 (16 kHz), in PyTorch.

Written from the architecture (a frozen copy of the repository's test
oracle, with the adaptive normalization's filter as a constant) and run on
whatever device its tensors are on. It imports nothing of the program and
takes nothing the program made: the weights are read from the published
`.testtensor` archive, the audio is what the benchmark handed the program.

Streams are independent and each chunk's front-end and encoder see that
chunk alone, so the encoder runs over every chunk of every stream in
blocks of rows; the LSTM then walks each stream's frames in order with the
state carried from chunk to chunk, and the decoder reads each chunk's
frames. TF32 is off unless a caller asks for it (`tf32=True` is the
benchmark's lower-precision control).
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn.functional as tf

from vadbench.reference.testtensor import load_testtensor

# the adaptive normalization's 7-tap smoothing filter (Silero's)
ADAPTIVE_NORM_FILTER = (
    0.03663284704089164733887,
    0.11128076165914535522461,
    0.21674531698226928710938,
    0.27068215608596801757812,
    0.21674531698226928710938,
    0.11128076165914535522461,
    0.03663284704089164733887,
)
# family -> (STFT pad each side, hop, encoder strides, layer prefix)
GEOMETRY = {
    "v3": (128, 64, (2, 2, 1, 1), "transformer_l"),
    "v4": (96, 64, (2, 2, 2, 1), "stage"),
}
HIDDEN = 64
BLOCK_ROWS = 16384  # chunks through the encoder at once


@contextlib.contextmanager
def precision(tf32: bool):
    """fp32 products (TF32 off), or TF32 for the control; restored after."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def load_params(family: str, archive, device) -> dict:
    """The archive's tensors as the reference reads them, on `device`."""
    if family not in GEOMETRY:
        raise ValueError(f"the reference has no family {family!r}")
    raw = load_testtensor(archive)

    def t(name):
        return torch.from_numpy(np.ascontiguousarray(raw[name], np.float32)).to(device)

    prefix = GEOMETRY[family][3]
    layers = []
    for i in (1, 2, 3, 4):
        names = {k[len(f"{prefix}{i}.") :] for k in raw if k.startswith(f"{prefix}{i}.")}
        layers.append({k: t(f"{prefix}{i}.{k}") for k in names})
    basis = t("forward_basis_buffer")
    return {
        "family": family,
        "basis": basis.reshape(basis.shape[0], 1, -1),
        "layers": layers,
        "lstm_w": t("weights"),
        "lstm_b": t("biases"),
        "dec_w": t("decoder_weights").reshape(t("decoder_weights").shape[0], -1),
        "dec_b": t("decoder_biases"),
    }


def stft_magnitude(audio, basis, pad, hop):
    """audio [N, S] -> magnitude [N, 129, F]."""
    x = tf.pad(audio.unsqueeze(1), (pad, pad), mode="reflect")
    spec = tf.conv1d(x, basis, stride=hop)
    cutoff = basis.shape[-1] // 2 + 1
    real, imag = spec[:, :cutoff], spec[:, cutoff:]
    return torch.sqrt(real**2 + imag**2)


def adaptive_norm(spect):
    e = torch.log1p(spect.double() * 1048576.0).float()
    mean = e.mean(dim=1, keepdim=True)
    taps = torch.tensor(ADAPTIVE_NORM_FILTER, dtype=torch.float32, device=e.device).view(1, 1, 7)
    smoothed = tf.conv1d(tf.pad(mean, (3, 3), mode="reflect"), taps)
    return e - smoothed.mean(dim=-1, keepdim=True)


def conv_block(x, p):
    channels = p["dw_conv_weights"].shape[0]
    h = tf.conv1d(x, p["dw_conv_weights"], p["dw_conv_biases"], padding=2, groups=channels).relu()
    h = tf.conv1d(h, p["pw_conv_weights"], p["pw_conv_biases"])
    if "proj_weights" in p:
        h = h + tf.conv1d(x, p["proj_weights"], p["proj_biases"])
    else:
        h = h + x
    return h.relu()


def attention(x, p):
    bsz, seq, dim = x.shape
    q, k, v = tf.linear(x, p["attention_weights"], p["attention_biases"]).chunk(3, dim=-1)
    hd = dim // 2

    def heads(z):
        return z.reshape(bsz, seq, 2, hd).permute(0, 2, 1, 3)

    q, k, v = heads(q), heads(k), heads(v)
    alpha = torch.softmax(k @ q.transpose(-1, -2) / (hd**0.5), dim=-1)
    out = (alpha @ v).permute(0, 2, 1, 3).reshape(bsz, seq, dim)
    return tf.linear(out, p["attention_proj_weights"], p["attention_proj_biases"])


def transformer_block(x, p):
    h = x.permute(0, 2, 1)
    h = h + attention(h, p)
    h = tf.layer_norm(h, (h.shape[-1],), p["norm1_weights"], p["norm1_biases"])
    ff = tf.linear(tf.linear(h, p["linear1_weights"], p["linear1_biases"]).relu(),
                   p["linear2_weights"], p["linear2_biases"])
    h = tf.layer_norm(h + ff, (h.shape[-1],), p["norm2_weights"], p["norm2_biases"])
    return h.permute(0, 2, 1)


def encode(params, chunks):
    """chunks [N, S] -> features [N, T, 64]."""
    pad, hop, strides, _ = GEOMETRY[params["family"]]
    spect = stft_magnitude(chunks, params["basis"], pad, hop)
    if params["family"] == "v3":
        x = adaptive_norm(spect)
    else:
        x = torch.cat([spect, adaptive_norm(spect)], dim=1)
    for p, stride in zip(params["layers"], strides):
        x = conv_block(x, p)
        if "attention_weights" in p:
            x = transformer_block(x, p)
        x = tf.conv1d(x, p["conv_weights"], p["conv_biases"], stride=stride)
        if "batch_norm_weights" in p:
            x = tf.batch_norm(x, p["batch_norm_running_mean"], p["batch_norm_running_var"],
                              p["batch_norm_weights"], p["batch_norm_biases"], False, 0.0, 1e-5)
        x = x.relu()
    return x.permute(0, 2, 1)


def lstm(x, w, b):
    """x [B, T, H] from zero state, fused [L, 4H, 2H] weights -> outputs [B, T, H]."""
    layers, bsz = w.shape[0], x.shape[0]
    h = [x.new_zeros(bsz, HIDDEN) for _ in range(layers)]
    c = [x.new_zeros(bsz, HIDDEN) for _ in range(layers)]
    out = torch.empty_like(x)
    for step in range(x.shape[1]):
        inp = x[:, step]
        for layer in range(layers):
            gates = tf.linear(torch.cat([inp, h[layer]], dim=-1), w[layer], b[layer])
            i, f, g, o = gates.chunk(4, dim=-1)
            c[layer] = f.sigmoid() * c[layer] + i.sigmoid() * g.tanh()
            h[layer] = o.sigmoid() * c[layer].tanh()
            inp = h[layer]
        out[:, step] = inp
    return out


def decode(params, out):
    """LSTM outputs [B, K, T, 64] -> chunk probabilities [B, K]."""
    logits = torch.einsum("bktc,oc->bkto", out.relu(), params["dec_w"]) + params["dec_b"]
    if params["family"] == "v3":
        return logits.mean(dim=2).sigmoid()[..., 1]
    return logits.sigmoid().mean(dim=2)[..., 0]


def stream_probs(params, audio: torch.Tensor, chunk: int, *, tf32: bool = False) -> torch.Tensor:
    """audio [B, K * chunk] fp32 (s16 / 32768), each row one stream from its
    start -> the probability of each chunk, [B, K]."""
    bsz = audio.shape[0]
    n_chunks = audio.shape[1] // chunk
    rows = audio[:, : n_chunks * chunk].reshape(bsz * n_chunks, chunk)
    with torch.no_grad(), precision(tf32):
        feats = torch.cat([encode(params, rows[r : r + BLOCK_ROWS])
                           for r in range(0, rows.shape[0], BLOCK_ROWS)])
        frames = feats.shape[1]
        seq = lstm(feats.reshape(bsz, n_chunks * frames, HIDDEN), params["lstm_w"],
                   params["lstm_b"])
        return decode(params, seq.reshape(bsz, n_chunks, frames, HIDDEN))
