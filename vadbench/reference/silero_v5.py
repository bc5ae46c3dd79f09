"""Plain fp32 reference of Silero VAD v5 (16 kHz), in PyTorch.

Written from the architecture (snakers4/silero-vad v5.0, `Silero_Vad_5`;
a frozen copy of the repository's test oracle, `silero_v5_forward`) and
run on whatever device its tensors are on. It imports nothing of the
program and takes nothing the program made: the weights are read from the
`.testtensor` archive, the audio is what the benchmark handed the program.

  * Input: chunk k of a stream (512 samples) prefixed with the last 64
    samples of chunk k-1, zeros for chunk 0: 576 samples.
  * Spectrum: reflect pad right by 64, conv1d with `forward_basis_buffer`
    [258, 1, 256] at stride 128 (4 frames), magnitude sqrt(re^2 + im^2)
    over the first and the last 129 rows.
  * Encoder: four conv1d, k3, pad 1, strides 1, 2, 2, 1, each followed by
    ReLU: [129, 4] -> [128, 1].
  * LSTM: one layer of width 128, fused weights [1, 512, 256] on [x; h]
    and bias [1, 512], gates in the order i, f, g, o; the state carried
    across all chunks of the stream.
  * Decoder: ReLU, conv1d 128 -> 1 (k1), sigmoid, mean over frames.

Departures from upstream: the LSTM's two weight matrices and two biases
are read fused and pre-summed, as the archive holds them; upstream's
decoder dropout is left out (it is off at inference); the 16 kHz branch
alone (upstream also carries an 8 kHz one); the stream's audio is taken
whole, zero-padded to whole chunks, as the benchmark hands it over.

Streams are independent and each chunk's front-end and encoder see that
chunk (with its context) alone, so the encoder runs over every chunk of
every stream in blocks of rows; the LSTM then walks the chunks in order,
all streams at once, and the decoder reads each chunk's frames. TF32 is
off unless a caller asks for it (`tf32=True` is the benchmark's
lower-precision control).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as tf

from vadbench.reference.silero import precision
from vadbench.reference.testtensor import load_testtensor

CONTEXT = 64
STFT_PAD_RIGHT, HOP = 64, 128
STRIDES = (1, 2, 2, 1)
HIDDEN = 128
BLOCK_ROWS = 16384  # chunks through the encoder at once


def load_params(family: str, archive, device) -> dict:
    """The archive's tensors as the reference reads them, on `device`."""
    if family != "v5":
        raise ValueError(f"the v5 reference has no family {family!r}")
    raw = load_testtensor(archive)

    def t(name):
        return torch.from_numpy(np.ascontiguousarray(raw[name], np.float32)).to(device)

    return {
        "basis": t("forward_basis_buffer"),
        "convs": [(t(f"enc{i}.weight"), t(f"enc{i}.bias")) for i in (1, 2, 3, 4)],
        "lstm_w": t("weights"),
        "lstm_b": t("biases"),
        "dec_w": t("decoder_weights"),
        "dec_b": t("decoder_biases"),
    }


def chunk_inputs(audio: torch.Tensor, chunk: int) -> torch.Tensor:
    """audio [B, K * chunk] -> each chunk with its context, [B, K, 64 +
    chunk] (a view of the audio with 64 zeros in front)."""
    return tf.pad(audio, (CONTEXT, 0)).unfold(1, CONTEXT + chunk, chunk)


def stft_magnitude(x: torch.Tensor, basis: torch.Tensor) -> torch.Tensor:
    """x [N, 576] -> magnitude [N, 129, 4]."""
    spec = tf.conv1d(tf.pad(x.unsqueeze(1), (0, STFT_PAD_RIGHT), mode="reflect"), basis,
                     stride=HOP)
    cutoff = basis.shape[-1] // 2 + 1
    real, imag = spec[:, :cutoff], spec[:, cutoff:]
    return torch.sqrt(real**2 + imag**2)


def encode(params: dict, x: torch.Tensor) -> torch.Tensor:
    """x [N, 576] -> features [N, T, 128]."""
    h = stft_magnitude(x, params["basis"])
    for (w, b), stride in zip(params["convs"], STRIDES):
        h = tf.conv1d(h, w, b, stride=stride, padding=1).relu()
    return h.permute(0, 2, 1)


def lstm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x [B, S, 128] from zero state, one layer -> outputs [B, S, 128]."""
    h = x.new_zeros(x.shape[0], HIDDEN)
    c = x.new_zeros(x.shape[0], HIDDEN)
    out = torch.empty_like(x)
    for step in range(x.shape[1]):
        gates = tf.linear(torch.cat([x[:, step], h], dim=-1), w[0], b[0])
        i, f, g, o = gates.chunk(4, dim=-1)
        c = f.sigmoid() * c + i.sigmoid() * g.tanh()
        h = o.sigmoid() * c.tanh()
        out[:, step] = h
    return out


def decode(params: dict, out: torch.Tensor) -> torch.Tensor:
    """LSTM outputs [N, T, 128] -> chunk probabilities [N]."""
    logits = tf.conv1d(out.relu().permute(0, 2, 1), params["dec_w"], params["dec_b"])
    return logits.sigmoid().mean(dim=-1)[:, 0]


def stream_probs(params, audio: torch.Tensor, chunk: int, *, tf32: bool = False) -> torch.Tensor:
    """audio [B, K * chunk] fp32 (s16 / 32768), each row one stream from its
    start -> the probability of each chunk, [B, K]."""
    bsz = audio.shape[0]
    n_chunks = audio.shape[1] // chunk
    windows = chunk_inputs(audio[:, : n_chunks * chunk], chunk)
    rows = bsz * n_chunks
    with torch.no_grad(), precision(tf32):
        feats = []
        for r0 in range(0, rows, BLOCK_ROWS):
            idx = torch.arange(r0, min(r0 + BLOCK_ROWS, rows), device=audio.device)
            feats.append(encode(params, windows[idx // n_chunks, idx % n_chunks]))
        feats = torch.cat(feats)
        frames = feats.shape[1]
        seq = lstm(feats.reshape(bsz, n_chunks * frames, HIDDEN), params["lstm_w"],
                   params["lstm_b"])
        return decode(params, seq.reshape(bsz * n_chunks, frames, HIDDEN)).reshape(bsz, n_chunks)
