"""Operations and bytes of the port's kernels and of the whole model, as
functions of the shapes they run at; the peaks they are held against.

Operations: 2 flops a multiply-add of the products (the spectrum's two
bases, the encoder's convolutions and attention, the LSTM's gate products,
the decoder); the elementwise work (norms, softmax, activations, the
spectrum's magnitude aside) is not counted, so a share is a lower bound of
the work done. Bytes: each input read once and each output written once,
fp32. The arithmetic is that of the repository's chip smoke test.
"""

from __future__ import annotations

import importlib

#: NVIDIA H100 SXM, published dense peaks: fp32 outside the tensor cores
#: (the faithful tier), and the HBM3 rate
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

N_FFT, BINS, HOP = 256, 129, 64
#: the LSTM of v3.1 and v4 (other widths are passed in)
HIDDEN, LSTM_LAYERS = 64, 2
#: the packed v3.1 weights the step kernel reads (encoder, LSTM, decoder)
V31_WEIGHT_BYTES = 124_632 * 4
BASIS_BYTES = 2 * N_FFT * BINS * 4


def lstm_weight_bytes(layers: int = LSTM_LAYERS, hidden: int = HIDDEN) -> int:
    """Each layer's [4H, 2H] weight and [4H] bias, fp32."""
    return (layers * 4 * hidden * 2 * hidden + layers * 4 * hidden) * 4


def frames(samples: int, pad: int, n_fft: int = N_FFT, hop: int = HOP) -> int:
    return (samples + 2 * pad - n_fft) // hop + 1


def spectrum_flops(rows: int, n_fft: int = N_FFT, bins: int = BINS) -> float:
    """rows frames against the real and the imaginary basis, then two
    squares, a sum and a root a bin."""
    return rows * (2 * 2 * n_fft * bins + 4 * bins)


def encoder_flops(n_frames: int, stages, attention: bool) -> float:
    """One chunk's encoder stages: depthwise k5, pointwise and projection,
    (v3.1) the attention's qkv, scores, mix, output and feed-forward
    products, and the strided 1x1 conv."""
    macs, f = 0, n_frames
    for cin, cout, proj, stride in stages:
        out = -(-f // stride)
        macs += f * cin * 5 + f * cin * cout * (2 if proj else 1)
        if attention:
            macs += f * cout * 3 * cout + 2 * f * f * cout + 3 * f * cout * cout
        macs += out * cout * cout
        f = out
    return 2.0 * macs


def encoder_frames(n_frames: int, stages) -> int:
    for *_x, stride in stages:
        n_frames = -(-n_frames // stride)
    return n_frames


def lstm_flops(steps: int, layers: int = LSTM_LAYERS, hidden: int = HIDDEN) -> float:
    """steps x layers gate products of [2H] x [2H, 4H]."""
    return 2.0 * steps * layers * 2 * hidden * 4 * hidden


def model_flops_per_chunk(config: dict) -> float:
    """The whole model on one chunk of the configuration, as the module of
    its family (vadbench/families/<family>.py) counts it."""
    name = config["family"]
    try:
        family = importlib.import_module(f"vadbench.families.{name}")
    except ModuleNotFoundError as e:
        if e.name != f"vadbench.families.{name}":
            raise
        raise ModuleNotFoundError(
            f"no count of the model family {name!r}: add vadbench/families/{name}.py with "
            "flops_per_chunk(config)", name=e.name) from None
    return family.flops_per_chunk(config)


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the card could take."""
    return max(flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES_PER_S)


def encode_fused_audio(rows: int, samples: int) -> tuple[float, float]:
    """The v3.1 slab's front half: rows chunks -> [rows, T, 64] features."""
    from vadbench.families import v3

    f = frames(samples, v3.STFT_PAD)
    t = encoder_frames(f, v3.STAGES)
    flops = spectrum_flops(rows * f) + rows * encoder_flops(f, v3.STAGES, True)
    nbytes = rows * samples * 4 + rows * t * HIDDEN * 4 + V31_WEIGHT_BYTES + BASIS_BYTES
    return flops, nbytes


def lstm_decoder_fused(batch: int, chunks: int, t: int, width: int = HIDDEN) -> tuple[float, float]:
    """The v3.1 slab's recurrent half: [batch, chunks, t, 64] features ->
    probabilities [batch, chunks], state in and out."""
    steps = batch * chunks * t
    nbytes = (steps * width * 4 + 4 * LSTM_LAYERS * batch * HIDDEN * 4 + batch * chunks * 4
              + lstm_weight_bytes() + (2 * HIDDEN + 2) * 4)
    return lstm_flops(steps), nbytes


def stft_magnitude(batch: int, samples: int, pad_left: int, pad_right: int, hop: int,
                   n_fft: int = N_FFT, bins: int = BINS) -> tuple[float, float]:
    """[batch, samples] raw audio -> magnitudes [batch, F, bins]."""
    f = (samples + pad_left + pad_right - n_fft) // hop + 1
    nbytes = batch * samples * 4 + 2 * n_fft * bins * 4 + batch * f * bins * 4
    return spectrum_flops(batch * f, n_fft, bins), nbytes


def lstm_fused(batch: int, t: int, width: int = HIDDEN, layers: int = LSTM_LAYERS,
               hidden: int = HIDDEN) -> tuple[float, float]:
    """[batch, t, width] frames from a state -> outputs and the new state,
    `layers` layers of width `hidden`."""
    state = 4 * layers * batch * hidden * 4
    return (batch * lstm_flops(t, layers, hidden),
            2 * batch * t * width * 4 + state + lstm_weight_bytes(layers, hidden))


#: the recorded call's shape -> (flops, bytes), by kernel
KERNELS = {
    "encode_fused_audio": lambda shape: encode_fused_audio(*shape),
    "lstm_decoder_fused": lambda shape: lstm_decoder_fused(*shape),
    "stft_magnitude": lambda shape: stft_magnitude(shape[0], shape[1], shape[2], shape[3],
                                                   shape[4], shape[5], shape[6]),
    "lstm_fused": lambda shape: lstm_fused(*shape),
}
