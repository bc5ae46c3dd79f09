"""Silero v5 (16 kHz): the spectrum of a 576-sample input (a chunk with its
64-sample context; right pad 64, hop 128, 4 frames), four k3 convs, one
LSTM layer of width 128 and a 1-logit decoder a frame."""

from vadbench.metrics import counts

#: (in, out, k, stride) of each conv
CONVS = ((129, 128, 3, 1), (128, 64, 3, 2), (64, 64, 3, 2), (64, 128, 3, 1))
STFT_PAD_RIGHT, STFT_HOP = 64, 128
LSTM_LAYERS, HIDDEN = 1, 128
DECODER_OUTPUTS = 1


def flops_per_chunk(config: dict) -> float:
    samples = config["chunk_samples"] + config["context_samples"]
    frames = (samples + STFT_PAD_RIGHT - counts.N_FFT) // STFT_HOP + 1
    f, convs = frames, 0.0
    for cin, cout, k, stride in CONVS:
        f = -(-f // stride)  # pad 1 keeps a k3 conv's length before the stride
        convs += 2.0 * k * cin * cout * f
    return (counts.spectrum_flops(frames) + convs + counts.lstm_flops(f, LSTM_LAYERS, HIDDEN)
            + 2.0 * f * HIDDEN * DECODER_OUTPUTS)
