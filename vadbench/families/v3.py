"""Silero v3.1: the spectrum, four encoder stages with attention, two LSTM
layers of width 64 and a 2-logit decoder a frame."""

from vadbench.metrics import counts

#: (in, out, has a projection, stride) of each encoder stage
STAGES = ((129, 16, True, 2), (16, 32, True, 2), (32, 32, False, 1), (32, 64, True, 1))
STFT_PAD = 128
DECODER_OUTPUTS = 2


def flops_per_chunk(config: dict) -> float:
    f = counts.frames(config["chunk_samples"], STFT_PAD)
    t = counts.encoder_frames(f, STAGES)
    return (counts.spectrum_flops(f) + counts.encoder_flops(f, STAGES, True)
            + counts.lstm_flops(t) + 2.0 * t * counts.HIDDEN * DECODER_OUTPUTS)
