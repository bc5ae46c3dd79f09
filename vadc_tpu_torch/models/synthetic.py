"""Synthetic (random-weight) Silero v5 archives of the official shapes.

Counterpart of vadc_tpu/models/synthetic.py, in numpy only: importing the
JAX package's module loads jax through `vadc_tpu/__init__`, which the port
never does. The same seed gives the same arrays as the JAX package's (a
test holds them equal), so results on these weights compare across the two
packages. No official v5 weights are in the repository; results on these
are labelled synthetic.
"""

from __future__ import annotations

import numpy as np


def _random_v5(seed: int, n_fft: int, extra: dict | None) -> dict:
    """4 reparameterized k3 convs, a 1x128 LSTM, a 1-logit decoder. The
    sample rate changes only the STFT geometry: n_fft, hence the basis and
    the first conv's input width n_fft // 2 + 1."""
    rng = np.random.default_rng(seed)

    def r(*shape, scale=0.3):
        return (rng.normal(size=shape) * scale).astype(np.float32)

    cutoff = n_fft // 2 + 1
    shapes = [(128, cutoff, 3), (64, 128, 3), (64, 64, 3), (128, 64, 3)]
    archive = {"forward_basis_buffer": r(2 * cutoff, 1, n_fft, scale=0.1)}
    archive.update(extra or {})
    for i, s in enumerate(shapes, 1):
        archive[f"enc{i}.weight"] = r(*s)
        archive[f"enc{i}.bias"] = r(s[0], scale=0.1)
    archive["weights"] = r(1, 512, 256, scale=0.15)
    archive["biases"] = r(1, 512, scale=0.1)
    archive["decoder_weights"] = r(1, 128, 1)
    archive["decoder_biases"] = r(1, scale=0.1)
    return archive


def random_v5_archive(seed: int = 0) -> dict:
    """16 kHz v5: n_fft 256, hop 128."""
    return _random_v5(seed, 256, None)


def random_v5_8k_archive(seed: int = 1) -> dict:
    """8 kHz v5 branch: half-rate STFT (n_fft 128), same encoder and LSTM."""
    return _random_v5(seed, 128, {"meta.sample_rate": np.asarray([8000.0], np.float32)})


def save_archive(path, tensors: dict) -> None:
    """Write an archive as a .testtensor file, for the entry points that load
    their weights from a path (the CLI, the server)."""
    from vadc_tpu_torch.io.testtensor import save_testtensor

    save_testtensor(str(path), tensors)
