# Copy of vadc_tpu/export/silero_v5_from_onnx.py (numpy only): the port imports nothing of vadc_tpu
# and keeps its own; tests/test_torch_copies.py holds it to the original.
"""Extract Silero v5 weights from the official .onnx model.

The official v5 release is a fused model carrying BOTH sample-rate branches
(`_model` = 16 kHz, `_model_8k` = 8 kHz) selected at runtime through an If
node on the scalar `sr` input — the structure the reference's ORT backend
introspects (onnx_helpers.c:154-161, 314-357). Here the weights of the
requested branch are read directly from the protobuf (initializers inside
the If subgraphs included) and packed into the runtime archive schema of
models/silero_v5.py, with `meta.sample_rate` recorded so family detection
selects the matching half-rate STFT geometry.

Identification is two-tier:
  1. by initializer-name suffix (the jit parameter names survive ONNX
     export: `stft.forward_basis_buffer`, `encoder.{i}.reparam_conv.*`,
     `decoder.rnn.*`, `decoder.decoder.2.*`);
  2. by tensor shape within the branch partition when the exporter mangled
     names — unambiguous except the LSTM weight pair ([512, 128] twice),
     which falls back to graph order (weight_ih precedes weight_hh in every
     known export; the bias pair is order-free since the runtime sums them).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from vadc_tpu_torch.export.onnx_extract import extract_initializers

_ENCODER_SHAPES_16K = ((128, 129, 3), (64, 128, 3), (64, 64, 3), (128, 64, 3))
_ENCODER_SHAPES_8K = ((128, 65, 3), (64, 128, 3), (64, 64, 3), (128, 64, 3))
_BASIS_SHAPE_16K = (258, 1, 256)
_BASIS_SHAPE_8K = (130, 1, 128)


def looks_like_v5(names) -> bool:
    """Heuristic mirror of the reference's v5 classification
    (onnx_helpers.c:154-161: LSTM hidden 128): reparam-conv encoder names
    or a [512, 128]-shaped recurrent weight pair."""
    return any("reparam_conv" in n for n in names)


def _partition(
    inits: dict[str, np.ndarray], sample_rate: int
) -> dict[str, np.ndarray]:
    """Initializers of the requested branch: `_8k`-tagged names for 8 kHz,
    everything else for 16 kHz. Falls back to shape when untagged."""
    tagged_8k = {n: a for n, a in inits.items() if "_8k" in n}
    if sample_rate == 8000:
        if tagged_8k:
            return tagged_8k
        # untagged single-branch model: keep only 8k-shaped tensors
        return inits
    if tagged_8k:
        return {n: a for n, a in inits.items() if "_8k" not in n}
    return inits


def _by_suffix(part: dict[str, np.ndarray], suffixes: tuple[str, ...]):
    hits = [
        (n, a)
        for n, a in part.items()
        if any(n.endswith(s) for s in suffixes)
    ]
    if len(hits) == 1:
        return hits[0][1]
    return None


def _by_shape(part: dict[str, np.ndarray], shape: tuple[int, ...]):
    hits = [a for a in part.values() if a.shape == shape]
    if len(hits) == 1:
        return np.asarray(hits[0])
    return None


def extract_silero_v5(
    path: str | Path, sample_rate: int = 16000
) -> dict[str, np.ndarray]:
    """Official v5 .onnx -> runtime weight archive for one branch."""
    if sample_rate not in (16000, 8000):
        raise ValueError(f"sample_rate must be 16000 or 8000, got {sample_rate}")
    inits = {
        n: np.asarray(a, np.float32)
        for n, a in extract_initializers(path).items()
        if a.dtype.kind == "f"
    }
    part = _partition(inits, sample_rate)
    enc_shapes = _ENCODER_SHAPES_16K if sample_rate == 16000 else _ENCODER_SHAPES_8K
    basis_shape = _BASIS_SHAPE_16K if sample_rate == 16000 else _BASIS_SHAPE_8K

    archive: dict[str, np.ndarray] = {
        "meta.sample_rate": np.asarray([sample_rate], np.float32)
    }

    basis = _by_suffix(part, ("stft.forward_basis_buffer",))
    if basis is None:
        basis = _by_shape(part, basis_shape)
    assert basis is not None, f"no STFT basis {basis_shape} found"
    assert basis.reshape(basis.shape[0], -1).shape == (
        basis_shape[0],
        basis_shape[2],
    ), f"unexpected STFT basis shape {basis.shape}"
    archive["forward_basis_buffer"] = basis

    for i, shape in enumerate(enc_shapes):
        w = _by_suffix(part, (f"encoder.{i}.reparam_conv.weight",))
        b = _by_suffix(part, (f"encoder.{i}.reparam_conv.bias",))
        if w is None:
            w = _by_shape(part, shape)
        assert w is not None, f"encoder stage {i} weight {shape} not found"
        assert w.shape == shape, f"encoder stage {i}: {w.shape} != {shape}"
        assert b is not None and b.shape == (shape[0],), (
            f"encoder stage {i} bias not identified; exporter mangled names "
            "beyond shape-based recovery"
        )
        archive[f"enc{i + 1}.weight"] = w
        archive[f"enc{i + 1}.bias"] = b

    def rnn(part_name: str):
        return _by_suffix(
            part,
            (
                f"decoder.rnn.{part_name}_l0",
                f"decoder.rnn.{part_name}",
                f"rnn.{part_name}",
            ),
        )

    w_ih, w_hh = rnn("weight_ih"), rnn("weight_hh")
    if w_ih is None or w_hh is None:
        # graph-order fallback: ih precedes hh in every known export
        pair = [a for a in part.values() if a.shape == (512, 128)]
        assert len(pair) == 2, f"expected 2 LSTM weight tensors, found {len(pair)}"
        w_ih, w_hh = pair
    b_ih, b_hh = rnn("bias_ih"), rnn("bias_hh")
    if b_ih is None or b_hh is None:
        pair = [a for a in part.values() if a.shape == (512,)]
        assert len(pair) == 2, f"expected 2 LSTM bias tensors, found {len(pair)}"
        b_ih, b_hh = pair  # order-free: the runtime sums them
    archive["weights"] = np.concatenate([w_ih, w_hh], axis=-1)[None]  # [1,512,256]
    archive["biases"] = (b_ih + b_hh)[None]  # [1, 512]

    dec_w = _by_suffix(part, ("decoder.decoder.2.weight",))
    dec_b = _by_suffix(part, ("decoder.decoder.2.bias",))
    if dec_w is None:
        dec_w = _by_shape(part, (1, 128, 1))
    if dec_b is None:
        dec_b = _by_shape(part, (1,))
    assert dec_w is not None and dec_b is not None, "decoder head not found"
    archive["decoder_weights"] = dec_w
    archive["decoder_biases"] = dec_b
    return archive


def main(argv=None) -> int:
    """CLI: extract one branch of an official v5 .onnx into a .testtensor
    archive the runtime loads (`--model out.testtensor`)."""
    import argparse

    from vadc_tpu_torch.io.testtensor import save_testtensor

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("onnx_path")
    p.add_argument("out_path")
    p.add_argument("--sample_rate", type=int, default=16000,
                   choices=(16000, 8000))
    args = p.parse_args(argv)
    save_testtensor(args.out_path, extract_silero_v5(args.onnx_path, args.sample_rate))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
