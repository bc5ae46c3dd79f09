"""Weight schemas: named .testtensor archives -> the port's param trees.

Counterpart of vadc_tpu/models/weights.py (and of the param builders in
vadc_tpu/models/silero_v4.py and silero_v5.py), with the same leaf names, so
that a param tree of either package maps leaf for leaf onto the other's.
Leaves are fp32 torch tensors on an explicit device.

Archive layouts. v3.1 (99 tensors, reference utils.py:194-232):
`forward_basis_buffer`, four `transformer_l{1..4}.*` groups (l3 has no
conv-block projection), the fused LSTM `weights`/`biases`, and
`decoder_weights`/`decoder_biases`. v4: the same basis, LSTM and decoder
names around four `stage{1..4}.*` conv groups. v5: the basis, four
`enc{1..4}.weight`/`.bias` k3 convs, the LSTM and the decoder.
"""

from __future__ import annotations

from pathlib import Path
from typing import Callable

import numpy as np
import torch

from vadc_tpu_torch.io.testtensor import load_testtensor

# The bundled weight archives are data of the repository, kept once under
# vadc_tpu/data and read by path (nothing of that package is imported).
DATA_DIR = Path(__file__).resolve().parents[2] / "vadc_tpu" / "data"
DEFAULT_WEIGHTS = DATA_DIR / "silero_v31_16k.testtensor"

# Encoder stage conv strides for v3 (reference tensor.h:158-161).
V3_STRIDES = (2, 2, 1, 1)
# v4 16 kHz strides stage 3 by 2 as well (silero_vad.py:175-178).
V4_STRIDES_16K = (2, 2, 2, 1)
V4_STRIDES_8K = (2, 2, 1, 1)

_TRANSFORMER_KEYS = {
    "dw_w": ("dw_conv_weights", "dw"),
    "dw_b": ("dw_conv_biases", None),
    "pw_w": ("pw_conv_weights", "pw"),
    "pw_b": ("pw_conv_biases", None),
    "proj_w": ("proj_weights", "pw"),
    "proj_b": ("proj_biases", None),
    "qkv_w": ("attention_weights", None),
    "qkv_b": ("attention_biases", None),
    "att_proj_w": ("attention_proj_weights", None),
    "att_proj_b": ("attention_proj_biases", None),
    "norm1_w": ("norm1_weights", None),
    "norm1_b": ("norm1_biases", None),
    "lin1_w": ("linear1_weights", None),
    "lin1_b": ("linear1_biases", None),
    "lin2_w": ("linear2_weights", None),
    "lin2_b": ("linear2_biases", None),
    "norm2_w": ("norm2_weights", None),
    "norm2_b": ("norm2_biases", None),
    "conv_w": ("conv_weights", "pw"),
    "conv_b": ("conv_biases", None),
    "bn_w": ("batch_norm_weights", None),
    "bn_b": ("batch_norm_biases", None),
    "bn_mean": ("batch_norm_running_mean", None),
    "bn_var": ("batch_norm_running_var", None),
}

# The v4 encoder stage: a v3 transformer layer's keys minus the
# transformer block (vadc_tpu/models/silero_v4.py:31-44).
_STAGE_KEYS = {
    k: v for k, v in _TRANSFORMER_KEYS.items()
    if k in ("dw_w", "dw_b", "pw_w", "pw_b", "proj_w", "proj_b", "conv_w", "conv_b")
    or k.startswith("bn_")
}


class Params(dict):
    """A param tree: a dict with the JAX pytree's keys and leaves.

    It differs from a plain dict only in caching what the kernels derive
    from it once (the fused kernel's packed weight buffer, the split STFT
    basis), so a tree must not be changed after it is built. The model's
    kernel paths take a Params; every loader here returns one.

    A derived value on a card is complete before it is cached: it is built
    on the current stream, and the shards of one card (engine/shard.py) read
    the same Params from streams of their own."""

    def derived(self, key: str, build: Callable[[], object]):
        cache = self.__dict__.setdefault("_derived", {})
        if key not in cache:
            value = build()
            device = _device_of(value)
            if device is not None and device.type == "cuda":
                torch.cuda.current_stream(device).synchronize()
            cache[key] = value
        return cache[key]


def _device_of(value) -> torch.device | None:
    """The device of a derived value: a tensor, an object with a `device`
    (a packed buffer), or a tuple of them."""
    if isinstance(value, (tuple, list)):
        return _device_of(value[0]) if value else None
    return getattr(value, "device", None)


def _tensor(arr, device) -> torch.Tensor:
    # a copy: the source may be a read-only view (an archive, a JAX array)
    return torch.from_numpy(np.array(arr, dtype=np.float32, copy=True)).to(device)


def _canon(arr: np.ndarray, kind: str | None, device="cpu") -> torch.Tensor:
    """Canonicalize a raw weight: squeeze conv kernel dims to matmul shapes."""
    arr = np.asarray(arr)
    if kind in ("dw", "pw"):
        # dw: [C, 1, 5] or [C, 5] -> [C, 5]; pw: [O, C, 1] or [O, C] -> [O, C]
        arr = arr.reshape(arr.shape[0], -1)
    return _tensor(arr, device)


def transformer_layer_params(
    tensors: dict[str, np.ndarray], prefix: str = "", device="cpu", keys=_TRANSFORMER_KEYS
) -> dict:
    """Extract one encoder-stage param group; `proj_*` are absent for stages
    without a conv-block projection (v3.1 and v4 stage 3), `bn_*` when the
    exporter folded batch norm into the stage conv."""
    p: dict = {}
    for out_key, (name, kind) in keys.items():
        full = f"{prefix}{name}"
        if full not in tensors:
            if out_key in ("proj_w", "proj_b") or out_key.startswith("bn_"):
                continue
            raise KeyError(f"missing weight tensor {full!r}")
        p[out_key] = _canon(tensors[full], kind, device)
    return p


def silero_v31_params(tensors: dict[str, np.ndarray], device="cpu") -> Params:
    """Build the Silero v3.1 param tree from the 99-tensor archive."""
    basis = np.asarray(tensors["forward_basis_buffer"])
    return Params(
        stft_basis=_tensor(basis.reshape(basis.shape[0], -1), device),
        layers=[
            transformer_layer_params(tensors, f"transformer_l{i}.", device)
            for i in (1, 2, 3, 4)
        ],
        lstm_w=_tensor(tensors["weights"], device),
        lstm_b=_tensor(tensors["biases"], device),
        dec_w=_canon(tensors["decoder_weights"], "pw", device),
        dec_b=_tensor(tensors["decoder_biases"], device),
    )


def silero_v4_params(
    tensors: dict[str, np.ndarray], sample_rate: int = 16000, device="cpu"
) -> Params:
    """Build the Silero v4 param tree (either branch: the sample rate
    selects the encoder strides at run time, not the leaves)."""
    del sample_rate  # the tree is the same for both branches, as in vadc_tpu
    basis = np.asarray(tensors["forward_basis_buffer"])
    return Params(
        stft_basis=_tensor(basis.reshape(basis.shape[0], -1), device),
        stages=[
            transformer_layer_params(tensors, f"stage{i}.", device, keys=_STAGE_KEYS)
            for i in (1, 2, 3, 4)
        ],
        lstm_w=_tensor(tensors["weights"], device),
        lstm_b=_tensor(tensors["biases"], device),
        dec_w=_canon(tensors["decoder_weights"], "pw", device),
        dec_b=_tensor(tensors["decoder_biases"], device),
    )


def silero_v5_params(tensors: dict[str, np.ndarray], device="cpu") -> Params:
    """Build the Silero v5 param tree (16 kHz or the 8 kHz branch)."""
    basis = np.asarray(tensors["forward_basis_buffer"])
    return Params(
        stft_basis=_tensor(basis.reshape(basis.shape[0], -1), device),
        encoder=[
            {"w": _tensor(tensors[f"enc{i}.weight"], device),
             "b": _tensor(tensors[f"enc{i}.bias"], device)}
            for i in (1, 2, 3, 4)
        ],
        lstm_w=_tensor(tensors["weights"], device),
        lstm_b=_tensor(tensors["biases"], device),
        dec_w=_canon(tensors["decoder_weights"], "pw", device),
        dec_b=_tensor(tensors["decoder_biases"], device),
    )


def params_from_numpy(tree, device="cpu"):
    """A param tree with numpy leaves (e.g. the JAX package's tree after
    `jax.tree.map(np.asarray, p)`) -> the port's tree of fp32 tensors on
    `device`. Dicts and lists keep their structure; the top-level dict
    becomes a Params."""

    def convert(node):
        if isinstance(node, dict):
            return {k: convert(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [convert(v) for v in node]
        return _tensor(node, device)

    return Params(convert(tree))


def clamp_sequence_count(family: str, requested: int) -> int:
    """Model-imposed chunk-size contract (reference vadc.h:85-94, clamp
    vadc.c:742-754): v3/v4 chunk sizes are multiples of 256 in
    [512, 1536], rounded to the nearest valid point; 8 kHz branch families
    use half-rate slices (128) and ranges; v5 is fixed at 512, v5 8 kHz at
    256."""
    if family == "v5":
        return 512
    if family == "v5_8k":
        return 256
    if family == "v4_8k":
        slice_samples, lo, hi = 128, 256, 768
    else:
        slice_samples, lo, hi = 256, 512, 1536
    rounded = int(requested / slice_samples + 0.5) * slice_samples
    return max(lo, min(hi, rounded))


def detect_model_family(tensors: dict[str, np.ndarray]) -> str:
    """Classify a weight archive as 'v3', 'v4', 'v4_8k', 'v5' or 'v5_8k'
    (reference onnx_helpers.c:154-161, 277-312)."""
    if "transformer_l1.dw_conv_weights" in tensors:
        return "v3"
    if "stage1.dw_conv_weights" in tensors:
        sr = tensors.get("meta.sample_rate")
        if sr is not None and int(sr[0]) == 8000:
            return "v4_8k"
        return "v4"
    if "enc1.weight" in tensors or (
        "weights" in tensors and tensors["weights"].shape[-1] == 256
    ):
        # fused [L, 4H, 2H]: 2H=256 => hidden 128 => v5 (v3/v4 have 2H=128);
        # the 8 kHz branch has a 130-row STFT basis
        sr = tensors.get("meta.sample_rate")
        if sr is not None and int(np.asarray(sr).ravel()[0]) == 8000:
            return "v5_8k"
        basis = tensors.get("forward_basis_buffer")
        if basis is not None and basis.shape[0] == 130:
            return "v5_8k"
        return "v5"
    raise ValueError("unrecognized weight archive layout")


def load_params_from_tensors(
    tensors: dict[str, np.ndarray], device="cpu"
) -> tuple[str, Params]:
    """Classify a loaded tensor archive and build its param tree."""
    family = detect_model_family(tensors)
    if family == "v3":
        return family, silero_v31_params(tensors, device)
    if family in ("v5", "v5_8k"):
        return family, silero_v5_params(tensors, device)
    sample_rate = 8000 if family == "v4_8k" else 16000
    return family, silero_v4_params(tensors, sample_rate, device)


def load_params(
    path: str | Path, device="cpu", sample_rate: int = 16000
) -> tuple[str, Params]:
    """Load model weights from a .testtensor archive (any family) or an
    .onnx graph (through the numpy extractors of export/), returning
    (family, params).

    sample_rate selects the branch of fused v4/v5 .onnx graphs, which carry
    both rates (vadc_tpu/models/weights.py load_params routes it the same
    way); a plain v3 graph has only 16 kHz. Testtensor archives record their
    rate in `meta.sample_rate` and ignore this argument."""
    path = Path(path)
    if path.suffix.lower() == ".onnx":
        from vadc_tpu_torch.export.onnx_extract import classify_model
        from vadc_tpu_torch.export.silero_v3_from_onnx import extract_silero_v3
        from vadc_tpu_torch.export.silero_v4_from_onnx import extract_silero_v4
        from vadc_tpu_torch.export.silero_v5_from_onnx import extract_silero_v5

        family = classify_model(path)
        if family == "v5":
            tensors = extract_silero_v5(path, sample_rate)
        elif family == "v4":
            tensors = extract_silero_v4(path, sample_rate)
        else:
            if sample_rate != 16000:
                raise ValueError("v3 models have no 8 kHz branch (16 kHz only)")
            tensors = extract_silero_v3(path)
        return load_params_from_tensors(tensors, device)
    return load_params_from_tensors(load_testtensor(path), device)
