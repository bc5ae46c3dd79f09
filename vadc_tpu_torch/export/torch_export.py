"""Torch checkpoint -> .testtensor weight archives.

The offline export path (the role of reference utils.py:93-232): takes a
PyTorch state_dict of a Silero model and packs it into the positional/named
archive layout the runtime loads. LSTM ih|hh weight matrices are concatenated
and the two bias vectors summed — the archive stores the fused form that the
single-bias LSTM cell consumes (reference lstm.c:28-30).

Accepts both naming schemes found in the wild:
  * torchscript exports: `_model1.encoder.{i}.<...>` with ConvBlocks wrapped
    in a Sequential (`.0.` inserted);
  * plain state_dict saves: `encoder.sequential.{i}.<...>` with direct
    ConvBlock children.

torch is only imported by callers that pass tensors; this module works on any
mapping of name -> array-like.
"""

from __future__ import annotations

from pathlib import Path
from typing import Mapping

import numpy as np

from vadc_tpu_torch.io.testtensor import save_testtensor

# Per-stage positions of the TransformerLayer / Conv1d / BatchNorm1d modules
# in the v3 encoder Sequential (stages separated by the ReLU at +3):
# stage i>=2 starts with its ConvBlock at base index.
_V3_STAGE_BASES = (0, 4, 9, 14)
_V3_HAS_PROJ = (True, True, False, True)

_CONVBLOCK_SUBKEYS = {
    "dw_conv_weights": "dw_conv.0.weight",
    "dw_conv_biases": "dw_conv.0.bias",
    "pw_conv_weights": "pw_conv.0.weight",
    "pw_conv_biases": "pw_conv.0.bias",
    "proj_weights": "proj.weight",
    "proj_biases": "proj.bias",
}

_TRANSFORMER_SUBKEYS = {
    "attention_weights": "attention.QKV.weight",
    "attention_biases": "attention.QKV.bias",
    "attention_proj_weights": "attention.out_proj.weight",
    "attention_proj_biases": "attention.out_proj.bias",
    "norm1_weights": "norm1.weight",
    "norm1_biases": "norm1.bias",
    "linear1_weights": "linear1.weight",
    "linear1_biases": "linear1.bias",
    "linear2_weights": "linear2.weight",
    "linear2_biases": "linear2.bias",
    "norm2_weights": "norm2.weight",
    "norm2_biases": "norm2.bias",
}

_BN_SUBKEYS = {
    "batch_norm_weights": "weight",
    "batch_norm_biases": "bias",
    "batch_norm_running_mean": "running_mean",
    "batch_norm_running_var": "running_var",
}


def _to_numpy(v) -> np.ndarray:
    if hasattr(v, "detach"):
        v = v.detach().cpu().numpy()
    return np.asarray(v, dtype=np.float32)


class _KeyResolver:
    """Resolve logical module paths against either naming scheme."""

    def __init__(self, sd: Mapping):
        self.sd = sd
        if any(k.startswith("_model1.") for k in sd):
            self.enc = "_model1.encoder."
            self.first = "_model1.first_layer.0."
            self.lstm = "_model1.lstm."
            self.dec = "_model1.decoder.1."
            self.basis = "_model1.feature_extractor.forward_basis_buffer"
            self.convblock_wrapped = True
        else:
            self.enc = "encoder.sequential."
            self.first = "first_layer."
            self.lstm = "lstm."
            self.dec = "decoder.1."
            self.basis = "feature_extractor.forward_basis_buffer"
            self.convblock_wrapped = False

    def get(self, key: str) -> np.ndarray:
        return _to_numpy(self.sd[key])

    def convblock(self, base: int | None, has_proj: bool) -> dict[str, np.ndarray]:
        """base None => the standalone first_layer conv block."""
        if base is None:
            prefix = self.first
        else:
            wrap = "0." if self.convblock_wrapped else ""
            prefix = f"{self.enc}{base}.{wrap}"
        out = {}
        for archive_key, subkey in _CONVBLOCK_SUBKEYS.items():
            if not has_proj and archive_key.startswith("proj"):
                continue
            out[archive_key] = self.get(prefix + subkey)
        return out


def fuse_lstm(sd: Mapping, prefix: str, num_layers: int) -> dict[str, np.ndarray]:
    """Stack per-layer fused ih|hh weight matrices and summed biases."""
    weights, biases = [], []
    for layer in range(num_layers):
        w_ih = _to_numpy(sd[f"{prefix}weight_ih_l{layer}"])
        w_hh = _to_numpy(sd[f"{prefix}weight_hh_l{layer}"])
        b_ih = _to_numpy(sd[f"{prefix}bias_ih_l{layer}"])
        b_hh = _to_numpy(sd[f"{prefix}bias_hh_l{layer}"])
        weights.append(np.concatenate([w_ih, w_hh], axis=-1))
        biases.append(b_ih + b_hh)
    return {"weights": np.stack(weights), "biases": np.stack(biases)}


def v31_archive_from_state_dict(sd: Mapping) -> dict[str, np.ndarray]:
    """Build the 99-tensor Silero v3.1 archive (layout of
    testdata/silero_v31_16k.testtensor; see SURVEY.md §2.5)."""
    r = _KeyResolver(sd)
    archive: dict[str, np.ndarray] = {"forward_basis_buffer": r.get(r.basis)}
    for i, (base, has_proj) in enumerate(zip(_V3_STAGE_BASES, _V3_HAS_PROJ)):
        prefix = f"transformer_l{i + 1}."
        # stage 1's conv block is the standalone first_layer module
        archive_cb = r.convblock(None if i == 0 else base, has_proj)
        for k, v in archive_cb.items():
            archive[prefix + k] = v
        tl_base = base if i == 0 else base + 1
        for archive_key, subkey in _TRANSFORMER_SUBKEYS.items():
            archive[prefix + archive_key] = r.get(f"{r.enc}{tl_base}.{subkey}")
        conv_base, bn_base = tl_base + 1, tl_base + 2
        archive[prefix + "conv_weights"] = r.get(f"{r.enc}{conv_base}.weight")
        archive[prefix + "conv_biases"] = r.get(f"{r.enc}{conv_base}.bias")
        for archive_key, subkey in _BN_SUBKEYS.items():
            archive[prefix + archive_key] = r.get(f"{r.enc}{bn_base}.{subkey}")
    archive.update(fuse_lstm(sd, r.lstm, num_layers=2))
    archive["decoder_weights"] = r.get(r.dec + "weight")
    archive["decoder_biases"] = r.get(r.dec + "bias")
    return archive


def v5_archive_from_state_dict(
    sd: Mapping, sample_rate: int = 16000
) -> dict[str, np.ndarray]:
    """Build the v5 weight archive from the upstream jit module's state dict.

    Key layout per the upstream v5 jit module (reference
    silero_vad.py:380-392 loads `v5._model.state_dict()` whose keys are
    `stft.forward_basis_buffer`, `encoder.{0..3}.reparam_conv.{weight,bias}`,
    `decoder.rnn.{weight_ih,weight_hh,bias_ih,bias_hh}[_l0]`, and
    `decoder.decoder.2.{weight,bias}`). Accepts keys with or without a
    submodule prefix (`_model.` for the 16 kHz branch, `_model_8k.` for the
    8 kHz branch of the combined upstream module) and with or without the
    `_l0` LSTM suffix. The archive records meta.sample_rate so family
    detection picks the right half-rate geometry."""
    prefix = "_model." if sample_rate == 16000 else "_model_8k."

    def get(key: str) -> np.ndarray:
        for candidate in (f"{prefix}{key}", key):
            if candidate in sd:
                return _to_numpy(sd[candidate])
        raise KeyError(f"missing weight tensor {prefix}{key}")

    archive: dict[str, np.ndarray] = {
        "forward_basis_buffer": get("stft.forward_basis_buffer"),
        "meta.sample_rate": np.asarray([sample_rate], np.float32),
    }
    for i in range(4):
        archive[f"enc{i + 1}.weight"] = get(f"encoder.{i}.reparam_conv.weight")
        archive[f"enc{i + 1}.bias"] = get(f"encoder.{i}.reparam_conv.bias")
    def get_rnn(part: str) -> np.ndarray:
        for key in (f"decoder.rnn.{part}_l0", f"decoder.rnn.{part}"):
            try:
                return get(key)
            except KeyError:
                continue
        raise KeyError(f"missing LSTM tensor decoder.rnn.{part}")

    w_ih = get_rnn("weight_ih")
    w_hh = get_rnn("weight_hh")
    b_ih = get_rnn("bias_ih")
    b_hh = get_rnn("bias_hh")
    archive["weights"] = np.concatenate([w_ih, w_hh], axis=-1)[None]  # [1, 512, 256]
    archive["biases"] = (b_ih + b_hh)[None]  # [1, 512]
    archive["decoder_weights"] = get("decoder.decoder.2.weight")
    archive["decoder_biases"] = get("decoder.decoder.2.bias")
    return archive


def export_v31(checkpoint_path: str | Path, out_path: str | Path) -> None:
    """torch checkpoint (plain state_dict save or jit archive) -> archive."""
    import torch

    path = Path(checkpoint_path)
    try:
        sd = torch.load(path, weights_only=True, map_location="cpu")
    except Exception:
        sd = torch.jit.load(str(path), map_location="cpu").state_dict()
    save_testtensor(out_path, v31_archive_from_state_dict(sd))


def export_v5(
    checkpoint_path: str | Path,
    out_path: str | Path,
    sample_rate: int = 16000,
) -> None:
    """Upstream v5 jit archive (or a plain state_dict save) -> archive.
    sample_rate=8000 extracts the `_model_8k` branch."""
    import torch

    path = Path(checkpoint_path)
    try:
        sd = torch.load(path, weights_only=True, map_location="cpu")
    except Exception:
        sd = torch.jit.load(str(path), map_location="cpu").state_dict()
    save_testtensor(out_path, v5_archive_from_state_dict(sd, sample_rate))
