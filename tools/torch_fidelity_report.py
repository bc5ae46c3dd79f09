"""Golden-fidelity report of the PyTorch/CUDA port, with error-magnitude
buckets: the counterpart of tools/fidelity_report.py.

Runs every tracked reference fixture through the port's op
(vadc_tpu_torch/nn/functional.py) and prints the largest absolute error of
each, bucketed as the reference harness does (test.c:70-130: exact zero,
then 1e-10 ... 1). The fixtures keep the reference's [B, C, L] layout; the
port's encoder ops take [B, L, C], so inputs and outputs are transposed
around them. Imports nothing of JAX or of vadc_tpu.

Usage: python tools/torch_fidelity_report.py [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

#: the reference implementation's golden fixtures, in its checkout under the
#: home directory (where tools/fidelity_report.py and tools/tpu_check.py
#: look for them); absent, the report exits 1 and gpu_check skips its tier
TESTDATA = Path.home() / "reference" / "testdata"


def bucket(err: float) -> str:
    if err == 0.0:
        return "zero"
    for exp in range(-10, 1):
        if err <= 10.0**exp:
            return f"<=1e{exp}"
    return "above 1"


def run_cases(testdata: Path, device="cuda") -> list[tuple[str, float]]:
    """Run every tracked golden fixture through the port's ops on `device`
    and return (op name, max-abs-error) pairs: the cases of
    tools/fidelity_report.py's run_cases, in its order and with its names.
    Shared by the report and tools/gpu_check.py."""
    import torch

    from vadc_tpu_torch.io.testtensor import load_testtensor
    from vadc_tpu_torch.models.weights import V3_STRIDES, transformer_layer_params
    from vadc_tpu_torch.nn import functional as F
    from vadc_tpu_torch.runtime import resolve_device

    device = resolve_device(device)
    results = []

    def t(a) -> torch.Tensor:
        return torch.from_numpy(np.array(a, dtype=np.float32, copy=True)).to(device)

    def nlc(a) -> torch.Tensor:  # [B, C, L] fixture -> the port's [B, L, C]
        return t(a).transpose(1, 2)

    def ncl(x: torch.Tensor) -> torch.Tensor:
        return x.transpose(1, 2)

    def check(name, actual, expected):
        got = actual.detach().cpu().double().numpy()
        err = float(np.max(np.abs(got - np.asarray(expected, np.float64))))
        results.append((name, err))

    def layer(d, prefix=""):
        return transformer_layer_params(d, prefix, device)

    d = load_testtensor(testdata / "layernorm_test.testtensor")
    check("layer_norm", F.layer_norm(t(d["input"]), t(d["weight"]), t(d["bias"])), d["result"])

    d = load_testtensor(testdata / "batchnorm_test.testtensor")
    check("batch_norm1d", ncl(F.batch_norm1d_nlc(nlc(d["input"]), t(d["running_mean"]),
                                                 t(d["running_var"]), t(d["weight"]),
                                                 t(d["bias"]))), d["result"])

    d = load_testtensor(testdata / "decoder_test.testtensor")
    # the whole [B, 2, 1] output: relu, 64 -> 2 projection, frame mean, sigmoid
    logits = F.linear(torch.relu(nlc(d["input"])), t(d["weight"][:, :, 0]), t(d["bias"]))
    check("decoder_v3", torch.sigmoid(torch.mean(logits, dim=1))[:, :, None], d["output"])

    d = load_testtensor(testdata / "dw_conv_129.testtensor")
    check("depthwise_conv5", ncl(F.depthwise_conv5_nlc(
        nlc(d["input"][None]), t(d["weight"]).reshape(-1, 5), t(d["bias"])))[0], d["output"])

    d = load_testtensor(testdata / "pw_conv_129_16.testtensor")
    check("pointwise_conv", ncl(F.linear(nlc(d["input"][None]), t(d["weight"][:, :, 0]),
                                         t(d["bias"])))[0], d["output"])

    d = load_testtensor(testdata / "first_layer_conv_block.testtensor")
    check("conv_block", ncl(F.conv_block_nlc(
        nlc(d["input"][None]), t(d["dw_conv.0.weight"]).reshape(-1, 5), t(d["dw_conv.0.bias"]),
        t(d["pw_conv.0.weight"][:, :, 0]), t(d["pw_conv.0.bias"]),
        t(d["proj.weight"][:, :, 0]), t(d["proj.bias"])))[0], d["output"])

    d = load_testtensor(testdata / "dual_head_attention_test.testtensor")
    check("attention", F.attention(t(d["input"])[None], t(d["weights"]), t(d["biases"]),
                                   t(d["proj_weights"]), t(d["proj_biases"]))[0], d["result"])

    d = load_testtensor(testdata / "adaptive_audio_normalization_test.testtensor")
    check("adaptive_norm", ncl(F.adaptive_audio_normalization_nlc(nlc(d["input"]))), d["output"])

    d = load_testtensor(testdata / "lstm_nito_reference_randn.testtensor")
    out, _, _ = F.lstm(t(d["input_x"])[None], t(d["hidden_state_previous"])[:, None, :],
                       t(d["cell_state_previous"])[:, None, :], t(d["weights_transposed"]),
                       t(d["biases"]))
    check("lstm", out[0], d["output"][:7])

    for fixture, layers, label in (
        ("transformer_first_layer.testtensor", None, "encoder layer 1"),
        ("transformer_layers_1_2.testtensor", (1, 2), "encoder layers 1-2"),
        ("transformer_layers_1_2_3.testtensor", (1, 2, 3), "encoder layers 1-3"),
        ("transformer_layers_1_2_3_4.testtensor", (1, 2, 3, 4), "full encoder"),
    ):
        d = load_testtensor(testdata / fixture)
        x = nlc(d["input"])
        if layers is None:
            x = F.transformer_layer_nlc(x, layer(d), stride=2)
        else:
            for lid, stride in zip(layers, V3_STRIDES):
                x = F.transformer_layer_nlc(x, layer(d, f"transformer_l{lid}."), stride=stride)
        check(label, ncl(x), d["result"])

    d = load_testtensor(testdata / "adaptive_normalization_encoder.testtensor")
    x = F.adaptive_audio_normalization_nlc(nlc(d["input"]))
    for lid, stride in zip((1, 2, 3, 4), V3_STRIDES):
        x = F.transformer_layer_nlc(x, layer(d, f"transformer_l{lid}."), stride=stride)
    check("adaptive_norm + encoder", ncl(x), d["result"])
    return results


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = parser.parse_args(argv)

    if not TESTDATA.is_dir():
        print("reference testdata not found", file=sys.stderr)
        return 1
    from vadc_tpu_torch.runtime import NoCudaDeviceError, resolve_device

    try:
        device = resolve_device(args.device)
    except NoCudaDeviceError as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1
    results = run_cases(TESTDATA, device)

    print(f"device: {device}")
    print(f"{'op':28s} {'max-abs-error':>14s}  bucket")
    for name, err in results:
        print(f"{name:28s} {err:14.3e}  {bucket(err)}")
    worst = max(err for _, err in results)
    print(f"\nworst: {worst:.3e} ({bucket(worst)}); all within the reference "
          "per-op tolerance" if worst <= 1e-4 else f"\nworst: {worst:.3e} EXCEEDS 1e-4")
    return 0


if __name__ == "__main__":
    sys.exit(main())
