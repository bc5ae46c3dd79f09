"""The v5 convs' kernel module (vadc_tpu_torch/kernels/v5_convs.py) on the
CPU: its routing, its checks and its packed weights. The kernel itself
runs only on the card (tests/test_torch_cuda.py, chip_smoke.py).

  * On a CPU tensor the wrapper is the plain chain, models/silero_v5.py:
    _convs, bit for bit, at the 16 kHz and the 8 kHz widths and at every
    tier; it launches and builds nothing.
  * It refuses what neither version takes: another dtype, rank or C_in, a
    view that is not contiguous, weights of other widths.
  * The packed weights, walked in the kernel's order (each conv's used taps
    in order, a tap's slices of SLICE_FLOATS / C_out input channels, the
    biases after the slices) by the kernel's arithmetic in torch ops
    (`kernel_order` below: the taps that read only the pad skipped, each
    tap's sum added to the frame's running sum at the tier's storage, the
    bias, the ReLU, the next operands rounded where the kernel stages
    them), give the plain chain within fp32 rounding (the products' sums
    are the same; where a tap is skipped the plain chain adds an exact
    zero). Measured on an x86 CPU (37 and 300 rows of seeded speech, both
    widths): at most 4.0e-7 of the largest feature at faithful, 0 at the
    bf16 tiers. Bound 1e-6 of the largest feature; at fast and turbo, where
    a sum's last bit can flip a bf16 rounding (2^-8 of an operand) and the
    flip runs on through the later convs, 2^-7, with the share of features
    off by more than 1e-6 held under 1 %.
  * The module imports, and its CPU path runs, where there is no nvcc.
"""

import os
import subprocess
import sys

import pytest
import torch

from tests.torch_port_util import ROOT, single_torch_thread, speech  # noqa: F401
from tests.torch_port_util import to_torch as _t
from vadc_tpu_torch.kernels import v5_convs as KV
from vadc_tpu_torch.models import silero_v5 as T5
from vadc_tpu_torch.models.synthetic import random_v5_8k_archive, random_v5_archive
from vadc_tpu_torch.models.weights import load_params_from_tensors
from vadc_tpu_torch.nn.precision import TIERS, bf16, split, store

FAMILIES = {"v5": (T5, lambda: random_v5_archive(0), 512),
            "v5_8k": (T5.v5_8k, lambda: random_v5_8k_archive(1), 256)}
ROWS = 37  # a ragged tile of the kernel's 32 chunks


@pytest.fixture(scope="module")
def families():
    """family -> (params, spectrum [ROWS, 4, C_in] of seeded speech)."""
    out = {}
    for family, (module, archive, window) in FAMILIES.items():
        params = load_params_from_tensors(archive())[1]
        audio = _t(speech(ROWS, chunk=module.CONTEXT_SAMPLES + window, seed=5))
        spect = T5.spectrum(params, audio, pad_right=module.STFT_PAD_RIGHT, hop=module.STFT_HOP,
                            tier=TIERS["faithful"])
        out[family] = (params, spect)
    return out


@pytest.mark.parametrize("tier", list(TIERS))
@pytest.mark.parametrize("family", list(FAMILIES))
def test_the_cpu_path_is_the_plain_chain_bit_for_bit(families, family, tier):
    params, spect = families[family]
    before = KV.v5_convs.launches
    got = KV.v5_convs(params, spect, tier)
    assert got.shape == (ROWS, 1, 128)
    assert torch.equal(got, T5._convs(params, spect, TIERS[tier]))
    assert KV.v5_convs.launches == before


def test_the_cpu_path_is_what_encode_runs(families):
    params, _ = families["v5"]
    audio = _t(speech(3, chunk=576, seed=6))
    assert torch.equal(T5.encode(params, audio), T5.encode_reference(params, audio))


def _refusal(spect):
    """case -> (exception, message, input): what the wrapper refuses."""
    return {
        "dtype": (TypeError, "float32", spect.double()),
        "rank": (ValueError, r"\[rows, frames, 129\]", spect.reshape(ROWS, -1)),
        "c_in": (ValueError, r"\[rows, frames, 129\]", spect[:, :, :128].contiguous()),
        "no rows": (ValueError, r"\[rows, frames, 129\]", spect[:0]),
        "not contiguous": (ValueError, "contiguous", spect.transpose(0, 1).contiguous()
                           .transpose(0, 1)),
    }


@pytest.mark.parametrize("case", ["dtype", "rank", "c_in", "no rows", "not contiguous"])
def test_the_wrapper_refuses_what_it_does_not_take(families, case):
    params, spect = families["v5"]
    error, match, bad = _refusal(spect)[case]
    with pytest.raises(error, match=match):
        KV.v5_convs(params, bad)


def test_the_wrapper_refuses_weights_of_other_widths(families):
    params, spect = families["v5"]
    narrow = {"encoder": [dict(p) for p in params["encoder"]]}
    narrow["encoder"][1]["w"] = narrow["encoder"][1]["w"][:32]
    with pytest.raises(ValueError, match="conv weights"):
        KV.v5_convs(narrow, spect)


def test_the_kernel_path_refuses_a_device_it_has_no_kernel_for_and_other_frames(families):
    params, spect = families["v5"]
    with pytest.raises(ValueError, match="unsupported device"):
        KV.v5_convs(params, spect.to("meta"))
    assert KV.v5_convs(params, spect[:, :3].contiguous()).shape == (ROWS, 1, 128)


def _unpack(words: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) of bf16_3x words (nn.precision.pack_operand)."""
    bits = words.view(torch.int32)
    return (bits & -65536).view(torch.float32), (bits << 16).view(torch.float32)


def _products(x: torch.Tensor, w: torch.Tensor, mode: str) -> torch.Tensor:
    """x [rows, C] @ w [C, O] packed for `mode`, as the kernel's operands
    take them (x of the bf16 mode comes rounded)."""
    if mode != "bf16_3x":
        return x @ w
    w_hi, w_lo = _unpack(w)
    x_hi, x_lo = split(x)
    return x_hi @ w_hi + x_hi @ w_lo + x_lo @ w_hi


def kernel_order(packed: torch.Tensor, spect: torch.Tensor, tier) -> torch.Tensor:
    """The kernel's walk of `packed` (csrc/v5_convs.cu) in torch ops."""
    mode, off = tier.products, 0
    n_slices = (packed.numel() - sum(KV.WIDTHS)) // KV.SLICE_FLOATS
    bias_at = n_slices * KV.SLICE_FLOATS
    x = bf16(spect) if mode == "bf16" else spect
    frames = KV.FRAMES
    for layer, (c_out, stride) in enumerate(zip(KV.WIDTHS, KV.STRIDES)):
        c_in = x.shape[2]
        per_slice = KV.SLICE_FLOATS // c_out
        span = -(-c_in // per_slice) * per_slice * c_out
        out_frames = (frames - 1) // stride + 1
        y = torch.zeros(x.shape[0], out_frames, c_out)
        for t in KV.used_taps(frames, stride):
            w = packed[off : off + span].reshape(-1, c_out)[:c_in]
            off += span
            for f in range(out_frames):
                i = f * stride + t - 1
                if 0 <= i < frames:
                    y[:, f] = store(y[:, f] + store(_products(x[:, i], w, mode), tier), tier)
        y = torch.relu(store(y + packed[bias_at : bias_at + c_out], tier))
        bias_at += c_out
        last = layer == len(KV.WIDTHS) - 1
        x, frames = (bf16(y) if mode == "bf16" and not last else y), out_frames
    assert off == n_slices * KV.SLICE_FLOATS and bias_at == packed.numel()
    return x


@pytest.mark.parametrize("tier", list(TIERS))
@pytest.mark.parametrize("family", list(FAMILIES))
def test_the_packed_weights_in_the_kernels_order_give_the_plain_chain(families, family, tier):
    params, spect = families[family]
    t = TIERS[tier]
    assert KV.STRIDES == T5.ENCODER_STRIDES
    packed = KV.packed_weights_of(params, t)
    assert packed is KV.packed_weights_of(params, t)  # once per Params and tier
    c_in = spect.shape[2]
    slices = 3 * -(-c_in // 16) + 3 * 4 + 2 * 2 + 1 * 4  # taps x slices a tap, by conv
    assert packed.shape == (slices * KV.SLICE_FLOATS + sum(KV.WIDTHS),)
    got = kernel_order(packed, spect, t)
    want = T5._convs(params, spect, t)
    scale = float(want.abs().max())
    err = (got - want).abs() / scale
    assert float(err.max()) <= (1e-6 if t.products != "bf16" else 2 ** -7), float(err.max())
    assert float((err > 1e-6).double().mean()) <= 0.01


def test_the_module_imports_and_runs_its_plain_version_without_nvcc(tmp_path):
    """In a process that finds no nvcc, the module imports and its CPU path
    neither builds nor loads the kernel library."""
    code = (
        "import torch\n"
        "from vadc_tpu_torch.kernels import _build, v5_convs as KV\n"
        "from vadc_tpu_torch.models.synthetic import random_v5_archive\n"
        "from vadc_tpu_torch.models.weights import load_params_from_tensors\n"
        "p = load_params_from_tensors(random_v5_archive(0))[1]\n"
        "y = KV.v5_convs(p, torch.rand(3, 4, 129))\n"
        "assert y.shape == (3, 1, 128) and KV.v5_convs.launches == 0\n"
        "assert _build._lib is None and not _build.build_info\n"
        "try:\n"
        "    _build._nvcc()\n"
        "except RuntimeError:\n"
        "    print('no nvcc')\n"
    )
    env = {**os.environ, "PATH": str(tmp_path), "CUDA_HOME": str(tmp_path / "none"),
           "CUDA_PATH": str(tmp_path / "none"), "PYTHONPATH": str(ROOT)}
    done = subprocess.run([sys.executable, "-c", code], env=env, cwd=tmp_path,
                          capture_output=True, text=True, timeout=300)
    assert done.returncode == 0, done.stderr
    assert done.stdout.strip() == "no nvcc"
