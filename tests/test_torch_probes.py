"""The two probes of tools/tpu_check.py (`k_bf16_3d`, `k_concat`) and their
counterparts in the port, vadc_tpu_torch/kernels/probes.py, on the CPU.

tpu_check's `_probe_toolchain_blockers` runs unedited, its `pl.pallas_call`
patched to run in interpret mode and to record each call's inputs and
output; the port's plain versions, which the wrappers take on a CPU tensor,
are held to what the Pallas kernels returned on the same inputs: bf16_dot
exactly (products of bf16 values are exact in fp32, and 48 of them sum
exactly here), concat_dot within 1e-5 (fp32 sums in other orders). The CUDA
kernels run only on the card (tests/test_torch_cuda.py, tools/gpu_check.py,
chip_smoke.py)."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from tests.torch_port_util import single_torch_thread  # noqa: F401
from tools import gpu_check, tpu_check
from vadc_tpu_torch.kernels import _build
from vadc_tpu_torch.kernels.probes import (
    MAX_K, bf16_dot, bf16_dot_reference, bf16_dot_wgmma, concat_dot, concat_dot_reference,
)
from vadc_tpu_torch.nn.precision import matmul_at

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def probe_calls():
    """tpu_check._probe_toolchain_blockers with every pallas_call in
    interpret mode: (the probes it reports lifted, [(kernel name, inputs,
    output)])."""
    calls = []
    real = pl.pallas_call

    def recording(kernel, *args, **kwargs):
        run = real(kernel, *args, **{**kwargs, "interpret": True})

        def call(*inputs):
            out = run(*inputs)
            calls.append((kernel.__name__, [np.asarray(a) for a in inputs], np.asarray(out)))
            return out

        return call

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pl, "pallas_call", recording)
        lifted = tpu_check._probe_toolchain_blockers(np, jax, jnp)
    return lifted, calls


def _torch(a: np.ndarray, dtype=torch.float32) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.float32).copy()).to(dtype)


def test_both_probes_run_in_interpret_mode(probe_calls):
    lifted, calls = probe_calls
    assert [c[0] for c in calls] == ["k_bf16_3d", "k_concat"]
    assert calls[0][2].shape == (2, 8, 16) and calls[0][2].dtype == np.float32
    assert calls[1][2].shape == (8, 32) and calls[1][2].dtype == np.float32
    assert lifted == ["bf16_3d_dot_nonmultiple_contraction", "lane_concat_of_3d_slab_slice"]


@pytest.mark.parametrize("entry", [bf16_dot, bf16_dot_wgmma])
def test_bf16_dot_gives_the_pallas_probes_output(probe_calls, entry):
    _, calls = probe_calls
    (x, w), want = calls[0][1], calls[0][2]
    assert x.dtype == w.dtype == jnp.bfloat16
    got = entry(_torch(x, torch.bfloat16), _torch(w, torch.bfloat16))
    assert got.dtype == torch.float32 and got.shape == (2, 8, 16)
    assert np.array_equal(got.numpy(), want) and (want == 6.0).all()


def test_concat_dot_gives_the_pallas_probes_output(probe_calls):
    _, calls = probe_calls
    (x, h, w), want = calls[1][1], calls[1][2]
    # the probe's kernel reads x[:, 1, :]
    got = concat_dot(_torch(x), 1, _torch(h), _torch(w))
    assert got.shape == (8, 32)
    assert float(np.abs(got.numpy() - want).max()) <= 1e-5


def test_a_single_bf16_pass_breaks_the_probes_limit_and_bf16_3x_meets_it(probe_calls):
    """The control of tools/gpu_check.py: the probe's 1e-3 against fp32 is
    out of reach of one bf16 product, and within reach of bf16_3x, the
    product concat_dot's kernel computes."""
    _, calls = probe_calls
    (x, h, w), want = calls[1][1], calls[1][2]
    cat = torch.cat([_torch(x)[:, 1], _torch(h)], -1)
    single = float((matmul_at(cat, _torch(w), "bf16") - _torch(want)).abs().max())
    split = float((matmul_at(cat, _torch(w), "bf16_3x") - _torch(want)).abs().max())
    assert single > 1e-3 > split
    assert split > 0.0  # bf16_3x is not fp32


@pytest.mark.parametrize("k", [40, 48, 128])
def test_bf16_dot_folds_leading_dims_and_a_k_cut_breaks_it(k):
    x, w = gpu_check.seeded_bf16(16, k, gpu_check.PROBE_N[k], k, "cpu")
    assert x.shape == (2, 8, k)
    got = bf16_dot(x, w)
    assert got.shape == (2, 8, gpu_check.PROBE_N[k])
    assert torch.equal(got, bf16_dot_reference(x.reshape(16, k), w).reshape(got.shape))
    cut = k // 16 * 16
    if cut < k:  # K = 40: the tail's 8 products matter
        short = bf16_dot(x[..., :cut].contiguous(), w[:cut].contiguous())
        assert float((short - got).abs().max()) > 1e-5


def test_concat_dot_is_the_concatenated_product():
    x, t, h, w = gpu_check.seeded_concat(37, 128, 256, 0, "cpu")
    got = concat_dot(x, t, h, w)
    assert got.shape == (37, 256)
    assert torch.equal(got, concat_dot_reference(x, t, h, w))
    assert float((got - torch.cat([x[:, t], h], -1) @ w).abs().max()) == 0.0


def test_the_kernels_are_built_and_bound():
    """probes.cu is one of the library's sources, with its three C entries
    bound; it computes with the instructions the kernels are named for (the
    mma.sync fragments from the header the spectrum and the body share), and
    calls no library kernel."""
    csrc = ROOT / "vadc_tpu_torch/kernels/csrc"
    assert csrc / "probes.cu" in _build.sources() and csrc / "mma.cuh" in _build.headers()
    probes = (csrc / "probes.cu").read_text()
    assert '#include "mma.cuh"' in probes
    src = probes + (csrc / "mma.cuh").read_text()
    for entry in ("vadc_bf16_dot", "vadc_bf16_dot_wgmma", "vadc_concat_dot"):
        assert entry in _build._SIGNATURES
        assert re.search(rf'extern "C" int {entry}\(', probes)
    assert "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32" in src
    assert "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16" in src
    assert "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16" in src
    assert "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16" in src
    assert "wgmma.commit_group" in src and "wgmma.wait_group" in src
    assert not re.search(r"cublas|cutlass|#include <mma\.h>", src, re.I)
    assert MAX_K == 256 and "K > 256" in src


def test_gpu_checks_probes_on_the_cpu():
    """gpu_check's probe checks with the plain versions: every limit holds
    and both controls break."""
    check = gpu_check.Checks()
    info = gpu_check.probe_checks(torch.device("cpu"), check)
    assert check.failures == []
    assert check.results["control_bf16_dot_k_cut_to_32"] > 1e-5
    assert check.results["control_single_bf16_pass_vs_fp32"] > 1e-3
    assert info["bf16_dot_vs_bf16_dot_wgmma"] == 0.0
