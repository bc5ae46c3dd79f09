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
    H_TMA, MAX_K, OUT_TMA, W_TMA, X_TMA, bf16_dot, bf16_dot_reference, bf16_dot_staging,
    bf16_dot_wgmma, concat_dot, concat_dot_reference, concat_dot_staging,
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
    bound, on the port's GEMM core (wgmma.cuh): operands copied by TMA into
    128-byte-swizzled shared memory behind an mbarrier (the tensor maps
    encoded through the driver's entry point, no -lcuda), the output stored
    by TMA; products by the instructions the kernels are named for: mma.sync
    with ldmatrix fragments, wgmma m64n64k16 on swizzled descriptors with w
    read MN-major (transpose-B), and from registers for concat_dot's A; no
    library kernel."""
    csrc = ROOT / "vadc_tpu_torch/kernels/csrc"
    assert csrc / "probes.cu" in _build.sources()
    assert {csrc / "mma.cuh", csrc / "wgmma.cuh"} <= set(_build.headers())
    probes = (csrc / "probes.cu").read_text()
    assert '#include "mma.cuh"' in probes and '#include "wgmma.cuh"' in probes
    src = probes + (csrc / "mma.cuh").read_text() + (csrc / "wgmma.cuh").read_text()
    for entry in ("vadc_bf16_dot", "vadc_bf16_dot_wgmma", "vadc_concat_dot"):
        assert entry in _build._SIGNATURES
        assert re.search(rf'extern "C" int {entry}\(', probes)
    # TMA in and out, one mbarrier phase, the 128-byte swizzle
    assert "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes" in src
    assert "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group" in src
    assert "mbarrier.arrive.expect_tx.shared::cta.b64" in src
    assert "mbarrier.try_wait.parity.shared::cta.b64" in src
    assert "CU_TENSOR_MAP_SWIZZLE_128B" in src and "__grid_constant__ CUtensorMap" in src
    assert "cudaGetDriverEntryPoint" in src and "-lcuda" not in _build.LINK_FLAGS
    assert "fence.proxy.async.shared::cta" in src
    # a descriptor of layout 1 (128-byte swizzle, bits 62-63)
    assert "static_cast<uint64_t>(1) << 62" in src
    # mma.sync and its ldmatrix fragments
    assert "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32" in src
    assert "ldmatrix.sync.aligned.m8n8.x4.shared.b16" in src
    assert "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16" in src
    # wgmma: A and B by descriptors (transpose-A 0, transpose-B 1), and A
    # from registers (transpose-B 1)
    assert src.count("wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16") == 2
    assert ", %32, %33, p, 1, 1, 0, 1;" in src
    assert ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;" in src
    assert "wgmma.fence" in src and "wgmma.commit_group" in src and "wgmma.wait_group" in src
    assert not re.search(r"cublas|cutlass|#include <mma\.h>", src, re.I)
    assert MAX_K == 256 and "constexpr int MAX_K = 256;" in probes and "K > MAX_K" in probes


@pytest.mark.parametrize("k,n,want", [
    (48, 16, X_TMA | W_TMA | OUT_TMA),   # the probe's
    (128, 256, X_TMA | W_TMA | OUT_TMA),  # the v4 gate product's
    (37, 24, W_TMA | OUT_TMA),           # x's rows 74 bytes
    (48, 13, X_TMA),                     # w's rows 26 bytes, the output's 52
    (40, 12, X_TMA | OUT_TMA),           # w's rows 24 bytes, the output's 48
    (1, 1, 0),
])
def test_bf16_staging_follows_the_row_strides(k, n, want):
    """An operand goes by TMA where its row stride is a multiple of 16
    bytes (and its base is: torch's CPU allocations are)."""
    x = torch.zeros(5, k, dtype=torch.bfloat16)
    w = torch.zeros(k, n, dtype=torch.bfloat16)
    out = torch.zeros(5, n)
    assert bf16_dot_staging(x, w, out) == want


def test_staging_needs_16_byte_bases():
    """A view that starts off 16 bytes is copied by the threads, whatever
    its stride."""
    flat = torch.zeros(8 + 64 * 48, dtype=torch.bfloat16)
    x = flat[1:1 + 64 * 48].view(64, 48)
    w = torch.zeros(48, 16, dtype=torch.bfloat16)
    assert x.is_contiguous() and x.data_ptr() % 16 == 2
    assert bf16_dot_staging(x, w, torch.zeros(64, 16)) == W_TMA | OUT_TMA
    assert bf16_dot_staging(flat[8:8 + 64 * 48].view(64, 48), w, torch.zeros(64, 16)) == 7
    xc = torch.zeros(4 * 3 * 64 + 1)[1:].view(4, 3, 64)
    hc, wc, out = torch.zeros(4, 64), torch.zeros(128, 32), torch.zeros(4, 32)
    assert concat_dot_staging(xc, 1, hc, wc, out) == H_TMA | W_TMA | OUT_TMA


@pytest.mark.parametrize("seq,d,t,dh,n,want", [
    (3, 64, 1, 64, 256, X_TMA | H_TMA | W_TMA | OUT_TMA),  # the gate shape
    (3, 20, 1, 20, 24, X_TMA | H_TMA | W_TMA | OUT_TMA),   # x[:, 1] 80 bytes in, stride 240
    (3, 19, 1, 18, 24, W_TMA | OUT_TMA),                   # stride 228; h's rows 72 bytes
    (4, 37, 0, 36, 13, X_TMA | H_TMA),                     # t = 0, stride 592: D need not be
    (3, 22, 2, 0, 16, W_TMA | OUT_TMA),                    # stride 264; no h
    (3, 24, 2, 8, 8, X_TMA | H_TMA | W_TMA | OUT_TMA),
])
def test_concat_staging_follows_the_view_of_x(seq, d, t, dh, n, want):
    """x[:, t] is a 2-D view of row stride T D and base t D (fp32): both
    must be multiples of 16 bytes for TMA; h by Dh, w and the output by N."""
    x, h = torch.zeros(6, seq, d), torch.zeros(6, dh)
    w, out = torch.zeros(d + dh, n), torch.zeros(6, n)
    assert concat_dot_staging(x, t, h, w, out) == want


def test_gpu_checks_probes_on_the_cpu():
    """gpu_check's probe checks with the plain versions: every limit holds
    and both controls break."""
    check = gpu_check.Checks()
    info = gpu_check.probe_checks(torch.device("cpu"), check)
    assert check.failures == []
    assert check.results["control_bf16_dot_k_cut_to_32"] > 1e-5
    assert check.results["control_single_bf16_pass_vs_fp32"] > 1e-3
    assert info["bf16_dot_vs_bf16_dot_wgmma"] == 0.0
