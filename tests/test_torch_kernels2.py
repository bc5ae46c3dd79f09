"""The v4/v5 ops and kernel modules on the CPU: the plain ops of
nn/functional that only v4 and v5 use against vadc_tpu's, and the plain versions of the
`stft_magnitude` and `lstm_fused` kernels against the Pallas kernels they
stand in for, run in interpret mode, plus the wrappers' CPU routing.

Bounds: the ops 1e-6 (conv1d_nlc and batch_norm1d_nlc relative to their
largest output); `lstm_fused` 1e-5 on y, hn and cn; `stft_magnitude` 1e-5
relative to the largest magnitude. Measured on the CPU: conv1d_nlc 3.6e-7,
batch_norm1d_nlc 1.2e-7, decoder_v5_nlc 6.0e-8; lstm_fused 9.5e-7 (v4
weights, L=2, H=64) and 1.5e-6 (synthetic v5, L=1, H=128), both on c;
stft_magnitude up to 6.0e-7 relative (v4 geometries).

The CUDA kernels themselves run only on the card (tests/test_torch_cuda.py
and chip_smoke.py).
"""

import functools
from unittest import mock

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tests.conftest import assert_close
from tests.torch_port_util import DATA, single_torch_thread, speech  # noqa: F401
from tests.torch_port_util import to_torch as _t
from vadc_tpu.io.testtensor import load_testtensor
from vadc_tpu.nn import functional as JF
from vadc_tpu_torch.kernels import _build
from vadc_tpu_torch.kernels import lstm as KL
from vadc_tpu_torch.kernels import stft_mag as KS
from vadc_tpu_torch.kernels.stft_dotmag import split_basis
from vadc_tpu_torch.models import silero_v4 as T4
from vadc_tpu_torch.models import silero_v5 as T5
from vadc_tpu_torch.models.synthetic import random_v5_8k_archive, random_v5_archive
from vadc_tpu_torch.models.weights import load_params_from_tensors
from vadc_tpu_torch.nn import functional as TF

TOL_OP = 1e-6
TOL_KERNEL = 1e-5


@pytest.fixture(scope="module")
def archives():
    """The tensor archives of the four new families: the two bundled v4
    archives (official weights) and the two synthetic v5 ones."""
    return {
        "v4": load_testtensor(DATA / "silero_v4_16k.testtensor"),
        "v4_8k": load_testtensor(DATA / "silero_v4_8k.testtensor"),
        "v5": random_v5_archive(0),
        "v5_8k": random_v5_8k_archive(1),
    }


def _basis(archive) -> np.ndarray:
    b = np.asarray(archive["forward_basis_buffer"], np.float32)
    return b.reshape(b.shape[0], -1)


# --- nn/functional ---------------------------------------------------------


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("length", [4, 7])
def test_conv1d_nlc(archives, stride, length):
    rng = np.random.default_rng(stride * 10 + length)
    w = np.asarray(archives["v5"]["enc2.weight"])  # [64, 128, 3]
    b = np.asarray(archives["v5"]["enc2.bias"])
    x = rng.normal(size=(3, length, 128)).astype(np.float32)
    got = TF.conv1d_nlc(_t(x), _t(w), _t(b), stride=stride, padding=1)
    want = np.asarray(JF.conv1d_nlc(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), stride=stride,
                                    padding=1))
    assert got.shape == want.shape == (3, (length + 2 - 3) // stride + 1, 64)
    # sums of 384 products of unit-scale values: relative to the largest
    peak = float(np.abs(want).max())
    assert_close(got / peak, want / peak, TOL_OP, f"conv1d stride {stride}")
    # no bias, no padding
    want = np.asarray(JF.conv1d_nlc(jnp.asarray(x), jnp.asarray(w), None, stride=stride))
    peak = float(np.abs(want).max())
    assert_close(TF.conv1d_nlc(_t(x), _t(w), None, stride=stride) / peak, want / peak, TOL_OP,
                 "conv1d unpadded")


def test_batch_norm1d_nlc():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(4, 6, 32)).astype(np.float32)
    mean, w, b = (rng.normal(size=32).astype(np.float32) for _ in range(3))
    var = rng.uniform(0.1, 2.0, size=32).astype(np.float32)
    got = TF.batch_norm1d_nlc(_t(x), _t(mean), _t(var), _t(w), _t(b))
    want = np.asarray(JF.batch_norm1d_nlc(*(jnp.asarray(a) for a in (x, mean, var, w, b))))
    # outputs up to ~10: relative to the largest, as XLA may contract the
    # affine into FMAs
    peak = float(np.abs(want).max())
    assert_close(got / peak, want / peak, TOL_OP, "batch norm")


@pytest.mark.parametrize("hidden", [64, 128])
def test_decoder_v5_nlc(hidden):
    rng = np.random.default_rng(hidden)
    out = rng.normal(size=(5, 3, hidden)).astype(np.float32)
    w = (0.3 * rng.normal(size=(1, hidden))).astype(np.float32)
    b = rng.normal(size=1).astype(np.float32)
    got = TF.decoder_v5_nlc(_t(out), _t(w), _t(b))
    want = JF.decoder_v5_nlc(jnp.asarray(out), jnp.asarray(w), jnp.asarray(b))
    assert got.shape == (5,)
    assert_close(got, want, TOL_OP, "decoder v5")
    # the sigmoid comes before the frame mean: the other order differs
    swapped = torch.sigmoid(torch.mean(TF.linear(torch.relu(_t(out)), _t(w), _t(b))[:, :, 0], 1))
    assert float((swapped - got).abs().max()) > 1e-3


# --- stft_magnitude --------------------------------------------------------

# (family, chunk samples as the model sees them, pad_left, pad_right, hop)
STFT_GEOMETRIES = [
    ("v4", 512, 96, 96, 64),
    ("v4", 1536, 96, 96, 64),
    ("v4_8k", 256, 96, 96, 64),
    ("v4_8k", 768, 96, 96, 64),
    ("v5", 576, 0, 64, 128),
    ("v5_8k", 288, 0, 32, 64),
]


@pytest.mark.parametrize("family,samples,pad_left,pad_right,hop", STFT_GEOMETRIES,
                         ids=[f"{g[0]}-{g[1]}" for g in STFT_GEOMETRIES])
def test_stft_magnitude_reference_matches_pallas_interpret(archives, family, samples, pad_left,
                                                           pad_right, hop):
    import vadc_tpu.kernels.stft_mag as JS

    basis = _basis(archives[family])
    batch = 4
    audio = speech(batch, chunk=samples, seed=samples)
    packed = JS.prepack_basis(jnp.asarray(basis), hop)
    # patched here, not in vadc_tpu: the Pallas call runs in interpret mode
    with mock.patch.object(JS.pl, "pallas_call",
                           functools.partial(JS.pl.pallas_call, interpret=True)):
        want = np.asarray(JS.stft_magnitude_pallas(
            jnp.asarray(audio), packed, pad_left=pad_left, pad_right=pad_right, hop=hop,
            cutoff=basis.shape[0] // 2, block_streams=batch,
        ))
    wr, wi = split_basis(_t(basis))
    kw = dict(pad_left=pad_left, pad_right=pad_right, hop=hop)
    got = KS.stft_magnitude_reference(_t(audio), wr, wi, **kw)
    n_fft = basis.shape[1]
    assert got.shape == want.shape == (batch, (samples + pad_left + pad_right - n_fft) // hop + 1,
                                       n_fft // 2 + 1)
    peak = float(np.abs(want).max())
    assert_close(got / peak, want / peak, TOL_KERNEL, f"{family} stft magnitude")
    # the plain version IS nn.functional.stft_magnitude_nlc, and the
    # wrapper takes it for a CPU tensor
    assert torch.equal(got, TF.stft_magnitude_nlc(_t(audio), _t(basis), **kw))
    assert torch.equal(KS.stft_magnitude(_t(audio), wr, wi, **kw), got)


# --- lstm_fused ------------------------------------------------------------


@pytest.mark.parametrize("family,seq", [("v4", 3), ("v4", 9), ("v5", 1), ("v5", 6)])
def test_lstm_fused_reference_matches_pallas_interpret(archives, family, seq):
    """From a random carried state, at the v4 shape (L=2, H=64, official
    weights) and the v5 shape (L=1, H=128, synthetic weights)."""
    from vadc_tpu.kernels.lstm import lstm_fused as jax_lstm_fused

    w = np.asarray(archives[family]["weights"], np.float32)
    b = np.asarray(archives[family]["biases"], np.float32)
    layers, hidden = w.shape[0], w.shape[2] // 2
    batch = 4
    rng = np.random.default_rng(seq)
    x = rng.normal(size=(batch, seq, hidden)).astype(np.float32)
    h0 = (0.5 * rng.normal(size=(layers, batch, hidden))).astype(np.float32)
    c0 = (2.0 * rng.normal(size=(layers, batch, hidden))).astype(np.float32)
    want = jax_lstm_fused(*(jnp.asarray(a) for a in (x, h0, c0, w, b)), block_streams=batch)
    got = KL.lstm_fused_reference(_t(x), _t(h0), _t(c0), _t(w), _t(b))
    for name, g, wv in zip(("y", "hn", "cn"), got, want):
        assert g.shape == wv.shape
        assert_close(g, wv, TOL_KERNEL, f"{family} T={seq} lstm {name}")
    # the wrapper takes the plain version for a CPU tensor ...
    y, hn, cn = KL.lstm_fused(_t(x), _t(h0), _t(c0), _t(w), _t(b))
    assert torch.equal(y, got[0]) and torch.equal(hn, got[1]) and torch.equal(cn, got[2])
    # ... and writes the state in place when asked to
    h, c = _t(h0), _t(c0)
    _, hn, cn = KL.lstm_fused(_t(x), h, c, _t(w), _t(b), hn=h, cn=c)
    assert hn is h and cn is c
    assert torch.equal(h, got[1]) and torch.equal(c, got[2])


def test_lstm_weight_is_transposed_once_per_params(archives):
    _, params = load_params_from_tensors(archives["v5"])
    wt = KL.transposed_weight_of(params)
    assert wt is KL.transposed_weight_of(params)
    assert wt.shape == (1, 256, 512) and wt.is_contiguous()
    assert torch.equal(wt, params["lstm_w"].transpose(1, 2))


# --- the wrappers' routing -------------------------------------------------


def test_wrappers_refuse_a_device_they_have_no_kernel_for(archives):
    """Only a CPU tensor takes the plain version: any other device goes to
    the kernel's checks (here 'meta', which has no kernel) and raises."""
    wr, wi = (t.to("meta") for t in split_basis(_t(_basis(archives["v4"]))))
    with pytest.raises(ValueError, match="unsupported device"):
        KS.stft_magnitude(torch.empty(2, 512, device="meta"), wr, wi,
                          pad_left=96, pad_right=96, hop=64)
    h = torch.empty(1, 2, 128, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        KL.lstm_fused(torch.empty(2, 1, 128, device="meta"), h, h.clone(),
                      torch.empty(1, 512, 256, device="meta"), torch.empty(1, 512, device="meta"))


def test_cpu_runs_build_and_launch_nothing(archives):
    """The v4 and v5 forwards on the CPU never invoke nvcc nor load the
    library, and count no launch."""
    KS.stft_magnitude.launches = 0
    KL.lstm_fused.launches = 0
    for family, module, samples in (("v4", T4, 1536), ("v4_8k", T4.v4_8k, 768),
                                    ("v5", T5, 576), ("v5_8k", T5.v5_8k, 288)):
        _, params = load_params_from_tensors(archives[family])
        h, c = module.init_state(2)
        audio = _t(speech(2, chunk=samples, seed=1))
        module.forward(params, audio, h, c)
        module.forward_minibatched(params, audio, h[:, :1], c[:, :1])
    assert _build._lib is None and not _build.build_info
    assert KS.stft_magnitude.launches == 0 and KL.lstm_fused.launches == 0
