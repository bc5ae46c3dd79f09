"""The port's lstm_decoder_fused against vadc_tpu.kernels.lstm's on the CPU.

The JAX kernel runs in Pallas interpret mode (block_streams chosen to divide
the batch); the port's wrapper runs its plain version, because the tensors
lie on the CPU. Same seeded numpy inputs through both, with the bundled
v3.1 weights and with random ones: probs, hn, cn within 1e-5 (both fp32; the
two differ in the order of the gate sums; measured: probs 2.4e-7, hn 2.9e-6,
cn 5.7e-6). The K-chunk
form equals K single calls, the state may be updated in place, and the
kernel's argument checks raise."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tests.conftest import assert_close
from tests.torch_port_util import jax_and_port_params
from tests.torch_port_util import single_torch_thread  # noqa: F401
from tests.torch_port_util import to_torch as _t
from vadc_tpu.kernels import lstm as JK
from vadc_tpu_torch.kernels import lstm_decoder as KD
from vadc_tpu_torch.kernels.lstm import transpose_weight

TOL = 1e-5


@pytest.fixture(scope="module")
def weights():
    """name -> (w [2, 256, 128], b [2, 256], dec_w [2, 64], dec_b [2]) as numpy."""
    jp, _ = jax_and_port_params()
    bundled = tuple(np.asarray(jp[k]) for k in ("lstm_w", "lstm_b", "dec_w", "dec_b"))
    rng = np.random.default_rng(11)
    random = (
        (0.15 * rng.normal(size=(2, 256, 128))).astype(np.float32),
        (0.1 * rng.normal(size=(2, 256))).astype(np.float32),
        (0.3 * rng.normal(size=(2, 64))).astype(np.float32),
        (0.1 * rng.normal(size=(2,))).astype(np.float32),
    )
    return {"bundled": bundled, "random": random}


def _inputs(batch: int, frames: int, seed: int, chunks: int | None = None):
    rng = np.random.default_rng(seed)
    shape = (batch, frames, 64) if chunks is None else (batch, chunks, frames, 64)
    x = (1.5 * rng.normal(size=shape)).astype(np.float32)
    h = (0.3 * rng.normal(size=(2, batch, 64))).astype(np.float32)
    c = (1.0 * rng.normal(size=(2, batch, 64))).astype(np.float32)
    return x, h, c


def _jax(x, h, c, w):
    batch = x.shape[0]
    block = 2 if batch % 2 == 0 else 1
    return JK.lstm_decoder_fused(*(jnp.asarray(a) for a in (x, h, c, *w)), block_streams=block)


@pytest.mark.parametrize("which", ["bundled", "random"])
@pytest.mark.parametrize("frames", [3, 7])
@pytest.mark.parametrize("batch", [1, 4, 5])
def test_matches_the_jax_kernel(weights, which, batch, frames):
    w = weights[which]
    x, h, c = _inputs(batch, frames, seed=batch * 10 + frames)
    want = _jax(x, h, c, w)
    got = KD.lstm_decoder_fused(_t(x), _t(h), _t(c), *(_t(a) for a in w))
    assert got[0].shape == (batch,) and got[1].shape == (2, batch, 64)
    for name, g, r in zip(("probs", "hn", "cn"), got, want):
        assert_close(g, r, TOL, f"{which} B={batch} T={frames} {name}")


@pytest.mark.parametrize("which", ["bundled", "random"])
@pytest.mark.parametrize("batch,chunks,frames", [(1, 6, 7), (5, 3, 3), (4, 4, 5)])
def test_k_chunk_form_equals_k_single_calls(weights, which, batch, chunks, frames):
    """x [B, K, T, 64]: probs [B, K], the state carried from chunk to chunk
    and the decoder's mean taken per chunk; each chunk against the JAX
    kernel fed the carried state."""
    w = tuple(_t(a) for a in weights[which])
    x, h, c = _inputs(batch, frames, seed=3, chunks=chunks)
    probs, hn, cn = KD.lstm_decoder_fused(_t(x), _t(h), _t(c), *w)
    assert probs.shape == (batch, chunks)
    hk, ck = _t(h), _t(c)
    hj, cj = h, c
    for k in range(chunks):
        pk, hk, ck = KD.lstm_decoder_fused(_t(x[:, k]), hk, ck, *w)
        assert torch.equal(pk, probs[:, k]), k
        pj, hj, cj = _jax(x[:, k], hj, cj, weights[which])
        assert_close(probs[:, k], pj, TOL, f"chunk {k} probs vs jax")
    assert torch.equal(hk, hn) and torch.equal(ck, cn)
    assert_close(hn, hj, TOL, "hn vs jax")
    assert_close(cn, cj, TOL, "cn vs jax")


@pytest.mark.parametrize("chunks", [None, 3])
def test_state_in_place(weights, chunks):
    w = tuple(_t(a) for a in weights["bundled"])
    x, h, c = _inputs(4, 7, seed=5, chunks=chunks)
    want = KD.lstm_decoder_fused(_t(x), _t(h), _t(c), *w)
    h2, c2 = _t(h), _t(c)
    probs, hn, cn = KD.lstm_decoder_fused(_t(x), h2, c2, *w, hn=h2, cn=c2)
    assert hn is h2 and cn is c2
    assert torch.equal(probs, want[0])
    assert torch.equal(h2, want[1]) and torch.equal(c2, want[2])


def test_reference_is_lstm_then_decoder(weights):
    """The plain version is nn.functional.lstm followed by decoder_v3_nlc."""
    from vadc_tpu_torch.nn import functional as F

    w, b, dw, db = (_t(a) for a in weights["bundled"])
    x, h, c = (_t(a) for a in _inputs(3, 7, seed=6))
    out, hn, cn = F.lstm(x, h, c, w, b)
    got = KD.lstm_decoder_fused_reference(x, h, c, w, b, dw, db)
    assert torch.equal(got[0], F.decoder_v3_nlc(out, dw, db))
    assert torch.equal(got[1], hn) and torch.equal(got[2], cn)


def test_cpu_call_launches_nothing(weights):
    from vadc_tpu_torch.kernels import _build

    KD.lstm_decoder_fused.launches = 0
    x, h, c = _inputs(2, 3, seed=7)
    KD.lstm_decoder_fused(_t(x), _t(h), _t(c), *(_t(a) for a in weights["bundled"]))
    assert KD.lstm_decoder_fused.launches == 0 and _build._lib is None


def _meta_args(batch=4, frames=7, chunks=None):
    shape = (batch, frames, 64) if chunks is None else (batch, chunks, frames, 64)
    m = lambda *s: torch.empty(*s, device="meta")  # noqa: E731
    return dict(x=m(*shape), h0=m(2, batch, 64), c0=m(2, batch, 64), wt=m(2, 128, 256),
                b=m(2, 256), dec_w=m(2, 64), dec_b=m(2), hn=m(2, batch, 64), cn=m(2, batch, 64))


_BAD = {
    "x of three axes but 32 channels": (dict(x=torch.empty(4, 7, 32, device="meta")), ValueError),
    "x of two axes": (dict(x=torch.empty(4, 64, device="meta")), ValueError),
    "x with no frames": (dict(x=torch.empty(4, 0, 64, device="meta")), ValueError),
    "h0 of another batch": (dict(h0=torch.empty(2, 3, 64, device="meta")), ValueError),
    "cn of another shape": (dict(cn=torch.empty(1, 4, 64, device="meta")), ValueError),
    "wt not transposed": (dict(wt=torch.empty(2, 256, 128, device="meta")), ValueError),
    "b of one layer": (dict(b=torch.empty(1, 256, device="meta")), ValueError),
    "dec_w of one logit": (dict(dec_w=torch.empty(1, 64, device="meta")), ValueError),
    "dec_b of three": (dict(dec_b=torch.empty(3, device="meta")), ValueError),
    "x in float64": (dict(x=torch.empty(4, 7, 64, device="meta", dtype=torch.float64)), TypeError),
    "c0 in float16": (dict(c0=torch.empty(2, 4, 64, device="meta", dtype=torch.float16)), TypeError),
    "b on another device": (dict(b=torch.empty(2, 256)), ValueError),
    "x not contiguous": (dict(x=torch.empty(7, 4, 64, device="meta").transpose(0, 1)), ValueError),
    "hn not contiguous": (dict(hn=torch.empty(2, 64, 4, device="meta").transpose(1, 2)), ValueError),
}


@pytest.mark.parametrize("case", sorted(_BAD))
def test_argument_checks_raise(case):
    """The checks every CUDA call passes before the launch, on 'meta'
    tensors (shapes, types and strides without storage)."""
    change, error = _BAD[case]
    with pytest.raises(error, match="lstm_decoder_fused"):
        KD._check(**{**_meta_args(), **change})


def test_only_a_cpu_tensor_takes_the_plain_version():
    """A tensor on any device but the CPU goes to the kernel's checks; a
    device without a kernel ('meta' here) raises, well-formed or not."""
    with pytest.raises(ValueError, match="unsupported device"):
        KD._check(**_meta_args())
    with pytest.raises(ValueError, match="unsupported device"):
        KD._check(**_meta_args(chunks=5))
    a = _meta_args()
    with pytest.raises(ValueError, match="unsupported device"):
        KD.lstm_decoder_fused(a["x"], a["h0"], a["c0"], torch.empty(2, 256, 128, device="meta"),
                              a["b"], a["dec_w"], a["dec_b"])


def test_transposed_weight_is_the_kernels_layout(weights):
    w = _t(weights["bundled"][0])
    wt = transpose_weight(w)
    assert wt.shape == (2, 128, 256) and wt.is_contiguous()
    assert torch.equal(wt[1, 5], w[1, :, 5])
