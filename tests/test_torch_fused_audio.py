"""The port's forward_fused (the whole Silero v3.1 step from raw audio; one
CUDA kernel on the card, its plain version here) against the JAX package's
forward_fused, which runs in Pallas interpret mode on the CPU, with the
bundled v3.1 weights and a random carried state.

Bounds: probabilities 1e-4; h 3e-4 and c 3e-4 of its largest value. These
are the whole-model bounds of tests/test_torch_model.py, for its reason:
adaptive normalization takes log1p(2^20 x) of every STFT bin, and the two
packages' fp32 STFTs round differently at near-zero bins (the JAX kernel's
hop-block STFT also sums in another order than JAX's plain one). Measured
here against JAX forward_fused: probabilities <= 4.7e-6, h <= 2.1e-5, c <=
9.1e-6 of its largest value; on the BN-folded archive against JAX forward:
4.8e-8, 9.7e-6, 3.4e-6. Given the same spectrum, the port's plain
forward_fused and its plain forward differ only in the collapsed smoothing
of the normalization: held at 1e-5, measured probabilities 1.5e-8, h 5.0e-6,
c 2.0e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.conftest import assert_close
from tests.test_torch_kernels import _fold_bn
from tests.torch_port_util import jax_and_port_params, noise, speech  # noqa: F401
from tests.torch_port_util import single_torch_thread  # noqa: F401
from tests.torch_port_util import to_torch as _t
from vadc_tpu.kernels import silero_v31_fused as JK
from vadc_tpu.models import silero_v31 as JM
from vadc_tpu_torch.kernels import silero_v31_fused as KF
from vadc_tpu_torch.models import silero_v31 as TM
from vadc_tpu_torch.models.weights import params_from_numpy
from vadc_tpu_torch.nn import functional as TF

TOL_PROBS = 1e-4
TOL_STATE = 3e-4
BATCH = 4
MATERIALS = {"speech": speech, "noise": noise}


@pytest.fixture(scope="module")
def params():
    return jax_and_port_params()


@pytest.fixture(scope="module")
def folded(params):
    """The bundled archive with batch norm folded into each stage's 1x1 conv
    and the bn_* tensors dropped, as the official v3 .onnx extraction has
    it: (JAX tree, port tree)."""
    jp, _ = params
    folded_np = _fold_bn(jax.tree.map(np.asarray, jp))
    return jax.tree.map(jnp.asarray, folded_np), params_from_numpy(folded_np)


def _state(batch: int, seed: int) -> tuple[np.ndarray, np.ndarray]:
    rng = np.random.default_rng(seed)
    h = (0.5 * rng.normal(size=(2, batch, 64))).astype(np.float32)
    c = (2.0 * rng.normal(size=(2, batch, 64))).astype(np.float32)
    return h, c


def _assert_model_close(got, want, label: str, tol_probs=TOL_PROBS, tol_state=TOL_STATE):
    p, h, c = got
    p_w, h_w, c_w = (np.asarray(x) for x in want)
    assert_close(p, p_w, tol_probs, f"{label} probs")
    assert_close(h, h_w, tol_state, f"{label} h")
    scale = max(1.0, float(np.abs(c_w).max()))
    assert_close(c / scale, c_w / scale, tol_state, f"{label} c (relative)")


@pytest.mark.parametrize("samples", [512, 1024, 1536])
@pytest.mark.parametrize("material", sorted(MATERIALS))
def test_plain_forward_fused_matches_jax_forward_fused(params, material, samples):
    jp, tp = params
    audio = MATERIALS[material](BATCH, chunk=samples, seed=samples)
    h, c = _state(BATCH, seed=samples + 1)
    want = JK.forward_fused(jp, jnp.asarray(audio), jnp.asarray(h), jnp.asarray(c),
                            block_streams=2)
    got = KF.forward_fused(tp, _t(audio), _t(h), _t(c))
    assert got[0].shape == (BATCH,) and got[1].shape == (2, BATCH, 64)
    _assert_model_close(got, want, f"{material} S={samples}")


@pytest.mark.parametrize("samples", [512, 1536])
def test_plain_forward_fused_is_forward_given_the_same_spectrum(params, samples):
    """Both plain versions take the spectrum of nn/functional's
    stft_magnitude_nlc; they differ only in the normalization's smoothing,
    collapsed into per-frame weights in forward_fused (another order of the
    same sums)."""
    _, tp = params
    audio = _t(speech(BATCH, chunk=samples, seed=3))
    h, c = (_t(x) for x in _state(BATCH, seed=4))
    got = KF.forward_fused_reference(tp, audio, h, c)
    want = TM.forward_reference(tp, audio, h, c)
    _assert_model_close(got, want, f"S={samples}", tol_probs=1e-5, tol_state=1e-5)


def test_bn_folded_archive_matches_jax_forward(params, folded):
    """A BN-folded archive (scale 1, shift 0 in the packed weights) gives the
    JAX package's plain forward on the same folded weights."""
    folded_j, folded_t = folded
    audio = speech(BATCH, seed=5)
    h, c = _state(BATCH, seed=6)
    want = jax.jit(JM.forward)(folded_j, jnp.asarray(audio), jnp.asarray(h), jnp.asarray(c))
    got = KF.forward_fused(folded_t, _t(audio), _t(h), _t(c))
    _assert_model_close(got, want, "BN-folded")
    # folding is exact up to rounding: the unfolded archive gives the same
    _, tp = params
    unfolded = KF.forward_fused(tp, _t(audio), _t(h), _t(c))
    assert_close(got[0], unfolded[0], 1e-5, "folded vs unfolded probs")


def test_jax_forward_fused_refuses_a_bn_folded_archive(folded):
    """The reference's fault, documented without editing it: JAX's
    forward_fused applies batch norm unconditionally
    (vadc_tpu/kernels/silero_v31_fused.py:155-156, reading p["bn_var"]),
    so it raises on exactly the archives that its forward and
    forward_fused2d accept. The port's forward_fused takes them (above)."""
    folded_j, _ = folded
    h, c = _state(2, seed=7)
    with pytest.raises(KeyError, match="bn_var"):
        JK.forward_fused(folded_j, jnp.asarray(speech(2, seed=7)), jnp.asarray(h),
                         jnp.asarray(c), block_streams=2)


@pytest.mark.parametrize("n_frames", [9, 13, 17, 21, 25])
def test_norm_weights_collapse_the_normalization(n_frames):
    """spect_e - sum_f norm_w[f] * mean[f] is the adaptive normalization
    (reflect pad 3, 7-tap smoothing, frame mean) of nn/functional."""
    rng = np.random.default_rng(n_frames)
    # magnitudes spanning near-zero bins to loud ones
    spect = _t(np.abs(rng.normal(size=(3, n_frames, 129))) * 10.0 ** rng.uniform(-7, 0, (3, 1, 129)))
    spect_e = TF.accurate_log1p(spect * 1048576.0)
    norm_w = KF.norm_weights(n_frames)
    got = spect_e - (spect_e.mean(-1) * torch.from_numpy(norm_w.copy())).sum(-1)[:, None, None]
    assert_close(got, TF.adaptive_audio_normalization_nlc(spect), 1e-6, f"F={n_frames}")
    assert norm_w.dtype == np.float32 and norm_w.shape == (n_frames,)
    assert abs(float(norm_w.sum(dtype=np.float64)) - 1.0) <= 1e-6
    assert not norm_w.flags.writeable and KF.norm_weights(n_frames) is norm_w


def test_wrapper_state_in_place_chunk_sizes_and_devices(params):
    _, tp = params
    audio = _t(speech(2, seed=8))
    h, c = (_t(x) for x in _state(2, seed=9))
    want = KF.forward_fused(tp, audio, h.clone(), c.clone())
    probs, hn, cn = KF.forward_fused(tp, audio, h, c, hn=h, cn=c)
    assert hn is h and cn is c
    assert torch.equal(probs, want[0]) and torch.equal(h, want[1]) and torch.equal(c, want[2])
    # a strided batch (one chunk of each stream, as StreamRunner.scan gives)
    # is the same as its contiguous copy
    chunks = _t(speech(6, seed=10)).reshape(2, 3, -1)
    h0, c0 = TM.init_state(2)
    strided = KF.forward_fused(tp, chunks[:, 1], h0, c0)
    packed = KF.forward_fused(tp, chunks[:, 1].contiguous(), h0, c0)
    assert all(torch.equal(a, b) for a, b in zip(strided, packed))
    for samples in (256, 1000, 1792):
        with pytest.raises(ValueError, match="multiple of 256"):
            KF.forward_fused(tp, torch.zeros(2, samples), h0, c0)
    # only a CPU tensor takes the plain version: 'meta' has no kernel
    meta = torch.empty(2, 1536, device="meta")
    state = torch.empty(2, 2, 64, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        KF.forward_fused(tp, meta, state, state.clone())
