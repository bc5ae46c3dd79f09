"""The port's kernel modules on the CPU: each plain version against the
Pallas kernel it stands in for, run in interpret mode, plus the wrappers'
CPU routing, the packed weight buffer the CUDA kernel reads, and the
launch counts.

The CUDA kernels themselves run only on the card (tests/test_torch_cuda.py
and chip_smoke.py). Bounds: dot_magnitude 1e-5 relative to the largest
magnitude; the fused forward 1e-5 on probabilities and h, 1e-5 relative
to the largest |c| on the cell state (an unbounded running sum). Both
packages start the fused forward from the JAX front-end's features (see
tests/test_torch_model.py for why the front-ends differ more). Measured on
the CPU: dot_magnitude 7.2e-7 relative; the fused forward probabilities
2e-10, h 3.4e-6, c 8.4e-7 relative.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.conftest import assert_close
from tests.torch_port_util import jax_and_port_params, noise, speech  # noqa: F401
from tests.torch_port_util import single_torch_thread  # noqa: F401
from tests.torch_port_util import to_torch as _t
from vadc_tpu.models import silero_v31 as JM
from vadc_tpu.nn import functional as JF
from vadc_tpu.nn.functional import BATCH_NORM_EPS
from vadc_tpu_torch.kernels import _build
from vadc_tpu_torch.kernels import silero_v31_fused2d as K2
from vadc_tpu_torch.kernels import silero_v31_fused3d as K3
from vadc_tpu_torch.kernels import stft_dotmag as KD
from vadc_tpu_torch.models import silero_v31 as TM
from vadc_tpu_torch.models.weights import params_from_numpy
from vadc_tpu_torch.nn import functional as TF

TOL = 1e-5


@pytest.fixture(scope="module")
def params():
    return jax_and_port_params()


@jax.jit
def _jax_features(jp, audio):
    """The JAX package's faithful front-end (STFT magnitude + adaptive
    normalization), as its fused entry points compute it."""
    spect = JF.stft_magnitude_nlc(audio, jp["stft_basis"], pad_left=128, pad_right=128, hop=64)
    return JF.adaptive_audio_normalization_nlc(spect)


def _frames(audio: np.ndarray) -> torch.Tensor:
    return TF.frame(TF.reflect_pad_last(_t(audio), 128, 128), 256, 64)


def _carried_state(jp, batch: int, seed: int):
    """A realistic (h, c): one JAX step on other audio from zero state."""
    h, c = JM.init_state(batch)
    _, h, c = jax.jit(JM.forward)(jp, jnp.asarray(noise(batch, seed=seed)), h, c)
    return np.asarray(h), np.asarray(c)


def _assert_state_close(got, want, label):
    hn, cn = got
    hn_j, cn_j = want
    assert_close(hn, hn_j, TOL, f"{label} hn")
    scale = max(1.0, float(np.abs(np.asarray(cn_j)).max()))
    assert_close(cn / scale, np.asarray(cn_j) / scale, TOL, f"{label} cn (relative)")


def test_dot_magnitude_reference_matches_pallas_interpret(params):
    from vadc_tpu.kernels import stft_dotmag as JD

    jp, tp = params
    frames = _frames(speech(4, seed=1))  # a strided unfold view
    wr, wi = KD.split_basis(tp["stft_basis"])
    jwr, jwi = JD.split_basis(jp["stft_basis"])
    assert torch.equal(wr, _t(np.asarray(jwr))) and torch.equal(wi, _t(np.asarray(jwi)))
    got = KD.dot_magnitude_reference(frames, wr, wi)
    want = np.asarray(JD.dot_magnitude(jnp.asarray(frames.numpy()), jwr, jwi, interpret=True))
    assert got.shape == (4, 25, 129)
    peak = float(np.abs(want).max())
    assert_close(got / peak, want / peak, TOL, "dot_magnitude vs Pallas interpret")
    # the wrapper takes the plain version for a CPU tensor, 2-D rows too
    assert torch.equal(KD.dot_magnitude(frames, wr, wi), got)
    rows = frames.reshape(-1, 256)
    assert torch.equal(KD.dot_magnitude(rows, wr, wi), got.reshape(-1, 129))


@pytest.mark.parametrize("entry", ["fused2d", "fused3d"])
def test_fused_reference_matches_pallas_interpret(params, entry):
    from vadc_tpu.kernels.silero_v31_fused2d import forward_fused2d
    from vadc_tpu.kernels.silero_v31_fused3d import forward_fused3d

    jp, tp = params
    batch = 8
    audio = speech(batch, seed=2)
    h, c = _carried_state(jp, batch, seed=3)
    jax_fn = forward_fused2d if entry == "fused2d" else forward_fused3d
    p_j, h_j, c_j = jax_fn(jp, jnp.asarray(audio), jnp.asarray(h), jnp.asarray(c),
                           block_streams=batch)
    feats = _t(_jax_features(jp, jnp.asarray(audio)))
    port_fn = K2.forward_fused2d_reference if entry == "fused2d" else K3.forward_fused3d_reference
    p_t, h_t, c_t = port_fn(tp, feats, _t(h), _t(c))
    assert_close(p_t, p_j, TOL, f"{entry} probs")
    _assert_state_close((h_t, c_t), (h_j, c_j), entry)
    # the wrappers route a CPU tensor to the same plain version
    wrapper = K2.forward_fused2d if entry == "fused2d" else K3.forward_fused3d
    p_w, h_w, c_w = wrapper(tp, feats, _t(h), _t(c))
    assert torch.equal(p_w, p_t) and torch.equal(h_w, h_t) and torch.equal(c_w, c_t)


def _fold_bn(tree: dict) -> dict:
    """The numpy param tree with BN folded into each stage's 1x1 conv, as
    the official .onnx v3 export ships it (no bn_* leaves)."""
    layers = []
    for p in tree["layers"]:
        p = dict(p)
        scale = p["bn_w"] / np.sqrt(p["bn_var"] + BATCH_NORM_EPS)
        p["conv_b"] = ((p["conv_b"] - p["bn_mean"]) * scale + p["bn_b"]).astype(np.float32)
        p["conv_w"] = (p["conv_w"] * scale[:, None]).astype(np.float32)
        for k in ("bn_w", "bn_b", "bn_mean", "bn_var"):
            p.pop(k)
        layers.append(p)
    return {**tree, "layers": layers}


def test_fused_bn_folded_archive(params):
    from vadc_tpu.kernels.silero_v31_fused2d import forward_fused2d

    jp, tp = params
    folded_np = _fold_bn(jax.tree.map(np.asarray, jp))
    folded_j = jax.tree.map(jnp.asarray, folded_np)
    folded_t = params_from_numpy(folded_np)
    batch = 4
    audio = speech(batch, seed=4)
    h, c = _carried_state(jp, batch, seed=5)
    p_j, h_j, c_j = forward_fused2d(folded_j, jnp.asarray(audio), jnp.asarray(h),
                                    jnp.asarray(c), block_streams=batch)
    feats = _t(_jax_features(folded_j, jnp.asarray(audio)))
    p_t, h_t, c_t = K2.forward_fused2d_reference(folded_t, feats, _t(h), _t(c))
    assert_close(p_t, p_j, TOL, "BN-folded probs")
    _assert_state_close((h_t, c_t), (h_j, c_j), "BN-folded")
    # folding is exact up to rounding: the unfolded archive gives the same
    p_u, _, _ = K2.forward_fused2d_reference(tp, feats, _t(h), _t(c))
    assert_close(p_t, p_u, TOL, "folded vs unfolded probs")


def _slot(packed: K2.PackedWeights, stage: int | None, slot: str, numel: int) -> torch.Tensor:
    if stage is None:
        index = len(K2.STAGE_WIDTHS) * len(K2._STAGE_SLOTS) + K2._TAIL_SLOTS.index(slot)
    else:
        index = stage * len(K2._STAGE_SLOTS) + K2._STAGE_SLOTS.index(slot)
    off = int(packed.offsets[index])
    return packed.buffer[off : off + numel]


def test_packed_weights_layout(params):
    """The buffer the CUDA kernel reads: each slot at its offset, matrices
    transposed to [in, out], BN folded to scale/shift (1/0 when the
    archive has no BN), stage 3's absent projection at offset -1."""
    jp, tp = params
    packed = K2.PackedWeights(tp)
    n_slots = len(K2.STAGE_WIDTHS) * len(K2._STAGE_SLOTS) + len(K2._TAIL_SLOTS)
    assert packed.offsets.shape == (n_slots,) and packed.buffer.dtype == torch.float32
    for st, p in enumerate(tp["layers"]):
        for slot in K2._STAGE_SLOTS:
            if slot in ("bn_scale", "bn_shift"):
                continue
            if slot not in p:
                assert slot in ("proj_w", "proj_b") and st == 2
                assert packed.offsets[st * len(K2._STAGE_SLOTS) + K2._STAGE_SLOTS.index(slot)] == -1
                continue
            want = p[slot].T if slot in K2._TRANSPOSED else p[slot]
            got = _slot(packed, st, slot, want.numel())
            assert torch.equal(got, want.reshape(-1)), (st, slot)
        scale = p["bn_w"] * torch.rsqrt(p["bn_var"] + BATCH_NORM_EPS)
        assert torch.equal(_slot(packed, st, "bn_scale", scale.numel()), scale)
        assert torch.equal(_slot(packed, st, "bn_shift", scale.numel()),
                           p["bn_b"] - p["bn_mean"] * scale)
    for i, slot in enumerate(("lstm_w0", "lstm_w1")):
        assert torch.equal(_slot(packed, None, slot, 256 * 128), tp["lstm_w"][i].T.reshape(-1))
    assert torch.equal(_slot(packed, None, "dec_w", 128), tp["dec_w"].reshape(-1))
    folded = K2.PackedWeights(params_from_numpy(_fold_bn(jax.tree.map(np.asarray, jp))))
    for st in range(4):
        n = tp["layers"][st]["conv_b"].numel()
        assert torch.equal(_slot(folded, st, "bn_scale", n), torch.ones(n))
        assert torch.equal(_slot(folded, st, "bn_shift", n), torch.zeros(n))
    # built once per Params object
    assert K2.pack_weights(tp) is K2.pack_weights(tp)


@pytest.mark.parametrize("batch,chunk", [(5, 1536), (3, 512)], ids=["ragged-B5", "9-frames"])
def test_ragged_batch_and_short_chunks_match_jax_forward(params, batch, chunk):
    jp, tp = params
    audio = speech(batch, chunk=chunk, seed=6)
    h, c = _carried_state(jp, batch, seed=7)
    p_j, h_j, c_j = jax.jit(JM.forward)(jp, jnp.asarray(audio), jnp.asarray(h), jnp.asarray(c))
    feats = _t(_jax_features(jp, jnp.asarray(audio)))
    assert feats.shape == (batch, chunk // 64 + 1, 129)
    # log1p(2^20 x) amplifies the packages' different STFT rounding (see
    # test_torch_model.test_stft_gap_is_jax_rounding); measured 1.9e-3
    assert_close(TM.features(tp, _t(audio)), feats, 5e-3, "front-end (log-amplified)")
    p_t, h_t, c_t = K2.forward_fused2d(tp, feats, _t(h), _t(c))
    assert_close(p_t, p_j, TOL, f"B={batch} x {chunk} probs")
    _assert_state_close((h_t, c_t), (h_j, c_j), f"B={batch} x {chunk}")


def test_wrapper_writes_state_in_place(params):
    _, tp = params
    feats = TM.features(tp, _t(speech(2, seed=8)))
    h, c = TM.init_state(2)
    want = K2.forward_fused2d(tp, feats, h.clone(), c.clone())
    probs, hn, cn = K2.forward_fused2d(tp, feats, h, c, hn=h, cn=c)
    assert hn is h and cn is c
    assert torch.equal(probs, want[0]) and torch.equal(h, want[1]) and torch.equal(c, want[2])


def test_wrappers_refuse_a_device_they_have_no_kernel_for(params):
    """Only a CPU tensor takes the plain version: any other device goes to
    the kernel's checks (here 'meta', which has no kernel) and raises."""
    _, tp = params
    wr, wi = KD.split_basis(tp["stft_basis"])
    frames = torch.empty(2, 25, 256, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        KD.dot_magnitude(frames, wr.to("meta"), wi.to("meta"))
    feats = torch.empty(2, 25, 129, device="meta")
    h = torch.empty(2, 2, 64, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        K2.forward_fused2d(tp, feats, h, h.clone())


def test_cpu_runs_build_and_launch_nothing(params):
    """Importing the kernel modules and running the CPU path never invokes
    nvcc nor loads the library, and counts no launch."""
    from vadc_tpu_torch.kernels.silero_v31_fused import forward_fused

    _, tp = params
    KD.dot_magnitude.launches = 0
    K2.forward_fused2d.launches = 0
    forward_fused.launches = 0
    h, c = TM.init_state(3)
    TM.forward(tp, _t(speech(3, seed=9)), h, c)
    TM.forward_minibatched(tp, _t(speech(3, seed=9)), h[:, :1], c[:, :1])
    assert _build._lib is None and not _build.build_info
    assert KD.dot_magnitude.launches == 0 and K2.forward_fused2d.launches == 0
    assert forward_fused.launches == 0


def test_kernel_sources_and_build_flags():
    names = sorted(p.name for p in _build.sources())
    assert names == ["errors.cu", "fsm_scan.cu", "lstm.cu", "lstm_decoder.cu", "probes.cu",
                     "silero_v31_fused.cu", "silero_v31_fused_audio.cu", "stft_dotmag.cu",
                     "stft_mag.cu", "v5_convs.cu"]
    # the headers the kernels share are part of the library's hash: the
    # STFT tile (dot_magnitude, stft_magnitude, forward_fused), the v3.1
    # model body (forward_fused2d, encode_fused, forward_fused,
    # lstm_decoder_fused), the LSTM's activations and cell (every kernel
    # that runs an LSTM step), the resident-weights variant of the two
    # recurrent kernels (lstm_fused, lstm_decoder_fused), the precision
    # tiers' arithmetic (the v3.1 kernels' instances), the tensor-core
    # fragments (the probes, the spectrum tile and the body at the bf16 tiers),
    # the LSTMs' gate sums at the bf16 tiers (every recurrent kernel) and the
    # TMA and wgmma core (the probes)
    assert [p.name for p in _build.headers()] == [
        "lstm_cell.cuh", "lstm_mma.cuh", "lstm_resident.cuh", "mma.cuh", "silero_v31_body.cuh",
        "stft_tile.cuh", "tier.cuh", "wgmma.cuh"]
    flags = " ".join(_build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags and "-O3" in flags
    assert "fast_math" not in flags and "fast-math" not in flags
    assert _build.library_path().parent == _build.BUILD_DIR
    # every pointer and the stream go through ctypes as c_void_p
    import ctypes

    for name, argtypes in _build._SIGNATURES.items():
        assert argtypes[-1] is ctypes.c_void_p, name


def test_plain_versions_are_finite_on_digital_silence(params):
    """All-zero audio: every spectral bin is 0, the log1p and the norms see
    their edge case; the result is finite and reads as non-speech."""
    _, tp = params
    feats = TM.features(tp, torch.zeros(2, 1536))
    assert torch.isfinite(feats).all()
    h, c = TM.init_state(2)
    probs, hn, cn = K2.forward_fused2d_reference(tp, feats, h, c)
    assert torch.isfinite(hn).all() and torch.isfinite(cn).all()
    assert bool(((probs >= 0) & (probs < 0.5)).all()), probs
