"""The port's model and runners against vadc_tpu's, on the CPU, with the
bundled Silero v3.1 weights: `forward` and `forward_minibatched` against
the JAX functions under jax.jit, `StreamRunner.scan` and
`MinibatchRunner.process_window` against the JAX runners, over several
chunks with the LSTM state carried.

Bounds. Probabilities: 1e-4. The state: 3e-4 on h, and on c relative to
its largest value (c is an unbounded running sum). Measured here:
probabilities <= 1.5e-5, h <= 1.4e-4, c <= 4.8e-5 of its largest value.

Why the state's bound is wider than the probabilities': adaptive
normalization takes log1p(2^20 x) of every STFT bin, a slope of 2^20 where
a bin is near zero, and speech has such bins between its harmonics. There
fp32 rounding of the spectrum becomes a visible feature difference, and the
two packages' fp32 STFTs round differently. The port's is the closer of the
two to a float64 STFT of the same frames, as
test_stft_gap_is_jax_rounding holds (measured on these materials, in
log1p(2^20 x): JAX up to 5.4e-3 off float64, the port up to 2.1e-3).
Given the same spectrum, the
rest of the model agrees to 1e-5 on probabilities and state
(tests/test_torch_kernels.py holds that).
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
from vadc_tpu.engine import runner as JR
from vadc_tpu.models import silero_v31 as JM
from vadc_tpu.nn import functional as JF
from vadc_tpu_torch.engine import runner as TR
from vadc_tpu_torch.models import silero_v31 as TM
from vadc_tpu_torch.nn import functional as TF
from vadc_tpu_torch.runtime import NoCudaDeviceError

TOL_PROBS = 1e-4
TOL_STATE = 3e-4
BATCH = 8
STEPS = 5

MATERIALS = {"speech": speech, "noise": noise}


@pytest.fixture(scope="module")
def params():
    return jax_and_port_params()


def _chunks(material: str, batch: int, steps: int, seed: int = 0) -> np.ndarray:
    return MATERIALS[material](batch * steps, seed=seed).reshape(batch, steps, -1)


def _assert_state(h, c, h_j, c_j, label):
    assert_close(h, h_j, TOL_STATE, f"{label} h")
    scale = max(1.0, float(np.abs(np.asarray(c_j)).max()))
    assert_close(c / scale, np.asarray(c_j) / scale, TOL_STATE, f"{label} c (relative)")


@pytest.mark.parametrize("material", sorted(MATERIALS))
def test_forward_matches_jax_with_carried_state(params, material):
    jp, tp = params
    chunks = _chunks(material, BATCH, STEPS, seed=1)
    fwd = jax.jit(JM.forward)
    h_j, c_j = JM.init_state(BATCH)
    h, c = TM.init_state(BATCH)
    for t in range(STEPS):
        p_j, h_j, c_j = fwd(jp, jnp.asarray(chunks[:, t]), h_j, c_j)
        p, h, c = TM.forward(tp, _t(chunks[:, t]), h, c)
        assert p.shape == (BATCH,)
        assert_close(p, p_j, TOL_PROBS, f"{material} step {t} probs")
        _assert_state(h, c, h_j, c_j, f"{material} step {t}")


@pytest.mark.parametrize("material", sorted(MATERIALS))
def test_forward_minibatched_matches_jax_with_carried_state(params, material):
    """N consecutive chunks of one stream per call, the state carried from
    call to call."""
    jp, tp = params
    windows = _chunks(material, STEPS, BATCH, seed=2)  # [calls, N, S]
    fwd = jax.jit(JM.forward_minibatched)
    h_j, c_j = JM.init_state(1)
    h, c = TM.init_state(1)
    for call in range(STEPS):
        p_j, h_j, c_j = fwd(jp, jnp.asarray(windows[call]), h_j, c_j)
        p, h, c = TM.forward_minibatched(tp, _t(windows[call]), h, c)
        assert p.shape == (BATCH,) and h.shape == (2, 1, 64)
        assert_close(p, p_j, TOL_PROBS, f"{material} call {call} probs")
        _assert_state(h, c, h_j, c_j, f"{material} call {call}")


@pytest.mark.parametrize("material", sorted(MATERIALS))
def test_stft_gap_is_jax_rounding(params, material):
    """The inputs of the tests above, in the log1p(2^20 x) of adaptive
    normalization: the port's fp32 STFT magnitude is within 3e-3 of a
    float64 STFT (measured <= 2.1e-3), and closer to it than the JAX
    package's is. So the packages' gap in the state is the reference's
    rounding, amplified, and not a fault of the port."""
    jp, tp = params
    audio = _chunks(material, BATCH, STEPS, seed=1).reshape(BATCH * STEPS, -1)
    stft = dict(pad_left=TM.STFT_PAD, pad_right=TM.STFT_PAD, hop=TM.STFT_HOP)
    jax_mag = jax.jit(lambda a: JF.stft_magnitude_nlc(a, jp["stft_basis"], **stft))(
        jnp.asarray(audio)
    )
    port_mag = TF.stft_magnitude_nlc(_t(audio), tp["stft_basis"], **stft)
    padded = np.pad(audio.astype(np.float64), ((0, 0), (TM.STFT_PAD, TM.STFT_PAD)), mode="reflect")
    frames = np.lib.stride_tricks.sliding_window_view(padded, 256, axis=-1)[:, :: TM.STFT_HOP]
    spec = frames @ np.asarray(jp["stft_basis"], np.float64).T
    exact = np.sqrt(spec[..., :129] ** 2 + spec[..., 129:] ** 2)

    def log_err(mag):
        return float(np.abs(np.log1p(np.asarray(mag, np.float64) * 2.0**20)
                            - np.log1p(exact * 2.0**20)).max())

    port_err, jax_err = log_err(port_mag), log_err(jax_mag)
    assert port_err <= 3e-3, port_err
    assert port_err < jax_err, (port_err, jax_err)


def test_chunk_sequential_minibatched_equals_the_flattened_form(params):
    """forward_minibatched runs the encoder per chunk and threads (h, c)
    chunk to chunk; forward_minibatched_reference flattens the N chunks'
    frames into one LSTM sequence. The two are the same function: on the
    same encoder rows (encode_fused_audio's, whose normalization is the
    step kernel's collapsed form) they agree to 1e-5 (measured: probs
    3.3e-9, hn and cn equal); against forward_minibatched_reference,
    whose normalization smooths before it averages (another order of the
    same sums), the whole-model bounds hold (probs 1e-4, state 3e-4;
    measured: probs 8.8e-9, hn 1.7e-5, cn 5.0e-5)."""
    from vadc_tpu_torch.kernels.silero_v31_fused import encode_fused_audio_reference
    from vadc_tpu_torch.nn import functional as TF

    _, tp = params
    audio = _t(speech(BATCH, seed=3))
    h = _t(0.3 * np.random.default_rng(4).normal(size=(2, 1, 64)))
    c = _t(np.random.default_rng(5).normal(size=(2, 1, 64)))
    got = TM.forward_minibatched(tp, audio, h, c)
    out, hn, cn = TF.lstm_minibatched(encode_fused_audio_reference(tp, audio), h, c,
                                      tp["lstm_w"], tp["lstm_b"])
    flattened = (TF.decoder_v3_nlc(out, tp["dec_w"], tp["dec_b"]), hn, cn)
    for name, g, w in zip(("probs", "hn", "cn"), got, flattened):
        assert_close(g, w, 1e-5, f"minibatched {name}")
    want = TM.forward_minibatched_reference(tp, audio, h, c)
    for name, g, w, tol in zip(("probs", "hn", "cn"), got, want, (1e-4, 3e-4, 3e-4)):
        assert_close(g, w, tol, f"minibatched vs the smoothing form {name}")
    # the caller's state is not consumed
    assert torch.equal(h, _t(0.3 * np.random.default_rng(4).normal(size=(2, 1, 64))))


def test_forward_equals_its_plain_composition(params):
    """On the CPU the kernel wrapper runs its plain version, so forward is
    forward_fused_reference bit for bit. That is forward_reference with the
    normalization's smoothing collapsed into per-frame weights (another
    order of the same sums), so the two agree to 1e-5 (c relative to its
    largest value; measured: probs 1.6e-9, h 5.6e-6, c 3.4e-6)."""
    from vadc_tpu_torch.kernels.silero_v31_fused import forward_fused_reference

    _, tp = params
    audio = _t(speech(3, seed=6))
    h, c = TM.init_state(3)
    got = TM.forward(tp, audio, h, c)
    for g, w in zip(got, forward_fused_reference(tp, audio, h, c)):
        assert torch.equal(g, w)
    probs, hn, cn = TM.forward_reference(tp, audio, h, c)
    assert_close(got[0], probs, 1e-5, "probs")
    assert_close(got[1], hn, 1e-5, "h")
    scale = float(cn.abs().max())
    assert_close(got[2] / scale, cn / scale, 1e-5, "c (relative)")


def test_stream_runner_scan_matches_jax(params):
    jp, tp = params
    chunks = _chunks("speech", BATCH, STEPS, seed=7)
    jr = JR.StreamRunner("v3", jp)
    p_j, st_j = jr.scan(jnp.asarray(chunks), jr.init_state(BATCH))
    tr = TR.StreamRunner("v3", tp, device="cpu")
    state = tr.init_state(BATCH)
    p, st = tr.scan(chunks, state)
    assert st is state  # updated in place, as JAX donates its buffers
    assert p.shape == (BATCH, STEPS)
    assert_close(p, p_j, TOL_PROBS, "scan probs")
    _assert_state(st.h, st.c, st_j.h, st_j.c, "scan")


def test_scan_equals_steps(params):
    """The v3.1 scan is the slab route (the front-end and the encoder over
    all B*T chunks at once, then the LSTM through each stream's chunks); a
    step is `forward_fused`. The two share every op but the adaptive
    normalization's order of sums (the step collapses the 7-tap mean), so
    they agree to rounding: probabilities 1e-5, h 1e-4, c 1e-4 of its
    largest value. Measured: 1.8e-9, 7.2e-6, 1.4e-5."""
    _, tp = params
    chunks = _chunks("noise", 4, STEPS, seed=8)
    tr = TR.StreamRunner("v3", tp, device="cpu")
    p_scan, s_scan = tr.scan(chunks, tr.init_state(4))
    state = tr.init_state(4)
    for t in range(STEPS):
        p_t, state = tr.step(chunks[:, t], state)
        assert_close(p_t, p_scan[:, t], 1e-5, f"step {t} probs")
    assert_close(state.h, s_scan.h, 1e-4, "h")
    scale = max(1.0, float(s_scan.c.abs().max()))
    assert_close(state.c / scale, s_scan.c / scale, 1e-4, "c (relative)")


def test_minibatch_runner_matches_jax_with_padded_final_batch(params):
    """Two windows of 10 chunks at batch 4: the third batch of each window
    is padded with two zero chunks, which advance the state but return no
    probability."""
    jp, tp = params
    chunk = 1536
    windows = speech(20, seed=9).reshape(2, 10 * chunk)
    jr = JR.MinibatchRunner("v3", jp, batch_size=4, chunk_samples=chunk)
    tr = TR.MinibatchRunner("v3", tp, batch_size=4, chunk_samples=chunk, device="cpu")
    for w in range(2):
        p_j = jr.process_window(windows[w])
        p = tr.process_window(windows[w])
        assert len(p) == len(p_j) == 10
        assert_close(np.asarray(p), np.asarray(p_j), TOL_PROBS, f"window {w} probs")
        _assert_state(tr.h, tr.c, jr.h, jr.c, f"window {w}")
    # the padding advanced the state: a runner fed the 10 chunks one batch
    # of exactly 10 ends elsewhere
    exact = TR.MinibatchRunner("v3", tp, batch_size=10, chunk_samples=chunk, device="cpu")
    exact.process_window(windows[0])
    fresh = TR.MinibatchRunner("v3", tp, batch_size=4, chunk_samples=chunk, device="cpu")
    fresh.process_window(windows[0])
    assert not torch.equal(exact.h, fresh.h)


def test_runners_refuse_unported_tiers_families_and_missing_cards(params):
    _, tp = params
    for tier in ("balanced", "fast", "turbo"):
        # v3.1 runs every tier; v4 and v5 (and the 8 kHz twins) refuse the
        # bf16 ones, naming the ROADMAP item, before they touch the weights
        assert TR.StreamRunner("v3", tp, device="cpu", precision=tier).precision == tier
        runner = TR.MinibatchRunner("v3", tp, batch_size=2, chunk_samples=1536,
                                    device="cpu", precision=tier)
        assert runner.precision == tier
        for family in ("v4", "v4_8k", "v5", "v5_8k"):
            with pytest.raises(NotImplementedError, match="ROADMAP.*'bf16 tiers: v4 and v5'"):
                TR.StreamRunner(family, tp, device="cpu", precision=tier)
            with pytest.raises(NotImplementedError, match="ROADMAP.*'bf16 tiers: v4 and v5'"):
                TR.MinibatchRunner(family, tp, batch_size=2, chunk_samples=512,
                                   device="cpu", precision=tier)
    # every family of the JAX package is ported; an unknown one is refused
    with pytest.raises(ValueError, match="unknown model family"):
        TR.StreamRunner("v6", tp, device="cpu")
    with pytest.raises(ValueError):
        TR.StreamRunner("v3", tp, device="cpu", precision="exact")
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; the no-card error cannot show")
    with pytest.raises(NoCudaDeviceError):
        TR.StreamRunner("v3", tp, device="cuda")
    with pytest.raises(NoCudaDeviceError):
        TR.MinibatchRunner("v3", tp, batch_size=4, chunk_samples=1536, device="cuda")
