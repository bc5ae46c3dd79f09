"""The port's Silero v4 (16 kHz and the 8 kHz branch) against vadc_tpu's on
the CPU, with the official weights of the two bundled archives: the weight
trees leaf for leaf, `forward` and `forward_minibatched` against the JAX
functions under jax.jit, `StreamRunner.scan` and
`MinibatchRunner.process_window` against the JAX runners, and the JAX
package's speech-vs-silence behaviour check on the port.

Bounds, v3.1's (tests/test_torch_model.py) and for the same reason:
probabilities 1e-4; the state 3e-4 on h, and on c relative to its largest
value. v4's adaptive
normalization takes log1p(2^20 x) of every STFT bin as v3.1's does, and
the two packages' fp32 STFTs round differently at the near-zero bins (see
tests/test_torch_model.py::test_stft_gap_is_jax_rounding). Measured here:
probabilities <= 6.2e-6, h <= 2.6e-5, c <= 5.6e-6 of its largest value
(the 16 kHz branch; the 8 kHz one 1.3e-6, 1.4e-5 and 3.6e-6).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.conftest import assert_close
from tests.torch_port_util import DATA, noise, single_torch_thread, speech  # noqa: F401
from tests.torch_port_util import to_torch as _t
from vadc_tpu.engine import runner as JR
from vadc_tpu.io.testtensor import load_testtensor
from vadc_tpu.models import silero_v4 as J4
from vadc_tpu.models import weights as JW
from vadc_tpu_torch.engine import runner as TR
from vadc_tpu_torch.models import silero_v4 as T4
from vadc_tpu_torch.models import weights as TW

TOL_PROBS = 1e-4
TOL_STATE = 3e-4
BATCH = 8
STEPS = 3

ARCHIVES = {"v4": "silero_v4_16k.testtensor", "v4_8k": "silero_v4_8k.testtensor"}
CHUNK = {"v4": 1536, "v4_8k": 768}
JAX_MODULE = {"v4": J4, "v4_8k": J4.v4_8k}
PORT_MODULE = {"v4": T4, "v4_8k": T4.v4_8k}
MATERIALS = {"speech": speech, "noise": noise}


@pytest.fixture(scope="module")
def params():
    """family -> (JAX param tree, the port's), each built by its own
    package's loader from the same archive."""
    out = {}
    for family, name in ARCHIVES.items():
        tensors = load_testtensor(DATA / name)
        j_family, jp = JW.load_params_from_tensors(tensors)
        t_family, tp = TW.load_params_from_tensors(tensors)
        assert j_family == t_family == family
        out[family] = (jp, tp)
    return out


def _chunks(material: str, family: str, batch: int, steps: int, seed: int) -> np.ndarray:
    return MATERIALS[material](batch * steps, chunk=CHUNK[family], seed=seed).reshape(
        batch, steps, -1
    )


def _assert_state(h, c, h_j, c_j, label):
    assert_close(h, h_j, TOL_STATE, f"{label} h")
    scale = max(1.0, float(np.abs(np.asarray(c_j)).max()))
    assert_close(c / scale, np.asarray(c_j) / scale, TOL_STATE, f"{label} c (relative)")


@pytest.mark.parametrize("family", sorted(ARCHIVES))
def test_weights_leaf_for_leaf(params, family):
    jp, tp = params[family]
    assert isinstance(tp, TW.Params)
    j_leaves = jax.tree_util.tree_flatten_with_path(jp)[0]
    t_leaves = jax.tree_util.tree_flatten_with_path(jax.tree.map(lambda t: t.numpy(), dict(tp)))[0]
    assert [p for p, _ in j_leaves] == [p for p, _ in t_leaves]
    for (path, want), (_, got) in zip(j_leaves, t_leaves):
        want = np.asarray(want)
        assert got.dtype == np.float32 and got.shape == want.shape, path
        assert np.array_equal(got.view(np.int32), want.view(np.int32)), path
    # stage 3 has no conv-block projection; the official archives are
    # BN-folded
    assert "proj_w" not in tp["stages"][2] and "bn_w" not in tp["stages"][0]
    assert tuple(tp["lstm_w"].shape) == (2, 256, 128) and tuple(tp["dec_w"].shape) == (1, 64)


@pytest.mark.parametrize("material", sorted(MATERIALS))
@pytest.mark.parametrize("family", sorted(ARCHIVES))
def test_forward_matches_jax_with_carried_state(params, family, material):
    jp, tp = params[family]
    jm, tm = JAX_MODULE[family], PORT_MODULE[family]
    chunks = _chunks(material, family, BATCH, STEPS, seed=1)
    fwd = jax.jit(jm.forward)
    h_j, c_j = jm.init_state(BATCH)
    h, c = tm.init_state(BATCH)
    for t in range(STEPS):
        p_j, h_j, c_j = fwd(jp, jnp.asarray(chunks[:, t]), h_j, c_j)
        p, h, c = tm.forward(tp, _t(chunks[:, t]), h, c)
        assert p.shape == (BATCH,) and h.shape == (2, BATCH, 64)
        assert_close(p, p_j, TOL_PROBS, f"{family} {material} step {t} probs")
        _assert_state(h, c, h_j, c_j, f"{family} {material} step {t}")


@pytest.mark.parametrize("family", sorted(ARCHIVES))
def test_forward_minibatched_matches_jax_with_carried_state(params, family):
    """N consecutive chunks of one stream per call (one LSTM sequence of N
    x frames), the state carried from call to call."""
    jp, tp = params[family]
    jm, tm = JAX_MODULE[family], PORT_MODULE[family]
    windows = _chunks("speech", family, STEPS, BATCH, seed=2)  # [calls, N, S]
    fwd = jax.jit(jm.forward_minibatched)
    h_j, c_j = jm.init_state(1)
    h, c = tm.init_state(1)
    for call in range(STEPS):
        p_j, h_j, c_j = fwd(jp, jnp.asarray(windows[call]), h_j, c_j)
        p, h, c = tm.forward_minibatched(tp, _t(windows[call]), h, c)
        assert p.shape == (BATCH,) and h.shape == (2, 1, 64)
        assert_close(p, p_j, TOL_PROBS, f"{family} call {call} probs")
        _assert_state(h, c, h_j, c_j, f"{family} call {call}")


@pytest.mark.parametrize("family", sorted(ARCHIVES))
def test_forward_equals_its_plain_composition(params, family):
    """On the CPU the kernel wrappers run their plain versions, so each
    forward is its `*_reference` bit for bit."""
    _, tp = params[family]
    tm = PORT_MODULE[family]
    audio = _t(speech(3, chunk=CHUNK[family], seed=6))
    h, c = tm.init_state(3)
    for g, w in zip(tm.forward(tp, audio, h, c), tm.forward_reference(tp, audio, h, c)):
        assert torch.equal(g, w)
    h1, c1 = h[:, :1], c[:, :1]
    for g, w in zip(tm.forward_minibatched(tp, audio, h1, c1),
                    tm.forward_minibatched_reference(tp, audio, h1, c1)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("family", sorted(ARCHIVES))
def test_stream_runner_scan_matches_jax(params, family):
    jp, tp = params[family]
    chunks = _chunks("speech", family, BATCH, STEPS, seed=7)
    jr = JR.StreamRunner(family, jp)
    p_j, st_j = jr.scan(jnp.asarray(chunks), jr.init_state(BATCH))
    tr = TR.StreamRunner(family, tp, device="cpu")
    state = tr.init_state(BATCH)
    assert state.context is None
    p, st = tr.scan(chunks, state)
    assert st is state  # updated in place, as JAX donates its buffers
    assert p.shape == (BATCH, STEPS)
    assert_close(p, p_j, TOL_PROBS, f"{family} scan probs")
    _assert_state(st.h, st.c, st_j.h, st_j.c, f"{family} scan")


@pytest.mark.parametrize("family", sorted(ARCHIVES))
def test_minibatch_runner_matches_jax_with_padded_final_batch(params, family):
    """Two windows of 10 chunks at batch 4: the third batch of each window
    is padded with two zero chunks, which advance the state but return no
    probability."""
    jp, tp = params[family]
    chunk = CHUNK[family]
    windows = speech(20, chunk=chunk, seed=9).reshape(2, 10 * chunk)
    jr = JR.MinibatchRunner(family, jp, batch_size=4, chunk_samples=chunk)
    tr = TR.MinibatchRunner(family, tp, batch_size=4, chunk_samples=chunk, device="cpu")
    for w in range(2):
        p_j = jr.process_window(windows[w])
        p = tr.process_window(windows[w])
        assert len(p) == len(p_j) == 10
        assert_close(np.asarray(p), np.asarray(p_j), TOL_PROBS, f"{family} window {w} probs")
        _assert_state(tr.h, tr.c, jr.h, jr.c, f"{family} window {w}")


def _speechlike(duration_s: float, f0: float = 120.0, sr: int = 16000) -> np.ndarray:
    """Harmonic stack with formant weighting and syllabic AM, as
    tests/test_v4.py builds it."""
    t = np.arange(int(duration_s * sr)) / sr
    sig = np.zeros_like(t)
    for k in range(1, 25):
        f = k * f0
        w = (np.exp(-(((f - 500) / 400) ** 2)) + 0.7 * np.exp(-(((f - 1500) / 500) ** 2))
             + 0.3 * np.exp(-(((f - 2500) / 700) ** 2)))
        sig += w * np.sin(2 * np.pi * f * t + k)
    sig *= 0.5 * (1 + np.sin(2 * np.pi * 3.0 * t - np.pi / 2))
    return (0.3 * sig / np.abs(sig).max()).astype(np.float32)


def test_speech_vs_silence_behavior(params):
    """tests/test_v4.py's mapping check on the port: high probability on
    speech-like audio after v4's ~30-chunk warm-up, low on near-silence."""
    _, tp = params["v4"]
    n_chunks = 40
    voiced = _speechlike(n_chunks * 1536 / 16000)[: n_chunks * 1536]
    quiet = (np.random.default_rng(0).normal(size=n_chunks * 1536) * 0.001).astype(np.float32)
    runner = TR.StreamRunner("v4", tp, device="cpu")
    chunks = np.stack([voiced.reshape(n_chunks, 1536), quiet.reshape(n_chunks, 1536)])
    probs, _ = runner.scan(chunks, runner.init_state(2))
    probs = probs.numpy()
    assert probs[0, -10:].min() > 0.6, probs[0]
    assert probs[1].max() < 0.1, probs[1]
