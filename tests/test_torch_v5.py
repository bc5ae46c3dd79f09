"""The port's Silero v5 (16 kHz and the 8 kHz branch) against vadc_tpu's on
the CPU. No official v5 weights are in the repository, so both packages
run the synthetic archives of the official shapes, which the port makes
itself (`vadc_tpu_torch.models.synthetic`, numpy only) and which equal the
JAX package's array for array.

Covered: the archives and the weight trees, `attach_context`, `forward`
and `forward_minibatched` against the JAX functions under jax.jit,
`StreamRunner.scan` and `MinibatchRunner.process_window` against the JAX
runners with the audio context carried across steps and across windows.

Bounds: probabilities 1e-5; the state 5e-5 on h, and on c relative to its
largest value. v5's STFT feeds convs directly (no log1p(2^20 x)), so the
packages' different fp32 STFT rounding is not amplified as in v3.1 and
v4. What sets the state's bound is the synthetic weights' scale: on the
noise material the four random convs grow the features to ~47 and the gate
pre-activations to ~63 (median 11), where one fp32 ulp is 4e-6 to 8e-6, so
the two packages' sums of 256 products differ by a few 1e-5. Measured
here: probabilities <= 7.7e-7; h <= 3.4e-5 and c <= 1.8e-5 of its largest
value on noise, both <= 5.4e-6 on speech. The carried context is the audio
itself: equal bit for bit.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.conftest import assert_close
from tests.torch_port_util import noise, single_torch_thread, speech  # noqa: F401
from tests.torch_port_util import to_torch as _t
from vadc_tpu.engine import runner as JR
from vadc_tpu.models import silero_v5 as J5
from vadc_tpu.models import synthetic as JS
from vadc_tpu.models import weights as JW
from vadc_tpu_torch.engine import runner as TR
from vadc_tpu_torch.models import silero_v5 as T5
from vadc_tpu_torch.models import synthetic as TS
from vadc_tpu_torch.models import weights as TW

TOL_PROBS = 1e-5
TOL_STATE = 5e-5
BATCH = 8
STEPS = 3

FAMILIES = ("v5", "v5_8k")
WINDOW = {"v5": 512, "v5_8k": 256}
CONTEXT = {"v5": 64, "v5_8k": 32}
JAX_MODULE = {"v5": J5, "v5_8k": J5.v5_8k}
PORT_MODULE = {"v5": T5, "v5_8k": T5.v5_8k}
MATERIALS = {"speech": speech, "noise": noise}


def _archives(family: str):
    """(the JAX package's synthetic archive, the port's), same seed."""
    if family == "v5":
        return JS.random_v5_archive(0), TS.random_v5_archive(0)
    return JS.random_v5_8k_archive(1), TS.random_v5_8k_archive(1)


@pytest.fixture(scope="module")
def params():
    out = {}
    for family in FAMILIES:
        j_arch, t_arch = _archives(family)
        j_family, jp = JW.load_params_from_tensors(j_arch)
        t_family, tp = TW.load_params_from_tensors(t_arch)
        assert j_family == t_family == family
        out[family] = (jp, tp)
    return out


def _chunks(material: str, family: str, batch: int, steps: int, seed: int) -> np.ndarray:
    return MATERIALS[material](batch * steps, chunk=WINDOW[family], seed=seed).reshape(
        batch, steps, -1
    )


def _assert_state(h, c, h_j, c_j, label):
    assert_close(h, h_j, TOL_STATE, f"{label} h")
    scale = max(1.0, float(np.abs(np.asarray(c_j)).max()))
    assert_close(c / scale, np.asarray(c_j) / scale, TOL_STATE, f"{label} c (relative)")


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_synthetic_archives_equal_the_jax_packages(seed):
    for j_arch, t_arch in ((JS.random_v5_archive(seed), TS.random_v5_archive(seed)),
                           (JS.random_v5_8k_archive(seed), TS.random_v5_8k_archive(seed))):
        assert list(j_arch) == list(t_arch)
        for name in j_arch:
            assert t_arch[name].dtype == j_arch[name].dtype, name
            assert np.array_equal(t_arch[name], j_arch[name]), name
    assert TW.detect_model_family(TS.random_v5_archive(seed)) == "v5"
    assert TW.detect_model_family(TS.random_v5_8k_archive(seed)) == "v5_8k"


@pytest.mark.parametrize("family", FAMILIES)
def test_weights_leaf_for_leaf(params, family):
    jp, tp = params[family]
    j_leaves = jax.tree_util.tree_flatten_with_path(jp)[0]
    t_leaves = jax.tree_util.tree_flatten_with_path(jax.tree.map(lambda t: t.numpy(), dict(tp)))[0]
    assert [p for p, _ in j_leaves] == [p for p, _ in t_leaves]
    for (path, want), (_, got) in zip(j_leaves, t_leaves):
        want = np.asarray(want)
        assert got.dtype == np.float32 and got.shape == want.shape, path
        assert np.array_equal(got.view(np.int32), want.view(np.int32)), path
    n_fft = 256 if family == "v5" else 128
    assert tuple(tp["stft_basis"].shape) == (n_fft + 2, n_fft)
    assert tuple(tp["lstm_w"].shape) == (1, 512, 256)


@pytest.mark.parametrize("family", FAMILIES)
def test_attach_context(family):
    tm = PORT_MODULE[family]
    window, ctx = WINDOW[family], CONTEXT[family]
    chunks = _t(noise(3, chunk=window, seed=4))
    context = tm.init_context(3)
    assert context.shape == (3, ctx) and not context.any()
    inp, new_ctx = tm.attach_context(chunks, _t(noise(3, chunk=ctx, seed=5)))
    assert inp.shape == (3, ctx + window)
    assert torch.equal(inp[:, :ctx], _t(noise(3, chunk=ctx, seed=5)))
    assert torch.equal(inp[:, ctx:], chunks) and torch.equal(new_ctx, chunks[:, -ctx:])
    j_inp, j_ctx = J5.attach_context(jnp.asarray(chunks.numpy()),
                                     jnp.asarray(noise(3, chunk=ctx, seed=5)))
    assert np.array_equal(inp.numpy(), np.asarray(j_inp))
    assert np.array_equal(new_ctx.numpy(), np.asarray(j_ctx))


@pytest.mark.parametrize("material", sorted(MATERIALS))
@pytest.mark.parametrize("family", FAMILIES)
def test_forward_matches_jax_with_carried_state_and_context(params, family, material):
    jp, tp = params[family]
    jm, tm = JAX_MODULE[family], PORT_MODULE[family]
    chunks = _chunks(material, family, BATCH, STEPS, seed=1)
    fwd = jax.jit(jm.forward)
    h_j, c_j = jm.init_state(BATCH)
    ctx_j = jm.init_context(BATCH)
    h, c = tm.init_state(BATCH)
    ctx = tm.init_context(BATCH)
    for t in range(STEPS):
        inp_j, ctx_j = J5.attach_context(jnp.asarray(chunks[:, t]), ctx_j)
        p_j, h_j, c_j = fwd(jp, inp_j, h_j, c_j)
        inp, ctx = tm.attach_context(_t(chunks[:, t]), ctx)
        p, h, c = tm.forward(tp, inp, h, c)
        assert p.shape == (BATCH,) and h.shape == (1, BATCH, 128)
        assert_close(p, p_j, TOL_PROBS, f"{family} {material} step {t} probs")
        _assert_state(h, c, h_j, c_j, f"{family} {material} step {t}")


@pytest.mark.parametrize("family", FAMILIES)
def test_forward_minibatched_matches_jax(params, family):
    """N consecutive chunks of one stream, contexts attached, through one
    LSTM sequence; the state carried from call to call."""
    jp, tp = params[family]
    jm, tm = JAX_MODULE[family], PORT_MODULE[family]
    width = CONTEXT[family] + WINDOW[family]
    windows = speech(STEPS * BATCH, chunk=width, seed=2).reshape(STEPS, BATCH, width)
    fwd = jax.jit(jm.forward_minibatched)
    h_j, c_j = jm.init_state(1)
    h, c = tm.init_state(1)
    for call in range(STEPS):
        p_j, h_j, c_j = fwd(jp, jnp.asarray(windows[call]), h_j, c_j)
        p, h, c = tm.forward_minibatched(tp, _t(windows[call]), h, c)
        assert p.shape == (BATCH,) and h.shape == (1, 1, 128)
        assert_close(p, p_j, TOL_PROBS, f"{family} call {call} probs")
        _assert_state(h, c, h_j, c_j, f"{family} call {call}")


@pytest.mark.parametrize("family", FAMILIES)
def test_forward_equals_its_plain_composition(params, family):
    _, tp = params[family]
    tm = PORT_MODULE[family]
    audio = _t(speech(3, chunk=CONTEXT[family] + WINDOW[family], seed=6))
    h, c = tm.init_state(3)
    for g, w in zip(tm.forward(tp, audio, h, c), tm.forward_reference(tp, audio, h, c)):
        assert torch.equal(g, w)
    h1, c1 = h[:, :1], c[:, :1]
    for g, w in zip(tm.forward_minibatched(tp, audio, h1, c1),
                    tm.forward_minibatched_reference(tp, audio, h1, c1)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("family", FAMILIES)
def test_stream_runner_scan_carries_the_context(params, family):
    jp, tp = params[family]
    chunks = _chunks("speech", family, BATCH, STEPS, seed=7)
    jr = JR.StreamRunner(family, jp)
    p_j, st_j = jr.scan(jnp.asarray(chunks), jr.init_state(BATCH))
    tr = TR.StreamRunner(family, tp, device="cpu")
    state = tr.init_state(BATCH)
    assert state.context.shape == (BATCH, CONTEXT[family])
    p, st = tr.scan(chunks, state)
    assert st is state  # h, c and the context updated in place
    assert p.shape == (BATCH, STEPS)
    assert_close(p, p_j, TOL_PROBS, f"{family} scan probs")
    _assert_state(st.h, st.c, st_j.h, st_j.c, f"{family} scan")
    assert np.array_equal(st.context.numpy(), np.asarray(st_j.context))
    assert torch.equal(st.context, _t(chunks[:, -1, -CONTEXT[family]:]))


@pytest.mark.parametrize("family", FAMILIES)
def test_minibatch_runner_carries_the_context_across_windows(params, family):
    """Two windows of 10 chunks at batch 4 (the last batch of each padded
    with zero chunks): chunk i of a batch gets the tail of chunk i-1, chunk
    0 the context carried from the batch before, across windows too."""
    jp, tp = params[family]
    chunk = WINDOW[family]
    windows = speech(20, chunk=chunk, seed=9).reshape(2, 10 * chunk)
    jr = JR.MinibatchRunner(family, jp, batch_size=4, chunk_samples=chunk)
    tr = TR.MinibatchRunner(family, tp, batch_size=4, chunk_samples=chunk, device="cpu")
    for w in range(2):
        p_j = jr.process_window(windows[w])
        p = tr.process_window(windows[w])
        assert len(p) == len(p_j) == 10
        assert_close(np.asarray(p), np.asarray(p_j), TOL_PROBS, f"{family} window {w} probs")
        _assert_state(tr.h, tr.c, jr.h, jr.c, f"{family} window {w}")
        assert np.array_equal(tr.context.numpy(), np.asarray(jr.context))
    # the context matters: a runner that drops it ends elsewhere
    blind = TR.MinibatchRunner(family, tp, batch_size=4, chunk_samples=chunk, device="cpu")
    blind.context = None
    blind.process_window(windows[0])
    fresh = TR.MinibatchRunner(family, tp, batch_size=4, chunk_samples=chunk, device="cpu")
    fresh.process_window(windows[0])
    assert not torch.equal(blind.h, fresh.h)
