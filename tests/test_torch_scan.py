"""The port's v3.1 slab scan (`silero_v31.forward_scan`, behind
`StreamRunner.scan`) and the `forward_minibatched` built on it, on the CPU
with the bundled weights: against vadc_tpu's `StreamRunner.scan` and
`forward_minibatched`, and against the port's own loop of steps.

Bounds against vadc_tpu, the whole-model ones of tests/test_torch_model.py
and for its reason (the two packages' fp32 STFTs round differently under
log1p(2^20 x)): probabilities 1e-4, h 3e-4, c 3e-4 of its largest value.
Against the port's own steps and its plain flattened version only the order
of sums differs: probabilities 1e-5, h 1e-4, c 1e-4 of its largest value.
The v4 and v5 families have no slab route: their scan stays the loop of
steps, bit for bit."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.conftest import assert_close
from tests.torch_port_util import DATA, jax_and_port_params, noise, speech  # noqa: F401
from tests.torch_port_util import single_torch_thread  # noqa: F401
from tests.torch_port_util import to_torch as _t
from vadc_tpu.engine import runner as JR
from vadc_tpu.models import silero_v31 as JM
from vadc_tpu_torch.engine import runner as TR
from vadc_tpu_torch.kernels import lstm_decoder as KD
from vadc_tpu_torch.kernels import silero_v31_fused as KF
from vadc_tpu_torch.kernels import silero_v31_fused2d as K2
from vadc_tpu_torch.models import silero_v31 as TM
from vadc_tpu_torch.models import weights as TW
from vadc_tpu_torch.models.synthetic import random_v5_8k_archive, random_v5_archive

TOL_PROBS, TOL_STATE = 1e-4, 3e-4
TOL_OWN_PROBS, TOL_OWN_STATE = 1e-5, 1e-4
MATERIALS = {"speech": speech, "noise": noise}


@pytest.fixture(scope="module")
def params():
    return jax_and_port_params()


def _slab(material: str, batch: int, chunks: int, samples: int = 1536, seed: int = 0):
    return MATERIALS[material](batch * chunks, chunk=samples, seed=seed).reshape(
        batch, chunks, samples
    )


def _assert_state(h, c, h_ref, c_ref, tol, label):
    assert_close(h, h_ref, tol, f"{label} h")
    scale = max(1.0, float(np.abs(np.asarray(c_ref)).max()))
    assert_close(np.asarray(c) / scale, np.asarray(c_ref) / scale, tol, f"{label} c (relative)")


@pytest.mark.parametrize("material", sorted(MATERIALS))
@pytest.mark.parametrize("batch,chunks", [(4, 6), (1, 9), (5, 2)])
def test_scan_matches_the_jax_runner(params, material, batch, chunks):
    jp, tp = params
    slab = _slab(material, batch, chunks, seed=21)
    jr = JR.StreamRunner("v3", jp)
    p_j, st_j = jr.scan(jnp.asarray(slab), jr.init_state(batch))
    tr = TR.StreamRunner("v3", tp, device="cpu")
    state = tr.init_state(batch)
    p, st = tr.scan(slab, state)
    assert st is state and p.shape == (batch, chunks)
    assert_close(p, p_j, TOL_PROBS, "scan probs")
    _assert_state(st.h, st.c, st_j.h, st_j.c, TOL_STATE, "scan")


@pytest.mark.parametrize("samples", [512, 768, 1024, 1280, 1536])
def test_forward_scan_equals_the_loop_of_steps(params, samples):
    """Every chunk size, from a carried state: forward_scan against K calls
    of forward in order."""
    _, tp = params
    batch, chunks = 3, 4
    slab = _t(_slab("speech", batch, chunks, samples, seed=samples))
    h, c = TM.init_state(batch)
    _, h, c = TM.forward(tp, _t(noise(batch, chunk=samples, seed=1)), h, c)
    probs, hn, cn = TM.forward_scan(tp, slab, h, c)
    assert probs.shape == (batch, chunks) and hn is not h
    hs, cs = h, c
    for k in range(chunks):
        p_k, hs, cs = TM.forward(tp, slab[:, k], hs, cs)
        assert_close(probs[:, k], p_k, TOL_OWN_PROBS, f"chunk {k} probs")
    _assert_state(hn, cn, hs, cs, TOL_OWN_STATE, f"S={samples}")


def test_forward_scan_state_in_place_and_across_slabs(params):
    """Two slabs of 3 chunks with the state written over h, c equal one
    slab of 6 chunks bit for bit: only the LSTM crosses a slab's edge."""
    _, tp = params
    slab = _t(_slab("speech", 4, 6, seed=5))
    h, c = TM.init_state(4)
    whole, hw, cw = TM.forward_scan(tp, slab, h, c)
    h2, c2 = TM.init_state(4)
    first, hn, cn = TM.forward_scan(tp, slab[:, :3], h2, c2, hn=h2, cn=c2)
    assert hn is h2 and cn is c2
    second, _, _ = TM.forward_scan(tp, slab[:, 3:], h2, c2, hn=h2, cn=c2)
    assert torch.equal(torch.cat([first, second], dim=1), whole)
    assert torch.equal(h2, hw) and torch.equal(c2, cw)


def test_forward_scan_cut_over_rows_gives_the_same_bits(params, monkeypatch):
    """A slab of more rows than SCAN_ROWS goes through the front-end and the
    encoder in pieces of rows; the rows are independent, so nothing moves."""
    _, tp = params
    slab = _t(_slab("noise", 3, 5, seed=6))
    h, c = TM.init_state(3)
    want = TM.forward_scan(tp, slab, h, c)
    monkeypatch.setattr(TM, "SCAN_ROWS", 4)
    got = TM.forward_scan(tp, slab, h, c)
    for g, w in zip(got, want):
        assert_close(g, w, 1e-6, "row pieces")


def test_forward_scan_is_its_three_parts(params):
    """encode_fused_audio (the front-end and the encoder from raw audio) ->
    one lstm_decoder_fused over [B, K, T, 64]; the front-end was `features`
    and the encoder `encode_fused` until the slab route took the step
    kernel's own front-end."""
    _, tp = params
    slab = _t(_slab("speech", 2, 3, seed=7))
    h, c = TM.init_state(2)
    enc = KF.encode_fused_audio(tp, slab.reshape(6, 1536))
    assert enc.shape == (6, 7, 64) and K2.out_frames(25) == 7 and K2.out_frames(9) == 3
    want = KD.lstm_decoder_fused(enc.reshape(2, 3, 7, 64), h, c, tp["lstm_w"], tp["lstm_b"],
                                 tp["dec_w"], tp["dec_b"])
    got = TM.forward_scan(tp, slab, h, c)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("samples", [512, 1536])
def test_encode_fused_matches_jax_encoder_on_the_same_features(params, samples):
    """encode_fused (its plain version here) against the JAX package's four
    encoder stages on the same normalized features, at the per-op bound
    of 1e-4."""
    from vadc_tpu.models.weights import V3_STRIDES
    from vadc_tpu.nn import functional as JF

    jp, tp = params
    feats = TM.features(tp, _t(speech(4, chunk=samples, seed=8)))
    x = jnp.asarray(feats.numpy())
    for p, stride in zip(jp["layers"], V3_STRIDES):
        x = JF.transformer_layer_nlc(x, p, stride=stride)
    got = K2.encode_fused(tp, feats)
    assert got.shape == (4, K2.out_frames(feats.shape[1]), 64)
    assert_close(got, x, 1e-4, f"encoder S={samples}")


@pytest.mark.parametrize("material", sorted(MATERIALS))
def test_forward_minibatched_matches_jax_and_the_flattened_version(params, material):
    """The CLI's window: N chunks of one stream per call over three calls,
    against jax.jit(forward_minibatched) and against the port's plain
    flattened-sequence version."""
    jp, tp = params
    windows = _slab(material, 3, 8, seed=9)  # [calls, N, S]
    fwd = jax.jit(JM.forward_minibatched)
    h_j, c_j = JM.init_state(1)
    h, c = TM.init_state(1)
    h_f, c_f = TM.init_state(1)
    for call in range(3):
        p_j, h_j, c_j = fwd(jp, jnp.asarray(windows[call]), h_j, c_j)
        p, h, c = TM.forward_minibatched(tp, _t(windows[call]), h, c)
        p_f, h_f, c_f = TM.forward_minibatched_reference(tp, _t(windows[call]), h_f, c_f)
        assert p.shape == (8,) and h.shape == (2, 1, 64)
        assert_close(p, p_j, TOL_PROBS, f"call {call} probs vs jax")
        _assert_state(h, c, h_j, c_j, TOL_STATE, f"call {call} vs jax")
        assert_close(p, p_f, TOL_OWN_PROBS, f"call {call} probs vs flattened")
        _assert_state(h, c, h_f, c_f, TOL_OWN_STATE, f"call {call} vs flattened")


def test_forward_minibatched_leaves_the_callers_state(params):
    _, tp = params
    h, c = TM.init_state(1)
    h += 0.25
    before = h.clone()
    _, hn, cn = TM.forward_minibatched(tp, _t(speech(4, seed=3)), h, c)
    assert torch.equal(h, before) and hn is not h and cn is not c


def _family_params(family: str):
    if family.startswith("v4"):
        name = {"v4": "silero_v4_16k.testtensor", "v4_8k": "silero_v4_8k.testtensor"}[family]
        return TW.load_params(DATA / name)[1]
    archive = random_v5_archive(0) if family == "v5" else random_v5_8k_archive(1)
    return TW.load_params_from_tensors(archive)[1]


@pytest.mark.parametrize("family,samples", [("v4", 1536), ("v4_8k", 768), ("v5", 512),
                                            ("v5_8k", 256)])
def test_other_families_scan_is_still_the_loop_of_steps(family, samples):
    tp = _family_params(family)
    assert not hasattr(TR.get_family_module(family), "forward_scan")
    slab = _slab("speech", 3, 4, samples, seed=13)
    tr = TR.StreamRunner(family, tp, device="cpu")
    p_scan, s_scan = tr.scan(slab, tr.init_state(3))
    state = tr.init_state(3)
    for t in range(4):
        p_t, state = tr.step(slab[:, t], state)
        assert torch.equal(p_t, p_scan[:, t])
    assert torch.equal(state.h, s_scan.h) and torch.equal(state.c, s_scan.c)
    if state.context is not None:
        assert torch.equal(state.context, s_scan.context)


def test_encode_fused_refuses_a_device_it_has_no_kernel_for(params):
    """Only a CPU tensor takes the plain version: any other device goes to
    the kernel's checks ('meta' has no kernel) and raises."""
    _, tp = params
    with pytest.raises(ValueError, match="encode_fused: unsupported device"):
        K2.encode_fused(tp, torch.empty(2, 25, 129, device="meta"))
    assert K2.encode_fused.launches == 0


@pytest.mark.parametrize("material", sorted(MATERIALS))
def test_forward_scan_and_the_steps_share_their_front_end(params, material):
    """The slab route's front half is the step kernel's own front-end and
    encoder (encode_fused_audio), so against the loop of steps only the
    batch shape of the products differs: held ten times tighter than
    TOL_OWN (probabilities 1e-6, h and c 1e-5 of c's largest value;
    measured: probabilities 1.2e-7, h 1.2e-6, c 2.9e-6). On the card the two
    are equal bit for bit (tests/test_torch_cuda.py)."""
    _, tp = params
    batch, chunks = 3, 5
    slab = _t(_slab(material, batch, chunks, seed=31))
    h, c = TM.init_state(batch)
    _, h, c = TM.forward(tp, _t(speech(batch, seed=32)), h, c)
    probs, hn, cn = TM.forward_scan(tp, slab, h, c)
    hs, cs = h, c
    for k in range(chunks):
        p_k, hs, cs = TM.forward(tp, slab[:, k], hs, cs)
        assert_close(probs[:, k], p_k, 1e-6, f"chunk {k} probs")
    _assert_state(hn, cn, hs, cs, 1e-5, material)


def test_forward_scan_runs_encode_fused_audio_and_not_features(params, monkeypatch):
    """One encode_fused_audio call per SCAN_ROWS rows of the slab; neither
    `features` (dot_magnitude and the torch normalization) nor encode_fused
    is on the route any more."""
    _, tp = params
    calls = []

    def counted(p, audio, tier):
        calls.append(tuple(audio.shape))
        return KF.encode_fused_audio(p, audio, tier)

    def off_route(*args, **kwargs):
        raise AssertionError("features / encode_fused are not on the slab route")

    monkeypatch.setattr(TM, "encode_fused_audio", counted)
    monkeypatch.setattr(TM, "features", off_route)
    monkeypatch.setattr(K2, "encode_fused", off_route)
    slab = _t(_slab("speech", 2, 3, seed=33))
    h, c = TM.init_state(2)
    probs, _, _ = TM.forward_scan(tp, slab, h, c)
    assert calls == [(6, 1536)] and probs.shape == (2, 3)
    monkeypatch.setattr(TM, "SCAN_ROWS", 4)
    TM.forward_scan(tp, slab, h, c)
    assert calls[1:] == [(4, 1536), (2, 1536)]
    window, _, _ = TM.forward_minibatched(tp, slab[0], h[:, :1], c[:, :1])
    assert calls[3:] == [(3, 1536)] and window.shape == (3,)


def test_forward_minibatched_is_the_scan_of_one_stream(params):
    _, tp = params
    window = _t(_slab("speech", 1, 7, seed=34))
    h = _t(0.3 * np.random.default_rng(35).normal(size=(2, 1, 64)))
    c = _t(np.random.default_rng(36).normal(size=(2, 1, 64)))
    got = TM.forward_minibatched(tp, window[0], h, c)
    want = TM.forward_scan(tp, window, h, c)
    assert torch.equal(got[0], want[0][0])
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
