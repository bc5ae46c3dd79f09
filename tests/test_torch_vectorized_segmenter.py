"""The port's vectorized segmentation FSM against
vadc_tpu.engine.vectorized_segmenter and against the scalar Segmenter, on
seeded random probability grids: `fsm_step`, `segment_batch` and
`BatchSegmenter` (against the JAX package's backends device, native and
auto; slabs of 16 and of 7, whose last is ragged; valid_chunks) give
identical states, events and segments. The FSM kernel's wrapper
(`kernels/fsm.py: fsm_scan`) takes segment_batch for a CPU tensor, and on
the CPU the segmenter launches no kernel (the kernel against
segment_batch on the card: tests/test_torch_cuda.py, whose inputs the
plain version here holds to the JAX package's bit for bit, since the card's
machine has no JAX). No tolerance: the FSM is integer logic on float32
comparisons that both packages make alike."""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from hypothesis import given, settings
from hypothesis import strategies as st

from vadc_tpu.cli.segmenter import Segmenter as JSegmenter
from vadc_tpu.cli.segmenter import SegmenterConfig as JConfig
from vadc_tpu.engine import vectorized_segmenter as JV
from vadc_tpu_torch import tracing
from vadc_tpu_torch.cli.segmenter import SegmenterConfig
from vadc_tpu_torch.engine import vectorized_segmenter as TV
from vadc_tpu_torch.kernels import _build, fsm

FSM = dict(threshold=0.5, neg_threshold=0.35, min_silence_chunks=2, min_speech_chunks=3)
CONFIGS = {
    "default": {},
    "long silence": dict(min_silence_chunks=4, min_speech_chunks=1),
    "tight": dict(threshold=0.6, neg_threshold=0.59, min_silence_chunks=1, min_speech_chunks=2),
}


def _grid(n_streams: int, n_chunks: int, seed: int) -> np.ndarray:
    """Probabilities that dwell: runs of speech-like and silence-like values
    with some in the hysteresis band, so segments open, close and get
    discarded."""
    rng = np.random.default_rng(seed)
    out = np.empty((n_streams, n_chunks), np.float32)
    for i in range(n_streams):
        t = 0
        while t < n_chunks:
            run = int(rng.integers(1, 9))
            level = rng.choice([0.05, 0.3, 0.42, 0.55, 0.9])
            out[i, t : t + run] = np.clip(level + 0.08 * rng.normal(size=run), 0, 1)[: n_chunks - t]
            t += run
    return out


def _config(kw: dict, cls=SegmenterConfig):
    return cls(**{**FSM, **kw})


def _scalar(probs: np.ndarray, kw: dict, valid=None) -> list[list[tuple[float, float]]]:
    """The scalar CLI Segmenter, one stream at a time on its real prefix."""
    out = []
    for i, row in enumerate(probs):
        seg = JSegmenter(_config(kw, JConfig))
        n = len(row) if valid is None else int(valid[i])
        got = [s for p in row[:n] for s in seg.feed(float(p))]
        out.append(got + list(seg.finish()))
    return out


def _state_equal(ts: TV.FsmState, js: JV.FsmState) -> None:
    assert np.array_equal(ts.triggered.numpy(), np.asarray(js.triggered))
    assert np.array_equal(ts.speech_start.numpy(), np.asarray(js.speech_start))
    assert np.array_equal(ts.temp_end.numpy(), np.asarray(js.temp_end))
    assert ts.chunk_index == int(js.chunk_index)


@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("masked", [False, True])
def test_fsm_step_matches_jax_chunk_by_chunk(name, masked):
    kw = {**FSM, **CONFIGS[name]}
    probs = _grid(6, 40, seed=1)
    rng = np.random.default_rng(2)
    ts, js = TV.init_fsm_state(6), JV.init_fsm_state(6)
    assert ts.triggered.dtype == torch.bool and ts.speech_start.dtype == torch.int32
    for t in range(40):
        active = rng.random(6) < 0.8 if masked else None
        ts, t_ev = TV.fsm_step(ts, torch.from_numpy(probs[:, t]), **kw,
                               active=None if active is None else torch.from_numpy(active))
        js, j_ev = JV.fsm_step(js, jnp.asarray(probs[:, t]), **kw,
                               active=None if active is None else jnp.asarray(active))
        _state_equal(ts, js)
        closed = np.asarray(j_ev[0])
        assert np.array_equal(t_ev[0].numpy(), closed)
        # start and end matter where a segment closed
        assert np.array_equal(t_ev[1].numpy()[closed], np.asarray(j_ev[1])[closed])
        assert np.array_equal(t_ev[2].numpy()[closed], np.asarray(j_ev[2])[closed])


@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("with_valid", [False, True])
def test_segment_batch_matches_jax_across_two_slabs(name, with_valid):
    kw = {**FSM, **CONFIGS[name]}
    probs = _grid(5, 48, seed=3)
    valid = np.array([48, 30, 7, 0, 41], np.int32) if with_valid else None
    ts = js = None
    for a, b in ((0, 20), (20, 48)):
        ts, t_ev = TV.segment_batch(
            torch.from_numpy(probs[:, a:b]), **kw, state=ts,
            valid_chunks=None if valid is None else torch.from_numpy(valid))
        js, j_ev = JV.segment_batch(
            jnp.asarray(probs[:, a:b]), **kw, state=js,
            valid_chunks=None if valid is None else jnp.asarray(valid))
        _state_equal(ts, js)
        assert t_ev[0].shape == (b - a, 5) and t_ev[0].dtype == torch.bool
        for t_arr, j_arr in zip(t_ev, j_ev):
            assert np.array_equal(t_arr.numpy(), np.asarray(j_arr))


@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("with_valid", [False, True])
def test_fsm_scan_on_the_cpu_is_segment_batch(name, with_valid):
    """The kernel's wrapper sends a CPU tensor to the plain version: the
    events segment_batch returns, stacked as [3, T, B] int32, and its state,
    across two slabs; no launch is counted and no library is built."""
    kw = {**FSM, **CONFIGS[name]}
    probs = torch.from_numpy(_grid(5, 48, seed=8))
    valid = torch.tensor([48, 30, 7, 0, 41], dtype=torch.int32) if with_valid else None
    launches = fsm.fsm_scan.launches
    ts = ks = TV.init_fsm_state(5)
    closes = 0
    for a, b in ((0, 20), (20, 48)):
        ts, (closed, starts, ends) = TV.segment_batch(probs[:, a:b], **kw, state=ts,
                                                      valid_chunks=valid)
        ks, events = fsm.fsm_scan(probs[:, a:b], ks, **kw, valid_chunks=valid)
        assert events.dtype == torch.int32 and events.shape == (3, b - a, 5)
        assert torch.equal(events[0], closed.to(torch.int32))
        assert torch.equal(events[1], starts) and torch.equal(events[2], ends)
        assert ks.chunk_index == ts.chunk_index == b
        for field in ("triggered", "speech_start", "temp_end"):
            assert torch.equal(getattr(ks, field), getattr(ts, field))
        closes += int(events[0].sum())
    assert closes, "the grid should close some segments"
    assert fsm.fsm_scan.launches == launches
    assert _build._lib is None


@pytest.mark.parametrize("with_valid", [False, True])
def test_every_column_counted_and_no_launch_on_the_cpu(with_valid):
    """On the CPU the segmenter steps every column with segment_batch:
    `segmenter.columns` counts them, no other counter moves and the
    kernel's launch count does not move."""
    probs = _grid(4, 40, seed=9)
    valid = np.array([40, 17, 25, 3]) if with_valid else None
    launches = fsm.fsm_scan.launches
    before = tracing.counters()
    with tracing.record():
        got = _port_segments(probs, {}, valid=valid, slab=16)
    after = tracing.counters()
    counted = {k: n - before.get(k, 0) for k, n in after.items() if n != before.get(k, 0)}
    assert counted == {"segmenter.columns": 40}
    assert fsm.fsm_scan.launches == launches
    assert got == _scalar(probs, {}, valid)


def test_the_engine_takes_the_fsm_from_the_kernels_module():
    """The FSM's plain version and its kernel live in kernels/fsm.py; the
    engine's names are those objects, and the kernels module imports
    nothing of the engine."""
    import ast
    import inspect

    for name in ("FsmState", "init_fsm_state", "fsm_step", "segment_batch", "fsm_scan"):
        assert getattr(TV, name) is getattr(fsm, name), name
    imported = {node.module for node in ast.walk(ast.parse(inspect.getsource(fsm)))
                if isinstance(node, ast.ImportFrom)}
    assert not any(m and m.startswith("vadc_tpu_torch.engine") for m in imported), imported


def test_fsm_scan_c_entry_is_declared_as_defined():
    """ctypes cuts a pointer passed without argtypes and passes a float
    without them as a double: the kernel's C entry is declared with as
    many arguments as its definition takes, the thresholds as c_float, the
    strides as 64-bit, every pointer and the stream as c_void_p."""
    import ctypes
    import re

    src = (_build.CSRC / "fsm_scan.cu").read_text()
    assert _build.CSRC / "fsm_scan.cu" in _build.sources()
    found = re.search(r'extern "C" int vadc_fsm_scan\(([^)]*)\)', src)
    params = [" ".join(p.split()) for p in found.group(1).split(",")]
    sig = _build._SIGNATURES["vadc_fsm_scan"]
    assert len(params) == len(sig)
    by_c = {"float": ctypes.c_float, "int": ctypes.c_int, "long long": ctypes.c_longlong}
    for param, argtype in zip(params, sig):
        c_type = param.rsplit(" ", 1)[0]
        assert by_c.get(c_type, ctypes.c_void_p) is argtype, param
        assert ("*" in param or param.startswith("void")) == (argtype is ctypes.c_void_p), param


def _card_tests():
    """tests/test_torch_cuda.py as a module, for its inputs (it imports no
    JAX and nothing of tests/; its tests are not collected from here)."""
    path = Path(__file__).with_name("test_torch_cuda.py")
    spec = importlib.util.spec_from_file_location("card_tests", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


CARD = _card_tests()


def _plain_is_jax(slabs, valid) -> int:
    """segment_batch and the JAX package's segment_batch over the same
    numpy slabs in turn, the state carried, with the card tests' FSM: every
    entry of the three events (seg_start and seg_end where nothing closed
    too) and the state equal after each slab. The segments closed."""
    ts = js = None
    closes = 0
    for probs in slabs:
        ts, t_ev = TV.segment_batch(
            torch.from_numpy(probs), **CARD.FSM, state=ts,
            valid_chunks=None if valid is None else torch.from_numpy(valid))
        js, j_ev = JV.segment_batch(
            jnp.asarray(probs), **CARD.FSM, state=js,
            valid_chunks=None if valid is None else jnp.asarray(valid))
        _state_equal(ts, js)
        for t_arr, j_arr in zip(t_ev, j_ev):
            assert np.array_equal(t_arr.numpy(), np.asarray(j_arr))
        closes += int(t_ev[0].sum())
    return closes


@pytest.mark.parametrize("with_valid", [False, True])
@pytest.mark.parametrize("n_cols,batch", CARD.FSM_SHAPES)
def test_card_fsm_inputs_plain_is_jax(n_cols, batch, with_valid):
    """On the inputs of the card's test_fsm_scan_kernel_is_segment_batch_bit_for_bit
    (probabilities at the fp32 thresholds and one ulp either side; valid 0,
    inside either slab and past both), the plain version the kernel is held
    to there equals the JAX package's vectorized segmenter bit for bit."""
    grid, valid = CARD.fsm_case(n_cols, batch, with_valid)
    at = np.float32([CARD.FSM["threshold"], CARD.FSM["neg_threshold"]])
    assert batch * n_cols < 64 or np.isin(grid, at).any()
    closes = _plain_is_jax([grid[:, :n_cols], grid[:, n_cols:]], valid)
    if n_cols * batch >= 7 * 512:
        assert closes


@pytest.mark.parametrize("layout", CARD.FSM_LAYOUTS)
def test_card_fsm_view_inputs_plain_is_jax(layout):
    """The same on the card's views that are not contiguous: the values the
    kernel reads through the view, then the same columns reversed."""
    grid, valid, view = CARD.fsm_view_case(layout)
    probs = view(torch.from_numpy(grid)).numpy()
    assert _plain_is_jax([np.ascontiguousarray(probs), np.ascontiguousarray(probs[:, ::-1])],
                         valid)


def test_card_segmenter_inputs_scalar_is_jax():
    """On the inputs of the card's BatchSegmenter test, the port's scalar
    Segmenter (which the card's segments are held to there) gives the JAX
    package's scalar Segmenter's segments and its BatchSegmenter's."""
    from vadc_tpu_torch.cli.segmenter import Segmenter

    probs, valid = CARD.segmenter_case()
    port = []
    for row, n in zip(probs, valid):
        scalar = Segmenter(SegmenterConfig(**CARD.FSM))
        port.append([s for p in row[:n] for s in scalar.feed(float(p))] + list(scalar.finish()))
    jax_scalar = []
    for row, n in zip(probs, valid):
        scalar = JSegmenter(JConfig(**CARD.FSM))
        jax_scalar.append([s for p in row[:n] for s in scalar.feed(float(p))]
                          + list(scalar.finish()))
    jseg = JV.BatchSegmenter(JConfig(**CARD.FSM), probs.shape[0], backend="device",
                             valid_chunks=valid)
    for off in range(0, probs.shape[1], 64):
        jseg.feed(probs[:, off : off + 64])
    assert port == jax_scalar == jseg.finish(valid_chunks=valid)
    assert any(port)


def _port_segments(probs, kw, *, valid, slab):
    seg = TV.BatchSegmenter(_config(kw), probs.shape[0], device="cpu", valid_chunks=valid)
    for off in range(0, probs.shape[1], slab):
        seg.feed(torch.from_numpy(probs[:, off : off + slab]))
        assert len(seg._pending) <= TV.PENDING_SLABS
    return seg.finish(valid_chunks=valid)


@pytest.mark.parametrize("jax_backend", ["device", "native", "auto"])
@pytest.mark.parametrize("slab", [16, 7])
@pytest.mark.parametrize("with_valid", [False, True])
def test_batch_segmenter_matches_jax_and_the_scalar_segmenter(jax_backend, slab, with_valid):
    probs = _grid(7, 64, seed=4)
    valid = np.array([64, 50, 33, 12, 1, 0, 64]) if with_valid else None
    got = _port_segments(probs, {}, valid=valid, slab=slab)
    jseg = JV.BatchSegmenter(_config({}, JConfig), 7, backend=jax_backend, valid_chunks=valid)
    for off in range(0, 64, slab):
        jseg.feed(probs[:, off : off + slab])
    assert got == jseg.finish(valid_chunks=valid)
    assert got == _scalar(probs, {}, valid)
    assert any(got), "the grid should hold some segments"


@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("slab", [1, 5, 64])
def test_batch_segmenter_is_slab_size_invariant(name, slab):
    probs = _grid(4, 64, seed=5)
    valid = np.array([64, 17, 40, 3])
    got = _port_segments(probs, CONFIGS[name], valid=valid, slab=slab)
    assert got == _scalar(probs, CONFIGS[name], valid)


def test_collect_segments_and_array_input():
    probs = _grid(3, 50, seed=6)
    got = TV.collect_segments(probs, _config({}), device="cpu")
    assert got == JV.collect_segments(probs, _config({}, JConfig))
    assert got == _scalar(probs, {})


def test_finish_refuses_valid_chunks_that_disagree_with_the_constructors():
    seg = TV.BatchSegmenter(_config({}), 2, device="cpu", valid_chunks=[3, 4])
    seg.feed(np.zeros((2, 4), np.float32))
    with pytest.raises(ValueError, match="disagrees"):
        seg.finish(valid_chunks=[3, 5])


def test_cuda_device_is_refused_without_a_card():
    from vadc_tpu_torch.runtime import NoCudaDeviceError

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(NoCudaDeviceError):
        TV.BatchSegmenter(_config({}), 2, device="cuda")


@settings(max_examples=40, deadline=None)
@given(
    seed=st.integers(0, 2**31 - 1),
    n_streams=st.integers(1, 5),
    n_chunks=st.integers(1, 40),
    slab=st.integers(1, 12),
    min_silence=st.integers(1, 4),
    min_speech=st.integers(1, 4),
)
def test_batch_segmenter_equals_scalar_segmenter_property(seed, n_streams, n_chunks, slab,
                                                          min_silence, min_speech):
    rng = np.random.default_rng(seed)
    probs = _grid(n_streams, n_chunks, seed=seed)
    valid = rng.integers(0, n_chunks + 1, size=n_streams)
    kw = dict(min_silence_chunks=min_silence, min_speech_chunks=min_speech)
    got = _port_segments(probs, kw, valid=valid, slab=slab)
    assert got == _scalar(probs, kw, valid)
