"""The port's checkpoint container (vadc_tpu_torch/engine/checkpoint.py)
against the JAX package's (vadc_tpu/engine/checkpoint.py) on the CPU.

The cases of tests/test_checkpoint.py, each run in both packages on the
same seeded inputs. The container is integer and byte logic: for the same
state the port writes the JAX package's bytes exactly, each package loads
the other's checkpoints with the arrays equal, segments are equal, and a
resumed stream continues bit for bit within a package. Where the two
packages' models compute a state, the state is held at the whole-model
bounds of tests/test_torch_fused_audio.py: probabilities 1e-4, (h, c) 3e-4
(v5, synthetic weights: 1e-5 and 5e-5, those of tests/test_torch_v5.py).

test_sharded_checkpoint_resume_on_mesh runs on the port's
MultiHostStreamEngine over eight CPU devices, and
test_checkpoint_refuses_nonaddressable_state on a state marked as one
process's slice; a one-process `save_sharded` file holds the bytes of the
JAX package's for the same state and segmenter.
"""

import numpy as np
import pytest
import torch

from tests.conftest import assert_close
from tests.torch_port_util import jax_and_port_params, to_torch
from tests.torch_port_util import single_torch_thread  # noqa: F401
from vadc_tpu import native
from vadc_tpu.engine import checkpoint as J
from vadc_tpu_torch.engine import checkpoint as T

TOL = {"v3": (1e-4, 3e-4), "v5": (1e-5, 5e-5)}


@pytest.fixture(scope="module")
def v31():
    return jax_and_port_params()


@pytest.fixture(scope="module")
def v5():
    """(JAX params, the port's) of the synthetic v5 archive of seed 0."""
    from vadc_tpu.models.silero_v5 import silero_v5_params as j_params
    from vadc_tpu.models.synthetic import random_v5_archive
    from vadc_tpu_torch.models.weights import silero_v5_params as t_params

    archive = random_v5_archive(0)
    return j_params(archive), t_params(archive)


def _runners(family: str, jp, tp):
    from vadc_tpu.engine.runner import StreamRunner as JRunner
    from vadc_tpu_torch.engine.runner import StreamRunner as TRunner

    return JRunner(family, jp), TRunner(family, tp, device="cpu")


def _scan_both(family, params, chunks):
    """The final state of both packages' StreamRunner.scan over `chunks`
    [B, T, S] from the initial state."""
    import jax.numpy as jnp

    jr, tr = _runners(family, *params)
    _, sj = jr.scan(jnp.asarray(chunks), jr.init_state(chunks.shape[0]))
    _, st = tr.scan(to_torch(chunks), tr.init_state(chunks.shape[0]))
    return sj, st


def test_roundtrip_v3(v31):
    chunks = (np.random.default_rng(0).normal(size=(3, 2, 1536)) * 0.1).astype(np.float32)
    sj, st = _scan_both("v3", v31, chunks)
    from vadc_tpu.engine.vectorized_segmenter import init_fsm_state as j_fsm
    from vadc_tpu_torch.engine.vectorized_segmenter import init_fsm_state as t_fsm

    back_j = J.EngineCheckpoint.from_bytes(
        J.EngineCheckpoint("v3", sj, j_fsm(3), chunk_index=2).to_bytes())
    back = T.EngineCheckpoint.from_bytes(
        T.EngineCheckpoint("v3", st, t_fsm(3), chunk_index=2).to_bytes())
    assert back.family == back_j.family == "v3"
    assert back.chunk_index == back_j.chunk_index == 2
    assert back.fsm_state.chunk_index == 2 and isinstance(back.fsm_state.chunk_index, int)
    assert torch.equal(back.model_state.h, st.h) and torch.equal(back.model_state.c, st.c)
    assert back.model_state.context is None and back_j.model_state.context is None
    assert_close(back.model_state.h, np.asarray(back_j.model_state.h), TOL["v3"][1], "h")
    assert_close(back.model_state.c, np.asarray(back_j.model_state.c), TOL["v3"][1], "c")


def test_resume_continues_identically(v31, tmp_path):
    """Within the port: 2 chunks, checkpoint to disk, reload, 2 more equal
    the last 2 of the straight run bit for bit; against the JAX package's
    resumed probabilities within 1e-4."""
    import jax.numpy as jnp

    jr, tr = _runners("v3", *v31)
    chunks = (np.random.default_rng(1).normal(size=(2, 4, 1536)) * 0.1).astype(np.float32)
    probs_full, _ = tr.scan(to_torch(chunks), tr.init_state(2))
    _, mid = tr.scan(to_torch(chunks[:, :2]), tr.init_state(2))
    path = tmp_path / "state.ckpt"
    T.EngineCheckpoint("v3", mid, chunk_index=2).save(path)
    resumed = T.EngineCheckpoint.load(path)
    probs_rest, _ = tr.scan(to_torch(chunks[:, 2:]), resumed.model_state)
    assert torch.equal(probs_full[:, 2:], probs_rest)

    _, mid_j = jr.scan(jnp.asarray(chunks[:, :2]), jr.init_state(2))
    J.EngineCheckpoint("v3", mid_j, chunk_index=2).save(tmp_path / "jax.ckpt")
    rest_j, _ = jr.scan(jnp.asarray(chunks[:, 2:]),
                        J.EngineCheckpoint.load(tmp_path / "jax.ckpt").model_state)
    assert_close(probs_rest, np.asarray(rest_j), TOL["v3"][0], "resumed probs")


def test_v5_context_roundtrip(v5):
    chunks = (np.random.default_rng(2).normal(size=(2, 3, 512)) * 0.1).astype(np.float32)
    sj, st = _scan_both("v5", v5, chunks)
    back = T.EngineCheckpoint.from_bytes(T.EngineCheckpoint("v5", st, chunk_index=3).to_bytes())
    assert torch.equal(back.model_state.context, st.context)
    # the context is the last raw samples, the same in both packages
    np.testing.assert_array_equal(back.model_state.context.numpy(), np.asarray(sj.context))
    assert_close(back.model_state.h, np.asarray(sj.h), TOL["v5"][1], "v5 h")


def _speech_probs():
    """tests/test_checkpoint.py's script: TWO raw segments whose padded
    ranges merge (chunks 2-7 speech, 8-11 silence closes segment 1, which is
    then held pending; 12-17 speech, silence to the end)."""
    probs = np.zeros(30, np.float32)
    probs[2:8] = 0.9
    probs[12:18] = 0.9
    return probs


def test_segmenter_resume_between_close_and_merge():
    """Stopping after a segment closed (held as the pending merge
    candidate) and before the next arrives neither drops nor double-emits
    the held segment; the port's copy of the Segmenter gives the JAX
    package's segments and state."""
    from vadc_tpu.cli import segmenter as js
    from vadc_tpu_torch.cli import segmenter as ts

    probs = _speech_probs()
    results = {}
    for name, mod in (("jax", js), ("port", ts)):
        cfg = mod.SegmenterConfig(speech_pad_s=0.3)  # wide pad: the two merge
        ref = mod.Segmenter(cfg)
        expected = [s for p in probs for s in ref.feed(float(p))] + list(ref.finish())
        first = mod.Segmenter(cfg)
        got = [s for p in probs[:11] for s in first.feed(float(p))]
        state = first.state_dict()
        assert state["pending"] is not None, "the test must stop with a held segment"
        second = mod.Segmenter(cfg)
        second.load_state_dict(state)
        got += [s for p in probs[11:] for s in second.feed(float(p))] + list(second.finish())
        assert len(expected) == 1 and got == expected
        results[name] = (got, state)
    assert results["port"] == results["jax"]


def test_segmenter_state_dict_roundtrip_fields():
    from vadc_tpu.cli import segmenter as js
    from vadc_tpu_torch.cli import segmenter as ts

    dicts = {}
    for name, mod in (("jax", js), ("port", ts)):
        seg = mod.Segmenter(mod.SegmenterConfig())
        for p in [0.9, 0.9, 0.9, 0.9, 0.1, 0.1]:
            list(seg.feed(p))
        d = seg.state_dict()
        other = mod.Segmenter(mod.SegmenterConfig())
        other.load_state_dict(d)
        assert other.state == seg.state
        assert other.chunk_index == seg.chunk_index
        assert other._pending == seg._pending
        dicts[name] = d
    assert dicts["port"] == dicts["jax"]


def _backend_or_skip(backend):
    if backend == "native" and not native.available():
        pytest.skip("native library not built")


@pytest.mark.parametrize("first_slab", [11, 4])
@pytest.mark.parametrize("jax_backend", ["device", "native"])
def test_batch_segmenter_checkpoint_mid_stream(jax_backend, first_slab):
    """BatchSegmenter: the accumulated raw segments and the FSM fields
    survive a save and restore, the first 11 columns fed as one slab or in
    slabs of 4 (then two readbacks are still deferred at the capture); the
    resumed output equals the uninterrupted run, including a segment closed
    before the stop that merges with one closed after, and equals the JAX
    package's on either of its backends. The capture holds the bytes of the
    JAX package's device-backend capture."""
    import jax.numpy as jnp

    from vadc_tpu.cli.segmenter import SegmenterConfig as JConfig
    from vadc_tpu.engine.runner import init_stream_state as j_state
    from vadc_tpu.engine.vectorized_segmenter import BatchSegmenter as JSeg
    from vadc_tpu_torch.cli.segmenter import SegmenterConfig
    from vadc_tpu_torch.engine.runner import init_stream_state
    from vadc_tpu_torch.engine.vectorized_segmenter import PENDING_SLABS, BatchSegmenter

    _backend_or_skip(jax_backend)
    probs = np.stack([_speech_probs(), _speech_probs()[::-1].copy()])
    cfg = SegmenterConfig(speech_pad_s=0.3)

    def make():
        return BatchSegmenter(cfg, 2, device="cpu")

    ref = make()
    ref.feed(probs)
    expected = ref.finish()

    first = make()
    offsets = range(0, 11, first_slab)
    for off in offsets:
        first.feed(probs[:, off : min(off + first_slab, 11)])
    assert len(first._pending) == min(len(offsets), PENDING_SLABS)
    ckpt = T.EngineCheckpoint.capture("v3", init_stream_state("v3", 2), first)
    assert any(ckpt.raw_segments), "the test must stop with an accumulated raw segment"
    restored = T.EngineCheckpoint.from_bytes(ckpt.to_bytes())
    second = make()
    restored.restore_segmenter(second)
    second.feed(probs[:, 11:])
    assert second.finish() == expected

    jfirst = JSeg(JConfig(speech_pad_s=0.3), 2, backend="device")
    jfirst.feed(jnp.asarray(probs[:, :11]))
    jckpt = J.EngineCheckpoint.capture("v3", j_state("v3", 2), jfirst)
    assert ckpt.to_bytes() == jckpt.to_bytes()
    jref = JSeg(JConfig(speech_pad_s=0.3), 2, backend=jax_backend)
    jref.feed(jnp.asarray(probs))
    assert expected == jref.finish()


@pytest.mark.parametrize("jax_backend", ["device", "native"])
def test_segmenter_checkpoint_crosses_packages(jax_backend):
    """A BatchSegmenter captured in one package (the JAX package's on either
    backend) resumes in the other's and finishes with the uninterrupted
    run's segments, both ways."""
    import jax.numpy as jnp

    from vadc_tpu.cli.segmenter import SegmenterConfig as JConfig
    from vadc_tpu.engine.runner import init_stream_state as j_state
    from vadc_tpu.engine.vectorized_segmenter import BatchSegmenter as JSeg
    from vadc_tpu_torch.cli.segmenter import SegmenterConfig
    from vadc_tpu_torch.engine.runner import init_stream_state
    from vadc_tpu_torch.engine.vectorized_segmenter import BatchSegmenter

    _backend_or_skip(jax_backend)
    probs = np.stack([_speech_probs(), _speech_probs()[::-1].copy()])
    jref = JSeg(JConfig(speech_pad_s=0.3), 2, backend=jax_backend)
    jref.feed(jnp.asarray(probs))
    expected = jref.finish()

    jfirst = JSeg(JConfig(speech_pad_s=0.3), 2, backend=jax_backend)
    jfirst.feed(jnp.asarray(probs[:, :11]))
    data = J.EngineCheckpoint.capture("v3", j_state("v3", 2), jfirst).to_bytes()
    port = BatchSegmenter(SegmenterConfig(speech_pad_s=0.3), 2, device="cpu")
    T.EngineCheckpoint.from_bytes(data).restore_segmenter(port)
    port.feed(probs[:, 11:])
    assert port.finish() == expected

    first = BatchSegmenter(SegmenterConfig(speech_pad_s=0.3), 2, device="cpu")
    first.feed(probs[:, :11])
    data = T.EngineCheckpoint.capture("v3", init_stream_state("v3", 2), first).to_bytes()
    jsecond = JSeg(JConfig(speech_pad_s=0.3), 2, backend=jax_backend)
    J.EngineCheckpoint.from_bytes(data).restore_segmenter(jsecond)
    jsecond.feed(jnp.asarray(probs[:, 11:]))
    assert jsecond.finish() == expected


def _full_state(family: str, seed: int):
    """Seeded numpy arrays of every field a checkpoint can hold."""
    rng = np.random.default_rng(seed)
    layers, hidden = (2, 64) if family == "v3" else (1, 128)
    b = 5
    return {
        "h": rng.normal(size=(layers, b, hidden)).astype(np.float32),
        "c": rng.normal(size=(layers, b, hidden)).astype(np.float32),
        "context": None if family == "v3" else rng.normal(size=(b, 64)).astype(np.float32),
        "triggered": rng.integers(0, 2, size=b).astype(bool),
        "speech_start": rng.integers(0, 5000, size=b).astype(np.int32),
        "temp_end": rng.integers(0, 5000, size=b).astype(np.int32),
        "chunk_index": 5017,
        "chunk_indices": rng.integers(0, 5018, size=b).astype(np.int32),
        "raw_segments": [[], [(3, 9)], [(1, 4), (20, 31)], [], [(7, 8)]],
        "pending": [None, (5, 9), None, (0, 2), (40, 77)],
        "sendbuf": [b"", b"1.99,5.12\n6.98,10.21\n", b",5.12\n", b"", b"0.50,1.00\n"],
    }


def _jax_ckpt(family: str, f: dict):
    import jax.numpy as jnp

    from vadc_tpu.engine.runner import StreamState
    from vadc_tpu.engine.vectorized_segmenter import FsmState

    ctx = None if f["context"] is None else jnp.asarray(f["context"])
    return J.EngineCheckpoint(
        family, StreamState(jnp.asarray(f["h"]), jnp.asarray(f["c"]), ctx),
        FsmState(jnp.asarray(f["triggered"]), jnp.asarray(f["speech_start"]),
                 jnp.asarray(f["temp_end"]), jnp.int32(f["chunk_index"])),
        chunk_index=f["chunk_index"], raw_segments=f["raw_segments"], pending=f["pending"],
        chunk_indices=f["chunk_indices"], sendbuf=f["sendbuf"])


def _port_ckpt(family: str, f: dict):
    from vadc_tpu_torch.engine.runner import StreamState
    from vadc_tpu_torch.engine.vectorized_segmenter import FsmState

    ctx = None if f["context"] is None else torch.from_numpy(f["context"])
    return T.EngineCheckpoint(
        family, StreamState(torch.from_numpy(f["h"]), torch.from_numpy(f["c"]), ctx),
        FsmState(torch.from_numpy(f["triggered"]), torch.from_numpy(f["speech_start"]),
                 torch.from_numpy(f["temp_end"]), f["chunk_index"]),
        chunk_index=f["chunk_index"], raw_segments=f["raw_segments"], pending=f["pending"],
        chunk_indices=f["chunk_indices"], sendbuf=f["sendbuf"])


@pytest.mark.parametrize("family", ["v3", "v5"])
def test_to_bytes_equals_the_jax_packages(family):
    """For the same state, with every optional field, the port's bytes are
    the JAX package's; with only the required ones too."""
    from vadc_tpu.engine.runner import StreamState as JState
    from vadc_tpu_torch.engine.runner import StreamState

    f = _full_state(family, seed=11)
    assert _port_ckpt(family, f).to_bytes() == _jax_ckpt(family, f).to_bytes()
    j = _jax_ckpt(family, f)
    t = _port_ckpt(family, f)
    bare_j = J.EngineCheckpoint(family, JState(j.model_state.h, j.model_state.c,
                                               j.model_state.context))
    bare_t = T.EngineCheckpoint(family, StreamState(t.model_state.h, t.model_state.c,
                                                    t.model_state.context))
    assert bare_t.to_bytes() == bare_j.to_bytes()


def _assert_same_fields(a, b) -> None:
    """Every field of two checkpoints (either package) equal."""
    host = lambda x: None if x is None else np.asarray(  # noqa: E731
        x.numpy() if isinstance(x, torch.Tensor) else x)
    assert a.family == b.family and a.chunk_index == b.chunk_index
    for name in ("h", "c", "context"):
        x, y = host(getattr(a.model_state, name)), host(getattr(b.model_state, name))
        assert (x is None) == (y is None)
        if x is not None:
            assert x.dtype == y.dtype == np.float32
            np.testing.assert_array_equal(x, y)
    for name in ("triggered", "speech_start", "temp_end"):
        x, y = host(getattr(a.fsm_state, name)), host(getattr(b.fsm_state, name))
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)
    assert int(a.fsm_state.chunk_index) == int(b.fsm_state.chunk_index)
    np.testing.assert_array_equal(a.chunk_indices, b.chunk_indices)
    assert a.raw_segments == b.raw_segments
    assert a.pending == b.pending
    assert a.sendbuf == b.sendbuf


@pytest.mark.parametrize("family", ["v3", "v5"])
def test_checkpoints_load_across_packages(family, tmp_path):
    """A JAX checkpoint loaded by the port, and a port checkpoint loaded by
    JAX: every field equal to the state saved, in either package."""
    f = _full_state(family, seed=12)
    J.EngineCheckpoint.save(_jax_ckpt(family, f), tmp_path / "jax.ckpt")
    _port_ckpt(family, f).save(tmp_path / "port.ckpt")
    port_of_jax = T.EngineCheckpoint.load(tmp_path / "jax.ckpt")
    jax_of_port = J.EngineCheckpoint.load(tmp_path / "port.ckpt")
    _assert_same_fields(port_of_jax, _port_ckpt(family, f))
    _assert_same_fields(jax_of_port, _jax_ckpt(family, f))
    _assert_same_fields(port_of_jax, jax_of_port)
    assert port_of_jax.model_state.h.device.type == "cpu"


def test_pending_segments_roundtrip():
    from vadc_tpu.engine.runner import init_stream_state as j_state
    from vadc_tpu_torch.engine.runner import init_stream_state

    kw = dict(pending=[None, (5, 9), (0, 2)], chunk_indices=np.asarray([7, 9, 11], np.int32))
    back = T.EngineCheckpoint.from_bytes(
        T.EngineCheckpoint("v3", init_stream_state("v3", 3), **kw).to_bytes())
    back_j = J.EngineCheckpoint.from_bytes(
        J.EngineCheckpoint("v3", j_state("v3", 3), **kw).to_bytes())
    assert back.pending == back_j.pending == [None, (5, 9), (0, 2)]
    np.testing.assert_array_equal(back.chunk_indices, [7, 9, 11])
    np.testing.assert_array_equal(back.chunk_indices, back_j.chunk_indices)


def test_sendbuf_roundtrip():
    """Rendered but unsent serving output bytes survive the container,
    including empty slots and a partial-line suffix; an absent field stays
    absent."""
    from vadc_tpu.engine.runner import init_stream_state as j_state
    from vadc_tpu_torch.engine.runner import init_stream_state

    bufs = [b"", b"1.99,5.12\n6.98,10.21\n", b",5.12\n"]  # [2]: a head suffix
    back = T.EngineCheckpoint.from_bytes(
        T.EngineCheckpoint("v3", init_stream_state("v3", 3), sendbuf=bufs).to_bytes())
    back_j = J.EngineCheckpoint.from_bytes(
        J.EngineCheckpoint("v3", j_state("v3", 3), sendbuf=bufs).to_bytes())
    assert back.sendbuf == back_j.sendbuf == bufs
    plain = T.EngineCheckpoint("v3", init_stream_state("v3", 3))
    assert T.EngineCheckpoint.from_bytes(plain.to_bytes()).sendbuf is None


@pytest.mark.parametrize("field", ["chunk_index", "chunk_indices", "pending"])
def test_checkpoint_refuses_counters_beyond_float32_exact(field):
    """The container stores integer state as float32, exact only below 2^24
    (~18.6 days of 96 ms chunks): saving past it raises, in both packages,
    instead of rounding a counter; the float payloads (model.h, model.c,
    model.context) are exempt."""
    from vadc_tpu.engine.runner import init_stream_state as j_state
    from vadc_tpu_torch.engine.runner import init_stream_state

    def kw(v):
        return {"chunk_index": {"chunk_index": v},
                "chunk_indices": {"chunk_indices": np.asarray([1, v])},
                "pending": {"pending": [None, (1, v)]}}[field]

    for mod, state in ((T, init_stream_state("v3", 2)), (J, j_state("v3", 2))):
        mod.EngineCheckpoint("v3", state, **kw(2**24 - 1)).to_bytes()  # ok
        with pytest.raises(ValueError, match="2\\^24"):
            mod.EngineCheckpoint("v3", state, **kw(2**24)).to_bytes()
    big = init_stream_state("v3", 2)
    big.h.fill_(2.0**25)
    T.EngineCheckpoint("v3", big).to_bytes()  # a float payload: no refusal


def test_shard_path_is_the_jax_packages():
    assert T.shard_path("ckpt", 0, 1) == J.shard_path("ckpt", 0, 1)
    assert T.shard_path("/tmp/x/run", 3, 4).name == "run.proc3of4.testtensor"


def test_restore_segmenter_refuses_a_checkpoint_without_fsm_state():
    from vadc_tpu_torch.cli.segmenter import SegmenterConfig
    from vadc_tpu_torch.engine.runner import init_stream_state
    from vadc_tpu_torch.engine.vectorized_segmenter import BatchSegmenter

    seg = BatchSegmenter(SegmenterConfig(), 2, device="cpu")
    with pytest.raises(ValueError, match="no segmentation state"):
        T.EngineCheckpoint("v3", init_stream_state("v3", 2)).restore_segmenter(seg)


def test_checkpoint_uses_no_private_name_of_the_segmenter():
    """engine/checkpoint.py reads and writes a BatchSegmenter only through
    its `state_dict` and `load_state_dict`: every attribute taken off a
    name annotated as a BatchSegmenter is one of the two."""
    import ast
    import inspect

    tree = ast.parse(inspect.getsource(T))
    segmenters = {
        arg.arg
        for node in ast.walk(tree) if isinstance(node, ast.FunctionDef)
        for arg in node.args.args + node.args.kwonlyargs
        if arg.annotation is not None and "BatchSegmenter" in ast.unparse(arg.annotation)
    }
    assert segmenters == {"segmenter"}
    used = {node.attr for node in ast.walk(tree)
            if isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name)
            and node.value.id in segmenters}
    assert used == {"state_dict", "load_state_dict"}, used


def test_sharded_checkpoint_resume_on_devices(v31, tmp_path):
    """tests/test_checkpoint.py's test_sharded_checkpoint_resume_on_mesh on
    the port: save and restore a MultiHostStreamEngine's state over 8 CPU
    devices by save_sharded/load_sharded; the resumed continuation equals
    the live one bit for bit, and the segmenter state rides along."""
    from vadc_tpu_torch.cli.segmenter import SegmenterConfig
    from vadc_tpu_torch.engine.distributed import MultiHostStreamEngine
    from vadc_tpu_torch.engine.vectorized_segmenter import BatchSegmenter

    engine = MultiHostStreamEngine("v3", v31[1], devices=["cpu"] * 8)
    n = 16
    rng = np.random.default_rng(4)
    head = (rng.normal(size=(n, 2, 1536)) * 0.1).astype(np.float32)
    tail = (rng.normal(size=(n, 2, 1536)) * 0.1).astype(np.float32)

    state = engine.init_state(n)
    probs, state = engine.scan(head, state)
    seg = BatchSegmenter(SegmenterConfig(), n, device="cpu")
    seg.feed(torch.from_numpy(probs))

    prefix = tmp_path / "ckpt"
    path = T.save_sharded(engine, state, prefix, segmenter=seg)
    assert path.name == "ckpt.proc0of1.testtensor"
    live, _ = engine.scan(tail, state)  # updates the state in place

    restored_state, ckpt = T.load_sharded(engine, prefix)
    assert ckpt.family == "v3" and len(restored_state.shards) == 8
    seg2 = BatchSegmenter(SegmenterConfig(), n, device="cpu")
    ckpt.restore_segmenter(seg2)
    assert seg2.state_dict()["raw_segments"] == seg.state_dict()["raw_segments"]
    resumed, _ = engine.scan(tail, restored_state)
    np.testing.assert_array_equal(resumed, live)

    # a layout mismatch is a one-line diagnosis, not a silent misassignment
    class _OtherLayout:
        process_id, n_processes = 0, 4

    with pytest.raises(FileNotFoundError, match="saved layout differs") as port_error:
        T.load_sharded(_OtherLayout(), prefix)
    with pytest.raises(FileNotFoundError) as jax_error:
        J.load_sharded(_OtherLayout(), prefix)
    assert str(port_error.value) == str(jax_error.value)


def test_checkpoint_refuses_a_state_sharded_over_processes(v31):
    """tests/test_checkpoint.py's test_checkpoint_refuses_nonaddressable_state:
    one process's slice of a state sharded over processes that reaches
    EngineCheckpoint directly raises the JAX package's pointed diagnosis,
    naming save_sharded. A state sharded over one process's devices is
    gathered and saved whole."""
    from vadc_tpu_torch.engine.shard import ShardedStreamRunner

    runner = ShardedStreamRunner("v3", v31[1], ["cpu"] * 2)
    state = runner.init_state(4)
    whole = T.EngineCheckpoint("v3", state).to_bytes()
    assert T.EngineCheckpoint.from_bytes(whole).model_state.n_streams == 4
    state.n_processes = 2
    with pytest.raises(ValueError, match="save_sharded") as port_error:
        T.EngineCheckpoint("v3", state).to_bytes()
    assert "sharded across processes" in str(port_error.value)


@pytest.mark.parametrize("family", ["v3", "v5"])
def test_save_sharded_file_is_the_jax_packages(family, v31, v5, tmp_path):
    """For the same state (from seeded arrays) and a segmenter fed the same
    probabilities (the JAX package's on its device backend), the port's
    one-process save_sharded file over 8 CPU devices holds exactly the
    bytes of the JAX package's over its 8 virtual devices."""
    import jax.numpy as jnp

    from vadc_tpu.cli.segmenter import SegmenterConfig as JConfig
    from vadc_tpu.engine.distributed import MultiHostStreamEngine as JEngine
    from vadc_tpu.engine.runner import StreamState as JState
    from vadc_tpu.engine.vectorized_segmenter import BatchSegmenter as JSegmenter
    from vadc_tpu_torch.cli.segmenter import SegmenterConfig
    from vadc_tpu_torch.engine.distributed import MultiHostStreamEngine
    from vadc_tpu_torch.engine.runner import StreamState
    from vadc_tpu_torch.engine.vectorized_segmenter import BatchSegmenter

    jp, tp = v31 if family == "v3" else v5
    n = 16
    rng = np.random.default_rng(14)
    layers, hidden = (2, 64) if family == "v3" else (1, 128)
    h = rng.normal(size=(layers, n, hidden)).astype(np.float32)
    c = rng.normal(size=(layers, n, hidden)).astype(np.float32)
    ctx = None if family == "v3" else rng.normal(size=(n, 64)).astype(np.float32)
    probs = np.zeros((n, 30), np.float32)
    probs[:, 2:8] = 0.9
    probs[::3, 12:18] = 0.9
    pending = [None if i % 4 else (i, i + 3) for i in range(n)]

    je = JEngine(family, jp)
    j_state = je.state_from_local(JState(jnp.asarray(h), jnp.asarray(c),
                                         None if ctx is None else jnp.asarray(ctx)))
    j_seg = JSegmenter(JConfig(), n, backend="device")
    j_seg.feed(jnp.asarray(probs))
    j_path = J.save_sharded(je, j_state, tmp_path / "jax", segmenter=j_seg, pending=pending)

    te = MultiHostStreamEngine(family, tp, devices=["cpu"] * 8)
    t_state = te.state_from_local(StreamState(
        torch.from_numpy(h), torch.from_numpy(c), None if ctx is None else torch.from_numpy(ctx)))
    t_seg = BatchSegmenter(SegmenterConfig(), n, device="cpu")
    t_seg.feed(torch.from_numpy(probs))
    t_path = T.save_sharded(te, t_state, tmp_path / "port", segmenter=t_seg, pending=pending)

    raw = t_seg.state_dict()["raw_segments"]
    assert any(raw) and raw == j_seg._raw
    assert t_path.name == "port.proc0of1.testtensor" and j_path.name == "jax.proc0of1.testtensor"
    assert t_path.read_bytes() == j_path.read_bytes()
