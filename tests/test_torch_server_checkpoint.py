"""The port's server checkpoints (vadc_tpu_torch/server.py: save_checkpoint,
restore_checkpoint, --resume) on the CPU, against the JAX server's
(vadc_tpu.server.VadServer(..., shard=False)).

The checkpoint cases of tests/test_server.py: drain, save, restart and the
uninterrupted run's lines with a segment held pending at the save; unsent
output re-delivered after a restore; the v5 context column carried. Then
what is the port's own: warmup after a restore keeps the state bit for bit;
a checkpoint of another family or slot count is refused; the server's
bytes are the JAX server's for the same state; a checkpoint saved by
either package's server resumes in the other's with the uninterrupted run's
lines, byte for byte; --resume on the command line. A server whose slots
are sharded over CPU devices saves the unsharded server's bytes, and either
kind resumes the other's checkpoint with the uninterrupted run's lines.

Segment lines are compared byte for byte and restored state bit for bit
(the container is float32 both ways); no bound is needed. No test may hang:
every socket has a timeout, every server is stopped in `finally`.
"""

import socket
import time

import numpy as np
import pytest
import torch

from tests.test_torch_server import (  # noqa: F401 - jax_server, v5_archive: fixtures
    SOCKET_TIMEOUT, _exchange, _speechlike, jax_server, serving, v5_archive,
)
from tests.torch_port_util import V31_ARCHIVE
from tests.torch_port_util import single_torch_thread  # noqa: F401
from vadc_tpu import native
from vadc_tpu.io.pcm import f32_to_s16le
from vadc_tpu_torch.engine.checkpoint import EngineCheckpoint
from vadc_tpu_torch.server import VadServer, main

pytestmark = pytest.mark.skipif(not native.available(), reason="native library unavailable")

CHUNK_BYTES = 1536 * 2
DRAIN_TIMEOUT = 120.0


@pytest.fixture(scope="module")
def split_audio():
    """tests/test_server.py's stream of two bursts, split mid-silence after
    the first segment closed, on a chunk boundary: (whole, part 1, part 2)."""
    sil = (np.random.default_rng(1).normal(size=24000) * 0.001).astype(np.float32)
    burst = _speechlike(2.0)
    pcm = f32_to_s16le(np.concatenate([sil[:16000], burst, sil, burst, sil[:16000]]))
    cut = (len(pcm) // 2 // CHUNK_BYTES) * CHUNK_BYTES
    return pcm, pcm[:cut], pcm[cut:]


@pytest.fixture(scope="module")
def uninterrupted(split_audio):
    """The port server's lines for the whole stream, in one connection."""
    srv = VadServer(port=0, max_streams=1, model=str(V31_ARCHIVE), device="cpu")
    with serving(srv) as port:
        lines = _exchange(port, split_audio[0])
    assert lines.count(b"\n") == 2, lines
    return lines


def _port_server(model=str(V31_ARCHIVE), max_streams=1):
    return VadServer(port=0, max_streams=max_streams, model=model, device="cpu")


def _part1_and_save(srv, part1: bytes, path, slot: int = 0) -> bytes:
    """Stream part 1 into `slot` (the first a fresh server hands out: its
    last) with the connection held open, wait until every chunk is through
    and the closed segment is held pending, save the checkpoint while the
    server runs, then stop it. Returns what the client received before the
    stop."""
    n_chunks = len(part1) // CHUNK_BYTES
    with serving(srv) as port:
        a = socket.create_connection(("127.0.0.1", port), timeout=SOCKET_TIMEOUT)
        try:
            a.sendall(part1)
            deadline = time.monotonic() + DRAIN_TIMEOUT
            while time.monotonic() < deadline:
                s = srv.slots[slot]
                if int(srv.fsm.chunk_index[slot]) >= n_chunks and s is not None and s.pending:
                    break
                time.sleep(0.02)
            s = srv.slots[slot]
            assert s is not None and s.pending is not None, (
                "segment 1 must be closed and held pending at the save point")
            srv.save_checkpoint(path)
        finally:
            a.setblocking(False)
            got = b""
            try:
                while chunk := a.recv(4096):
                    got += chunk
            except BlockingIOError:
                pass
            a.close()
    return got


def _resume_part2(srv, part2: bytes, path) -> bytes:
    srv.restore_checkpoint(path)
    with serving(srv) as port:
        return _exchange(port, part2)


def test_server_checkpoint_resume(split_audio, uninterrupted, tmp_path):
    """Drain, save, restart, restore: the reconnecting client's lines are the
    uninterrupted run's, including the segment closed before the save and
    held pending across the restart."""
    _, part1, part2 = split_audio
    path = tmp_path / "server.ckpt"
    before = _part1_and_save(_port_server(), part1, path)
    assert before == b""  # segment 1 was held pending, not sent
    ckpt = EngineCheckpoint.load(path)
    assert ckpt.pending[0] is not None and int(ckpt.chunk_indices[0]) == len(part1) // CHUNK_BYTES
    assert _resume_part2(_port_server(), part2, path) == uninterrupted


def test_restore_redelivers_unsent_output(tmp_path):
    """Lines rendered but still backpressured at the save are re-delivered
    to the reconnecting client after a restore."""
    path = tmp_path / "server.ckpt"
    srv0 = _port_server()
    try:
        srv0.save_checkpoint(path)
    finally:
        srv0.pool.close()
    ckpt = EngineCheckpoint.load(path)
    ckpt.sendbuf = [b"0.50,1.00\n"]
    ckpt.save(path)
    sil = f32_to_s16le((np.random.default_rng(3).normal(size=16000) * 0.001).astype(np.float32))
    # silence: the only output is the re-delivery
    assert _resume_part2(_port_server(), sil, path) == b"0.50,1.00\n"


def test_restore_requeues_a_partial_head_line_whole():
    """The saved bytes may start with the unsent suffix of a line cut
    mid-send: it is re-queued as one entry, and every whole line as its
    own."""
    srv = _port_server(max_streams=2)
    try:
        srv._resume_slots[1] = (5, 9)
        srv._resume_sendbuf[1] = b",5.12\n6.98,10.21\n"
        from vadc_tpu_torch.server import _Slot

        a, b = socket.socketpair()
        try:
            with srv._lock:
                srv.slots[1] = _Slot(a)
                srv._continue_slot(1)
            s = srv.slots[1]
            assert s.pending == (5, 9)
            assert [line for line, _t in s.outbox] == [b",5.12\n", b"6.98,10.21\n"]
            assert not srv._resume_slots and not srv._resume_sendbuf
            assert srv._reset_requests == []
        finally:
            a.close()
            b.close()
    finally:
        srv.pool.close()


def _random_state(srv, seed: int):
    rng = np.random.default_rng(seed)
    st = srv.state
    h = rng.normal(size=tuple(st.h.shape)).astype(np.float32)
    c = rng.normal(size=tuple(st.c.shape)).astype(np.float32)
    ctx = (None if st.context is None
           else rng.normal(size=tuple(st.context.shape)).astype(np.float32))
    return h, c, ctx


def _put_state(srv, state) -> None:
    h, c, ctx = state
    srv.state.h.copy_(torch.from_numpy(h))
    srv.state.c.copy_(torch.from_numpy(c))
    if ctx is not None:
        srv.state.context.copy_(torch.from_numpy(ctx))


def _assert_state(srv, state) -> None:
    h, c, ctx = state
    assert torch.equal(srv.state.h, torch.from_numpy(h))
    assert torch.equal(srv.state.c, torch.from_numpy(c))
    if ctx is not None:
        assert torch.equal(srv.state.context, torch.from_numpy(ctx))


def test_server_checkpoint_saves_v5_context(v5_archive, jax_server, tmp_path):
    """Save and restore carry the v5 context column bit for bit (in the
    port's server, and in the JAX server from the port's file)."""
    srv = _port_server(model=v5_archive, max_streams=2)
    srv2 = _port_server(model=v5_archive, max_streams=2)
    js = jax_server(port=0, max_streams=2, model=v5_archive, shard=False)
    try:
        assert srv.state.context is not None
        state = _random_state(srv, 5)
        _put_state(srv, state)
        srv.fsm.chunk_index[:] = [3, 7]
        path = tmp_path / "srv.ckpt"
        srv.save_checkpoint(path)
        srv2.restore_checkpoint(path)
        _assert_state(srv2, state)
        assert list(srv2.fsm.chunk_index[:2]) == [3, 7]
        assert sorted(srv2._resume_slots) == [0, 1]
        js.restore_checkpoint(str(path))
        np.testing.assert_array_equal(np.asarray(js.state.context), state[2])
        np.testing.assert_array_equal(np.asarray(js.state.h), state[0])
    finally:
        for s in (srv, srv2, js):
            s.pool.close()


@pytest.mark.parametrize("family", ["v3", "v5"])
def test_warmup_after_restore_keeps_the_state(family, v5_archive, tmp_path):
    """serve_forever's warmup (an all-idle tick and catch-up tick) after a
    restore leaves the restored state, the FSM arrays and the continuation
    markers as they were, bit for bit."""
    model = str(V31_ARCHIVE) if family == "v3" else v5_archive
    src, srv = _port_server(model, 3), _port_server(model, 3)
    try:
        state = _random_state(src, 9)
        _put_state(src, state)
        src.fsm.chunk_index[:] = [0, 12, 40]
        src.fsm.triggered[:] = [0, 1, 0]
        src.fsm.speech_start[:] = [0, 9, 0]
        src._resume_slots[2] = (30, 35)  # a pending still held from a restore
        path = tmp_path / "srv.ckpt"
        src.save_checkpoint(path)
        srv.restore_checkpoint(path)
        srv.warmup()
        _assert_state(srv, state)
        assert srv.tick_count == 2
        assert srv.fsm.chunk_index.tolist() == [0, 12, 40]
        assert srv.fsm.triggered.tolist() == [0, 1, 0]
        assert srv.fsm.speech_start.tolist() == [0, 9, 0]
        assert srv._resume_slots == {1: None, 2: (30, 35)}
    finally:
        src.pool.close()
        srv.pool.close()


@pytest.mark.parametrize("saved,served,message", [
    (("v3", 2), ("v5", 2), "checkpoint family 'v3' != server 'v5'"),
    (("v3", 2), ("v3", 4), "checkpoint of 2 slots != server's 4"),
])
def test_restore_refuses_another_family_or_slot_count(saved, served, message, v5_archive,
                                                      tmp_path):
    models = {"v3": str(V31_ARCHIVE), "v5": v5_archive}
    src = _port_server(models[saved[0]], saved[1])
    srv = _port_server(models[served[0]], served[1])
    try:
        path = tmp_path / "srv.ckpt"
        src.save_checkpoint(path)
        before = [x.clone() for x in (srv.state.h, srv.state.c)]
        with pytest.raises(ValueError) as e:
            srv.restore_checkpoint(path)
        assert message in str(e.value) and "\n" not in str(e.value)
        assert torch.equal(srv.state.h, before[0]) and torch.equal(srv.state.c, before[1])
        assert not srv._resume_slots
    finally:
        src.pool.close()
        srv.pool.close()


@pytest.mark.parametrize("family", ["v3", "v5"])
def test_save_checkpoint_writes_the_jax_servers_bytes(family, v5_archive, jax_server, tmp_path):
    """For the same state, FSM arrays, held pendings and unsent bytes, the
    port's server writes the JAX server's checkpoint byte for byte."""
    import jax.numpy as jnp

    from vadc_tpu.engine.runner import StreamState

    model = str(V31_ARCHIVE) if family == "v3" else v5_archive
    ts = _port_server(model, 3)
    js = jax_server(port=0, max_streams=3, model=model, shard=False)
    try:
        state = _random_state(ts, 21)
        _put_state(ts, state)
        h, c, ctx = state
        js.state = StreamState(jnp.asarray(h), jnp.asarray(c),
                               None if ctx is None else jnp.asarray(ctx))
        for srv in (ts, js):
            srv.fsm.chunk_index[:] = [4, 0, 77]
            srv.fsm.triggered[:] = [1, 0, 0]
            srv.fsm.speech_start[:] = [2, 0, 0]
            srv.fsm.temp_end[:] = [3, 0, 0]
            srv._resume_slots.update({0: (1, 2), 2: None})
            srv._resume_sendbuf[2] = b"4.10,5.00\n"
        ts.save_checkpoint(tmp_path / "port.ckpt")
        js.save_checkpoint(str(tmp_path / "jax.ckpt"))
        assert (tmp_path / "port.ckpt").read_bytes() == (tmp_path / "jax.ckpt").read_bytes()
    finally:
        ts.pool.close()
        js.pool.close()


def test_jax_checkpoint_resumes_in_the_port(split_audio, uninterrupted, jax_server, tmp_path):
    """The JAX server saves after part 1; the port's server restores and
    serves part 2: the uninterrupted run's lines (which are the JAX
    server's too)."""
    whole, part1, part2 = split_audio
    js = jax_server(port=0, max_streams=1, model=str(V31_ARCHIVE), shard=False)
    path = tmp_path / "jax.ckpt"
    assert _part1_and_save(js, part1, str(path)) == b""
    assert _resume_part2(_port_server(), part2, path) == uninterrupted
    js_whole = jax_server(port=0, max_streams=1, model=str(V31_ARCHIVE), shard=False)
    with serving(js_whole) as port:
        assert _exchange(port, whole) == uninterrupted


def test_port_checkpoint_resumes_in_jax(split_audio, uninterrupted, jax_server, tmp_path):
    """The port's server saves after part 1; the JAX server restores and
    serves part 2: the uninterrupted run's lines."""
    _, part1, part2 = split_audio
    path = tmp_path / "port.ckpt"
    assert _part1_and_save(_port_server(), part1, path) == b""
    js = jax_server(port=0, max_streams=1, model=str(V31_ARCHIVE), shard=False)
    assert _resume_part2(js, part2, str(path)) == uninterrupted


def test_main_resumes_a_checkpoint(tmp_path, monkeypatch):
    """`--device cpu --resume CKPT` builds the server, restores the file and
    serves: the saved slots are marked for continuation, the state is the
    saved one."""
    src = _port_server(max_streams=2)
    try:
        state = _random_state(src, 4)
        _put_state(src, state)
        src.fsm.chunk_index[:] = [0, 31]
        path = tmp_path / "srv.ckpt"
        src.save_checkpoint(path)
    finally:
        src.pool.close()
    served = []
    monkeypatch.setattr(VadServer, "serve_forever", lambda self: served.append(self))
    assert main(["--device", "cpu", "--port", "0", "--max_streams", "2",
                 "--resume", str(path)]) == 0
    (srv,) = served
    try:
        _assert_state(srv, state)
        assert srv._resume_slots == {1: None} and srv.fsm.chunk_index.tolist() == [0, 31]
    finally:
        srv.pool.close()


@pytest.mark.parametrize("content,message", [
    (b"not a checkpoint", "unsupported version"),
    (None, "checkpoint of 2 slots != server's 3"),
])
def test_main_resume_of_a_bad_checkpoint_exits_1(content, message, tmp_path, capsys):
    """A file that is no checkpoint, or one of another slot count: exit 1
    with one `Error:` line, before serving."""
    path = tmp_path / "srv.ckpt"
    if content is None:
        src = _port_server(max_streams=2)
        try:
            src.save_checkpoint(path)
        finally:
            src.pool.close()
    else:
        path.write_bytes(content)
    assert main(["--device", "cpu", "--port", "0", "--max_streams", "3",
                 "--resume", str(path)]) == 1
    err = capsys.readouterr().err
    assert err.startswith("Error: --resume") and message in err and err.count("\n") == 1


def _sharded_server(model=str(V31_ARCHIVE), max_streams=2, devices=2):
    return VadServer(port=0, max_streams=max_streams, model=model, devices=["cpu"] * devices)


@pytest.mark.parametrize("family", ["v3", "v5"])
def test_sharded_server_saves_the_unsharded_bytes(family, v5_archive, tmp_path):
    """The same state, FSM arrays, held pendings and unsent bytes restored
    into a server sharded over two CPU devices: its save is the unsharded
    server's file byte for byte, each shard holding its rows."""
    model = str(V31_ARCHIVE) if family == "v3" else v5_archive
    plain, sharded = _port_server(model, 4), _sharded_server(model, 4)
    try:
        assert len(sharded._shards) == 2 and len(plain._shards) == 1
        state = _random_state(plain, 31)
        _put_state(plain, state)
        plain.fsm.chunk_index[:] = [4, 0, 77, 9]
        plain.fsm.triggered[:] = [1, 0, 0, 1]
        plain._resume_slots.update({0: (1, 2), 3: None})
        plain._resume_sendbuf[3] = b"4.10,5.00\n"
        plain.save_checkpoint(tmp_path / "plain.ckpt")
        sharded.restore_checkpoint(tmp_path / "plain.ckpt")
        h, c, _ = state
        assert torch.equal(sharded._shards[1].state.h, torch.from_numpy(h[:, 2:]))
        assert torch.equal(sharded.state.c, torch.from_numpy(c))
        sharded.save_checkpoint(tmp_path / "sharded.ckpt")
        assert (tmp_path / "sharded.ckpt").read_bytes() == (tmp_path / "plain.ckpt").read_bytes()
    finally:
        plain.pool.close()
        sharded.pool.close()


@pytest.mark.parametrize("first,second", [("sharded", "plain"), ("plain", "sharded")])
def test_resume_across_sharded_and_unsharded(first, second, split_audio, uninterrupted, tmp_path):
    """Part 1 into one kind of 2-slot server (its client on slot 1, the
    first handed out; on the second shard when sharded), save, part 2 from
    a fresh server of the other kind: the uninterrupted run's lines."""
    _, part1, part2 = split_audio
    make = {"sharded": _sharded_server, "plain": lambda: _port_server(max_streams=2)}
    path = tmp_path / f"{first}.ckpt"
    assert _part1_and_save(make[first](), part1, path, slot=1) == b""
    assert EngineCheckpoint.load(path).pending[1] is not None
    assert _resume_part2(make[second](), part2, path) == uninterrupted
