"""The port's serving daemon (vadc_tpu_torch/server.py) on the CPU.

Tick level, without sockets: the port's `_tick` and `_tick2` against the
JAX server's (`vadc_tpu.server.VadServer(..., shard=False)`) on the same
s16 batch, masks and starting state, for Silero v3.1 (bundled weights) and
v5 (synthetic weights, for the masked audio context). Bounds: v3.1
probabilities 1e-4 and (h, c) 3e-4, the whole-model bounds of
tests/test_torch_fused_audio.py (measured here: probabilities 4.5e-8, h
1.8e-5, c 3.1e-5); v5 1e-5 and 5e-5, those of tests/test_torch_v5.py
(measured: 8.3e-7, 9.6e-6, 1.2e-5). Idle slots hold their state bit for
bit, reset slots are computed from zeros.

End to end over localhost sockets: the behaviour tests of
tests/test_server.py that need no checkpoint and no second device, with
the bundled v3.1 archive; the catch-up tick's reset race; and one client's
segment lines from the port's server against the JAX server's.

No test may hang: every socket has a timeout, every thread is a daemon and
is joined with a timeout, and every server is stopped in `finally`.
"""

import contextlib
import socket
import struct
import threading
import time

import numpy as np
import pytest
import torch

from tests.conftest import assert_close
from tests.torch_port_util import DATA, V31_ARCHIVE
from tests.torch_port_util import single_torch_thread  # noqa: F401
from vadc_tpu import native
from vadc_tpu.io.pcm import f32_to_s16le
from vadc_tpu_torch.server import VadServer, _Slot, main

pytestmark = pytest.mark.skipif(not native.available(), reason="native library unavailable")

SOCKET_TIMEOUT = 60.0
JOIN_TIMEOUT = 30.0
# (probabilities, state) bounds of the tick parity against the JAX server
TICK_TOL = {"v3": (1e-4, 3e-4), "v5": (1e-5, 5e-5)}
# slot 0 active, slot 1 active and reset, slot 2 idle, slot 3 idle and
# reset; in the catch-up tick's second sub-step slots 0 and 2 are active
ACTIVE_A = np.array([True, True, False, False])
ACTIVE_B = np.array([True, False, True, False])
RESET = np.array([False, True, False, True])


def _speechlike(duration_s, f0=120.0, sr=16000):
    """tests/test_server.py's speech-like signal."""
    t = np.arange(int(duration_s * sr)) / sr
    sig = np.zeros_like(t)
    for k in range(1, 25):
        f = k * f0
        w = np.exp(-(((f - 500) / 400) ** 2)) + 0.7 * np.exp(-(((f - 1500) / 500) ** 2))
        sig += w * np.sin(2 * np.pi * f * t + k)
    sig *= 0.5 * (1 + np.sin(2 * np.pi * 3.0 * t - np.pi / 2))
    return (0.3 * sig / np.abs(sig).max()).astype(np.float32)


def _wav(pcm: bytes, rate: int) -> bytes:
    fmt = struct.pack("<HHIIHH", 1, 1, rate, rate * 2, 2, 16)
    return (b"RIFF" + struct.pack("<I", 36 + len(pcm)) + b"WAVE" + b"fmt "
            + struct.pack("<I", 16) + fmt + b"data" + struct.pack("<I", len(pcm)) + pcm)


@pytest.fixture(scope="module")
def audio() -> bytes:
    sil = (np.random.default_rng(0).normal(size=16000) * 0.001).astype(np.float32)
    return f32_to_s16le(np.concatenate([sil, _speechlike(2.0), sil]))


@pytest.fixture(scope="module")
def v5_archive(tmp_path_factory) -> str:
    from vadc_tpu.io.testtensor import save_testtensor
    from vadc_tpu_torch.models.synthetic import random_v5_archive

    path = tmp_path_factory.mktemp("v5") / "v5.testtensor"
    save_testtensor(str(path), random_v5_archive(0))
    return str(path)


@pytest.fixture(scope="module")
def jax_server():
    """The JAX server's class. Its constructor points jax's compile cache
    at VADC_TPU_CACHE_DIR (else a directory under HOME): keep it on the
    suite's own cache, and put the settings back afterwards."""
    import jax

    from vadc_tpu.server import VadServer as JaxServer

    names = ("jax_compilation_cache_dir", "jax_persistent_cache_min_compile_time_secs",
             "jax_persistent_cache_min_entry_size_bytes")
    saved = {name: getattr(jax.config, name) for name in names}
    with pytest.MonkeyPatch.context() as mp:
        if saved["jax_compilation_cache_dir"]:
            mp.setenv("VADC_TPU_CACHE_DIR", saved["jax_compilation_cache_dir"])
        yield JaxServer
    for name, value in saved.items():
        jax.config.update(name, value)


def _model(family: str, v5_archive: str) -> str:
    return str(V31_ARCHIVE) if family == "v3" else v5_archive


@contextlib.contextmanager
def serving(srv):
    """The server's accept and engine loops on a free localhost port; yields
    the port. Stops both and closes the pool on exit."""
    sock = socket.create_server(("127.0.0.1", 0))
    srv.pool.start()
    threads = [threading.Thread(target=srv._accept_loop, args=(sock,), daemon=True),
               threading.Thread(target=srv._engine_loop, daemon=True)]
    for t in threads:
        t.start()
    try:
        yield sock.getsockname()[1]
    finally:
        srv._stop.set()
        with contextlib.suppress(OSError):
            sock.shutdown(socket.SHUT_RDWR)  # wakes the blocked accept()
        sock.close()
        for t in threads:
            t.join(timeout=JOIN_TIMEOUT)
        srv.pool.close()


def _exchange(port: int, payload: bytes) -> bytes:
    """Send the payload, half-close, and read until the server closes."""
    c = socket.create_connection(("127.0.0.1", port), timeout=SOCKET_TIMEOUT)
    data = b""
    try:
        c.sendall(payload)
        c.shutdown(socket.SHUT_WR)
        while True:
            chunk = c.recv(4096)
            if not chunk:
                break
            data += chunk
    except socket.timeout:
        pass
    finally:
        c.close()
    return data


def _run_client(port: int, pcm: bytes) -> list[tuple[float, float]]:
    return [tuple(float(x) for x in line.split(","))
            for line in _exchange(port, pcm).decode().strip().splitlines()
            if line and not line.startswith("error")]


def _wait_free(srv, n: int, timeout: float = 15.0) -> None:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        with srv._lock:
            if len(srv._free) >= n:
                return
        time.sleep(0.01)
    raise AssertionError(f"slots not freed: {srv._free}")


def _one_segment(segs) -> None:
    assert len(segs) == 1, segs
    start, end = segs[0]
    assert 0.5 < start < 1.6 and 2.5 < end < 3.6, segs


# ---- ticks -----------------------------------------------------------------


def _tick_inputs(srv, seed: int):
    """Two s16 batches and a random starting state (h, c, v5 context)."""
    rng = np.random.default_rng(seed)
    n, c = srv.n, srv.chunk
    ba = (rng.normal(size=(n, c)) * 3000).astype(np.int16)
    bb = (rng.normal(size=(n, c)) * 3000).astype(np.int16)
    h0 = (0.3 * rng.normal(size=tuple(srv.state.h.shape))).astype(np.float32)
    c0 = rng.normal(size=tuple(srv.state.c.shape)).astype(np.float32)
    ctx0 = (None if srv.state.context is None else
            (0.1 * rng.normal(size=tuple(srv.state.context.shape))).astype(np.float32))
    return ba, bb, (h0, c0, ctx0)


def _set_state(srv, start) -> None:
    h0, c0, ctx0 = start
    srv.state.h.copy_(torch.from_numpy(h0))
    srv.state.c.copy_(torch.from_numpy(c0))
    if ctx0 is not None:
        srv.state.context.copy_(torch.from_numpy(ctx0))


def _jax_state(start):
    import jax.numpy as jnp

    from vadc_tpu.engine.runner import StreamState

    h0, c0, ctx0 = start
    return StreamState(jnp.asarray(h0), jnp.asarray(c0),
                       None if ctx0 is None else jnp.asarray(ctx0))


def _state_of(srv):
    st = srv.state
    return [x.clone() for x in (st.h, st.c)] + ([] if st.context is None else [st.context.clone()])


def _assert_slots(srv, start, held: list[int], zeroed: list[int]) -> None:
    """Slots in `held` carry their starting state bit for bit, slots in
    `zeroed` hold zeros exactly."""
    h0, c0, ctx0 = start
    st = srv.state
    for s in held:
        assert torch.equal(st.h[:, s], torch.from_numpy(h0[:, s])), f"slot {s} h moved"
        assert torch.equal(st.c[:, s], torch.from_numpy(c0[:, s])), f"slot {s} c moved"
        if ctx0 is not None:
            assert torch.equal(st.context[s], torch.from_numpy(ctx0[s])), f"slot {s} context"
    for s in zeroed:
        assert not st.h[:, s].any() and not st.c[:, s].any(), f"slot {s} not zeroed"
        if ctx0 is not None:
            assert not st.context[s].any(), f"slot {s} context not zeroed"


@pytest.mark.parametrize("family", ["v3", "v5"])
def test_ticks_match_the_jax_server(family, v5_archive, jax_server):
    """_tick and _tick2 against the JAX server's on the same inputs. Idle
    slots hold bit for bit; a reset slot's chunk is computed from zeros (its
    state equals one step of the same chunk from the initial state)."""
    import jax.numpy as jnp

    model = _model(family, v5_archive)
    js = jax_server(port=0, max_streams=4, model=model, shard=False)
    ts = VadServer(port=0, max_streams=4, model=model, device="cpu")
    try:
        assert ts.family == js.family == family and ts.chunk == js.chunk
        assert (ts.state.context is not None) == (family == "v5")
        tol_p, tol_s = TICK_TOL[family]
        ba, bb, start = _tick_inputs(ts, seed=3)
        masks = [jnp.asarray(m) for m in (ACTIVE_A, ACTIVE_B, RESET)]

        p_j, s_j = js._tick(js._params, jnp.asarray(ba), _jax_state(start), masks[0], masks[2])
        _set_state(ts, start)
        p_t = ts._tick(ba, ACTIVE_A, RESET)
        assert p_t.shape == (4,) and p_t.dtype == np.float32
        assert_close(p_t, np.asarray(p_j), tol_p, f"{family} tick probs")
        assert_close(ts.state.h, np.asarray(s_j.h), tol_s, f"{family} tick h")
        assert_close(ts.state.c, np.asarray(s_j.c), tol_s, f"{family} tick c")
        if s_j.context is not None:
            np.testing.assert_array_equal(ts.state.context.numpy(), np.asarray(s_j.context))
        _assert_slots(ts, start, held=[2], zeroed=[3])
        # the reset slot 1 from zeros: one step of its chunk from the
        # initial state, on the same batch
        fresh = ts.runner.init_state(ts.n)
        ts.runner.step(ts._audio[0].clone(), fresh)
        assert torch.equal(ts.state.h[:, 1], fresh.h[:, 1])
        assert torch.equal(ts.state.c[:, 1], fresh.c[:, 1])

        q_j, t_j = js._tick2(js._params, jnp.asarray(ba), jnp.asarray(bb), _jax_state(start),
                             *masks)
        _set_state(ts, start)
        q_t = ts._tick2(ba, bb, ACTIVE_A, ACTIVE_B, RESET)
        assert q_t.shape == (4, 2) and q_t.dtype == np.float32
        assert_close(q_t, np.asarray(q_j), tol_p, f"{family} tick2 probs")
        assert_close(ts.state.h, np.asarray(t_j.h), tol_s, f"{family} tick2 h")
        assert_close(ts.state.c, np.asarray(t_j.c), tol_s, f"{family} tick2 c")
        if t_j.context is not None:
            np.testing.assert_array_equal(ts.state.context.numpy(), np.asarray(t_j.context))
        # slot 3 is idle in both sub-steps after its reset
        _assert_slots(ts, start, held=[], zeroed=[3])
    finally:
        ts.pool.close()
        js.pool.close()


@pytest.mark.parametrize("family", ["v3", "v5"])
def test_tick2_parity_with_sequential_ticks(family, v5_archive):
    """The catch-up tick is two sequential ticks: reset before sub-step 0
    only, each sub-step merged under its own mask (slot 2, active only in
    the second, models a chunk that arrived between the two gathers). The
    port runs the same kernels in both, so the bits are the same."""
    srv = VadServer(port=0, max_streams=4, model=_model(family, v5_archive), device="cpu")
    try:
        ba, bb, start = _tick_inputs(srv, seed=5)
        _set_state(srv, start)
        p_a = srv._tick(ba, ACTIVE_A, RESET)
        p_b = srv._tick(bb, ACTIVE_B, np.zeros(4, bool))
        seq = _state_of(srv)
        _set_state(srv, start)
        q2 = srv._tick2(ba, bb, ACTIVE_A, ACTIVE_B, RESET)
        np.testing.assert_array_equal(q2[:, 0], p_a)
        np.testing.assert_array_equal(q2[:, 1], p_b)
        for got, want in zip(_state_of(srv), seq):
            assert torch.equal(got, want)
    finally:
        srv.pool.close()


class _RacingPool:
    """A stand-in for the native pool: the first gather reports a backlog;
    during the second, a client is accepted on `slot` (its reset request is
    appended, as _accept_loop does before add_fd)."""

    def __init__(self, srv, slot: int, batch_a, batch_b):
        self.srv, self.slot, self.calls = srv, slot, 0
        self.batches = (batch_a, batch_b)

    def gather(self):
        n = self.srv.n
        self.calls += 1
        if self.calls == 2:
            with self.srv._lock:
                self.srv._reset_requests.append(self.slot)
        batch = self.batches[self.calls - 1]
        return batch.copy(), np.ones(n, np.uint8), n, 1 if self.calls == 1 else 0


def test_tick2_reset_race_keeps_the_old_chunk_out():
    """A slot recycled between the catch-up tick's two gathers: its row in
    the first gather is not the new client's, so the slot sits sub-step 0
    out (no state update, no FSM feed) and the new client's first chunk is
    computed from zeros in sub-step 1 (vadc_tpu/server.py merged that row
    into the new client's state and fed its probability to the FSM)."""
    srv = VadServer(port=0, max_streams=4, model=str(V31_ARCHIVE), device="cpu")
    ref = VadServer(port=0, max_streams=4, model=str(V31_ARCHIVE), device="cpu")
    try:
        ba, bb, start = _tick_inputs(srv, seed=7)
        _set_state(srv, start)
        srv.pool.close()
        srv.pool = _RacingPool(srv, 2, ba, bb)
        g = srv._gather()
        assert g.batch_b is not None and g.count == 4
        assert g.active.tolist() == [True, True, False, True]
        assert g.active_b.tolist() == [True] * 4
        assert g.reset.tolist() == [False, False, True, False]
        srv._process(g)
        assert srv.catchup_ticks == 1 and srv.tick_count == 1
        # the late slot's first FSM feed was skipped
        assert srv.fsm.chunk_index.tolist() == [2, 2, 1, 2]
        # its state is one step of the new client's chunk from zeros: the
        # same as a tick of batch b alone with that slot reset
        _set_state(ref, start)
        ref._tick(bb, np.ones(4, bool), np.array([False, False, True, False]))
        assert torch.equal(srv.state.h[:, 2], ref.state.h[:, 2])
        assert torch.equal(srv.state.c[:, 2], ref.state.c[:, 2])
    finally:
        ref.pool.close()


def test_tick_count_counts_every_device_call():
    """tick_count counts every device call, reset-only ticks and warm-up
    included, and does not saturate; tick_times (bounded) holds the wall
    time of the ticks that processed audio."""
    from vadc_tpu_torch.server import _Gathered

    srv = VadServer(port=0, max_streams=2, model=str(V31_ARCHIVE), device="cpu")
    try:
        srv.warmup()
        assert srv.tick_count == 2 and not srv.tick_times
        zeros = np.zeros((2, srv.chunk), np.int16)
        off = np.zeros(2, bool)
        srv._process(_Gathered(zeros, off, 0, None, None, np.array([True, False])))
        assert srv.tick_count == 3 and not srv.tick_times
        srv._process(_Gathered(zeros, np.array([True, False]), 1, None, None, off))
        assert srv.tick_count == 4 and len(srv.tick_times) == 1
        assert srv.tick_times.maxlen == 20000
    finally:
        srv.pool.close()


# ---- end to end over sockets ----------------------------------------------


@pytest.fixture(scope="module")
def server():
    srv = VadServer(port=0, max_streams=2, model=str(V31_ARCHIVE), device="cpu")
    with serving(srv) as port:
        yield port, srv


def test_warmup_holds_state_and_serving_still_exact(audio):
    """warmup() runs one all-idle tick and one all-idle catch-up tick (where
    the kernels build on a card): the state comes through bit for bit, and a
    client served after it gets the same segment as ever."""
    srv = VadServer(port=0, max_streams=2, model=str(V31_ARCHIVE), device="cpu")
    h0 = srv.state.h + 0.25
    c0 = srv.state.c - 0.125
    srv.state.h.copy_(h0)
    srv.state.c.copy_(c0)
    srv.warmup()
    assert torch.equal(srv.state.h, h0) and torch.equal(srv.state.c, c0)
    with serving(srv) as port:
        _one_segment(_run_client(port, audio))


def test_concurrent_clients(server, audio):
    port, _ = server
    results = {}

    def go(name):
        results[name] = _run_client(port, audio)

    threads = [threading.Thread(target=go, args=(i,), daemon=True) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=2 * SOCKET_TIMEOUT)
    assert sorted(results) == [0, 1]
    for segs in results.values():
        _one_segment(segs)


def test_slot_reuse_and_overflow(server, audio):
    port, srv = server
    _wait_free(srv, 2)
    _one_segment(_run_client(port, audio))
    # both slots held by clients that never end: a third gets "server full"
    _wait_free(srv, 2)
    hold = [socket.create_connection(("127.0.0.1", port), timeout=SOCKET_TIMEOUT)
            for _ in range(2)]
    try:
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            with srv._lock:
                if not srv._free:
                    break
            time.sleep(0.01)
        c3 = socket.create_connection(("127.0.0.1", port), timeout=10)
        try:
            assert b"server full" in c3.recv(100)
        finally:
            c3.close()
    finally:
        for h in hold:
            h.close()
    _wait_free(srv, 2)


def test_wav_client_and_raw_client_agree(server, audio):
    """A 44.1 kHz wav client gets the segment of a raw model-rate client of
    the same material, within two 96 ms chunks per edge."""
    port, srv = server
    _wait_free(srv, 2)
    sil = (np.random.default_rng(0).normal(size=44100) * 0.001).astype(np.float32)
    a441 = np.concatenate([sil, _speechlike(2.0, sr=44100), sil])
    pcm441 = np.clip(a441 * 32768, -32768, 32767).astype("<i2").tobytes()
    raw = _run_client(port, audio)
    wav = _run_client(port, _wav(pcm441, 44100))
    assert len(raw) == len(wav) == 1, (raw, wav)
    (rs, re_), (ws, we) = raw[0], wav[0]
    assert abs(rs - ws) <= 0.2 and abs(re_ - we) <= 0.2


def test_wav_client_slot_recycles(server, audio):
    port, srv = server
    _wait_free(srv, 2)
    assert len(_run_client(port, _wav(audio, 16000))) == 1
    _wait_free(srv, 2, timeout=10)
    assert all(s is None or s.pipe_fd is None for s in srv.slots)
    assert len(_run_client(port, audio)) == 1


def test_wav_client_malformed_header_gets_error_and_recycles(server):
    """A RIFF header with sample rate 0 gets a one-line error; the slot
    recycles."""
    port, srv = server
    _wait_free(srv, 2)
    fmt = struct.pack("<HHIIHH", 1, 1, 0, 0, 2, 16)
    blob = (b"RIFF" + struct.pack("<I", 36) + b"WAVE" + b"fmt " + struct.pack("<I", 16) + fmt
            + b"data" + struct.pack("<I", 0))
    data = _exchange(port, blob)
    assert b"error:" in data and b"zero sample rate" in data
    _wait_free(srv, 2)


def test_catchup_tick_drains_backlog_exactly(audio):
    """Slowed ticks back the rings up: the engine takes catch-up ticks and
    still delivers the exact segment."""
    srv = VadServer(port=0, max_streams=2, model=str(V31_ARCHIVE), device="cpu")
    tick, tick2 = srv._tick, srv._tick2

    def slow_tick(*a):
        time.sleep(0.05)
        return tick(*a)

    def slow_tick2(*a):
        time.sleep(0.05)
        return tick2(*a)

    srv._tick, srv._tick2 = slow_tick, slow_tick2
    with serving(srv) as port:
        _one_segment(_run_client(port, audio))  # unpaced: faster than realtime
    assert srv.catchup_ticks > 0, "backlog never hit the catch-up path"
    assert srv.tick_count >= len(srv.tick_times) > 0


def test_segment_lines_equal_the_jax_server(audio, jax_server):
    """One client's audio (tests/test_server.py's speech) gives the same
    segment lines, byte for byte, from the port's server and the JAX one."""
    js = jax_server(port=0, max_streams=2, model=str(V31_ARCHIVE), shard=False)
    with serving(js) as port:
        want = _exchange(port, audio)
    ts = VadServer(port=0, max_streams=2, model=str(V31_ARCHIVE), device="cpu")
    with serving(ts) as port:
        got = _exchange(port, audio)
    assert want.count(b"\n") == 1, want
    assert got == want


def _bare_outbox_server():
    """A VadServer shell with just the outbox machinery (no pool, no
    model)."""
    from collections import deque

    from vadc_tpu.cli.segmenter import SegmenterConfig

    srv = VadServer.__new__(VadServer)
    srv.cfg = SegmenterConfig.from_ms(chunk_samples=1536)
    srv.slots = [None]
    srv.segments_dropped = 0
    srv.delivery_latencies = deque(maxlen=20000)
    return srv


def _drain(b: socket.socket, into: bytearray) -> None:
    try:
        while True:
            got = b.recv(65536)
            if not got:
                return
            into += got
    except BlockingIOError:
        pass


@pytest.mark.parametrize("blocking", [False, True])
def test_outbox_never_blocks_and_preserves_line_integrity(blocking):
    """A client that stops reading never stalls the emits: queueing to a
    backpressured socket takes bounded time, the cap drops the oldest whole
    lines, and what is delivered is whole, ordered lines. Both socket modes:
    raw clients' sockets are non-blocking (shared with the pool), wav
    clients' stay blocking (the decoder reads them)."""
    srv = _bare_outbox_server()
    a, b = socket.socketpair()
    try:
        a.setsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF, 4096)
        a.setblocking(blocking)
        slot = _Slot(a)
        srv.slots[0] = slot
        n = 5000
        t0 = time.perf_counter()
        for i in range(n):
            srv._queue_segment(0, 10 * i + 2, 10 * i + 6)
        elapsed = time.perf_counter() - t0
        assert elapsed < 2.0, f"queueing blocked: {elapsed:.1f}s for {n} segments"
        assert len(slot.outbox) <= srv._OUTBOX_CAP_LINES + 1
        assert srv.segments_dropped > 0
        b.setblocking(False)
        received = bytearray()
        deadline = time.monotonic() + 30
        while (slot.outbox or slot.head_off) and time.monotonic() < deadline:
            srv._pump_outbox(slot)
            _drain(b, received)
        _drain(b, received)
        assert not slot.outbox
        assert received.endswith(b"\n"), "torn trailing line"
        lines = received.decode().splitlines()
        starts = [float(line.split(",")[0]) for line in lines]
        assert starts == sorted(starts) and len(set(starts)) == len(starts)
        assert len(lines) + srv.segments_dropped == n
    finally:
        a.close()
        b.close()


# ---- the command line ------------------------------------------------------

V4_ARCHIVE = DATA / "silero_v4_16k.testtensor"


@pytest.mark.parametrize("argv,message", [
    (["--resume", "x.ckpt"], "Queue 1: 'Checkpoint'"),
    (["--shard"], "Queue 1: 'Multi-GPU'"),
    (["--model", "/nonexistent/w.testtensor", "--device", "cpu"], "no weight archive"),
])
def test_main_refuses_what_is_not_ported(argv, message, capsys):
    assert main(argv) == 1
    err = capsys.readouterr().err
    assert err.startswith("Error: ") and message in err and err.count("\n") == 1


@pytest.mark.parametrize("argv,precision", [
    (["--fast", "--model", str(V4_ARCHIVE), "--device", "cpu"], "fast"),
    (["--precision", "balanced", "--model", str(V4_ARCHIVE), "--device", "cpu"], "balanced"),
])
def test_main_serves_v4_at_a_bf16_tier(argv, precision, monkeypatch):
    """The command line takes every tier for the v4 model (refused before
    the v4/v5 tiers were ported): the server it builds runs the tier."""
    served = []
    monkeypatch.setattr(VadServer, "serve_forever", lambda self: served.append(self))
    assert main(["--port", "0", *argv]) == 0
    (srv,) = served
    assert srv.runner.family == "v4" and srv.runner.precision == precision
    srv.pool.close()


def test_main_without_a_card_exits_1(capsys, monkeypatch):
    """--device defaults to cuda; without a card the server exits 1 with a
    one-line error, as the CLI does, and nothing moves to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert main(["--port", "0"]) == 1
    err = capsys.readouterr().err
    assert "no CUDA device" in err and "--device cpu" in err


@pytest.mark.parametrize("precision", ["balanced", "fast", "turbo"])
def test_bf16_tiers_serve_the_faithful_segment_lines(precision):
    """The server at a bf16 tier (its StreamRunner's tier, every tick):
    the faithful tier's segment lines for the same client, on synthetic
    speech with its aspiration floor (tests/test_torch_tiers.py's track)."""
    from vadc_tpu.io.synthaudio import utterance_track

    track, _ = utterance_track(4, seed=7)
    audio = f32_to_s16le(track.astype(np.float32))
    want_srv = VadServer(port=0, max_streams=2, model=str(V31_ARCHIVE), device="cpu")
    with serving(want_srv) as port:
        want = _exchange(port, audio)
    srv = VadServer(port=0, max_streams=2, model=str(V31_ARCHIVE), device="cpu",
                    precision=precision)
    assert srv.runner.precision == precision
    with serving(srv) as port:
        got = _exchange(port, audio)
    assert want.count(b"\n") >= 3 and got == want


def test_v4_at_fast_serves_the_faithful_segment_lines():
    """The v4 model at fast on every tick: the faithful tier's segment lines
    for the same client (the v4 track of seed 0, whose segments no tier but
    turbo moves: tests/torch_tier_survey.py)."""
    from vadc_tpu.io.synthaudio import utterance_track

    track, _ = utterance_track(4, seed=0)
    audio = f32_to_s16le(track.astype(np.float32))
    lines = {}
    for precision in ("faithful", "fast"):
        srv = VadServer(port=0, max_streams=2, model=str(V4_ARCHIVE), device="cpu",
                        precision=precision)
        assert srv.runner.family == "v4" and srv.runner.precision == precision
        with serving(srv) as port:
            lines[precision] = _exchange(port, audio)
    assert lines["faithful"].count(b"\n") >= 3 and lines["fast"] == lines["faithful"]
