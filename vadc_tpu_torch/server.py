"""Multi-client VAD serving daemon on the PyTorch/CUDA port.

Counterpart of vadc_tpu/server.py. TCP line protocol: a client connects,
streams raw mono s16le PCM at the model's rate, or a wav container at any
rate/bits/channels (sniffed by its RIFF magic and decoded natively per
connection), and receives speech-segment events as `start,end\\n` (seconds,
padded and merged: the CLI's output contract) while the stream is live.
Half-closing the write side (or disconnecting) ends the stream; the server
applies the EOF snap, flushes the final segment and reuses the slot.

Architecture:
  * client sockets are drained GIL-free by the native StreamPool
    (native.py over native/stream_pool.cpp) into per-stream chunk rings; wav clients
    go through a per-connection decoder thread feeding the pool via a pipe;
  * one engine loop advances ALL slots per tick in one batched step on the
    one device it is given: the s16 batch goes from a pinned host buffer to
    the device once per gather and is dequantized there (x / 32768, a power
    of two, so bit-identical to io/pcm.py); reset slots are zeroed,
    the step writes the new state into a second set of state buffers, and a
    masked merge keeps every idle slot's state (and v5 context) bit for bit;
    one device-to-host copy of the probabilities ends the tick. When the
    rings hold a backlog, a catch-up tick runs two chunks per slot and
    returns one stacked [N, 2] copy;
  * the segmentation FSM is the native NativeFsm with per-stream chunk
    counters; pad/merge and the EOF snap run on the host per event.

Every family the port loads serves, at any precision tier (`--precision`,
`--fast`). Not in the port
yet: checkpoint/resume (ROADMAP Queue 1, 'Checkpoint') and serving over
several devices ('Multi-GPU'); `--resume` and `--shard` say so and exit 1.

    python -m vadc_tpu_torch.server --port 7355 --max_streams 64 [--device cuda] [--fast]
    # then: cat audio.s16le | nc -q1 localhost 7355
"""

from __future__ import annotations

import argparse
import os
import select
import socket
import sys
import threading
import time
from collections import deque
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from vadc_tpu_torch.runtime import PRECISIONS, NoCudaDeviceError


class _Slot:
    __slots__ = ("conn", "pending", "pipe_fd", "outbox", "head_off")

    def __init__(self, conn: socket.socket):
        self.conn = conn
        self.pending: tuple[int, int] | None = None  # merged segment (chunks)
        # wav clients: read end of the decode pipe the pool drains (the
        # pool never closes fds; _finish_slot must)
        self.pipe_fd: int | None = None
        # rendered-but-unsent segment lines (client backpressure): emits
        # only QUEUE here; the engine loop pumps the bytes out with
        # non-blocking sends, so a slow client can never stall the tick
        self.outbox: list[tuple[bytes, float]] = []
        self.head_off = 0  # bytes of outbox[0] already sent (partial write)


@dataclass
class _Gathered:
    """What one drain of the pool gives the next tick: the first gather's
    batch [N, chunk] s16 and active mask, the second gather's (catch-up
    tick) or None, the slots to reset, and the first gather's ready count."""

    batch: np.ndarray
    active: np.ndarray
    count: int
    batch_b: np.ndarray | None
    active_b: np.ndarray | None
    reset: np.ndarray


def _masked_zero(state, mask: torch.Tensor) -> None:
    """Zero the state of the slots in `mask`, in place: a recycled slot's
    first chunk is computed from zeros, not from the previous client's
    leftovers."""
    state.h.masked_fill_(mask[None, :, None], 0.0)
    state.c.masked_fill_(mask[None, :, None], 0.0)
    if state.context is not None:
        state.context.masked_fill_(mask[:, None], 0.0)


def _masked_merge(new, old, mask: torch.Tensor) -> None:
    """new = where(mask, new, old), in place: idle slots hold their (possibly
    just reset) state bit for bit."""
    torch.where(mask[None, :, None], new.h, old.h, out=new.h)
    torch.where(mask[None, :, None], new.c, old.c, out=new.c)
    if new.context is not None:
        torch.where(mask[:, None], new.context, old.context, out=new.context)


class VadServer:
    def __init__(
        self,
        host: str = "127.0.0.1",
        port: int = 7355,
        *,
        max_streams: int = 64,
        model: str | None = None,
        precision: str = "faithful",
        sequence_count: int = 1536,
        device="cuda",
    ):
        from vadc_tpu_torch import native
        from vadc_tpu_torch.cli.segmenter import SegmenterConfig
        from vadc_tpu_torch.cli.main import DEFAULT_WEIGHTS
        from vadc_tpu_torch.engine.runner import StreamRunner
        from vadc_tpu_torch.models.weights import clamp_sequence_count, load_params
        from vadc_tpu_torch.runtime import resolve_device

        if not native.available():
            raise RuntimeError("native library required (make -C native)")
        self.device = resolve_device(device)
        weights = Path(model) if model else DEFAULT_WEIGHTS
        if not weights.exists():
            raise FileNotFoundError(f"no weight archive at {weights}")
        self.family, params = load_params(weights, device=self.device)
        self.chunk = clamp_sequence_count(self.family, sequence_count)
        self.n = max_streams
        self.runner = StreamRunner(self.family, params, device=self.device, precision=precision)
        # double-buffered state: a tick steps from self.state into
        # self._spare, merges, and swaps the two
        self.state = self.runner.init_state(self.n)
        self._spare = self.runner.init_state(self.n)
        # host staging for the tick inputs (pinned on a card, so the copies
        # to the device run asynchronously) and their device twins: up to
        # two s16 batches, and the masks active_a, active_b, reset
        pin = self.device.type == "cuda"
        self._host_batch = torch.empty((2, self.n, self.chunk), dtype=torch.int16, pin_memory=pin)
        self._host_masks = torch.empty((3, self.n), dtype=torch.bool, pin_memory=pin)
        self._dev_batch = self._host_batch.to(self.device)
        self._dev_masks = self._host_masks.to(self.device)
        self._audio = torch.empty((2, self.n, self.chunk), dtype=torch.float32, device=self.device)
        # the 8 kHz families time their chunks at 8 kHz (the JAX server's
        # config assumes 16 kHz for every family)
        self.sample_rate = self.runner.module.SAMPLE_RATE
        self.cfg = SegmenterConfig.from_ms(chunk_samples=self.chunk, sample_rate=self.sample_rate)
        self.fsm = native.NativeFsm(
            self.n,
            threshold=self.cfg.threshold,
            neg_threshold=self.cfg.neg_threshold,
            min_silence_chunks=self.cfg.min_silence_chunks,
            min_speech_chunks=self.cfg.min_speech_chunks,
        )
        self.pool = native.StreamPool(self.n, self.chunk, ring_chunks=64)
        self.slots: list[_Slot | None] = [None] * self.n
        self._free = list(range(self.n))
        # pool attachment gate: a slot's pool stream keeps the PREVIOUS
        # client's drained/EOF state until add_fd resets it, and intake may
        # delay add_fd by the sniff window; the engine must not finish a
        # slot whose fd isn't attached yet
        self._attached = np.zeros(self.n, bool)
        self._lock = threading.Lock()
        # serializes the engine tick against anything that reads the state
        # and the FSM arrays as one view. Lock order when nested:
        # _state_lock, then _lock.
        self._state_lock = threading.Lock()
        self._reset_requests: list[int] = []
        # segment lines dropped to unresponsive clients (outbox cap / EOF
        # flush timeout)
        self.segments_dropped = 0
        self.host, self.port = host, port
        self._stop = threading.Event()
        # set by serve_forever once the kernels are built and the socket
        # accepts clients; `address` is then the bound (host, port)
        self.ready = threading.Event()
        self.address: tuple[str, int] | None = None
        # serving observability. tick_count counts every device call
        # (ticks, catch-up ticks and reset-only ticks, warm-up included)
        # and never saturates; tick_times (bounded, ~30 min of 96 ms ticks)
        # is the wall time of the ticks that processed audio; catchup_ticks
        # counts the two-chunk ticks. emit_latencies: FSM event -> line
        # queued and first send tried; delivery_latencies: line queued ->
        # fully handed to the kernel, backpressure included.
        self.tick_count = 0
        self.tick_times: deque = deque(maxlen=20000)
        self.catchup_ticks = 0
        self.emit_latencies: deque = deque(maxlen=20000)
        self.delivery_latencies: deque = deque(maxlen=20000)

    # ---- device ticks -------------------------------------------------------

    def _stage(self, batches: list[np.ndarray], masks: list[np.ndarray]) -> None:
        """The tick's inputs to the device: each s16 batch into the pinned
        buffer, one copy; the masks likewise; the batches dequantized on the
        device into self._audio."""
        k = len(batches)
        host = self._host_batch.numpy()
        for i, b in enumerate(batches):
            host[i] = b
        host_masks = self._host_masks.numpy()
        for i, m in enumerate(masks):
            host_masks[i] = m
        if self.device.type != "cpu":
            self._dev_batch[:k].copy_(self._host_batch[:k], non_blocking=True)
            self._dev_masks.copy_(self._host_masks, non_blocking=True)
        torch.mul(self._dev_batch[:k], 1.0 / 32768.0, out=self._audio[:k])

    def _tick(self, batch: np.ndarray, active: np.ndarray, reset: np.ndarray) -> np.ndarray:
        """One chunk per slot: batch [N, chunk] s16; active, reset [N] bool.
        Zeroes the reset slots, steps every slot, keeps the state of the
        slots not active. Returns probs [N] on the host (one copy)."""
        self._stage([batch], [active, reset])
        active_d, reset_d = self._dev_masks[0], self._dev_masks[1]
        old, new = self.state, self._spare
        _masked_zero(old, reset_d)
        probs = self.runner.step_into(self._audio[0], old, new)
        _masked_merge(new, old, active_d)
        self.state, self._spare = new, old
        self.tick_count += 1
        return probs.cpu().numpy()

    def _tick2(
        self,
        batch_a: np.ndarray,
        batch_b: np.ndarray,
        active_a: np.ndarray,
        active_b: np.ndarray,
        reset: np.ndarray,
    ) -> np.ndarray:
        """Catch-up tick: the two oldest queued chunks per slot in one call,
        for an engine behind the chunk cadence. The same as two sequential
        ticks: reset applies before sub-step 0 only, and each sub-step
        merges under its own active mask. Returns probs [N, 2] on the host
        (one stacked copy)."""
        self._stage([batch_a, batch_b], [active_a, active_b, reset])
        active_a_d, active_b_d, reset_d = self._dev_masks
        s0, s1 = self.state, self._spare
        _masked_zero(s0, reset_d)
        probs_a = self.runner.step_into(self._audio[0], s0, s1)
        _masked_merge(s1, s0, active_a_d)
        probs_b = self.runner.step_into(self._audio[1], s1, s0)
        _masked_merge(s0, s1, active_b_d)
        self.tick_count += 1
        return torch.stack([probs_a, probs_b], dim=1).cpu().numpy()

    def warmup(self) -> None:
        """One all-idle tick and one all-idle catch-up tick before the first
        client connects: the kernels build (nvcc at first use) and load
        here, never on a client's first chunk. Active and reset are all
        false, so the state provably holds."""
        zeros = np.zeros((self.n, self.chunk), np.int16)
        off = np.zeros(self.n, bool)
        with self._state_lock:
            self._tick(zeros, off, off)
            self._tick2(zeros, zeros, off, off, off)

    # ---- client lifecycle -------------------------------------------------

    def _accept_loop(self, server_sock: socket.socket) -> None:
        while not self._stop.is_set():
            try:
                conn, _addr = server_sock.accept()
            except OSError:
                return
            with self._lock:
                if not self._free:
                    conn.sendall(b"error: server full\n")
                    conn.close()
                    continue
                slot = self._free.pop()
                # gate BEFORE publishing the slot: the engine's finish check
                # is lock-free, so if it saw the fresh _Slot with attached
                # still True it would finish the new connection against the
                # previous client's drained pool state
                self._attached[slot] = False
                self.slots[slot] = _Slot(conn)
                # appended BEFORE add_fd makes the client's chunks
                # gatherable: any chunk a gather returns has its reset
                # visible to the capture after that gather
                self._reset_requests.append(slot)
            # intake runs off-thread: it may block up to the sniff timeout
            # peeking for a wav magic, and for wav clients it becomes the
            # long-lived decoder; raw clients get their socket fd handed to
            # the GIL-free pool untouched (the peek consumes nothing)
            threading.Thread(target=self._intake, args=(slot, conn), daemon=True).start()

    def _intake(self, slot: int, conn: socket.socket) -> None:
        """Sniff the client's first bytes: raw s16le goes straight to the
        native pool; a RIFF/WAVE header routes through the native decoder
        (any rate/bits/channels -> model-rate mono s16le) into a pipe the
        pool drains."""
        from vadc_tpu_torch.io.wav import WavFormatError, WavSource, is_riff_wave

        head = b""
        deadline = time.monotonic() + 2.0
        # MSG_PEEK never drains, so recv can't return b'' to signal a
        # half-close while <12 bytes sit buffered; poll for RDHUP instead
        rdhup = getattr(select, "POLLRDHUP", 0x2000)
        poller = select.poll()
        poller.register(conn, select.POLLIN | rdhup)
        try:
            conn.settimeout(0.25)
            while len(head) < 12 and time.monotonic() < deadline:
                try:
                    got = conn.recv(12, socket.MSG_PEEK)
                except TimeoutError:
                    continue
                if not got:
                    break  # connection closed before any bytes
                if len(got) == len(head):
                    # live but no new bytes; a peer FIN means no more will
                    # come: stop waiting and treat as raw
                    if any(ev & rdhup for _fd, ev in poller.poll(0)):
                        break
                    time.sleep(0.02)
                head = got
        except OSError:
            pass
        try:
            conn.settimeout(None)
        except OSError:
            pass  # fd still drains below; the pool will observe its EOF
        if not is_riff_wave(head):
            self.pool.add_fd(slot, conn.fileno())
            self._attached[slot] = True
            return
        r, w = os.pipe()
        with self._lock:
            s = self.slots[slot]
            if s is None or s.conn is not conn:  # recycled mid-sniff
                os.close(r)
                os.close(w)
                return
            s.pipe_fd = r
        self.pool.add_fd(slot, r)
        self._attached[slot] = True
        try:
            with WavSource(conn.makefile("rb"), target_rate=self.sample_rate) as src:
                while True:
                    data = src.read(1 << 16)
                    if not data:
                        break
                    os.write(w, data)
        except (WavFormatError, ValueError) as e:
            # ValueError too: untrusted header fields must never kill the
            # intake thread (a dead thread would leak the slot)
            try:
                conn.sendall(f"error: {e}\n".encode())
            except OSError:
                pass
        except OSError:
            pass  # client or pipe went away mid-stream
        finally:
            os.close(w)  # pool sees EOF -> drain tail -> slot recycles

    def _emit(self, slot: int, start_c: int, end_c: int) -> None:
        """Pad/merge like the CLI (vadc.c:262-299) and queue for the client."""
        s = self.slots[slot]
        if s is None:
            return
        spc, pad = self.cfg.seconds_per_chunk, self.cfg.speech_pad_s
        if s.pending is not None:
            pend_end_padded = s.pending[1] * spc + pad
            new_start_padded = max(start_c * spc - pad, 0.0)
            if pend_end_padded >= new_start_padded:
                s.pending = (s.pending[0], end_c)
            else:
                self._queue_segment(slot, *s.pending)
                s.pending = (start_c, end_c)
        else:
            s.pending = (start_c, end_c)

    # an unresponsive client's outbox is capped; beyond it the oldest
    # unsent whole lines are dropped (~16 KB of segment lines per slot)
    _OUTBOX_CAP_LINES = 1024

    def _queue_segment(self, slot: int, start_c: int, end_c: int) -> None:
        """Render the segment line and queue it. Cheap on purpose: emits run
        under _state_lock, so the socket write happens in _pump_outbox and a
        client that stops reading never stalls the tick."""
        s = self.slots[slot]
        if s is None:
            return
        spc, pad = self.cfg.seconds_per_chunk, self.cfg.speech_pad_s
        start = max(start_c * spc - pad, 0.0)
        end = end_c * spc + pad
        s.outbox.append((f"{start:.2f},{end:.2f}\n".encode(), time.perf_counter()))
        if len(s.outbox) > self._OUTBOX_CAP_LINES:
            # never drop the partially-sent head (splitting a line would
            # corrupt the client's stream); drop the oldest whole lines
            keep = 1 if s.head_off else 0
            excess = len(s.outbox) - self._OUTBOX_CAP_LINES
            del s.outbox[keep : keep + excess]
            self.segments_dropped += excess
        self._pump_outbox(s)

    @staticmethod
    def _conn_writable(conn, timeout_s: float):
        """POLLOUT probe: True = writable, False = would block, None = fd
        gone. poll(), never select(): past ~1024 clients the server's fds
        exceed FD_SETSIZE and select() raises for every high fd."""
        try:
            p = select.poll()
            p.register(conn, select.POLLOUT)
            events = p.poll(max(timeout_s, 0.0) * 1000)
        except (OSError, ValueError):  # fd closed under us
            return None
        if not events:
            return False
        if events[0][1] & select.POLLOUT:
            return True  # send() will surface any pending error itself
        return None  # POLLERR/POLLHUP/POLLNVAL only: peer gone

    def _pump_outbox(self, s: _Slot) -> bool:
        """Drain a slot's queued segment lines without ever blocking. True
        when the outbox is empty (or the client is gone), False when the
        socket can't take more bytes right now. A writability probe guards
        every send: wav clients' sockets stay blocking (the decoder reads
        them), and during the sniff the socket is in timeout mode."""
        while s.outbox:
            writable = self._conn_writable(s.conn, 0.0)
            if writable is None:
                s.outbox.clear()
                s.head_off = 0
                return True
            if not writable:
                return False
            line, t_queued = s.outbox[0]
            try:
                n = s.conn.send(line[s.head_off :] if s.head_off else line)
            except (BlockingIOError, TimeoutError):
                return False
            except OSError:
                s.outbox.clear()
                s.head_off = 0
                return True
            s.head_off += n
            if s.head_off >= len(line):
                s.outbox.pop(0)
                s.head_off = 0
                self.delivery_latencies.append(time.perf_counter() - t_queued)
        return True

    def _flush_outbox_blocking(self, s: _Slot, timeout: float = 5.0) -> None:
        """EOF flush: give a backpressured client up to `timeout` to drain
        its remaining lines, then drop. Runs on the closer thread, never the
        engine loop; each pump runs under _state_lock, the wait outside."""
        deadline = time.monotonic() + timeout
        while True:
            with self._state_lock:
                if self._pump_outbox(s):
                    return
            remaining = deadline - time.monotonic()
            writable = self._conn_writable(s.conn, max(remaining, 0.0))
            if remaining <= 0 or not writable:
                with self._state_lock:
                    self.segments_dropped += len(s.outbox)
                    s.outbox.clear()
                    s.head_off = 0
                return

    def _finish_slot(self, slot: int) -> None:
        """EOF snap (vadc.c:1005-1027), flush, close, recycle. The emit and
        the FSM resets happen under _state_lock."""
        fsm = self.fsm
        with self._state_lock:
            last_chunk = int(fsm.chunk_index[slot]) - 1
            if fsm.triggered[slot]:
                start = int(fsm.speech_start[slot])
                if last_chunk - start > self.cfg.min_speech_chunks:
                    self._emit(slot, start, last_chunk)
            s = self.slots[slot]
            if s is not None and s.pending is not None:
                self._queue_segment(slot, *s.pending)
                s.pending = None
            fsm.triggered[slot] = 0
            fsm.speech_start[slot] = 0
            fsm.temp_end[slot] = 0
            fsm.chunk_index[slot] = 0
        if s is None:
            with self._lock:
                self.slots[slot] = None
                self._free.append(slot)
            return
        # detach the slot from the engine's view BEFORE any flush wait: from
        # here the closer below is the _Slot's sole owner
        with self._lock:
            self.slots[slot] = None

        def closer():
            self._flush_outbox_blocking(s)
            try:
                s.conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            s.conn.close()
            if s.pipe_fd is not None:
                try:
                    os.close(s.pipe_fd)  # wav decode pipe read end
                except OSError:
                    pass
            with self._lock:
                self._free.append(slot)

        if s.outbox:
            # backpressured client at EOF: the flush may wait up to 5 s,
            # never on the engine thread
            threading.Thread(target=closer, daemon=True).start()
        else:
            closer()

    # ---- engine loop ------------------------------------------------------

    def _take_resets(self) -> list[int]:
        with self._lock:
            taken, self._reset_requests = self._reset_requests, []
        return taken

    def _gather(self) -> _Gathered:
        """Drain the pool for the next tick.

        Catch-up: when the drain reports a backlog (streams still holding a
        completed chunk), a second gather takes the next chunk of each, so
        the engine recovers at up to 2x instead of never.

        Resets are captured AFTER each gather, never before: a recycle's
        reset request is appended before its add_fd makes the new client's
        chunks gatherable, so any chunk a gather returned has its reset
        visible right after it. A reset that shows only after the SECOND
        gather arrived after the first: that slot's row in the first gather
        is not the new client's, so the slot sits sub-step 0 out (no state
        update, no FSM feed) and the new client starts from zeros at
        sub-step 1 (vadc_tpu/server.py:755 merged such a row into the new
        client's state)."""
        batch, ready, count, backlog = self.pool.gather()
        active = ready > 0
        resets = self._take_resets()
        batch_b = active_b = None
        if backlog:
            b2, r2, c2, _ = self.pool.gather()
            late = self._take_resets()
            if late:
                active[late] = False
                resets += late
            if c2:
                batch_b, active_b = b2, r2 > 0
        reset = np.zeros(self.n, bool)
        reset[resets] = True
        return _Gathered(batch, active, count, batch_b, active_b, reset)

    def _process(self, g: _Gathered) -> None:
        """The device tick of one drain, the FSM feed and the emits, under
        _state_lock so the state, the FSM arrays and each slot's pending
        segment always change together."""
        t0 = time.perf_counter()
        with self._state_lock:
            if g.batch_b is not None:
                p2 = self._tick2(g.batch, g.batch_b, g.active, g.active_b, g.reset)
                self.catchup_ticks += 1
                # one [N, 2] copy, two FSM feeds: the active masks differ
                events = self.fsm.feed(p2[:, :1], active=g.active)
                events += self.fsm.feed(p2[:, 1:], active=g.active_b)
            else:
                probs = self._tick(g.batch, g.active, g.reset)
                events = self.fsm.feed(probs[:, None], active=g.active) if g.count else []
            if g.count:
                # latency from the feed that produced the events: the k-th
                # event's includes head-of-line blocking behind the others,
                # as a client observes it
                t_ev = time.perf_counter()
                for slot, start_c, end_c in events:
                    self._emit(slot, start_c, end_c)
                    self.emit_latencies.append(time.perf_counter() - t_ev)
                self.tick_times.append(time.perf_counter() - t0)
            for s in self.slots:
                if s is not None and s.outbox:
                    self._pump_outbox(s)

    def _engine_loop(self) -> None:
        while not self._stop.is_set():
            g = self._gather()
            if g.count or g.reset.any():
                self._process(g)
            # finish streams whose sockets have drained (attached gate: an
            # un-attached slot's pool state is the previous client's)
            for slot in range(self.n):
                if (
                    self.slots[slot] is not None
                    and self._attached[slot]
                    and self.pool.stream_done(slot)
                ):
                    self._finish_slot(slot)
            if not g.count:
                # idle ticks still retry backpressured outboxes: a client
                # may pause its audio while unread segment lines remain
                if any(s is not None and s.outbox for s in self.slots):
                    with self._state_lock:
                        for s in self.slots:
                            if s is not None and s.outbox:
                                self._pump_outbox(s)
                time.sleep(0.002)

    def stop(self) -> None:
        """Ask the engine loop (and serve_forever) to return."""
        self._stop.set()

    def serve_forever(self) -> None:
        """Serve until stop() (or an exception in the engine loop); then
        stop accepting, and close the socket and the pool."""
        server_sock = socket.create_server((self.host, self.port))
        acceptor = None
        try:
            self.pool.start()
            self.warmup()  # the first client never pays the kernel build
            acceptor = threading.Thread(target=self._accept_loop, args=(server_sock,), daemon=True)
            acceptor.start()
            self.address = server_sock.getsockname()[:2]
            print(
                f"vadc-torch server on {self.address[0]}:{self.address[1]} ({self.family}, "
                f"chunk {self.chunk}, {self.n} slots, {self.device})",
                file=sys.stderr, flush=True,
            )
            self.ready.set()
            self._engine_loop()
        finally:
            self._stop.set()
            try:
                server_sock.shutdown(socket.SHUT_RDWR)  # wakes the blocked accept()
            except OSError:
                pass
            server_sock.close()
            if acceptor is not None:
                acceptor.join(timeout=10.0)
            self.pool.close()


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(
        prog="vadc-torch-server",
        description="Multi-client VAD serving daemon on PyTorch and CUDA: raw s16le "
        "(or wav) in over TCP, speech segments out, per connection.",
    )
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=7355)
    p.add_argument("--max_streams", type=int, default=64)
    p.add_argument("--model", default=None,
                   help="a .testtensor archive of any family, or a v3 .onnx "
                        "(default: bundled Silero v3.1 16k)")
    p.add_argument("--fast", action="store_true", help="shorthand for --precision fast")
    p.add_argument("--precision", choices=PRECISIONS, default=None,
                   help="precision tier (default faithful, fp32); the bf16 tiers "
                        "balanced, fast and turbo run every family")
    p.add_argument("--sequence_count", type=int, default=1536)
    p.add_argument("--device", default="cuda", help="torch device: cuda (default), cuda:N or cpu")
    p.add_argument("--shard", action=argparse.BooleanOptionalAction, default=None,
                   help="serve over several devices (not ported yet)")
    p.add_argument("--resume", default=None, metavar="CKPT",
                   help="restore a server checkpoint (not ported yet)")
    args = p.parse_args(argv)
    precision = args.precision or ("fast" if args.fast else "faithful")
    try:
        if args.resume:
            raise NotImplementedError(
                "--resume: server checkpoints are not ported yet (ROADMAP.md, Queue 1: "
                "'Checkpoint')"
            )
        if args.shard:
            raise NotImplementedError(
                "--shard: serving over several devices is not ported yet (ROADMAP.md, "
                "Queue 1: 'Multi-GPU'); the server serves on the one --device"
            )
        server = VadServer(
            args.host,
            args.port,
            max_streams=args.max_streams,
            model=args.model,
            precision=precision,
            sequence_count=args.sequence_count,
            device=args.device,
        )
    except (FileNotFoundError, ValueError, NotImplementedError, NoCudaDeviceError,
            RuntimeError) as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        return 130
    return 0


if __name__ == "__main__":
    sys.exit(main())
