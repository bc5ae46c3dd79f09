"""Sustained multi-client serving benchmark of the PyTorch/CUDA port's
server (vadc_tpu_torch.server.VadServer): the counterpart of
tools/serve_bench.py, with its clients.

Drives a live VadServer with N concurrent TCP clients streaming synthetic
speech at (a multiple of) realtime for a fixed duration, with optional
connect/disconnect churn waves, a checkpoint wave under load and fault
clients (slowloris, a reader that does not read, mid-wav aborts, malformed
wav headers), then reports:

  * per-tick latency p50/p99 (device step + FSM + emission, measured inside
    the engine loop), and the server's tick_count;
  * segment-emission and delivery latency p50/p99;
  * aggregate audio throughput (seconds of audio served / wall);
  * segment delivery accounting (every client validates its own count);
  * the host RSS growth after warm-up, raw: the baseline is taken after the
    first tick at full occupancy (the caching allocator and the pinned
    buffers grow until then), and the growth after it is held to 64 MB.
    serve_bench.py's model of a remote device plugin's per-transfer leak
    has no counterpart: nothing here transfers through such a plugin.

Runs on the card unless `--device cpu` is given (exits 1 without a card).
Imports nothing of JAX or of vadc_tpu.

Usage:
    python tools/torch_serve_bench.py [--clients 64] [--seconds 30] [--rtf 4]
        [--precision turbo] [--churn] [--checkpoint] [--faults] [--device cuda|cpu]

Importable: run_serving_bench(...) returns the metrics dict.
"""

from __future__ import annotations

import argparse
import json
import socket
import sys
import tempfile
import threading
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np

SR = 16000
#: the largest raw RSS growth after warm-up (serve_bench.py's bound)
RSS_GROWTH_LIMIT_MB = 64.0


def _speechlike(duration_s: float, f0: float = 120.0) -> np.ndarray:
    # the library generator carries the third formant, phase jitter, and
    # the aspiration floor the accuracy/soak tooling depends on
    from vadc_tpu_torch.io.synthaudio import voiced

    return voiced(duration_s, f0, SR)


def _cycle_pcm(chunk_samples: int) -> tuple[bytes, int]:
    """One 3 s voiced + 2 s silence cycle, padded to a whole number of
    chunks. Returns (pcm bytes, expected segments per cycle = 1)."""
    from vadc_tpu_torch.io.pcm import f32_to_s16le

    audio = np.concatenate(
        [_speechlike(3.0), 0.001 * np.random.default_rng(0).normal(size=2 * SR).astype(np.float32)]
    )
    pad = (-len(audio)) % chunk_samples
    audio = np.concatenate([audio, np.zeros(pad, np.float32)])
    return f32_to_s16le(audio), 1


class _Client(threading.Thread):
    """Streams `cycles` audio cycles at `rtf` x realtime in chunk-sized
    writes, then half-closes and collects segment lines."""

    def __init__(self, port: int, pcm_cycle: bytes, cycles: int, chunk_bytes: int, rtf: float):
        super().__init__(daemon=True)
        self.port = port
        self.pcm = pcm_cycle * cycles
        self.cycles = cycles
        self.chunk_bytes = chunk_bytes
        self.rtf = rtf
        self.segments: list[tuple[float, float]] = []
        self.error: str | None = None
        self.audio_seconds = len(self.pcm) / 2 / SR

    def run(self) -> None:
        try:
            c = socket.create_connection(("127.0.0.1", self.port), timeout=30)
        except OSError as e:
            self.error = f"connect: {e}"
            return
        lines = []
        recv_buf = b""
        # Writes stay BLOCKING (with a generous timeout): under engine
        # saturation the server stops reading a backpressured stream and the
        # kernel send buffer fills — a non-blocking sendall would raise
        # BlockingIOError and miscount throttled clients as errors; the
        # correct client behavior is to wait for writability. Reads are
        # polled via select() so they never block the pacing loop.
        import select as _select

        c.settimeout(60)
        chunk_period = (self.chunk_bytes / 2 / SR) / self.rtf
        # poll(), NOT select(): at >=1024 concurrent clients the fd numbers
        # exceed FD_SETSIZE and select() raises "filedescriptor out of
        # range" — found live by the 1024-client bench config
        poller = _select.poll()
        poller.register(c, _select.POLLIN)
        try:
            next_t = time.perf_counter()
            for off in range(0, len(self.pcm), self.chunk_bytes):
                c.sendall(self.pcm[off : off + self.chunk_bytes])
                next_t += chunk_period
                while True:
                    delay = next_t - time.perf_counter()
                    if delay <= 0:
                        break
                    # block in poll for the whole pacing delay, waking
                    # early only when the server has data — a poll-and-
                    # sleep(5ms) loop here costs ~200 wakeups/s/client,
                    # which at the 1k-client scale saturates the single
                    # host core with context switches before any audio moves
                    if poller.poll(delay * 1000):
                        data = c.recv(4096)
                        if not data:  # server closed early; drain loop below
                            break
                        recv_buf += data
            c.shutdown(socket.SHUT_WR)
            c.settimeout(60)
            while True:
                data = c.recv(4096)
                if not data:
                    break
                recv_buf += data
        except OSError as e:
            self.error = f"stream: {e}"
        finally:
            c.close()
        for line in recv_buf.decode().splitlines():
            if line.startswith("error"):
                self.error = line
            else:
                lines.append(tuple(float(x) for x in line.split(",")))
        self.segments = lines


def _pct(xs, q):
    if not xs:
        return None
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(len(xs) * q))]


class _SlowlorisClient(threading.Thread):
    """Dribbles single bytes at a crawl for `seconds`, then closes. The
    classic slot-exhaustion attack: a healthy server must keep ticking the
    other slots and recycle this one on close without error."""

    def __init__(self, port: int, seconds: float, byte_period_s: float = 0.05):
        super().__init__(daemon=True)
        self.port = port
        self.seconds = seconds
        self.byte_period_s = byte_period_s
        self.error: str | None = None

    def run(self) -> None:
        try:
            c = socket.create_connection(("127.0.0.1", self.port), timeout=30)
            end = time.perf_counter() + self.seconds
            while time.perf_counter() < end:
                c.sendall(b"\x00")
                time.sleep(self.byte_period_s)
            c.close()
        except OSError as e:
            self.error = f"slowloris: {e}"


class _SlowReaderClient(threading.Thread):
    """Streams audio at pace but REFUSES to read its socket until its
    stream is done (tiny SO_RCVBUF forces early backpressure): the server's
    per-slot outbox must absorb the unread segment lines without stalling
    the engine tick, then deliver every line intact at EOF flush."""

    def __init__(self, port: int, pcm: bytes, chunk_bytes: int, rtf: float):
        super().__init__(daemon=True)
        self.port = port
        self.pcm = pcm
        self.chunk_bytes = chunk_bytes
        self.rtf = rtf
        self.segments: list[tuple[float, float]] = []
        self.error: str | None = None

    def run(self) -> None:
        try:
            c = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            c.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 2048)
            c.settimeout(30)
            c.connect(("127.0.0.1", self.port))
            period = (self.chunk_bytes / 2) / SR / self.rtf
            for off in range(0, len(self.pcm), self.chunk_bytes):
                c.sendall(self.pcm[off : off + self.chunk_bytes])
                time.sleep(period)
            c.shutdown(socket.SHUT_WR)
            c.settimeout(60)
            data = b""
            while True:
                got = c.recv(4096)
                if not got:
                    break
                data += got
            c.close()
            self.segments = [
                tuple(float(x) for x in line.split(","))
                for line in data.decode().strip().splitlines()
                if line and not line.startswith("error")
            ]
        except OSError as e:
            self.error = f"slowreader: {e}"


class _MidWavDisconnectClient(threading.Thread):
    """Sends a valid wav header + partial frames, then ABORTS the
    connection (RST via SO_LINGER 0) mid-decode. The intake thread must
    exit cleanly and the slot must recycle."""

    def __init__(self, port: int):
        super().__init__(daemon=True)
        self.port = port
        self.error: str | None = None

    def run(self) -> None:
        import io
        import struct
        import wave

        buf = io.BytesIO()
        with wave.open(buf, "wb") as w:
            w.setnchannels(2)
            w.setsampwidth(2)
            w.setframerate(44100)
            w.writeframes(np.zeros(44100 * 2, "<i2").tobytes())
        payload = buf.getvalue()[: len(buf.getvalue()) // 2]
        try:
            c = socket.create_connection(("127.0.0.1", self.port), timeout=30)
            c.sendall(payload)
            time.sleep(0.2)  # let the decoder start
            c.setsockopt(
                socket.SOL_SOCKET, socket.SO_LINGER, struct.pack("ii", 1, 0)
            )
            c.close()  # RST
        except OSError as e:
            self.error = f"midwav: {e}"


class _MalformedWavClient(threading.Thread):
    """RIFF/WAVE magic followed by a garbage chunk layout: the server must
    answer with a one-line `error: ...` diagnosis, never die or hang."""

    def __init__(self, port: int):
        super().__init__(daemon=True)
        self.port = port
        self.error: str | None = None
        self.diagnosed = False

    def run(self) -> None:
        bad = b"RIFF" + (9999).to_bytes(4, "little") + b"WAVE" + b"\xde\xad" * 64
        try:
            c = socket.create_connection(("127.0.0.1", self.port), timeout=30)
            c.sendall(bad)
            c.shutdown(socket.SHUT_WR)
            c.settimeout(30)
            data = b""
            while True:
                got = c.recv(4096)
                if not got:
                    break
                data += got
            c.close()
            self.diagnosed = data.decode(errors="replace").startswith("error:")
        except OSError as e:
            self.error = f"malformed: {e}"


def _rss_mb() -> float:
    """RSS after returning freed arena pages to the OS: glibc retains
    freed memory in per-thread arenas, and a serving run spawns hundreds
    of short-lived client/fault threads — without malloc_trim their
    retained-but-dead arenas read as ~100+ MB of phantom 'growth' and the
    leak signal drowns. trim(0) releases exactly the freed pages, so what
    remains in RSS is live memory."""
    try:
        import ctypes

        ctypes.CDLL("libc.so.6").malloc_trim(0)
    except OSError:
        pass
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) / 1024.0
    return 0.0




def run_serving_bench(
    n_clients: int = 64,
    seconds: float = 30.0,
    rtf: float = 4.0,
    precision: str = "turbo",
    model: str | None = None,
    churn: bool = False,
    checkpoint: bool = False,
    faults: bool = False,
    ckpt_period_s: float = 2.0,
    device="cuda",
) -> dict:
    from vadc_tpu_torch import native
    from vadc_tpu_torch.server import VadServer

    if not native.available():
        raise RuntimeError("native library unavailable (make -C native)")

    # churn waves get their own slot headroom so recycling is exercised
    # without starving the steady clients
    srv = VadServer(
        port=0,
        max_streams=n_clients + (2 if churn else 0) + (4 if faults else 0),
        model=model,
        precision=precision,
        device=device,
    )
    # serve_forever builds and warms the kernels (one idle tick and one idle
    # catch-up tick) before it accepts: no client pays the build, and the
    # ticks measured are the clients'
    server = threading.Thread(target=srv.serve_forever, daemon=True)
    server.start()
    while not srv.ready.wait(0.1):
        if not server.is_alive():
            raise RuntimeError("the server stopped before it was ready")
    port = srv.address[1]
    ticks_ready = srv.tick_count

    pcm_cycle, segs_per_cycle = _cycle_pcm(srv.chunk)
    cycle_s = len(pcm_cycle) / 2 / SR
    cycles = max(1, int(seconds * rtf / cycle_s))

    # RSS: the baseline after the first tick at full occupancy (every
    # steady client holds a slot), when the caching allocator and the
    # pinned staging have grown to the run's size; growth after it is
    # leak-shaped
    rss_before = _rss_mb()
    rss_warm_box: dict = {}

    def _warm_probe():
        while not srv._stop.is_set():
            if srv.n - len(srv._free) >= n_clients:
                at = srv.tick_count
                while srv.tick_count == at and not srv._stop.is_set():
                    time.sleep(0.001)
                rss_warm_box["ticks"] = srv.tick_count
                rss_warm_box["mb"] = _rss_mb()
                return
            time.sleep(0.005)

    threading.Thread(target=_warm_probe, daemon=True).start()

    t0 = time.perf_counter()
    # build the full stream ONCE and share it (bytes * 1 returns the same
    # object): per-client copies would put the bench's own buffers on the
    # heap that the RSS probe reads
    pcm_full = pcm_cycle * cycles
    clients = [
        _Client(port, pcm_full, 1, srv.chunk * 2, rtf) for _ in range(n_clients)
    ]
    for cl in clients:
        cl.start()
        time.sleep(0.002)  # connection ramp, not a thundering herd

    churn_clients: list[_Client] = []
    churn_thread = None
    churn_stop = threading.Event()
    if churn:
        # connect/disconnect waves on top of the steady load: short-lived
        # clients that stream exactly one cycle then leave, forcing slot
        # recycling while other slots are mid-stream
        def churner():
            while not churn_stop.is_set() and any(cl.is_alive() for cl in clients):
                c = _Client(port, pcm_cycle, 1, srv.chunk * 2, rtf)
                churn_clients.append(c)
                c.start()
                c.join(timeout=120)
                time.sleep(0.05)  # let the slot recycle before the next wave

        churn_thread = threading.Thread(target=churner, daemon=True)
        churn_thread.start()

    # fault accounting by counters, not retained thread objects
    fault_counts = {"midwav": 0, "malformed": 0, "malformed_diagnosed": 0}
    slow: _SlowlorisClient | None = None
    fault_waves: list[threading.Thread] = []
    if faults:
        # fault wave rides ON TOP of the steady load (and churn, when on):
        # a crawling writer holding a slot, repeated mid-wav-decode aborts,
        # and malformed wav headers — all while checkpoints may fire
        slow = _SlowlorisClient(port, min(seconds, 10.0))
        slow.start()
        slow_reader = _SlowReaderClient(
            port, pcm_cycle * 2, srv.chunk * 2, rtf
        )
        slow_reader.start()

        def abort_wave():
            while any(cl.is_alive() for cl in clients):
                t = _MidWavDisconnectClient(port)
                t.start()
                t.join(timeout=60)
                fault_counts["midwav"] += 1
                time.sleep(0.3)  # slot recycle before the next abort

        def malformed_wave():
            while any(cl.is_alive() for cl in clients):
                t = _MalformedWavClient(port)
                t.start()
                t.join(timeout=60)
                fault_counts["malformed"] += 1
                fault_counts["malformed_diagnosed"] += bool(t.diagnosed)
                time.sleep(0.5)

        for wave in (abort_wave, malformed_wave):
            th = threading.Thread(target=wave, daemon=True)
            fault_waves.append(th)
            th.start()

    ckpt_times_ms: list[float] = []
    ckpt_stop = threading.Event()
    ckpt_thread = None
    ckpt_dir = tempfile.TemporaryDirectory()
    ckpt_path = Path(ckpt_dir.name) / "serve_bench.ckpt"
    if checkpoint:
        # repeating checkpoint wave, not a single save: each save must not
        # stall the engine tick, and the save latency itself is a reported
        # serving metric
        def ckpt_wave():
            while not ckpt_stop.is_set() and any(cl.is_alive() for cl in clients):
                if ckpt_stop.wait(ckpt_period_s):
                    break
                t = time.perf_counter()
                srv.save_checkpoint(ckpt_path)
                ckpt_times_ms.append((time.perf_counter() - t) * 1e3)

        ckpt_thread = threading.Thread(target=ckpt_wave, daemon=True)
        ckpt_thread.start()

    for cl in clients:
        cl.join(timeout=600)
    wall = time.perf_counter() - t0
    # the churner's current client may still be mid-stream when the steady
    # clients finish — join it before the server stops and results are read
    if churn_thread is not None:
        churn_stop.set()
        churn_thread.join(timeout=180)
    if ckpt_thread is not None:
        ckpt_stop.set()
        ckpt_thread.join(timeout=120)
        if not ckpt_times_ms:
            # run too short for the wave cadence — still exercise one save
            # under whatever load remains so checkpoint_under_load is real
            t = time.perf_counter()
            srv.save_checkpoint(ckpt_path)
            ckpt_times_ms.append((time.perf_counter() - t) * 1e3)
    fault_results: dict = {}
    if faults:
        # finalize the fault wave and probe health BEFORE the server stops
        for th in fault_waves:  # wave generators first (they spawn clients)
            th.join(timeout=120)
        if slow is not None:
            slow.join(timeout=60)
        # post-fault health probe: one fresh client must still get exact
        # segment delivery after every fault class has fired
        probe = _Client(port, pcm_cycle, 1, srv.chunk * 2, rtf)
        probe.start()
        probe.join(timeout=120)
        slow_reader.join(timeout=120)
        fault_results = {
            "fault_slowloris_errors": int(bool(slow is not None and slow.error)),
            "fault_slowreader_delivery_exact": slow_reader.error is None
            and len(slow_reader.segments) == 2 * segs_per_cycle,
            "fault_midwav_aborts": fault_counts["midwav"],
            "fault_malformed": fault_counts["malformed"],
            "fault_malformed_diagnosed": fault_counts["malformed_diagnosed"],
            "post_fault_delivery_exact": len(probe.segments) == segs_per_cycle
            and probe.error is None,
        }
    srv.stop()
    server.join(timeout=60)
    ckpt_dir.cleanup()
    rss_end = _rss_mb()
    rss_warm = rss_warm_box.get("mb", rss_end)
    rss_postwarm_growth = round(rss_end - rss_warm, 1)

    expected = cycles * segs_per_cycle
    delivered = [len(cl.segments) for cl in clients]
    errors = [cl.error for cl in clients if cl.error]
    audio_total = sum(cl.audio_seconds for cl in clients)
    ticks = [t * 1e3 for t in srv.tick_times]
    emits = [t * 1e3 for t in srv.emit_latencies]
    dels = [t * 1e3 for t in srv.delivery_latencies]
    result = {
        "clients": n_clients,
        "precision": precision,
        "device": str(srv.device),
        "rtf_per_client": rtf,
        "wall_s": round(wall, 2),
        "audio_seconds_served": round(audio_total, 1),
        "aggregate_realtime_x": round(audio_total / wall, 1),
        "expected_segments_per_client": expected,
        "delivered_min": min(delivered),
        "delivered_max": max(delivered),
        "delivery_exact": delivered.count(expected),
        "client_errors": len(errors),
        # every device call after the warm-up (ticks, catch-up ticks and
        # reset-only ticks), counted by the server
        "tick_count": srv.tick_count - ticks_ready,
        "tick_p50_ms": round(_pct(ticks, 0.50), 2) if ticks else None,
        "tick_p99_ms": round(_pct(ticks, 0.99), 2) if ticks else None,
        "ticks_measured": len(ticks),
        # ticks that drained TWO queued chunks per stream — the engine was
        # behind cadence and recovering
        "catchup_ticks": srv.catchup_ticks,
        "emit_p50_ms": round(_pct(emits, 0.50), 3) if emits else None,
        "emit_p99_ms": round(_pct(emits, 0.99), 3) if emits else None,
        # client-observed: queued -> kernel, incl. outbox parking (a
        # non-reading fault client deliberately dominates the p99 when
        # --faults is on)
        "delivery_p50_ms": round(_pct(dels, 0.50), 3) if dels else None,
        "delivery_p99_ms": round(_pct(dels, 0.99), 3) if dels else None,
        "segments_dropped": srv.segments_dropped,
        "churn_clients": len(churn_clients),
        "churn_errors": sum(1 for c in churn_clients if c.error),
        # warm-up: from before the first client to the first tick at full
        # occupancy; postwarm: the raw growth after it
        "rss_warm_at_tick": rss_warm_box.get("ticks"),
        "rss_warmup_mb": round(rss_warm - rss_before, 1),
        "rss_postwarm_growth_mb": rss_postwarm_growth,
        "rss_postwarm_ok": rss_postwarm_growth <= RSS_GROWTH_LIMIT_MB,
    }
    if checkpoint:
        result["checkpoint_under_load"] = "ok"
        result["ckpt_saves"] = len(ckpt_times_ms)
        result["ckpt_save_p50_ms"] = round(_pct(ckpt_times_ms, 0.50), 1)
        result["ckpt_save_max_ms"] = round(max(ckpt_times_ms), 1)
    result.update(fault_results)
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--clients", type=int, default=64)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--rtf", type=float, default=4.0,
                    help="per-client feed rate as a multiple of realtime")
    ap.add_argument("--precision",
                    choices=("faithful", "balanced", "fast", "turbo"),
                    default="turbo")
    ap.add_argument("--model", default=None)
    ap.add_argument("--churn", action="store_true")
    ap.add_argument("--checkpoint", action="store_true")
    ap.add_argument("--faults", action="store_true",
                    help="inject slowloris / mid-wav-abort / malformed-wav "
                         "clients during the run and probe post-fault health")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default: the card, or exit 1 without one) or cpu")
    args = ap.parse_args(argv)

    from vadc_tpu_torch.runtime import NoCudaDeviceError

    try:
        result = run_serving_bench(
            n_clients=args.clients,
            seconds=args.seconds,
            rtf=args.rtf,
            precision=args.precision,
            model=args.model,
            churn=args.churn,
            checkpoint=args.checkpoint,
            faults=args.faults,
            device=args.device,
        )
    except NoCudaDeviceError as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
