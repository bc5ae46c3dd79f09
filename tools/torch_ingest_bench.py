"""Host-ingest capacity of the PyTorch/CUDA port's server: how many realtime
streams can the HOST side feed? The counterpart of tools/ingest_bench.py.

The device's chunk-step is measured with audio already on the card
(chip_smoke.py). This tool measures the other half of the serving path —
the native StreamPool (native/stream_pool.cpp, through the port's
vadc_tpu_torch/native.py) draining N live pipes, framing chunks, and the
batched segmentation FSM consuming the resulting probabilities — with NO
device in the loop, so the number is the pure host-side ceiling of the
server's tick.

Method: N pipes are fed s16le at MAX pace by writer threads (blocking writes;
the pool's ring backpressure paces them), while the engine-side loop runs
gather() + NativeFsm.feed() flat out for --seconds. Aggregate drained
samples/second divided by the stream sample rate = the equivalent number of
REALTIME streams this host configuration can sustain. Reported per component
(gather-only vs gather+FSM) so regressions attribute.

It touches no device, so it takes no --device flag. Imports nothing of JAX
or of vadc_tpu.

Run: python tools/torch_ingest_bench.py [--streams 512] [--seconds 8] [--json]

Importable: run_ingest(...) returns the rate stats as a dict.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from vadc_tpu_torch import native  # noqa: E402


def run_ingest(
    n_streams: int,
    seconds: float,
    chunk_samples: int = 1536,
    sample_rate: int = 16000,
    writer_threads: int = 8,
    with_fsm: bool = True,
    ring_chunks: int = 64,
) -> dict:
    """Drain n_streams max-pace pipes for `seconds`; return rate stats."""
    if not native.available():
        raise RuntimeError("native library unavailable (make -C native)")
    pool = native.StreamPool(n_streams, chunk_samples, ring_chunks=ring_chunks)
    fsm = (
        native.NativeFsm(
            n_streams,
            threshold=0.5,
            neg_threshold=0.35,
            min_silence_chunks=2,
            min_speech_chunks=3,
        )
        if with_fsm
        else None
    )
    pipes = [os.pipe() for _ in range(n_streams)]
    for i, (r, _w) in enumerate(pipes):
        pool.add_fd(i, r)

    stop = threading.Event()
    # one chunk of speech-ish s16le, reused (content is irrelevant to cost)
    rng = np.random.default_rng(0)
    payload = (rng.standard_normal(chunk_samples) * 8000).astype("<i2").tobytes()

    def writer(fds: list[int]) -> None:
        # each writer OWNS its write fds and closes them itself: the main
        # thread closing an fd another thread is blocked in os.write on
        # wouldn't wake it, and a racing reuse of the fd number would send
        # PCM into an unrelated file; teardown instead closes the READ
        # ends, which wakes blocked writers with EPIPE
        try:
            while not stop.is_set():
                for fd in fds:
                    try:
                        os.write(fd, payload)  # blocks on ring backpressure
                    except (BrokenPipeError, OSError):
                        return
        finally:
            for fd in fds:
                try:
                    os.close(fd)
                except OSError:
                    pass

    threads = []
    per = max(1, n_streams // writer_threads)
    for t in range(writer_threads):
        fds = [w for _, w in pipes[t * per : (t + 1) * per if t < writer_threads - 1 else n_streams]]
        if fds:
            th = threading.Thread(target=writer, args=(fds,), daemon=True)
            th.start()
            threads.append(th)

    pool.start()
    # warm: let rings fill and the reader thread reach steady state
    warm_until = time.perf_counter() + 0.5
    while time.perf_counter() < warm_until:
        pool.gather()

    chunks = 0
    gathers = 0
    fsm_events = 0
    t0 = time.perf_counter()
    deadline = t0 + seconds
    while time.perf_counter() < deadline:
        batch, ready, count, _ = pool.gather()
        gathers += 1
        chunks += count
        if fsm is not None and count:
            # synthetic alternating probabilities exercise the FSM's full
            # trigger/close path, the production per-tick host work
            probs = ready.astype(np.float32)[:, None] * (
                0.9 if (gathers & 7) < 4 else 0.1
            )
            fsm_events += len(fsm.feed(probs, active=ready > 0))
    elapsed = time.perf_counter() - t0

    stop.set()
    pool.close()
    # closing the read ends wakes writers blocked in os.write (EPIPE);
    # each writer then closes its own write fds on exit
    for r, _ in pipes:
        try:
            os.close(r)
        except OSError:
            pass
    for th in threads:
        th.join(timeout=5)

    samples_per_s = chunks * chunk_samples / elapsed
    return {
        "streams": n_streams,
        "chunk_samples": chunk_samples,
        "seconds": round(elapsed, 3),
        "chunks_drained": chunks,
        "gathers": gathers,
        "fsm": with_fsm,
        "fsm_events": fsm_events,
        "samples_per_s": round(samples_per_s),
        "mb_per_s_s16": round(samples_per_s * 2 / 1e6, 1),
        "realtime_streams_equiv": round(samples_per_s / sample_rate),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--streams", type=int, default=512)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--chunk", type=int, default=1536)
    ap.add_argument("--writer_threads", type=int, default=8)
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args(argv)

    rows = []
    for with_fsm in (False, True):
        r = run_ingest(
            args.streams,
            args.seconds,
            chunk_samples=args.chunk,
            writer_threads=args.writer_threads,
            with_fsm=with_fsm,
        )
        rows.append(r)
        label = "gather+fsm" if with_fsm else "gather-only"
        print(
            f"{label:12s} {r['streams']} pipes: {r['mb_per_s_s16']:8.1f} MB/s "
            f"= {r['realtime_streams_equiv']:>7,} realtime streams equiv "
            f"({r['chunks_drained']} chunks / {r['seconds']}s)",
            file=sys.stderr,
        )
    if args.json:
        print(json.dumps({"rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
