"""Attribute the serving RSS growth of the PyTorch/CUDA port's server: leak
vs allocator churn vs native growth. The counterpart of tools/rss_attrib.py.

A linear RSS growth through a serving run is either a real leak, glibc or
numpy allocator retention of per-tick churn, or growth in native code (the
CUDA runtime and the caching allocator's host side, the ctypes pool, socket
buffers). This experiment separates the three:

  * steady load of --clients on vadc_tpu_torch.server.VadServer, NO
    churn/faults/checkpoints (isolates the tick loop itself);
  * RSS sampled every second -> a slope, not two points;
  * tracemalloc snapshots at the warm point and at the end -> Python-visible
    growth by allocation site (numpy >= 1.22 reports its buffers through
    tracemalloc's domain API, so np churn shows up here);
  * the RSS-minus-tracemalloc residual = native-side growth.

Ticks are counted by the server's monotonic `tick_count`, not by its
bounded `tick_times` (which stops growing once full). The clients and the
RSS probe are tools/torch_serve_bench.py's.

Runs on the card unless `--device cpu` is given (without a card it exits 1
with one line). Imports nothing of JAX or of vadc_tpu.

Usage: python tools/torch_rss_attrib.py [--clients 64] [--seconds 60] [--rtf 4]
    [--precision turbo] [--device cuda|cpu]

Importable: run_rss_attrib(...) returns the figures as a dict.
"""

from __future__ import annotations

import argparse
import json
import sys
import threading
import time
import tracemalloc
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from tools.torch_serve_bench import SR, _Client, _cycle_pcm, _rss_mb  # noqa: E402


def run_rss_attrib(clients: int = 64, seconds: float = 60.0, rtf: float = 4.0,
                   precision: str = "turbo", device="cuda") -> dict:
    """The experiment; returns {"clients", "device", "postwarm_s",
    "postwarm_ticks", "tick_count", "rss_growth_mb", "rss_growth_mb_per_s",
    "python_growth_mb", "native_residual_mb", "top_sites": [(MB, site)],
    "rss_series": [(t_s, rss_mb, ticks)], "client_errors", "errors"}."""
    from vadc_tpu_torch import native
    from vadc_tpu_torch.runtime import resolve_device
    from vadc_tpu_torch.server import VadServer

    device = resolve_device(device)
    if not native.available():
        raise RuntimeError("native library unavailable (make -C native)")

    srv = VadServer(port=0, max_streams=clients, precision=precision, device=device)
    # serve_forever builds and warms the kernels before it accepts, and
    # closes the socket and the pool when stop() ends its engine loop
    server = threading.Thread(target=srv.serve_forever, daemon=True)
    server.start()
    while not srv.ready.wait(0.1):
        if not server.is_alive():
            raise RuntimeError("the server stopped before it was ready")
    port = srv.address[1]

    pcm_cycle, _ = _cycle_pcm(srv.chunk)
    cycle_s = len(pcm_cycle) / 2 / SR
    cycles = max(1, int(seconds * rtf / cycle_s))

    tracemalloc.start(10)
    samples: list[tuple[float, float, int]] = []  # (t, rss_mb, ticks)
    stop = threading.Event()

    def sampler() -> None:
        t0 = time.perf_counter()
        while not stop.is_set():
            samples.append((time.perf_counter() - t0, _rss_mb(), srv.tick_count))
            stop.wait(1.0)

    sth = threading.Thread(target=sampler, daemon=True)
    try:
        sth.start()
        streams = [_Client(port, pcm_cycle * cycles, 1, srv.chunk * 2, rtf)
                   for _ in range(clients)]
        for cl in streams:
            cl.start()
            time.sleep(0.002)

        # warm point: past the connection ramp and the first full cycle
        time.sleep(min(seconds * 0.4, 20.0))
        snap_warm = tracemalloc.take_snapshot()
        rss_warm = _rss_mb()
        ticks_warm = srv.tick_count
        t_warm = time.perf_counter()

        for cl in streams:
            cl.join(timeout=600)
        t_end = time.perf_counter()
        snap_end = tracemalloc.take_snapshot()
        rss_end = _rss_mb()
        ticks_end = srv.tick_count
    finally:
        stop.set()
        sth.join(timeout=5)
        tracemalloc.stop()
        srv.stop()
        server.join(timeout=60)

    postwarm_s = t_end - t_warm
    stats = snap_end.compare_to(snap_warm, "lineno")
    py_growth = sum(s.size_diff for s in stats) / 1e6
    rss_growth = rss_end - rss_warm
    errors = [cl.error for cl in streams if cl.error]
    return {
        "clients": clients,
        "precision": precision,
        "device": str(device),
        "postwarm_s": postwarm_s,
        "postwarm_ticks": ticks_end - ticks_warm,
        "tick_count": srv.tick_count,
        "rss_growth_mb": rss_growth,
        "rss_growth_mb_per_s": rss_growth / postwarm_s,
        "python_growth_mb": py_growth,
        "native_residual_mb": rss_growth - py_growth,
        "top_sites": [(s.size_diff / 1e6, str(s.traceback)) for s in stats[:12]
                      if abs(s.size_diff) > 1e5],
        "rss_series": [(round(t, 1), round(r, 1), n) for t, r, n in samples],
        "client_errors": len(errors),
        "errors": errors[:3],
    }


def print_report(r: dict) -> None:
    """tools/rss_attrib.py's lines."""
    print(f"\npost-warm window: {r['postwarm_s']:.1f} s, {r['postwarm_ticks']} ticks")
    print(f"RSS growth:            {r['rss_growth_mb']:8.1f} MB "
          f"({r['rss_growth_mb_per_s']:6.2f} MB/s)")
    print(f"tracemalloc (Python):  {r['python_growth_mb']:8.1f} MB")
    print(f"native residual:       {r['native_residual_mb']:8.1f} MB")
    print("\ntop Python growth sites:")
    for mb, site in r["top_sites"]:
        print(f"  {mb:+8.2f} MB  {site}")
    print("\nRSS time series (t_s, rss_mb, ticks):")
    print(json.dumps(r["rss_series"]))
    print(f"\nclient errors: {r['client_errors']}{r['errors']}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--clients", type=int, default=64)
    ap.add_argument("--seconds", type=float, default=60.0)
    ap.add_argument("--rtf", type=float, default=4.0)
    ap.add_argument("--precision", choices=("faithful", "balanced", "fast", "turbo"),
                    default="turbo")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default: the card, or exit 1 without one) or cpu")
    args = ap.parse_args(argv)

    from vadc_tpu_torch.runtime import NoCudaDeviceError

    try:
        r = run_rss_attrib(args.clients, args.seconds, args.rtf, args.precision, args.device)
    except NoCudaDeviceError as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1
    print_report(r)
    return 0


if __name__ == "__main__":
    sys.exit(main())
