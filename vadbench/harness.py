"""What every cell of the benchmark shares: the manifest and the files it
names, the profiler window, the record of launched shapes and host spans,
and the checks of a run's process.

Each configuration, model family, traffic mix, limit set and per-layer metric
is a file of its own, found by the name `BENCHMARK.json` (or the configuration)
gives it:

    vadbench/configs/<config>.json      sizes, weights, precision, reference, family
    vadbench/families/<family>.py       the model's operations a chunk (metrics/counts.py)
    vadbench/traffic/<traffic>.json     parameters; "kind" names the module below
    vadbench/kinds/<kind>.py            drives the program under that kind of traffic
    vadbench/limits/<workload>.json     the limits that decide `correct`
    vadbench/metrics/<metric>.py        read(run) -> value or None
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
HERE = Path(__file__).resolve().parent
#: top-level module names that may not be loaded in a run's process
FORBIDDEN = ("jax", "jaxlib", "flax", "vadc_tpu")


@dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    limits: dict
    chips: int = 1


def manifest() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def _json(path: Path) -> dict:
    return json.loads(path.read_text())


def cell(name: str, overrides: dict | None = None) -> Cell:
    """The workload `name` of BENCHMARK.json with its configuration, traffic
    and limits; `overrides` replaces traffic parameters (the tests' tiny
    sizes)."""
    w = next((w for w in manifest()["workloads"] if w["name"] == name), None)
    if w is None:
        raise SystemExit(f"vadbench: no workload {name!r} in BENCHMARK.json")
    return cell_of(name, w["config"], w["traffic"], w["chips"], overrides)


def cell_of(name: str, config: str, traffic: str, chips: int = 1,
            overrides: dict | None = None) -> Cell:
    """A cell from its files: vadbench/configs/<config>.json (or the file
    BENCHMARK.json names for it), traffic/<traffic>.json, limits/<name>.json."""
    entry = next((c for c in manifest()["configs"] if c["name"] == config), None)
    path = ROOT / entry["file"] if entry else HERE / "configs" / f"{config}.json"
    return Cell(name, {**_json(path), "name": config},
                {**_json(HERE / "traffic" / f"{traffic}.json"), "name": traffic,
                 **(overrides or {})},
                _json(HERE / "limits" / f"{name}.json"), chips)


def kind(name: str):
    """The module that drives the program under traffic of kind `name`."""
    return importlib.import_module(f"vadbench.kinds.{name}")


def reference(config: dict):
    return importlib.import_module(f"vadbench.reference.{config['reference']}")


def _metric_module(path: Path):
    spec = importlib.util.spec_from_file_location(
        f"vadbench_metric_{path.stem.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def metric_reader(name: str):
    """vadbench/metrics/<name>.py, loaded by path (names hold dots)."""
    return _metric_module(HERE / "metrics" / f"{name}.py").read


def call_sites() -> dict:
    """CALL_SITES below, with those that a per-layer reader declares as its
    own (a module-level CALL_SITES in vadbench/metrics/<name>.py, in the same
    form), so that a new kernel's roofline comes as a file of its own."""
    sites = dict(CALL_SITES)
    for path in sorted((HERE / "metrics").glob("*.py")):
        if path.stem not in ("__init__", "counts", "shared"):
            sites.update(getattr(_metric_module(path), "CALL_SITES", {}))
    return sites


def forbidden_modules() -> list[str]:
    """Loaded modules whose whole top-level name is forbidden."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)} & set(FORBIDDEN))


def quantile(values, q: float) -> float:
    """numpy's linear-interpolation quantile (q in [0, 1])."""
    return float(np.quantile(np.asarray(values, np.float64), q))


# ---- what the traced run records from outside the program ---------------

def _stft_shape(a, k) -> tuple:
    return (*a[0].shape, k["pad_left"], k["pad_right"], k["hop"], *a[1].shape)


#: call sites of the kernels the rooflines read: (module, attribute) ->
#: the kernel's name in the record and a function of the call's arguments
#: giving the launched shape
CALL_SITES = {
    ("vadc_tpu_torch.models.silero_v31", "encode_fused_audio"):
        ("encode_fused_audio", lambda a, k: tuple(a[1].shape)),
    ("vadc_tpu_torch.models.silero_v31", "lstm_decoder_fused"):
        ("lstm_decoder_fused", lambda a, k: tuple(a[0].shape)),
    ("vadc_tpu_torch.models.silero_v4", "stft_magnitude"):
        ("stft_magnitude", _stft_shape),
    ("vadc_tpu_torch.models.silero_v5", "stft_magnitude"):
        ("stft_magnitude", _stft_shape),
    # x [B, T, width], w [layers, 4 x hidden, 2 x hidden]
    ("vadc_tpu_torch.models.slab", "lstm_fused"):
        ("lstm_fused", lambda a, k: (*a[0].shape, a[3].shape[0], a[3].shape[1] // 4)),
}


@dataclass
class Record:
    """Launched shapes by kernel, and host spans (label, start, end), taken
    while `on` is set."""

    on: bool = False
    calls: dict = field(default_factory=dict)
    spans: list = field(default_factory=list)
    _undo: list = field(default_factory=list)

    def install_call_sites(self) -> None:
        for (mod_name, attr), (kernel, shape_of) in call_sites().items():
            mod = importlib.import_module(mod_name)
            inner = getattr(mod, attr)

            def wrapped(*a, _inner=inner, _kernel=kernel, _shape=shape_of, **k):
                if self.on:
                    self.calls.setdefault(_kernel, []).append(_shape(a, k))
                return _inner(*a, **k)

            setattr(mod, attr, wrapped)
            self._undo.append((mod, attr, inner))

    def span(self, owner, attr: str, label: str) -> None:
        """Wrap owner.attr so that each call is a host span `label`."""
        inner = getattr(owner, attr)

        def wrapped(*a, **k):
            t0 = time.monotonic()
            try:
                return inner(*a, **k)
            finally:
                if self.on:
                    self.spans.append((label, t0, time.monotonic()))

        setattr(owner, attr, wrapped)
        self._undo.append((owner, attr, inner))

    def restore_later(self, owner, attr: str, inner) -> None:
        """Put `inner` back as owner.attr at `uninstall`."""
        self._undo.append((owner, attr, inner))

    def uninstall(self) -> None:
        for owner, attr, inner in reversed(self._undo):
            setattr(owner, attr, inner)
        self._undo.clear()


class DeviceTrace:
    """torch.profiler over a stretch of the window, device activity only.
    `begin` and `end` are called with the device idle (after a
    synchronization); `begin` launches one marker op whose device start
    ties the profiler's clock to time.monotonic()."""

    def __init__(self, device):
        import torch

        self.torch, self.device = torch, device
        self.prof = None
        self.events: list = []  # (name, start, duration), seconds, monotonic clock
        self.chip_busy: dict = {}  # card index -> seconds busy (its events' union)
        self.t_begin = self.t_end = 0.0

    def warm(self) -> None:
        """One empty profile in set-up: the profiler's first start is slow."""
        self.begin()
        self.end()
        self.prof = None

    def begin(self) -> None:
        torch = self.torch
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.start()
        torch.cuda.synchronize(self.device)
        # the marker: a short spin on a stream of its own, so that it starts
        # at once whatever another thread has queued on the device
        side = torch.cuda.Stream(self.device)
        with torch.cuda.stream(side):
            self.t_begin = time.monotonic()
            torch.cuda._sleep(1000)
        side.synchronize()

    def end(self) -> None:
        """Stop the profiler; `collect` reads its events later, off the
        traced path."""
        self.torch.cuda.synchronize(self.device)
        self.t_end = time.monotonic()
        self.prof.stop()

    def collect(self) -> None:
        raw = []
        for e in self.prof.profiler.kineto_results.events():
            if e.device_type() != self.torch.autograd.DeviceType.CUDA or e.is_user_annotation():
                continue
            raw.append((e.name(), e.start_ns() * 1e-9, e.duration_ns() * 1e-9, e.device_index()))
        self.prof = None
        raw.sort(key=lambda r: r[1])
        marker = next((r for r in raw if "spin_kernel" in r[0]), raw[0] if raw else None)
        raw = [r for r in raw if r is not marker]
        # the marker started at t_begin (on the first card; the profiler
        # puts every card's events on one clock)
        offset = marker[1] - self.t_begin if marker else 0.0
        self.events = [(n, s - offset, d) for n, s, d, _dev in raw]
        self.chip_busy = {dev: _union_s([(s, d) for _n, s, d, k in raw if k == dev])
                          for dev in {r[3] for r in raw}}

    @property
    def window_s(self) -> float:
        return self.t_end - self.t_begin

    def busy_intervals(self) -> list:
        """The union of the device events' intervals (every card's)."""
        return _union([(s, d) for _n, s, d in self.events])

    def busy_s(self) -> float:
        return _union_s([(s, d) for _n, s, d in self.events])

    def chip_busy_s(self, chips: int) -> float:
        """Seconds in which an operation ran on a card, averaged over
        `chips` cards: each card's own union of its events, a card with
        none counting 0."""
        return float(sum(self.chip_busy.values())) / chips

    def idle_gaps(self) -> list:
        """(start, end) of each stretch of the traced window with nothing on
        the device."""
        gaps, t = [], self.t_begin
        for s, e in self.busy_intervals():
            if s > t:
                gaps.append((t, s))
            t = max(t, e)
        if self.t_end > t:
            gaps.append((t, self.t_end))
        return gaps

    def breakdown(self, spans: list, outside: str) -> dict:
        """The top device operations by time, and the idle time by the host
        span (innermost, the latest begun) under each gap's midpoint."""
        by_op: dict = {}
        for n, _s, d in self.events:
            by_op[n] = by_op.get(n, 0.0) + d
        ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:10]
        spans = sorted(spans, key=lambda s: s[1])
        starts = np.array([s[1] for s in spans]) if spans else np.zeros(0)
        idle: dict = {}
        for g0, g1 in self.idle_gaps():
            mid = 0.5 * (g0 + g1)
            label = outside
            for j in range(int(np.searchsorted(starts, mid, "right")) - 1, -1, -1):
                if spans[j][1] <= mid <= spans[j][2]:
                    label = spans[j][0]
                    break
                if mid - spans[j][1] > 60.0:
                    break
            n, total, longest = idle.get(label, (0, 0.0, 0.0))
            idle[label] = (n + 1, total + (g1 - g0), max(longest, g1 - g0))
        gaps = sorted(idle.items(), key=lambda kv: -kv[1][1])[:10]
        return {
            "device_ops": [[name[:160], float(t)] for name, t in ops],
            "idle_gaps": [[f"{label} ({n} gaps, longest {longest * 1e3:.3f} ms)", float(total)]
                          for label, (n, total, longest) in gaps],
        }


def _union(intervals) -> list:
    """(start, duration) pairs, sorted by start -> their union as [start,
    end] runs."""
    out = []
    for s, d in intervals:
        e = s + d
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _union_s(intervals) -> float:
    return float(sum(e - s for s, e in _union(intervals)))
