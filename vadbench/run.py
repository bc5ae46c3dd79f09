"""Run one cell of the benchmark once and print its result.

    python3 -m vadbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

Needs a CUDA card (exits 3 without one, and prints no result). With
`--trace 0` the result's metrics are the cell's end-to-end metrics; with
`--trace 1` its per-layer metrics, read by vadbench/metrics/<name>.py from
a traced run. The last line on stdout is the result as one JSON object;
the numbers that decide `correct` are its last key, `checks`, and the last
lines on stderr. Exits 4 if the process loaded JAX or the JAX package.
"""

from __future__ import annotations

import time

T_PROCESS = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# every build and kernel cache of the program inside the checkout, at fixed
# paths (the port builds its CUDA library in vadc_tpu_torch/kernels/_build
# and the native pool in native/, both inside the checkout already)
os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(ROOT / ".vadbench_cache" / "torch_extensions"))
os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / ".vadbench_cache" / "triton"))
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def select_metrics(manifest: dict, workload: str, trace: bool) -> list[dict]:
    """The cell's end-to-end metrics (trace 0) or per-layer metrics (trace
    1): those with no `workloads` key and those that list the cell."""
    group = manifest["per_layer" if trace else "end_to_end"]
    return [m for m in group if workload in m.get("workloads", [workload])]


def result_line(cell, out: dict, metrics: list[dict], trace: bool, device: str) -> dict:
    import torch

    from vadbench import harness

    values = {}
    for m in metrics:
        value = (harness.metric_reader(m["name"])(out["run"]) if trace
                 else out["end_to_end"].get(m["name"]))
        if value is not None:
            values[m["name"]] = {"value": float(value), "unit": m["unit"]}
    dev = {"platform": "gpu" if device != "cpu" else "cpu",
           "kind": torch.cuda.get_device_name(0) if device != "cpu" else "cpu",
           "count": cell.chips, "memory_peak_bytes": out["memory_peak_bytes"]}
    line = {"correct": bool(out["correct"]), "attempted": int(out["attempted"]),
            "failed": int(out["failed"]), "metrics": values, "device": dev}
    trace_rec = out["run"].get("trace")
    if trace and trace_rec is not None:
        dev["busy_s"] = trace_rec.chip_busy_s(cell.chips)
        dev["window_s"] = trace_rec.window_s
        line["breakdown"] = out["breakdown"]
    # set-up by part (the kernel library's build or load apart), seconds
    line["setup_parts"] = out["setup_parts"]
    line["checks"] = {k: {"value": float(v), "limit": float(lim)}
                      for k, (v, lim) in out["checks"].items()}
    return line


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
             overrides: dict | None = None, t_process: float | None = None,
             control: bool = False) -> dict:
    """One run of the cell in this process -> the result line (a dict).
    `control` runs the cell's control: the plain reference in TF32 in the
    program's place."""
    from vadbench import harness

    cell = harness.cell(workload, overrides)
    out = harness.kind(cell.traffic["kind"]).run(
        cell, seed, seconds, trace, device, T_PROCESS if t_process is None else t_process,
        control=control)
    return result_line(cell, out, select_metrics(harness.manifest(), workload, trace), trace,
                       device)


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="vadbench.run", description=__doc__)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    try:
        import torch

        from vadbench import harness

        cell = harness.cell(args.workload)
        import vadc_tpu_torch  # noqa: F401  (the program under test)
    except ImportError as e:
        print(f"vadbench: cannot load the benchmark or the program: {e}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"vadbench: {args.workload} needs {cell.chips} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} visible",
              file=sys.stderr)
        return 3
    torch.cuda.reset_peak_memory_stats()
    line = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    loaded = harness.forbidden_modules()
    if loaded:
        print(f"vadbench: the run loaded {', '.join(loaded)}; no result", file=sys.stderr)
        return 4
    for name, c in line["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stdout.write(json.dumps(line) + "\n")
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
