"""The lower-precision control of a cell: the plain reference put in the
program's place at the precision just below the configuration's (fp32 with
TF32 off -> TF32), on the cell's own traffic at its own size. The run is
the cell's own (`vadbench.run`), with the reference's probabilities handed
to the program's segmenter in place of the program's, so the comparison
that decides the cell's `correct` judges the control too.

    python3 -m vadbench.control --workload <name> --seed <n> [--seconds <s>]

Prints one JSON line: the cell's checks as the control reads them beside
their limits, and `correct`, which has to come out false. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def readings(workload: str, seed: int, seconds: float, device: str = "cuda",
             overrides: dict | None = None) -> dict:
    """The control's run of `workload` -> its correct and checks."""
    from vadbench import run

    line = run.run_cell(workload, seed, seconds, False, device=device, overrides=overrides,
                        t_process=time.monotonic(), control=True)
    return {"workload": workload, "seed": seed, "control": "reference in TF32",
            "correct": line["correct"], "checks": line["checks"]}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="vadbench.control", description=__doc__)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("vadbench.control: needs a CUDA card", file=sys.stderr)
        return 3
    print(json.dumps(readings(args.workload, args.seed, args.seconds)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
