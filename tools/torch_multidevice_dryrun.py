#!/usr/bin/env python3
"""Multi-process, multi-device dry run of the PyTorch/CUDA port's stream
sharding (vadc_tpu_torch/engine/distributed.py): the counterpart of
tools/multihost_dryrun.py.

Spawns 2 processes of 2 devices each, joined by torch.distributed over
gloo on a free localhost port (VADC_COORDINATOR, VADC_NUM_PROCESSES,
VADC_PROCESS_ID, as a real launch sets them). Each process runs a
MultiHostStreamEngine over its devices on its own slice of seeded streams
(Silero v3.1, the bundled weights; 8 streams in all on the CPU, 2048 on
cards): a step, a scan, a sharded checkpoint
save (save_sharded, one file a process, barriers around it), a scan from
the live state and the same scan from the state loaded back
(load_sharded), which must agree bit for bit. It then holds its
probabilities and final state against one unsharded StreamRunner over all
the streams in the same process: bit for bit on a card; on the CPU
probabilities within 1e-6 and (h, c) within 1e-4, the JAX package's bound
for its sharded runner against its unsharded one (the CPU's LSTM products
sum a 2-row batch in another order than an 8-row one, and the recurrent
state carries the difference: 1.1e-5 on c after 7 steps). Prints `MULTIDEVICE DRYRUN OK` when every process
passed; exits 1 otherwise.

    python tools/torch_multidevice_dryrun.py                # --device cuda (the default):
                                                            # ["cuda:0", "cuda:0"] a process
                                                            # on one card; distinct cards
                                                            # where there are four
    python tools/torch_multidevice_dryrun.py --device cpu   # ["cpu", "cpu"] a process
"""

from __future__ import annotations

import argparse
import os
import socket
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
PROCESSES = 2
DEVICES_PER_PROCESS = 2
CHUNK = 1536
SCAN_CHUNKS = 3
STREAMS = {"cpu": 8, "cuda": 2048}  # over all processes
SEED = 0
TIMEOUT_S = 600
TOL_CPU = {"probs": 1e-6, "state": 1e-4}


def local_devices(kind: str, process_id: int) -> list[str]:
    if kind == "cpu":
        return ["cpu"] * DEVICES_PER_PROCESS
    import torch

    if torch.cuda.device_count() >= PROCESSES * DEVICES_PER_PROCESS:
        first = process_id * DEVICES_PER_PROCESS
        return [f"cuda:{first + i}" for i in range(DEVICES_PER_PROCESS)]
    return ["cuda:0"] * DEVICES_PER_PROCESS


def seeded_chunks(total: int, seed: int) -> np.ndarray:
    """[total, 1 + 2 * SCAN_CHUNKS, CHUNK] of noise-like audio: a step's
    chunk, then two scans' worth."""
    rng = np.random.default_rng(seed)
    return (0.1 * rng.normal(size=(total, 1 + 2 * SCAN_CHUNKS, CHUNK))).astype(np.float32)


def worker(kind: str, prefix: str) -> None:
    import torch

    from vadc_tpu_torch.engine import distributed
    from vadc_tpu_torch.engine.checkpoint import load_sharded, save_sharded
    from vadc_tpu_torch.engine.runner import StreamRunner
    from vadc_tpu_torch.models.weights import DEFAULT_WEIGHTS, load_params

    torch.set_num_threads(1)
    distributed.initialize()
    pid = int(os.environ["VADC_PROCESS_ID"])
    devices = local_devices(kind, pid)
    _, params = load_params(DEFAULT_WEIGHTS)
    engine = distributed.MultiHostStreamEngine("v3", params, devices=devices)
    assert (engine.n_processes, engine.process_id) == (PROCESSES, pid)

    total = STREAMS[kind]
    chunks = seeded_chunks(total, SEED)
    local_n = total // PROCESSES
    local = chunks[pid * local_n : (pid + 1) * local_n]
    head, tail = local[:, 1 : 1 + SCAN_CHUNKS], local[:, 1 + SCAN_CHUNKS :]
    state = engine.init_state(total)
    p_step, state = engine.step(local[:, 0], state)
    p_head, state = engine.scan(head, state)
    path = save_sharded(engine, state, prefix)
    p_tail, state = engine.scan(tail, state)
    restored, ckpt = load_sharded(engine, prefix)
    p_again, again = engine.scan(tail, restored)
    if not (np.array_equal(p_again, p_tail) and torch.equal(again.h, state.h)
            and torch.equal(again.c, state.c)):
        raise AssertionError(f"process {pid}: the scan from {path.name} differs from the live one")

    # one unsharded single-process run over every stream
    ref = StreamRunner("v3", engine.runner.runners[0].params, device=devices[0])
    rs = ref.init_state(total)
    r_step, rs = ref.step(chunks[:, 0], rs)
    r_head, rs = ref.scan(chunks[:, 1 : 1 + SCAN_CHUNKS], rs)
    r_tail, rs = ref.scan(chunks[:, 1 + SCAN_CHUNKS :], rs)
    rows = slice(pid * local_n, (pid + 1) * local_n)
    pairs = {"step probs": (p_step, r_step[rows]), "scan probs": (p_head, r_head[rows]),
             "second scan probs": (p_tail, r_tail[rows]),
             "h": (state.h, rs.h[:, rows]), "c": (state.c, rs.c[:, rows])}
    for name, (got, want) in pairs.items():
        got, want = torch.as_tensor(got).cpu(), want.cpu()
        if kind == "cuda":
            ok = torch.equal(got, want)
            err = "not bit for bit"
        else:
            diff = float((got - want).abs().max())
            bound = TOL_CPU["state" if name in ("h", "c") else "probs"]
            ok, err = diff <= bound, f"max abs diff {diff:.3e} > {bound:.3e}"
        if not ok:
            raise AssertionError(f"process {pid}, {name} against the unsharded run: {err}")
    engine.barrier()
    torch.distributed.destroy_process_group()
    # one write of the whole line: the workers share the parent's stdout, and
    # unbuffered (PYTHONUNBUFFERED) print() writes the text and its newline
    # apart, so two workers' lines could run together
    sys.stdout.write(f"process {pid} of {PROCESSES} on {devices}: {local_n} of {total} streams, "
                     f"step, scans and sharded checkpoint ok ({ckpt.family}, "
                     f"{Path(path).name})\n")
    sys.stdout.flush()


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", choices=("cpu", "cuda"), default="cuda")
    p.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    p.add_argument("--prefix", default=None, help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.worker:
        worker(args.device, args.prefix)
        return 0
    if args.device == "cuda":
        import torch

        if not torch.cuda.is_available():
            print("Error: no CUDA device is visible to PyTorch", file=sys.stderr)
            return 1
    port = free_port()
    with tempfile.TemporaryDirectory() as tmp:
        procs = []
        for pid in range(PROCESSES):
            env = dict(os.environ, VADC_COORDINATOR=f"127.0.0.1:{port}",
                       VADC_NUM_PROCESSES=str(PROCESSES), VADC_PROCESS_ID=str(pid),
                       PYTHONPATH=os.pathsep.join(filter(None, [str(ROOT),
                                                                os.environ.get("PYTHONPATH")])))
            procs.append(subprocess.Popen(
                [sys.executable, __file__, "--worker", "--device", args.device,
                 "--prefix", str(Path(tmp) / "ckpt")],
                env=env, cwd=ROOT,
            ))
        rcs = []
        try:
            for proc in procs:
                rcs.append(proc.wait(timeout=TIMEOUT_S))
        except subprocess.TimeoutExpired:
            rcs.append("timeout")
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
    if rcs != [0] * PROCESSES:
        print(f"MULTIDEVICE DRYRUN FAILED: exit codes {rcs}", file=sys.stderr)
        return 1
    print("MULTIDEVICE DRYRUN OK", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
