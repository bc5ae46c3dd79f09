"""The port's multi-process engine (vadc_tpu_torch/engine/distributed.py) on
the CPU.

The dry run (tools/torch_multidevice_dryrun.py --device cpu): 2 processes
of 2 CPU devices each over gloo on a free localhost port, each held to an
unsharded run of the same seeded streams and to its own sharded checkpoint
(about 4 s, so it stays in tier-1). In one process, without a process
group: the engine's feeding and layout, its refusal of a stream count that
does not divide, its local state, and its scan against the JAX package's
MultiHostStreamEngine on the conftest's 8 virtual devices (probabilities
within 1e-4, the whole-model bound of tests/test_torch_fused_audio.py).
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from tests.conftest import assert_close
from tests.torch_port_util import jax_and_port_params
from tests.torch_port_util import single_torch_thread  # noqa: F401
from vadc_tpu_torch.engine import distributed
from vadc_tpu_torch.engine.shard import ShardedState

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def v31():
    return jax_and_port_params()


def test_dryrun_two_processes_of_two_devices_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run(
        [sys.executable, str(ROOT / "tools" / "torch_multidevice_dryrun.py"), "--device", "cpu"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.splitlines()
    assert lines[-1] == "MULTIDEVICE DRYRUN OK", proc.stdout
    assert sum("sharded checkpoint ok" in line for line in lines) == 2, proc.stdout


def test_engine_in_one_process_without_a_group(v31):
    """No process group: one process, id 0; the local slice is all streams;
    probabilities come back as numpy in feed order; local_state and
    state_from_local are each other's inverse."""
    engine = distributed.MultiHostStreamEngine("v3", v31[1], devices=["cpu"] * 4)
    assert (engine.n_processes, engine.process_id) == (1, 0)
    engine.barrier()  # a no-op alone
    with pytest.raises(ValueError, match=r"n_streams 6 must divide over 4 devices"):
        engine.init_state(6)
    state = engine.init_state(8)
    assert isinstance(state, ShardedState) and state.n_streams == 8 and state.n_processes == 1
    rng = np.random.default_rng(7)
    probs, state = engine.scan((0.1 * rng.normal(size=(8, 2, 1536))).astype(np.float32), state)
    assert isinstance(probs, np.ndarray) and probs.shape == (8, 2)
    local = engine.local_state(state)
    assert local.h.device.type == "cpu" and local.h.shape == (2, 8, 64)
    back = engine.state_from_local(local)
    assert torch.equal(back.h, state.h) and torch.equal(back.c, state.c)
    p1, _ = engine.step(np.zeros((8, 1536), np.float32), state)
    p2, _ = engine.step(np.zeros((8, 1536), np.float32), back)
    np.testing.assert_array_equal(p1, p2)


def test_engine_scan_matches_the_jax_engine(v31):
    """16 streams over 8 devices in both packages, a T=3 scan."""
    from vadc_tpu.engine.distributed import MultiHostStreamEngine as JaxEngine

    jax_engine = JaxEngine("v3", v31[0])
    port = distributed.MultiHostStreamEngine("v3", v31[1], devices=["cpu"] * 8)
    chunks = (0.1 * np.random.default_rng(8).normal(size=(16, 3, 1536))).astype(np.float32)
    pj, _ = jax_engine.scan(chunks, jax_engine.init_state(16))
    pt, _ = port.scan(chunks, port.init_state(16))
    assert_close(pt, pj, 1e-4, "engine scan probs")


def test_initialize_needs_the_cluster_spelled_out(monkeypatch):
    """Nothing discovers a cluster: without the address, the count and the
    id (arguments or the JAX package's variables) initialize refuses."""
    for name in ("VADC_COORDINATOR", "VADC_NUM_PROCESSES", "VADC_PROCESS_ID"):
        monkeypatch.delenv(name, raising=False)
    with pytest.raises(ValueError, match="VADC_COORDINATOR, VADC_NUM_PROCESSES"):
        distributed.initialize()
    monkeypatch.setenv("VADC_COORDINATOR", "127.0.0.1:1")
    with pytest.raises(ValueError):
        distributed.initialize(num_processes=2)
