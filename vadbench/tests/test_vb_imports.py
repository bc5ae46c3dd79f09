"""Nothing the benchmark runs loads JAX or the JAX package: each loaded
module's whole top-level name is checked (the port's own name,
vadc_tpu_torch, begins with the JAX package's)."""

import os
import subprocess
import sys

from conftest import ROOT

from vadbench import harness

PROBE = r"""
import sys, time
from vadbench import run, harness, control
from vadbench.kinds import corpus
from vadbench.reference import silero, segmenter, testtensor
from vadbench.traffic import audio
import vadc_tpu_torch.cli.batch
for m in [m["name"] for m in harness.manifest()["per_layer"]]:
    harness.metric_reader(m)
harness.Record().install_call_sites()
line = run.run_cell("v31.corpus.512", 3, 1.0, True, device="cpu",
                    overrides={"files": 2, "file_s": [2.0, 3.0], "sample_streams": 1},
                    t_process=time.monotonic())
print(",".join(harness.forbidden_modules()) or "none")
print(",".join(sorted({m.split(".", 1)[0] for m in sys.modules})))
"""


def test_whole_names_are_compared():
    mods = dict(sys.modules)
    try:
        sys.modules["vadc_tpu_torch_fake.x"] = object()
        sys.modules.pop("vadc_tpu", None)
        assert "vadc_tpu" not in harness.forbidden_modules()
        sys.modules["vadc_tpu.cli"] = object()
        assert "vadc_tpu" in harness.forbidden_modules()
    finally:
        sys.modules.clear()
        sys.modules.update(mods)


def test_a_run_loads_no_jax_and_no_jax_package(tmp_path):
    # the run writes only under the HOME, XDG_CACHE_HOME and TMPDIR it is given
    env = {"PATH": os.environ.get("PATH", "/usr/bin:/bin"), "PYTHONPATH": str(ROOT)}
    for name in ("HOME", "XDG_CACHE_HOME", "TMPDIR"):
        env[name] = str(tmp_path / name.lower())
        os.makedirs(env[name])
    out = subprocess.run([sys.executable, "-c", PROBE], cwd=ROOT, capture_output=True,
                         text=True, timeout=600, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    forbidden, loaded = out.stdout.strip().splitlines()[-2:]
    assert forbidden == "none"
    tops = set(loaded.split(","))
    assert "vadc_tpu_torch" in tops and "torch" in tops
    assert not tops & {"jax", "jaxlib", "flax", "vadc_tpu"}
