"""vadc_tpu_torch runs where neither JAX nor the JAX package can be
imported (the machine with the card has no JAX, and the port imports nothing
of vadc_tpu, not even its numpy-only modules: it keeps its own copies): in a
fresh interpreter where `import jax` and `import vadc_tpu` both fail, every
module of the package imports, the CPU path runs, the CLI and the batch CLI
answer and the server serves a client. The port's tools (TOOLS) and its
live-stream examples (EXAMPLES) import neither either.
chip_smoke.py, chip_profile.py and chip_ab.py, which drive the port on the
card, import neither, and without a card they exit non-zero with no result
line."""

import importlib.util
import os
import re
import select
import signal
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
PACKAGE = ROOT / "vadc_tpu_torch"

# `import jax`, `import vadc_tpu` and any `from vadc_tpu.x import y` raise
# ImportError in the interpreter this prefixes
#: the port's tools: none imports jax or vadc_tpu
TOOLS = ("torch_multidevice_dryrun.py", "gpu_check.py", "torch_fidelity_report.py",
         "torch_accuracy_eval.py", "torch_serve_bench.py", "torch_soak.py",
         "torch_bench_stages.py", "torch_ingest_bench.py", "torch_rss_attrib.py",
         "torch_tensor_image.py", "torch_validate_v5.py")

#: the port's live-stream examples: neither imports jax or vadc_tpu
EXAMPLES = ("serve_streams_torch.py", "serve_pool_torch.py")

_BLOCK_JAX = "import sys; sys.modules['jax'] = None; sys.modules['vadc_tpu'] = None\n"

_DRIVE = _BLOCK_JAX + """
import importlib, importlib.util, io, contextlib, pkgutil, tempfile
import vadc_tpu_torch
modules = ["vadc_tpu_torch"] + sorted(
    m.name for m in pkgutil.walk_packages(vadc_tpu_torch.__path__, "vadc_tpu_torch."))
assert len(modules) > 30 and "vadc_tpu_torch.cli.batch" in modules, modules
assert {"vadc_tpu_torch.nn.precision", "vadc_tpu_torch.engine.onnx_backend",
        "vadc_tpu_torch.export.onnx_exec", "vadc_tpu_torch.export.silero_v5_from_onnx",
        "vadc_tpu_torch.export.silero_v4_from_onnx",
        "vadc_tpu_torch.kernels.tier_check", "vadc_tpu_torch.engine.checkpoint",
        "vadc_tpu_torch.api", "vadc_tpu_torch.cli.cut",
        "vadc_tpu_torch.cli.filter_script", "vadc_tpu_torch.engine.shard",
        "vadc_tpu_torch.engine.distributed", "vadc_tpu_torch.tracing",
        "vadc_tpu_torch.kernels.probes", "vadc_tpu_torch.io.degrade",
        "vadc_tpu_torch.export.pack", "vadc_tpu_torch.export.onnx_build",
        "vadc_tpu_torch.export.torch_export"} <= set(modules), modules
for name in modules:
    importlib.import_module(name)
for script in ("chip_smoke.py", "chip_profile.py", "chip_ab.py",
               "tools/torch_multidevice_dryrun.py", "tools/gpu_check.py",
               "tools/torch_fidelity_report.py", "tools/torch_accuracy_eval.py",
               "tools/torch_serve_bench.py", "tools/torch_soak.py",
               "tools/torch_bench_stages.py", "tools/torch_ingest_bench.py",
               "tools/torch_rss_attrib.py", "tools/torch_tensor_image.py",
               "tools/torch_validate_v5.py", "examples/serve_streams_torch.py",
               "examples/serve_pool_torch.py"):
    spec = importlib.util.spec_from_file_location(script.split("/")[-1][:-3], script)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
for blocked in ("jax", "vadc_tpu"):
    try:
        importlib.import_module(blocked)
    except ImportError:
        pass
    else:
        raise AssertionError(blocked + " is importable: the block does not hold")
import numpy as np, torch
from vadc_tpu_torch.cli.main import DEFAULT_WEIGHTS, main
from vadc_tpu_torch.engine.runner import StreamRunner
from vadc_tpu_torch.models.weights import load_params
_, params = load_params(DEFAULT_WEIGHTS)
runner = StreamRunner("v3", params, device="cpu")
probs, _ = runner.scan(np.zeros((2, 2, 1536), np.float32), runner.init_state(2))
assert probs.shape == (2, 2) and bool(torch.isfinite(probs).all())
from vadc_tpu_torch.engine.distributed import MultiHostStreamEngine
engine = MultiHostStreamEngine("v3", params, devices=["cpu", "cpu"])
p, _ = engine.scan(np.zeros((2, 2, 1536), np.float32), engine.init_state(2))
assert p.shape == (2, 2)
for tier in ("balanced", "fast", "turbo"):
    r = StreamRunner("v3", params, device="cpu", precision=tier)
    p, _ = r.scan(np.zeros((2, 2, 1536), np.float32), r.init_state(2))
    assert bool(torch.isfinite(p).all())
from vadc_tpu_torch.models.synthetic import random_v5_8k_archive, random_v5_archive
from vadc_tpu_torch.models.weights import load_params_from_tensors
for family, path, chunk in (("v4", DEFAULT_WEIGHTS.parent / "silero_v4_16k.testtensor", 1536),
                            ("v4_8k", DEFAULT_WEIGHTS.parent / "silero_v4_8k.testtensor", 768)):
    got, p = load_params(path)
    assert got == family
    r = StreamRunner(family, p, device="cpu")
    probs, _ = r.scan(np.zeros((2, 2, chunk), np.float32), r.init_state(2))
    assert bool(torch.isfinite(probs).all())
for family, archive, chunk in (("v5", random_v5_archive(0), 512),
                               ("v5_8k", random_v5_8k_archive(1), 256)):
    got, p = load_params_from_tensors(archive)
    assert got == family
    r = StreamRunner(family, p, device="cpu")
    probs, st = r.scan(np.zeros((2, 2, chunk), np.float32), r.init_state(2))
    assert bool(torch.isfinite(probs).all()) and st.context is not None
sys.stdin = io.TextIOWrapper(io.BytesIO(b"\\0\\0" * 1536 * 3))
with contextlib.redirect_stderr(io.StringIO()):
    assert main(["--device", "cpu", "--raw_probabilities"]) == 0
from vadc_tpu_torch.cli import batch
with tempfile.TemporaryDirectory() as tmp:
    pcm = tmp + "/silence.s16le"
    open(pcm, "wb").write(b"\\0\\0" * 1536 * 3)
    with contextlib.redirect_stdout(io.StringIO()) as out:
        assert batch.main([pcm, "--device", "cpu"]) == 0
    assert out.getvalue() == ""
from vadc_tpu_torch import api
assert api.speech_probabilities(np.zeros(3072, np.float32), device="cpu").shape == (2,)
spec = importlib.util.spec_from_file_location("serve_streams_torch", "examples/serve_streams_torch.py")
serve_streams = importlib.util.module_from_spec(spec)
spec.loader.exec_module(serve_streams)
with tempfile.TemporaryDirectory() as tmp:
    pcm = tmp + "/silence.s16le"
    open(pcm, "wb").write(b"\\0\\0" * 1536 * 3)
    with contextlib.redirect_stdout(io.StringIO()) as out, \\
            contextlib.redirect_stderr(io.StringIO()) as err:
        assert serve_streams.main(["--device", "cpu", pcm, pcm]) == 0
    assert out.getvalue() == "" and "# 2 streams x 3 chunks" in err.getvalue(), err.getvalue()
loaded = sorted(k for k, v in sys.modules.items()
                if v is not None and k.split(".")[0] in ("jax", "jaxlib", "vadc_tpu"))
assert not loaded, loaded
"""


def _python(code: str, cwd: Path = ROOT) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_package_imports_and_runs_without_jax():
    """Also without vadc_tpu: every module of the port (found by walking the
    package), chip_smoke.py, chip_profile.py, chip_ab.py, the port's tools
    and its examples import; the runners (the sharded one too), the CLI,
    the batch CLI, the Python API and serve_streams_torch run on the CPU."""
    proc = _python(_DRIVE)
    assert proc.returncode == 0, proc.stderr
    probs = np.array(proc.stdout.split(), float)
    assert probs.shape == (3,) and ((probs >= 0) & (probs <= 1)).all(), proc.stdout


def test_no_source_of_the_port_names_jax():
    """No file of the port, nor the card's three scripts and the port's tools
    (the multi-device dry run, the regression tier, the fidelity report, the
    accuracy evaluation, the serving bench, the soak, the per-stage timing,
    the ingest bench, the RSS attribution, the tensor image dump and the v5
    validation harness), imports jax or anything of vadc_tpu, at module
    level or inside a function."""
    pattern = re.compile(r"^\s*(import jax|from jax|import vadc_tpu|from vadc_tpu)\b", re.M)
    sources = sorted(PACKAGE.rglob("*.py")) + [ROOT / "chip_smoke.py", ROOT / "chip_profile.py",
                                               ROOT / "chip_ab.py"] + [
        ROOT / "tools" / name for name in TOOLS] + [ROOT / "examples" / name for name in EXAMPLES]
    assert len(sources) > 30
    for path in sources:
        assert not pattern.search(path.read_text()), path
    assert pattern.search("    from vadc_tpu.io import wav") and pattern.search("import vadc_tpu")
    assert not pattern.search("from vadc_tpu_torch.io import wav\nimport vadc_tpu_torch")


def test_silenceremove_torch_runs_only_the_port():
    """examples/silenceremove_torch.sh runs the port's detector and filter
    script, and no module of the JAX package."""
    text = (ROOT / "examples" / "silenceremove_torch.sh").read_text()
    assert not re.search(r"\bvadc_tpu\.", text), text
    assert "python -m vadc_tpu_torch.cli.main " in text
    assert "python -m vadc_tpu_torch.cli.filter_script " in text
    assert re.search(r"\bvadc_tpu\.", (ROOT / "examples" / "silenceremove.sh").read_text())


def test_chip_smoke_without_a_card_exits_nonzero_without_a_result():
    code = _BLOCK_JAX + (
        "import runpy, torch\n"
        "torch.cuda.is_available = lambda: False\n"
        "sys.argv = ['chip_smoke.py']\n"
        "runpy.run_path('chip_smoke.py', run_name='__main__')\n"
    )
    proc = _python(code)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout and "no CUDA device" in proc.stderr


def test_chip_profile_without_a_card_exits_nonzero():
    code = _BLOCK_JAX + (
        "import runpy, torch\n"
        "torch.cuda.is_available = lambda: False\n"
        "sys.argv = ['chip_profile.py']\n"
        "runpy.run_path('chip_profile.py', run_name='__main__')\n"
    )
    proc = _python(code)
    assert proc.returncode != 0
    assert not proc.stdout and "no CUDA device" in proc.stderr


def test_chip_ab_without_a_card_exits_nonzero():
    code = _BLOCK_JAX + (
        "import runpy, torch\n"
        "torch.cuda.is_available = lambda: False\n"
        "sys.argv = ['chip_ab.py']\n"
        "runpy.run_path('chip_ab.py', run_name='__main__')\n"
    )
    proc = _python(code)
    assert proc.returncode != 0
    assert not proc.stdout and "no CUDA device" in proc.stderr


_SERVE = _BLOCK_JAX + (
    "import runpy\n"
    "runpy.run_module('vadc_tpu_torch.server', run_name='__main__', alter_sys=True)\n"
)


def _synthetic_file(path: Path) -> None:
    """chip_smoke.py's (and the verify recipe's) 12 s file of two voiced
    spans, as raw s16le."""
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    smoke.synthetic_file(path)


def _banner_port(proc: subprocess.Popen, timeout: float = 60.0) -> int:
    """The port of the server's 'vadc-torch server on HOST:PORT' line."""
    deadline = time.monotonic() + timeout
    seen = ""
    while time.monotonic() < deadline:
        ready, _, _ = select.select([proc.stderr], [], [], 0.5)
        if ready:
            line = proc.stderr.readline()
            seen += line
            m = re.search(r"vadc-torch server on [^:]+:(\d+) ", line)
            if m:
                return int(m.group(1))
            if not line and proc.poll() is not None:
                break
    raise AssertionError(f"no banner within {timeout} s: {seen!r}")


def test_server_module_serves_and_stops_without_jax(tmp_path):
    """`python -m vadc_tpu_torch.server --device cpu --port 0` with JAX
    blocked: it announces its port, answers a client with the two segments
    of the synthetic file, and exits 130 on SIGINT."""
    pcm = tmp_path / "synthetic.s16le"
    _synthetic_file(pcm)
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.Popen(
        [sys.executable, "-c", _SERVE, "--device", "cpu", "--port", "0", "--max_streams", "2"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    )
    try:
        port = _banner_port(proc)
        c = socket.create_connection(("127.0.0.1", port), timeout=60)
        try:
            c.sendall(pcm.read_bytes())
            c.shutdown(socket.SHUT_WR)
            data = b""
            while chunk := c.recv(4096):
                data += chunk
        finally:
            c.close()
        lines = data.decode().split()
        # the JAX CLI's segments of this file (the first end sits on a
        # borderline chunk: 5.12 or 5.21)
        assert len(lines) == 2 and lines[0] in ("1.99,5.12", "1.99,5.21"), lines
        assert lines[1] == "6.98,10.21", lines
        proc.send_signal(signal.SIGINT)
        assert proc.wait(timeout=60) == 130
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        proc.stdout.close()
        proc.stderr.close()
