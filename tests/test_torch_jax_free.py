"""vadc_tpu_torch runs where JAX is not installed (the machine with the
card has none): in a fresh interpreter where `import jax` fails, every
module of the package imports, the CPU path runs and the CLI answers.
chip_smoke.py and chip_profile.py, which drive the port on the card,
import no JAX and nothing of vadc_tpu themselves, and without a card they
exit non-zero with no result line."""

import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
PACKAGE = ROOT / "vadc_tpu_torch"

_BLOCK_JAX = "import sys; sys.modules['jax'] = None\n"

_DRIVE = _BLOCK_JAX + """
import importlib, io, contextlib
modules = [
    "vadc_tpu_torch", "vadc_tpu_torch.runtime", "vadc_tpu_torch.nn.functional",
    "vadc_tpu_torch.models.weights", "vadc_tpu_torch.models.silero_v31",
    "vadc_tpu_torch.engine.runner", "vadc_tpu_torch.kernels._build",
    "vadc_tpu_torch.kernels.stft_dotmag", "vadc_tpu_torch.kernels.silero_v31_fused2d",
    "vadc_tpu_torch.kernels.silero_v31_fused3d", "vadc_tpu_torch.cli.main",
    "vadc_tpu_torch.kernels.stft_mag", "vadc_tpu_torch.kernels.lstm",
    "vadc_tpu_torch.models.silero_v4", "vadc_tpu_torch.models.silero_v5",
    "vadc_tpu_torch.models.synthetic",
]
for name in modules:
    importlib.import_module(name)
import numpy as np, torch
from vadc_tpu_torch.cli.main import DEFAULT_WEIGHTS, main
from vadc_tpu_torch.engine.runner import StreamRunner
from vadc_tpu_torch.models.weights import load_params
_, params = load_params(DEFAULT_WEIGHTS)
runner = StreamRunner("v3", params, device="cpu")
probs, _ = runner.scan(np.zeros((2, 2, 1536), np.float32), runner.init_state(2))
assert probs.shape == (2, 2) and bool(torch.isfinite(probs).all())
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
loaded = sorted(k for k, v in sys.modules.items() if v is not None and k.split(".")[0] == "jax")
assert not loaded, loaded
"""


def _python(code: str, cwd: Path = ROOT) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_package_imports_and_runs_without_jax():
    proc = _python(_DRIVE)
    assert proc.returncode == 0, proc.stderr
    probs = np.array(proc.stdout.split(), float)
    assert probs.shape == (3,) and ((probs >= 0) & (probs <= 1)).all(), proc.stdout


def test_no_source_of_the_port_names_jax():
    pattern = re.compile(r"^\s*(import jax|from jax)\b", re.M)
    sources = sorted(PACKAGE.rglob("*.py")) + [ROOT / "chip_smoke.py", ROOT / "chip_profile.py"]
    assert len(sources) > 10
    for path in sources:
        assert not pattern.search(path.read_text()), path
    # the card's scripts reach vadc_tpu only through the port's sanctioned
    # JAX-free imports (vadc_tpu.io, vadc_tpu.cli.segmenter/stats)
    vadc_tpu = re.compile(r"^\s*(import vadc_tpu|from vadc_tpu)\b", re.M)
    for name in ("chip_smoke.py", "chip_profile.py"):
        assert not vadc_tpu.search((ROOT / name).read_text()), name


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
