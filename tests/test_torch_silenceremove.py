"""examples/silenceremove_torch.sh against examples/silenceremove.sh: the
detector CLI, the filter script, then ffmpeg's re-encode. A stub `ffmpeg`
first on PATH records its argv; on the verify recipe's synthetic wav (the
material tests/test_torch_cli.py holds to the JAX CLI's segments) both
scripts pass ffmpeg the same `-af` filter. Without --device the port's
detector asks for the card: here the script fails before ffmpeg runs."""

import os
import stat
import subprocess

import pytest

from tests.torch_port_util import ROOT, single_torch_thread  # noqa: F401

_STUB = "#!/bin/sh\nprintf '%s\\0' \"$@\" > \"$FFMPEG_ARGV\"\n"


@pytest.fixture(scope="module")
def media(tmp_path_factory):
    """(the synthetic wav, a directory holding the stub ffmpeg)."""
    import importlib.util

    root = tmp_path_factory.mktemp("silenceremove")
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    smoke.synthetic_file(root / "synthetic.s16le")
    bin_dir = root / "bin"
    bin_dir.mkdir()
    stub = bin_dir / "ffmpeg"
    stub.write_text(_STUB)
    stub.chmod(stub.stat().st_mode | stat.S_IXUSR)
    return root / "synthetic.wav", bin_dir


def _run(script: str, media, out_name: str, *extra: str) -> tuple:
    """(the script's CompletedProcess, the stub ffmpeg's argv or None)."""
    import jax

    wav, bin_dir = media
    argv_file = wav.parent / f"{out_name}.argv"
    env = dict(os.environ, PATH=f"{bin_dir}{os.pathsep}{os.environ['PATH']}",
               FFMPEG_ARGV=str(argv_file), JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT))
    # the JAX CLI's compile cache on the suite's own (tests/conftest.py)
    if jax.config.jax_compilation_cache_dir:
        env["VADC_TPU_CACHE_DIR"] = jax.config.jax_compilation_cache_dir
    proc = subprocess.run(["bash", str(ROOT / "examples" / script), str(wav),
                           str(wav.parent / out_name), *extra],
                          cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    argv = argv_file.read_text().split("\0")[:-1] if argv_file.exists() else None
    return proc, argv


def test_port_script_passes_ffmpeg_the_jax_scripts_filter(media):
    jax_proc, jax_argv = _run("silenceremove.sh", media, "jax.wav")
    assert jax_proc.returncode == 0, jax_proc.stderr
    proc, argv = _run("silenceremove_torch.sh", media, "port.wav", "--device", "cpu")
    assert proc.returncode == 0, proc.stderr
    wav = media[0]
    assert jax_argv == ["-hide_banner", "-i", str(wav), "-af", jax_argv[4],
                        str(wav.parent / "jax.wav")]
    assert argv == [*jax_argv[:5], str(wav.parent / "port.wav")]
    # two speech ranges (tests/test_torch_cli.py: 1.99,5.12 and 6.98,10.21)
    assert argv[4].startswith("asetpts=N/SR/TB, aselect='between(t,1.99")
    assert argv[4].count("between") == 2


def test_port_script_without_a_card_stops_before_ffmpeg(media):
    proc, argv = _run("silenceremove_torch.sh", media, "nocard.wav")
    assert proc.returncode != 0
    assert argv is None
    assert "Error: no CUDA device" in proc.stderr
