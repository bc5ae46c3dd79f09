"""tools/gpu_check.py, the port's regression tier, on the CPU: every check
of tools/tpu_check.py under its name (read from tpu_check's source), the
port's added checks, and the probes; with the plain versions every bound
holds. Without a card main() exits 2 and prints one line, as tpu_check
does off a TPU. On the card the same checks hold the CUDA kernels
(chip_smoke.py's tools phase, `python tools/gpu_check.py`)."""

import re
from pathlib import Path

import pytest
import torch

from tests.torch_port_util import single_torch_thread  # noqa: F401
from tools import gpu_check

ROOT = Path(__file__).resolve().parent.parent
# the checks the port adds beside tpu_check's
ADDED = {"forward_fused", "encode_fused_audio", "stft_magnitude_v4", "stft_magnitude_v5",
         "probe_bf16_dot_exact_6", "probe_bf16_dot_wgmma_exact_6", "probe_concat_dot_vs_fp32",
         "probe_bf16_dot_seeded", "probe_bf16_dot_wgmma_seeded",
         "probe_concat_dot_vs_bf16_3x_seeded", "probe_concat_dot_vs_fp32_seeded"}
CONTROLS = {"control_single_bf16_pass_vs_fp32", "control_bf16_dot_k_cut_to_32"}


def tpu_check_names() -> set:
    """The names tpu_check.main gives its checks (the golden ones, which
    need the reference fixtures, aside)."""
    src = (ROOT / "tools" / "tpu_check.py").read_text()
    return {n for n in re.findall(r'check\(\s*"([a-z0-9_]+)"', src) if not n.startswith("golden")}


@pytest.fixture(scope="module")
def summary():
    return gpu_check.run_checks("cpu")


def test_tpu_checks_names_are_read():
    assert tpu_check_names() == {
        "lstm_fused", "lstm_decoder_fused", "stft_dotmag_kernel", "fused2d_forward_state_carry",
        "fused3d_forward_state_carry", "fast_vs_faithful_probability",
        "balanced_vs_faithful_probability", "speech_balanced_vs_faithful",
        "speech_fast_vs_faithful", "speech_turbo_vs_faithful"}


def test_run_checks_on_the_cpu_passes_and_names_every_check(summary):
    assert summary["check"] == "gpu_kernels"
    assert summary["ok"] is True and summary["failures"] == []
    assert set(summary["results"]) == tpu_check_names() | ADDED | CONTROLS
    assert set(summary) == {"check", "ok", "failures", "seconds", "results", "probes"}
    assert set(summary["probes"]) == {"probe_concat_dot_vs_fp32", "bf16_dot_vs_bf16_dot_wgmma"}


def test_the_speech_ladder_is_held_to_the_ports_bound(summary, capsys):
    from vadc_tpu_torch.kernels.tier_check import SPEECH_BOUND

    for tier, bound in SPEECH_BOUND["v3"].items():
        got = summary["results"][f"speech_{tier}_vs_faithful"]
        assert 0.0 < got <= bound
    assert gpu_check.TPU_SPEECH_BOUND == {"balanced": 3e-3, "fast": 3e-2, "turbo": 1e-1}


def test_the_golden_tier_skips_without_fixtures(tmp_path, capsys):
    check = gpu_check.Checks()
    gpu_check.golden_checks("cpu", check, tmp_path / "absent")
    assert check.results == {}
    assert capsys.readouterr().err == "golden fixtures unavailable; skipping fidelity tier\n"


def test_a_check_fails_above_its_bound_and_a_control_below_it(capsys):
    check = gpu_check.Checks()
    check("a", 0.5, 1.0)
    check("b", 2.0, 1.0)
    check.control("c", 2.0, 1.0)
    check.control("d", 0.5, 1.0)
    assert check.failures == ["b", "d"]
    out = capsys.readouterr().out
    assert "ok" in out and "FAIL" in out and "breaks" in out and "holds" in out


def test_main_without_a_card_exits_2_with_one_line(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert gpu_check.main() == 2
    captured = capsys.readouterr()
    assert captured.out == ""
    assert len(captured.err.strip().splitlines()) == 1 and "no CUDA device" in captured.err


def test_run_checks_refuses_a_missing_card(monkeypatch):
    from vadc_tpu_torch.runtime import NoCudaDeviceError

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(NoCudaDeviceError):
        gpu_check.run_checks("cuda")


def test_the_probes_bounds_count_tensor_core_operations():
    """The probes' bound (chip_smoke.products_bound_ms): a bf16 product's
    operations at the bf16 tensor-core peak, bf16_3x's three times, or the
    bytes at the memory rate, whichever is larger."""
    from chip_smoke import products_bound_ms

    ms, by = products_bound_ms(1.0, (989e12 * 1e-3, "bf16"))
    assert by == "operations" and ms == pytest.approx(1.0)
    ms, by = products_bound_ms(1.0, (989e12 * 1e-3, "bf16_3x"))
    assert by == "operations" and ms == pytest.approx(3.0)
    ms, by = products_bound_ms(3.35e12 * 2e-3, (1.0, "bf16"))
    assert by == "bytes" and ms == pytest.approx(2.0)
