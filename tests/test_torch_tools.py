"""The port's tools on the CPU, held to the JAX package's where there is one:
tools/torch_accuracy_eval.py (scores and degradation rows equal to
tools/accuracy_eval.py's through vadc_tpu on the CPU, faithful tier),
tools/torch_fidelity_report.py (on fixtures this test writes from seeded
inputs and the JAX ops' outputs, in the reference's layout), the serving
bench with its fault clients, the soak, and the tools' device rule: each
runs on the card unless asked for the CPU, and without a card exits 1
(tools/torch_multidevice_dryrun.py too; tools/torch_bench_stages.py,
torch_rss_attrib.py and torch_validate_v5.py as well, whose CPU tests are
in tests/test_torch_tools_stages.py)."""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import jax.numpy as jnp

from tools import accuracy_eval as j_acc
from tools import fidelity_report as j_fid
from tools import torch_accuracy_eval as t_acc
from tools import torch_fidelity_report as t_fid
from tools import torch_bench_stages, torch_multidevice_dryrun, torch_rss_attrib
from tools import torch_serve_bench, torch_soak, torch_validate_v5
from vadc_tpu.io.testtensor import load_testtensor, save_testtensor
from vadc_tpu.models.weights import V3_STRIDES, transformer_layer_params
from vadc_tpu.nn import functional as JF
from vadc_tpu_torch.models.weights import DEFAULT_WEIGHTS
from tests.torch_port_util import single_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
UTTERANCES = 2


def test_accuracy_scores_equal_the_jax_tools():
    want = j_acc.evaluate(n_utterances=UTTERANCES, seed=3)
    got = t_acc.evaluate(n_utterances=UTTERANCES, seed=3, device="cpu")
    assert got == want
    assert got["frame_f1"] > 0.9 and got["segments_truth"] == got["segments_matched"] > 0


def test_degradation_rows_equal_the_jax_tools():
    want = j_acc.degradation_matrix(n_utterances=UTTERANCES, seed=1)
    got = t_acc.degradation_matrix(n_utterances=UTTERANCES, seed=1, device="cpu")
    assert [r["degradation"] for r in got["rows"]] == [name for name, _ in
                                                      t_acc._degradations(16000, 1)]
    assert got == want


def test_scoring_functions_are_the_jax_tools(capsys):
    truth, detected = [(0.5, 2.0), (3.0, 4.5)], [(0.6, 2.1), (5.0, 5.5)]
    for name in ("score_frames", "score_segments"):
        args = (truth, detected, 6.0, 0.2) if name == "score_frames" else (truth, detected)
        assert getattr(t_acc, name)(*args) == getattr(j_acc, name)(*args)
    audio = np.random.default_rng(0).normal(size=16000).astype(np.float32)
    for color in ("white", "pink"):
        assert np.array_equal(t_acc.mix_noise(audio, truth[:1], 10.0, 16000, color=color),
                              j_acc.mix_noise(audio, truth[:1], 10.0, 16000, color=color))


def test_accuracy_all_tiers_cli_on_the_cpu(capsys):
    assert t_acc.main(["--device", "cpu", "--utterances", "1", "--all_tiers"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["tiers_agree"] is True and set(out["tiers"]) == {"faithful", "balanced", "fast",
                                                               "turbo"}


def _fixtures(root: Path) -> None:
    """The golden fixtures run_cases reads, from seeded inputs and the
    bundled v3.1 weights, each expected output computed by the JAX
    package's op, in the reference's [B, C, L] layout."""
    rng = np.random.default_rng(5)
    r = lambda *shape: rng.normal(size=shape).astype(np.float32)  # noqa: E731
    a = load_testtensor(DEFAULT_WEIGHTS)
    j = jnp.asarray
    l1 = {k.split(".", 1)[1]: v for k, v in a.items() if k.startswith("transformer_l1.")}

    d = {"input": r(2, 5, 16), "weight": r(16), "bias": r(16)}
    d["result"] = np.asarray(JF.layer_norm(j(d["input"]), j(d["weight"]), j(d["bias"])))
    save_testtensor(root / "layernorm_test.testtensor", d)
    d = {"input": r(2, 16, 7), "running_mean": r(16), "running_var": np.abs(r(16)) + 0.5,
         "weight": r(16), "bias": r(16)}
    d["result"] = np.asarray(JF.batch_norm1d(*(j(d[k]) for k in ("input", "running_mean",
                                                                 "running_var", "weight", "bias"))))
    save_testtensor(root / "batchnorm_test.testtensor", d)
    d = {"input": r(2, 64, 7), "weight": a["decoder_weights"], "bias": a["decoder_biases"]}
    d["output"] = np.asarray(JF.decoder_v3(j(d["input"]), j(d["weight"][:, :, 0]), j(d["bias"])))
    save_testtensor(root / "decoder_test.testtensor", d)
    d = {"input": r(129, 20), "weight": l1["dw_conv_weights"][:, 0], "bias": l1["dw_conv_biases"]}
    d["output"] = np.asarray(JF.depthwise_conv5(j(d["input"])[None], j(d["weight"]),
                                                j(d["bias"]))[0])
    save_testtensor(root / "dw_conv_129.testtensor", d)
    d = {"input": r(129, 20), "weight": l1["pw_conv_weights"], "bias": l1["pw_conv_biases"]}
    d["output"] = np.asarray(JF.pointwise_conv(j(d["input"])[None], j(d["weight"][:, :, 0]),
                                               j(d["bias"]))[0])
    save_testtensor(root / "pw_conv_129_16.testtensor", d)
    d = {"input": r(129, 20), "dw_conv.0.weight": l1["dw_conv_weights"][:, 0],
         "dw_conv.0.bias": l1["dw_conv_biases"], "pw_conv.0.weight": l1["pw_conv_weights"],
         "pw_conv.0.bias": l1["pw_conv_biases"], "proj.weight": l1["proj_weights"],
         "proj.bias": l1["proj_biases"]}
    d["output"] = np.asarray(JF.conv_block(
        j(d["input"])[None], j(d["dw_conv.0.weight"]), j(d["dw_conv.0.bias"]),
        j(d["pw_conv.0.weight"][:, :, 0]), j(d["pw_conv.0.bias"]), j(d["proj.weight"][:, :, 0]),
        j(d["proj.bias"]))[0])
    save_testtensor(root / "first_layer_conv_block.testtensor", d)
    d = {"input": r(10, 16), "weights": l1["attention_weights"], "biases": l1["attention_biases"],
         "proj_weights": l1["attention_proj_weights"], "proj_biases": l1["attention_proj_biases"]}
    d["result"] = np.asarray(JF.attention(j(d["input"])[None], j(d["weights"]), j(d["biases"]),
                                          j(d["proj_weights"]), j(d["proj_biases"]))[0])
    save_testtensor(root / "dual_head_attention_test.testtensor", d)
    d = {"input": np.abs(r(1, 129, 12)) * 0.01}
    d["output"] = np.asarray(JF.adaptive_audio_normalization(j(d["input"])))
    save_testtensor(root / "adaptive_audio_normalization_test.testtensor", d)
    d = {"input_x": r(7, 64), "hidden_state_previous": r(2, 64) * 0.1,
         "cell_state_previous": r(2, 64) * 0.1, "weights_transposed": a["weights"],
         "biases": a["biases"]}
    out, _, _ = JF.lstm(j(d["input_x"])[None], j(d["hidden_state_previous"])[:, None, :],
                        j(d["cell_state_previous"])[:, None, :], j(d["weights_transposed"]),
                        j(d["biases"]))
    d["output"] = np.concatenate([np.asarray(out[0]), r(2, 64)])  # rows past 7 are not read
    save_testtensor(root / "lstm_nito_reference_randn.testtensor", d)
    spect = np.abs(r(1, 129, 25)) * 0.01
    d = {"input": spect, **{k[len("transformer_l1."):]: v for k, v in a.items()
                            if k.startswith("transformer_l1.")}}
    d["result"] = np.asarray(JF.transformer_layer(j(spect), transformer_layer_params(d), stride=2))
    save_testtensor(root / "transformer_first_layer.testtensor", d)
    for layers, name in (((1, 2), "transformer_layers_1_2"), ((1, 2, 3), "transformer_layers_1_2_3"),
                         ((1, 2, 3, 4), "transformer_layers_1_2_3_4"),
                         ((1, 2, 3, 4), "adaptive_normalization_encoder")):
        d = {"input": spect, **{k: v for k, v in a.items()
                                if k.split(".")[0] in {f"transformer_l{i}" for i in layers}}}
        x = j(spect)
        if name.startswith("adaptive"):
            x = JF.adaptive_audio_normalization(x)
        for lid, stride in zip(layers, V3_STRIDES):
            x = JF.transformer_layer(x, transformer_layer_params(d, f"transformer_l{lid}."),
                                     stride=stride)
        d["result"] = np.asarray(x)
        save_testtensor(root / f"{name}.testtensor", d)


@pytest.fixture(scope="module")
def fixtures(tmp_path_factory):
    root = tmp_path_factory.mktemp("testdata")
    _fixtures(root)
    return root


def test_fidelity_report_passes_on_seeded_fixtures(fixtures, capsys, monkeypatch):
    want = j_fid.run_cases(fixtures)
    got = t_fid.run_cases(fixtures, "cpu")
    assert [n for n, _ in got] == [n for n, _ in want] and len(got) == 14
    assert all(err == 0.0 for _, err in want)  # the fixtures are the JAX ops' outputs
    for name, err in got:
        assert err <= 1e-5, (name, err)  # the port's per-op parity with the JAX package
    monkeypatch.setattr(t_fid, "TESTDATA", fixtures)
    assert t_fid.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "all within the reference per-op tolerance" in out and "full encoder" in out


def test_gpu_checks_golden_tier_on_seeded_fixtures(fixtures):
    from tools import gpu_check

    check = gpu_check.Checks()
    gpu_check.golden_checks("cpu", check, fixtures)
    assert check.failures == [] and len(check.results) == 2
    assert "golden_lstm_accumulation" in check.results


def test_fidelity_report_without_fixtures_exits_1(tmp_path, capsys, monkeypatch):
    monkeypatch.setattr(t_fid, "TESTDATA", tmp_path / "absent")
    assert t_fid.main(["--device", "cpu"]) == 1
    assert capsys.readouterr().err == "reference testdata not found\n"


def test_serving_bench_with_faults_on_the_cpu():
    """4 steady clients, churn, a checkpoint wave and every fault client:
    each client's segments accounted for (tests/test_server_faults.py's
    case, against the port's server)."""
    r = torch_serve_bench.run_serving_bench(n_clients=4, seconds=2.0, rtf=4.0,
                                            precision="faithful", faults=True, checkpoint=True,
                                            churn=True, device="cpu")
    assert r["churn_clients"] >= 1 and r["churn_errors"] == 0
    assert r["device"] == "cpu" and r["clients"] == 4
    assert r["delivery_exact"] == 4 and r["client_errors"] == 0
    assert r["delivered_min"] == r["delivered_max"] == r["expected_segments_per_client"] >= 1
    assert r["fault_slowreader_delivery_exact"] and r["post_fault_delivery_exact"]
    assert r["fault_malformed"] >= 1 and r["fault_malformed_diagnosed"] == r["fault_malformed"]
    assert r["fault_midwav_aborts"] >= 1 and r["fault_slowloris_errors"] == 0
    assert r["tick_count"] >= r["ticks_measured"] > 0 and r["tick_p50_ms"] > 0
    assert r["checkpoint_under_load"] == "ok" and r["ckpt_saves"] >= 1
    assert r["ckpt_save_max_ms"] >= r["ckpt_save_p50_ms"] > 0 and r["segments_dropped"] == 0
    assert r["rss_warm_at_tick"] is not None and r["rss_postwarm_ok"]
    assert r["rss_warmup_mb"] < 256


def test_soak_on_the_cpu(capsys):
    assert torch_soak.main(["--device", "cpu", "--minutes", "0.2", "--precision", "faithful"]) == 0
    err = capsys.readouterr().err
    assert "SOAK PASSED" in err and "cpu" in err
    r = torch_soak.soak(minutes=0.2, precision="fast", device="cpu")
    assert r["windows"] == 7 and r["segments"] >= 1 and r["rss_growth_mb"] <= 64.0


@pytest.mark.parametrize("tool, argv", [
    (t_acc, ["--utterances", "1"]),
    (t_fid, []),
    (torch_soak, ["--minutes", "0.1"]),
    (torch_serve_bench, ["--clients", "1", "--seconds", "1"]),
    (torch_bench_stages, ["--batch", "2", "--t_short", "1", "--t_long", "2"]),
    (torch_rss_attrib, ["--clients", "1", "--seconds", "1"]),
    (torch_validate_v5, [str(ROOT / "README.md")]),
])
def test_the_tools_run_on_the_card_by_default(tool, argv, capsys, monkeypatch):
    """Without `--device`, a tool asks for the card; without one it exits 1
    with one line, and never carries on on the CPU."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(t_fid, "TESTDATA", ROOT)  # a directory: the device decides
    assert tool.main(argv) == 1
    captured = capsys.readouterr()
    assert captured.out == "" and captured.err.startswith("Error: no CUDA device")


def test_multidevice_dryrun_defaults_to_the_card(capsys, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert torch_multidevice_dryrun.main([]) == 1
    assert capsys.readouterr().err == "Error: no CUDA device is visible to PyTorch\n"


def test_tools_run_as_scripts():
    for script in ("gpu_check.py", "torch_accuracy_eval.py", "torch_serve_bench.py",
                   "torch_soak.py", "torch_fidelity_report.py", "torch_bench_stages.py",
                   "torch_ingest_bench.py", "torch_rss_attrib.py", "torch_tensor_image.py",
                   "torch_validate_v5.py"):
        proc = subprocess.run([sys.executable, str(ROOT / "tools" / script), "--help"],
                              capture_output=True, text=True, timeout=120, cwd=ROOT)
        if script == "gpu_check.py":  # no flags: without a card it exits 2
            assert proc.returncode == 2 and "no CUDA device" in proc.stderr
        else:
            assert proc.returncode == 0 and "usage" in proc.stdout
