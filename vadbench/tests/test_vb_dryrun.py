"""A dry run of each cell's harness at a tiny size on the CPU, the port on
its plain versions; and the manifest against the benchmark's contract."""

import json
import re
import time

import pytest
from conftest import ROOT, TINY

from vadbench import harness, run

MANIFEST = harness.manifest()
CELLS = [w["name"] for w in MANIFEST["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def _tiny(cell):
    return TINY[harness.cell(cell).traffic["kind"]]


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_dry_run_reports_the_cells_metrics(cell, trace):
    line = run.run_cell(cell, 2**31 + 17, 6.0, bool(trace), device="cpu", overrides=_tiny(cell),
                        t_process=time.monotonic())
    json.dumps(line)
    assert line["correct"] is True and line["failed"] <= line["attempted"]
    assert list(line)[-1] == "checks"
    assert set(line["checks"]) == {"lines_wrong", "prob_gap_max"}
    want = {m["name"]: m["unit"] for m in run.select_metrics(MANIFEST, cell, bool(trace))}
    got = {k: v["unit"] for k, v in line["metrics"].items()}
    assert got.items() <= want.items()
    if trace:
        # the device readers find nothing on the CPU and stay silent
        assert not [k for k in got if "roofline" in k or "idle" in k]
        assert got
    else:
        assert got == want and "setup_s" in got
    assert set(line["setup_parts"]) >= {"process_start_s", "corpus_write_s", "warmup_job_s"}


def test_manifest_keeps_the_contract():
    m = MANIFEST
    assert set(m) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert m["paths"] == ["vadbench"] and 1 <= m["run_seconds"] <= 51
    names = [c["name"] for c in m["configs"]] + CELLS + [e["name"] for e in m["end_to_end"]] \
        + [e["name"] for e in m["per_layer"]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in m["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("vadbench/") and (ROOT / c["file"]).exists()
        assert any(w["config"] == c["name"] for w in m["workloads"])
    e2e = {e["name"]: e for e in m["end_to_end"]}
    # event_delay_p95_ms comes with the first steady live cell (PERF.md)
    assert set(e2e) == {"corpus_audio_s_per_s", "setup_s"}
    for e in m["end_to_end"]:
        assert 0.01 <= e["bound"] <= 0.25 and e["source"] in ("host_clock", "device_trace")
    # a cell takes 1 card, or 4 where what it measures exists only across
    # cards; at most a quarter of the cells (one always) take 4
    assert sum(w["chips"] == 4 for w in m["workloads"]) <= max(1, len(CELLS) // 4)
    for w in m["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4)
        assert len(w["why"]) <= 200
        assert (ROOT / "vadbench/traffic" / f"{w['traffic']}.json").exists()
        assert (ROOT / "vadbench/limits" / f"{w['name']}.json").exists()
        own = run.select_metrics(m, w["name"], False)
        assert "setup_s" in [e["name"] for e in own] and len(own) >= 2
        assert run.select_metrics(m, w["name"], True)
    layers = {}
    for p in m["per_layer"]:
        assert p["moves"] in e2e and (ROOT / "vadbench/metrics" / f"{p['name']}.py").exists()
        for w in p["workloads"]:
            assert w in CELLS and w in e2e[p["moves"]].get("workloads", CELLS)
        assert re.match(r"^[A-Za-z0-9_/%.-]{1,16}$", p["unit"])
        layers.setdefault(p["layer"], p["layer"])
    assert len(json.dumps(m)) < 64 * 1024
    # every file under paths is named from a name's characters
    for path in (ROOT / "vadbench").rglob("*"):
        if "__pycache__" not in path.parts:
            assert re.match(r"^[A-Za-z0-9_./-]+$", str(path.relative_to(ROOT)))


def test_run_refuses_without_a_card_and_prints_no_result(capsys):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    rc = run.main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1", "--trace", "0"])
    assert rc == 3 and capsys.readouterr().out == ""
