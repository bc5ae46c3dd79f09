"""The cell's control: the plain reference put in the program's place,
judged by the cell's own comparison. In TF32 (the control) it has to fail;
TF32 exists only on the card, so that test is marked `cuda`, and at the
cells' own size the control is read with `python3 -m vadbench.control`
(PERF.md gives the readings). On the CPU a dry run shows that what the
cell judges is the reference that stands in."""

import pytest
from conftest import TINY

from vadbench import control

CELLS = ["v31.corpus.512"]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: TF32 runs only there")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_tf32_control_is_not_correct(card, cell):
    small = {"files": 48, "file_s": [20.0, 40.0], "sample_streams": 16}
    r = control.readings(cell, 20261018, 2.0, device="cuda", overrides=small)
    assert r["correct"] is False, r
    assert r["checks"]["prob_gap_max"]["value"] > r["checks"]["prob_gap_max"]["limit"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_judged_by_the_cells_own_comparison(cell, monkeypatch):
    # no TF32 on the CPU: a reference 0.01 off where it runs as the control
    # stands in for it, and what the cell judges has to be that reference
    from vadbench.reference import silero

    stream_probs = silero.stream_probs

    def off(params, audio, chunk, *, tf32=False):
        probs = stream_probs(params, audio, chunk, tf32=tf32)
        return probs + 0.01 if tf32 else probs

    monkeypatch.setattr(silero, "stream_probs", off)
    # files of two slabs or more, so that the substitution spans slabs
    tiny = {**TINY["corpus"], "files": 3, "file_s": [7.0, 9.0]}
    r = control.readings(cell, 2**31 + 99, 2.0, device="cpu", overrides=tiny)
    assert r["correct"] is False, r
    assert r["checks"]["prob_gap_max"]["value"] == pytest.approx(0.01, abs=1e-3)
