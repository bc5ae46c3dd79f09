"""The comparison that decides `correct` fails a broken timed path: the
harness runs with its look for a chip skipped (a CPU dry run), the port
broken underneath, and `correct` has to come out false. One test per
fault that a cell can have: a step that returns its state unchanged; half
of the streams left out of the batch; an answer altered where it is
produced. (One chip: no exchange between chips to leave out.)"""

import time

import pytest
import torch
from conftest import TINY

from vadbench import run

CELLS = ["v31.corpus.512"]


def _run(cell):
    # files of two slabs or more: a state left unchanged shows from the second on
    return run.run_cell(cell, 4242, 6.0, False, device="cpu",
                        overrides={**TINY["corpus"], "files": 4, "file_s": [10.0, 14.0]},
                        t_process=time.monotonic())


def _state_unchanged(monkeypatch):
    from vadc_tpu_torch.engine.runner import StreamRunner

    scan = StreamRunner.scan

    def broken_scan(self, chunks, state):
        h, c = state.h.clone(), state.c.clone()
        probs, state = scan(self, chunks, state)
        state.h.copy_(h)
        state.c.copy_(c)
        return probs, state

    monkeypatch.setattr(StreamRunner, "scan", broken_scan)


def _half_batch(monkeypatch):
    from vadc_tpu_torch.engine.runner import StreamRunner

    scan = StreamRunner.scan

    def broken_scan(self, chunks, state):
        probs, state = scan(self, chunks, state)
        probs = probs.clone()
        probs[probs.shape[0] // 2 :] = 0.0
        return probs, state

    monkeypatch.setattr(StreamRunner, "scan", broken_scan)


def _answer_altered(monkeypatch):
    from vadc_tpu_torch.engine.vectorized_segmenter import BatchSegmenter

    finish = BatchSegmenter.finish

    def broken_finish(self, valid_chunks=None):
        out = finish(self, valid_chunks)
        for segs in out:
            if segs:
                segs[0] = (segs[0][0], segs[0][1] + 0.096)
                break
        return out

    monkeypatch.setattr(BatchSegmenter, "finish", broken_finish)


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch, _answer_altered])
def test_a_broken_timed_path_is_not_correct(cell, fault, monkeypatch):
    torch.manual_seed(0)
    fault(monkeypatch)
    line = _run(cell)
    assert line["correct"] is False, line["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_unbroken_path_is_correct(cell):
    assert _run(cell)["correct"] is True
