"""The counts of operations and bytes against counts worked by hand at one
shape, and the readers' arithmetic on a made-up trace."""

import json
import sys

import numpy as np
import pytest

from vadbench import families, harness
from vadbench.families import v3, v4
from vadbench.metrics import counts, shared


def test_spectrum_and_lstm_counts_by_hand():
    # 10 frames x (real + imaginary basis: 2 x 256 x 129 multiply-adds = 2 flops
    # each) + 4 flops a bin for the magnitude
    assert counts.spectrum_flops(10) == 10 * (2 * 2 * 256 * 129 + 4 * 129)
    # 3 steps x 2 layers x [128] x [128, 256] products at 2 flops
    assert counts.lstm_flops(3) == 2 * 3 * 2 * 128 * 256
    assert counts.frames(1536, 128) == 25 and counts.frames(1536, 96) == 24


def test_v31_encoder_count_by_hand():
    # stage 1: 25 frames, 129 -> 16, projection, attention, stride 2 -> 13
    s1 = 25 * 129 * 5 + 25 * 129 * 16 * 2 + 25 * 16 * 48 + 2 * 25 * 25 * 16 + 3 * 25 * 16 * 16 \
        + 13 * 16 * 16
    s2 = 13 * 16 * 5 + 13 * 16 * 32 * 2 + 13 * 32 * 96 + 2 * 13 * 13 * 32 + 3 * 13 * 32 * 32 \
        + 7 * 32 * 32
    s3 = 7 * 32 * 5 + 7 * 32 * 32 + 7 * 32 * 96 + 2 * 7 * 7 * 32 + 3 * 7 * 32 * 32 + 7 * 32 * 32
    s4 = 7 * 32 * 5 + 7 * 32 * 64 * 2 + 7 * 64 * 192 + 2 * 7 * 7 * 64 + 3 * 7 * 64 * 64 \
        + 7 * 64 * 64
    assert counts.encoder_flops(25, v3.STAGES, True) == 2 * (s1 + s2 + s3 + s4)


def test_v4_encoder_count_by_hand():
    # 24 frames: 258 -> 16 (proj), stride 2 -> 12; 16 -> 32 (proj) -> 6;
    # 32 -> 32 -> 3; 32 -> 64 (proj), stride 1 -> 3
    macs = (24 * 258 * 5 + 24 * 258 * 16 * 2 + 12 * 16 * 16
            + 12 * 16 * 5 + 12 * 16 * 32 * 2 + 6 * 32 * 32
            + 6 * 32 * 5 + 6 * 32 * 32 + 3 * 32 * 32
            + 3 * 32 * 5 + 3 * 32 * 64 * 2 + 3 * 64 * 64)
    assert counts.encoder_flops(24, v4.STAGES, False) == 2 * macs
    assert counts.encoder_frames(24, v4.STAGES) == 3


def test_kernel_counts_at_one_shape_by_hand():
    flops, nbytes = counts.stft_magnitude(4096, 1536, 96, 96, 64, 256, 129)
    assert flops == 4096 * 24 * (4 * 256 * 129 + 4 * 129)
    assert nbytes == 4096 * 1536 * 4 + 2 * 256 * 129 * 4 + 4096 * 24 * 129 * 4
    flops, nbytes = counts.lstm_fused(512, 192)
    assert flops == 512 * 2 * 192 * 2 * 128 * 256
    assert nbytes == 2 * 512 * 192 * 64 * 4 + 4 * 2 * 512 * 64 * 4 + (2 * 256 * 128 + 2 * 256) * 4
    flops, nbytes = counts.lstm_decoder_fused(512, 64, 7)
    assert flops == counts.lstm_flops(512 * 64 * 7)
    flops, nbytes = counts.encode_fused_audio(16384, 1536)
    assert flops == counts.spectrum_flops(16384 * 25) + 16384 * counts.encoder_flops(
        25, v3.STAGES, True)
    assert nbytes == 16384 * 1536 * 4 + 16384 * 7 * 64 * 4 + 124_632 * 4 + 2 * 256 * 129 * 4
    # the bound: the larger of the two times
    assert counts.bound_s(67e12, 1.0) == pytest.approx(1.0)
    assert counts.bound_s(1.0, 3.35e12) == pytest.approx(1.0)


@pytest.mark.parametrize("config, flops", [("silero_v31_16k", 5_417_854),
                                           ("silero_v4_16k", 4_149_888)])
def test_model_count_by_family(config, flops):
    # the counts before they moved into vadbench/families
    cfg = json.loads((harness.HERE / "configs" / f"{config}.json").read_text())
    assert counts.model_flops_per_chunk(cfg) == flops


def test_a_family_is_a_file_of_its_own(tmp_path, monkeypatch):
    # a family found by its name alone: a module put beside the others
    (tmp_path / "stub9.py").write_text(
        "def flops_per_chunk(config):\n    return 7.0 * config['chunk_samples']\n")
    monkeypatch.setattr(families, "__path__", [*families.__path__, str(tmp_path)])
    monkeypatch.delitem(sys.modules, "vadbench.families.stub9", raising=False)
    assert counts.model_flops_per_chunk({"family": "stub9", "chunk_samples": 512}) == 3584.0
    monkeypatch.delitem(sys.modules, "vadbench.families.stub9")
    # a family with no module: the error names the file to add
    with pytest.raises(ModuleNotFoundError, match=r"vadbench/families/v77\.py"):
        counts.model_flops_per_chunk({"family": "v77", "chunk_samples": 512})


def test_lstm_fused_count_by_hand_at_both_widths():
    # two layers of width 64 (v3.1, v4): unchanged by the width's argument
    steps = 512 * 192
    flops, nbytes = counts.lstm_fused(512, 192, 64, 2)
    assert counts.lstm_fused(512, 192, 64, 2, 64) == (flops, nbytes)
    assert flops == 2 * steps * 2 * 128 * 256
    assert nbytes == 2 * steps * 64 * 4 + 4 * 2 * 512 * 64 * 4 \
        + (2 * 256 * 128 + 2 * 256) * 4
    # one layer of width 128 (v5): [256] x [256, 512] a step
    steps = 512 * 256
    flops, nbytes = counts.KERNELS["lstm_fused"]((512, 256, 128, 1, 128))
    assert flops == 2 * steps * 256 * 512 and flops == pytest.approx(3.44e10, rel=2e-3)
    assert nbytes == 2 * steps * 128 * 4 + 4 * 512 * 128 * 4 + (512 * 256 + 512) * 4


def test_call_sites_record_the_lstm_width_from_its_weights():
    import torch

    sites = harness.call_sites()
    kernel, shape_of = sites[("vadc_tpu_torch.models.slab", "lstm_fused")]
    x, w = torch.zeros(4, 24, 128), torch.zeros(1, 512, 256)
    assert kernel == "lstm_fused" and shape_of((x, None, None, w), {}) == (4, 24, 128, 1, 128)
    x, w = torch.zeros(4, 24, 64), torch.zeros(2, 256, 128)
    assert shape_of((x, None, None, w), {}) == (4, 24, 64, 2, 64)
    stft = {sites[(f"vadc_tpu_torch.models.silero_v{v}", "stft_magnitude")] for v in (4, 5)}
    assert len(stft) == 1 and next(iter(stft))[0] == "stft_magnitude"


class _Trace(harness.DeviceTrace):
    def __init__(self, events, t0, t1):  # no card: the arithmetic alone
        self.events, self.t_begin, self.t_end, self.prof = events, t0, t1, None


def test_idle_share_busy_union_and_gaps():
    tr = _Trace([("a", 0.1, 0.2), ("b", 0.2, 0.1), ("c", 0.6, 0.1)], 0.0, 1.0)
    assert tr.busy_s() == pytest.approx(0.3)  # [0.1, 0.3] and [0.6, 0.7]
    assert tr.idle_gaps() == [(0.0, 0.1), (pytest.approx(0.3), 0.6), (pytest.approx(0.7), 1.0)]
    assert shared.idle_share({"trace": tr}) == pytest.approx(70.0)
    b = tr.breakdown([("tick", 0.25, 0.65)], "idle")
    assert b["device_ops"][0] == ["a", 0.2]
    labels = {name.split(" (")[0]: t for name, t in b["idle_gaps"]}
    assert labels["tick"] == pytest.approx(0.3) and labels["idle"] == pytest.approx(0.4)


def test_busy_a_card_is_each_cards_union_averaged_over_the_cards():
    tr = _Trace([], 0.0, 1.0)
    tr.chip_busy = {0: 0.3, 2: 0.1}  # card 1 and 3 ran nothing
    assert tr.chip_busy_s(4) == pytest.approx(0.1)
    assert tr.chip_busy_s(1) == pytest.approx(0.4)
    assert harness._union_s([(0.1, 0.2), (0.2, 0.1), (0.6, 0.1)]) == pytest.approx(0.3)


def test_roofline_reader_on_a_made_up_trace():
    shape = (32768, 1536)
    least = counts.bound_s(*counts.encode_fused_audio(*shape))
    name = "void (anonymous namespace)::silero_v31_encode_audio_kernel<0>(float const*)"
    tr = _Trace([(name, 0.0, 2 * least), (name, 1.0, 2 * least), ("other", 2.0, 1.0)], 0.0, 3.0)
    run = {"trace": tr, "calls": {"encode_fused_audio": [shape, shape]}}
    assert shared.roofline(run, "encode_fused_audio") == pytest.approx(50.0)
    # a lost kernel event leaves the metric out rather than over 100 %
    tr.events = tr.events[1:]
    assert shared.roofline(run, "encode_fused_audio") is None
    assert shared.roofline({"trace": None, "calls": {}}, "encode_fused_audio") is None


def test_mfu_reader():
    cfg = harness.cell("v31.corpus.512").config
    per_chunk = counts.model_flops_per_chunk(cfg)
    corpus_mfu = harness.metric_reader("corpus_mfu")
    assert corpus_mfu({"chunks": 1000, "window_s": 2.0, "config": cfg}) == pytest.approx(
        100 * 1000 * per_chunk / 2.0 / 67e12)
    assert corpus_mfu({"chunks": 0}) is None
    assert np.isfinite(per_chunk) and per_chunk > counts.spectrum_flops(25)


def test_a_reader_brings_its_own_call_site_and_counts(tmp_path, monkeypatch):
    (tmp_path / "metrics").mkdir()
    (tmp_path / "metrics" / "roofline.k.py").write_text(
        "CALL_SITES = {('vadc_tpu_torch.models.silero_v31', 'forward_fused'):\n"
        "              ('k', lambda a, k: tuple(a[1].shape))}\n"
        "def read(run):\n    return None\n")
    monkeypatch.setattr(harness, "HERE", tmp_path)
    sites = harness.call_sites()
    assert sites[("vadc_tpu_torch.models.silero_v31", "forward_fused")][0] == "k"
    assert set(harness.CALL_SITES) < set(sites)
    tr = _Trace([("my_kernel_x", 0.0, 4.0)], 0.0, 5.0)
    run = {"trace": tr, "calls": {"k": [(3,)]}}
    assert shared.roofline(run, "k", r"\bmy_kernel_x\b", lambda shape: (67e12 * shape[0], 0.0)) \
        == pytest.approx(75.0)
