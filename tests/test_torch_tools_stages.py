"""The last five ported tools on the CPU, each held to its JAX counterpart
where one can run here: tools/torch_tensor_image.py (tools/tensor_image.py's
factoring, images and PGM bytes), tools/torch_ingest_bench.py
(tools/ingest_bench.py's keys), tools/torch_validate_v5.py (on the synthetic
v5 graph of export/onnx_build.py: tools/validate_v5.py's lines, a non-v5
graph refused, a missing file), tools/torch_bench_stages.py (each family's
prefix rows; the full prefix equal to `forward` bit for bit; v4's prefixes
against the same chain of the JAX package's functions at faithful, within
the whole-model bounds: 1e-4, the state 3e-4) and tools/torch_rss_attrib.py
(a short run on the port's server). The device rule and the scripts'
`--help` are in tests/test_torch_tools.py."""

import json
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tests.conftest import assert_close
from tests.torch_port_util import V31_ARCHIVE, build_v3_onnx, single_torch_thread  # noqa: F401
from tools import ingest_bench as j_ingest
from tools import tensor_image as j_img
from tools import torch_bench_stages as stages
from tools import torch_ingest_bench as t_ingest
from tools import torch_rss_attrib
from tools import torch_tensor_image as t_img
from tools import torch_validate_v5 as t_v5
from tools import validate_v5 as j_v5
from vadc_tpu.models import silero_v4 as J4
from vadc_tpu.models import weights as JW
from vadc_tpu.io.testtensor import load_testtensor
from vadc_tpu.nn import functional as JF
from vadc_tpu_torch import native
from vadc_tpu_torch.export.onnx_build import build_silero_v5_onnx
from vadc_tpu_torch.models.synthetic import random_v5_8k_archive, random_v5_archive

TOL_PROBS = 1e-4  # ROADMAP.md "What the port is held against": whole model
TOL_STATE = 3e-4


@pytest.mark.parametrize("n", [1, 2, 7, 12, 97, 129, 360, 1024, 33024])
def test_near_square_factors_are_the_jax_tools(n):
    assert t_img.near_square_factors(n) == j_img.near_square_factors(n)


@pytest.mark.parametrize("shape, kind", [
    ((12,), "normal"), ((3, 4), "normal"), ((2, 3, 5), "normal"), ((129, 1, 5), "normal"),
    ((7,), "constant"), ((0,), "normal"), ((4, 4), "ramp"), ((64, 2), "integers"),
])
def test_to_image_is_the_jax_tools(shape, kind):
    rng = np.random.default_rng(sum(shape) + len(kind))
    arr = {"normal": lambda: rng.normal(size=shape).astype(np.float32),
           "constant": lambda: np.full(shape, 0.25, np.float32),
           "ramp": lambda: np.arange(np.prod(shape), dtype=np.float64).reshape(shape),
           "integers": lambda: rng.integers(-5, 5, size=shape)}[kind]()
    got, want = t_img.to_image(arr), j_img.to_image(arr)
    assert got.dtype == want.dtype == np.uint8 and got.shape == want.shape
    assert np.array_equal(got, want)


def test_tensor_image_cli_writes_the_jax_tools_bytes(tmp_path, capsys):
    """Every tensor of the bundled v3.1 archive: the same PGM files, byte
    for byte, and the same lines, as tools/tensor_image.py's."""
    want_dir, got_dir = tmp_path / "jax", tmp_path / "port"
    assert j_img.main([str(V31_ARCHIVE), "", str(want_dir)]) == 0
    want_out = capsys.readouterr().out
    assert t_img.main([str(V31_ARCHIVE), "", str(got_dir)]) == 0
    got_out = capsys.readouterr().out
    names = sorted(p.name for p in want_dir.iterdir())
    assert len(names) == len(load_testtensor(V31_ARCHIVE)) > 50
    assert sorted(p.name for p in got_dir.iterdir()) == names
    for name in names:
        assert (got_dir / name).read_bytes() == (want_dir / name).read_bytes(), name
    assert got_out.replace(str(got_dir), "D") == want_out.replace(str(want_dir), "D")
    assert t_img.main([str(V31_ARCHIVE), "decoder_biases", str(got_dir / "one")]) == 0
    assert [p.name for p in (got_dir / "one").iterdir()] == ["decoder_biases.pgm"]


@pytest.mark.parametrize("streams, seconds, writers, with_fsm", [(8, 0.5, 2, False),
                                                                 (4, 0.3, 1, True)])
def test_ingest_returns_the_jax_tools_keys(streams, seconds, writers, with_fsm):
    if not native.available():
        pytest.skip("native library not built (make -C native)")
    kw = dict(chunk_samples=256, writer_threads=writers, with_fsm=with_fsm)
    got = t_ingest.run_ingest(streams, seconds, **kw)
    want = j_ingest.run_ingest(streams, seconds, **kw)
    assert list(got) == list(want)
    assert got["streams"] == streams and got["fsm"] is with_fsm
    assert got["chunks_drained"] > 0 and got["samples_per_s"] > 0 and got["gathers"] > 0
    assert got["realtime_streams_equiv"] == round(got["samples_per_s"] / 16000)


def test_ingest_cli_prints_the_two_rows(capsys):
    if not native.available():
        pytest.skip("native library not built (make -C native)")
    assert t_ingest.main(["--streams", "4", "--seconds", "0.2", "--chunk", "256",
                          "--writer_threads", "1", "--json"]) == 0
    captured = capsys.readouterr()
    rows = [line.split()[0] for line in captured.err.splitlines()]
    assert rows == ["gather-only", "gather+fsm"]
    assert [r["fsm"] for r in json.loads(captured.out)["rows"]] == [False, True]


@pytest.fixture(scope="module")
def v5_graph(tmp_path_factory):
    """The synthetic official-topology v5 graph of tests/test_tools.py's
    test_validate_v5_harness (the same seeds), built by the port's
    onnx_build."""
    path = tmp_path_factory.mktemp("v5") / "silero_v5_synthetic.onnx"
    build_silero_v5_onnx(path, random_v5_archive(7), random_v5_8k_archive(8))
    return path


def _masked(text: str) -> list:
    return [re.sub(r"[-+]?\d+(\.\d+)?(e[-+]?\d+)?", "#", line) for line in text.splitlines()]


def test_validate_v5_passes_on_the_synthetic_graph(v5_graph, capsys):
    assert t_v5.main([str(v5_graph), "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.splitlines()[0] == "classified: v5" and out.endswith("V5 VALIDATION PASSED\n")
    assert "-- 16000 Hz branch (family v5," in out and "-- 8000 Hz branch (family v5_8k," in out
    chunks = [line for line in out.splitlines() if line.startswith("  chunk ")]
    assert len(chunks) == 8 and all(line.endswith("ok") for line in chunks)


def test_validate_v5_prints_the_jax_tools_lines(v5_graph, capsys):
    """The same lines as tools/validate_v5.py's validate on the same graph,
    numbers aside, and both within the default atol."""
    assert j_v5.validate(v5_graph, 1e-5, chunks=2)
    want = capsys.readouterr().out
    assert t_v5.validate(v5_graph, 1e-5, chunks=2, device="cpu")
    got = capsys.readouterr().out
    assert _masked(got) == _masked(want) and len(got.splitlines()) == 7


def test_validate_v5_refuses_a_v3_graph(tmp_path, capsys):
    path, _ = build_v3_onnx(tmp_path / "silero_v3_rebuilt.onnx")
    assert t_v5.main([str(path), "--device", "cpu"]) == 2
    captured = capsys.readouterr()
    assert captured.out == "classified: v3\nV5 VALIDATION FAILED\n"
    assert captured.err == "FAIL: expected a v5 graph, got v3\n"


def test_validate_v5_without_the_file_exits_1(tmp_path, capsys):
    assert t_v5.main([str(tmp_path / "absent.onnx"), "--device", "cpu"]) == 1
    assert capsys.readouterr().err == f"Error: {tmp_path / 'absent.onnx'} not found\n"


ROWS = {
    "v3": ["encode_fused_audio", "forward_fused (full)"],
    "v4": ["stft_magnitude", "+adaptive_norm+concat", "+conv_stage1", "+conv_stage2",
           "+conv_stage3", "+conv_stage4", "+lstm_fused", "+decoder (full)"],
    "v5": ["attach_context+stft_magnitude", "+conv1", "+conv2", "+conv3", "+conv4",
           "+lstm_fused", "+decoder (full)"],
}
ROWS["v4_8k"], ROWS["v5_8k"] = ROWS["v4"], ROWS["v5"]


@pytest.mark.parametrize("family", stages.FAMILIES)
def test_bench_stages_rows_on_the_cpu(family):
    r = stages.run_stages(family, batch=4, precision="fast", t_short=1, t_long=3, device="cpu")
    assert r["full_equals_forward"] is True and r["device"] == "cpu"
    assert [row["name"] for row in r["rows"]] == ROWS[family]
    for row in r["rows"]:
        assert np.isfinite(row["cumulative_us"]) and row["stage_us"] >= 0.0
        assert row["device_us"] is None and row["launches"] == {}  # no kernel off the card


@pytest.mark.parametrize("family", stages.FAMILIES)
@pytest.mark.parametrize("precision", ["faithful", "turbo"])
def test_full_prefix_is_forward_bit_for_bit(family, precision):
    """The last prefix over 3 chunks from a zero state: the probabilities of
    every chunk and the state those of the model's own step."""
    module, params = stages.load_model(family, "cpu")
    gen = torch.Generator().manual_seed(5)
    chunks = torch.randn((4, 3, stages.CHUNK[family]), generator=gen) * 0.1
    state = stages.init_state(family, module, 4, "cpu")
    full = stages.prefixes(family, module, params, precision)[-1][1]
    got = stages.run_loop(full, chunks, state)
    want = stages.run_loop(stages.forward_step(family, module, params, precision), chunks, state)
    assert stages.same_bits(got[0], want[0]) and stages.same_bits(got[1], want[1])
    assert len(want[1]) == (3 if family.startswith("v5") else 2)


def test_a_full_prefix_off_forward_exits_1(monkeypatch, capsys):
    """The guard: a last prefix one ulp off forward's probabilities is
    refused, and the CLI exits 1 with one line."""
    real = stages.prefixes

    def nudged(*args):
        steps = real(*args)
        name, full = steps[-1]

        def off(audio, state):
            probs, state = full(audio, state)
            return torch.nextafter(probs, torch.full_like(probs, 2.0)), state

        return steps[:-1] + [(name, off)]

    monkeypatch.setattr(stages, "prefixes", nudged)
    with pytest.raises(stages.PrefixMismatch):
        stages.run_stages("v5", batch=2, t_short=1, t_long=2, device="cpu")
    assert stages.main(["--family", "v4", "--batch", "2", "--t_short", "1", "--t_long", "2",
                        "--device", "cpu"]) == 1
    captured = capsys.readouterr()
    assert captured.err == "Error: v4: the full prefix differs from forward's output\n"


def test_bench_stages_cli_prints_the_rows(capsys):
    assert stages.main(["--family", "v5_8k", "--batch", "2", "--t_short", "1", "--t_long", "2",
                        "--precision", "balanced", "--device", "cpu", "--json"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("v5_8k: batch 2, precision balanced, cpu, T 1/2")
    for line, name in zip(out[1:-1], ROWS["v5_8k"]):
        assert re.fullmatch(rf"{re.escape(name)} +cumulative +-?\d+\.\d us   stage +\d+\.\d us"
                            r"   device not measured   launches a chunk: none", line), line
    assert json.loads(out[-1])["families"][0]["family"] == "v5_8k"


def test_split_is_refused_off_the_card(capsys):
    with pytest.raises(ValueError, match="--split"):
        stages.run_stages("v3", batch=2, t_short=1, t_long=2, device="cpu", split=True)
    assert stages.main(["--split", "--device", "cpu", "--batch", "2"]) == 2


def test_split_stages_group_the_phases():
    """phase_rows' rows summed into tools/bench_stages.py's stages: every
    phase in exactly one, the encoder layers by stage."""
    from vadc_tpu_torch.kernels import _build

    layer_phases = _build.PHASES[4:17]  # proj .. conv1x1, once per encoder stage
    rows = [(0, "spectrum", 100.0), (0, "log1p", 10.0), (0, "mean, subtract, state", 5.0)]
    for stage in range(1, 5):
        rows += [(stage, name, float(stage)) for name in layer_phases]
    rows += [(0, "lstm input half", 7.0), (0, "lstm", 40.0), (0, "decoder, stores", 3.0)]
    got = dict(stages.split_stages({"rows": rows}))
    assert list(got) == ["stft", "adaptive_norm", "layer1", "layer2", "layer3", "layer4", "lstm",
                         "decoder"]
    assert got["stft"] == 100.0 and got["adaptive_norm"] == 15.0
    assert [got[f"layer{s}"] for s in range(1, 5)] == [13.0 * s for s in range(1, 5)]
    assert got["lstm"] == 47.0 and got["decoder"] == 3.0
    assert sum(got.values()) == sum(us for _, _, us in rows)


@pytest.fixture(scope="module")
def v4_models():
    tensors = {f: load_testtensor(V31_ARCHIVE.parent / name) for f, name in
               (("v4", "silero_v4_16k.testtensor"), ("v4_8k", "silero_v4_8k.testtensor"))}
    return {f: (JW.load_params_from_tensors(t)[1], stages.load_model(f, "cpu"))
            for f, t in tensors.items()}


def _jax_v4_prefix(params, audio, h, c, depth: int, sample_rate: int):
    """tools/bench_stages.py's chain on the JAX package's v4 functions:
    vadc_tpu/nn/functional.py's spectrum and normalization,
    vadc_tpu/models/silero_v4.py: conv_stage, lstm, the decoder."""
    x = JF.stft_magnitude_nlc(audio, params["stft_basis"], pad_left=J4.STFT_PAD,
                              pad_right=J4.STFT_PAD, hop=J4.STFT_HOP)
    if depth >= 1:
        x = jnp.concatenate([x.astype(JF.compute_dtype()), JF.adaptive_audio_normalization_nlc(x)],
                            axis=-1)
    strides = JW.V4_STRIDES_16K if sample_rate == 16000 else JW.V4_STRIDES_8K
    for p, stride in list(zip(params["stages"], strides))[: max(depth - 1, 0)]:
        x = J4.conv_stage(x, p, stride=stride)
    if depth >= 6:
        x, h, c = JF.lstm(x, h, c, params["lstm_w"], params["lstm_b"])
    if depth == 7:
        return JF.decoder_v5_nlc(x, params["dec_w"], params["dec_b"]), h, c
    return jnp.mean(x, axis=tuple(range(1, x.ndim))), h, c


@pytest.mark.parametrize("family", ["v4", "v4_8k"])
def test_v4_prefixes_match_the_jax_chain(v4_models, family):
    """Each depth of the port's v4 prefix at faithful, over 2 chunks from a
    zero state (the LSTM's state carried), against the JAX chain."""
    jp, (module, tp) = v4_models[family]
    gen = torch.Generator().manual_seed(11)
    chunks = torch.randn((4, 2, stages.CHUNK[family]), generator=gen) * 0.1
    steps = stages.prefixes(family, module, tp, "faithful")
    assert len(steps) == 8
    for depth, (name, step) in enumerate(steps):
        state = stages.init_state(family, module, 4, "cpu")
        hj, cj = J4.init_state(4)
        for t in range(chunks.shape[1]):
            value, state = step(chunks[:, t], state)
            want, hj, cj = _jax_v4_prefix(jp, jnp.asarray(chunks[:, t].numpy()), hj, cj, depth,
                                          module.SAMPLE_RATE)
            assert_close(value.numpy(), np.asarray(want), TOL_PROBS, f"{family} {name} chunk {t}")
            assert_close(state[0].numpy(), np.asarray(hj), TOL_STATE, f"{family} {name} h")
            assert_close(state[1].numpy(), np.asarray(cj), TOL_STATE, f"{family} {name} c")


def test_rss_attrib_on_the_cpu(capsys):
    if not native.available():
        pytest.skip("native library not built (make -C native)")
    r = torch_rss_attrib.run_rss_attrib(clients=4, seconds=3.0, rtf=4.0, precision="faithful",
                                        device="cpu")
    assert r["client_errors"] == 0 and r["errors"] == [] and r["device"] == "cpu"
    assert r["tick_count"] > 0 and r["postwarm_ticks"] > 0 and r["postwarm_s"] > 0
    assert len(r["rss_series"]) >= 2
    ticks = [n for _, _, n in r["rss_series"]]
    assert ticks == sorted(ticks)  # tick_count never falls back
    for key in ("rss_growth_mb", "rss_growth_mb_per_s", "python_growth_mb", "native_residual_mb"):
        assert np.isfinite(r[key]), key
    assert r["native_residual_mb"] == pytest.approx(r["rss_growth_mb"] - r["python_growth_mb"])
    torch_rss_attrib.print_report(r)
    out = capsys.readouterr().out
    for head in ("post-warm window:", "RSS growth:", "tracemalloc (Python):", "native residual:",
                 "top Python growth sites:", "RSS time series", "client errors: 0[]"):
        assert head in out, head
