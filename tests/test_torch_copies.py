"""The port's copies of vadc_tpu's numpy-only modules give what the
originals give. The port imports nothing of vadc_tpu, so it keeps its own
`io/*`, `cli/segmenter.py`, `cli/stats.py`, `cli/filter_script.py`,
`native.py` and the ONNX readers of `export/`; each is held here to its
original on seeded inputs, case by case. Everything is integer or bitwise
logic, or the same float arithmetic in the same order: the results are
required equal, not close."""

import inspect
import io
import struct

import numpy as np
import pytest

from tests.torch_port_util import V31_ARCHIVE, build_v3_onnx
from vadc_tpu import native as j_native
from vadc_tpu.cli import filter_script as j_filter
from vadc_tpu.cli import segmenter as j_segmenter
from vadc_tpu.cli import stats as j_stats
from vadc_tpu.export import onnx_build
from vadc_tpu.export import torch_export as j_torch_export
from vadc_tpu.export import onnx_extract as j_extract
from vadc_tpu.export import silero_v3_from_onnx as j_v3
from vadc_tpu.engine import onnx_backend as j_backend
from vadc_tpu.export import onnx_exec as j_exec
from vadc_tpu.export import silero_v4_from_onnx as j_v4
from vadc_tpu.export import silero_v5_from_onnx as j_v5
from vadc_tpu.io import degrade as j_degrade
from vadc_tpu.io import ffmpeg as j_ffmpeg
from vadc_tpu.io import pcm as j_pcm
from vadc_tpu.io import resample as j_resample
from vadc_tpu.io import synthaudio as j_synth
from vadc_tpu.io import testtensor as j_tt
from vadc_tpu.io import wav as j_wav
from vadc_tpu.models.synthetic import random_v5_8k_archive, random_v5_archive
from vadc_tpu_torch import native as t_native
from vadc_tpu_torch.cli import filter_script as t_filter
from vadc_tpu_torch.cli import segmenter as t_segmenter
from vadc_tpu_torch.cli import stats as t_stats
from vadc_tpu_torch.export import onnx_build as t_onnx_build
from vadc_tpu_torch.export import onnx_extract as t_extract
from vadc_tpu_torch.export import torch_export as t_torch_export
from vadc_tpu_torch.export import silero_v3_from_onnx as t_v3
from vadc_tpu_torch.engine import onnx_backend as t_backend
from vadc_tpu_torch.export import onnx_exec as t_exec
from vadc_tpu_torch.export import silero_v4_from_onnx as t_v4
from vadc_tpu_torch.export import silero_v5_from_onnx as t_v5
from vadc_tpu_torch.io import degrade as t_degrade
from vadc_tpu_torch.io import ffmpeg as t_ffmpeg
from vadc_tpu_torch.io import pcm as t_pcm
from vadc_tpu_torch.io import resample as t_resample
from vadc_tpu_torch.io import synthaudio as t_synth
from vadc_tpu_torch.io import testtensor as t_tt
from vadc_tpu_torch.io import wav as t_wav

PAIRS = {
    "io.pcm": (j_pcm, t_pcm), "io.resample": (j_resample, t_resample), "io.wav": (j_wav, t_wav),
    "io.ffmpeg": (j_ffmpeg, t_ffmpeg), "io.testtensor": (j_tt, t_tt),
    "cli.segmenter": (j_segmenter, t_segmenter), "cli.stats": (j_stats, t_stats),
    "native": (j_native, t_native), "export.onnx_extract": (j_extract, t_extract),
    "export.silero_v3_from_onnx": (j_v3, t_v3), "export.silero_v4_from_onnx": (j_v4, t_v4),
    "export.silero_v5_from_onnx": (j_v5, t_v5), "export.onnx_exec": (j_exec, t_exec),
    "engine.onnx_backend": (j_backend, t_backend), "io.synthaudio": (j_synth, t_synth),
    "cli.filter_script": (j_filter, t_filter), "io.degrade": (j_degrade, t_degrade),
    "export.onnx_build": (onnx_build, t_onnx_build),
    "export.torch_export": (j_torch_export, t_torch_export),
}


def _code(module) -> str:
    """A module's source without comment-only lines and with the package
    name normalized: what a copy must share with its original."""
    lines = [line for line in inspect.getsource(module).splitlines()
             if not line.lstrip().startswith("#")]
    return "\n".join(lines).replace("vadc_tpu_torch", "vadc_tpu")


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_copy_has_the_originals_code_and_public_names(name):
    original, copy = PAIRS[name]
    assert copy.__name__ == "vadc_tpu_torch." + name
    assert _code(copy) == _code(original)
    public = lambda m: sorted(n for n in vars(m) if not n.startswith("_"))  # noqa: E731
    assert public(copy) == public(original)


def test_copies_import_the_ports_siblings():
    assert t_wav.read_full is t_pcm.read_full
    assert t_wav.PolyphaseResampler is t_resample.PolyphaseResampler
    assert t_v3.parse_model is t_extract.parse_model
    assert t_v3.convert_onnx_lstm is t_v4.convert_onnx_lstm
    assert t_v3.save_testtensor is t_tt.save_testtensor
    assert t_v4.parse_model is t_extract.parse_model
    assert t_v5.extract_initializers is t_extract.extract_initializers
    assert t_exec.parse_model is t_extract.parse_model
    assert t_backend.OnnxExecutor is t_exec.OnnxExecutor
    assert t_degrade._ima_expand is t_wav._ima_expand
    assert t_degrade._ULAW_F32 is t_wav._ULAW_F32 and t_degrade._ALAW_F32 is t_wav._ALAW_F32
    assert t_torch_export.save_testtensor is t_tt.save_testtensor


def _pcm(n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(-32768, 32768, size=n, dtype=np.int64).astype("<i2")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pcm_conversion(seed):
    raw = _pcm(4001, seed).tobytes()
    f_j, f_t = j_pcm.s16le_to_f32(raw), t_pcm.s16le_to_f32(raw)
    assert f_t.dtype == np.float32 and np.array_equal(f_t, f_j)
    x = (1.3 * np.random.default_rng(seed).normal(size=999)).astype(np.float32)
    assert t_pcm.f32_to_s16le(x) == j_pcm.f32_to_s16le(x)
    assert t_pcm.BYTES_PER_SAMPLE == j_pcm.BYTES_PER_SAMPLE == 2
    assert [e.name for e in t_pcm.BSError] == [e.name for e in j_pcm.BSError]


@pytest.mark.parametrize("window", [64, 1000, 4096])
def test_buffered_stream_refills(window):
    raw = _pcm(3000, 3).tobytes()
    got = []
    for mod in (j_pcm, t_pcm):
        bs = mod.BufferedStream(io.BytesIO(raw), window)
        chunks = []
        while True:
            data, err = bs.refill()
            chunks.append((bytes(data), err.name))
            if err != mod.BSError.NoError:
                break
        got.append(chunks)
    assert got[0] == got[1] and len(got[0]) >= 2


@pytest.mark.parametrize("rates", [(44100, 16000), (48000, 8000), (8000, 16000), (22050, 16000)])
def test_resampler_in_pieces(rates):
    src, dst = rates
    x = np.random.default_rng(src).normal(size=5000).astype(np.float32)
    outs = []
    for mod in (j_resample, t_resample):
        r = mod.PolyphaseResampler(src, dst)
        pieces = [r.process(x[:1234]), r.process(x[1234:1300]), r.process(x[1300:]), r.flush()]
        outs.append(np.concatenate(pieces))
    assert outs[0].size > 0 and np.array_equal(outs[0], outs[1])


def _wav_bytes(rate: int, bits: int, channels: int, seed: int) -> bytes:
    """A PCM wav of 0.4 s written by hand (format 1; 8-bit unsigned, 16/24/32
    signed little endian)."""
    rng = np.random.default_rng(seed)
    n = int(0.4 * rate)
    x = (0.5 * np.sin(2 * np.pi * 220 * np.arange(n) / rate)[:, None]
         + 0.05 * rng.normal(size=(n, channels)))
    x = np.clip(x, -1, 1)
    if bits == 8:
        body = ((x * 127) + 128).astype(np.uint8).tobytes()
    elif bits == 16:
        body = (x * 32767).astype("<i2").tobytes()
    elif bits == 24:
        v = (x * 8388607).astype("<i4")
        body = v.astype("<i4").view(np.uint8).reshape(-1, 4)[:, :3].tobytes()
    else:
        body = (x * 2147483647).astype("<i4").tobytes()
    block = channels * bits // 8
    fmt = struct.pack("<HHIIHH", 1, channels, rate, rate * block, block, bits)
    return (b"RIFF" + struct.pack("<I", 36 + len(body)) + b"WAVE" + b"fmt "
            + struct.pack("<I", 16) + fmt + b"data" + struct.pack("<I", len(body)) + body)


@pytest.mark.parametrize("rate,bits,channels", [(16000, 16, 1), (44100, 16, 2), (8000, 8, 1),
                                                (48000, 24, 2), (22050, 32, 1)])
@pytest.mark.parametrize("target", [16000, 8000])
def test_wav_read(tmp_path, rate, bits, channels, target):
    path = tmp_path / "in.wav"
    path.write_bytes(_wav_bytes(rate, bits, channels, seed=rate + bits))
    a, b = j_wav.read_file_s16(path, target_rate=target), t_wav.read_file_s16(path, target_rate=target)
    assert b.dtype == a.dtype and b.size > 0 and np.array_equal(a, b)
    with open(path, "rb") as f:
        h_j = j_wav.read_wav_header(f)
    with open(path, "rb") as f:
        h_t = t_wav.read_wav_header(f)
    assert vars(h_t) == vars(h_j) and h_t.codec_name == h_j.codec_name
    # the streaming source, read in odd pieces
    outs = []
    for mod in (j_wav, t_wav):
        with mod.WavSource(str(path), target_rate=target) as s:
            data = b""
            while piece := s.read(777):
                data += piece
        outs.append(data)
    assert outs[0] == outs[1] and outs[0]


@pytest.mark.parametrize("rate", [8000, 16000, 44100])
def test_wav_write_and_sniff(tmp_path, rate):
    samples = _pcm(3000, rate)
    j_wav.write_wav(tmp_path / "j.wav", samples, sample_rate=rate)
    t_wav.write_wav(tmp_path / "t.wav", samples, sample_rate=rate)
    data = (tmp_path / "t.wav").read_bytes()
    assert data == (tmp_path / "j.wav").read_bytes()
    assert t_wav.is_riff_wave(data[:12]) and j_wav.is_riff_wave(data[:12])
    assert not t_wav.is_riff_wave(b"RIFFxxxxAVI ")
    assert t_wav.sniff_media_head(tmp_path / "t.wav") == j_wav.sniff_media_head(tmp_path / "t.wav")
    raw = tmp_path / "raw.s16le"
    samples.tofile(raw)
    assert np.array_equal(t_wav.read_file_s16(raw), j_wav.read_file_s16(raw))
    head = t_wav.PrependStream(data[:12], io.BytesIO(data[12:]))
    assert head.read(20) + head.read() == data


def test_wav_refuses_what_the_original_refuses():
    bad = b"RIFF" + struct.pack("<I", 4) + b"WAVE"
    for mod in (j_wav, t_wav):
        with pytest.raises(mod.WavFormatError):
            mod.read_wav_header(io.BytesIO(bad))
    assert issubclass(t_wav.WavFormatError, ValueError)


@pytest.mark.parametrize("which", ["bundled v3.1", "synthetic v5", "synthetic v5 8 kHz"])
def test_testtensor_round_trip(tmp_path, which):
    if which == "bundled v3.1":
        tensors = j_tt.load_testtensor(V31_ARCHIVE)
        loaded = t_tt.load_testtensor(V31_ARCHIVE)
        assert list(loaded) == list(tensors)
    else:
        tensors = random_v5_archive(0) if which == "synthetic v5" else random_v5_8k_archive(1)
    assert t_tt.save_testtensor_bytes(tensors) == j_tt.save_testtensor_bytes(tensors)
    t_tt.save_testtensor(tmp_path / "a.testtensor", tensors)
    back = j_tt.load_testtensor(tmp_path / "a.testtensor")
    again = t_tt.load_testtensor_bytes((tmp_path / "a.testtensor").read_bytes())
    assert list(back) == list(again) == list(tensors)
    for k in tensors:
        assert np.array_equal(back[k], tensors[k]) and np.array_equal(again[k], tensors[k])
        assert again[k].dtype == back[k].dtype


def test_testtensor_refuses_garbage():
    for mod in (j_tt, t_tt):
        with pytest.raises(mod.TestTensorError):
            mod.load_testtensor_bytes(b"not an archive")


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("chunk", [512, 1536])
def test_segmenter_on_random_probabilities(seed, chunk):
    rng = np.random.default_rng(seed)
    probs = np.clip(np.repeat(rng.random(60), rng.integers(1, 6, size=60)) + 0.05 * rng.normal(size=1), 0, 1)
    kw = dict(chunk_samples=chunk, min_silence_ms=100.0 + 50 * seed, min_speech_ms=200.0,
              threshold=0.5 + 0.02 * seed, neg_threshold_relative=0.15, speech_pad_ms=30.0)
    cj, ct = j_segmenter.SegmenterConfig.from_ms(**kw), t_segmenter.SegmenterConfig.from_ms(**kw)
    assert vars(ct) == vars(cj)
    want = j_segmenter.segment_probabilities(probs, cj)
    assert t_segmenter.segment_probabilities(probs, ct) == want and want
    # resumable state: stop half way, carry the state dict over, finish
    a, b = t_segmenter.Segmenter(ct), t_segmenter.Segmenter(ct)
    half = len(probs) // 2
    out = [s for p in probs[:half] for s in a.feed(float(p))]
    b.load_state_dict(a.state_dict())
    out += [s for p in probs[half:] for s in b.feed(float(p))] + list(b.finish())
    assert out == want
    for s, e in want:
        assert t_segmenter.format_segment_seconds(s, e) == j_segmenter.format_segment_seconds(s, e)
        assert (t_segmenter.format_segment_centiseconds(s, e)
                == j_segmenter.format_segment_centiseconds(s, e))
    samples = _pcm(int(len(probs) * chunk), seed)
    assert np.array_equal(t_segmenter.slice_segments(samples, want, 16000),
                          j_segmenter.slice_segments(samples, want, 16000))


def test_stats_line(capsys):
    lines = []
    for mod in (j_stats, t_stats):
        s = mod.Stats(output_enabled=True, sample_rate=8000, start_time=0.0)
        s.add_samples(8000 * 3725)
        s.add_speech(1.0, 2.5)
        s.print_line(final=True)
        lines.append(capsys.readouterr().err.split(" / ")[0])
    assert lines[0] == lines[1] and lines[0].startswith("time=01:02:05.000")
    quiet = t_stats.Stats()
    quiet.print_line()
    assert capsys.readouterr().err == ""


def test_ffmpeg_command_and_error_kinds():
    kw = dict(audio_source=2, start_seconds=1.5, sample_rate=8000)
    assert t_ffmpeg.ffmpeg_command("a b.mp4", **kw) == j_ffmpeg.ffmpeg_command("a b.mp4", **kw)
    assert "8000" in t_ffmpeg.ffmpeg_command("x.mp3", sample_rate=8000)


def test_native_loads_the_same_library():
    """The same sources, built by the same `make -C native` into the same
    file. (Whether a process finds it loadable is not compared: several
    processes that start with no library each run `make` at first use, and
    one of them can meet a half-written file and latch 'unavailable'.)"""
    assert t_native._NATIVE_DIR == j_native._NATIVE_DIR
    assert t_native._LIB_PATH == j_native._LIB_PATH
    assert (t_native._NATIVE_DIR / "Makefile").exists()
    if t_native.available() and j_native.available():
        assert t_native._lib._name == j_native._lib._name


@pytest.mark.parametrize("seed", [0, 1])
def test_native_pcm_and_fsm(seed):
    samples = _pcm(1536 * 5 + 17, seed)
    assert np.array_equal(t_native.s16le_to_f32(samples), j_native.s16le_to_f32(samples))
    assert np.array_equal(t_native.frame_s16le(samples, 1536), j_native.frame_s16le(samples, 1536))
    rng = np.random.default_rng(seed)
    probs = np.repeat(rng.random((3, 20)), 4, axis=1).astype(np.float32)
    kw = dict(threshold=0.5, neg_threshold=0.35, min_silence_chunks=2, min_speech_chunks=3)
    fj, ft = j_native.NativeFsm(3, **kw), t_native.NativeFsm(3, **kw)
    active = np.array([1, 0, 1], np.uint8)
    for a, b in ((0, 30), (30, 80)):
        assert ft.feed(probs[:, a:b], active=active) == fj.feed(probs[:, a:b], active=active)
    assert np.array_equal(ft.triggered, fj.triggered)
    assert np.array_equal(ft.speech_start, fj.speech_start)
    assert np.array_equal(ft.chunk_index, fj.chunk_index)


@pytest.mark.parametrize("seed", [0, 1])
def test_convert_onnx_lstm(seed):
    rng = np.random.default_rng(seed)
    W, R, B = rng.normal(size=(1, 256, 64)), rng.normal(size=(1, 256, 64)), rng.normal(size=(1, 512))
    for a, b in zip(t_v4.convert_onnx_lstm(W, R, B), j_v4.convert_onnx_lstm(W, R, B)):
        assert np.array_equal(a, b)


@pytest.fixture(scope="module")
def v5_onnx(tmp_path_factory):
    path = tmp_path_factory.mktemp("onnx") / "silero_v5_synthetic.onnx"
    onnx_build.build_silero_v5_onnx(path, random_v5_archive(0), random_v5_8k_archive(1))
    return path


def test_parse_and_classify_a_built_v5_graph(v5_onnx):
    gj, gt = j_extract.parse_model(v5_onnx), t_extract.parse_model(v5_onnx)
    assert gt.inputs == gj.inputs and gt.outputs == gj.outputs
    assert [n.op_type for n in gt.nodes] == [n.op_type for n in gj.nodes]
    ij, it = gj.all_initializers(), gt.all_initializers()
    assert list(it) == list(ij) and len(it) > 10
    assert all(np.array_equal(it[k], ij[k]) for k in ij)
    assert t_extract.lstm_hidden_sizes(gt) == j_extract.lstm_hidden_sizes(gj) == {128}
    assert t_extract.classify_model(v5_onnx) == j_extract.classify_model(v5_onnx) == "v5"
    ej, et = j_extract.extract_initializers(v5_onnx), t_extract.extract_initializers(v5_onnx)
    assert list(et) == list(ej) and all(np.array_equal(et[k], ej[k]) for k in ej)


def test_classify_refuses_what_is_no_graph(tmp_path):
    junk = tmp_path / "junk.onnx"
    junk.write_bytes(b"\xff" * 64)
    for mod in (j_extract, t_extract):
        with pytest.raises(ValueError, match="unrecognized model graph"):
            mod.classify_model(junk)


@pytest.fixture(scope="module")
def v3_onnx(tmp_path_factory):
    """tests/torch_port_util.py: build_v3_onnx, a graph with the markers of
    the official v3 export made from the bundled v3.1 archive: (its path,
    the archive)."""
    return build_v3_onnx(tmp_path_factory.mktemp("onnx3") / "silero_v3_rebuilt.onnx")


def test_v3_extraction_from_a_rebuilt_graph(v3_onnx):
    path, archive = v3_onnx
    assert t_extract.classify_model(path) == j_extract.classify_model(path) == "v3"
    ej, et = j_v3.extract_silero_v3(path), t_v3.extract_silero_v3(path)
    assert list(et) == list(ej)
    for k in ej:
        assert np.array_equal(et[k], ej[k]), k
    # and both give back the archive the graph was made from (less its
    # batch-norm tensors, which the official export folds away)
    for k, v in et.items():
        assert np.array_equal(v, archive[k]), k
    assert set(archive) - set(et) == {k for k in archive if "batch_norm" in k}


def test_the_ports_loader_takes_the_rebuilt_v3_graph(v3_onnx):
    from vadc_tpu_torch.models.weights import load_params

    path, archive = v3_onnx
    family, params = load_params(path)
    assert family == "v3" and len(params["layers"]) == 4
    assert np.array_equal(params["lstm_w"].numpy(), archive["weights"])
    assert "bn_w" not in params["layers"][0]


def test_a_v3_graph_has_no_8k_branch(v3_onnx):
    from vadc_tpu.models.weights import load_params as jax_load_params
    from vadc_tpu_torch.models.weights import load_params

    path, _ = v3_onnx
    for load in (jax_load_params, load_params):
        with pytest.raises(ValueError, match="v3 models have no 8 kHz branch"):
            load(path, sample_rate=8000)


@pytest.mark.parametrize("seed", [0, 7])
def test_synthetic_speech_is_the_same_track(seed):
    """The speech the tiers' checks run on (chip_smoke.py) is the JAX
    package's, sample for sample."""
    (a, ra), (b, rb) = t_synth.utterance_track(4, seed=seed), j_synth.utterance_track(4, seed=seed)
    assert a.dtype == b.dtype and np.array_equal(a, b) and ra == rb and a.size > 16000


@pytest.mark.parametrize("seed", [0, 1])
def test_filter_script(seed):
    """The filter-script tool: the same ffmpeg filtergraph from the same
    segment lines (blank lines skipped), through main on streams too."""
    rng = np.random.default_rng(seed)
    starts = np.sort(rng.uniform(0, 600, size=7)).round(2)
    lines = "".join(f"{a:.2f},{a + d:.2f}\n\n" for a, d in zip(starts, rng.uniform(0.3, 4, 7)))
    outs = []
    for mod in (j_filter, t_filter):
        segs = list(mod.parse_segments(io.StringIO(lines)))
        out = io.StringIO()
        assert mod.main(io.StringIO(lines), out) == 0
        assert out.getvalue() == mod.build_filterscript(segs)
        outs.append(out.getvalue())
    assert outs[0] == outs[1] and outs[1].count("between(t,") == 7
    assert t_filter.build_filterscript([]) == j_filter.build_filterscript([])


@pytest.mark.parametrize("seed", [0, 1])
def test_degradations(seed):
    """Every transform of io/degrade.py gives the original's samples on
    seeded speech (the codecs through the port's own G.711 and IMA tables)."""
    audio, truth = j_synth.utterance_track(2, seed=seed)
    cases = {
        "synthetic_rir": lambda m: m.synthetic_rir(16000, 0.6, seed=seed),
        "reverb": lambda m: m.reverb(audio, 16000, 0.4, seed=seed),
        "bandlimit": lambda m: m.bandlimit(audio, 16000),
        "bandlimit_wide": lambda m: m.bandlimit(audio, 16000, 100.0, 7000.0),
        "clip": lambda m: m.clip(audio, 0.25),
        "g711_mu": lambda m: m.g711_roundtrip(audio, law="mu"),
        "g711_a": lambda m: m.g711_roundtrip(audio, law="a"),
        # the IMA encoder is a sample loop in Python: 1.5 s of the track
        "adpcm": lambda m: m.adpcm_roundtrip(audio[:24000]),
        "babble": lambda m: m.mix_background(audio, truth, m.babble(3.0, seed=seed + 7), 10.0,
                                             16000),
        "music": lambda m: m.mix_background(audio, truth, m.music(3.0, seed=seed + 8), 10.0,
                                            16000),
    }
    for name, case in cases.items():
        got, want = case(t_degrade), case(j_degrade)
        assert got.dtype == want.dtype and np.array_equal(got, want), name


def test_onnx_build_writes_the_originals_bytes(tmp_path):
    a16, a8 = random_v5_archive(3), random_v5_8k_archive(4)
    onnx_build.build_silero_v5_onnx(tmp_path / "j.onnx", a16, a8)
    t_onnx_build.build_silero_v5_onnx(tmp_path / "t.onnx", a16, a8)
    assert (tmp_path / "t.onnx").read_bytes() == (tmp_path / "j.onnx").read_bytes()


@pytest.mark.parametrize("seed", [0, 1])
def test_torch_export_maps_state_dicts_as_the_original(seed):
    """The v5 mapping at both rates (a synthetic upstream state dict, keys
    with and without the `_l0` suffix) and the fused LSTM."""
    rng = np.random.default_rng(seed)
    r = lambda *shape: rng.normal(size=shape).astype(np.float32)  # noqa: E731
    sd = {}
    for prefix, basis in (("_model.", 258), ("_model_8k.", 130)):
        sd[prefix + "stft.forward_basis_buffer"] = r(basis, 1, basis - 2)
        for i, s in enumerate([(128, basis // 2, 3), (64, 128, 3), (64, 64, 3), (128, 64, 3)]):
            sd[f"{prefix}encoder.{i}.reparam_conv.weight"] = r(*s)
            sd[f"{prefix}encoder.{i}.reparam_conv.bias"] = r(s[0])
        suffix = "_l0" if seed == 0 else ""
        for part, shape in (("weight_ih", (512, 128)), ("weight_hh", (512, 128)),
                            ("bias_ih", (512,)), ("bias_hh", (512,))):
            sd[f"{prefix}decoder.rnn.{part}{suffix}"] = r(*shape)
        sd[prefix + "decoder.decoder.2.weight"] = r(1, 128, 1)
        sd[prefix + "decoder.decoder.2.bias"] = r(1)
    for rate in (16000, 8000):
        got = t_torch_export.v5_archive_from_state_dict(sd, rate)
        want = j_torch_export.v5_archive_from_state_dict(sd, rate)
        assert list(got) == list(want)
        assert all(np.array_equal(got[k], want[k]) for k in want)
    lstm = {f"lstm.{p}_l{i}": r(*s) for i in range(2)
            for p, s in (("weight_ih", (256, 64)), ("weight_hh", (256, 64)), ("bias_ih", (256,)),
                         ("bias_hh", (256,)))}
    got, want = t_torch_export.fuse_lstm(lstm, "lstm.", 2), j_torch_export.fuse_lstm(lstm, "lstm.", 2)
    assert all(np.array_equal(got[k], want[k]) for k in want)
