"""The port's offline corpus CLI (`vadc_tpu_torch.cli.batch`, --device cpu)
against `vadc_tpu.cli.batch` on the same files (raw s16le of unequal length,
one pure silence, one 44.1 kHz wav), with the bundled archives given by
path: identical stdout lines and identical --cut_dir files, unsharded and
with the streams sharded over a list of CPU devices. Without a card
`--device cuda` (the default) exits 1 with one line. The ingest
(`load_streams`) reads the files straight into the slab buffer: its slabs
are the JAX CLI's grid whatever the buffer held before, and a file that
shrinks while it is read is an error."""

import numpy as np
import pytest
import torch

from tests.torch_port_util import DATA, V31_ARCHIVE, speech
from tests.torch_port_util import single_torch_thread  # noqa: F401
from vadc_tpu.cli import batch as JB
from vadc_tpu_torch.cli import batch as TB
from vadc_tpu_torch.io.wav import write_wav

SR = 16000


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Four inputs: 7.3 s, 12 s and 3.1 s of synthetic speech as raw s16le
    (none a whole number of chunks), 2.5 s of near silence, and the 12 s
    file again as a 44.1 kHz 16-bit wav."""
    root = tmp_path_factory.mktemp("corpus")
    paths = []
    pcms = []
    for i, secs in enumerate((7.3, 12.0, 3.1)):
        n = int(secs * SR)
        audio = speech(n // 1536 + 1, seed=40 + i).ravel()[:n]
        pcm = np.clip(audio * 32768, -32768, 32767).astype("<i2")
        path = root / f"speech{i}.s16le"
        pcm.tofile(path)
        paths.append(str(path))
        pcms.append(pcm)
    quiet = (0.001 * np.random.default_rng(1).normal(size=int(2.5 * SR)) * 32768).astype("<i2")
    quiet.tofile(root / "quiet.s16le")
    paths.append(str(root / "quiet.s16le"))
    # the 12 s file resampled crudely to 44.1 kHz: any material will do, both
    # CLIs decode it with their own copy of the same resampler
    idx = (np.arange(int(12.0 * 44100)) * (SR / 44100)).astype(np.int64)
    write_wav(root / "speech1_44k.wav", pcms[1][idx], sample_rate=44100)
    paths.append(str(root / "speech1_44k.wav"))
    return paths


def _run(mod, argv, capsys):
    rc = mod.main(argv)
    captured = capsys.readouterr()
    return rc, captured.out, captured.err


def _cut_files(directory):
    return {p.name: p.read_bytes() for p in sorted(directory.iterdir())}


@pytest.mark.parametrize("slab", [64, 16, 5])
def test_v31_lines_and_cut_files_equal_the_jax_cli(corpus, tmp_path, capsys, slab):
    model = ["--model", str(V31_ARCHIVE), "--slab_chunks", str(slab)]
    rc_j, out_j, _ = _run(JB, [*corpus, *model, "--cut_dir", str(tmp_path / "jax")], capsys)
    rc_t, out_t, err_t = _run(
        TB, [*corpus, *model, "--cut_dir", str(tmp_path / "port"), "--device", "cpu", "--stats"],
        capsys)
    assert rc_j == 0 and rc_t == 0
    assert out_t == out_j
    lines = out_t.splitlines()
    assert len(lines) >= 4 and not any("quiet" in line for line in lines)
    cut_j, cut_t = _cut_files(tmp_path / "jax"), _cut_files(tmp_path / "port")
    assert sorted(cut_t) == sorted(cut_j) and len(cut_t) == len(corpus)
    for name in cut_j:
        assert cut_t[name] == cut_j[name], name
    assert cut_t["quiet.s16le"] == b""
    assert "5 files" in err_t and "x realtime" in err_t


def test_sharded_over_three_devices_prints_the_unsharded_lines(corpus, tmp_path, capsys,
                                                                monkeypatch):
    """--device cuda shards the streams over every visible device: three
    CPU devices stand in for three cards, so the 5 files are padded to 6
    streams, 2 a shard. The lines and the cut files equal the unsharded
    run's (--device cpu) and the JAX batch CLI's (over its 8 virtual
    devices, 5 files padded to 8)."""
    from vadc_tpu_torch.engine import shard

    resolve, built = shard.stream_devices, []
    monkeypatch.setattr(shard, "stream_devices",
                        lambda devices=None: resolve(["cpu"] * 3 if devices is None else devices))
    monkeypatch.setattr(shard.ShardedStreamRunner, "init_state",
                        _recording(shard.ShardedStreamRunner.init_state, built))
    model = ["--model", str(V31_ARCHIVE), "--slab_chunks", "16"]
    rc_j, out_j, _ = _run(JB, [*corpus, *model, "--cut_dir", str(tmp_path / "jax")], capsys)
    rc_u, out_u, _ = _run(TB, [*corpus, *model, "--cut_dir", str(tmp_path / "one"),
                               "--device", "cpu"], capsys)
    assert built == [(1, 5)]
    rc_s, out_s, _ = _run(TB, [*corpus, *model, "--cut_dir", str(tmp_path / "three"),
                               "--device", "cuda"], capsys)
    assert built == [(1, 5), (3, 6)]
    assert rc_j == rc_u == rc_s == 0
    assert out_s == out_u == out_j and len(out_s.splitlines()) >= 4
    assert _cut_files(tmp_path / "three") == _cut_files(tmp_path / "one") \
        == _cut_files(tmp_path / "jax")


def _recording(init_state, into: list):
    """ShardedStreamRunner.init_state that records (shards, streams)."""

    def record(self, n_streams):
        into.append((self.n_shards, n_streams))
        return init_state(self, n_streams)

    return record


def test_default_model_is_the_bundled_archive(corpus, capsys):
    rc_a, out_a, _ = _run(TB, [*corpus[:2], "--device", "cpu"], capsys)
    rc_b, out_b, _ = _run(TB, [*corpus[:2], "--device", "cpu", "--model", str(V31_ARCHIVE)], capsys)
    assert rc_a == rc_b == 0 and out_a == out_b and out_a


@pytest.mark.parametrize("sequence_count", [512, 1024])
def test_other_chunk_sizes_equal_the_jax_cli(corpus, capsys, sequence_count):
    argv = [*corpus[:3], "--model", str(V31_ARCHIVE), "--sequence_count", str(sequence_count),
            "--min_silence", "150", "--threshold", "0.6"]
    rc_j, out_j, _ = _run(JB, argv, capsys)
    rc_t, out_t, _ = _run(TB, [*argv, "--device", "cpu"], capsys)
    assert rc_j == 0 and rc_t == 0 and out_t == out_j and out_t


def test_v4_archive_equals_the_jax_cli(corpus, capsys):
    """The v4 family's slabs run its own slab scan (models/slab.py)."""
    argv = [*corpus[:2], "--model", str(DATA / "silero_v4_16k.testtensor"), "--slab_chunks", "32"]
    rc_j, out_j, _ = _run(JB, argv, capsys)
    rc_t, out_t, _ = _run(TB, [*argv, "--device", "cpu"], capsys)
    assert rc_j == 0 and rc_t == 0 and out_t == out_j and out_t


def test_lines_equal_the_streaming_cli_per_file(corpus, capsys, monkeypatch):
    """Each raw file alone through the port's streaming CLI gives the batch
    CLI's segments of that file."""
    import io
    import sys

    from vadc_tpu_torch.cli import main as cli

    rc, out, _ = _run(TB, [*corpus[:3], "--device", "cpu"], capsys)
    assert rc == 0
    for path in corpus[:3]:
        with open(path, "rb") as f:
            monkeypatch.setattr(sys, "stdin", io.TextIOWrapper(f))
            assert cli.main(["--device", "cpu"]) == 0
        streamed = capsys.readouterr().out.split()
        batch = [line.split("\t")[1] for line in out.splitlines() if line.startswith(path + "\t")]
        assert batch == streamed, path


@pytest.fixture(scope="module")
def odd_corpus(corpus, tmp_path_factory):
    """The corpus and one raw file more, 4.2 s of speech and an odd
    trailing byte."""
    n = int(4.2 * SR)
    pcm = np.clip(speech(n // 1536 + 1, seed=44).ravel()[:n] * 32768, -32768, 32767).astype("<i2")
    path = tmp_path_factory.mktemp("odd") / "odd.s16le"
    path.write_bytes(pcm.tobytes() + b"\x5a")
    return [*corpus, str(path)]


def _laid_back(slabs: torch.Tensor) -> np.ndarray:
    """[n_slabs, B, slab, chunk] slabs as the [B, n_slabs * slab, chunk] grid."""
    n_slabs, streams, slab, chunk = slabs.shape
    return slabs.permute(1, 0, 2, 3).reshape(streams, n_slabs * slab, chunk).numpy()


@pytest.mark.parametrize("shards", [1, 4])
@pytest.mark.parametrize("slab", [64, 16, 5])
def test_load_streams_equals_the_jax_clis(odd_corpus, slab, shards):
    """The slabs laid back to [B, T_max, chunk] are the JAX CLI's grid bit
    for bit, the time axis past T_max and the silent streams (6 files
    padded to 8 streams for 4 shards) zero; the same emitted chunk counts
    and sample counts."""
    slabs, valid_t, lengths = TB.load_streams(odd_corpus, 1536, slab_chunks=slab, shards=shards)
    grid_j, valid_j, audios_j = JB.load_streams(odd_corpus, 1536)
    n_files, t_max = grid_j.shape[:2]
    assert slabs.dtype == torch.int16
    assert slabs.shape == (-(-t_max // slab), -(-n_files // shards) * shards, slab, 1536)
    grid_t = _laid_back(slabs)
    assert np.array_equal(grid_t[:n_files, :t_max], grid_j)
    assert not grid_t[n_files:].any() and not grid_t[:, t_max:].any()
    assert np.array_equal(valid_t, valid_j)
    assert list(lengths) == [len(a) for a in audios_j]
    assert lengths[-1] == (1 + 2 * int(4.2 * SR)) // 2


@pytest.mark.parametrize("slab,shards", [(64, 1), (5, 4)])
def test_load_streams_zeroes_what_a_reused_buffer_held(odd_corpus, monkeypatch, slab, shards):
    """A buffer full of 0x7FFF, as the pinned block of an earlier job may
    be, gives the slabs of a clean one."""
    clean = TB.load_streams(odd_corpus, 1536, slab_chunks=slab, shards=shards)[0]
    monkeypatch.setattr(TB, "slab_buffer",
                        lambda shape, pin: torch.full(shape, 0x7FFF, dtype=torch.int16))
    stale = TB.load_streams(odd_corpus, 1536, slab_chunks=slab, shards=shards)[0]
    assert torch.equal(stale, clean)


def test_load_streams_past_the_open_file_budget_reopens_the_files(odd_corpus, monkeypatch):
    """Files past half the descriptor limit are closed after their sizing
    and opened again to be read: at most that many held open while the
    buffer is taken, and the same slabs."""
    import os

    clean = TB.load_streams(odd_corpus, 1536, slab_chunks=5)[0]
    take, held = TB.slab_buffer, []

    def counted(shape, pin):
        held.append(len(os.listdir("/proc/self/fd")))
        return take(shape, pin)

    monkeypatch.setattr(TB, "slab_buffer", counted)
    before = len(os.listdir("/proc/self/fd"))
    assert torch.equal(TB.load_streams(odd_corpus, 1536, slab_chunks=5)[0], clean)
    assert held[-1] - before == 5  # the raw files, the wav closed
    monkeypatch.setattr(TB.resource, "getrlimit", lambda _which: (4, 4))
    assert torch.equal(TB.load_streams(odd_corpus, 1536, slab_chunks=5)[0], clean)
    assert held[-1] - before == 2
    assert len(os.listdir("/proc/self/fd")) == before


def test_read_runs_resumes_after_short_reads(tmp_path, monkeypatch):
    """A preadv that returns part of what was asked, and at most MAX_IOV
    buffers a call: the runs are filled in order all the same."""
    import os

    data = np.random.default_rng(3).integers(0, 256, 10_000, dtype=np.uint8)
    path = tmp_path / "f.bin"
    path.write_bytes(data.tobytes())
    preadv, calls = os.preadv, []

    def short(fd, buffers, offset):
        calls.append(len(buffers))
        return preadv(fd, [b[:777] for b in buffers[:1]], offset)

    monkeypatch.setattr(TB, "MAX_IOV", 2)
    monkeypatch.setattr(os, "preadv", short)
    out = np.zeros(10_000, np.uint8)
    runs = [memoryview(out[a:b]) for a, b in ((0, 3000), (3000, 6001), (6001, 10_000))]
    fd = os.open(path, os.O_RDONLY)
    try:
        assert TB._read_runs(fd, runs, str(path)) == 10_000
    finally:
        os.close(fd)
    assert np.array_equal(out, data) and max(calls) == 2 and len(calls) > 13


def test_a_shorter_corpus_after_a_longer_one_prints_a_fresh_processs_lines(
        corpus, tmp_path, capsys, monkeypatch):
    """Two jobs in one process, the second on shorter files, with the slab
    buffer handed back from the first job as torch's pinned-memory cache
    hands it back on a card: the second job's lines and cut files are a
    fresh process's."""
    import os
    import subprocess
    import sys

    from tests.torch_port_util import ROOT

    short = []
    for i, secs in enumerate((4.0, 1.3)):
        n = int(secs * SR)
        pcm = np.clip(speech(n // 1536 + 1, seed=50 + i).ravel()[:n] * 32768, -32768,
                      32767).astype("<i2")
        short.append(str(tmp_path / f"short{i}.s16le"))
        pcm.tofile(short[-1])
    model = ["--model", str(V31_ARCHIVE), "--slab_chunks", "16", "--device", "cpu"]
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    fresh = subprocess.run([sys.executable, "-m", "vadc_tpu_torch.cli.batch", *short, *model,
                            "--cut_dir", str(tmp_path / "fresh")],
                           capture_output=True, text=True, timeout=300, env=env, cwd=ROOT)
    assert fresh.returncode == 0, fresh.stderr

    cache, handed = [], []

    def cached(shape, pin):
        need = int(np.prod(shape))
        if not cache or cache[0].numel() < need:
            cache[:] = [torch.empty(need, dtype=torch.int16)]
        handed.append(cache[0].data_ptr())
        return cache[0][:need].view(shape)

    monkeypatch.setattr(TB, "slab_buffer", cached)
    rc_long, out_long, _ = _run(TB, [*corpus[:3], *model], capsys)
    rc, out, _ = _run(TB, [*short, *model, "--cut_dir", str(tmp_path / "after")], capsys)
    assert rc_long == rc == 0 and out_long
    assert handed[0] == handed[1]
    assert out == fresh.stdout and out
    assert _cut_files(tmp_path / "after") == _cut_files(tmp_path / "fresh")


def test_a_file_that_shrinks_after_it_was_sized_exits_1(corpus, tmp_path, capsys, monkeypatch):
    """A file cut short between its fstat and its read is an error of one
    line, never zeros in its place."""
    path = tmp_path / "shrinks.s16le"
    path.write_bytes(open(corpus[0], "rb").read())
    take = TB.slab_buffer

    def truncate_then_take(shape, pin):
        with open(path, "r+b") as f:
            f.truncate(3000)
        return take(shape, pin)

    monkeypatch.setattr(TB, "slab_buffer", truncate_then_take)
    rc, out, err = _run(TB, [corpus[1], str(path), "--device", "cpu"], capsys)
    assert rc == 1 and out == ""
    assert len(err.strip().splitlines()) == 1
    assert err.startswith("Error: ") and "shrank" in err and str(path) in err


def test_cuda_is_the_default_and_exits_1_without_a_card(corpus, capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    for argv in ([corpus[0]], [corpus[0], "--device", "cuda"]):
        rc, out, err = _run(TB, argv, capsys)
        assert rc == 1 and out == ""
        assert len(err.strip().splitlines()) == 1 and "no CUDA device" in err


@pytest.mark.parametrize("argv", [["--fast"], ["--precision", "fast"], ["--precision", "turbo"],
                                  ["--precision", "balanced"]])
def test_unported_tiers_are_refused_in_one_line(corpus, capsys, argv):
    """No tier is refused any more: the v4 model at each bf16 tier prints
    the JAX batch CLI's lines at the tier over the corpus."""
    v4 = ["--model", str(DATA / "silero_v4_16k.testtensor"), *argv]
    rc_j, out_j, _ = _run(JB, [*corpus, *v4], capsys)
    rc, out, err = _run(TB, [*corpus, "--device", "cpu", *v4], capsys)
    assert rc == rc_j == 0, err
    assert out == out_j and out.count("\n") >= 3


def test_missing_input_and_missing_model_exit_1(corpus, tmp_path, capsys):
    rc, _, err = _run(TB, [str(tmp_path / "absent.s16le"), "--device", "cpu"], capsys)
    assert rc == 1 and err.startswith("Error:")
    rc, _, err = _run(TB, [corpus[0], "--device", "cpu", "--model", str(tmp_path / "no.testtensor")],
                      capsys)
    assert rc == 1 and "no weight archive" in err


def test_same_basename_from_two_directories_gets_two_cut_files(corpus, tmp_path, capsys):
    other = tmp_path / "other"
    other.mkdir()
    twin = other / "speech0.s16le"
    twin.write_bytes(open(corpus[2], "rb").read())
    rc, _, _ = _run(TB, [corpus[0], str(twin), "--device", "cpu", "--cut_dir", str(tmp_path / "cut")],
                    capsys)
    assert rc == 0
    assert sorted(p.name for p in (tmp_path / "cut").iterdir()) == ["speech0.s16le", "speech0_1.s16le"]


@pytest.mark.parametrize("argv", [["--fast"], ["--precision", "balanced"], ["--precision", "turbo"]])
def test_bf16_tiers_print_the_faithful_lines(corpus, capsys, argv):
    rc, want, _ = _run(TB, [*corpus, "--device", "cpu"], capsys)
    rc_t, got, _ = _run(TB, [*corpus, "--device", "cpu", *argv], capsys)
    assert rc == rc_t == 0 and got == want and want.count("\n") >= 3
