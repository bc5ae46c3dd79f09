"""The port's live-stream examples (examples/serve_streams_torch.py,
examples/serve_pool_torch.py) against the JAX package's
(examples/serve_streams.py, examples/serve_pool.py) on the CPU.

Each example runs in this process on the same three seeded s16le speech
files of different lengths (10-15 s), so the pool's ticks run with
streams masked out near the ends. The FSM each example builds is recorded
(chip_smoke.py: recording_fsm), which gives every stream's probabilities.
The event lines are compared per file, in order, by chip_smoke.py's
compare_events: identical, except that a boundary may move by one chunk
where the JAX run's probability at that chunk lies within the path's bound
of a threshold (faithful: 1e-4; --fast: the bound tests/test_torch_tiers.py
holds the port's fast v3.1 to against JAX's fast); each such chunk is
printed. On the port alone, serve_pool's lines per file are serve_streams'
while the file lasts (serve_streams feeds zeros past a file's end).
"""

import contextlib
import importlib.util
import io
import os
import subprocess
import sys

import numpy as np
import pytest

from tests.torch_port_util import DATA, ROOT, jax_cache_kept, single_torch_thread  # noqa: F401
from vadc_tpu_torch.kernels.tier_check import SPEECH_BOUND

FAITHFUL_BOUND = 1e-4
FAST_BOUND = SPEECH_BOUND["v3"]["fast"]  # tests/test_torch_tiers.py: JAX_TIER_BOUND["fast"]
SECONDS = (10.3, 12.7, 15.1)

#: case -> (the model's archive name, or "v5" for the synthetic archive; extra
#: flags; probability bound; seconds per chunk)
CASES = {
    "v3": (None, [], FAITHFUL_BOUND, 0.096),
    "v3 --fast": (None, ["--fast"], FAST_BOUND, 0.096),
    "v4": ("silero_v4_16k.testtensor", [], FAITHFUL_BOUND, 0.096),
    "v5": ("v5", [], FAITHFUL_BOUND, 0.032),
}


def _load(path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def smoke():
    return _load(ROOT / "chip_smoke.py", "chip_smoke")


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """(the three s16le files, the synthetic v5 archive), seeded."""
    from vadc_tpu_torch.io.synthaudio import utterance_track
    from vadc_tpu_torch.models.synthetic import random_v5_archive, save_archive

    root = tmp_path_factory.mktemp("examples")
    files = []
    for seed, seconds in enumerate(SECONDS):
        audio, _ = utterance_track(4, seed=seed)
        path = root / f"speech{seed}.s16le"
        pcm = np.clip(audio[: int(seconds * 16000) + 37 * seed] * 32768, -32768, 32767)
        pcm.astype("<i2").tofile(path)
        files.append(str(path))
    v5 = root / "v5_synthetic.testtensor"
    save_archive(v5, random_v5_archive(0))
    return files, v5


def _argv(case: str, inputs) -> list:
    files, v5 = inputs
    model, extra, _, _ = CASES[case]
    if model is not None:
        extra = [*extra, "--model", str(v5 if model == "v5" else DATA / model)]
    return [*extra, *files]


def _need_native(*, jax_too: bool = False):
    """Skip unless the pool's library loads, in the port (and in the JAX
    package, whose module latches its own first attempt)."""
    from vadc_tpu_torch import native

    if not native.available():
        pytest.skip("native library unavailable (make -C native)")
    if jax_too:
        from vadc_tpu import native as jax_native

        if not jax_native.available():
            pytest.skip("native library unavailable to vadc_tpu (make -C native)")


def _jax(smoke, name: str, argv: list):
    """The JAX example's main() with argv as its command line: (stdout, FsmRecord)."""
    from vadc_tpu import native as jax_native

    module = _load(ROOT / "examples" / f"{name}.py", f"jax_{name}")
    out, err = io.StringIO(), io.StringIO()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sys, "argv", [f"{name}.py", *argv])
        with smoke.recording_fsm(jax_native) as record, contextlib.redirect_stdout(out), \
                contextlib.redirect_stderr(err):
            rc = module.main()
    assert rc == 0, err.getvalue()
    return out.getvalue(), record


@pytest.fixture(scope="module")
def port(smoke, inputs):
    """(name, case) -> the port's example with --device cpu: (stdout,
    FsmRecord), run once a module."""
    runs = {}

    def run(name: str, case: str):
        if (name, case) not in runs:
            out, _, record = smoke.run_example(name, ["--device", "cpu", *_argv(case, inputs)])
            runs[name, case] = out, record
        return runs[name, case]

    return run


def _against_jax(smoke, port, name: str, case: str, inputs) -> None:
    files = inputs[0]
    _, _, bound, spc = CASES[case]
    want, want_record = _jax(smoke, name[: -len("_torch")], _argv(case, inputs))
    got, got_record = port(name, case)
    want_probs = want_record.stream_probs()
    for f, p, q in zip(files, got_record.stream_probs(), want_probs):
        assert p.shape == q.shape, (f, p.shape, q.shape)
        err = float(np.abs(p - q).max())
        print(f"{name} {case}: {os.path.basename(f)}: {p.size} chunks, largest probability "
              f"difference from the JAX example's {err:.2e} (bound {bound:g})")
        # JAX's fast tier sums its products in fp32 on the CPU, as faithful
        # does; the port's in bf16. On speech2 the port's fast reads 3.46e-2
        # from faithful at one chunk, beyond SPEECH_BOUND's 3e-2 (its readings
        # over seeds 0-11 of the float tracks, rounded up), so only the events
        # are held at --fast.
        assert CASES[case][1] == ["--fast"] or err <= bound, (f, err)
    got_lines, want_lines = smoke.lines_by_file(got), smoke.lines_by_file(want)
    assert sum(map(len, want_lines.values())) >= len(files), want
    notes = smoke.compare_events(f"{name} {case}", got_lines, want_lines,
                                 dict(zip(files, want_probs)), spc, bound, smoke.fsm_thresholds())
    for note in notes:
        print(note)


@pytest.mark.parametrize("case", ["v3", "v3 --fast", "v4"])
def test_serve_streams_prints_the_jax_examples_events(smoke, port, inputs, jax_cache_kept, case):
    _against_jax(smoke, port, "serve_streams_torch", case, inputs)


@pytest.mark.parametrize("case", ["v3", "v5"])
def test_serve_pool_prints_the_jax_examples_events(smoke, port, inputs, jax_cache_kept, case):
    _need_native(jax_too=True)
    _against_jax(smoke, port, "serve_pool_torch", case, inputs)


@pytest.mark.parametrize("case", ["v3", "v5"])
def test_serve_pool_events_are_serve_streams_events(smoke, port, inputs, case):
    """Per file, serve_pool_torch's lines are those serve_streams_torch gave
    while the file lasted; some ticks ran with streams masked out (the
    masked merge, and for v5 the context's)."""
    _need_native()
    files = inputs[0]
    spc = CASES[case][3]
    pool_out, pool = port("serve_pool_torch", case)
    _, streams = port("serve_streams_torch", case)
    lengths = [len(p) for p in pool.stream_probs()]
    want = smoke.record_lines(streams, files, spc, before=lengths)
    assert sum(map(len, want.values())) >= len(files), want
    assert smoke.lines_by_file(pool_out) == want
    assert len(set(lengths)) == len(files), lengths
    assert any(a is not None and not a.all() for _, a, _ in pool.calls)
    for p, q in zip(pool.stream_probs(), streams.stream_probs()):
        np.testing.assert_array_equal(p, q[: len(p)])


@pytest.mark.parametrize("script", ["serve_streams_torch.py", "serve_pool_torch.py"])
def test_example_without_a_card_is_a_one_line_error(inputs, script):
    """Without --device the example asks for the card: here, with none, it
    exits 1 with one line on stderr and prints nothing."""
    proc = subprocess.run([sys.executable, str(ROOT / "examples" / script), inputs[0][0]],
                          cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 1, proc.stderr
    assert proc.stdout == ""
    lines = proc.stderr.splitlines()
    assert len(lines) == 1 and lines[0].startswith("Error: no CUDA device"), proc.stderr
