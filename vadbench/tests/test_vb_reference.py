"""The plain reference against the port at a small size on the CPU, and
the plain segmenter against the port's (this test may import both; the
reference imports nothing of the program)."""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from vadbench import harness
from vadbench.reference import segmenter as seg
from vadbench.reference import silero
from vadbench.traffic import audio

LIB = {"voiced_s": [0.5, 2.0], "pause_s": [0.3, 1.0], "voiced_pieces": 4, "pause_pieces": 3,
       "f0_hz": [140.0, 210.0], "gain_min": 0.5, "gain_max": 1.5, "gain_levels": 3}


def _port_probs(family_archive: str, pcm: np.ndarray, chunk: int) -> np.ndarray:
    from vadc_tpu_torch.engine.runner import StreamRunner
    from vadc_tpu_torch.models.weights import load_params

    family, params = load_params(harness.ROOT / family_archive, device="cpu")
    runner = StreamRunner(family, params, device="cpu")
    state = runner.init_state(pcm.shape[0])
    audio_f = torch.from_numpy(pcm.astype(np.float32) / 32768.0)
    out = []
    for k in range(pcm.shape[1] // chunk):
        probs, state = runner.step(audio_f[:, k * chunk : (k + 1) * chunk], state)
        out.append(probs.numpy())
    return np.stack(out, axis=1)


@pytest.mark.parametrize("config", ["silero_v31_16k", "silero_v4_16k"])
def test_reference_matches_the_port_on_the_cpu(config):
    cfg = harness._json(harness.ROOT / f"vadbench/configs/{config}.json")
    chunk = cfg["chunk_samples"]
    lib = audio.Library(4, LIB)
    pcm = np.stack([np.frombuffer(audio.stream_bytes(lib, 4, i, 2 * chunk * 24), "<i2")
                    for i in range(3)])
    want = _port_probs(cfg["weights"], pcm, chunk)
    params = silero.load_params(cfg["family"], harness.ROOT / cfg["weights"], "cpu")
    got = silero.stream_probs(params, torch.from_numpy(pcm.astype(np.float32) / 32768.0),
                              chunk).numpy()
    assert got.shape == want.shape == (3, 24)
    assert want.max() > 0.8 and want.min() < 0.2  # speech and pauses both present
    # fp32 on the CPU: the two sum in other orders (the limit on the card is 5e-4 at least)
    assert np.abs(got - want).max() < 5e-5


def test_the_reference_imports_nothing_of_the_program():
    for path in (harness.ROOT / "vadbench" / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
        names += [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.module]
        assert not [m for m in names if m.split(".")[0] in ("vadc_tpu", "vadc_tpu_torch", "jax")]


def test_plain_segmenter_gives_the_ports_lines():
    from vadc_tpu_torch.cli.segmenter import SegmenterConfig, segment_probabilities

    rng = np.random.default_rng(0)
    for trial in range(50):
        spans = rng.integers(1, 12, size=40)
        probs = np.repeat(rng.choice([0.05, 0.4, 0.9], size=40), spans)
        probs = np.clip(probs + rng.normal(0, 0.05, probs.size), 0, 1).astype(np.float32)
        cfg = seg.Config.for_chunk(1536, 16000)
        mine = [t for t, _ in seg.lines(probs, cfg)]
        port = [f"{s:.2f},{e:.2f}" for s, e in
                segment_probabilities(probs, SegmenterConfig.from_ms(chunk_samples=1536))]
        assert mine == port


def test_emit_chunks_say_when_each_line_is_final():
    cfg = seg.Config.for_chunk(1536, 16000)
    probs = np.array([0.0] * 3 + [0.9] * 6 + [0.0] * 5 + [0.9] * 6 + [0.0] * 5 + [0.9] * 6)
    out = seg.lines(probs, cfg)
    # the first segment is written when the second closes (chunk 22); the
    # second and the open third at the end of the stream
    assert [c for _, c in out] == [22, seg.EOF, seg.EOF]


def test_a_boundary_may_move_only_within_the_bound():
    cfg = seg.Config.for_chunk(1536, 16000)
    probs = np.array([0.0] * 3 + [0.9] * 6 + [0.34995] + [0.0] * 5 + [0.9] * 6 + [0.0] * 5)
    want = [t for t, _ in seg.lines(probs, cfg)]
    moved = probs.copy()
    moved[9] = 0.36  # the close one chunk later
    got = [t for t, _ in seg.lines(moved, cfg)]
    assert got != want
    assert seg.match(got, probs, cfg, bound=1e-3) is not None
    assert seg.match(got, probs, cfg, bound=1e-5) is None
    assert seg.match(want[:1], probs, cfg, bound=1e-3) is None
