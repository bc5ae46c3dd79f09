"""The slab scan of the port's Silero v4 and v5 families (`forward_scan` of
silero_v4, its v4_8k shim, silero_v5 and its v5_8k shim, behind
`StreamRunner.scan`; models/slab.py) on the CPU, in its plain versions:
against the loop of the port's own steps, against the JAX package's
chunk-blocked scan (`StreamRunner(..., scan_block_chunks=K)`, its
`_scan_tblock`) and its plain scan, and through the Python API and the
batch CLI.

The scan runs the same per-chunk arithmetic as the step: the encoder over
the B*K chunks in pieces of SCAN_PIECE_CHUNKS chunks of every stream, one
LSTM call through each stream's K*F frames, the decoder over every chunk
at once. On the CPU at these slabs (B=4 x K=11, so the last piece holds
3 chunks) the encoder and the LSTM give the step's bits (h, c, a v5
context: equal, measured at every tier on speech and noise), and the
decoder's frame mean over B*K rows rounds otherwise than over B rows by
at most 1.2e-7 (measured 1.19e-7, v4 fast). At one stream the products
over a piece's few rows can sum in another order than over one chunk's,
and at a bf16 tier that can flip a rounding: tests/test_torch_tiers_v45.py
reads v5 up to 8.1e-4 apart on a speech track.
"""

import io
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tests.conftest import assert_close
from tests.torch_port_util import DATA, noise, speech
from tests.torch_port_util import single_torch_thread  # noqa: F401
from tests.torch_tier_survey import family_params
from vadc_tpu.engine import runner as JR
from vadc_tpu_torch.engine import runner as TR
from vadc_tpu_torch.kernels.tier_check import SPEECH_BOUND
from vadc_tpu_torch.models import slab

FAMILIES = ("v4", "v4_8k", "v5", "v5_8k")
TIERS = ("faithful", "balanced", "fast", "turbo")
SAMPLES = {"v4": 1536, "v4_8k": 768, "v5": 512, "v5_8k": 256}
BATCH, CHUNKS = 4, 11  # 11 = a whole piece of 8 and a short one of 3
# the whole-model bounds against the JAX package (ROADMAP.md, "What the port
# is held against"): probabilities, and h and c (c of its largest value)
JAX_BOUND = {"v4": (1e-4, 3e-4), "v4_8k": (1e-4, 3e-4), "v5": (1e-5, 5e-5),
             "v5_8k": (1e-5, 5e-5)}
MATERIALS = {"speech": speech, "noise": noise}


@pytest.fixture(scope="module")
def params():
    """family -> (JAX param tree, the port's), from the same archive."""
    return {family: family_params(family) for family in FAMILIES}


def _slab(family: str, material: str = "speech", seed: int = 3, n_chunks: int = CHUNKS):
    chunks = MATERIALS[material](BATCH * n_chunks, SAMPLES[family], seed=seed)
    return chunks.reshape(BATCH, n_chunks, SAMPLES[family])


def _steps(runner, chunks):
    """The loop of the runner's steps over chunks [B, K, S] from a fresh
    state: (probs [B, K], final state)."""
    state = runner.init_state(chunks.shape[0])
    probs = [runner.step(torch.from_numpy(chunks[:, k]), state)[0] for k in range(chunks.shape[1])]
    return torch.stack(probs, dim=1), state


def _assert_state_bits(got, want, label: str) -> None:
    assert torch.equal(got.h, want.h), f"{label}: h"
    assert torch.equal(got.c, want.c), f"{label}: c"
    if want.context is not None:
        assert torch.equal(got.context, want.context), f"{label}: context"


@pytest.mark.parametrize("tier", TIERS)
@pytest.mark.parametrize("family", FAMILIES)
def test_scan_equals_the_loop_of_steps(params, family, tier):
    """StreamRunner.scan (forward_scan) against StreamRunner.step K times,
    on speech and on noise: probabilities within 1e-5, h and c within 1e-4
    (c of its largest value). Measured: the state and the context equal
    bit for bit, probabilities at most 1.19e-7 apart."""
    runner = TR.StreamRunner(family, params[family][1], device="cpu", precision=tier)
    for material in MATERIALS:
        chunks = _slab(family, material)
        state = runner.init_state(BATCH)
        probs, got = runner.scan(chunks, state)
        assert got is state and probs.shape == (BATCH, CHUNKS)
        want_probs, want = _steps(runner, chunks)
        label = f"{family} {tier} {material}"
        assert_close(probs, want_probs, 1e-5, f"{label} probs")
        assert_close(got.h, want.h, 1e-4, f"{label} h")
        scale = max(1.0, float(want.c.abs().max()))
        assert_close(got.c / scale, want.c / scale, 1e-4, f"{label} c")
        if want.context is not None:
            assert torch.equal(got.context, want.context), f"{label} context"


@pytest.mark.parametrize("tier", ["faithful", "fast"])
@pytest.mark.parametrize("family", FAMILIES)
def test_scan_matches_the_jax_chunk_blocked_and_plain_scans(params, family, tier):
    """The port's scan against the JAX package's `_scan_tblock` (one block of
    K chunks) and its plain `scan` (lax.scan of steps) on the same numpy
    chunks, which give each other's bits. At faithful on speech and noise
    within the whole-model bounds: v4 and v4_8k 1e-4 on probabilities and
    3e-4 on (h, c), v5 and v5_8k 1e-5 and 5e-5 (measured at most 7.3e-6,
    1.8e-5; v5 8.9e-7, 2.3e-5). At fast the JAX package computes its
    products in fp32 on the CPU and the port at bf16 (its TPU arithmetic,
    tests/test_torch_tiers_v45.py), so the two are held as that file holds
    its runners at a tier: probabilities on speech within the family's
    SPEECH_BOUND (measured v4 4.0e-3, v4_8k 1.6e-3, v5 8.6e-3, v5_8k 2.1e-3)."""
    jp, tp = params[family]
    runner = TR.StreamRunner(family, tp, device="cpu", precision=tier)
    blocked = JR.StreamRunner(family, jp, precision=tier, scan_block_chunks=CHUNKS)
    plain = JR.StreamRunner(family, jp, precision=tier)
    materials = MATERIALS if tier == "faithful" else ("speech",)
    for material in materials:
        chunks = _slab(family, material)
        probs, state = runner.scan(chunks, runner.init_state(BATCH))
        p_b, s_b = blocked.scan(jnp.asarray(chunks), blocked.init_state(BATCH))
        p_p, s_p = plain.scan(jnp.asarray(chunks), plain.init_state(BATCH))
        np.testing.assert_array_equal(np.asarray(p_b), np.asarray(p_p))
        np.testing.assert_array_equal(np.asarray(s_b.h), np.asarray(s_p.h))
        label = f"{family} {tier} {material}"
        if tier != "faithful":
            assert_close(probs, p_b, SPEECH_BOUND[family][tier], f"{label} probs vs JAX")
            continue
        tol_probs, tol_state = JAX_BOUND[family]
        assert_close(probs, p_b, tol_probs, f"{label} probs vs JAX")
        assert_close(state.h, s_b.h, tol_state, f"{label} h vs JAX")
        scale = max(1.0, float(np.abs(np.asarray(s_b.c)).max()))
        assert_close(state.c / scale, np.asarray(s_b.c) / scale, tol_state, f"{label} c vs JAX")
        if state.context is not None:
            np.testing.assert_array_equal(state.context.numpy(), np.asarray(s_b.context))


@pytest.mark.parametrize("n_chunks", [1, 2, 9])
@pytest.mark.parametrize("family", ["v5", "v5_8k"])
def test_v5_context_after_the_scan_is_the_loops(params, family, n_chunks):
    """The carried context is the audio: after a scan of K chunks it is the
    last chunk's tail, bit for bit the loop's, written into the state's own
    buffer; a scan from a carried context continues as the loop does."""
    runner = TR.StreamRunner(family, params[family][1], device="cpu")
    chunks = _slab(family, "noise", seed=11, n_chunks=2 * n_chunks)
    state = runner.init_state(BATCH)
    buffer = state.context
    runner.scan(chunks[:, :n_chunks], state)
    probs, _ = runner.scan(chunks[:, n_chunks:], state)
    want_probs, want = _steps(runner, chunks)
    assert state.context is buffer
    assert torch.equal(state.context, torch.from_numpy(chunks[:, -1, -buffer.shape[1]:]))
    _assert_state_bits(state, want, f"{family} K={n_chunks}")
    assert_close(probs, want_probs[:, n_chunks:], 1e-5, f"{family} K={n_chunks} probs")


@pytest.mark.parametrize("cut", [slab.SCAN_PIECE_CHUNKS, 5])
@pytest.mark.parametrize("family", FAMILIES)
def test_a_scan_cut_into_two_calls_gives_the_bits_of_one(params, family, cut):
    """16 chunks in one scan against two scans from the carried state. Cut
    at a piece's edge, every piece and so every output is the one call's
    bit for bit; cut elsewhere the state and the context still are, and the
    decoder's frame mean, over other row counts, rounds within 1e-7
    (measured 6.0e-8, v5_8k)."""
    runner = TR.StreamRunner(family, params[family][1], device="cpu")
    chunks = _slab(family, seed=5, n_chunks=16)
    one = runner.init_state(BATCH)
    whole, _ = runner.scan(chunks, one)
    two = runner.init_state(BATCH)
    parts = torch.cat([runner.scan(chunks[:, :cut], two)[0], runner.scan(chunks[:, cut:], two)[0]],
                      dim=1)
    _assert_state_bits(two, one, f"{family} cut at {cut}")
    if cut % slab.SCAN_PIECE_CHUNKS == 0:
        assert torch.equal(parts, whole)
    else:
        assert_close(parts, whole, 1e-7, f"{family} cut at {cut}")


@pytest.mark.parametrize("family", FAMILIES)
def test_pieces_of_the_encoder_and_a_short_last_piece(params, family, monkeypatch):
    """The encoder runs over ceil(K / SCAN_PIECE_CHUNKS) pieces of whole
    chunks of every stream, the last one short where K is no multiple; on
    the CPU the pieces' size changes no bit of the result."""
    tp = params[family][1]
    module = TR.get_family_module(family)
    chunks = torch.from_numpy(_slab(family, seed=7))
    h, c = module.init_state(BATCH)
    extra = (module.init_context(BATCH),) if family.startswith("v5") else ()
    rows = []
    encode_slab = slab.encode_slab

    def counting(encode, audio):
        def piece(x):
            rows.append(x.shape[0])
            return encode(x)

        return encode_slab(piece, audio)

    monkeypatch.setattr(slab, "encode_slab", counting)
    want = module.forward_scan(tp, chunks, h, c, *extra)
    assert rows == [BATCH * 8, BATCH * 3]
    for piece in (1, 3, CHUNKS):
        rows.clear()
        monkeypatch.setattr(slab, "SCAN_PIECE_CHUNKS", piece)
        got = module.forward_scan(tp, chunks, h, c, *extra)
        assert len(rows) == -(-CHUNKS // piece) and sum(rows) == BATCH * CHUNKS
        for g, w in zip(got, want):
            assert torch.equal(g, w), f"{family}: pieces of {piece}"


@pytest.mark.parametrize("tier", TIERS)
@pytest.mark.parametrize("family", FAMILIES)
def test_forward_scan_equals_its_plain_version(params, family, tier):
    """forward_scan (the kernels' wrappers, which take their plain versions
    on a CPU tensor, over pieces) against forward_scan_reference (the JAX
    package's `_scan_tblock` in the plain ops, the encoder over every chunk
    at once) from a carried state: within 1e-6 (measured: equal)."""
    tp = params[family][1]
    module = TR.get_family_module(family)
    chunks = torch.from_numpy(_slab(family, "noise", seed=9))
    rng = np.random.default_rng(9)
    h, c = (torch.from_numpy((0.5 * rng.normal(size=t.shape)).astype(np.float32))
            for t in module.init_state(BATCH))
    extra = ()
    if family.startswith("v5"):  # a carried context: another chunk's tail
        tail = _slab(family, "noise", seed=10, n_chunks=1)[:, 0, -module.CONTEXT_SAMPLES:]
        extra = (torch.from_numpy(tail.copy()),)
    got = module.forward_scan(tp, chunks, h, c, *extra, tier=tier)
    want = module.forward_scan_reference(tp, chunks, h, c, *extra, tier=tier)
    assert len(got) == len(want) == 3 + len(extra)
    for name, g, w in zip(("probs", "h", "c", "context"), got, want):
        assert_close(g, w, 1e-6, f"{family} {tier} {name}")


def _save_model(family: str, tp_archive_dir) -> str:
    """A model path the API takes: the bundled v4 archives, a synthetic v5
    archive written to the directory."""
    from vadc_tpu_torch.models.synthetic import (
        random_v5_8k_archive, random_v5_archive, save_archive,
    )

    if family.startswith("v4"):
        name = "silero_v4_16k.testtensor" if family == "v4" else "silero_v4_8k.testtensor"
        return str(DATA / name)
    path = tp_archive_dir / f"{family}.testtensor"
    save_archive(path, random_v5_archive(0) if family == "v5" else random_v5_8k_archive(1))
    return str(path)


@pytest.mark.parametrize("family", FAMILIES)
def test_api_speech_probabilities_is_the_loop_of_steps(params, family, tmp_path):
    """api.speech_probabilities on the CPU (one stream, every chunk in one
    scan, the last chunk zero-padded) against the loop of StreamRunner.step
    over the same chunks: within 1e-5 (measured at most 6.0e-8)."""
    from vadc_tpu_torch import api

    model = _save_model(family, tmp_path)
    window = SAMPLES[family]
    samples = speech(19, window, seed=12).ravel()[: 19 * window - window // 3]
    got = api.speech_probabilities(samples, model=model, sequence_count=window, device="cpu")
    assert got.shape == (19,)
    padded = np.zeros(19 * window, np.float32)
    padded[: len(samples)] = samples
    want, _ = _steps(TR.StreamRunner(family, params[family][1], device="cpu"),
                     padded.reshape(1, 19, window))
    assert_close(got, want[0], 1e-5, f"{family} api")


def test_batch_cli_v4_lines_equal_the_streaming_cli_per_file(tmp_path, capsys, monkeypatch):
    """The batch CLI with the bundled v4 archive over three seeded files of
    unequal length (slabs of 4 chunks: several scans a file, the last one
    short) prints, for each file, the lines of the streaming CLI on that
    file alone."""
    from vadc_tpu_torch.cli import batch
    from vadc_tpu_torch.cli import main as cli

    model = str(DATA / "silero_v4_16k.testtensor")
    paths = []
    for i, seconds in enumerate((6.2, 9.0, 4.1)):
        n = int(seconds * 16000)
        audio = speech(n // 1536 + 1, seed=60 + i).ravel()[:n]
        path = tmp_path / f"f{i}.s16le"
        np.clip(audio * 32768, -32768, 32767).astype("<i2").tofile(path)
        paths.append(str(path))
    assert batch.main([*paths, "--model", model, "--slab_chunks", "4", "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) >= 3
    for path in paths:
        with open(path, "rb") as f:
            monkeypatch.setattr(sys, "stdin", io.TextIOWrapper(f))
            assert cli.main(["--model", model, "--device", "cpu"]) == 0
        streamed = capsys.readouterr().out.split()
        assert streamed, path
        assert [ln.split("\t")[1] for ln in lines if ln.startswith(path + "\t")] == streamed, path
