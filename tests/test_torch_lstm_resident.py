"""The resident-weights variant of the port's recurrent kernels, on the CPU.

The CUDA kernels run only on the card (chip_smoke.py holds the two variants
to each other bit for bit there). Here the ORDER the resident variant
computes in is held as plain PyTorch, `lstm_hoisted_reference`: per layer
the input gate sums of all frames first (x . rows 0..H-1 of the transposed
weight), then the recurrence from them (+ h . rows H..2H-1, + bias). The same
numpy-seeded inputs go through it, through nn.functional.lstm, and through
vadc_tpu.kernels.lstm's `lstm_fused` / `lstm_decoder_fused` in Pallas
interpret mode, at the v4 shape (H=64, L=2) and the v5 shape (H=128, L=1).

Bounds: 1e-5 on y, h and probs, 1e-5 of its largest value on c (all fp32;
the three differ in the order of each gate's sum of 2H products; measured:
y 1.4e-6, h 1.5e-6, c 3.4e-6 of its largest value, probs 4.8e-7). The
variant rule is held to PERF.md's kernel table, and the wrappers' routing,
scratch size and C signatures are checked without a card.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tests.conftest import assert_close
from tests.torch_port_util import single_torch_thread  # noqa: F401
from tests.torch_port_util import to_torch as _t
from vadc_tpu.kernels import lstm as JK
from vadc_tpu_torch.kernels import _build
from vadc_tpu_torch.kernels import lstm as KL
from vadc_tpu_torch.kernels import lstm_decoder as KD
from vadc_tpu_torch.nn import functional as F

TOL = 1e-5
SHAPES = {"v4 (H=64, L=2)": (64, 2), "v5 (H=128, L=1)": (128, 1)}


def _inputs(hidden: int, layers: int, batch: int, frames: int, chunks: int | None = None):
    """Seeded numpy inputs: x, a carried state, the fused weight and bias."""
    rng = np.random.default_rng(1000 * hidden + 100 * batch + frames + (chunks or 0))
    shape = (batch, frames, hidden) if chunks is None else (batch, chunks, frames, hidden)
    x = (1.5 * rng.normal(size=shape)).astype(np.float32)
    h = (0.3 * rng.normal(size=(layers, batch, hidden))).astype(np.float32)
    c = (1.0 * rng.normal(size=(layers, batch, hidden))).astype(np.float32)
    w = (0.15 * rng.normal(size=(layers, 4 * hidden, 2 * hidden))).astype(np.float32)
    b = (0.1 * rng.normal(size=(layers, 4 * hidden))).astype(np.float32)
    return x, h, c, w, b


def _hold(got, want, label: str) -> None:
    """y (or probs) and h within TOL; c within TOL of its largest value."""
    for name, g, r in zip(("y", "hn", "cn"), got, want):
        g, r = np.asarray(g), np.asarray(r)
        assert g.shape == r.shape, f"{label} {name}: {g.shape} vs {r.shape}"
        scale = max(1.0, float(np.abs(r).max())) if name == "cn" else 1.0
        assert_close(g / scale, r / scale, TOL, f"{label} {name}")


@pytest.mark.parametrize("frames", [3, 7, 96])
@pytest.mark.parametrize("batch", [1, 37])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_hoisted_order_matches_the_plain_lstm(shape, batch, frames):
    x, h, c, w, b = (_t(a) for a in _inputs(*SHAPES[shape], batch, frames))
    got = KL.lstm_hoisted_reference(x, h, c, w, b)
    want = F.lstm(x, h, c, w, b)
    _hold(got, want, f"{shape} B={batch} T={frames} vs nn.functional.lstm")
    assert torch.equal(KL.lstm_fused_reference(x, h, c, w, b)[0], want[0])


@pytest.mark.parametrize("frames", [3, 7, 96])
@pytest.mark.parametrize("batch", [1, 37])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_hoisted_order_matches_the_jax_kernel(shape, batch, frames):
    """vadc_tpu's lstm_fused in Pallas interpret mode, one block of streams."""
    x, h, c, w, b = _inputs(*SHAPES[shape], batch, frames)
    want = JK.lstm_fused(*(jnp.asarray(a) for a in (x, h, c, w, b)), block_streams=batch)
    got = KL.lstm_hoisted_reference(*(_t(a) for a in (x, h, c, w, b)))
    _hold(got, want, f"{shape} B={batch} T={frames} vs vadc_tpu lstm_fused")


@pytest.mark.parametrize("chunks", [1, 5])
@pytest.mark.parametrize("frames", [3, 7])
@pytest.mark.parametrize("batch", [1, 37])
def test_hoisted_order_with_the_decoder_matches_the_jax_kernel(batch, frames, chunks):
    """The K chunks' frames as one hoisted sequence, then the v3 decoder per
    chunk, against vadc_tpu's lstm_decoder_fused chunk by chunk with the
    state carried, and against the port's plain version."""
    x, h, c, w, b = _inputs(64, 2, batch, frames, chunks)
    rng = np.random.default_rng(7)
    dec_w = (0.3 * rng.normal(size=(2, 64))).astype(np.float32)
    dec_b = (0.1 * rng.normal(size=(2,))).astype(np.float32)
    y, hn, cn = KL.lstm_hoisted_reference(
        _t(x).reshape(batch, chunks * frames, 64), _t(h), _t(c), _t(w), _t(b))
    probs = torch.stack(
        [F.decoder_v3_nlc(y[:, k * frames : (k + 1) * frames], _t(dec_w), _t(dec_b))
         for k in range(chunks)], dim=1)
    hj, cj, pj = jnp.asarray(h), jnp.asarray(c), []
    for k in range(chunks):
        p, hj, cj = JK.lstm_decoder_fused(
            jnp.asarray(x[:, k]), hj, cj, *(jnp.asarray(a) for a in (w, b, dec_w, dec_b)),
            block_streams=batch)
        pj.append(np.asarray(p))
    label = f"B={batch} K={chunks} T={frames}"
    _hold((probs, hn, cn), (np.stack(pj, axis=1), hj, cj), f"{label} vs vadc_tpu")
    plain = KD.lstm_decoder_fused_reference(
        _t(x), _t(h), _t(c), _t(w), _t(b), _t(dec_w), _t(dec_b))
    _hold((probs, hn, cn), plain, f"{label} vs the plain version")


def test_hoisted_order_uses_the_kernels_weight_slices():
    """Rows 0..H-1 of the transposed weight multiply x, rows H..2H-1 the
    recurrent h, gate order i, f, g, o: one step by hand."""
    x, h, c, w, b = (_t(a) for a in _inputs(64, 2, 2, 1))
    wt = KL.transpose_weight(w)
    gates = x[:, 0] @ wt[0, :64] + h[0] @ wt[0, 64:] + b[0]
    i, f, g, o = gates.chunk(4, dim=-1)
    c0 = torch.sigmoid(f) * c[0] + torch.sigmoid(i) * F.accurate_tanh(g)
    h0 = torch.sigmoid(o) * F.accurate_tanh(c0)
    _, hn, cn = KL.lstm_hoisted_reference(x, h, c, w, b)
    assert torch.equal(hn[0], h0) and torch.equal(cn[0], c0)


# Every shape of PERF.md's kernel table (section 6) and the variant it says
# the wrapper runs there: (batch, steps a stream) -> resident?
_TABLE = {
    "lstm_decoder_fused B=1 x K=96 x T=7 (CLI window)": (1, 96 * 7, True),
    "lstm_decoder_fused B=64 x K=64 x T=7 (corpus slab)": (64, 64 * 7, True),
    "lstm_decoder_fused B=2048 x K=8 x T=7": (2048, 8 * 7, True),
    "lstm_decoder_fused B=2048 x K=1 x T=7": (2048, 7, True),
    "lstm_decoder_fused B=37 x K=5 x T=3": (37, 15, True),
    "lstm_decoder_fused B=37 x K=1 x T=3 (512-sample chunks)": (37, 3, True),
    "lstm_fused v4 B=1 x T=288 (CLI window)": (1, 288, True),
    "lstm_fused v5 B=1 x T=96 (CLI window)": (1, 96, True),
    "lstm_fused v4 B=2048 x T=3 (step)": (2048, 3, True),
    "lstm_fused v4 8 kHz B=2048 x T=3 (step, 768 samples)": (2048, 3, True),
    "lstm_fused v4 B=2048 x T=1 (step, 512 samples)": (2048, 1, False),
    "lstm_fused v5 B=2048 x T=1 (step)": (2048, 1, False),
    "lstm_fused v5 B=1 x T=1 (one chunk)": (1, 1, False),
    "lstm_fused v5 B=64 x T=2 (below the crossover)": (64, 2, False),
}


@pytest.mark.parametrize("case", sorted(_TABLE))
def test_variant_rule_matches_the_kernel_table(case):
    batch, steps, resident = _TABLE[case]
    assert KL.use_resident(batch, steps) is resident


def test_variant_rule_is_a_function_of_the_shapes_alone():
    import inspect

    assert list(inspect.signature(KL.use_resident).parameters) == ["batch", "steps"]
    # monotone in the steps at every batch: one crossover
    for batch in (1, 64, 2048):
        picks = [KL.use_resident(batch, steps) for steps in range(1, 400)]
        assert picks == sorted(picks)


@pytest.mark.parametrize("batch,steps,unit,rows", [
    (1, 672, 7, 672),            # the CLI's window: every row
    (64, 448, 7, 64 * 448),      # a corpus slab: every row
    (2048, 56, 7, 2048 * 56),    # 2048 x 8 chunks: 117 MB, every row
    (4096, 448, 7, 262144),      # more than the limit: 256 MiB of rows
    (70000, 14, 7, 70000 * 7),   # one chunk of every stream at least
])
def test_scratch_rows(batch, steps, unit, rows):
    """The resident variant's scratch: all rows up to PRE_BYTES_MAX, never
    fewer than one unit of every stream (shapes on the 'meta' device)."""
    x = torch.empty(1, 1, 64, device="meta")
    pre = KL.pre_scratch(x, batch, steps, unit)
    assert pre.shape == (rows, 256) and pre.dtype == torch.float32
    assert pre.shape[0] >= batch * unit
    assert pre.shape[0] * 1024 <= max(KL.PRE_BYTES_MAX, batch * unit * 1024)


def test_both_variants_have_declared_c_signatures():
    """ctypes cuts a pointer passed without argtypes: each entry point of
    the two recurrent kernels is declared, with as many arguments as its C
    definition takes: lstm_fused's two variants (the resident one adds the
    scratch, its rows and the count of kernels launched) and
    lstm_decoder_fused's one, the resident kernels (its streaming entry is
    gone with its kernel)."""
    import re

    sig = _build._SIGNATURES
    assert len(sig["vadc_lstm_fused_resident"]) == len(sig["vadc_lstm_fused"]) + 3
    assert "vadc_lstm_decoder_fused" not in sig
    sources = {p.name for p in _build.sources()} | {p.name for p in _build.headers()}
    assert {"lstm.cu", "lstm_decoder.cu", "lstm_resident.cuh", "lstm_cell.cuh",
            "lstm_mma.cuh"} <= sources
    text = "".join(p.read_text() for p in _build.sources())
    assert 'extern "C" int vadc_lstm_decoder_fused(' not in text
    for name in ("vadc_lstm_fused", "vadc_lstm_fused_resident", "vadc_lstm_decoder_fused_resident"):
        found = re.search(rf'extern "C" int {name}\(([^)]*)\)', text)
        assert found, name
        assert found.group(1).count(",") + 1 == len(sig[name]), name


@pytest.mark.parametrize("steps", [1, 96])
def test_a_cpu_tensor_takes_the_plain_version_at_any_length(steps):
    """The variant rule is the card's: on the CPU both wrappers run their
    plain versions whatever the length, build nothing and count nothing."""
    KL.lstm_fused.launches = KD.lstm_decoder_fused.launches = 0
    x, h, c, w, b = (_t(a) for a in _inputs(64, 2, 2, steps))
    got = KL.lstm_fused(x, h, c, w, b)
    want = KL.lstm_fused_reference(x, h, c, w, b)
    assert all(torch.equal(a, r) for a, r in zip(got, want))
    dec_w, dec_b = torch.ones(2, 64), torch.zeros(2)
    got = KD.lstm_decoder_fused(x, h, c, w, b, dec_w, dec_b)
    want = KD.lstm_decoder_fused_reference(x, h, c, w, b, dec_w, dec_b)
    assert all(torch.equal(a, r) for a, r in zip(got, want))
    assert KL.lstm_fused.launches == 0 and KD.lstm_decoder_fused.launches == 0
    assert _build._lib is None


@pytest.mark.parametrize("steps", [1, 96])
def test_a_device_without_a_kernel_raises_for_both_variants(steps):
    """A tensor that is not on the CPU goes to the kernel's checks whichever
    variant its length names; 'meta' has no kernel and raises."""
    m = lambda *s: torch.empty(*s, device="meta")  # noqa: E731
    with pytest.raises(ValueError, match="unsupported device"):
        KL.lstm_fused(m(2, steps, 64), m(2, 2, 64), m(2, 2, 64), m(2, 256, 128), m(2, 256))
    with pytest.raises(ValueError, match="unsupported device"):
        KD.lstm_decoder_fused(m(2, steps, 7, 64), m(2, 2, 64), m(2, 2, 64), m(2, 256, 128),
                              m(2, 256), m(2, 64), m(2))
