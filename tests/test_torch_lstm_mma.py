"""The bf16 tiers' LSTM gate sums on the tensor cores, on the CPU.

The CUDA kernels run only on the card (chip_smoke.py holds them there to
their plain versions by kernels/tier_check.py and to each other bit for
bit). Here, at small sizes, each case for every bf16 tier and both hidden
sizes (v4's H=64, L=2 and v5's H=128, L=1):

  * the weight packing: `lstm.gate_fragments` unpacked with numpy gives
    nn/precision.py's operands (hi = bf16(w), lo = bf16(w - hi)) at every
    gate row in the kernels' order (tile m, row r: gate r // 4 of unit 4m +
    r % 4), every weight exactly once; the fused kernels' packed buffer
    holds each layer's fragments in its LSTM slot, zeros in the alignment
    gap; the faithful packing is byte for byte what it was (the transposed
    fp32 weight);
  * the kernels' order as plain PyTorch, `lstm.lstm_mma_reference` (each
    k16 step's product from zero, added to the fp32 sum in k order, the
    input steps, then the recurrent ones, then the bias), held within
    tier_check's `lstm_fused` limits to nn.functional.lstm at the tier
    (measured at most 1.4e-3 on y, 6e-4 on h and c at v5's fast), and to
    the JAX package's nn.functional.lstm under `precision_mode(tier)` over
    one step from a carried state. On the CPU the JAX package's products
    are fp32 at every tier (XLA drops the precision there), so the inputs
    are operands every bf16 tier leaves exact (x, h0 and w rounded to
    bf16): its layer-0 products are then the port's, and what remains is
    the order of the sums and, at v4's layer 1, the port's rounding (fast,
    turbo) or split (balanced) of the new h (measured 6.8e-4 on y at fast);
  * the decoder path: the kernels' order with the v3 decoder over one
    chunk against lstm_decoder_fused_reference at the tier, within
    tier_check's `lstm` limits, and over K chunks the bits of K single
    chunks with the state carried;
  * the launch plans of the new instances: the streams a block takes (the
    fewest that leave no more blocks than SMs, at most the 8 of an n8
    tile) and each kernel's shared memory, at or under the 232,448 bytes a
    block may use (and static shared memory under 48 KB).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tests.torch_port_util import single_torch_thread  # noqa: F401
from vadc_tpu.nn import functional as JF
from vadc_tpu_torch.kernels import lstm as KL
from vadc_tpu_torch.kernels import lstm_decoder as KD
from vadc_tpu_torch.kernels import silero_v31_fused2d as K2
from vadc_tpu_torch.kernels import tier_check
from vadc_tpu_torch.models.weights import DEFAULT_WEIGHTS, load_params
from vadc_tpu_torch.nn import functional as F
from vadc_tpu_torch.nn.precision import bf16, pack_operand, split, tier_of

TIERS = ("balanced", "fast", "turbo")
SHAPES = {"v4 (H=64, L=2)": (64, 2), "v5 (H=128, L=1)": (128, 1)}
H100_SMS = 132


def _inputs(hidden: int, layers: int, batch: int, frames: int, seed: int):
    """Seeded numpy inputs: x, a carried state, the fused weight and bias."""
    rng = np.random.default_rng(seed)
    x = (1.5 * rng.normal(size=(batch, frames, hidden))).astype(np.float32)
    h = (0.3 * rng.normal(size=(layers, batch, hidden))).astype(np.float32)
    c = (1.0 * rng.normal(size=(layers, batch, hidden))).astype(np.float32)
    w = (0.15 * rng.normal(size=(layers, 4 * hidden, 2 * hidden))).astype(np.float32)
    b = (0.1 * rng.normal(size=(layers, 4 * hidden))).astype(np.float32)
    return x, h, c, w, b


def _unpack(words: np.ndarray, hidden: int) -> np.ndarray:
    """gate_fragments' words [L, planes, H/4, 2H/16, 32, 4] back to the
    planes [L, planes, 4H, 2H] as fp32, counting how often each weight is
    written (each exactly once)."""
    layers, planes = words.shape[:2]
    out = np.zeros((layers, planes, 4 * hidden, 2 * hidden), np.float32)
    seen = np.zeros(out.shape, np.int32)
    lane = np.arange(32)
    g, t = lane // 4, lane % 4
    rows_of = np.stack([g, g + 8, g, g + 8], -1)  # [32, 4]
    cols_of = np.stack([2 * t, 2 * t, 2 * t + 8, 2 * t + 8], -1)
    w = words.astype(np.uint32)
    low = (w << 16).view(np.float32)
    high = (w & 0xFFFF0000).view(np.float32)
    for m in range(hidden // 4):
        r = rows_of
        gate_row = (r // 4) * hidden + 4 * m + r % 4
        for ks in range(2 * hidden // 16):
            col = 16 * ks + cols_of
            for lo_hi, vals in ((0, low), (1, high)):
                out[:, :, gate_row, col + lo_hi] = vals[:, :, m, ks]
                seen[:, :, gate_row, col + lo_hi] += 1
    assert (seen == 1).all()
    return out


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("tier", TIERS)
def test_gate_fragments_unpack_to_the_tier_operands(tier, shape):
    hidden, layers = SHAPES[shape]
    t = tier_of(tier)
    w = torch.from_numpy(_inputs(hidden, layers, 1, 1, 3)[3])
    frags = KL.gate_fragments(w, t.products)
    assert frags.dtype == torch.float32 and frags._vadc_products == t.products
    assert tuple(frags.shape) == KL.weight_shape(layers, hidden, t)
    planes = _unpack(frags.view(torch.int32).numpy(), hidden)
    want = [bf16(w)] if t.products == "bf16" else list(split(w))
    assert planes.shape[1] == len(want)
    for got, plane in zip(planes.transpose(1, 0, 2, 3), want):
        np.testing.assert_array_equal(got, plane.numpy())


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_faithful_packing_is_what_it_was(shape):
    """The faithful instances read the transposed fp32 weight, byte for
    byte, and weight_of gives it at faithful (the bf16 tiers' fragments
    otherwise, fast and turbo the same)."""
    hidden, layers = SHAPES[shape]
    w = torch.from_numpy(_inputs(hidden, layers, 1, 1, 4)[3])
    wt = KL.kernel_weight(w, tier_of("faithful"))
    assert wt.numpy().tobytes() == np.ascontiguousarray(w.numpy().transpose(0, 2, 1)).tobytes()
    assert wt._vadc_products == "fp32"
    assert tuple(wt.shape) == KL.weight_shape(layers, hidden, tier_of("faithful"))


@pytest.fixture(scope="module")
def v31_params():
    return load_params(DEFAULT_WEIGHTS, device="cpu")[1]


@pytest.mark.parametrize("tier", ("faithful", *TIERS))
def test_packed_buffer_holds_the_gate_fragments(v31_params, tier):
    """The fused kernels' LSTM slots: each layer as lstm_decoder_fused reads
    it (the step kernels' LSTM and it give each other's bits): at faithful
    the transposed weight as before, at balanced and fast its gate
    fragments, at turbo (whose v3.1 LSTM keeps the CUDA-core chains) the
    transposed weight as bf16 operands; zeros up to the next slot; the
    weight_of cache gives the same bytes."""
    t = tier_of(tier)
    packed = K2.PackedWeights(v31_params, t)
    buf = packed.buffer.numpy()
    names = [f"{s}@{st}" for st in range(4) for s in K2._STAGE_SLOTS] + list(K2._TAIL_SLOTS)
    offsets = dict(zip(names, packed.offsets))
    following = {"lstm_w0": "lstm_w1", "lstm_w1": "lstm_b0"}
    whole = KD.weight_of(v31_params, t).numpy()
    for layer, name in enumerate(("lstm_w0", "lstm_w1")):
        w = v31_params["lstm_w"][layer : layer + 1]
        if tier in ("balanced", "fast"):
            want = KL.gate_fragments(w, t.products)
        else:
            want = pack_operand(w[0].T.contiguous(), t.products)
        want = want.numpy().reshape(-1)
        start, end = offsets[name], offsets[following[name]]
        assert buf[start : start + want.size].tobytes() == want.tobytes()
        assert not buf[start + want.size : end].any()
        assert whole[layer].reshape(-1).tobytes() == want.tobytes()


@pytest.mark.parametrize("tier", ("faithful", *TIERS))
def test_which_lstms_sum_on_the_tensor_cores(tier):
    """lstm_fused at every bf16 tier (fast and turbo reading the same
    fragments); the v3.1 LSTM at balanced and fast, the same rule as the
    CUDA sources' (csrc/lstm_mma.cuh: v31_gates_on_mma)."""
    t = tier_of(tier)
    w = torch.from_numpy(_inputs(64, 2, 1, 1, 9)[3])
    on_mma = KL.weight_shape(2, 64, t) != (2, 128, 256)
    assert on_mma == (tier != "faithful")
    assert KL.v31_gates_on_mma(t) == (tier in ("balanced", "fast"))
    got = KD.kernel_weight(w, t)
    assert tuple(got.shape) == KL.weight_shape(2, 64, t, KL.v31_gates_on_mma(t))
    if tier == "turbo":
        assert torch.equal(KL.kernel_weight(w, t), KL.kernel_weight(w, tier_of("fast")))
    source = (K2._build.CSRC / "lstm_mma.cuh").read_text()
    assert "return T == TIER_BALANCED || T == TIER_FAST;" in source


@pytest.mark.parametrize("frames", [3, 12])
@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("tier", TIERS)
def test_mma_order_matches_the_plain_lstm(tier, shape, frames):
    hidden, layers = SHAPES[shape]
    t = tier_of(tier)
    x, h, c, w, b = (torch.from_numpy(a) for a in _inputs(hidden, layers, 37, frames, 5))
    got = KL.lstm_mma_reference(x, h, c, w, b, t)
    want = F.lstm(x, h, c, w, b, t)
    errs = _errs(got, want, tier)
    assert not tier_check.breaches(tier, "lstm_fused", 37, errs), errs
    # at faithful the order is the hoisted one
    assert all(torch.equal(a, r) for a, r in zip(
        KL.lstm_mma_reference(x, h, c, w, b), KL.lstm_hoisted_reference(x, h, c, w, b)))


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("tier", TIERS)
def test_mma_order_matches_the_jax_lstm(tier, shape):
    hidden, layers = SHAPES[shape]
    t = tier_of(tier)
    x, h, c, w, b = (torch.from_numpy(a) for a in _inputs(hidden, layers, 37, 1, 6))
    x, h, w = bf16(x), bf16(h), bf16(w)  # operands every bf16 tier leaves exact
    got = KL.lstm_mma_reference(x, h, c, w, b, t)
    with JF.precision_mode(tier):
        want = JF.lstm(*(jnp.asarray(a.numpy()) for a in (x, h, c, w, b)))
    errs = _errs(got, [torch.from_numpy(np.array(a)) for a in want], tier)
    assert not tier_check.breaches(tier, "lstm_fused", 37, errs), errs


def _decoded(x, h, c, w, b, dec_w, dec_b, tier, chunks: int, frames: int):
    """The K chunks' frames as one sequence in the kernels' order, then the
    v3 decoder per chunk: (probs [B, K], hn, cn)."""
    y, hn, cn = KL.lstm_mma_reference(x, h, c, w, b, tier)
    probs = torch.stack([F.decoder_v3_nlc(y[:, k * frames : (k + 1) * frames], dec_w, dec_b, tier)
                         for k in range(chunks)], dim=1)
    return probs, hn, cn


def _decoder_inputs(frames: int):
    x, h, c, w, b = (torch.from_numpy(a) for a in _inputs(64, 2, 37, frames, 7))
    rng = np.random.default_rng(8)
    dec_w = torch.from_numpy((0.3 * rng.normal(size=(2, 64))).astype(np.float32))
    dec_b = torch.from_numpy((0.1 * rng.normal(size=(2,))).astype(np.float32))
    return x, h, c, w, b, dec_w, dec_b


@pytest.mark.parametrize("frames", [3, 7])
@pytest.mark.parametrize("tier", TIERS)
def test_mma_order_with_the_decoder_matches_the_plain_version(tier, frames):
    """One chunk (the v3.1 step's function: 3 to 7 frames) in the kernels'
    order with the v3 decoder against lstm_decoder_fused_reference at the
    tier, within tier_check's limits of lstm_decoder_fused. Over more
    frames a bf16 rounding flip (tier_check) can reach the probabilities,
    in the k order of the CUDA-core chains as in the kernels' order."""
    t = tier_of(tier)
    x, h, c, w, b, dec_w, dec_b = _decoder_inputs(frames)
    got = _decoded(x, h, c, w, b, dec_w, dec_b, t, 1, frames)
    want = KD.lstm_decoder_fused_reference(x, h, c, w, b, dec_w, dec_b, t)
    errs = tier_check.state_errors((got[0][:, 0], got[1], got[2]), want, tier)
    assert not tier_check.breaches(tier, "lstm_decoder_fused", 37, errs), errs


@pytest.mark.parametrize("tier", TIERS)
def test_mma_order_over_chunks_is_the_chunks_one_by_one(tier):
    """K chunks in one sequence give the bits of K single chunks with the
    state carried, in the kernels' order as in the kernel."""
    t = tier_of(tier)
    x, h, c, w, b, dec_w, dec_b = _decoder_inputs(4 * 3)
    probs, hn, cn = _decoded(x, h, c, w, b, dec_w, dec_b, t, 4, 3)
    hk, ck = h, c
    for k in range(4):
        p, hk, ck = _decoded(x[:, 3 * k : 3 * k + 3], hk, ck, w, b, dec_w, dec_b, t, 1, 3)
        assert torch.equal(p[:, 0], probs[:, k])
    assert torch.equal(hk, hn) and torch.equal(ck, cn)


def _errs(got, want, tier: str) -> dict:
    """tier_check's errors of (y, h, c), c relative to max(1, its largest)."""
    scale = max(1.0, float(want[2].abs().max()))
    return {name: tier_check.errors(g, r, tier, scale if name == "c" else 1.0)
            for name, g, r in zip(("y", "h", "c"), got, want)}


@pytest.mark.parametrize("batch", [1, 37, 132, 133, 301, 1056, 2048])
@pytest.mark.parametrize("steps", [1, 3, 288])
@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("tier", TIERS)
def test_launch_plan(tier, shape, steps, batch):
    hidden, layers = SHAPES[shape]
    plan = KL.mma_plan(batch, steps, hidden, layers, tier, H100_SMS)
    resident = KL.use_resident(batch, steps)
    assert [k["kernel"] for k in plan] == (
        ["input_gates_mma_kernel", "wavefront_mma_kernel" if hidden == 64 else "cluster_mma_kernel"]
        if resident else ["lstm_mma_kernel"])
    for k in plan:
        assert k["static_smem"] <= KL.STATIC_SMEM
        assert k["static_smem"] + k["dynamic_smem"] <= KL.SMEM_PER_BLOCK
        assert k["threads"] % 32 == 0 and k["threads"] <= 1024
        if k["streams"] is None:
            continue
        nb = k["streams"]
        assert 1 <= nb <= KL.MMA_MAX_STREAMS
        groups = k["blocks"] // (2 if k["kernel"] == "cluster_mma_kernel" else 1)
        assert groups * nb >= batch > (groups - 1) * nb  # every stream, no empty block
        # the fewest streams a block that leave no more blocks than SMs
        assert nb == KL.MMA_MAX_STREAMS or groups <= H100_SMS
        assert nb == 1 or -(-batch // (nb - 1)) > H100_SMS
    # balanced keeps its lo fragments in shared memory, the bf16 tiers none
    if resident:
        assert plan[-1]["dynamic_smem"] == ((98304 if hidden == 64 else 65536)
                                            if tier == "balanced" else 0)


def test_launch_plan_refuses_faithful():
    with pytest.raises(ValueError, match="faithful"):
        KL.mma_plan(64, 3, 64, 2, "faithful", H100_SMS)
