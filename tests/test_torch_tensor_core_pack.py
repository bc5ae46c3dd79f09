"""What the bf16 tiers' tensor-core instances read, on the CPU: the spectrum
bases packed as bf16 hi and lo planes for bf16_3x (stft_dotmag.padded_basis)
and the v3.1 encoder's product weights packed as mma.sync B fragments
(silero_v31_fused2d.pack_fragments), each unpacked here with numpy and held
to nn/precision.py's operands (hi = bf16(w), lo = bf16(w - hi)), their
padding zero; the faithful packings byte for byte what they were; and the
launch plans and geometry checks of the new instances.

The kernels themselves run only on the card (tests/test_torch_cuda.py and
chip_smoke.py).
"""

import numpy as np
import pytest
import torch

from tests.torch_port_util import DATA
from vadc_tpu.io.testtensor import load_testtensor
from vadc_tpu_torch.kernels import silero_v31_fused as KF
from vadc_tpu_torch.kernels import silero_v31_fused2d as K2
from vadc_tpu_torch.kernels import stft_dotmag as KD
from vadc_tpu_torch.kernels import stft_mag as KS
from vadc_tpu_torch.models.synthetic import random_v5_8k_archive, random_v5_archive
from vadc_tpu_torch.models.weights import load_params_from_tensors
from vadc_tpu_torch.nn.precision import TIERS

FAMILIES = {
    "v3": lambda: load_testtensor(DATA / "silero_v31_16k.testtensor"),
    "v4": lambda: load_testtensor(DATA / "silero_v4_16k.testtensor"),
    "v4_8k": lambda: load_testtensor(DATA / "silero_v4_8k.testtensor"),
    "v5": lambda: random_v5_archive(0),
    "v5_8k": lambda: random_v5_8k_archive(1),
}
MODES = ("bf16", "bf16_3x")  # the products' modes of the bf16 tiers
SMEM_LIMIT = 232_448  # a block's shared memory on an H100


@pytest.fixture(scope="module")
def family_params():
    return {name: load_params_from_tensors(make())[1] for name, make in FAMILIES.items()}


def _np_bf16(x: np.ndarray) -> np.ndarray:
    """fp32 -> bf16 -> fp32, nearest even (finite inputs), in numpy."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32).astype(np.uint64)
    bits = (bits + 0x7FFF + ((bits >> 16) & 1)) & 0xFFFF0000
    return bits.astype(np.uint32).view(np.float32)


def _np_split(x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    hi = _np_bf16(x)
    return hi, _np_bf16((x - hi).astype(np.float32))


def _bf16_values(bits: np.ndarray) -> np.ndarray:
    """16-bit bf16 patterns (any integer dtype) as fp32 values."""
    return (bits.astype(np.uint32) << 16).view(np.float32)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_padded_basis_at_bf16_3x_is_the_split_bases(family_params, family):
    """[n_fft, LDB] bf16: each tap's row is hi of the real bins, zeros to
    whole n8 tiles, hi of the imaginary bins, zeros, the same of lo, then 8
    zeros; rows of whole 16 bytes."""
    wr, wi = KS.split_basis_of(family_params[family])
    n_fft, cutoff = wr.shape
    basis = KS.padded_basis_of(family_params[family], "bf16_3x")
    assert KS.padded_basis_of(family_params[family], "bf16_3x") is basis
    width = KD.bins_pad(cutoff)
    assert width == {129: 136, 65: 72}[cutoff] and width % 8 == 0
    ld = KD.mma_ld(cutoff)
    assert ld == 4 * width + 8 and (2 * ld) % 16 == 0
    assert basis.dtype == torch.bfloat16 and basis.shape == (n_fft, ld) and basis.is_contiguous()
    values = _bf16_values(basis.view(torch.int16).numpy().view(np.uint16))
    (wr_hi, wr_lo), (wi_hi, wi_lo) = _np_split(wr.numpy()), _np_split(wi.numpy())
    expect = np.zeros((n_fft, ld), np.float32)
    for i, plane in enumerate((wr_hi, wi_hi, wr_lo, wi_lo)):
        expect[:, i * width:i * width + cutoff] = plane
    np.testing.assert_array_equal(values, expect)
    # the padding (bins past the cutoff, the last 8 values) is zero
    used = np.zeros(ld, bool)
    for i in range(4):
        used[i * width:i * width + cutoff] = True
    assert not values[:, ~used].any()


@pytest.mark.parametrize("mode", ["fp32", "bf16"])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_padded_basis_of_the_cuda_core_tile_is_what_it_was(family_params, family, mode):
    """The bases of the CUDA-core instances (fp32, and bf16, which stays
    there), built here with numpy as that tile reads them ([n_fft, 2, bins
    padded to 4], fp32; bf16(w) at bf16), byte for byte."""
    wr, wi = KS.split_basis_of(family_params[family])
    n_fft, cutoff = wr.shape
    expect = np.zeros((n_fft, 2, -(-cutoff // 4) * 4), np.float32)
    for i, w in enumerate((wr.numpy(), wi.numpy())):
        expect[:, i, :cutoff] = w if mode == "fp32" else _np_bf16(w)
    got = KS.padded_basis_of(family_params[family], mode)
    assert got.dtype == torch.float32
    assert got.numpy().tobytes() == expect.tobytes()


def _unpack_fragments(words: np.ndarray, k: int, n: int, mode: str) -> tuple[np.ndarray, ...]:
    """pack_fragments' words back to [Kp, N] planes (hi, and lo at bf16_3x),
    by the mma.sync B fragment's layout: lane l = 4g + t holds rows 16 kb +
    2t (+ 8) and + 1 of column 8j + g, the lower row in the lower half."""
    kp = -(-k // 16) * 16
    per_lane = 4 if mode == "bf16_3x" else 2
    w = words.view(np.uint32).reshape(n // 8, kp // 16, 32, per_lane)
    planes = []
    for p in range(per_lane // 2):
        out = np.full((kp, n), np.nan, np.float32)
        for lane in range(32):
            g, t = divmod(lane, 4)
            for e in range(2):
                word = w[:, :, lane, 2 * p + e]  # [N / 8, Kp / 16]
                rows = 16 * np.arange(kp // 16) + 2 * t + 8 * e
                cols = 8 * np.arange(n // 8) + g
                out[rows[None, :], cols[:, None]] = _bf16_values(word & 0xFFFF)
                out[rows[None, :] + 1, cols[:, None]] = _bf16_values(word >> 16)
        planes.append(out)
    return tuple(planes)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("k,n", [(129, 16), (16, 48), (32, 96), (64, 192), (24, 8)])
def test_pack_fragments_gives_the_split_weights(mode, k, n):
    """Every (k, n) of the weight lands once in its fragment word, as hi (and
    lo) of nn/precision.py; the rows past K are zero."""
    wt = torch.from_numpy(np.random.default_rng(k * n).normal(size=(k, n)).astype(np.float32))
    packed = K2.pack_fragments(wt, mode)
    kp = -(-k // 16) * 16
    per_lane = 4 if mode == "bf16_3x" else 2  # words a lane of a fragment block
    assert packed.dtype == torch.float32 and packed.numel() == per_lane * kp * n // 4
    planes = _unpack_fragments(packed.numpy().copy(), k, n, mode)
    hi, lo = _np_split(wt.numpy())
    want = (hi,) if mode == "bf16" else (hi, lo)
    for got, w in zip(planes, want):
        assert not np.isnan(got).any()
        np.testing.assert_array_equal(got[:k], w)
        assert not got[k:].any()


def test_pack_fragments_refuses_columns_that_are_no_n8_tiles():
    with pytest.raises(ValueError, match="n8 tiles"):
        K2.pack_fragments(torch.zeros(16, 12), "bf16")


def _slots(packed):
    """slot name -> the packed tensor's words (the offsets' order)."""
    names = [f"{name}@{st}" for st in range(4) for name in K2._STAGE_SLOTS] + list(K2._TAIL_SLOTS)
    buf = packed.buffer.numpy()
    starts = [int(o) for o in packed.offsets]
    ordered = sorted(o for o in starts if o >= 0) + [buf.size]
    out = {}
    for name, start in zip(names, starts):
        if start < 0:
            continue
        end = ordered[ordered.index(start) + 1]
        out[name] = buf[start:end]
    return out


@pytest.mark.parametrize("tier", ["balanced", "fast", "turbo"])
def test_packed_weights_at_a_tier_hold_fragments_of_the_split_products(family_params, tier):
    """The encoder's seven products of each stage as fragments of the tier's
    operands, K padded with zero rows; each LSTM layer at balanced and fast
    as its gate fragments (kernels/lstm.gate_fragments, which
    tests/test_torch_lstm_mma.py unpacks), at turbo and the decoder's
    weight packed as before (nn/precision.pack_operand); offsets 16-byte
    aligned."""
    from vadc_tpu_torch.kernels.lstm import gate_fragments
    from vadc_tpu_torch.nn.precision import pack_operand, tier_of

    t = tier_of(tier)
    params = family_params["v3"]
    packed = K2.PackedWeights(params, t)
    assert all(o % 4 == 0 for o in packed.offsets if o >= 0)
    slots = _slots(packed)
    for st, layer in enumerate(params["layers"]):
        for name in sorted(K2._FRAGMENTS):
            if name not in layer:
                assert f"{name}@{st}" not in slots
                continue
            wt = layer[name].T.contiguous()
            k, n = wt.shape
            words = slots[f"{name}@{st}"]
            size = (4 if t.products == "bf16_3x" else 2) * (-(-k // 16) * 16) * n // 4
            assert not words[size:].any()  # the alignment gap
            planes = _unpack_fragments(words[:size].copy(), k, n, t.products)
            hi, lo = _np_split(wt.numpy())
            for got, w in zip(planes, (hi, lo)):
                np.testing.assert_array_equal(got[:k], w)
                assert not got[k:].any()
    for layer, name in enumerate(("lstm_w0", "lstm_w1")):
        w = params["lstm_w"][layer : layer + 1]
        want = (gate_fragments(w, t.products) if tier != "turbo"
                else pack_operand(w[0].T.contiguous(), t.products)).reshape(-1).numpy()
        assert slots[name][:want.size].tobytes() == want.tobytes()
    want = pack_operand(params["dec_w"].contiguous(), t.products).reshape(-1).numpy()
    assert slots["dec_w"][:want.size].tobytes() == want.tobytes()


def test_packed_weights_at_faithful_are_what_they_were(family_params):
    """The faithful buffer, built here with numpy from the archive's tensors
    (transposed products, folded batch norm, every tensor on a 4-float
    boundary), byte for byte."""
    from vadc_tpu_torch.nn.functional import folded_batch_norm

    params = family_params["v3"]
    pieces, offsets, cursor = [], [], 0
    for layer in params["layers"]:
        ones = np.ones(layer["conv_b"].shape, np.float32)
        if "bn_w" in layer:
            scale, shift = (t.numpy() for t in folded_batch_norm(
                layer["bn_mean"], layer["bn_var"], layer["bn_w"], layer["bn_b"]))
        else:
            scale, shift = ones, 0 * ones
        for slot in K2._STAGE_SLOTS:
            if slot == "bn_scale":
                t = scale
            elif slot == "bn_shift":
                t = shift
            elif slot not in layer:
                offsets.append(-1)
                continue
            else:
                t = layer[slot].numpy()
                t = t.T if slot in K2._TRANSPOSED else t
            gap = -cursor % 4
            pieces += [np.zeros(gap, np.float32), np.ascontiguousarray(t, np.float32).reshape(-1)]
            cursor += gap
            offsets.append(cursor)
            cursor += t.size
    for t in (params["lstm_w"][0].T, params["lstm_w"][1].T, params["lstm_b"][0],
              params["lstm_b"][1], params["dec_w"], params["dec_b"]):
        t = t.numpy()
        gap = -cursor % 4
        pieces += [np.zeros(gap, np.float32), np.ascontiguousarray(t, np.float32).reshape(-1)]
        cursor += gap
        offsets.append(cursor)
        cursor += t.size
    packed = K2.pack_weights(params)
    assert list(packed.offsets) == offsets
    assert packed.buffer.numpy().tobytes() == np.concatenate(pieces).tobytes()
    # the products' weights, the LSTM's and the decoder's: the archive's bytes
    slots = _slots(packed)
    for st, layer in enumerate(params["layers"]):
        for name in K2._FRAGMENTS & set(layer):
            assert slots[f"{name}@{st}"][:layer[name].numel()].tobytes() == \
                layer[name].T.contiguous().numpy().tobytes()


@pytest.mark.parametrize("tier", list(TIERS))
def test_the_step_kernel_checks_the_bases_of_its_tier(family_params, tier):
    """forward_fused's arguments take the bases packed for the tier's STFT
    and refuse those of the other tile (on the CPU the check runs up to the
    device)."""
    from vadc_tpu_torch.nn.precision import tier_of

    t = tier_of(tier)
    params = family_params["v3"]
    audio = torch.zeros(2, 1536)
    packed = K2.pack_weights(params, t)
    other = "fp32" if t.stft == "bf16_3x" else "bf16_3x"
    with pytest.raises(ValueError, match="padded STFT basis"):
        KF._check("forward_fused", packed, audio, KS.padded_basis_of(params, other), t)
    # the tier's own bases pass the basis check and stop at the device
    with pytest.raises(ValueError, match="unsupported device"):
        KF._check("forward_fused", packed, audio, KS.padded_basis_of(params, t.stft), t)


# (label, batch, frames, hop, n_fft, cutoff): the family geometries and edges
MMA_PLANS = [
    ("v4 step", 2048, 24, 64, 256, 129), ("v4 CLI window", 96, 24, 64, 256, 129),
    ("v4 ragged", 37, 24, 64, 256, 129), ("v4_8k step", 2048, 12, 64, 256, 129),
    ("v5 step", 2048, 4, 128, 256, 129), ("v5_8k step", 2048, 4, 64, 128, 65),
    ("v5_8k ragged", 37, 4, 64, 128, 65), ("v3.1 geometry", 2048, 25, 64, 256, 129),
    ("v3.1 512", 37, 9, 64, 256, 129), ("one stream", 1, 24, 64, 256, 129),
]


@pytest.mark.parametrize("label,batch,frames,hop,n_fft,cutoff", MMA_PLANS,
                         ids=[p[0] for p in MMA_PLANS])
def test_launch_plan_of_the_tensor_core_instances(label, batch, frames, hop, n_fft, cutoff):
    """bf16_3x: 64 rows a pass; the ring of 16-tap bf16 slices, a pass's
    magnitudes and the streams' hi and lo planes within a block's shared
    memory (half an SM's when a block owns more than one stream); no plan
    with fewer busy-SM passes. The bf16 mode takes the fp32 tile's plan."""
    streams, smem = KS.launch_plan(batch, frames, hop, n_fft, cutoff, 132, "bf16_3x")
    assert 1 <= streams <= batch
    ring = 2 * KS.MMA_STAGES * KS.MMA_SLICE_TAPS * KD.mma_ld(cutoff) + 4 * 64 * cutoff
    stream = 4 * KS.staged_plane_ld(frames, hop, n_fft)
    assert smem == ring + streams * stream <= SMEM_LIMIT
    if streams > 1:
        assert smem <= KS.SMEM_TWO_BLOCKS

    def cost(s):
        return -(-(-(-batch // s)) // 132) * -(-(s * frames) // KS.MMA_ROWS_PASS)

    fits = [s for s in range(1, batch + 1) if ring + s * stream <= KS.SMEM_TWO_BLOCKS or s == 1]
    assert cost(streams) == min(cost(s) for s in fits)
    assert (KS.launch_plan(batch, frames, hop, n_fft, cutoff, 132, "bf16")
            == KS.launch_plan(batch, frames, hop, n_fft, cutoff, 132))


@pytest.mark.parametrize("frames,hop,n_fft", [(24, 64, 256), (4, 128, 256), (4, 64, 128),
                                              (25, 64, 256), (12, 64, 256), (9, 64, 256)])
def test_staged_plane_covers_the_frames_and_keeps_the_skew(frames, hop, n_fft):
    """A stream's bf16 plane holds its skewed padded samples in whole 16
    bytes, and the next stream starts where a further frame of this one
    would fall modulo 128 bytes: the rows of an ldmatrix stay in 8 distinct
    16-byte bank groups across the streams."""
    staged = (frames - 1) * hop + n_fft
    ld = KS.staged_plane_ld(frames, hop, n_fft)
    assert ld % 8 == 0 and ld >= staged + (staged - 1) // hop * 8
    assert (ld - frames * (hop + 8)) % 64 == 0
    starts = [(s * ld + f * (hop + 8)) * 2 for s in range(3) for f in range(frames)]
    for i in range(len(starts) - 7):
        assert len({(a // 16) % 8 for a in starts[i:i + 8]}) == 8


def test_tensor_core_plans_refuse_what_the_kernels_do_not_take():
    """An unknown mode, a geometry with no instance, and a chunk whose bf16
    planes do not fit one block are refused before any launch."""
    with pytest.raises(ValueError, match="unknown mode"):
        KS.launch_plan(2048, 24, 64, 256, 129, 132, "tf32")
    for n_fft, cutoff in ((256, 128), (512, 257), (128, 129)):
        with pytest.raises(ValueError, match="no kernel"):
            KS.check_call_geometry(1536, n_fft, cutoff, 96, 96, 64)
    with pytest.raises(ValueError, match="does not fit"):
        KS.launch_plan(1, 4000, 64, 256, 129, 132, "bf16_3x")
    with pytest.raises(ValueError, match="unknown mode"):
        KS.stft_magnitude(torch.zeros(2, 1536), torch.zeros(256, 129), torch.zeros(256, 129),
                          pad_left=96, pad_right=96, hop=64, mode="tf32")
