"""What the spectrum kernels read and how they are launched, on the CPU: the
packed bases of the five families against the split bases and against the
JAX package's packing of the same archive, the wrappers' cache of them, the
stft_magnitude launch plan (streams a block, rows a pass, shared memory),
and the geometries the kernels refuse.

The kernels themselves run only on the card (tests/test_torch_cuda.py and
chip_smoke.py).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tests.torch_port_util import DATA
from tests.torch_port_util import to_torch as _t
from vadc_tpu.io.testtensor import load_testtensor
from vadc_tpu_torch.kernels import stft_dotmag as KD
from vadc_tpu_torch.kernels import stft_mag as KS
from vadc_tpu_torch.models.synthetic import random_v5_8k_archive, random_v5_archive
from vadc_tpu_torch.models.weights import load_params_from_tensors

# family -> (archive, hop of its STFT)
FAMILIES = {
    "v3": (lambda: load_testtensor(DATA / "silero_v31_16k.testtensor"), 64),
    "v4": (lambda: load_testtensor(DATA / "silero_v4_16k.testtensor"), 64),
    "v4_8k": (lambda: load_testtensor(DATA / "silero_v4_8k.testtensor"), 64),
    "v5": (lambda: random_v5_archive(0), 128),
    "v5_8k": (lambda: random_v5_8k_archive(1), 64),
}
SMEM_LIMIT = 232_448  # a block's shared memory on an H100


@pytest.fixture(scope="module")
def family_params():
    return {name: load_params_from_tensors(make())[1] for name, (make, _) in FAMILIES.items()}


@pytest.mark.parametrize("family", list(FAMILIES))
def test_padded_basis_is_the_split_basis_padded(family_params, family):
    """[n_fft, 2, bins_ld]: the split bases, zeros after them, rows of a
    multiple of 16 bytes on a 16-byte aligned base; the same numbers as the
    JAX package's packing for its Pallas kernel."""
    import vadc_tpu.kernels.stft_mag as JS

    params = family_params[family]
    wr, wi = KS.split_basis_of(params)
    n_fft, cutoff = wr.shape
    basis = KS.padded_basis_of(params)
    ld = KD.bins_ld(cutoff)
    assert (n_fft, cutoff, ld) in ((256, 129, 132), (128, 65, 68))
    assert basis.shape == (n_fft, 2, ld) and basis.is_contiguous()
    assert KS.padded_basis_of(params) is basis
    assert torch.equal(basis[:, 0, :cutoff], wr) and torch.equal(basis[:, 1, :cutoff], wi)
    assert not basis[:, :, cutoff:].any()
    assert basis.data_ptr() % 16 == 0 and (ld * 4) % 16 == 0
    assert torch.equal(basis, KD.padded_basis(wr, wi))
    hop = FAMILIES[family][1]
    packed = np.asarray(JS.prepack_basis(jnp.asarray(params["stft_basis"].numpy()), hop))
    col_pad = packed.shape[2] // 2
    taps = packed.reshape(n_fft, 2 * col_pad)  # [n_fft / hop, hop, .] -> tap-major
    assert torch.equal(basis[:, 0, :cutoff], _t(taps[:, :cutoff]))
    assert torch.equal(basis[:, 1, :cutoff], _t(taps[:, col_pad:col_pad + cutoff]))


def test_packed_basis_is_built_once_per_pair_of_tensors(family_params):
    wr, wi = KS.split_basis_of(family_params["v4"])
    wr, wi = wr.clone(), wi.clone()
    first = KD.packed_basis(wr, wi)
    assert KD.packed_basis(wr, wi) is first
    assert KD.packed_basis(wr, wi.clone()) is not first  # another pair
    wr.mul_(2.0)  # written in place: packed anew
    again = KD.packed_basis(wr, wi)
    assert again is not first and torch.equal(again[:, 0, :129], wr)


# (label, batch, frames, hop, n_fft, cutoff, streams a block expected)
PLANS = [
    ("v4 step", 2048, 24, 64, 256, 129, 2),
    ("v4 CLI window", 96, 24, 64, 256, 129, 1),
    ("v4 ragged", 37, 24, 64, 256, 129, 1),
    ("v4_8k step", 2048, 12, 64, 256, 129, 4),
    ("v5 step", 2048, 4, 128, 256, 129, None),
    ("v5_8k step", 2048, 4, 64, 128, 65, None),
    ("v3.1 geometry", 2048, 25, 64, 256, 129, None),
    ("one stream", 1, 24, 64, 256, 129, 1),
]


@pytest.mark.parametrize("label,batch,frames,hop,n_fft,cutoff,expect", PLANS,
                         ids=[p[0] for p in PLANS])
def test_launch_plan(label, batch, frames, hop, n_fft, cutoff, expect):
    """Streams a block within the batch; their chunks, the bases' ring and
    a pass's magnitudes within a block's shared memory (within half an SM's
    when a block owns more than one stream); no plan with fewer busy-SM
    passes."""
    streams, smem = KS.launch_plan(batch, frames, hop, n_fft, cutoff, 132)
    if expect is not None:
        assert streams == expect
    assert 1 <= streams <= batch
    stream = 4 * KS.staged_floats(frames, hop, n_fft)
    rows_pass = KD.ROWS_PASS[(n_fft, cutoff)]
    ring = 4 * (KS.STAGES * KS.SLICE_TAPS * 2 * KD.bins_ld(cutoff) + rows_pass * cutoff)
    assert smem == ring + streams * stream <= SMEM_LIMIT
    if streams > 1:
        assert smem <= KS.SMEM_TWO_BLOCKS

    def cost(s):
        return -(-(-(-batch // s)) // 132) * -(-(s * frames) // rows_pass)

    fits = [s for s in range(1, batch + 1) if ring + s * stream <= KS.SMEM_TWO_BLOCKS or s == 1]
    assert cost(streams) == min(cost(s) for s in fits)


@pytest.mark.parametrize("frames,hop,n_fft", [(24, 64, 256), (4, 128, 256), (4, 64, 128),
                                              (25, 64, 256), (12, 64, 256)])
def test_staged_chunk_covers_the_frames_and_keeps_the_skew(frames, hop, n_fft):
    """A stream's staged floats hold the skewed padded samples its frames
    read, and the next stream starts where a further frame of this one
    would fall modulo the 32 banks."""
    staged = (frames - 1) * hop + n_fft
    ld = KS.staged_floats(frames, hop, n_fft)
    assert ld >= staged + (staged - 1) // hop + 1
    assert (ld - frames * (hop + 1)) % 32 == 0


# (samples, n_fft, cutoff, pad_left, pad_right, hop, message of the refusal)
REFUSED = [
    (96, 256, 129, 96, 96, 64, "reflect pads"),
    (64, 256, 129, 0, 32, 64, "shorter than one"),
    (1536, 256, 129, 96, 90, 64, "must divide"),
    (1536, 256, 129, 96, 96, 96, "must divide"),
    (1536, 256, 128, 96, 96, 64, "no kernel"),
    (1536, 512, 257, 96, 96, 64, "no kernel"),
    (1536, 256, 129, 96, 96, 16, "multiple of 32"),
]


@pytest.mark.parametrize("samples,n_fft,cutoff,pad_left,pad_right,hop,message", REFUSED)
def test_stft_magnitude_refuses_what_the_kernel_does_not_take(samples, n_fft, cutoff, pad_left,
                                                             pad_right, hop, message):
    with pytest.raises(ValueError, match=message):
        KS.check_call_geometry(samples, n_fft, cutoff, pad_left, pad_right, hop)


@pytest.mark.parametrize("samples,pad_left,pad_right,hop,n_fft,cutoff",
                         [(1536, 96, 96, 64, 256, 129), (768, 96, 96, 64, 256, 129),
                          (576, 0, 64, 128, 256, 129), (288, 0, 32, 64, 128, 65),
                          (1536, 128, 128, 64, 256, 129)])
def test_stft_magnitude_takes_every_geometry_of_the_families(samples, pad_left, pad_right, hop,
                                                             n_fft, cutoff):
    KS.check_call_geometry(samples, n_fft, cutoff, pad_left, pad_right, hop)
    KD.check_geometry("dot_magnitude", n_fft, cutoff)
