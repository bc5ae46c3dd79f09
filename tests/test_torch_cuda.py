"""The port's CUDA kernels against their plain versions on the card.

Marked `cuda`: each test skips without a card. On a machine with one (and
no JAX, which tests/conftest.py imports), run them with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Bounds as in chip_smoke.py: dot_magnitude 1e-5 of the largest magnitude;
the fused kernel 1e-5 on probabilities and 5e-5 on h and on c relative to
its largest value (the state passes 14 recurrent updates whose fp32 sums
the kernel takes in another order than cuBLAS).
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from vadc_tpu.io.synthaudio import utterance_track

pytestmark = pytest.mark.cuda

# This file imports nothing from tests/ (the card's machine may have another
# package named `tests` installed) and no JAX.
V31_ARCHIVE = Path(__file__).resolve().parent.parent / "vadc_tpu" / "data" / "silero_v31_16k.testtensor"


def speech(n_chunks: int, chunk: int = 1536, seed: int = 0) -> np.ndarray:
    track, _ = utterance_track(n_utterances=4, seed=seed)
    need = n_chunks * chunk
    return np.tile(track, -(-need // len(track)))[:need].reshape(n_chunks, chunk)


def noise(n_chunks: int, chunk: int = 1536, seed: int = 0) -> np.ndarray:
    return (0.1 * np.random.default_rng(seed).normal(size=(n_chunks, chunk))).astype(np.float32)


@pytest.fixture(scope="module")
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from vadc_tpu_torch.runtime import require_cuda

    return require_cuda()


@pytest.fixture(scope="module")
def params(device):
    from vadc_tpu_torch.models.weights import load_params

    return load_params(V31_ARCHIVE, device=device)[1]


def _max_abs(a, b) -> float:
    return float((a.double() - b.double()).abs().max())


@pytest.mark.parametrize("batch,chunk", [(64, 1536), (37, 1536), (16, 512)])
def test_dot_magnitude_kernel_matches_plain(params, device, batch, chunk):
    from vadc_tpu_torch.kernels import stft_dotmag as KD
    from vadc_tpu_torch.nn import functional as F

    audio = torch.from_numpy(speech(batch, chunk=chunk, seed=batch)).to(device)
    frames = F.frame(F.reflect_pad_last(audio, 128, 128), 256, 64)
    wr, wi = KD.split_basis(params["stft_basis"])
    before = KD.dot_magnitude.launches
    got = KD.dot_magnitude(frames, wr, wi)
    want = KD.dot_magnitude_reference(frames, wr, wi)
    torch.cuda.synchronize()
    assert KD.dot_magnitude.launches == before + 1
    assert got.shape == (batch, chunk // 64 + 1, 129)
    assert _max_abs(got, want) <= 1e-5 * float(want.abs().max())


@pytest.mark.parametrize("batch,chunk", [(64, 1536), (37, 1536), (1, 1536), (16, 512)])
def test_fused_kernel_matches_plain(params, device, batch, chunk):
    from vadc_tpu_torch.kernels import silero_v31_fused2d as K2
    from vadc_tpu_torch.models import silero_v31 as TM

    feats = TM.features(params, torch.from_numpy(speech(batch, chunk=chunk, seed=1)).to(device))
    h = torch.from_numpy(0.5 * noise(2 * batch, chunk=64, seed=2)).reshape(2, batch, 64).to(device)
    c = torch.from_numpy(5 * noise(2 * batch, chunk=64, seed=3)).reshape(2, batch, 64).to(device)
    before = K2.forward_fused2d.launches
    probs, hn, cn = K2.forward_fused2d(params, feats, h, c)
    p_ref, h_ref, c_ref = K2.forward_fused2d_reference(params, feats, h, c)
    torch.cuda.synchronize()
    assert K2.forward_fused2d.launches == before + 1
    assert _max_abs(probs, p_ref) <= 1e-5
    assert _max_abs(hn, h_ref) <= 5e-5
    assert _max_abs(cn, c_ref) <= 5e-5 * max(1.0, float(c_ref.abs().max()))


def test_state_in_place_and_the_runner_on_the_card(params, device):
    """hn/cn may be h/c; the stream runner on the card matches the plain
    path on the CPU and goes through both kernels."""
    from vadc_tpu_torch.engine.runner import StreamRunner
    from vadc_tpu_torch.kernels.silero_v31_fused2d import forward_fused2d
    from vadc_tpu_torch.kernels.stft_dotmag import dot_magnitude

    chunks = speech(32 * 3, seed=4).reshape(32, 3, -1)
    gpu = StreamRunner("v3", params, device=device)
    cpu = StreamRunner("v3", params, device="cpu")
    dot_magnitude.launches = forward_fused2d.launches = 0
    state = gpu.init_state(32)
    p_gpu, st = gpu.scan(chunks, state)
    torch.cuda.synchronize()
    assert st is state
    assert dot_magnitude.launches == 3 and forward_fused2d.launches == 3
    p_cpu, st_cpu = cpu.scan(chunks, cpu.init_state(32))
    assert _max_abs(p_gpu.cpu(), p_cpu) <= 1e-4
    assert _max_abs(st.h.cpu(), st_cpu.h) <= 1e-4
    assert np.isfinite(p_gpu.cpu().numpy()).all()
