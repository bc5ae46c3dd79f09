"""The port's CUDA kernels against their plain versions on the card.

Marked `cuda`: each test skips without a card. On a machine with one (and
no JAX, which tests/conftest.py imports), run them with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Bounds as in chip_smoke.py: dot_magnitude and stft_magnitude 1e-5 of the
largest magnitude (and stft_magnitude bit-equal to dot_magnitude on the
reflect-padded unfold, as the two share one spectrum code); the fused kernel 1e-5
on probabilities and 5e-5 on h and on c relative to its largest value (the
state passes 14 recurrent updates whose fp32 sums the kernel takes in
another order than cuBLAS); lstm_fused 5e-5 on y, h and c (c relative),
for the same reason; forward_fused, which also takes its own spectrum,
the whole-model bounds 1e-4 on probabilities and 3e-4 on h and c (c
relative), and its spectrum bit-equal to dot_magnitude's;
lstm_decoder_fused the fused kernel's bounds, equal bit for bit to K single
calls and, on encode_fused's output, to the fused kernel. The two variants
of lstm_fused (streaming and resident weights), launched explicitly, equal
each other and the wrapper's call bit for bit, and lstm_decoder_fused's one
entry, launched explicitly in one pass and in several at every tier, its
wrapper's call.
The bf16 tiers' instances are held to their plain versions at the tier by
vadc_tpu_torch/kernels/tier_check.py (which says why they are not
bit-equal); at every tier stft_magnitude equals dot_magnitude's instance
of the same operands, and the two lstm_fused variants equal each other.
A server checkpoint saved on the card restores on the CPU and the other
way round with the state bit for bit (the next tick within the
whole-model bounds), and the Python API on the card gives the CPU's
probabilities within 1e-4 and its segments. The two probes of
tools/tpu_check.py on tensor cores (kernels/probes.py): bf16_dot (mma.sync)
and bf16_dot_wgmma give 6.0 exactly at the probe's inputs and agree with
their plain version within 1e-5 (and with each other) at seeded shapes,
concat_dot within 1e-3 of fp32 at the probe's inputs and 1e-5 of bf16_3x
at seeded shapes, among them shapes whose strides TMA cannot take (the
kernels' threads copy those operands); the staging rule of
kernels/probes.py is the C entries'. The segmenter's FSM kernel
(kernels/fsm.py: fsm_scan) gives segment_batch's events and state bit for
bit, on probabilities at the thresholds and on strided views, and
BatchSegmenter on the card the scalar Segmenter's segments. v5's convs
(kernels/v5_convs.py: v5_convs) against the plain chain at every tier and
both widths (the bounds beside those tests), a chunk's bits the same
whatever rows share its launch, one launch a piece of the v5 scans, and
the v5 slab scan against the loop of steps within tier_check's bounds.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from vadc_tpu.io.synthaudio import utterance_track

pytestmark = pytest.mark.cuda

# This file imports nothing from tests/ (the card's machine may have another
# package named `tests` installed) and no JAX.
DATA = Path(__file__).resolve().parent.parent / "vadc_tpu" / "data"
V31_ARCHIVE = DATA / "silero_v31_16k.testtensor"


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
    path on the CPU. Its scan is the slab route (one launch of
    encode_fused_audio for the whole slab, and the two of
    lstm_decoder_fused's resident variant: its pre-pass and its recurrent
    kernel; none of dot_magnitude or encode_fused, the route's front half
    until encode_fused_audio took it); its step goes through the whole-step
    kernel alone, and gives the slab's bits."""
    from vadc_tpu_torch.engine.runner import StreamRunner
    from vadc_tpu_torch.kernels.lstm_decoder import lstm_decoder_fused
    from vadc_tpu_torch.kernels.silero_v31_fused import encode_fused_audio, forward_fused
    from vadc_tpu_torch.kernels.silero_v31_fused2d import encode_fused, forward_fused2d
    from vadc_tpu_torch.kernels.stft_dotmag import dot_magnitude

    counted = (encode_fused_audio, lstm_decoder_fused, forward_fused, forward_fused2d,
               dot_magnitude, encode_fused)
    chunks = speech(32 * 3, seed=4).reshape(32, 3, -1)
    gpu = StreamRunner("v3", params, device=device)
    cpu = StreamRunner("v3", params, device="cpu")
    for fn in counted:
        fn.launches = 0
    state = gpu.init_state(32)
    p_gpu, st = gpu.scan(chunks, state)
    torch.cuda.synchronize()
    assert st is state
    assert [fn.launches for fn in counted] == [1, 2, 0, 0, 0, 0]
    p_cpu, st_cpu = cpu.scan(chunks, cpu.init_state(32))
    assert _max_abs(p_gpu.cpu(), p_cpu) <= 1e-4
    assert _max_abs(st.h.cpu(), st_cpu.h) <= 1e-4
    assert np.isfinite(p_gpu.cpu().numpy()).all()
    for fn in counted:
        fn.launches = 0
    steps = gpu.init_state(32)
    for t in range(3):
        p_t, steps = gpu.step(chunks[:, t], steps)
        assert torch.equal(p_t, p_gpu[:, t])
    torch.cuda.synchronize()
    assert [fn.launches for fn in counted] == [0, 0, 3, 0, 0, 0]
    assert torch.equal(steps.h, st.h) and torch.equal(steps.c, st.c)


@pytest.mark.parametrize("batch,chunk", [(64, 1536), (37, 1536), (1, 1536), (16, 512),
                                         (5, 768), (9, 1024), (12, 1280)])
def test_encode_fused_audio_kernel_matches_plain(params, device, batch, chunk):
    """The step kernel's front-end and encoder alone against its plain
    version (5e-4 absolute on activations of up to about 7, chip_smoke.py's
    TOL_ENCODE_AUDIO: the spectra are summed in other orders and
    log1p(2^20 x) amplifies that at near-zero bins), counted once, a strided batch equal to its contiguous copy; and
    lstm_decoder_fused on its rows equal to forward_fused bit for bit."""
    from vadc_tpu_torch.kernels import lstm_decoder as KD
    from vadc_tpu_torch.kernels import silero_v31_fused as KF

    audio = torch.from_numpy(speech(batch * 2, chunk=chunk, seed=40)).to(device)
    audio = audio.reshape(batch, 2, chunk)[:, 1]  # rows strided, as a slab's column
    h = torch.from_numpy(0.5 * noise(2 * batch, chunk=64, seed=41)).reshape(2, batch, 64).to(device)
    c = torch.from_numpy(5 * noise(2 * batch, chunk=64, seed=42)).reshape(2, batch, 64).to(device)
    before = KF.encode_fused_audio.launches
    enc = KF.encode_fused_audio(params, audio)
    ref = KF.encode_fused_audio_reference(params, audio)
    torch.cuda.synchronize()
    assert KF.encode_fused_audio.launches == before + 1
    assert enc.shape == ref.shape == (batch, (chunk // 64 + 1 + 3) // 4, 64)
    assert bool(torch.isfinite(enc).all())
    assert _max_abs(enc, ref) <= 5e-4
    assert torch.equal(enc, KF.encode_fused_audio(params, audio.contiguous()))
    want = KF.forward_fused(params, audio, h, c)
    got = KD.lstm_decoder_fused(enc[:, None], h, c, params["lstm_w"], params["lstm_b"],
                                params["dec_w"], params["dec_b"])
    torch.cuda.synchronize()
    assert torch.equal(got[0][:, 0], want[0])
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])


@pytest.mark.parametrize("streams,chunks,chunk", [(37, 5, 1536), (1, 24, 1536), (64, 3, 512)])
def test_slab_scan_is_the_loop_of_steps_bit_for_bit(params, device, streams, chunks, chunk):
    """StreamRunner.scan (encode_fused_audio over all the slab's chunks, then
    lstm_decoder_fused) against the loop of StreamRunner.step (forward_fused)
    from the same carried state: the same bits, probabilities and state."""
    from vadc_tpu_torch.engine.runner import StreamRunner

    slab = torch.from_numpy(speech(streams * chunks, chunk=chunk, seed=50)).to(device)
    slab = slab.reshape(streams, chunks, chunk)
    runner = StreamRunner("v3", params, device=device)
    warm = runner.init_state(streams)
    runner.step(slab[:, 0], warm)  # a carried state, not zeros
    by_slab, by_steps = runner.init_state(streams), runner.init_state(streams)
    for st in (by_slab, by_steps):
        st.h.copy_(warm.h)
        st.c.copy_(warm.c)
    p_slab, by_slab = runner.scan(slab, by_slab)
    p_steps = []
    for k in range(chunks):
        p_k, by_steps = runner.step(slab[:, k], by_steps)
        p_steps.append(p_k.clone())
    torch.cuda.synchronize()
    assert torch.equal(torch.stack(p_steps, dim=1), p_slab)
    assert torch.equal(by_steps.h, by_slab.h) and torch.equal(by_steps.c, by_slab.c)


def test_encode_fused_audio_refuses_on_the_card(params, device):
    from vadc_tpu_torch.kernels import silero_v31_fused as KF

    for samples in (256, 1000, 1792):
        with pytest.raises(ValueError, match="multiple of 256"):
            KF.encode_fused_audio(params, torch.zeros(2, samples, device=device))
    with pytest.raises(TypeError, match="float32"):
        KF.encode_fused_audio(params, torch.zeros(2, 1536, device=device, dtype=torch.float64))
    with pytest.raises(ValueError, match="unit-stride"):
        KF.encode_fused_audio(params, torch.zeros(1536, 2, device=device).T)


def _lstm_decoder_inputs(params, device, batch, chunks, samples, seed):
    from vadc_tpu_torch.kernels import silero_v31_fused2d as K2
    from vadc_tpu_torch.models import silero_v31 as TM

    audio = torch.from_numpy(speech(batch * chunks, chunk=samples, seed=seed)).to(device)
    feats = TM.features(params, audio)
    enc = K2.encode_fused(params, feats)
    h = torch.from_numpy(0.5 * noise(2 * batch, chunk=64, seed=seed + 1)).reshape(2, batch, 64)
    c = torch.from_numpy(5 * noise(2 * batch, chunk=64, seed=seed + 2)).reshape(2, batch, 64)
    return feats, enc, h.to(device), c.to(device)


@pytest.mark.parametrize("batch,chunks,samples", [(64, 1, 1536), (5, 3, 512), (37, 5, 1024),
                                                  (1, 24, 1536), (4, 4, 1280)])
def test_lstm_decoder_kernel_matches_plain(params, device, batch, chunks, samples):
    """lstm_decoder_fused on encode_fused's output against its plain
    version (probs 1e-5, h and c 5e-5, c relative to its largest value: fp32
    both, other orders of the gate sums), the K-chunk call against K single
    calls bit for bit, the state in place, and encode_fused against the
    plain encoder stages (1e-4, the faithful tier's per-op bound)."""
    from vadc_tpu_torch.kernels import lstm_decoder as KD
    from vadc_tpu_torch.kernels import silero_v31_fused2d as K2

    feats, enc, h, c = _lstm_decoder_inputs(params, device, batch, chunks, samples, seed=20)
    enc_ref = K2.encode_fused_reference(params, feats)
    assert enc.shape == (batch * chunks, K2.out_frames(samples // 64 + 1), 64)
    assert _max_abs(enc, enc_ref) <= 1e-4
    x = enc.reshape(batch, chunks, -1, 64)
    args = (params["lstm_w"], params["lstm_b"], params["dec_w"], params["dec_b"])
    before = KD.lstm_decoder_fused.launches
    probs, hn, cn = KD.lstm_decoder_fused(x, h, c, *args)
    p_ref, h_ref, c_ref = KD.lstm_decoder_fused_reference(x, h, c, *args)
    torch.cuda.synchronize()
    # three frames and more: the resident variant's pre-pass and recurrent kernel
    assert KD.lstm_decoder_fused.launches == before + 2
    assert probs.shape == (batch, chunks)
    assert _max_abs(probs, p_ref) <= 1e-5
    assert _max_abs(hn, h_ref) <= 5e-5
    assert _max_abs(cn, c_ref) <= 5e-5 * max(1.0, float(c_ref.abs().max()))
    hk, ck = h.clone(), c.clone()
    for k in range(chunks):
        p_k, h_out, c_out = KD.lstm_decoder_fused(x[:, k].contiguous(), hk, ck, *args, hn=hk, cn=ck)
        assert h_out is hk and c_out is ck and p_k.shape == (batch,)
        assert torch.equal(p_k, probs[:, k])
    torch.cuda.synchronize()
    assert torch.equal(hk, hn) and torch.equal(ck, cn)


@pytest.mark.parametrize("batch,samples", [(64, 1536), (37, 512), (1, 768)])
def test_encode_then_lstm_decoder_is_the_fused_kernel_bit_for_bit(params, device, batch, samples):
    from vadc_tpu_torch.kernels import lstm_decoder as KD
    from vadc_tpu_torch.kernels import silero_v31_fused2d as K2

    feats, enc, h, c = _lstm_decoder_inputs(params, device, batch, 1, samples, seed=30)
    want = K2.forward_fused2d(params, feats, h, c)
    got = KD.lstm_decoder_fused(enc, h, c, params["lstm_w"], params["lstm_b"], params["dec_w"],
                                params["dec_b"])
    torch.cuda.synchronize()
    assert got[0].shape == (batch,)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_lstm_decoder_refuses_what_it_does_not_take_on_the_card(params, device):
    from vadc_tpu_torch.kernels import lstm_decoder as KD

    args = (params["lstm_w"], params["lstm_b"], params["dec_w"], params["dec_b"])
    h = torch.zeros(2, 3, 64, device=device)
    with pytest.raises(ValueError, match="must be"):
        KD.lstm_decoder_fused(torch.zeros(3, 7, 32, device=device), h, h.clone(), *args)
    with pytest.raises(ValueError, match="contiguous"):
        KD.lstm_decoder_fused(torch.zeros(7, 3, 64, device=device).transpose(0, 1), h, h.clone(),
                              *args)
    with pytest.raises(TypeError, match="float32"):
        KD.lstm_decoder_fused(torch.zeros(3, 7, 64, device=device, dtype=torch.float16), h,
                              h.clone(), *args)
    with pytest.raises(ValueError, match="on cpu"):
        KD.lstm_decoder_fused(torch.zeros(3, 7, 64, device=device), h.cpu(), h.clone(), *args)


def test_batch_cli_on_the_card_equals_its_cpu_self(tmp_path, device, capsys):
    from vadc_tpu_torch.cli import batch

    paths = []
    for i, n_chunks in enumerate((70, 33, 5)):
        pcm = np.clip(speech(n_chunks, seed=40 + i).ravel()[: n_chunks * 1536 - 100 * i] * 32768,
                      -32768, 32767).astype("<i2")
        path = tmp_path / f"f{i}.s16le"
        pcm.tofile(path)
        paths.append(str(path))
    outs = []
    for dev in ("cuda", "cpu"):
        assert batch.main([*paths, "--device", dev, "--slab_chunks", "32",
                           "--cut_dir", str(tmp_path / dev)]) == 0
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1] and outs[0]
    for name in ("f0.s16le", "f1.s16le", "f2.s16le"):
        assert (tmp_path / "cuda" / name).read_bytes() == (tmp_path / "cpu" / name).read_bytes()


def test_batch_cli_back_to_back_reuses_the_pinned_block(tmp_path, device, capsys):
    """Two jobs in one process, the second on shorter files of the same
    slab shape: the second job's slab buffer is the first one's pinned
    block, which still holds its samples, and its lines and cut files are
    those of a fresh process."""
    import os
    import subprocess
    import sys

    from vadc_tpu_torch.cli import batch

    def corpus(name, lengths, seed):
        paths = []
        for i, n_chunks in enumerate(lengths):
            pcm = np.clip(speech(n_chunks, seed=seed + i).ravel()[: n_chunks * 1536 - 211 * i]
                          * 32768, -32768, 32767).astype("<i2")
            paths.append(str(tmp_path / f"{name}{i}.s16le"))
            pcm.tofile(paths[-1])
        return paths

    longer, shorter = corpus("long", (150, 120, 90, 61), 80), corpus("short", (145, 30, 9, 2), 90)
    argv = ["--slab_chunks", "16", "--device", device.type]
    root = Path(__file__).resolve().parent.parent
    fresh = subprocess.run([sys.executable, "-m", "vadc_tpu_torch.cli.batch", *shorter, *argv,
                            "--cut_dir", str(tmp_path / "fresh")], capture_output=True, text=True,
                           timeout=600, env=dict(os.environ, PYTHONPATH=str(root)), cwd=root)
    assert fresh.returncode == 0, fresh.stderr
    take, blocks = batch.slab_buffer, []

    def recorded(shape, pin):
        slabs = take(shape, pin)
        blocks.append((slabs.data_ptr(), slabs.is_pinned()))
        return slabs

    batch.slab_buffer = recorded
    try:
        assert batch.main([*longer, *argv]) == 0
        first = capsys.readouterr().out
        assert batch.main([*shorter, *argv, "--cut_dir", str(tmp_path / "after")]) == 0
        second = capsys.readouterr().out
    finally:
        batch.slab_buffer = take
    assert first and second == fresh.stdout and second
    assert blocks[0] == blocks[1] and blocks[0][1], blocks
    for name in os.listdir(tmp_path / "fresh"):
        assert (tmp_path / "after" / name).read_bytes() == (tmp_path / "fresh" / name).read_bytes()


FSM = dict(threshold=0.5, neg_threshold=0.35, min_silence_chunks=2, min_speech_chunks=3)


def fsm_probs(batch: int, n_cols: int, seed: int, edges: bool = True) -> np.ndarray:
    """Probabilities that dwell (runs of speech-like, silence-like and
    in-between levels), so segments open, close and get discarded; with
    `edges` about one entry in eight is exactly the fp32 threshold or
    neg_threshold, or one ulp either side of one."""
    rng = np.random.default_rng(seed)
    run = np.cumsum(rng.random((batch, n_cols)) < 0.25, axis=1)
    levels = rng.choice([0.05, 0.3, 0.42, 0.55, 0.9], size=(batch, n_cols + 1))
    out = np.take_along_axis(levels, run, 1) + 0.08 * rng.normal(size=(batch, n_cols))
    out = np.clip(out, 0, 1).astype(np.float32)
    if edges:
        at = np.float32([FSM["threshold"], FSM["neg_threshold"]])
        edge = np.concatenate([at, np.nextafter(at, np.float32(0)), np.nextafter(at, np.float32(1))])
        mask = rng.random((batch, n_cols)) < 0.125
        out[mask] = rng.choice(edge, size=int(mask.sum()))
    return out


FSM_SHAPES = [(n_cols, batch) for n_cols in (1, 7, 64) for batch in (1, 5, 512, 1000)]
FSM_LAYOUTS = ["transposed", "column_slice", "every_other"]


def fsm_case(n_cols: int, batch: int, with_valid: bool):
    """The inputs of test_fsm_scan_kernel_is_segment_batch_bit_for_bit:
    probabilities [batch, 2 * n_cols] (two slabs of n_cols) and
    valid_chunks (int32 [batch], or None), 0, inside either slab and past
    both among them. tests/test_torch_vectorized_segmenter.py holds the
    plain version to the JAX package's on the same inputs."""
    rng = np.random.default_rng(1000 * n_cols + batch)
    probs = fsm_probs(batch, 2 * n_cols, seed=batch + n_cols)
    valid = None
    if with_valid:
        valid = rng.integers(0, 2 * n_cols + 2, size=batch)
        valid[: min(batch, 3)] = [0, n_cols, 2 * n_cols + 5][: min(batch, 3)]
        valid = valid.astype(np.int32)
    return probs, valid


def fsm_view_case(layout: str):
    """The inputs of test_fsm_scan_kernel_on_views_that_are_not_contiguous:
    a [333, 120] grid, valid_chunks, and the view of the grid (a tensor on
    any device) that the kernel reads: a transposed [T, B] tensor, a column
    slice of the wider slab or every other column, 40 columns each."""
    batch, n_cols = 333, 40
    grid = fsm_probs(batch, 3 * n_cols, seed=7)
    valid = np.random.default_rng(8).integers(0, 50, batch).astype(np.int32)

    def view(t: torch.Tensor) -> torch.Tensor:
        if layout == "transposed":
            return t[:, :n_cols].t().contiguous().t()
        if layout == "column_slice":
            return t[:, 3 : 3 + n_cols]
        return t[:, ::2][:, :n_cols]

    return grid, valid, view


def segmenter_case():
    """The inputs of test_batch_segmenter_on_the_card_is_the_scalar_segmenter:
    probabilities [37, 200] and every stream's real chunk count."""
    batch, n_cols = 37, 200
    probs = fsm_probs(batch, n_cols, seed=11, edges=False)
    valid = np.random.default_rng(12).integers(0, n_cols + 1, batch)
    valid[:2] = [0, n_cols]
    return probs, valid


def _fsm_both(probs_slabs, valid, device):
    """The kernel and segment_batch on the card, and segment_batch on the
    CPU, over the same slabs in turn, the state carried: their events and
    states after each slab. The kernel leaves the state it was given as it
    was (a checkpoint may hold it), as segment_batch does."""
    from vadc_tpu_torch.kernels import fsm

    batch = probs_slabs[0].shape[0]
    ks = ts = fsm.init_fsm_state(batch, device)
    cs = fsm.init_fsm_state(batch)
    valid_cpu = None if valid is None else valid.cpu()
    out = []
    for probs in probs_slabs:
        launches = fsm.fsm_scan.launches
        given = [t.clone() for t in ks[:3]]
        held, (ks, events) = ks, fsm.fsm_scan(probs, ks, **FSM, valid_chunks=valid)
        assert fsm.fsm_scan.launches == launches + 1
        assert all(torch.equal(t, g) for t, g in zip(held[:3], given))
        ts, (closed, starts, ends) = fsm.segment_batch(probs, **FSM, state=ts, valid_chunks=valid)
        cs, cpu_events = fsm.segment_batch(probs.cpu(), **FSM, state=cs, valid_chunks=valid_cpu)
        out.append((ks, events, ts, torch.stack([closed.to(torch.int32), starts, ends]), cs,
                    torch.stack([cpu_events[0].to(torch.int32), *cpu_events[1:]])))
    torch.cuda.synchronize()
    return out


def _fsm_equal(out) -> int:
    """The kernel's events and state equal segment_batch's on the card and
    on the CPU bit for bit; the number of segments closed."""
    closes = 0
    for ks, events, ts, plain, cs, cpu_plain in out:
        assert events.dtype == torch.int32 and events.shape == plain.shape
        assert torch.equal(events, plain)
        assert torch.equal(events.cpu(), cpu_plain)
        assert ks.chunk_index == ts.chunk_index == cs.chunk_index
        for field in ("triggered", "speech_start", "temp_end"):
            assert getattr(ks, field).dtype == getattr(ts, field).dtype
            assert torch.equal(getattr(ks, field), getattr(ts, field)), field
            assert torch.equal(getattr(ks, field).cpu(), getattr(cs, field)), field
        closes += int(plain[0].sum())
    return closes


@pytest.mark.parametrize("with_valid", [False, True])
@pytest.mark.parametrize("n_cols,batch", FSM_SHAPES)
def test_fsm_scan_kernel_is_segment_batch_bit_for_bit(device, n_cols, batch, with_valid):
    """Two slabs in turn, the state carried: the kernel's [3, T, B] events
    (seg_start and seg_end where nothing closed too) and its state equal
    segment_batch's on the card and on the CPU, with probabilities at the
    fp32 thresholds and one ulp either side; valid_chunks 0, inside either
    slab and past both."""
    grid, valid = fsm_case(n_cols, batch, with_valid)
    probs = torch.from_numpy(grid).to(device)
    valid = None if valid is None else torch.from_numpy(valid).to(device)
    out = _fsm_both([probs[:, :n_cols], probs[:, n_cols:]], valid, device)
    closes = _fsm_equal(out)
    if n_cols * batch >= 7 * 512:
        assert closes, "the probabilities should close some segments"


@pytest.mark.parametrize("layout", FSM_LAYOUTS)
def test_fsm_scan_kernel_on_views_that_are_not_contiguous(device, layout):
    """The kernel reads probs through both strides: a transposed [T, B]
    tensor, a column slice of a wider slab and every other column give
    segment_batch's bits, with no copy made."""
    grid, valid, view = fsm_view_case(layout)
    probs = view(torch.from_numpy(grid).to(device))
    assert not probs.is_contiguous()
    out = _fsm_both([probs, probs.flip(1)], torch.from_numpy(valid).to(device), device)
    assert _fsm_equal(out)


def test_fsm_scan_refuses_what_it_does_not_take_on_the_card(device):
    from vadc_tpu_torch.kernels import fsm

    state = fsm.init_fsm_state(4, device)
    probs = torch.zeros(4, 3, device=device)
    with pytest.raises(TypeError, match="float32"):
        fsm.fsm_scan(probs.double(), state, **FSM)
    with pytest.raises(ValueError, match="non-empty"):
        fsm.fsm_scan(probs[:, :0], state, **FSM)
    with pytest.raises(ValueError, match="speech_start"):
        fsm.fsm_scan(probs, state._replace(speech_start=state.speech_start.long()), **FSM)
    with pytest.raises(ValueError, match="triggered"):
        fsm.fsm_scan(probs, state._replace(triggered=state.triggered.cpu()), **FSM)
    with pytest.raises(ValueError, match="valid_chunks"):
        fsm.fsm_scan(probs, state, **FSM, valid_chunks=torch.zeros(5, dtype=torch.int32,
                                                                   device=device))
    with pytest.raises(ValueError, match="int32"):
        fsm.fsm_scan(probs, state._replace(chunk_index=2**31 - 2), **FSM)


@pytest.mark.parametrize("slab", [64, 37])
def test_batch_segmenter_on_the_card_is_the_scalar_segmenter(device, slab):
    """BatchSegmenter on the card (one kernel launch a slab, the last slab
    ragged) gives the scalar Segmenter's segments on every stream's real
    prefix, and counts every column it fed."""
    from vadc_tpu_torch import tracing
    from vadc_tpu_torch.cli.segmenter import Segmenter, SegmenterConfig
    from vadc_tpu_torch.engine.vectorized_segmenter import BatchSegmenter
    from vadc_tpu_torch.kernels import fsm

    probs, valid = segmenter_case()
    batch, n_cols = probs.shape
    config = SegmenterConfig(**FSM)
    launches = fsm.fsm_scan.launches
    before = tracing.counters()
    with tracing.record():
        seg = BatchSegmenter(config, batch, device=device, valid_chunks=valid)
        on_card = torch.from_numpy(probs).to(device)
        for off in range(0, n_cols, slab):
            seg.feed(on_card[:, off : off + slab])
        got = seg.finish()
    after = tracing.counters()
    counted = {k: n - before.get(k, 0) for k, n in after.items() if n != before.get(k, 0)}
    assert counted == {"segmenter.columns": n_cols}
    assert fsm.fsm_scan.launches == launches + -(-n_cols // slab)
    want = []
    for row, n in zip(probs, valid):
        scalar = Segmenter(config)
        want.append([s for p in row[:n] for s in scalar.feed(float(p))] + list(scalar.finish()))
    assert got == want and any(got)


@pytest.mark.parametrize("batch,chunk", [(64, 1536), (37, 1536), (1, 1536), (16, 512),
                                         (16, 1024)])
def test_forward_fused_kernel_matches_plain(params, device, batch, chunk):
    """The whole v3.1 step from raw audio against its plain version, from a
    carried state, with the state in place and a ragged last block. Bounds:
    the whole-model ones (probs 1e-4, h 3e-4, c 3e-4 of its largest value):
    the spectra are summed in other orders, and log1p(2^20 x) amplifies
    that. The kernel's spectrum is dot_magnitude's, bit for bit."""
    from vadc_tpu_torch.kernels import silero_v31_fused as KF
    from vadc_tpu_torch.kernels import stft_dotmag as KD
    from vadc_tpu_torch.nn import functional as F

    audio = torch.from_numpy(speech(batch, chunk=chunk, seed=batch + 10)).to(device)
    h = torch.from_numpy(0.5 * noise(2 * batch, chunk=64, seed=12)).reshape(2, batch, 64).to(device)
    c = torch.from_numpy(5 * noise(2 * batch, chunk=64, seed=13)).reshape(2, batch, 64).to(device)
    spect = torch.empty(batch, chunk // 64 + 1, 129, device=device)
    before = KF.forward_fused.launches
    probs, hn, cn = KF.forward_fused(params, audio, h, c, spectrum=spect)
    p_ref, h_ref, c_ref = KF.forward_fused_reference(params, audio, h, c)
    wr, wi = KD.split_basis(params["stft_basis"])
    mag = KD.dot_magnitude(F.frame(F.reflect_pad_last(audio, 128, 128), 256, 64), wr, wi)
    torch.cuda.synchronize()
    assert KF.forward_fused.launches == before + 1
    assert probs.shape == (batch,) and hn.shape == (2, batch, 64)
    assert torch.equal(spect, mag)
    assert _max_abs(probs, p_ref) <= 1e-4
    assert _max_abs(hn, h_ref) <= 3e-4
    assert _max_abs(cn, c_ref) <= 3e-4 * max(1.0, float(c_ref.abs().max()))
    h2, c2 = h.clone(), c.clone()
    _, h_out, c_out = KF.forward_fused(params, audio, h2, c2, hn=h2, cn=c2)
    torch.cuda.synchronize()
    assert h_out is h2 and c_out is c2
    assert torch.equal(h2, hn) and torch.equal(c2, cn)


def test_forward_fused_refuses_a_chunk_size_on_the_card(params, device):
    from vadc_tpu_torch.kernels import silero_v31_fused as KF

    h = torch.zeros(2, 2, 64, device=device)
    with pytest.raises(ValueError, match="multiple of 256"):
        KF.forward_fused(params, torch.zeros(2, 1000, device=device), h, h.clone())


def test_server_tick_on_the_card_matches_its_cpu_self(device):
    """The server's _tick and _tick2 on the card against the same server on
    the CPU: idle slots bit for bit, the rest within the whole-model
    bounds."""
    from vadc_tpu_torch.server import VadServer

    servers = [VadServer(port=0, max_streams=8, model=str(V31_ARCHIVE), device=d)
               for d in (device, "cpu")]
    try:
        rng = np.random.default_rng(14)
        n, chunk = 8, servers[0].chunk
        ba = np.clip(speech(n, chunk=chunk, seed=15) * 32768, -32768, 32767).astype(np.int16)
        bb = (rng.normal(size=(n, chunk)) * 3000).astype(np.int16)
        h0 = (0.3 * rng.normal(size=(2, n, 64))).astype(np.float32)
        c0 = rng.normal(size=(2, n, 64)).astype(np.float32)
        act_a = np.array([1, 1, 0, 0, 1, 1, 1, 0], bool)
        act_b = np.array([1, 0, 1, 0, 1, 1, 0, 1], bool)
        reset = np.array([0, 1, 0, 1, 0, 0, 0, 0], bool)
        out = []
        for srv in servers:
            srv.state.h.copy_(torch.from_numpy(h0))
            srv.state.c.copy_(torch.from_numpy(c0))
            p1 = srv._tick(ba, act_a, reset)
            p2 = srv._tick2(bb, ba, act_b, act_a, np.zeros(n, bool))
            out.append((p1, p2, srv.state.h.cpu(), srv.state.c.cpu()))
        (g1, g2, gh, gc), (c1, c2, ch, cc) = out
        assert np.abs(g1 - c1).max() <= 1e-4 and np.abs(g2 - c2).max() <= 1e-4
        assert _max_abs(gh, ch) <= 3e-4
        assert _max_abs(gc, cc) <= 3e-4 * max(1.0, float(cc.abs().max()))
        # slot 3: reset, then idle in every sub-step: zeros on the card too
        assert not gh[:, 3].any() and not gc[:, 3].any()
        assert servers[0].tick_count == 2
    finally:
        for srv in servers:
            srv.pool.close()


@pytest.fixture(scope="module")
def family_params(device):
    """family -> (model module, params on the card) for v4, v4_8k (bundled
    archives) and v5, v5_8k (synthetic archives, fixed seeds)."""
    from vadc_tpu_torch.models import silero_v4, silero_v5
    from vadc_tpu_torch.models.synthetic import random_v5_8k_archive, random_v5_archive
    from vadc_tpu_torch.models.weights import load_params, load_params_from_tensors

    return {
        "v4": (silero_v4, load_params(DATA / "silero_v4_16k.testtensor", device=device)[1]),
        "v4_8k": (silero_v4.v4_8k,
                  load_params(DATA / "silero_v4_8k.testtensor", device=device)[1]),
        "v5": (silero_v5, load_params_from_tensors(random_v5_archive(0), device=device)[1]),
        "v5_8k": (silero_v5.v5_8k,
                  load_params_from_tensors(random_v5_8k_archive(1), device=device)[1]),
    }


# (family, batch, samples the model sees, pad_left, pad_right, hop): the
# paths' geometries, v4 at the step's B=2048, and a ragged B=37 at each
STFT_CASES = [
    ("v4", 64, 1536, 96, 96, 64), ("v4", 37, 512, 96, 96, 64), ("v4", 1, 1536, 96, 96, 64),
    ("v4_8k", 16, 768, 96, 96, 64), ("v4_8k", 16, 256, 96, 96, 64),
    ("v5", 64, 576, 0, 64, 128), ("v5_8k", 64, 288, 0, 32, 64),
    ("v4", 2048, 1536, 96, 96, 64), ("v4", 37, 1536, 96, 96, 64),
    ("v4_8k", 37, 768, 96, 96, 64), ("v5", 37, 576, 0, 64, 128), ("v5_8k", 37, 288, 0, 32, 64),
]


@pytest.mark.parametrize("family,batch,samples,pad_left,pad_right,hop", STFT_CASES,
                         ids=[f"{c[0]}-B{c[1]}-{c[2]}" for c in STFT_CASES])
def test_stft_magnitude_kernel_matches_plain(family_params, device, family, batch, samples,
                                             pad_left, pad_right, hop):
    from vadc_tpu_torch.kernels import stft_dotmag as KD
    from vadc_tpu_torch.kernels import stft_mag as KS
    from vadc_tpu_torch.nn import functional as F

    _, params = family_params[family]
    audio = torch.from_numpy(speech(batch, chunk=samples, seed=samples)).to(device)
    wr, wi = KS.split_basis_of(params)
    kw = dict(pad_left=pad_left, pad_right=pad_right, hop=hop)
    before = KS.stft_magnitude.launches
    got = KS.stft_magnitude(audio, wr, wi, **kw)
    want = KS.stft_magnitude_reference(audio, wr, wi, **kw)
    via_dotmag = KD.dot_magnitude(F.frame(F.reflect_pad_last(audio, pad_left, pad_right),
                                          wr.shape[0], hop), wr, wi)
    torch.cuda.synchronize()
    assert KS.stft_magnitude.launches == before + 1
    n_fft, cutoff = wr.shape
    assert got.shape == (batch, (samples + pad_left + pad_right - n_fft) // hop + 1, cutoff)
    assert _max_abs(got, want) <= 1e-5 * float(want.abs().max())
    assert torch.equal(got, via_dotmag)


def test_stft_magnitude_refuses_a_pad_the_chunk_cannot_reflect(family_params, device):
    from vadc_tpu_torch.kernels import stft_mag as KS

    wr, wi = KS.split_basis_of(family_params["v4"][1])
    with pytest.raises(ValueError, match="reflect pads"):
        KS.stft_magnitude(torch.zeros(2, 96, device=device), wr, wi,
                          pad_left=96, pad_right=96, hop=64)


def test_spectrum_kernels_refuse_a_geometry_they_are_not_built_for(family_params, device):
    """n_fft and bins of no instance, a hop that does not divide the padded
    chunk (the Pallas kernel's refusal too), a hop under a slice of taps."""
    from vadc_tpu_torch.kernels import stft_dotmag as KD
    from vadc_tpu_torch.kernels import stft_mag as KS

    wr, wi = KS.split_basis_of(family_params["v4"][1])
    audio = torch.zeros(2, 1536, device=device)
    with pytest.raises(ValueError, match="no kernel"):
        KS.stft_magnitude(audio, wr[:, :128].contiguous(), wi[:, :128].contiguous(),
                          pad_left=96, pad_right=96, hop=64)
    with pytest.raises(ValueError, match="must divide"):
        KS.stft_magnitude(audio, wr, wi, pad_left=96, pad_right=90, hop=64)
    with pytest.raises(ValueError, match="multiple of"):
        KS.stft_magnitude(audio, wr, wi, pad_left=96, pad_right=96, hop=16)
    with pytest.raises(ValueError, match="no kernel"):
        KD.dot_magnitude(torch.zeros(2, 3, 512, device=device), torch.zeros(512, 257, device=device),
                         torch.zeros(512, 257, device=device))


@pytest.mark.parametrize("family", ["v4", "v5_8k"])
def test_dot_magnitude_on_a_view_that_is_not_16_byte_aligned(family_params, device, family):
    """Frames one float off 16-byte alignment take the kernel's 4-byte
    copies: within 1e-5 of the largest magnitude of the plain version, and
    the bits of the kernel on an aligned copy of the same frames."""
    from vadc_tpu_torch.kernels import stft_dotmag as KD
    from vadc_tpu_torch.kernels import stft_mag as KS

    _, params = family_params[family]
    wr, wi = KS.split_basis_of(params)
    n_fft = wr.shape[0]
    flat = torch.from_numpy(speech(1, chunk=37 * 9 * n_fft + 1, seed=5)).to(device)[0]
    frames = flat[1:].reshape(37, 9, n_fft)
    assert frames.data_ptr() % 16 != 0
    before = KD.dot_magnitude.launches
    got = KD.dot_magnitude(frames, wr, wi)
    want = KD.dot_magnitude_reference(frames, wr, wi)
    aligned = KD.dot_magnitude(frames.clone(), wr, wi)
    torch.cuda.synchronize()
    assert KD.dot_magnitude.launches == before + 2
    assert _max_abs(got, want) <= 1e-5 * float(want.abs().max())
    assert torch.equal(got, aligned)


# (family, batch, steps): the main paths' shapes, smaller batches
LSTM_CASES = [("v4", 64, 3), ("v4", 37, 5), ("v4", 1, 288), ("v5", 64, 1), ("v5", 1, 96)]


@pytest.mark.parametrize("family,batch,steps", LSTM_CASES,
                         ids=[f"{c[0]}-B{c[1]}-T{c[2]}" for c in LSTM_CASES])
def test_lstm_fused_kernel_matches_plain(family_params, device, family, batch, steps):
    from vadc_tpu_torch.kernels import lstm as KL

    module, params = family_params[family]
    layers, hidden = module.NUM_LSTM_LAYERS, module.HIDDEN
    x = torch.from_numpy(noise(batch * steps, chunk=hidden, seed=5)).reshape(batch, steps, hidden)
    x = (10 * x).to(device)  # encoder features are O(1)
    h = (5 * torch.from_numpy(noise(layers * batch, chunk=hidden, seed=6))).to(device)
    c = (20 * torch.from_numpy(noise(layers * batch, chunk=hidden, seed=7))).to(device)
    h, c = h.reshape(layers, batch, hidden), c.reshape(layers, batch, hidden)
    w, b = params["lstm_w"], params["lstm_b"]
    before = KL.lstm_fused.launches
    y, hn, cn = KL.lstm_fused(x, h, c, w, b, wt=KL.transposed_weight_of(params))
    y_ref, h_ref, c_ref = KL.lstm_fused_reference(x, h, c, w, b)
    torch.cuda.synchronize()
    # the streaming variant is one kernel, the resident one its pre-pass and another
    assert KL.lstm_fused.launches == before + (2 if KL.use_resident(batch, steps) else 1)
    assert y.shape == (batch, steps, hidden) and hn.shape == (layers, batch, hidden)
    assert _max_abs(y, y_ref) <= 5e-5
    assert _max_abs(hn, h_ref) <= 5e-5
    assert _max_abs(cn, c_ref) <= 5e-5 * max(1.0, float(c_ref.abs().max()))
    # the state in place: hn, cn written over h, c; the same bits
    h2, c2 = h.clone(), c.clone()
    _, h_out, c_out = KL.lstm_fused(x, h2, c2, w, b, hn=h2, cn=c2)
    torch.cuda.synchronize()
    assert h_out is h2 and c_out is c2
    assert torch.equal(h2, hn) and torch.equal(c2, cn)


# a ragged block at 4 streams a block (B=333), 1 stream a block, one step
VARIANT_CASES = [("v4", 333, 5), ("v4", 1, 288), ("v4", 64, 1), ("v5", 333, 4), ("v5", 1, 96)]


@pytest.mark.parametrize("family,batch,steps", VARIANT_CASES,
                         ids=[f"{c[0]}-B{c[1]}-T{c[2]}" for c in VARIANT_CASES])
def test_lstm_fused_variants_give_the_same_bits(family_params, device, family, batch, steps):
    """The streaming-weights and the resident-weights variant, launched
    explicitly at any length, equal each other and the wrapper's call bit for
    bit; so does the resident one in several passes over a small scratch."""
    from vadc_tpu_torch.kernels import lstm as KL

    module, params = family_params[family]
    layers, hidden = module.NUM_LSTM_LAYERS, module.HIDDEN
    x = torch.from_numpy(noise(batch * steps, chunk=hidden, seed=15)).reshape(batch, steps, hidden)
    x = (10 * x).to(device)
    h = (5 * torch.from_numpy(noise(layers * batch, chunk=hidden, seed=16))).to(device)
    c = (20 * torch.from_numpy(noise(layers * batch, chunk=hidden, seed=17))).to(device)
    h, c = h.reshape(layers, batch, hidden), c.reshape(layers, batch, hidden)
    w, b, wt = params["lstm_w"], params["lstm_b"], KL.transposed_weight_of(params)
    want = KL.lstm_fused(x, h, c, w, b, wt=wt)

    def run(launch, **kw):
        out = (torch.empty_like(x), torch.empty_like(h), torch.empty_like(c))
        launch(x, h, c, wt, b, *out, **kw)
        torch.cuda.synchronize()
        return out

    outs = {"streaming": run(KL._launch_streaming), "resident": run(KL._launch_resident)}
    saved, KL.PRE_BYTES_MAX = KL.PRE_BYTES_MAX, 16 * hidden * batch * max(1, steps // 3)
    try:
        outs["resident in passes"] = run(KL._launch_resident)
    finally:
        KL.PRE_BYTES_MAX = saved
    for name, out in outs.items():
        assert all(torch.equal(a, r) for a, r in zip(out, want)), name


@pytest.mark.parametrize("batch,chunks,samples", [(333, 3, 1536), (1, 20, 1536), (37, 4, 512)])
def test_lstm_decoder_variants_give_the_same_bits(params, device, batch, chunks, samples):
    from vadc_tpu_torch.kernels import lstm as KL
    from vadc_tpu_torch.kernels import lstm_decoder as KD
    from vadc_tpu_torch.kernels.silero_v31_fused2d import encode_fused
    from vadc_tpu_torch.models import silero_v31

    audio = torch.from_numpy(speech(batch * chunks, chunk=samples, seed=18)).to(device)
    enc = encode_fused(params, silero_v31.features(params, audio))
    x = enc.reshape(batch, chunks, enc.shape[1], 64)
    h = (0.5 * torch.from_numpy(noise(2 * batch, chunk=64, seed=19))).to(device)
    c = (20 * torch.from_numpy(noise(2 * batch, chunk=64, seed=20))).to(device)
    h, c = h.reshape(2, batch, 64), c.reshape(2, batch, 64)
    from vadc_tpu_torch.nn.precision import pack_operand, tier_of

    # the one entry (the streaming kernel is gone), launched explicitly at
    # every tier and in passes over a small scratch, against the wrapper
    for tier in ("faithful", *TIERS):
        t = tier_of(tier)
        wt = KD.weight_of(params, t)
        args = (params["lstm_b"], pack_operand(params["dec_w"], t.products), params["dec_b"])
        want = KD.lstm_decoder_fused(x, h, c, params["lstm_w"], params["lstm_b"], params["dec_w"],
                                     params["dec_b"], wt=wt, tier=t)
        outs = {}
        for name, limit in (("one pass", None), ("passes", 1024 * batch * enc.shape[1])):
            out = (torch.empty_like(want[0]), torch.empty_like(h), torch.empty_like(c))
            saved = KL.PRE_BYTES_MAX
            KL.PRE_BYTES_MAX = limit or saved
            try:
                KD._launch(x, h, c, wt, *args, *out, t)
            finally:
                KL.PRE_BYTES_MAX = saved
            outs[name] = out
        torch.cuda.synchronize()
        for name, out in outs.items():
            assert all(torch.equal(a, r) for a, r in zip(out, want)), (tier, name)


@pytest.mark.parametrize("family", ["v4", "v4_8k", "v5", "v5_8k"])
def test_v4_v5_runners_on_the_card(family_params, device, family):
    """The stream runner's scan (forward_scan) on the card matches the plain
    path on the CPU and goes through both kernels: stft_magnitude once a
    piece of the encoder (models/slab.py: the 3 chunks are one piece) and
    lstm_fused once over each stream's 3 x F frames (its resident variant,
    which takes three frames and more, is two kernels: its pre-pass and the
    recurrent one); the v5 context is carried on the card exactly as on the
    CPU."""
    from vadc_tpu_torch.engine.runner import StreamRunner
    from vadc_tpu_torch.kernels.lstm import lstm_fused, use_resident
    from vadc_tpu_torch.kernels.stft_mag import stft_magnitude
    from vadc_tpu_torch.kernels.v5_convs import v5_convs

    chunk = {"v4": 1536, "v4_8k": 768, "v5": 512, "v5_8k": 256}[family]
    module, params = family_params[family]
    context = getattr(module, "CONTEXT_SAMPLES", 0)
    frames = module.encode(params, torch.zeros(1, context + chunk, device=device)).shape[1]
    chunks = speech(32 * 3, chunk=chunk, seed=8).reshape(32, 3, -1)
    gpu = StreamRunner(family, params, device=device)
    cpu = StreamRunner(family, params, device="cpu")
    stft_magnitude.launches = lstm_fused.launches = v5_convs.launches = 0
    state = gpu.init_state(32)
    p_gpu, st = gpu.scan(chunks, state)
    torch.cuda.synchronize()
    assert st is state
    assert stft_magnitude.launches == 1
    # v5's convs: one launch a piece of the encoder, as its spectrum's
    assert v5_convs.launches == (stft_magnitude.launches if family.startswith("v5") else 0)
    assert lstm_fused.launches == (2 if use_resident(32, 3 * frames) else 1)
    p_cpu, st_cpu = cpu.scan(chunks, cpu.init_state(32))
    assert _max_abs(p_gpu.cpu(), p_cpu) <= 1e-4
    assert _max_abs(st.h.cpu(), st_cpu.h) <= 1e-4
    if st.context is not None:
        assert torch.equal(st.context.cpu(), st_cpu.context)


def test_v4_scan_at_2048x8_against_the_loop_of_steps(family_params, device):
    """v4's slab scan of 2048 streams x 8 chunks against the loop of 8
    steps on the card. The kernels give the loop's bits: stft_magnitude
    over the slab's piece (all 8 chunks of every stream in one batch) gives
    each chunk's spectrum as the step computes it, and one lstm_fused call
    over the 24 frames of each stream fed the steps' own features gives the
    loop's h and c. The encoder's torch ops and the decoder over 8 times the
    step's rows are cuBLAS products, whose algorithm cuBLAS picks by the
    number of rows, so the scan is held to tier_check.shard_bound("v4")."""
    from vadc_tpu_torch.engine.runner import StreamRunner
    from vadc_tpu_torch.kernels.lstm import lstm_fused, weight_of
    from vadc_tpu_torch.kernels.tier_check import shard_bound
    from vadc_tpu_torch.models import silero_v4

    params = family_params["v4"][1]
    x = torch.from_numpy(speech(2048 * 8, chunk=1536, seed=38).astype(np.float32)).to(
        device).reshape(2048, 8, 1536)
    runner = StreamRunner("v4", params, device=device)
    scan = runner.init_state(2048)
    probs, _ = runner.scan(x, scan)
    loop = runner.init_state(2048)
    steps = torch.stack([runner.step(x[:, k], loop)[0] for k in range(8)], dim=1)
    whole = silero_v4.spectrum(params, x.reshape(-1, 1536), silero_v4.FAITHFUL)
    columns = torch.stack([silero_v4.spectrum(params, x[:, k].contiguous(), silero_v4.FAITHFUL)
                           for k in range(8)], dim=1)
    assert torch.equal(whole, columns.reshape(whole.shape))
    feats = torch.stack([silero_v4.encode(params, x[:, k].contiguous()) for k in range(8)], dim=1)
    h, c = silero_v4.init_state(2048, device)
    _, hn, cn = lstm_fused(feats.reshape(2048, -1, 64), h, c, params["lstm_w"], params["lstm_b"],
                           wt=weight_of(params))
    torch.cuda.synchronize()
    assert torch.equal(hn, loop.h) and torch.equal(cn, loop.c)
    bound = shard_bound("v4")
    assert _max_abs(probs, steps) <= bound["probs"]
    assert max(_max_abs(scan.h, loop.h), _max_abs(scan.c, loop.c)) <= bound["state"]


# ---- the bf16 tiers of the v3.1 path --------------------------------------
# each tier instance against its plain version at the tier, held to
# vadc_tpu_torch/kernels/tier_check.py (which says why they are not
# bit-equal): the largest differences at its large-batch limits, which
# allow a flip in any stream, and at 2048 streams the share of outputs
# that differ


@pytest.mark.parametrize("tier", ["balanced", "fast", "turbo"])
@pytest.mark.parametrize("batch", [2048, 37, 1])
def test_tier_instances_match_plain(params, device, tier, batch):
    """forward_fused (against the plain version fed its own spectrum),
    forward_fused2d and encode_fused_audio at the tier against their plain
    versions at the tier; the step kernel's spectrum bit for bit against
    dot_magnitude's instance; lstm_decoder_fused on encode_fused_audio's
    rows bit for bit against forward_fused."""
    from vadc_tpu_torch.kernels import lstm_decoder as KL
    from vadc_tpu_torch.kernels import silero_v31_fused as KF
    from vadc_tpu_torch.kernels import silero_v31_fused2d as K2
    from vadc_tpu_torch.kernels import stft_dotmag as KD
    from vadc_tpu_torch.kernels import tier_check as TC
    from vadc_tpu_torch.models import silero_v31 as TM
    from vadc_tpu_torch.nn import functional as F

    audio = torch.from_numpy(speech(batch, seed=60)).to(device)
    h = torch.from_numpy(0.5 * noise(2 * batch, chunk=64, seed=61)).reshape(2, batch, 64).to(device)
    c = torch.from_numpy(5 * noise(2 * batch, chunk=64, seed=62)).reshape(2, batch, 64).to(device)
    spect = torch.empty(batch, 25, 129, device=device)
    got = KF.forward_fused(params, audio, h, c, spectrum=spect, tier=tier)
    want = KF.forward_fused_reference(params, audio, h, c, tier, spectrum=spect)
    wr, wi = KD.split_basis(params["stft_basis"])
    mag = KD.dot_magnitude(F.frame(F.reflect_pad_last(audio, 128, 128), 256, 64), wr, wi, tier)
    enc = KF.encode_fused_audio(params, audio, tier)
    enc_ref = KF.encode_fused_audio_reference(params, audio, tier, spectrum=spect)
    args = (params["lstm_w"], params["lstm_b"], params["dec_w"], params["dec_b"])
    split = KL.lstm_decoder_fused(enc[:, None], h, c, *args, tier=tier)
    feats = TM.features(params, audio, tier)
    f2d = K2.forward_fused2d(params, feats, h, c, tier=tier)
    f2d_ref = K2.forward_fused2d_reference(params, feats, h, c, tier)
    torch.cuda.synchronize()
    assert torch.equal(spect, mag)
    assert torch.equal(split[0][:, 0], got[0]) and torch.equal(split[1], got[1])
    broken = (TC.breaches(tier, "forward_fused", batch, TC.state_errors(got, want, tier), True)
              + TC.breaches(tier, "forward_fused2d", batch, TC.state_errors(f2d, f2d_ref, tier), True)
              + TC.breaches(tier, "encode_fused_audio", batch,
                            {"enc": TC.errors(enc, enc_ref, tier)}, True))
    assert not broken, broken


@pytest.mark.parametrize("tier", ["balanced", "fast", "turbo"])
@pytest.mark.parametrize("streams,chunks", [(37, 5), (1, 24)])
def test_tier_slab_is_the_loop_of_steps_bit_for_bit(params, device, tier, streams, chunks):
    from vadc_tpu_torch.engine.runner import StreamRunner

    slab = torch.from_numpy(speech(streams * chunks, seed=63)).to(device).reshape(streams, chunks, 1536)
    runner = StreamRunner("v3", params, device=device, precision=tier)
    p_slab, by_slab = runner.scan(slab, runner.init_state(streams))
    by_steps = runner.init_state(streams)
    p_steps = torch.stack([runner.step(slab[:, k], by_steps)[0] for k in range(chunks)], dim=1)
    torch.cuda.synchronize()
    assert torch.equal(p_steps, p_slab)
    assert torch.equal(by_steps.h, by_slab.h) and torch.equal(by_steps.c, by_slab.c)


def test_tiers_leave_the_faithful_instance_alone(params, device):
    """The faithful tier by name and by default are one instance; a bf16
    tier is another."""
    from vadc_tpu_torch.kernels import silero_v31_fused as KF

    audio = torch.from_numpy(speech(8, seed=64)).to(device)
    h, c = torch.zeros(2, 8, 64, device=device), torch.zeros(2, 8, 64, device=device)
    default = KF.forward_fused(params, audio, h, c)
    named = KF.forward_fused(params, audio, h, c, tier="faithful")
    fast = KF.forward_fused(params, audio, h, c, tier="fast")
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(default, named))
    assert not torch.equal(default[1], fast[1])


# ---- the bf16 tiers of the v4 and v5 paths --------------------------------
# stft_magnitude's instance of the products' mode the tier gives the family
# and lstm_fused's instance of the tier, each against its plain version at
# the tier, held to kernels/tier_check.py; the spectrum bit-equal to
# dot_magnitude's instance of the same operands, the two LSTM variants to
# each other; the paths on the card against the CPU within its PATH_MAX

TIERS = ("balanced", "fast", "turbo")
# family -> (samples the spectrum sees, pad_left, pad_right, hop)
V45_STFT = {"v4": (1536, 96, 96, 64), "v4_8k": (768, 96, 96, 64), "v5": (576, 0, 64, 128),
            "v5_8k": (288, 0, 32, 64)}
# dot_magnitude's tier of each spectrum mode: the tier whose STFT it is
DOTMAG_TIER = {"fp32": "faithful", "bf16_3x": "fast", "bf16": "turbo"}


@pytest.mark.parametrize("tier", TIERS)
@pytest.mark.parametrize("family", ["v4", "v4_8k", "v5", "v5_8k"])
def test_stft_magnitude_tier_instances_match_plain(family_params, device, family, tier):
    from vadc_tpu_torch.kernels import stft_dotmag as KD
    from vadc_tpu_torch.kernels import stft_mag as KS
    from vadc_tpu_torch.kernels import tier_check
    from vadc_tpu_torch.nn import functional as F
    from vadc_tpu_torch.nn.precision import stft_mode, tier_of

    _, params = family_params[family]
    samples, pad_left, pad_right, hop = V45_STFT[family]
    mode = stft_mode(tier_of(tier), log_sensitive=family.startswith("v4"))
    audio = torch.from_numpy(speech(256, chunk=samples, seed=70)).to(device)
    wr, wi = KS.split_basis_of(params)
    kw = dict(pad_left=pad_left, pad_right=pad_right, hop=hop)
    before = KS.stft_magnitude.launches
    got = KS.stft_magnitude(audio, wr, wi, **kw, mode=mode)
    want = KS.stft_magnitude_reference(audio, wr, wi, **kw, mode=mode)
    torch.cuda.synchronize()
    assert KS.stft_magnitude.launches == before + 1
    errs = {"mag": tier_check.errors(got, want, tier, float(want.abs().max()))}
    assert not tier_check.breaches(tier, "stft_magnitude", 256, errs), errs
    if wr.shape == (256, 129):
        frames = F.frame(F.reflect_pad_last(audio, pad_left, pad_right), 256, hop)
        assert torch.equal(got, KD.dot_magnitude(frames, wr, wi, DOTMAG_TIER[mode]))


# the tensor-core spectrum's edges: rows that are no multiple of 16 (a
# ragged B=37), the shortest chunks (512 samples, 9 frames a stream) and
# v5 8 kHz's 65 bins, whose Nyquist bin sits on a padded n8 tile
EDGE_CASES = {"v3.1 B=37 x 1536": ("v3", 37, 1536), "v3.1 B=37 x 512": ("v3", 37, 512),
              "v5_8k B=37 x 288": ("v5_8k", 37, 288)}


@pytest.mark.parametrize("tier", TIERS)
@pytest.mark.parametrize("case", list(EDGE_CASES))
def test_tensor_core_spectrum_at_the_tile_edges(params, family_params, device, case, tier):
    """Each spectrum kernel's instance at the tier's operands against its
    plain version by kernels/tier_check.py, and the three kernels of the
    v3.1 geometry bit for bit: the step kernel's spectrum, dot_magnitude's
    and stft_magnitude's at the same operands. v5 8 kHz at both bf16 modes
    (stft_magnitude alone has 65-bin instances)."""
    from vadc_tpu_torch.kernels import silero_v31_fused as KF
    from vadc_tpu_torch.kernels import stft_dotmag as KD
    from vadc_tpu_torch.kernels import stft_mag as KS
    from vadc_tpu_torch.kernels import tier_check
    from vadc_tpu_torch.nn import functional as F
    from vadc_tpu_torch.nn.precision import stft_mode, tier_of

    family, batch, samples = EDGE_CASES[case]
    t = tier_of(tier)
    audio = torch.from_numpy(speech(batch, chunk=samples, seed=71)).to(device)

    def held(got, want):
        errs = {"mag": tier_check.errors(got, want, tier, float(want.abs().max()))}
        assert not tier_check.breaches(tier, "stft_magnitude", batch, errs), (case, errs)

    if family == "v5_8k":
        _, p5 = family_params[family]
        wr, wi = KS.split_basis_of(p5)
        _, pad_left, pad_right, hop = V45_STFT[family]
        kw = dict(pad_left=pad_left, pad_right=pad_right, hop=hop)
        for mode in sorted({stft_mode(t, log_sensitive=False), t.stft}):
            got = KS.stft_magnitude(audio, wr, wi, **kw, mode=mode)
            held(got, KS.stft_magnitude_reference(audio, wr, wi, **kw, mode=mode))
        return
    wr, wi = KD.split_basis(params["stft_basis"])
    h = torch.zeros(2, batch, 64, device=device)
    spect = torch.empty(batch, samples // 64 + 1, 129, device=device)
    KF.forward_fused(params, audio, h, h.clone(), spectrum=spect, tier=t)
    frames = F.frame(F.reflect_pad_last(audio, 128, 128), 256, 64)
    mag = KD.dot_magnitude(frames, wr, wi, t)
    kw = dict(pad_left=128, pad_right=128, hop=64)
    got = KS.stft_magnitude(audio, wr, wi, **kw, mode=t.stft)
    want = KS.stft_magnitude_reference(audio, wr, wi, **kw, mode=t.stft)
    torch.cuda.synchronize()
    held(got, want)
    errs = {"mag": tier_check.errors(mag, want, tier, float(want.abs().max()))}
    assert not tier_check.breaches(tier, "dot_magnitude", batch, errs), errs
    assert torch.equal(spect, mag) and torch.equal(got, mag)


def _lstm_inputs_at(module, params, device, tier, batch: int, steps: int, seed: int):
    """Encoder features of speech at the tier as `batch` sequences of
    `steps` frames, and a carried state (a plain forward on noise first)."""
    context = getattr(module, "CONTEXT_SAMPLES", 0)
    chunk = {64: 1536, 128: 512}[module.HIDDEN]
    frames = module.encode(params, torch.zeros(1, context + chunk, device=device)).shape[1]
    n = batch * steps // frames
    audio = torch.from_numpy(speech(n, chunk=context + chunk, seed=seed)).to(device)
    x = module.encode(params, audio, tier=tier).reshape(batch, steps, module.HIDDEN).contiguous()
    h0, c0 = module.init_state(n, device)
    other = torch.from_numpy(noise(n, chunk=context + chunk, seed=seed + 1)).to(device)
    _, h, c = module.forward_reference(params, other, h0, c0)
    return x, h[:, :batch].contiguous(), c[:, :batch].contiguous()


@pytest.mark.parametrize("tier", TIERS)
@pytest.mark.parametrize("family,batch,steps", [("v4", 2048, 3), ("v4", 1, 288), ("v5", 2048, 1),
                                                ("v5", 1, 96)])
def test_lstm_fused_tier_instances_match_plain(family_params, device, family, batch, steps, tier):
    """The wrapper's instance of the tier against F.lstm at the tier; the
    streaming and the resident variant, launched explicitly at the tier,
    bit for bit against the wrapper's call."""
    from vadc_tpu_torch.kernels import lstm as KL
    from vadc_tpu_torch.kernels import tier_check
    from vadc_tpu_torch.nn.precision import tier_of

    module, params = family_params[family]
    t = tier_of(tier)
    x, h, c = _lstm_inputs_at(module, params, device, t, batch, steps, 71)
    w, b, wt = params["lstm_w"], params["lstm_b"], KL.weight_of(params, t)
    got = KL.lstm_fused(x, h, c, w, b, wt=wt, tier=t)
    want = KL.lstm_fused_reference(x, h, c, w, b, t)
    torch.cuda.synchronize()
    scale = max(1.0, float(want[2].abs().max()))
    errs = {name: tier_check.errors(g, r, tier, scale if name == "c" else 1.0)
            for name, g, r in zip(("y", "h", "c"), got, want)}
    assert not tier_check.breaches(tier, "lstm_fused", batch, errs), errs
    for launch in (KL._launch_streaming, KL._launch_resident):
        out = (torch.empty_like(x), torch.empty_like(h), torch.empty_like(c))
        launch(x, h, c, wt, b, *out, t)
        torch.cuda.synchronize()
        assert all(torch.equal(a, r) for a, r in zip(out, got)), launch.__name__


def test_lstm_fused_refuses_a_weight_packed_for_another_tier(family_params, device):
    from vadc_tpu_torch.kernels import lstm as KL

    _, params = family_params["v4"]
    x, h = torch.zeros(2, 3, 64, device=device), torch.zeros(2, 2, 64, device=device)
    w, b = params["lstm_w"], params["lstm_b"]
    # the tiers' gate fragments differ in shape from the faithful weight and
    # from each other (one plane at bf16, two at bf16_3x)
    with pytest.raises(ValueError, match="wt"):
        KL.lstm_fused(x, h, h.clone(), w, b, wt=KL.transposed_weight_of(params), tier="fast")
    with pytest.raises(ValueError, match="wt"):
        KL.lstm_fused(x, h, h.clone(), w, b, wt=KL.weight_of(params, "fast"))
    with pytest.raises(ValueError, match="wt"):
        KL.lstm_fused(x, h, h.clone(), w, b, wt=KL.weight_of(params, "fast"), tier="balanced")
    # a tensor of the right shape packed for another mode
    wt = KL.weight_of(params, "fast").clone()
    with pytest.raises(ValueError, match="packed for bf16 products"):
        KL.lstm_fused(x, h, h.clone(), w, b, wt=wt, tier="fast")


@pytest.mark.parametrize("tier", TIERS)
@pytest.mark.parametrize("family", ["v4", "v4_8k", "v5", "v5_8k"])
def test_v4_v5_runners_at_a_tier_on_the_card(family_params, device, family, tier):
    """The stream runner at the tier on the card against the plain path at
    the tier on the CPU, through both kernels' tier instances."""
    from vadc_tpu_torch.engine.runner import StreamRunner
    from vadc_tpu_torch.kernels import tier_check
    from vadc_tpu_torch.kernels.lstm import lstm_fused
    from vadc_tpu_torch.kernels.stft_mag import stft_magnitude

    chunk = {"v4": 1536, "v4_8k": 768, "v5": 512, "v5_8k": 256}[family]
    _, params = family_params[family]
    chunks = speech(32 * 3, chunk=chunk, seed=72).reshape(32, 3, -1)
    gpu = StreamRunner(family, params, device=device, precision=tier)
    cpu = StreamRunner(family, params, device="cpu", precision=tier)
    stft_magnitude.launches = lstm_fused.launches = 0
    p_gpu, st = gpu.scan(chunks, gpu.init_state(32))
    torch.cuda.synchronize()
    assert stft_magnitude.launches == 1 and lstm_fused.launches >= 1
    p_cpu, st_cpu = cpu.scan(chunks, cpu.init_state(32))
    limits = tier_check.PATH_MAX[tier]
    assert _max_abs(p_gpu.cpu(), p_cpu) <= limits["probs"]
    assert _max_abs(st.h.cpu(), st_cpu.h) <= limits["h"]


# ---- v5's four convs in one kernel (kernels/v5_convs.py) -------------------
# against the plain chain (models/silero_v5.py: _convs) on the card, at both
# widths (v5's C_in 129, v5_8k's 65), every tier and the rows of a single
# stream's step (1), a ragged tile of the kernel's 32 chunks (37), the
# server's batch (2048) and the batch CLI's piece (4096). Faithful: 2e-6 of
# the largest feature, chip_smoke.py's TOL_V5_CONVS, three times the largest
# reading on an H100 (6.1e-7 over 236 inputs; the kernel sums each tap's
# products in channel order, cuBLAS in its own) rounded up; the control, the
# plain chain at fast, reads 2.2e-3 and up there. The bf16 tiers:
# tier_check's class of the kernel, which says why. A chunk's bits do not
# depend on the rows launched with it.

V5_CONVS_ROWS = (1, 37, 2048, 4096)
V5_CONVS_FAITHFUL = 2e-6


def _v5_spectrum(family_params, device, family, rows, tier, seed):
    """(params, the spectrum at the tier of `rows` chunks of speech)."""
    from vadc_tpu_torch.models import silero_v5
    from vadc_tpu_torch.nn.precision import tier_of

    module, params = family_params[family]
    chunk = {"v5": 512, "v5_8k": 256}[family]
    audio = torch.from_numpy(speech(rows, chunk=module.CONTEXT_SAMPLES + chunk, seed=seed)).to(
        device)
    return params, silero_v5.spectrum(params, audio, pad_right=module.STFT_PAD_RIGHT,
                                      hop=module.STFT_HOP, tier=tier_of(tier))


@pytest.mark.parametrize("rows", V5_CONVS_ROWS)
@pytest.mark.parametrize("tier", ("faithful", *TIERS))
@pytest.mark.parametrize("family", ["v5", "v5_8k"])
def test_v5_convs_kernel_matches_plain(family_params, device, family, tier, rows):
    from vadc_tpu_torch.kernels import tier_check
    from vadc_tpu_torch.kernels import v5_convs as KV
    from vadc_tpu_torch.models import silero_v5
    from vadc_tpu_torch.nn.precision import tier_of

    t = tier_of(tier)
    params, spect = _v5_spectrum(family_params, device, family, rows, t, seed=80 + rows)
    before = KV.v5_convs.launches
    got = KV.v5_convs(params, spect, t)
    want = silero_v5._convs(params, spect, t)
    torch.cuda.synchronize()
    assert KV.v5_convs.launches == before + 1
    assert got.shape == want.shape == (rows, 1, 128)
    scale = float(want.abs().max())
    if tier == "faithful":
        assert _max_abs(got, want) <= V5_CONVS_FAITHFUL * scale
    else:
        broken = tier_check.breaches(tier, "v5_convs", rows,
                                     {"feat": tier_check.errors(got, want, tier, scale)})
        assert not broken, broken


@pytest.mark.parametrize("tier", ("faithful", *TIERS))
@pytest.mark.parametrize("family", ["v5", "v5_8k"])
def test_v5_convs_gives_a_chunk_the_same_bits_whatever_rows_share_its_launch(
        family_params, device, family, tier):
    from vadc_tpu_torch.kernels.v5_convs import v5_convs

    params, spect = _v5_spectrum(family_params, device, family, 4096, tier, seed=90)
    whole = v5_convs(params, spect, tier)
    for a, b in ((0, 1), (5, 37), (31, 33), (1000, 3049), (4095, 4096)):
        part = v5_convs(params, spect[a:b].contiguous(), tier)
        torch.cuda.synchronize()
        assert torch.equal(part, whole[a:b]), (a, b)


@pytest.mark.parametrize("tier", ("faithful", *TIERS))
@pytest.mark.parametrize("family", ["v5", "v5_8k"])
def test_v5_scan_against_the_loop_of_steps_within_tier_checks_bound(family_params, device,
                                                                     family, tier):
    """The batch CLI's slab (64 streams x 64 chunks) by the scan against
    the loop of StreamRunner.step on the card: the loop's bits, or within
    tier_check.shard_bound(family, tier). The convs' kernel gives each chunk
    the step's bits in the scan's pieces, and the context is the loop's."""
    from vadc_tpu_torch.engine.runner import StreamRunner
    from vadc_tpu_torch.kernels.tier_check import shard_bound

    module, params = family_params[family]
    chunk = {"v5": 512, "v5_8k": 256}[family]
    x = torch.from_numpy(speech(64 * 64, chunk=chunk, seed=91)).to(device).reshape(64, 64, chunk)
    runner = StreamRunner(family, params, device=device, precision=tier)
    scan = runner.init_state(64)
    probs, _ = runner.scan(x, scan)
    loop = runner.init_state(64)
    steps = torch.stack([runner.step(x[:, k], loop)[0] for k in range(64)], dim=1)
    torch.cuda.synchronize()
    assert torch.equal(scan.context, loop.context)
    got, want = (probs, scan.h, scan.c), (steps, loop.h, loop.c)
    if not all(torch.equal(g, w) for g, w in zip(got, want)):
        bound = shard_bound(family, tier)
        assert _max_abs(probs, steps) <= bound["probs"]
        assert max(_max_abs(scan.h, loop.h), _max_abs(scan.c, loop.c)) <= bound["state"]


# ---- checkpoints and the Python API across the card and the CPU ------------


@pytest.mark.parametrize("saver,loader", [("card", "cpu"), ("cpu", "card")])
def test_server_checkpoint_moves_between_card_and_cpu(device, saver, loader, tmp_path):
    """A server checkpoint saved on one device restores on the other with
    the state bit for bit; the next tick of both servers on the same chunk
    agrees within the whole-model bounds (probabilities 1e-4, h 3e-4)."""
    from vadc_tpu_torch import native

    if not native.available():
        pytest.skip("native library unavailable (make -C native)")
    from vadc_tpu_torch.server import VadServer

    on = {"card": device, "cpu": "cpu"}
    src = VadServer(port=0, max_streams=8, model=str(V31_ARCHIVE), device=on[saver])
    dst = VadServer(port=0, max_streams=8, model=str(V31_ARCHIVE), device=on[loader])
    try:
        rng = np.random.default_rng(31)
        h = torch.from_numpy((0.3 * rng.normal(size=tuple(src.state.h.shape))).astype(np.float32))
        c = torch.from_numpy(rng.normal(size=tuple(src.state.c.shape)).astype(np.float32))
        src.state.h.copy_(h)
        src.state.c.copy_(c)
        src.fsm.chunk_index[:] = np.arange(8) * 7
        src.save_checkpoint(tmp_path / "srv.ckpt")
        dst.restore_checkpoint(tmp_path / "srv.ckpt")
        assert dst.state.h.device.type == dst.device.type
        assert torch.equal(dst.state.h.cpu(), h) and torch.equal(dst.state.c.cpu(), c)
        assert dst.fsm.chunk_index.tolist() == (np.arange(8) * 7).tolist()
        dst.warmup()
        assert torch.equal(dst.state.h.cpu(), h) and torch.equal(dst.state.c.cpu(), c)
        batch = np.clip(speech(8, seed=32) * 32768, -32768, 32767).astype(np.int16)
        on_mask, off = np.ones(8, bool), np.zeros(8, bool)
        p_src, p_dst = src._tick(batch, on_mask, off), dst._tick(batch, on_mask, off)
        assert float(np.abs(p_src - p_dst).max()) <= 1e-4
        assert _max_abs(src.state.h.cpu(), dst.state.h.cpu()) <= 3e-4
    finally:
        src.pool.close()
        dst.pool.close()


@pytest.mark.parametrize("family", ["v3", "v4"])
def test_api_on_the_card_matches_the_cpu(device, family):
    """speech_probabilities on the card within 1e-4 of the CPU, and the same
    segments from detect_speech_samples, on 20 s of synthetic speech."""
    from vadc_tpu_torch import api

    model = str(V31_ARCHIVE if family == "v3" else DATA / "silero_v4_16k.testtensor")
    track, _ = utterance_track(n_utterances=6, seed=33)
    track = track.astype(np.float32)
    p_gpu = api.speech_probabilities(track, model=model, device="cuda")
    p_cpu = api.speech_probabilities(track, model=model, device="cpu")
    assert p_gpu.shape == p_cpu.shape and float(np.abs(p_gpu - p_cpu).max()) <= 1e-4
    assert (api.detect_speech_samples(track, model=model, device="cuda")
            == api.detect_speech_samples(track, model=model, device="cpu"))


# ---- stream sharding over devices ------------------------------------------
# The shards run the kernels of the unsharded runner on their own rows and
# CUDA streams; each stream's computation does not depend on the batch it is
# in, so the bits are the unsharded runner's.


def _two_cards():
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    return [torch.device("cuda", 0), torch.device("cuda", 1)]


def _sharded_against_unsharded(family, params, devices, batch, chunk, seed):
    from vadc_tpu_torch.engine.runner import StreamRunner
    from vadc_tpu_torch.engine.shard import ShardedStreamRunner

    sharded = ShardedStreamRunner(family, params, devices)
    plain = StreamRunner(family, params, device=devices[0])
    x = speech(batch * 3, chunk=chunk, seed=seed).reshape(batch, 3, chunk).astype(np.float32)
    s_state, p_state = sharded.init_state(batch), plain.init_state(batch)
    ps, _ = sharded.step(x[:, 0], s_state)
    pp, _ = plain.step(x[:, 0], p_state)
    ps2, _ = sharded.scan(x[:, 1:], s_state)
    pp2, _ = plain.scan(x[:, 1:], p_state)
    torch.cuda.synchronize()
    assert torch.equal(ps.cpu(), pp.cpu())
    if p_state.context is not None:
        assert torch.equal(s_state.context.cpu(), p_state.context.cpu())
    got = [ps2.cpu(), s_state.h.cpu(), s_state.c.cpu()]
    want = [pp2.cpu(), p_state.h.cpu(), p_state.c.cpu()]
    if all(torch.equal(g, w) for g, w in zip(got, want)):
        return
    # a v4 slab scan runs its encoder's, and a v4/v5 scan its decoder's,
    # cuBLAS products over each shard's rows, which sum in an order set by
    # the row count
    from vadc_tpu_torch.kernels.tier_check import shard_bound

    bound = shard_bound(family)
    assert bound is not None, f"{family}: the sharded scan misses the unsharded bits"
    assert _max_abs(got[0], want[0]) <= bound["probs"]
    assert max(_max_abs(got[1], want[1]), _max_abs(got[2], want[2])) <= bound["state"]


@pytest.mark.parametrize("family", ["v3", "v4"])
def test_sharded_runner_on_one_card_holds_the_unsharded_bits(params, family_params, device,
                                                             family):
    """Two shards of one card at B=2048: a step equals the unsharded
    runner's bit for bit, and so does a 2-chunk scan of v3.1 (its slab
    route's kernels are per stream); v4's slab scan runs its encoder's and
    decoder's cuBLAS products over each shard's rows and is held to
    tier_check.shard_bound("v4")."""
    p = params if family == "v3" else family_params[family][1]
    _sharded_against_unsharded(family, p, [device, device], 2048, 1536, seed=31)


def test_sharded_v5_on_one_card_is_held_to_its_bounds(family_params, device):
    """v5 on two shards of one card at B=2048: its spectrum and convs'
    kernels give each shard's rows the whole batch's bits; its decoder is a
    torch.matmul product, whose algorithm cuBLAS picks by the number of
    rows, so the step is held to tier_check's SHARD_BOUND and its context
    bit for bit."""
    from vadc_tpu_torch.engine.runner import StreamRunner
    from vadc_tpu_torch.engine.shard import ShardedStreamRunner
    from vadc_tpu_torch.kernels.stft_mag import split_basis_of, stft_magnitude
    from vadc_tpu_torch.kernels.tier_check import SHARD_BOUND
    from vadc_tpu_torch.models import silero_v5

    params = family_params["v5"][1]
    x = torch.from_numpy(speech(2048, chunk=512, seed=37).astype(np.float32)).to(device)
    sharded = ShardedStreamRunner("v5", params, [device, device])
    plain = StreamRunner("v5", params, device=device)
    s_state, p_state = sharded.init_state(2048), plain.init_state(2048)
    ps, _ = sharded.step(x, s_state)
    pp, _ = plain.step(x, p_state)
    torch.cuda.synchronize()
    bound = SHARD_BOUND["v5"]
    assert _max_abs(ps, pp) <= bound["probs"]
    assert max(_max_abs(s_state.h, p_state.h), _max_abs(s_state.c, p_state.c)) <= bound["state"]
    assert torch.equal(s_state.context, p_state.context)
    audio = torch.cat([torch.zeros(2048, silero_v5.CONTEXT_SAMPLES, device=device), x], dim=-1)
    wr, wi = split_basis_of(params)
    kw = dict(pad_left=0, pad_right=silero_v5.STFT_PAD_RIGHT, hop=silero_v5.STFT_HOP)
    whole = stft_magnitude(audio, wr, wi, **kw)
    halves = torch.cat([stft_magnitude(audio[:1024], wr, wi, **kw),
                        stft_magnitude(audio[1024:], wr, wi, **kw)])
    assert torch.equal(whole, halves)


def test_step_on_the_second_card_gives_the_first_cards_bits(params, device):
    """The runners make the tensors' device current for the kernels' C
    entries (runtime.on_device): a v3.1 step on cuda:1, launched while
    cuda:0 is current, equals the same step on cuda:0 bit for bit."""
    from vadc_tpu_torch.engine.runner import StreamRunner

    first, second = _two_cards()
    x = speech(256, seed=32).astype(np.float32)
    out = []
    for dev in (first, second):
        torch.cuda.set_device(first)
        runner = StreamRunner("v3", params, device=dev)
        state = runner.init_state(256)
        probs, _ = runner.step(x, state)
        probs2, _ = runner.scan(x.reshape(64, 4, -1), runner.init_state(64))
        torch.cuda.synchronize(dev)
        out.append([probs.cpu(), state.h.cpu(), state.c.cpu(), probs2.cpu()])
    assert all(torch.equal(a, b) for a, b in zip(*out))


def test_sharded_runner_over_two_cards_holds_the_unsharded_bits(params):
    _sharded_against_unsharded("v3", params, _two_cards(), 2048, 1536, seed=33)


def test_sharded_server_ticks_hold_the_unsharded_bits(device):
    """A server's slots sharded over two shards of the card: _tick and
    _tick2 equal the unsharded server's bit for bit, state included."""
    from vadc_tpu_torch.server import VadServer

    servers = [VadServer(port=0, max_streams=64, model=str(V31_ARCHIVE), devices=devs)
               for devs in ([device], [device, device])]
    try:
        assert [len(s._shards) for s in servers] == [1, 2]
        # a lone shard runs on the caller's stream, two on streams of their own
        assert servers[0].runner.streams == [None]
        assert all(isinstance(s, torch.cuda.Stream) for s in servers[1].runner.streams)
        rng = np.random.default_rng(34)
        n, chunk = 64, servers[0].chunk
        ba = np.clip(speech(n, seed=35) * 32768, -32768, 32767).astype(np.int16)
        bb = (rng.normal(size=(n, chunk)) * 3000).astype(np.int16)
        act_a, act_b, reset = (rng.random(n) < 0.7, rng.random(n) < 0.7, rng.random(n) < 0.2)
        out = []
        for srv in servers:
            p1 = srv._tick(ba, act_a, reset)
            p2 = srv._tick2(bb, ba, act_b, act_a, np.zeros(n, bool))
            out.append((p1, p2, srv.state.h.cpu(), srv.state.c.cpu()))
        (a1, a2, ah, ac), (b1, b2, bh, bc) = out
        np.testing.assert_array_equal(a1, b1)
        np.testing.assert_array_equal(a2, b2)
        assert torch.equal(ah, bh) and torch.equal(ac, bc)
    finally:
        for srv in servers:
            srv.pool.close()


def test_profile_on_the_card_names_the_kernel(params, device, tmp_path):
    """A v3.1 step under tracing.profile writes a trace that names its zone,
    forward_fused, beside the device's kernels."""
    import json

    from vadc_tpu_torch import tracing
    from vadc_tpu_torch.engine.runner import StreamRunner

    runner = StreamRunner("v3", params, device=device)
    state = runner.init_state(64)
    x = speech(64, seed=36).astype(np.float32)
    runner.step(x, state)
    with tracing.profile(str(tmp_path)):
        runner.step(x, state)
        torch.cuda.synchronize()
    (trace,) = list(tmp_path.glob("vadc_trace_*.json"))
    names = {e.get("name") for e in json.loads(trace.read_text())["traceEvents"]}
    assert "forward_fused" in names


def _leads_us(slab_starts: list, kernel_starts: list) -> list:
    """Each encode kernel's lead over the start of its batch.slab span, us
    (kernels and slabs in order, the same count of kernels a slab)."""
    assert slab_starts and kernel_starts and len(kernel_starts) % len(slab_starts) == 0
    per = len(kernel_starts) // len(slab_starts)
    return [1e6 * (slab_starts[k // per] - t) for k, t in enumerate(kernel_starts)]


def _report(label: str, leads: list) -> None:
    q = np.percentile(leads, [0, 50, 100])
    print(f"encode_fused_audio kernels' lead over their batch.slab span ({label}): "
          f"{len(leads)} kernels, min {q[0]:.1f} us, median {q[1]:.1f} us, max {q[2]:.1f} us "
          f"(negative: the kernel starts after the span)")


def test_batch_cli_spans_on_the_card(device, tmp_path, monkeypatch, capsys):
    """With VADC_TPU_PROFILE set, the batch CLI over 4 files writes one trace
    and one counters file (the read bytes, the raw files read straight
    into the slabs, and the columns the segmenter was fed), and the trace
    names the CLI's spans, the ingest's in the order open, pin, read, grid,
    beside the slab kernels; in that trace (the profiler aligns the host's
    ranges and the device's kernels) no encode_fused_audio kernel starts earlier than
    50 us before its batch.slab span. Under the benchmark's device trace
    (CUDA activity only) the recorder is on and records the spans; the
    leads there, by its marker kernel's mapping of the device's clock onto
    time.monotonic, are printed beside the profiler's."""
    import json
    import os
    import re

    from vadbench import harness
    from vadc_tpu_torch import tracing
    from vadc_tpu_torch.cli import batch

    paths = []
    for i, n_chunks in enumerate((150, 120, 90, 61)):
        pcm = np.clip(speech(n_chunks, seed=70 + i).ravel()[: n_chunks * 1536 - 77 * i] * 32768,
                      -32768, 32767).astype("<i2")
        paths.append(str(tmp_path / f"f{i}.s16le"))
        pcm.tofile(paths[-1])
    argv = [*paths, "--slab_chunks", "16"]
    n_slabs = -(-150 // 16)
    kernel = re.compile(r"\bsilero_v31_encode_audio_kernel\b")
    assert batch.main(argv) == 0  # warm: the kernels, the pinned memory
    plain = capsys.readouterr().out

    monkeypatch.setenv("VADC_TPU_PROFILE", str(tmp_path / "trace"))
    assert batch.main(argv) == 0
    monkeypatch.delenv("VADC_TPU_PROFILE")
    assert capsys.readouterr().out == plain and plain
    (trace,) = list((tmp_path / "trace").glob("vadc_trace_*.json"))
    (counters,) = list((tmp_path / "trace").glob("vadc_counters_*.json"))
    assert len(list((tmp_path / "trace").iterdir())) == 2
    events = json.loads(trace.read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    assert {"batch.job", "batch.open", "batch.pin", "batch.read", "batch.grid", "batch.slab",
            "segmenter.feed", "segmenter.finish", "batch.output", "encode_fused_audio"} <= names
    assert json.loads(counters.read_text()) == {
        "batch.read_bytes": sum(os.path.getsize(p) for p in paths),
        "batch.read_direct_files": len(paths), "segmenter.columns": n_slabs * 16}
    ingest = ["batch.open", "batch.pin", "batch.read", "batch.grid"]
    phases = sorted((e["ts"], e["name"]) for e in events
                    if e.get("cat") == "user_annotation" and e.get("name") in ingest)
    assert [name for _ts, name in phases] == ingest
    slabs = sorted(e["ts"] * 1e-6 for e in events
                   if e.get("name") == "batch.slab" and e.get("cat") == "user_annotation")
    kernels = sorted(e["ts"] * 1e-6 for e in events
                     if e.get("cat") == "kernel" and kernel.search(e["name"]))
    assert len(slabs) == n_slabs
    profiled = _leads_us(slabs, kernels)

    tracing.clear()
    dtrace = harness.DeviceTrace(torch.device(device))
    dtrace.warm()
    dtrace.begin()
    on = torch.autograd._profiler_enabled()
    assert batch.main(argv) == 0
    dtrace.end()
    dtrace.collect()
    capsys.readouterr()
    assert on, "the recorder is off under a profiler with CUDA activity only"
    spans = tracing.spans()
    tracing.clear()
    assert {s.name for s in spans} >= {"batch.job", "batch.slab", "segmenter.feed"}
    slabs = sorted(s.start_ns * 1e-9 for s in spans if s.name == "batch.slab")
    assert len(slabs) == n_slabs
    with capsys.disabled():
        _report("profile(), the profiler's alignment", profiled)
        _report("the benchmark's DeviceTrace, its marker's mapping",
                _leads_us(slabs, [t for n, t, _d in dtrace.events if kernel.search(n)]))
    assert max(profiled) < 50.0


def _probe_bf16(rows: int, k: int, n: int, seed: int, device):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(size=(rows, k)).astype(np.float32))
    w = torch.from_numpy((rng.normal(size=(k, n)) / np.sqrt(k)).astype(np.float32))
    return x.to(device, torch.bfloat16), w.to(device, torch.bfloat16)


def test_probe_kernels_at_the_probes_inputs(device):
    from vadc_tpu_torch.kernels.probes import (
        bf16_dot, bf16_dot_wgmma, concat_dot, concat_dot_reference,
    )

    x = torch.full((2, 8, 48), 0.5, dtype=torch.bfloat16, device=device)
    w = torch.full((48, 16), 0.25, dtype=torch.bfloat16, device=device)
    for entry in (bf16_dot, bf16_dot_wgmma):
        before = entry.launches
        out = entry(x, w)
        assert entry.launches == before + 1
        assert out.shape == (2, 8, 16) and out.dtype == torch.float32
        assert bool((out == 6.0).all())
    rng = np.random.default_rng(1)
    xc, hc, wc = (torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(device)
                  for s in ((8, 4, 64), (8, 64), (128, 32)))
    got = concat_dot(xc, 1, hc, wc)
    assert _max_abs(got, concat_dot_reference(xc, 1, hc, wc)) <= 1e-3


@pytest.mark.parametrize("rows", [16, 37, 2048, 4096])
@pytest.mark.parametrize("k,n", [(40, 24), (48, 16), (128, 256), (37, 24), (48, 13)])
def test_probe_kernels_at_seeded_shapes(device, rows, k, n):
    """(37, 24): x's rows (and concat_dot's x[:, t], D = 19, and h, Dh =
    18) off 16 bytes, copied by the kernels' threads; (48, 13): w's and the
    output's."""
    from vadc_tpu_torch.kernels.probes import (
        bf16_dot, bf16_dot_reference, bf16_dot_wgmma, concat_dot,
    )
    from vadc_tpu_torch.nn.precision import matmul_at

    x, w = _probe_bf16(rows, k, n, rows + k, device)
    want = bf16_dot_reference(x, w)
    a, b = bf16_dot(x, w), bf16_dot_wgmma(x, w)
    assert _max_abs(a, want) <= 1e-5 and _max_abs(b, want) <= 1e-5
    assert _max_abs(a, b) <= 1e-5
    rng = np.random.default_rng(rows * k)
    scale = np.float32(1 / np.sqrt(k))
    xc = torch.from_numpy(rng.normal(size=(rows, 3, k - k // 2)).astype(np.float32) * scale)
    hc = torch.from_numpy(rng.normal(size=(rows, k // 2)).astype(np.float32) * scale)
    wc = torch.from_numpy(rng.normal(size=(k, n)).astype(np.float32) * scale)
    xc, hc, wc = xc.to(device), hc.to(device), wc.to(device)
    got = concat_dot(xc, 2, hc, wc)
    assert _max_abs(got, matmul_at(torch.cat([xc[:, 2], hc], -1), wc, "bf16_3x")) <= 1e-5


def test_probe_staging_is_the_c_entries_rule_and_both_ways_agree(device):
    """kernels/probes.py's mirror of the staging rule gives the C entries'
    flags (vadc_*_staging) at aligned and misaligned operands, and the
    kernels meet their plain versions whichever way each operand went."""
    from vadc_tpu_torch.kernels.probes import (
        W_TMA, X_TMA, bf16_dot, bf16_dot_reference, bf16_dot_staging, bf16_dot_wgmma,
        concat_dot, concat_dot_staging, kernel_staging,
    )
    from vadc_tpu_torch.nn.precision import matmul_at

    seen = set()
    x0, _ = _probe_bf16(65, 48, 16, 5, device)
    flat = x0.reshape(-1)
    for x in (flat[:64 * 48].view(64, 48), flat[1:1 + 64 * 48].view(64, 48)):
        for n in (16, 13):
            _, w = _probe_bf16(1, 48, n, n, device)
            out = torch.empty(64, n, device=device)
            flags = bf16_dot_staging(x, w, out)
            assert flags == kernel_staging("bf16_dot", x.data_ptr(), w.data_ptr(), out.data_ptr(),
                                           48, n)
            seen.add(flags & (X_TMA | W_TMA))
            want = bf16_dot_reference(x, w)
            for entry in (bf16_dot, bf16_dot_wgmma):
                assert _max_abs(entry(x, w), want) <= 1e-5
    assert seen == {0, X_TMA, W_TMA, X_TMA | W_TMA}
    rng = np.random.default_rng(9)
    for seq, d, t, dh, n, offset in ((3, 64, 1, 64, 256, 0), (3, 19, 1, 18, 24, 0),
                                     (4, 37, 0, 36, 13, 0), (3, 22, 2, 0, 16, 0),
                                     (3, 64, 1, 64, 32, 1)):
        scale = np.float32(1 / np.sqrt(d + dh))
        flat = torch.from_numpy(rng.normal(size=37 * seq * d + 1).astype(np.float32) * scale)
        x = flat[offset:offset + 37 * seq * d].view(37, seq, d).to(device)
        if offset:
            x = torch.empty(37 * seq * d + 1, device=device)[offset:].view(37, seq, d).copy_(x)
        h = torch.from_numpy(rng.normal(size=(37, dh)).astype(np.float32) * scale).to(device)
        w = torch.from_numpy(rng.normal(size=(d + dh, n)).astype(np.float32) * scale).to(device)
        out = torch.empty(37, n, device=device)
        flags = concat_dot_staging(x, t, h, w, out)
        assert flags == kernel_staging("concat_dot", x.data_ptr(), seq, d, t, h.data_ptr(), dh,
                                       w.data_ptr(), out.data_ptr(), n)
        want = matmul_at(torch.cat([x[:, t], h], -1), w, "bf16_3x")
        assert _max_abs(concat_dot(x, t, h, w), want) <= 1e-5


def test_probe_kernels_refuse_what_they_do_not_take(device):
    from vadc_tpu_torch.kernels.probes import bf16_dot, bf16_dot_wgmma, concat_dot

    x, w = _probe_bf16(16, 48, 16, 0, device)
    for entry in (bf16_dot, bf16_dot_wgmma):
        with pytest.raises(TypeError):
            entry(x.float(), w)
        with pytest.raises(ValueError, match="contraction"):
            entry(*_probe_bf16(16, 264, 16, 0, device))
        with pytest.raises(ValueError, match="contiguous"):
            entry(x, w.t().contiguous().t())
    xc = torch.zeros(4, 3, 64, device=device)
    with pytest.raises(IndexError):
        concat_dot(xc, 3, torch.zeros(4, 64, device=device), torch.zeros(128, 8, device=device))
    with pytest.raises(ValueError):
        concat_dot(xc, 0, torch.zeros(4, 64, device=device), torch.zeros(127, 8, device=device))
