"""The three bf16 precision tiers (balanced, fast, turbo) of the port's
Silero v3.1 path on the CPU, in their plain versions.

The JAX package selects a tier with `precision_mode`, and on the CPU XLA
ignores its matmul precision flags; the port passes the tier as an argument
and emulates the TPU arithmetic (nn/precision.py), so most of a tier's
arithmetic shows on the CPU only in the port. What each test holds, and the
measured maximum on the CPU:

  * the emulated products: bf16 operands against JAX's
    jnp.dot(bf16, bf16, preferred_element_type=f32), 1e-6 of sum |a||b|
    (measured 2.3e-8: the two sum in other orders); bf16_3x against a
    float64 product, 1e-5 of sum |a||b| (measured 2.0e-6, bf16 alone
    1.4e-3);
  * the tier-dependent ops against JAX's under `precision_mode(tier)`, where
    the CPU shows them: tanh and log1p forms 2e-6 (measured 2.4e-7 and
    1.2e-7 relative), the STFT's operands (turbo's cast of audio and basis:
    1e-6 of the peak, measured 3.0e-7; fast and balanced, bf16_3x against
    JAX's fp32 on the CPU: 1e-5 of the peak, measured 4.6e-6), turbo's bf16
    encoder stage 3e-2 of its peak (measured 0.0625 at a peak of 7.2, two
    bf16 ulps);
  * the kernels' plain versions at each tier: forward_fused equal to
    encode_fused_audio + lstm_decoder_fused, and the collapsed
    normalization within 1e-4 of the 7-tap form (measured 9.5e-7), 1e-2 in
    turbo (measured 3.9e-3, one bf16 ulp of a feature);
  * the port's plain forward_fused2d at fast against JAX's
    forward_fused2d(fast=True) in interpret mode, from the same features:
    probabilities 1e-2, h 1e-1 (measured 4.2e-3 and 3.5e-2). The Pallas
    kernel takes the attention's scores and mix as bf16 products too, which
    the JAX package's XLA path, and so the port's tier, sum in fp32; with
    those two taken as the Pallas kernel takes them: 1e-3 and 1e-3
    (measured 1.0e-4 and 1.8e-7);
  * the slice on speech (vadc_tpu/io/synthaudio.py, SPEECH_SEEDS below):
    each tier's StreamRunner.step and .scan and MinibatchRunner against the
    port's faithful output within SPEECH_BOUND (kernels/tier_check.py, which
    chip_smoke.py holds the kernels to as well), and against the JAX
    package's StreamRunner (its scan) and MinibatchRunner at the same tier
    on the CPU within JAX_TIER_BOUND, with the JAX package's segments at the
    tier. The bounds come from the port's own readings over seeds 0-11
    (largest: balanced 1.25e-3, fast 2.38e-2, turbo 1.64e-1 from faithful;
    turbo 3.19e-2 from the JAX package's turbo), not from the one track the
    JAX package recorded on a TPU (seed 0: 5.4e-4, 7.4e-3, 2.7e-2), which
    the port's balanced exceeds there (6.8e-4). Balanced's deviation is its
    bf16_3x spectrum's, which log1p(2^20 x) amplifies at near-zero bins
    (with an fp32 spectrum it reads at most 1.2e-4); turbo's large ones are
    its bf16 spectrum's (seed 3: 1.64e-1, 4.0e-2 with an fp32 spectrum),
    and the JAX package's own turbo reads 1.32e-1 there. On seeds 1 and 6
    turbo moves one segment's start by one chunk, as the JAX package's own
    turbo does.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.conftest import assert_close
from tests.torch_port_util import jax_and_port_params, noise, speech
from tests.torch_port_util import single_torch_thread  # noqa: F401
from tests.torch_port_util import to_torch as _t
from vadc_tpu.engine import runner as JR
from vadc_tpu.models import silero_v31 as JM
from vadc_tpu.nn import functional as JF
from vadc_tpu_torch.cli.segmenter import Segmenter, SegmenterConfig
from vadc_tpu_torch.engine import runner as TR
from vadc_tpu_torch.kernels import silero_v31_fused as KF
from vadc_tpu_torch.kernels import silero_v31_fused2d as K2
from vadc_tpu_torch.kernels import stft_dotmag as KD
from vadc_tpu_torch.kernels.lstm_decoder import lstm_decoder_fused_reference
from vadc_tpu_torch.kernels.tier_check import SPEECH_BOUND
from vadc_tpu_torch.models import silero_v31 as TM
from vadc_tpu_torch.nn import functional as TF
from vadc_tpu_torch.nn import precision as P

TIERS = ("balanced", "fast", "turbo")
#: the port at a tier against the JAX package at the tier on the CPU, where
#: JAX computes balanced's and fast's products in fp32 (so those read as
#: from faithful) and turbo's bf16 spectrum and storage as the port does
#: (turbo read 3.19e-2 at most over seeds 0-11)
JAX_TIER_BOUND = {**SPEECH_BOUND, "turbo": 4e-2}
#: the port's plain forward_fused2d at fast against JAX's fast Pallas kernel
FUSED2D_TOL = {"probs": 1e-2, "h": 1e-1, "probs, Pallas attention": 1e-3,
               "h, Pallas attention": 1e-3}
#: the material of the whole-slice tests, the JAX package's generator: seed
#: 0, the track behind the JAX package's recorded deviations; seed 3, the
#: largest deviations of fast and turbo over seeds 0-11; seeds 1 and 6, the
#: tracks on which turbo's segments move
SPEECH_SEEDS = (0, 1, 3, 6)


@pytest.fixture(scope="module")
def params():
    return jax_and_port_params()


def _rand(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).normal(size=shape)).astype(np.float32)


def _scaled_err(got, want, a, b):
    """max |got - want| over the matching entry of |a| @ |b|."""
    scale = np.abs(a.astype(np.float64)) @ np.abs(b.astype(np.float64))
    return float(np.max(np.abs(np.asarray(got, np.float64) - want) / scale))


def test_bf16_products_match_jax_bf16_dot():
    a, b = _rand((7, 50), 0, 3.0), _rand((50, 9), 1)
    got = P.matmul_at(_t(a), _t(b), "bf16").numpy()
    want = np.asarray(jnp.dot(jnp.asarray(a).astype(jnp.bfloat16), jnp.asarray(b).astype(jnp.bfloat16),
                              preferred_element_type=jnp.float32))
    assert _scaled_err(got, want, a, b) < 1e-6
    # the operands are rounded: a bf16 product differs from the fp32 one
    assert not np.array_equal(got, P.matmul_at(_t(a), _t(b), "fp32").numpy())


def test_bf16_3x_products_match_float64():
    a, b = _rand((7, 50), 2, 3.0), _rand((50, 9), 3)
    exact = a.astype(np.float64) @ b.astype(np.float64)
    err_3x = _scaled_err(P.matmul_at(_t(a), _t(b), "bf16_3x").numpy(), exact, a, b)
    err_1x = _scaled_err(P.matmul_at(_t(a), _t(b), "bf16").numpy(), exact, a, b)
    assert err_3x < 1e-5 and err_3x < err_1x / 10


@pytest.mark.parametrize("mode", ["fp32", "bf16", "bf16_3x"])
def test_packed_weights_decode_to_the_tiers_operands(mode):
    """The words the kernels read (csrc/tier.cuh: packed_hi, packed_lo)."""
    w = _t(_rand((64, 33), 4, 2.0))
    words = P.pack_operand(w, mode).view(torch.int32)
    hi = (words & -65536).view(torch.float32)
    lo = (words << 16).view(torch.float32)
    if mode == "fp32":
        assert torch.equal(words.view(torch.float32), w)
    elif mode == "bf16":
        assert torch.equal(hi, P.bf16(w)) and torch.equal(words.view(torch.float32), P.bf16(w))
        assert not lo.any()
    else:
        want_hi, want_lo = P.split(w)
        assert torch.equal(hi, want_hi) and torch.equal(lo, want_lo)


@pytest.mark.parametrize("tier", ["faithful", *TIERS])
def test_tanh_and_log1p_follow_the_jax_tiers(tier):
    x = _rand((4000,), 5, 4.0)
    y = np.abs(_rand((4000,), 6, 1e3)) * np.logspace(-8, 0, 4000, dtype=np.float32)
    with JF.precision_mode(tier):
        tanh_j, log1p_j = np.asarray(JF._tanh(jnp.asarray(x))), np.asarray(JF._log1p(jnp.asarray(y)))
    t = P.tier_of(tier)
    assert_close(P.tanh_at(_t(x), t), tanh_j, 2e-6, f"{tier} tanh")
    assert_close(TF.log1p_at(_t(y), t) / _t(np.maximum(log1p_j, 1.0)),
                 log1p_j / np.maximum(log1p_j, 1.0), 2e-6, f"{tier} log1p")
    # the forms differ: the exp form at faithful and balanced, the builtin else
    assert t.exp_tanh == (tier in ("faithful", "balanced"))
    assert t.series_log1p == (tier == "faithful")


@pytest.mark.parametrize("tier", TIERS)
def test_stft_operands_follow_the_cast_rule(params, tier):
    """Turbo casts audio and basis to bf16 (JAX's `_stft_precision`:
    cast_bf16); fast and balanced keep fp32 samples at bf16_3x, which the
    CPU's JAX computes in fp32."""
    jp, tp = params
    audio = speech(3, seed=1)
    with JF.precision_mode(tier):
        want = np.asarray(JF.stft_magnitude_nlc(jnp.asarray(audio), jp["stft_basis"], pad_left=128,
                                                pad_right=128, hop=64))
    t = P.tier_of(tier)
    got = TF.stft_magnitude_nlc(_t(audio), tp["stft_basis"], pad_left=128, pad_right=128, hop=64,
                                tier=t)
    peak = float(np.abs(want).max())
    assert_close(got / peak, want / peak, 1e-6 if tier == "turbo" else 1e-5, f"{tier} stft")
    # dot_magnitude's plain version is the same product
    frames = TF.frame(TF.reflect_pad_last(_t(audio), 128, 128), 256, 64)
    wr, wi = KD.split_basis(tp["stft_basis"])
    assert torch.equal(KD.dot_magnitude(frames, wr, wi, tier), got)


def test_turbo_stores_the_encoder_in_bf16_as_jax_does(params):
    jp, tp = params
    audio = speech(4, seed=2)
    with JF.precision_mode("turbo"):
        x_j = JF.adaptive_audio_normalization_nlc(
            JF.stft_magnitude_nlc(jnp.asarray(audio), jp["stft_basis"], pad_left=128,
                                  pad_right=128, hop=64))
        y_j = JF.transformer_layer_nlc(x_j, jp["layers"][0], stride=2)
    assert x_j.dtype == jnp.bfloat16 and y_j.dtype == jnp.bfloat16
    x = _t(np.asarray(x_j.astype(jnp.float32)))
    y = TF.transformer_layer_nlc(x, tp["layers"][0], stride=2, tier=P.TURBO)
    assert torch.equal(P.bf16(y), y)  # every stored value is a bf16 value
    want = np.asarray(y_j.astype(jnp.float32))
    assert_close(y, want, 3e-2 * max(1.0, float(np.abs(want).max())), "turbo stage 1")
    # the tiers that store fp32 do not round
    y_fast = TF.transformer_layer_nlc(x, tp["layers"][0], stride=2, tier=P.FAST)
    assert not torch.equal(P.bf16(y_fast), y_fast)


def test_fused2d_fast_matches_jax_fast_kernel(params, monkeypatch):
    """The port's plain forward_fused2d at fast against JAX's
    forward_fused2d(fast=True) under precision_mode('fast') in interpret
    mode, both from JAX's fast-tier features. The Pallas kernel also takes
    the attention's scores and mix as bf16 products, which the JAX
    package's XLA path, and so the port's tier, sum in fp32: with those two
    products taken as the Pallas kernel takes them, the rest agrees to the
    rare bf16 rounding flip."""
    from vadc_tpu.kernels.silero_v31_fused2d import forward_fused2d

    jp, tp = params
    batch = 8
    audio = jnp.asarray(speech(48, seed=3)[::6])  # chunks spread over speech and pauses
    h0, c0 = JM.init_state(batch)
    _, h, c = jax.jit(JM.forward)(jp, jnp.asarray(noise(batch, seed=4)), h0, c0)
    with JF.precision_mode("fast"):
        p_j, h_j, c_j = forward_fused2d(jp, audio, h, c, block_streams=batch, fast=True)
        feats = JF.adaptive_audio_normalization_nlc(
            JF.stft_magnitude_nlc(audio, jp["stft_basis"], pad_left=128, pad_right=128, hop=64))
    p, hn, cn = K2.forward_fused2d_reference(tp, _t(feats), _t(h), _t(c), P.FAST)
    assert_close(p, p_j, FUSED2D_TOL["probs"], "fast probs")
    assert_close(hn, h_j, FUSED2D_TOL["h"], "fast h")
    # the wrapper on a CPU tensor is the same plain version, by name too
    got = K2.forward_fused2d(tp, _t(feats), _t(h), _t(c), tier="fast")
    assert torch.equal(got[0], p) and torch.equal(got[1], hn)

    def pallas_attention(x, qkv_w, qkv_b, proj_w, proj_b, *, n_heads=2, tier=P.FAITHFUL):
        bsz, seq, dim = x.shape
        hd = dim // n_heads
        qkv = TF.linear_at(x, qkv_w, qkv_b, tier)
        q, k, v = (t.reshape(bsz, seq, n_heads, hd).transpose(1, 2) for t in qkv.split(dim, -1))
        alpha = torch.softmax(P.matmul_at(k, q.transpose(-1, -2), tier.products) / hd ** 0.5, -1)
        out = P.matmul_at(alpha, v, tier.products).transpose(1, 2).reshape(bsz, seq, dim)
        return TF.linear_at(out, proj_w, proj_b, tier)

    monkeypatch.setattr(TF, "attention", pallas_attention)
    p, hn, cn = K2.forward_fused2d_reference(tp, _t(feats), _t(h), _t(c), P.FAST)
    assert_close(p, p_j, FUSED2D_TOL["probs, Pallas attention"], "fast probs, Pallas attention")
    assert_close(hn, h_j, FUSED2D_TOL["h, Pallas attention"], "fast h, Pallas attention")


@pytest.mark.parametrize("tier", TIERS)
def test_kernel_plain_versions_agree_at_the_tier(params, tier):
    """The kernels' plain versions at a tier compose as the kernels do:
    forward_fused = encode_fused_audio + lstm_decoder_fused, and the
    collapsed normalization equals the 7-tap form to rounding."""
    _, tp = params
    t = P.tier_of(tier)
    audio = _t(speech(4, seed=5))
    h, c = TM.init_state(4)
    probs, hn, cn = KF.forward_fused_reference(tp, audio, h, c, t)
    enc = KF.encode_fused_audio_reference(tp, audio, t)
    p2, h2, c2 = lstm_decoder_fused_reference(enc, h, c, tp["lstm_w"], tp["lstm_b"], tp["dec_w"],
                                              tp["dec_b"], t)
    assert torch.equal(probs, p2) and torch.equal(hn, h2) and torch.equal(cn, c2)
    feats = KF.features_reference(tp, audio, t)
    want = TF.adaptive_audio_normalization_nlc(
        TF.stft_magnitude_nlc(audio, tp["stft_basis"], pad_left=128, pad_right=128, hop=64, tier=t),
        t)
    # turbo's features are bf16 values: a rounding flip is one bf16 ulp
    assert_close(feats, want, 1e-2 if tier == "turbo" else 1e-4, f"{tier} features")


def _segments(probs) -> list:
    seg = Segmenter(SegmenterConfig.from_ms(chunk_samples=1536, sample_rate=16000))
    out = []
    for p in np.asarray(probs, np.float64):
        out.extend(seg.feed(float(p)))
    return out + list(seg.finish())


@pytest.fixture(scope="module", params=SPEECH_SEEDS, ids=lambda seed: f"seed{seed}")
def streams(request):
    """One stream of synthetic speech, the whole track of four utterances
    of vadc_tpu.io.synthaudio.utterance_track(4, seed): [1, N, 1536]."""
    from vadc_tpu.io.synthaudio import utterance_track

    track, _ = utterance_track(4, seed=request.param)
    n = len(track) // 1536
    return track[: n * 1536].reshape(1, n, 1536).astype(np.float32)


@pytest.fixture(scope="module")
def runs(params, streams):
    """tier -> the port's step-loop, scan and window probabilities on
    `streams`, each computed once."""
    _, tp = params
    return {tier: _runs(tp, streams, tier) for tier in ("faithful", *TIERS)}


def _runs(tp, streams, tier):
    runner = TR.StreamRunner("v3", tp, device="cpu", precision=tier)
    state = runner.init_state(streams.shape[0])
    steps = torch.stack([runner.step(streams[:, k], state)[0] for k in range(streams.shape[1])], 1)
    scan, _ = runner.scan(streams, runner.init_state(streams.shape[0]))
    mb = TR.MinibatchRunner("v3", tp, batch_size=96, chunk_samples=1536, device="cpu",
                            precision=tier)
    window = torch.tensor(mb.process_window(streams[0].reshape(-1)))
    return {"step": steps, "scan": scan, "window": window[None]}


def _jax_runs(jp, streams, tier):
    """The JAX package's scan and window probabilities at the tier on the
    CPU, as numpy [1, N]."""
    jr = JR.StreamRunner("v3", jp, precision=tier)
    p_j, _ = jr.scan(jnp.asarray(streams), jr.init_state(streams.shape[0]))
    jm = JR.MinibatchRunner("v3", jp, batch_size=96, chunk_samples=1536, precision=tier)
    return np.asarray(p_j), np.asarray(jm.process_window(streams[0].reshape(-1)))[None]


@pytest.mark.parametrize("tier", TIERS)
def test_tier_on_speech_stays_within_the_jax_deviation_of_faithful(runs, tier):
    faithful = runs["faithful"]
    for route, probs in runs[tier].items():
        want = faithful[route]
        assert_close(probs, want, SPEECH_BOUND[tier], f"{tier} {route}")
        if tier != "turbo":  # turbo's segments: the JAX package's, held below
            for s in range(probs.shape[0]):
                assert _segments(probs[s]) == _segments(want[s]), f"{tier} {route} stream {s}"
        assert not torch.equal(probs, want)  # the tier is not faithful in disguise
    assert len(_segments(faithful["step"][0])) >= 3  # there is speech


@pytest.mark.parametrize("tier", TIERS)
def test_tier_runners_match_the_jax_runner_at_the_tier(params, streams, runs, tier):
    """The port's StreamRunner (step loop and scan) and MinibatchRunner
    against the JAX package's at the same tier (on the CPU, where the JAX
    package's products run in fp32), with the JAX package's segments at the
    tier: at turbo on seeds 1 and 6 they differ from faithful's by one
    segment's start, one chunk earlier, in both packages."""
    jp, _ = params
    p_j, w_j = _jax_runs(jp, streams, tier)
    got = runs[tier]
    for route in ("step", "scan"):
        assert_close(got[route], p_j, JAX_TIER_BOUND[tier], f"{tier} {route} vs JAX")
    assert_close(got["window"], w_j, JAX_TIER_BOUND[tier], f"{tier} window vs JAX")
    for route, want in (("step", p_j), ("scan", p_j), ("window", w_j)):
        for s in range(streams.shape[0]):
            assert _segments(got[route][s]) == _segments(want[s]), f"{tier} {route} vs JAX"


def test_the_smoothing_product_stays_fp32_at_every_tier(params, monkeypatch):
    """Why the adaptive normalization's 7-tap smoothing is not a product at
    the tier (nn/precision.py): on the material the JAX package recorded its
    fast-tier deviation on with a TPU (utterance_track(4, seed=0), 7.4e-3),
    the port's fast tier (its plain JAX-style path) measures 7.4e-3 with the
    smoothing in fp32, and 2.5e-2 with its operands at bf16."""
    from vadc_tpu.io.synthaudio import utterance_track

    _, tp = params
    track, _ = utterance_track(4, seed=0)
    n = len(track) // 1536
    audio = _t(track[: n * 1536].reshape(n, 1536))
    h, c = TM.init_state(1)

    def probs(tier):
        return TM.forward_minibatched_reference(tp, audio, h, c, tier)[0]

    faithful = probs("faithful")
    fp32_taps = float((probs("fast") - faithful).abs().max())
    smooth = TF.adaptive_audio_normalization_nlc

    def bf16_taps(spect, tier=P.FAITHFUL):
        taps = torch.tensor(TF.ADAPTIVE_NORM_FILTER)
        spect_e = TF.log1p_at(spect * 1048576.0, tier)
        mean = TF.reflect_pad_last(torch.mean(spect_e, dim=-1), 3, 3)
        smoothed = P.matmul_at(TF.frame(mean, 7, 1), taps, tier.products)
        return P.store(spect_e - torch.mean(smoothed, dim=-1)[:, None, None], tier)

    monkeypatch.setattr(TF, "adaptive_audio_normalization_nlc", bf16_taps)
    at_bf16 = float((probs("fast") - faithful).abs().max())
    monkeypatch.setattr(TF, "adaptive_audio_normalization_nlc", smooth)
    assert fp32_taps < 1e-2 and at_bf16 > 2e-2, (fp32_taps, at_bf16)
