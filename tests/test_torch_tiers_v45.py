"""The three bf16 precision tiers (balanced, fast, turbo) of the port's
Silero v4 (16 and 8 kHz) and v5 (16 and 8 kHz) paths on the CPU, in their
plain versions, against the JAX package's model code under
`precision_mode` and against the port's own faithful tier.

On the CPU the JAX package computes its products in fp32 at every tier
(XLA drops the precision flags there), but its casts to bf16 are real: v5's
spectrum from fast on, and at turbo every spectrum and the bf16-stored
encoder. The port emulates the TPU arithmetic the JAX package documents
(nn/precision.py). What each test holds, and the measured maximum on the
CPU:

  * `stft_mode` is the JAX package's `_stft_precision`, for every tier and
    both kinds of spectrum (exact);
  * the spectrum at the tier against JAX's: where the operands are bf16
    (v5 from fast on, v4 at turbo) 1e-6 of the peak (measured 3.6e-7: the
    two sum exact products in other orders); where they are bf16_3x (v4 at
    balanced and fast, v5 at balanced), which JAX computes in fp32 on the
    CPU, 1e-5 of the peak (measured 4.4e-6); and the stft_magnitude
    kernel's plain version at the mode IS that function (torch.equal);
  * the ops a tier changes against JAX's under `precision_mode`: v5's
    conv1d_nlc, a v4 conv stage with batch norm and decoder_v5_nlc. Turbo,
    where both round to bf16, within two bf16 ulps of the peak, 8e-3
    (measured 0: the same bits); fast, bf16 operands against JAX's fp32
    products, within 2^-8 of the products' absolute sum (measured 8.1e-4
    on the conv, 1.6e-4 on the decoder through its sigmoid) and 3e-2 of the
    peak through a whole stage (measured 8.7e-3); balanced within 1e-5 of
    the products' sum (measured 1.9e-6) and 5e-5 of the peak through a
    stage (measured 1.4e-5). Every value turbo stores is a bf16 value; fast
    stores fp32;
  * the kernels' plain versions at each tier: lstm_hoisted_reference (the
    resident variant's order) against F.lstm at the tier over 24 steps, y,
    h and c (c relative to its largest value): 1e-4 at fast and turbo
    (measured 9.7e-6: the sums differ in order, and a 1e-7 difference can
    flip an operand's bf16 rounding), 1e-5 at balanced (measured 2.8e-6);
  * the slice on speech (vadc_tpu/io/synthaudio.py): v4 (official
    weights) on seeds 0, 1, 3 and 6 as tests/test_torch_tiers.py runs
    v3.1, v4_8k, v5 and v5_8k (synthetic weights) on seed 0: each tier's
    StreamRunner.step and .scan and MinibatchRunner against the port's
    faithful output within kernels/tier_check.py's SPEECH_BOUND for the
    family (the survey's readings over seeds 0-11 rounded up:
    tests/torch_tier_survey.py), with faithful's segments at balanced and
    fast, and against the JAX package's runners at the tier within
    JAX_TIER_BOUND, with the JAX package's segments at the tier (turbo
    moves v4's segments on seed 0, in both packages). The survey shows the
    tracks where the two packages' fast segments differ for v5 (seeds 3, 7
    and 10 of twelve: on the CPU the JAX package's fast products are fp32,
    the port's bf16; random weights put many chunks near the threshold);
    seed 0 is none of them;
  * the CLI with the v4 archive at each tier prints the JAX CLI's lines at
    the tier.
"""

import io
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import lax

from tests.conftest import assert_close
from tests.torch_port_util import DATA, single_torch_thread  # noqa: F401
from tests.torch_port_util import to_torch as _t
from tests.torch_tier_survey import GEOMETRY, family_params, segments, track, with_context
from vadc_tpu.engine import runner as JR
from vadc_tpu.models import silero_v4 as J4
from vadc_tpu.nn import functional as JF
from vadc_tpu_torch.engine import runner as TR
from vadc_tpu_torch.kernels import lstm as KL
from vadc_tpu_torch.kernels import stft_mag as KS
from vadc_tpu_torch.kernels.tier_check import PATH_MAX, SPEECH_BOUND
from vadc_tpu_torch.models import silero_v4 as T4
from vadc_tpu_torch.nn import functional as TF
from vadc_tpu_torch.nn import precision as P

TIERS = ("balanced", "fast", "turbo")
FAMILIES = ("v4", "v4_8k", "v5", "v5_8k")
#: (pad_left, pad_right, hop) of each family's spectrum
STFT = {"v4": (96, 96, 64), "v4_8k": (96, 96, 64), "v5": (0, 64, 128), "v5_8k": (0, 32, 64)}
#: the port at a tier against the JAX package at the tier on the CPU: at
#: balanced and fast the JAX package's products are fp32, so those read as
#: from faithful (SPEECH_BOUND); at turbo both round the spectrum and the
#: encoder to bf16, and the survey's largest readings (v4 2.2e-3, v4_8k
#: 3.6e-3, v5 8.0e-3, v5_8k 5.2e-3) are rounded up
JAX_TIER_BOUND = {family: {**SPEECH_BOUND[family], "turbo": turbo}
                  for family, turbo in (("v4", 5e-3), ("v4_8k", 5e-3), ("v5", 1e-2),
                                        ("v5_8k", 1e-2))}
SPEECH_CASES = (("v4", 0), ("v4", 1), ("v4", 3), ("v4", 6), ("v4_8k", 0), ("v5", 0), ("v5_8k", 0))
WINDOW = 96  # MinibatchRunner's batch: the CLI's window


@pytest.fixture(scope="module")
def params():
    """family -> (JAX param tree, the port's), from the same archive."""
    return {family: family_params(family) for family in FAMILIES}


def _rand(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).normal(size=shape)).astype(np.float32)


@pytest.mark.parametrize("log_sensitive", [True, False], ids=["v3-v4", "v5"])
@pytest.mark.parametrize("tier", ["faithful", *TIERS])
def test_stft_mode_follows_the_jax_stft_precision(tier, log_sensitive):
    with JF.precision_mode(tier):
        precision, cast = JF._stft_precision(log_sensitive)
    modes = {lax.Precision.HIGHEST: "fp32", lax.Precision.HIGH: "bf16_3x"}
    want = "bf16" if cast else modes[precision]
    assert P.stft_mode(P.tier_of(tier), log_sensitive) == want


@pytest.mark.parametrize("tier", TIERS)
@pytest.mark.parametrize("family", FAMILIES)
def test_stft_operands_follow_the_cast_rule(params, family, tier):
    jp, tp = params[family]
    pad_left, pad_right, hop = STFT[family]
    log_sensitive = family.startswith("v4")
    ctx = GEOMETRY[family][2]
    audio = with_context(track(family, 1)[0][40:44], ctx)  # four chunks of a voiced span
    with JF.precision_mode(tier):
        want = np.asarray(JF.stft_magnitude_nlc(jnp.asarray(audio), jp["stft_basis"],
                                                pad_left=pad_left, pad_right=pad_right, hop=hop,
                                                log_sensitive=log_sensitive))
    t = P.tier_of(tier)
    got = TF.stft_magnitude_nlc(_t(audio), tp["stft_basis"], pad_left=pad_left,
                                pad_right=pad_right, hop=hop, tier=t, log_sensitive=log_sensitive)
    mode = P.stft_mode(t, log_sensitive)
    peak = float(np.abs(want).max())
    assert_close(got / peak, want / peak, 1e-6 if mode == "bf16" else 1e-5, f"{family} {tier} stft")
    # the stft_magnitude kernel's plain version at the mode, and its wrapper
    # on a CPU tensor, are the same function
    wr, wi = KS.split_basis_of(tp)
    kw = dict(pad_left=pad_left, pad_right=pad_right, hop=hop, mode=mode)
    assert torch.equal(KS.stft_magnitude_reference(_t(audio), wr, wi, **kw), got)
    assert torch.equal(KS.stft_magnitude(_t(audio), wr, wi, **kw), got)
    if mode != "fp32":  # the operands are rounded: not the fp32 spectrum
        assert not torch.equal(got, KS.stft_magnitude_reference(_t(audio), wr, wi, **{
            **kw, "mode": "fp32"}))


def test_stft_magnitude_refuses_an_unknown_mode(params):
    _, tp = params["v4"]
    wr, wi = KS.split_basis_of(tp)
    with pytest.raises(ValueError, match="unknown mode"):
        KS.stft_magnitude(torch.zeros(1, 1536), wr, wi, pad_left=96, pad_right=96, hop=64,
                          mode="tf32")


def _products_sum(x: np.ndarray, w: np.ndarray, stride: int) -> np.ndarray:
    """sum over the taps of |x_tap| @ |w_tap|.T: the scale of conv1d_nlc's
    rounding (x [B, L, C] padded by 1, w [O, C, K])."""
    xp = np.abs(np.pad(x, ((0, 0), (1, 1), (0, 0))).astype(np.float64))
    k = w.shape[-1]
    out_len = (xp.shape[1] - k) // stride + 1
    return sum(xp[:, tap : tap + (out_len - 1) * stride + 1 : stride] @ np.abs(w[:, :, tap]).T
               for tap in range(k))


@pytest.mark.parametrize("tier", TIERS)
def test_conv1d_at_the_tier_matches_jax(params, tier):
    """v5's second conv (128 -> 64, stride 2) on a ReLU'd input."""
    jp, tp = params["v5"]
    t = P.tier_of(tier)
    x = np.maximum(_rand((3, 9, 128), 0, 2.0), 0.0)
    if t.bf16_storage:  # turbo's conv input is a stored bf16 activation
        x = P.bf16(_t(x)).numpy()
    w, b = tp["encoder"][1]["w"], tp["encoder"][1]["b"]
    with JF.precision_mode(tier):
        x_j = jnp.asarray(x).astype(jnp.bfloat16 if t.bf16_storage else jnp.float32)
        want = JF.conv1d_nlc(x_j, jp["encoder"][1]["w"], jp["encoder"][1]["b"], stride=2,
                             padding=1)
    assert (want.dtype == jnp.bfloat16) == t.bf16_storage
    want = np.asarray(want.astype(jnp.float32), np.float64)
    got = TF.conv1d_nlc(_t(x), w, b, stride=2, padding=1, tier=t)
    err = np.abs(got.numpy() - want)
    if t.bf16_storage:
        assert torch.equal(P.bf16(got), got)  # every stored value is a bf16 value
        assert err.max() <= 8e-3 * np.abs(want).max(), err.max() / np.abs(want).max()
    else:
        scaled = float((err / _products_sum(x, w.numpy(), 2)).max())
        assert scaled <= (2.0 ** -8 if t.products == "bf16" else 1e-5), scaled
        assert not torch.equal(P.bf16(got), got)


def _stage_with_bn(stage: dict, seed: int, like) -> dict:
    """A v4 stage with a batch norm of seeded statistics (the bundled
    archive's stages have it folded into the 1x1 conv)."""
    rng = np.random.default_rng(seed)
    channels = stage["conv_b"].shape[0]
    bn = {"bn_mean": 0.1 * rng.normal(size=channels), "bn_var": rng.uniform(0.5, 2.0, channels),
          "bn_w": rng.uniform(0.5, 1.5, channels), "bn_b": 0.1 * rng.normal(size=channels)}
    return {**stage, **{k: like(np.asarray(v, np.float32)) for k, v in bn.items()}}


@pytest.mark.parametrize("tier", TIERS)
def test_v4_conv_stage_with_batch_norm_matches_jax(params, tier):
    """v4's first stage (258 -> 16 channels, stride 2) with a batch norm, on
    the normalized features of speech at the tier."""
    jp, tp = params["v4"]
    t = P.tier_of(tier)
    audio = _t(track("v4", 1)[0][40:44])
    spect = TF.stft_magnitude_nlc(audio, tp["stft_basis"], pad_left=96, pad_right=96, hop=64,
                                  tier=t)
    x = torch.cat([P.store(spect, t), TF.adaptive_audio_normalization_nlc(spect, t)], dim=-1)
    p_t = _stage_with_bn(tp["stages"][0], 5, torch.from_numpy)
    p_j = _stage_with_bn(jp["stages"][0], 5, jnp.asarray)
    with JF.precision_mode(tier):
        x_j = jnp.asarray(x.numpy()).astype(jnp.bfloat16 if t.bf16_storage else jnp.float32)
        want = J4.conv_stage(x_j, p_j, stride=2)
    want = np.asarray(want.astype(jnp.float32))
    got = T4.conv_stage(x, p_t, stride=2, tier=t)
    peak = float(np.abs(want).max())
    tol = {"balanced": 5e-5, "fast": 3e-2, "turbo": 8e-3}[tier]
    assert_close(got / peak, want / peak, tol, f"{tier} stage")
    assert torch.equal(P.bf16(got), got) == t.bf16_storage


@pytest.mark.parametrize("tier", TIERS)
@pytest.mark.parametrize("family", ["v4", "v5"])
def test_decoder_at_the_tier_matches_jax(params, family, tier):
    jp, tp = params[family]
    t = P.tier_of(tier)
    hidden = tp["dec_w"].shape[1]
    out = _rand((5, 4, hidden), 3)
    with JF.precision_mode(tier):
        want = np.asarray(JF.decoder_v5_nlc(jnp.asarray(out), jp["dec_w"], jp["dec_b"]), np.float64)
    got = TF.decoder_v5_nlc(_t(out), tp["dec_w"], tp["dec_b"], t).numpy()
    # the H -> 1 product's rounding, through the sigmoid (slope <= 1/4)
    scale = 0.25 * float((np.maximum(out, 0) @ np.abs(tp["dec_w"].numpy()).T).max())
    err = float(np.abs(got - want).max()) / scale
    assert err <= (2.0 ** -8 if t.products == "bf16" else 1e-5), err
    assert not np.array_equal(got, TF.decoder_v5_nlc(_t(out), tp["dec_w"], tp["dec_b"]).numpy())


@pytest.mark.parametrize("tier", TIERS)
@pytest.mark.parametrize("family", ["v4", "v5"])
def test_lstm_plain_versions_agree_at_the_tier(params, family, tier):
    """lstm_hoisted_reference (the resident variant's order) against F.lstm
    at the tier, from a carried state over 24 steps; the wrapper on a CPU
    tensor is lstm_fused_reference at the tier."""
    _, tp = params[family]
    t = P.tier_of(tier)
    layers, hidden = tp["lstm_w"].shape[0], tp["lstm_w"].shape[2] // 2
    x = _t(np.maximum(_rand((6, 24, hidden), 7, 2.0), 0.0))
    h, c = _t(_rand((layers, 6, hidden), 8, 0.3)), _t(_rand((layers, 6, hidden), 9, 2.0))
    w, b = tp["lstm_w"], tp["lstm_b"]
    want = TF.lstm(x, h, c, w, b, t)
    got = KL.lstm_hoisted_reference(x, h, c, w, b, t)
    bound = 1e-5 if t.products == "bf16_3x" else 1e-4
    c_scale = max(1.0, float(want[2].abs().max()))  # c relative to its largest value
    for name, g, r in zip(("y", "h", "c"), got, want):
        scale = c_scale if name == "c" else 1.0
        assert_close(g / scale, r / scale, bound, f"{family} {tier} {name}")
    wrapper = KL.lstm_fused(x, h, c, w, b, tier=t)
    plain = KL.lstm_fused_reference(x, h, c, w, b, t)
    assert all(torch.equal(a, r) for a, r in zip(wrapper, plain))
    assert not torch.equal(wrapper[0], KL.lstm_fused_reference(x, h, c, w, b)[0])


# ---- the slice on speech --------------------------------------------------


@pytest.fixture(scope="module", params=SPEECH_CASES, ids=lambda c: f"{c[0]}-seed{c[1]}")
def case(request, params):
    """(family, the JAX tree, the port's, one stream of the speech track
    [1, N, chunk])."""
    family, seed = request.param
    jp, tp = params[family]
    return family, jp, tp, track(family, seed)


@pytest.fixture(scope="module")
def runs(case):
    """tier -> the port's step-loop, scan and window probabilities, each
    [1, N], computed once."""
    family, _, tp, chunks = case
    out = {}
    for tier in ("faithful", *TIERS):
        runner = TR.StreamRunner(family, tp, device="cpu", precision=tier)
        state = runner.init_state(1)
        steps = torch.stack([runner.step(chunks[:, k], state)[0]
                             for k in range(chunks.shape[1])], 1)
        scan, _ = runner.scan(chunks, runner.init_state(1))
        mb = TR.MinibatchRunner(family, tp, batch_size=WINDOW, chunk_samples=chunks.shape[2],
                                device="cpu", precision=tier)
        window = torch.tensor(mb.process_window(chunks[0].reshape(-1)))[None]
        out[tier] = {"step": steps, "scan": scan, "window": window}
    return out


@pytest.mark.parametrize("tier", TIERS)
def test_tier_on_speech_stays_within_the_bound_of_faithful(case, runs, tier):
    family = case[0]
    faithful = runs["faithful"]
    for route, probs in runs[tier].items():
        want = faithful[route]
        assert_close(probs, want, SPEECH_BOUND[family][tier], f"{family} {tier} {route}")
        if tier != "turbo":  # turbo's segments: the JAX package's, held below
            assert segments(probs[0], family) == segments(want[0], family), f"{tier} {route}"
        assert not torch.equal(probs, want)  # the tier is not faithful in disguise
    # the slab scan (models/slab.py) is the loop of steps' arithmetic over
    # other row counts: its encoder over pieces of 8 chunks, its decoder over
    # the track. v4 reads within 1e-6 of the loop; v5's products over a
    # piece's rows sum in another order than over one chunk's, and a bf16
    # rounding flip carries on through the recurrence: 1.0e-5 at balanced,
    # 8.1e-4 at fast and 7.0e-4 at turbo, held as tier_check holds paths that
    # sum in other orders (PATH_MAX)
    assert_close(runs[tier]["scan"], runs[tier]["step"], PATH_MAX[tier]["probs"],
                 f"{family} {tier} scan vs steps")
    assert len(segments(faithful["step"][0], family)) >= 1


@pytest.mark.parametrize("tier", TIERS)
def test_tier_runners_match_the_jax_runner_at_the_tier(case, runs, tier):
    """The port's StreamRunner (step loop and scan) and MinibatchRunner
    against the JAX package's at the tier on the CPU, with the JAX package's
    segments at the tier."""
    family, jp, _, chunks = case
    jr = JR.StreamRunner(family, jp, precision=tier)
    p_j = np.asarray(jr.scan(jnp.asarray(chunks), jr.init_state(1))[0])
    jm = JR.MinibatchRunner(family, jp, batch_size=WINDOW, chunk_samples=chunks.shape[2],
                            precision=tier)
    w_j = np.asarray(jm.process_window(chunks[0].reshape(-1)))[None]
    got = runs[tier]
    bound = JAX_TIER_BOUND[family][tier]
    for route, want in (("step", p_j), ("scan", p_j), ("window", w_j)):
        assert_close(got[route], want, bound, f"{family} {tier} {route} vs JAX")
        assert segments(got[route][0], family) == segments(want[0], family), f"{tier} {route}"


# ---- the CLI --------------------------------------------------------------


@pytest.fixture(scope="module")
def restore_jax_cache_settings():
    """The JAX CLI points jax's compile cache at VADC_TPU_CACHE_DIR (else a
    directory under HOME): keep it on the suite's own cache, and put the
    settings back afterwards (as tests/test_torch_cli.py does)."""
    names = ("jax_compilation_cache_dir", "jax_persistent_cache_min_compile_time_secs",
             "jax_persistent_cache_min_entry_size_bytes")
    saved = {name: getattr(jax.config, name) for name in names}
    with pytest.MonkeyPatch.context() as mp:
        if saved["jax_compilation_cache_dir"]:
            mp.setenv("VADC_TPU_CACHE_DIR", saved["jax_compilation_cache_dir"])
        yield
    for name, value in saved.items():
        jax.config.update(name, value)


def _run_cli(cli, argv, stdin: bytes, capsys, monkeypatch) -> tuple[int, str, str]:
    monkeypatch.setattr(sys, "stdin", io.TextIOWrapper(io.BytesIO(stdin)))
    capsys.readouterr()
    rc = cli.main(argv)
    out, err = capsys.readouterr()
    return rc, out, err


@pytest.mark.parametrize("tier", TIERS)
def test_v4_cli_at_a_tier_prints_the_jax_lines(capsys, monkeypatch, restore_jax_cache_settings,
                                               tier):
    from vadc_tpu.cli import main as jax_cli
    from vadc_tpu_torch.cli import main as port_cli

    pcm = np.clip(track("v4", 0).ravel() * 32768, -32768, 32767).astype("<i2").tobytes()
    argv = ["--model", str(DATA / "silero_v4_16k.testtensor"), "--precision", tier]
    rc_j, out_j, err_j = _run_cli(jax_cli, argv, pcm, capsys, monkeypatch)
    rc_t, out_t, err_t = _run_cli(port_cli, [*argv, "--device", "cpu"], pcm, capsys, monkeypatch)
    assert rc_j == 0, err_j
    assert rc_t == 0, err_t
    assert out_t == out_j and out_t.count("\n") >= 3, (out_t, out_j)
