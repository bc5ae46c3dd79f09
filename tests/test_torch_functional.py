"""Per-op parity of vadc_tpu_torch.nn.functional with vadc_tpu.nn.functional
at the faithful tier, on the CPU, with the bundled Silero v3.1 weights.

The same numpy inputs go to both packages. Bound: 1e-5 max abs error per op
(the README's per-op bound is 1e-4). Measured maxima on the CPU, for the
record: accurate_log1p bit-equal to eager JAX; accurate_tanh 1.2e-7; STFT
magnitude 6.6e-7 relative to its largest value; encoder stages up to
5.7e-6 (stage 1); the LSTM 1.6e-6; the decoder 1.5e-8.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tests.conftest import assert_close
from tests.torch_port_util import jax_and_port_params, single_torch_thread  # noqa: F401
from tests.torch_port_util import to_torch as _t
from vadc_tpu.io.synthaudio import voiced
from vadc_tpu.models.weights import V3_STRIDES
from vadc_tpu.nn import functional as JF
from vadc_tpu_torch.nn import functional as TF

TOL = 1e-5


@pytest.fixture(scope="module")
def params():
    return jax_and_port_params()


def _speech_batch(batch: int, samples: int = 1536) -> np.ndarray:
    sig = voiced(batch * samples / 16000 + 0.1, 150.0, phase_seed=3)
    return sig[: batch * samples].reshape(batch, samples).astype(np.float32)


def test_reflect_pad_last():
    x = np.random.default_rng(0).normal(size=(3, 40)).astype(np.float32)
    got = TF.reflect_pad_last(_t(x), 5, 7)
    assert torch.equal(got, _t(np.asarray(JF.reflect_pad_last(jnp.asarray(x), 5, 7))))


def test_accurate_log1p_bit_equal():
    rng = np.random.default_rng(1)
    y = (np.abs(rng.normal(size=20000)) * 10.0 ** rng.uniform(-8, 6, size=20000)).astype(np.float32)
    got = TF.accurate_log1p(_t(y)).numpy()
    want = np.asarray(JF.accurate_log1p(jnp.asarray(y)))
    assert np.array_equal(got.view(np.int32), want.view(np.int32))


def test_accurate_tanh():
    x = (4 * np.random.default_rng(2).normal(size=20000)).astype(np.float32)
    x[:3] = (0.0, 1e-30, -1e-30)
    assert_close(TF.accurate_tanh(_t(x)), JF.accurate_tanh(jnp.asarray(x)), TOL, "tanh")


def test_stft_magnitude_and_normalization(params):
    jp, tp = params
    audio = _speech_batch(4)
    kw = dict(pad_left=128, pad_right=128, hop=64)
    spect = TF.stft_magnitude_nlc(_t(audio), tp["stft_basis"], **kw)
    want = np.asarray(JF.stft_magnitude_nlc(jnp.asarray(audio), jp["stft_basis"], **kw))
    assert spect.shape == (4, 25, 129)
    # relative to the magnitudes (up to ~10 on speech)
    assert_close(spect / float(np.abs(want).max()), want / np.abs(want).max(), TOL, "stft")
    norm = TF.adaptive_audio_normalization_nlc(_t(want))
    assert_close(norm, JF.adaptive_audio_normalization_nlc(jnp.asarray(want)), TOL, "adaptive norm")


def test_depthwise_and_conv_block(params):
    jp, tp = params
    rng = np.random.default_rng(3)
    for i, (cin, _) in enumerate(((129, 16), (16, 32), (32, 32), (32, 64))):
        p_j, p_t = jp["layers"][i], tp["layers"][i]
        x = rng.normal(size=(3, 13, cin)).astype(np.float32)
        assert_close(
            TF.depthwise_conv5_nlc(_t(x), p_t["dw_w"], p_t["dw_b"]),
            JF.depthwise_conv5_nlc(jnp.asarray(x), p_j["dw_w"], p_j["dw_b"]),
            TOL, f"dw stage {i + 1}",
        )
        args_t = [p_t[k] for k in ("dw_w", "dw_b", "pw_w", "pw_b")] + [p_t.get("proj_w"), p_t.get("proj_b")]
        args_j = [p_j[k] for k in ("dw_w", "dw_b", "pw_w", "pw_b")] + [p_j.get("proj_w"), p_j.get("proj_b")]
        assert_close(
            TF.conv_block_nlc(_t(x), *args_t), JF.conv_block_nlc(jnp.asarray(x), *args_j),
            TOL, f"conv block stage {i + 1} ({'identity' if 'proj_w' not in p_t else 'proj'})",
        )


def test_attention_k_major_order(params):
    """The k.q^T orientation with softmax over the q axis; the usual q.k^T
    would give a different result (asserted, so a swap cannot pass)."""
    jp, tp = params
    p_j, p_t = jp["layers"][3], tp["layers"][3]
    x = np.random.default_rng(4).normal(size=(3, 7, 64)).astype(np.float32)
    args = ("qkv_w", "qkv_b", "att_proj_w", "att_proj_b")
    got = TF.attention(_t(x), *(p_t[k] for k in args))
    want = JF.attention(jnp.asarray(x), *(p_j[k] for k in args))
    assert_close(got, want, TOL, "attention")
    swapped = TF.attention(_t(x), p_t["qkv_w"][[*range(64, 128), *range(64), *range(128, 192)]],
                           p_t["qkv_b"][[*range(64, 128), *range(64), *range(128, 192)]],
                           p_t["att_proj_w"], p_t["att_proj_b"])
    assert float((swapped - got).abs().max()) > 1e-3


def test_layer_norm():
    rng = np.random.default_rng(5)
    x, w, b = (rng.normal(size=s).astype(np.float32) for s in ((4, 7, 32), (32,), (32,)))
    assert_close(TF.layer_norm(_t(x), _t(w), _t(b)),
                 JF.layer_norm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)), TOL, "layer norm")


@pytest.mark.parametrize("stage", [0, 1, 2, 3])
def test_transformer_layer(params, stage):
    jp, tp = params
    p_j, p_t = jp["layers"][stage], tp["layers"][stage]
    cin, cout = p_t["pw_w"].shape[1], p_t["pw_w"].shape[0]
    rng = np.random.default_rng(6 + stage)
    x = rng.normal(size=(3, 13, cin)).astype(np.float32)
    got = TF.transformer_layer_nlc(_t(x), p_t, stride=V3_STRIDES[stage])
    want = JF.transformer_layer_nlc(jnp.asarray(x), p_j, stride=V3_STRIDES[stage])
    assert got.shape == want.shape
    assert_close(got, want, TOL, f"stage {stage + 1}")
    h = rng.normal(size=(3, 7, cout)).astype(np.float32)
    assert_close(TF.transformer_block_nlc(_t(h), p_t),
                 JF.transformer_block_nlc(jnp.asarray(h), p_j), TOL, f"block {stage + 1}")


def test_transformer_layer_bn_folded(params):
    """Folded archives omit bn_*: the stage applies conv + relu only."""
    jp, tp = params
    p_j = {k: v for k, v in jp["layers"][1].items() if not k.startswith("bn_")}
    p_t = {k: v for k, v in tp["layers"][1].items() if not k.startswith("bn_")}
    x = np.random.default_rng(11).normal(size=(2, 13, 16)).astype(np.float32)
    assert_close(TF.transformer_layer_nlc(_t(x), p_t, stride=2),
                 JF.transformer_layer_nlc(jnp.asarray(x), p_j, stride=2), TOL, "folded stage")


def test_lstm_cell_lstm_and_minibatched(params):
    jp, tp = params
    rng = np.random.default_rng(12)
    x = rng.normal(size=(3, 7, 64)).astype(np.float32)
    h0 = (0.5 * rng.normal(size=(2, 3, 64))).astype(np.float32)
    c0 = rng.normal(size=(2, 3, 64)).astype(np.float32)
    hc = TF.lstm_cell(_t(x[:, 0]), _t(h0[0]), _t(c0[0]), tp["lstm_w"][0], tp["lstm_b"][0])
    hc_j = JF.lstm_cell(jnp.asarray(x[:, 0]), jnp.asarray(h0[0]), jnp.asarray(c0[0]),
                        jp["lstm_w"][0], jp["lstm_b"][0])
    for got, want in zip(hc, hc_j):
        assert_close(got, want, TOL, "lstm cell")
    got = TF.lstm(_t(x), _t(h0), _t(c0), tp["lstm_w"], tp["lstm_b"])
    want = JF.lstm(jnp.asarray(x), jnp.asarray(h0), jnp.asarray(c0), jp["lstm_w"], jp["lstm_b"])
    for name, g, w in zip(("out", "hn", "cn"), got, want):
        assert_close(g, w, TOL, f"lstm {name}")
    got = TF.lstm_minibatched(_t(x), _t(h0[:, :1]), _t(c0[:, :1]), tp["lstm_w"], tp["lstm_b"])
    want = JF.lstm_minibatched(jnp.asarray(x), jnp.asarray(h0[:, :1]), jnp.asarray(c0[:, :1]),
                               jp["lstm_w"], jp["lstm_b"])
    for name, g, w in zip(("out", "hn", "cn"), got, want):
        assert_close(g, w, TOL, f"lstm_minibatched {name}")


def test_decoder_v3(params):
    jp, tp = params
    out = np.random.default_rng(13).normal(size=(5, 7, 64)).astype(np.float32)
    assert_close(TF.decoder_v3_nlc(_t(out), tp["dec_w"], tp["dec_b"]),
                 JF.decoder_v3_nlc(jnp.asarray(out), jp["dec_w"], jp["dec_b"]), TOL, "decoder")
