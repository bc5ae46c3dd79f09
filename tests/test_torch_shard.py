"""The port's stream sharding (vadc_tpu_torch/engine/shard.py) on the CPU.

`ShardedStreamRunner` over `["cpu"] * 8` against the JAX package's
`ShardedStreamRunner` on the conftest's 8 virtual CPU devices
(tests/test_engine.py: test_sharded_matches_unsharded): Silero v3.1 at
B=16, a step and a T=2 scan, probabilities within 1e-4 and (h, c) within
3e-4, the whole-model bounds of tests/test_torch_fused_audio.py; v5
(synthetic weights, the audio context carried per shard) within 1e-5 and
5e-5, those of tests/test_torch_v5.py.

Against the port's own unsharded StreamRunner: probabilities within 1e-6
(measured 2.9e-10) and (h, c) within 1e-5 (measured 1.4e-6 on h and 4.8e-6
on c, of magnitude 6.4, after a step and a scan over 8 devices: the CPU's
LSTM products sum a 2-row batch in another order than a 16-row one; with 8
rows a shard the bits are equal). On a card the sharded runner holds the
unsharded bits (tests/test_torch_cuda.py).
"""

import numpy as np
import pytest
import torch

from tests.conftest import assert_close
from tests.torch_port_util import jax_and_port_params
from tests.torch_port_util import single_torch_thread  # noqa: F401
from vadc_tpu_torch.engine.runner import StreamRunner
from vadc_tpu_torch.engine.shard import ShardedState, ShardedStreamRunner, stream_devices

TOL_STATE = 1e-5


@pytest.fixture(scope="module")
def v31():
    return jax_and_port_params()


@pytest.fixture(scope="module")
def v5():
    from vadc_tpu.models.silero_v5 import silero_v5_params as j_params
    from vadc_tpu.models.synthetic import random_v5_archive
    from vadc_tpu_torch.models.weights import silero_v5_params as t_params

    archive = random_v5_archive(0)
    return j_params(archive), t_params(archive)


def _chunks(shape, seed, scale=0.1) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _jax_sharded(family, params):
    import jax

    from vadc_tpu.engine.shard import ShardedStreamRunner as JaxSharded
    from vadc_tpu.engine.shard import make_stream_mesh

    assert len(jax.devices()) >= 8, "conftest must provide 8 virtual devices"
    return JaxSharded(family, params, make_stream_mesh(jax.devices()[:8]))


@pytest.mark.parametrize("family,chunk,tol", [("v3", 1536, (1e-4, 3e-4)),
                                              ("v5", 512, (1e-5, 5e-5))])
def test_sharded_matches_the_jax_sharded_runner(family, chunk, tol, v31, v5):
    """A step and a T=2 scan over 16 streams on 8 devices, from the same
    seeded chunks, in both packages."""
    import jax.numpy as jnp

    jp, tp = v31 if family == "v3" else v5
    jr = _jax_sharded(family, jp)
    tr = ShardedStreamRunner(family, tp, ["cpu"] * 8)
    j_state, t_state = jr.init_state(16), tr.init_state(16)
    assert len(t_state.shards) == 8 and t_state.n_streams == 16

    x = _chunks((16, chunk), seed=1)
    pj, j_state = jr.step(jnp.asarray(x), j_state)
    pt, t_state = tr.step(x, t_state)
    assert pt.shape == (16,)
    assert_close(pt, np.asarray(pj), tol[0], f"{family} sharded step probs")
    assert_close(t_state.h, np.asarray(j_state.h), tol[1], f"{family} sharded step h")

    seq = _chunks((16, 2, chunk), seed=2)
    pj2, j_state = jr.scan(jnp.asarray(seq), j_state)
    pt2, t_state = tr.scan(seq, t_state)
    assert pt2.shape == (16, 2)
    assert_close(pt2, np.asarray(pj2), tol[0], f"{family} sharded scan probs")
    assert_close(t_state.h, np.asarray(j_state.h), tol[1], f"{family} sharded scan h")
    assert_close(t_state.c, np.asarray(j_state.c), tol[1], f"{family} sharded scan c")
    if family == "v5":
        # the context carry is per shard: each shard's streams keep their own tails
        assert_close(t_state.context, np.asarray(j_state.context), 0.0, "v5 context")


def _assert_state_close(got, want, label):
    for name in ("h", "c"):
        assert_close(getattr(got, name), getattr(want, name), TOL_STATE, f"{label} {name}")


@pytest.mark.parametrize("n_devices", [8, 2])
@pytest.mark.parametrize("family,chunk", [("v3", 1536), ("v5", 512)])
def test_sharded_matches_unsharded(family, chunk, n_devices, v31, v5):
    """The port's sharded runner against its unsharded runner, a step and a
    T=2 scan over 16 streams: the state is updated in place and the
    probabilities come back in stream order."""
    tp = (v31 if family == "v3" else v5)[1]
    sharded = ShardedStreamRunner(family, tp, ["cpu"] * n_devices)
    plain = StreamRunner(family, tp, device="cpu")
    s_state, p_state = sharded.init_state(16), plain.init_state(16)

    x = _chunks((16, chunk), seed=3)
    ps, out = sharded.step(x, s_state)
    pp, p_state = plain.step(x, p_state)
    assert out is s_state
    assert_close(ps, pp, 1e-6, f"{family} step probs over {n_devices}")
    _assert_state_close(s_state, p_state, f"{family} step over {n_devices}")

    seq = _chunks((16, 2, chunk), seed=4)
    ps2, s_state = sharded.scan(seq, s_state)
    pp2, p_state = plain.scan(seq, p_state)
    assert_close(ps2, pp2, 1e-6, f"{family} scan probs over {n_devices}")
    _assert_state_close(s_state, p_state, f"{family} scan over {n_devices}")
    if family == "v5":
        assert torch.equal(s_state.context, p_state.context)


def test_init_state_refuses_a_count_that_does_not_divide(v31):
    """The JAX runner's ValueError, word for word, from both packages."""
    jr = _jax_sharded("v3", v31[0])
    tr = ShardedStreamRunner("v3", v31[1], ["cpu"] * 8)
    with pytest.raises(ValueError) as jax_error:
        jr.init_state(12)
    with pytest.raises(ValueError) as port_error:
        tr.init_state(12)
    assert str(port_error.value) == str(jax_error.value) == "n_streams 12 must divide over 8 devices"
    with pytest.raises(ValueError, match="do not divide over 8 devices"):
        tr.step(np.zeros((12, 1536), np.float32), tr.init_state(16))


def test_a_repeated_device_shares_one_params(v31):
    """Params move once per distinct device: the shards of one device share
    one Params (and so what the kernels derive from it)."""
    tr = ShardedStreamRunner("v3", v31[1], ["cpu", "cpu", "cpu"])
    assert tr.runners[0].params is tr.runners[1].params is tr.runners[2].params
    assert tr.streams == [None, None, None]
    assert [d.type for d in tr.devices] == ["cpu"] * 3


def test_scatter_then_gather_is_the_state(v31):
    """scatter_state puts each shard's rows on its device; the state's h, c
    read them back gathered, in stream order."""
    from vadc_tpu_torch.engine.runner import StreamState

    rng = np.random.default_rng(5)
    whole = StreamState(torch.from_numpy(rng.normal(size=(2, 8, 64)).astype(np.float32)),
                        torch.from_numpy(rng.normal(size=(2, 8, 64)).astype(np.float32)))
    tr = ShardedStreamRunner("v3", v31[1], ["cpu"] * 4)
    state = tr.scatter_state(whole)
    assert isinstance(state, ShardedState) and len(state.shards) == 4
    assert torch.equal(state.shards[1].h, whole.h[:, 2:4])
    assert torch.equal(state.h, whole.h) and torch.equal(state.c, whole.c)
    assert state.context is None


def test_stream_devices():
    """The list given, resolved, repeats kept; by default every card, which
    without one is NoCudaDeviceError, never the CPU instead."""
    from vadc_tpu_torch.runtime import NoCudaDeviceError

    assert stream_devices(["cpu", "cpu"]) == [torch.device("cpu")] * 2
    with pytest.raises(ValueError, match="no devices"):
        stream_devices([])
    if not torch.cuda.is_available():
        with pytest.raises(NoCudaDeviceError):
            stream_devices()
