"""vadc_tpu_torch.models.weights against vadc_tpu.models.weights on the
bundled archives: the same leaves bit for bit, the same family detection,
the same chunk-size clamp. (The v4 and v5 trees are held leaf for leaf in
tests/test_torch_v4.py and test_torch_v5.py.)"""

import numpy as np
import pytest
import torch

import jax

from tests.torch_port_util import DATA, V31_ARCHIVE, single_torch_thread  # noqa: F401
from vadc_tpu.io.testtensor import load_testtensor
from vadc_tpu.models import weights as JW
from vadc_tpu_torch.models import weights as TW

ARCHIVES = sorted(DATA.glob("*.testtensor"))


def _leaves(tree):
    return jax.tree_util.tree_flatten_with_path(tree)[0]


def test_v31_leaves_bit_equal_to_jax():
    tensors = load_testtensor(V31_ARCHIVE)
    jp = JW.silero_v31_params(tensors)
    tp = TW.silero_v31_params(tensors)
    assert isinstance(tp, TW.Params)
    j_leaves = _leaves(jp)
    t_leaves = _leaves(jax.tree.map(lambda t: t.numpy(), dict(tp)))
    assert [p for p, _ in j_leaves] == [p for p, _ in t_leaves]
    assert len(j_leaves) == 99  # one leaf per tensor of the archive
    for (path, want), (_, got) in zip(j_leaves, t_leaves):
        want = np.asarray(want)
        assert got.dtype == np.float32 and got.shape == want.shape, path
        assert np.array_equal(got.view(np.int32), want.view(np.int32)), path
    # stage 3 (32 -> 32) has no conv-block projection: its residual is x
    assert "proj_w" not in tp["layers"][2]
    assert all("proj_w" in tp["layers"][i] for i in (0, 1, 3))


def test_params_from_numpy_matches_the_loader():
    tensors = load_testtensor(V31_ARCHIVE)
    from_jax = TW.params_from_numpy(jax.tree.map(np.asarray, JW.silero_v31_params(tensors)))
    direct = TW.silero_v31_params(tensors)
    assert isinstance(from_jax, TW.Params)
    for (path, a), (_, b) in zip(_leaves(dict(from_jax)), _leaves(dict(direct))):
        assert torch.equal(a, b), path


@pytest.mark.parametrize("archive", ARCHIVES, ids=[a.stem for a in ARCHIVES])
def test_family_detection_agrees(archive):
    tensors = load_testtensor(archive)
    family = JW.detect_model_family(tensors)
    assert TW.detect_model_family(tensors) == family
    got_family, params = TW.load_params(archive)
    assert got_family == family and isinstance(params, TW.Params)


@pytest.mark.parametrize("family", ["v5", "v5_8k"])
def test_synthetic_v5_archives_load_from_a_file(tmp_path, family):
    from vadc_tpu.io.testtensor import save_testtensor
    from vadc_tpu_torch.models.synthetic import random_v5_8k_archive, random_v5_archive

    archive = random_v5_archive(0) if family == "v5" else random_v5_8k_archive(1)
    path = tmp_path / f"{family}.testtensor"
    save_testtensor(path, archive)
    got_family, params = TW.load_params(path)
    assert got_family == family == JW.detect_model_family(load_testtensor(path))
    assert [tuple(p["w"].shape) for p in params["encoder"]] == [
        tuple(archive[f"enc{i}.weight"].shape) for i in (1, 2, 3, 4)
    ]


def test_clamp_sequence_count_agrees():
    for family in ("v3", "v4", "v4_8k", "v5", "v5_8k"):
        for requested in (0, 100, 300, 511, 512, 700, 1000, 1536, 1700, 4096):
            assert TW.clamp_sequence_count(family, requested) == JW.clamp_sequence_count(
                family, requested
            )


def test_leaves_land_on_the_device_asked_for():
    _, params = TW.load_params(V31_ARCHIVE, device="cpu")
    assert params["lstm_w"].device == torch.device("cpu")
    assert tuple(params["lstm_w"].shape) == (2, 256, 128)
    assert tuple(params["stft_basis"].shape) == (258, 256)
