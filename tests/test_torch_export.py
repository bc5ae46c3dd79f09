"""The port's export modules on the CPU: export/pack.py (its own module,
loaded on a device) by behaviour, and the copies export/torch_export.py and
export/onnx_build.py (held line by line in tests/test_torch_copies.py) by
what they produce: tests/test_export.py and tests/test_api.py's pack test
against the port, with the bundled v3.1 archive in place of the reference
fixtures that are absent here."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import chip_smoke
from tests.test_torch_jax_free import _BLOCK_JAX, ROOT
from tests.torch_port_util import single_torch_thread  # noqa: F401
from vadc_tpu_torch.export.pack import main as pack_main
from vadc_tpu_torch.export.pack import pack
from vadc_tpu_torch.io.testtensor import load_testtensor, load_testtensor_bytes
from vadc_tpu_torch.models.weights import DEFAULT_WEIGHTS, load_params
from vadc_tpu_torch.runtime import NoCudaDeviceError


def _import(path, name: str):
    import importlib.util

    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_pack_roundtrip(tmp_path):
    """tests/test_api.py::test_pack_roundtrip against the port: the packed
    module gives the archive's bytes and (family, params) on the device
    asked for, the bundled params exactly; its default device is the card."""
    out = tmp_path / "embedded.py"
    pack(DEFAULT_WEIGHTS, out)
    embedded = _import(out, "embedded")
    assert embedded.archive_bytes() == DEFAULT_WEIGHTS.read_bytes()
    family, params = embedded.load(device="cpu")
    assert family == "v3"
    assert params["lstm_w"].shape == (2, 256, 128) and params["lstm_w"].device.type == "cpu"
    _, want = load_params(DEFAULT_WEIGHTS)
    assert torch.equal(params["lstm_w"], want["lstm_w"])
    assert torch.equal(params["stft_basis"], want["stft_basis"])
    assert all(torch.equal(params["layers"][i][k], want["layers"][i][k])
               for i in range(4) for k in want["layers"][i])
    if not torch.cuda.is_available():
        with pytest.raises(NoCudaDeviceError):
            embedded.load()


def test_pack_cli(tmp_path, capsys):
    out = tmp_path / "weights_module.py"
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-m", "vadc_tpu_torch.export.pack", str(DEFAULT_WEIGHTS),
                           str(out)], capture_output=True, text=True, timeout=120, env=env)
    assert proc.returncode == 0, proc.stderr
    head = out.read_text().splitlines()[0]
    assert head == f'"""Embedded vadc_tpu_torch weight archive ({DEFAULT_WEIGHTS.name}, ' \
                  f'{DEFAULT_WEIGHTS.stat().st_size} bytes).'
    assert pack_main(["only-one"]) == 2
    assert "usage: python -m vadc_tpu_torch.export.pack" in capsys.readouterr().err


def test_packed_module_runs_without_jax(tmp_path):
    """A packed module imports only vadc_tpu_torch: it loads and steps where
    jax and vadc_tpu cannot be imported."""
    pack(DEFAULT_WEIGHTS, tmp_path / "embedded_nojax.py")
    code = _BLOCK_JAX + (
        f"sys.path.insert(0, {str(tmp_path)!r})\n"
        "import embedded_nojax, numpy as np\n"
        "from vadc_tpu_torch.engine.runner import StreamRunner\n"
        "family, params = embedded_nojax.load(device='cpu')\n"
        "runner = StreamRunner(family, params, device='cpu')\n"
        "probs, _ = runner.step(np.zeros((2, 1536), np.float32), runner.init_state(2))\n"
        "print(family, tuple(probs.shape))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=300, env=env, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == ["v3", "(2,)"]


def test_packed_params_step_like_the_bundled_ones(tmp_path):
    pack(DEFAULT_WEIGHTS, tmp_path / "embedded_step.py")
    family, packed = _import(tmp_path / "embedded_step.py", "embedded_step").load(device="cpu")
    _, bundled = load_params(DEFAULT_WEIGHTS)
    from vadc_tpu_torch.engine.runner import StreamRunner

    audio = np.random.default_rng(0).normal(size=(3, 1536)).astype(np.float32) * 0.1
    got = [StreamRunner(family, p, device="cpu").step(audio, StreamRunner(
        family, p, device="cpu").init_state(3)) for p in (packed, bundled)]
    assert torch.equal(got[0][0], got[1][0])
    assert torch.equal(got[0][1].h, got[1][1].h) and torch.equal(got[0][1].c, got[1][1].c)


def test_v31_export_bit_identical(tmp_path):
    """tests/test_export.py::test_v31_export_bit_identical against the port's
    copy, from a state dict built from the bundled archive (chip_smoke.py's
    inverse of the export's mapping) and saved with torch.save: the archive
    comes back tensor for tensor, in order, and byte for byte."""
    from vadc_tpu_torch.export.torch_export import export_v31

    golden = load_testtensor(DEFAULT_WEIGHTS)
    sd = {k: torch.from_numpy(np.ascontiguousarray(v))
          for k, v in chip_smoke.v31_state_dict_from_archive(golden).items()}
    assert len(sd) == 105 and "encoder.sequential.16.weight" in sd
    torch.save(sd, tmp_path / "v31_state_dict.pt")
    out = tmp_path / "v31.testtensor"
    export_v31(tmp_path / "v31_state_dict.pt", out)
    mine = load_testtensor(out)
    assert list(mine) == list(golden), "tensor order must match"
    for name in golden:
        np.testing.assert_array_equal(mine[name], golden[name], err_msg=name)
    assert out.read_bytes() == DEFAULT_WEIGHTS.read_bytes()


def test_v5_export_from_synthetic_jit_dict():
    """tests/test_export.py::test_v5_export_from_synthetic_jit_dict against
    the port: the upstream v5 jit state-dict layout into the archive, loaded
    by the port, which matches the torch oracle with the very same weights
    (the JAX package's params of the archive feed the oracle)."""
    from tests.torch_oracle import silero_v5_forward
    from vadc_tpu.models.weights import load_params_from_tensors as j_load
    from vadc_tpu_torch.export.torch_export import v5_archive_from_state_dict
    from vadc_tpu_torch.io.testtensor import save_testtensor_bytes
    from vadc_tpu_torch.models import silero_v5
    from vadc_tpu_torch.models.weights import load_params_from_tensors

    rng = np.random.default_rng(17)

    def r(*shape, scale=0.2):
        return rng.normal(size=shape).astype(np.float32) * scale

    shapes = [(128, 129, 3), (64, 128, 3), (64, 64, 3), (128, 64, 3)]
    sd = {"_model.stft.forward_basis_buffer": r(258, 1, 256, scale=0.1)}
    for i, s in enumerate(shapes):
        sd[f"_model.encoder.{i}.reparam_conv.weight"] = r(*s)
        sd[f"_model.encoder.{i}.reparam_conv.bias"] = r(s[0], scale=0.05)
    sd["_model.decoder.rnn.weight_ih_l0"] = r(512, 128, scale=0.1)
    sd["_model.decoder.rnn.weight_hh_l0"] = r(512, 128, scale=0.1)
    sd["_model.decoder.rnn.bias_ih_l0"] = r(512, scale=0.05)
    sd["_model.decoder.rnn.bias_hh_l0"] = r(512, scale=0.05)
    sd["_model.decoder.decoder.2.weight"] = r(1, 128, 1)
    sd["_model.decoder.decoder.2.bias"] = r(1, scale=0.05)

    archive = v5_archive_from_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    archive = load_testtensor_bytes(save_testtensor_bytes(archive))  # format RT
    family, params = load_params_from_tensors(archive)
    assert family == "v5"
    assert params["lstm_w"].shape == (1, 512, 256)

    audio = rng.normal(size=(2, 576)).astype(np.float32) * 0.1
    h, c = silero_v5.init_state(2)
    probs, _, _ = silero_v5.forward_reference(params, torch.from_numpy(audio), h, c)
    ref_probs, _, _ = silero_v5_forward(
        j_load(archive)[1], audio, np.zeros((1, 2, 128), np.float32),
        np.zeros((1, 2, 128), np.float32))
    np.testing.assert_allclose(probs.numpy(), ref_probs, atol=1e-4)
