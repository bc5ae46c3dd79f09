"""Shared helpers of the vadc_tpu_torch parity tests (tests/test_torch_*.py).

`single_torch_thread` is an autouse fixture for the modules that import it:
it runs torch on one CPU thread while the module's tests run. Measured with
torch 2.13 on an x86 CPU: in a process that imported jax before torch
started its OpenMP worker threads, torch.exp on a multi-threaded first call
intermittently returned values with ~1e-4 relative error (the same call on
one thread, or with the worker pool started before jax was imported, was
exact to 1 ulp). The port itself never imports jax; only these tests load
both frameworks in one process.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
DATA = ROOT / "vadc_tpu" / "data"
V31_ARCHIVE = DATA / "silero_v31_16k.testtensor"


@pytest.fixture(autouse=True, scope="module")
def single_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(prev)


def to_torch(x) -> torch.Tensor:
    """numpy (or array-like) -> a float32 CPU tensor that owns its memory."""
    return torch.from_numpy(np.array(x, dtype=np.float32, copy=True))


def jax_and_port_params():
    """(JAX param tree, the port's tree) of the bundled v3.1 archive; the
    port's is built from the JAX tree's leaves, so both compute from the
    same weights."""
    import jax

    from vadc_tpu.io.testtensor import load_testtensor
    from vadc_tpu.models.weights import silero_v31_params
    from vadc_tpu_torch.models.weights import params_from_numpy

    jp = silero_v31_params(load_testtensor(V31_ARCHIVE))
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp))


def speech(n_chunks: int, chunk: int = 1536, seed: int = 0) -> np.ndarray:
    """[n_chunks, chunk] of synthetic speech (voiced spans and silence)."""
    from vadc_tpu.io.synthaudio import utterance_track

    track, _ = utterance_track(n_utterances=4, seed=seed)
    need = n_chunks * chunk
    reps = -(-need // len(track))
    return np.tile(track, reps)[:need].reshape(n_chunks, chunk).astype(np.float32)


def noise(n_chunks: int, chunk: int = 1536, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return (0.1 * rng.normal(size=(n_chunks, chunk))).astype(np.float32)


@pytest.fixture(scope="module")
def jax_cache_kept():
    """The JAX package's entry points (its api, cli.cut, server) point jax's
    compile cache at VADC_TPU_CACHE_DIR, else a directory under HOME: keep
    it on the suite's own cache while a module runs, and put the settings
    back afterwards."""
    import jax

    names = ("jax_compilation_cache_dir", "jax_persistent_cache_min_compile_time_secs",
             "jax_persistent_cache_min_entry_size_bytes")
    saved = {name: getattr(jax.config, name) for name in names}
    with pytest.MonkeyPatch.context() as mp:
        if saved["jax_compilation_cache_dir"]:
            mp.setenv("VADC_TPU_CACHE_DIR", saved["jax_compilation_cache_dir"])
        yield
    for name, value in saved.items():
        jax.config.update(name, value)


def build_v3_onnx(path: Path) -> tuple[Path, dict]:
    """A graph with the markers of the official v3 export, made from the
    bundled v3.1 archive with the JAX package's onnx_build primitives and
    written to `path`: named conv-block, norm, bias, decoder and basis
    initializers; per stage four MatMuls with anonymous [in, out] weights
    and one square 1x1 Conv with a digit-named weight; two one-layer LSTM
    nodes. Not executable (the nodes are not wired): the extractors and
    the classifier read initializers and node order only. Returns (path,
    the archive)."""
    from vadc_tpu.export import onnx_build
    from vadc_tpu.export import silero_v3_from_onnx as j_v3
    from vadc_tpu.io import testtensor as j_tt

    a = j_tt.load_testtensor(V31_ARCHIVE)
    inits = {"feature_extractor.forward_basis_buffer": a["forward_basis_buffer"],
             "decoder.1.weight": a["decoder_weights"], "decoder.1.bias": a["decoder_biases"]}
    nodes = []
    anon = 1000
    for i, ((cb, tl), has_proj) in enumerate(zip(j_v3._STAGE_PREFIXES, j_v3._HAS_PROJ)):
        src = f"transformer_l{i + 1}."
        for ours, theirs in (("dw_conv_weights", "dw_conv.0.weight"), ("dw_conv_biases", "dw_conv.0.bias"),
                             ("pw_conv_weights", "pw_conv.0.weight"), ("pw_conv_biases", "pw_conv.0.bias")):
            inits[cb + theirs] = a[src + ours]
        if has_proj:
            inits[cb + "proj.weight"] = a[src + "proj_weights"]
            inits[cb + "proj.bias"] = a[src + "proj_biases"]
        for ours in ("attention_weights", "attention_proj_weights", "linear1_weights", "linear2_weights"):
            name = f"onnx::MatMul_{anon}"
            anon += 1
            inits[name] = np.ascontiguousarray(a[src + ours].T)
            nodes.append(onnx_build.node("MatMul", [f"x{anon}", name], [f"y{anon}"]))
        for ours, theirs in (("attention_biases", "attention.QKV.bias"),
                             ("attention_proj_biases", "attention.out_proj.bias"),
                             ("linear1_biases", "linear1.bias"), ("linear2_biases", "linear2.bias"),
                             ("norm1_weights", "norm1.weight"), ("norm1_biases", "norm1.bias"),
                             ("norm2_weights", "norm2.weight"), ("norm2_biases", "norm2.bias")):
            inits[tl + theirs] = a[src + ours]
        w_name, b_name = str(anon), str(anon + 1)
        anon += 2
        inits[w_name], inits[b_name] = a[src + "conv_weights"], a[src + "conv_biases"]
        nodes.append(onnx_build.node("Conv", [f"x{anon}", w_name, b_name], [f"y{anon}"]))
    for layer in range(2):
        W, R, B = onnx_build._onnx_lstm_weights(a["weights"][layer : layer + 1],
                                                a["biases"][layer : layer + 1])
        names = [f"lstm{layer}.{k}" for k in "WRB"]
        inits.update(zip(names, (W, R, B)))
        nodes.append(onnx_build.node("LSTM", [f"h{layer}", *names], [f"h{layer + 1}"], hidden_size=64))
    path.write_bytes(onnx_build.model(onnx_build.graph(
        nodes, name="silero_v3", inputs=["input", "h0", "c0"], outputs=["output", "hn", "cn"],
        initializers=inits)))
    return path, a
