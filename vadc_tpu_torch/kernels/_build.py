"""Build the package's CUDA kernels at first use and bind them with ctypes.

Every `csrc/*.cu` file is compiled by `nvcc` for Hopper (sm_90a) into ONE
shared library with a plain C interface; no PyTorch header is included, so
the build takes seconds. The library goes to `kernels/_build/`, named by a
hash of the sources, their headers (`csrc/*.cuh`) and the flags, so a
changed source builds anew and an unchanged one loads what an earlier
process built.

No `--use_fast_math`: the faithful tier needs the correctly rounded `sqrtf`
and the accurate `expf` of the default build.

Nothing here runs at import time: the CPU tests import every module of the
package on machines without `nvcc` or a card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)
LINK_FLAGS = ("-shared",)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_IP = ctypes.POINTER(ctypes.c_int)
_F = ctypes.c_float
# C entry points: name -> argtypes. Each returns cudaGetLastError() as int.
_SIGNATURES = {
    # frames base, batch, n_frames, stride_b, stride_f, padded basis, n_fft,
    # cutoff, out, tier, stream
    "vadc_dot_magnitude": [_P, _I, _I, _L, _L, _P, _I, _I, _P, _I, _P],
    # weights, offsets (host int32[]), n_offsets, x, h, c, probs, hn, cn,
    # batch, seq0, tier, stream
    "vadc_silero_v31_fused": [_P, _P, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    # weights, offsets (host int32[]), n_offsets, x, y, rows, seq0, tier, stream
    "vadc_silero_v31_encode": [_P, _P, _I, _P, _P, _I, _I, _I, _P],
    # weights, offsets (host int32[]), n_offsets, norm_w (host float[]),
    # n_norm_w, audio, batch, stride_b, samples, basis, h, c, probs, hn, cn,
    # spect (or null), tier, stream
    "vadc_silero_v31_fused_audio": [_P, _P, _I, _P, _I, _P, _I, _L, _I, _P, _P, _P, _P, _P,
                                    _P, _P, _I, _P],
    # weights, offsets (host int32[]), n_offsets, norm_w (host float[]),
    # n_norm_w, audio, rows, stride_b, samples, basis, y, tier, stream
    "vadc_silero_v31_encode_audio": [_P, _P, _I, _P, _I, _P, _I, _L, _I, _P, _P, _I, _P],
    # audio, batch, stride_b, samples, pad_left, pad_right, hop, padded
    # basis, n_fft, cutoff, streams a block, out, mode, stream
    "vadc_stft_magnitude": [_P, _I, _L, _I, _I, _I, _I, _P, _I, _I, _I, _P, _I, _P],
    # x, h0, c0, wt, bias, y, hn, cn, batch, seq, hidden, layers, tier,
    # streams a block (the bf16 tiers'), stream
    "vadc_lstm_fused": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # x, h0, c0, wt, bias, pre, pre_rows, y, hn, cn, batch, seq, hidden,
    # layers, tier, streams a block, launched (out: kernels launched), stream
    "vadc_lstm_fused_resident": [_P, _P, _P, _P, _P, _P, _L, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                 _IP, _P],
    # x, h0, c0, wt, bias, dec_w, dec_b, pre, pre_rows, probs, hn, cn, batch,
    # chunks, frames, tier, streams a block, launched (out: kernels
    # launched), stream
    "vadc_lstm_decoder_fused_resident": [_P, _P, _P, _P, _P, _P, _P, _P, _L, _P, _P, _P, _I, _I,
                                         _I, _I, _I, _IP, _P],
    # probs, stride_b, stride_t, batch, columns, threshold, neg_threshold,
    # min_silence, min_speech, chunk index of column 0, valid (or null),
    # triggered, speech_start, temp_end in, the same out, events, stream
    "vadc_fsm_scan": [_P, _L, _L, _I, _I, _F, _F, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P,
                      _P],
    # spectrum, rows, C_in, packed weights and biases, out, tier, stream
    "vadc_v5_convs": [_P, _I, _I, _P, _P, _I, _P],
    # x, w, out, rows, k, n, stream (the two bf16 probe products)
    "vadc_bf16_dot": [_P, _P, _P, _I, _I, _I, _P],
    "vadc_bf16_dot_wgmma": [_P, _P, _P, _I, _I, _I, _P],
    # x, seq, d, t, h, dh, w, out, rows, n, stream
    "vadc_concat_dot": [_P, _I, _I, _I, _P, _I, _P, _P, _I, _I, _P],
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None

#: what the last build in this process did: library path, seconds spent
#: (0.0 when an earlier build was loaded), and nvcc's output
build_info: dict = {}


def sources() -> list[Path]:
    """The files nvcc compiles, one translation unit each."""
    return sorted(CSRC.glob("*.cu"))


def headers() -> list[Path]:
    return sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError(
        "nvcc not found (looked on PATH and under CUDA_HOME or /usr/local/cuda); "
        "the CUDA kernels of vadc_tpu_torch build at first use on a machine "
        "with the CUDA toolkit"
    )


def library_path(defines: tuple[str, ...] = (), only: tuple[str, ...] = ()) -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS + defines + only).encode())
    for src in sources() + headers():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"libvadc_kernels_{digest.hexdigest()[:16]}.so"


def build(defines: tuple[str, ...] = (), only: tuple[str, ...] = ()) -> Path:
    """Compile csrc/*.cu unless a library of the same sources exists: one
    nvcc per source, all started together, then one link. `defines` are
    extra -D flags and `only` the source names to compile instead of all
    (a measuring script's second library; the package's own has neither)."""
    out = library_path(defines, only)
    if out.exists():
        build_info.update(path=str(out), seconds=0.0, log="(loaded an earlier build)")
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    start = time.perf_counter()
    # build in a temporary directory, then rename: a concurrent process
    # never loads a half-written library
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        tmp = Path(tmp)
        jobs = []
        for src in sources():
            if only and src.name not in only:
                continue
            obj = tmp / f"{src.stem}.o"
            log = open(tmp / f"{src.stem}.log", "w+")
            cmd = [nvcc, *NVCC_FLAGS, *defines, "-I", str(CSRC), "-c", "-o", str(obj), str(src)]
            jobs.append((src, obj, log, subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT)))
        logs, failed = [], []
        for src, _, log, proc in jobs:
            proc.wait()
            log.seek(0)
            logs.append(f"Compiling {src.name}\n{log.read()}")
            log.close()
            if proc.returncode != 0:
                failed.append(f"{src.name} (exit {proc.returncode})")
        if failed:
            raise RuntimeError("nvcc failed on " + ", ".join(failed) + ":\n" + "\n".join(logs))
        lib = tmp / "lib.so"
        link = subprocess.run(
            [nvcc, *LINK_FLAGS, "-o", str(lib), *(str(obj) for _, obj, _, _ in jobs)],
            capture_output=True, text=True,
        )
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed (exit {link.returncode}):\n{link.stdout}\n{link.stderr}")
        os.replace(lib, out)
    build_info.update(
        path=str(out),
        seconds=time.perf_counter() - start,
        log="\n".join(logs).strip(),
    )
    return out


def _bind(lib: ctypes.CDLL, names) -> ctypes.CDLL:
    for name in names:
        fn = getattr(lib, name)
        fn.argtypes = _SIGNATURES[name]
        fn.restype = ctypes.c_int
    lib.vadc_error_string.argtypes = [ctypes.c_int]
    lib.vadc_error_string.restype = ctypes.c_char_p
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on the first call in this process."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = _bind(ctypes.CDLL(str(build())), _SIGNATURES)
        return _lib


#: the step kernel's phase ids, in the order of `enum Phase` in
#: csrc/silero_v31_body.cuh
PHASES = (
    "start", "spectrum", "log1p", "mean, subtract, state", "proj", "depthwise", "pw", "qkv",
    "scores", "softmax", "mix", "out_proj", "layer_norm 1", "lin1", "lin2", "layer_norm 2",
    "conv1x1", "lstm input half", "lstm", "decoder, stores",
)


def probe_library() -> ctypes.CDLL:
    """A second library for chip_profile.py: the step kernel from raw audio
    compiled with -DVADC_PHASE_PROBE, so that it stamps clock64() at its
    phase boundaries (csrc/silero_v31_body.cuh). Nothing in the package
    loads it."""
    path = build(("-DVADC_PHASE_PROBE",), ("silero_v31_fused_audio.cu", "errors.cu"))
    lib = _bind(ctypes.CDLL(str(path)), ["vadc_silero_v31_fused_audio"])
    lib.vadc_phase_probe_shape.argtypes = [_IP, _IP]
    lib.vadc_phase_probe_shape.restype = None
    lib.vadc_phase_probe_read.argtypes = [_P, _P, _P, _P]
    lib.vadc_phase_probe_read.restype = ctypes.c_int
    return lib


def check(status: int, name: str) -> None:
    """Raise when a C entry point reported a CUDA error."""
    if status != 0:
        what = library().vadc_error_string(status).decode()
        raise RuntimeError(f"{name}: CUDA error {status} at launch ({what})")
