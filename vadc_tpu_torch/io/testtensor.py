# Copy of vadc_tpu/io/testtensor.py (numpy only): the port imports nothing of vadc_tpu
# and keeps its own; tests/test_torch_copies.py holds it to the original.
"""`.testtensor` binary tensor-archive format.

The format carries named fp32 tensors and is the interchange contract shared
with the reference implementation's golden-test fixtures and weight files
(format spec: reference tensor.h:201-325 and utils.py:7-86):

    header:   int32 version (must be 1), int32 tensor_count
    names:    tensor_count x { int32 byte_len, utf-8 bytes }
    tensors:  tensor_count x {
                  int32 ndim,
                  int32 dims[ndim],          (omitted when ndim == 0)
                  int32 size,                (= prod(dims))
                  int32 nbytes,              (= size * 4)
                  float32 data[size]
              }

Tensor *order* is significant: fixtures are consumed positionally by index in
the reference test harness, so both name->array and positional access are
preserved here via dict ordering (Python dicts are insertion-ordered).
"""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np

_HEADER = struct.Struct("<ii")
_I32 = struct.Struct("<i")

FORMAT_VERSION = 1


class TestTensorError(ValueError):
    """Raised on malformed .testtensor input."""


def load_testtensor_bytes(data: bytes) -> dict[str, np.ndarray]:
    """Parse a .testtensor archive from bytes into an ordered name->array dict."""
    if len(data) < _HEADER.size:
        raise TestTensorError("truncated header")
    version, count = _HEADER.unpack_from(data, 0)
    if version != FORMAT_VERSION:
        raise TestTensorError(f"unsupported version {version}")
    if count < 0:
        raise TestTensorError(f"negative tensor count {count}")

    offset = _HEADER.size
    names: list[str] = []
    for _ in range(count):
        (name_len,) = _I32.unpack_from(data, offset)
        offset += _I32.size
        names.append(data[offset : offset + name_len].decode("utf-8"))
        offset += name_len

    out: dict[str, np.ndarray] = {}
    for name in names:
        (ndim,) = _I32.unpack_from(data, offset)
        offset += _I32.size
        if ndim < 0 or ndim > 8:
            raise TestTensorError(f"tensor {name!r}: bad ndim {ndim}")
        dims = struct.unpack_from(f"<{ndim}i", data, offset)
        offset += 4 * ndim
        size, nbytes = struct.unpack_from("<ii", data, offset)
        offset += 8
        expected = int(np.prod(dims, dtype=np.int64)) if ndim else 1
        if size != expected or nbytes != size * 4:
            raise TestTensorError(
                f"tensor {name!r}: inconsistent size fields {dims} {size} {nbytes}"
            )
        arr = np.frombuffer(data, dtype="<f4", count=size, offset=offset)
        offset += nbytes
        out[name] = arr.reshape(dims).copy()
    return out


def load_testtensor(path: str | Path) -> dict[str, np.ndarray]:
    """Load a .testtensor archive from a file."""
    return load_testtensor_bytes(Path(path).read_bytes())


def save_testtensor_bytes(tensors: dict[str, np.ndarray]) -> bytes:
    """Serialize named arrays to .testtensor bytes (fp32, insertion order)."""
    arrays: dict[str, np.ndarray] = {}
    for name, arr in tensors.items():
        arr = np.asarray(arr)
        if arr.ndim == 0:
            raise TestTensorError(f"tensor {name!r}: 0-dim tensors unsupported")
        arrays[name] = np.ascontiguousarray(arr, dtype="<f4")

    parts = [_HEADER.pack(FORMAT_VERSION, len(arrays))]
    for name in arrays:
        enc = name.encode("utf-8")
        parts.append(_I32.pack(len(enc)))
        parts.append(enc)
    for arr in arrays.values():
        parts.append(_I32.pack(arr.ndim))
        parts.append(struct.pack(f"<{arr.ndim}i", *arr.shape))
        parts.append(struct.pack("<ii", arr.size, arr.nbytes))
        parts.append(arr.tobytes())
    return b"".join(parts)


def save_testtensor(path: str | Path, tensors: dict[str, np.ndarray]) -> None:
    """Write named arrays to a .testtensor file."""
    Path(path).write_bytes(save_testtensor_bytes(tensors))
