"""Reader of the `.testtensor` weight archives (named fp32 tensors).

A frozen copy of the port's reader, kept here so that the reference reads
the published weights without importing anything of the program:

    header:   int32 version (1), int32 tensor_count
    names:    tensor_count x { int32 byte_len, utf-8 bytes }
    tensors:  tensor_count x { int32 ndim, int32 dims[ndim], int32 size,
                               int32 nbytes, float32 data[size] }
"""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np

_HEADER = struct.Struct("<ii")
_I32 = struct.Struct("<i")


def load_testtensor(path: str | Path) -> dict[str, np.ndarray]:
    """name -> fp32 array, in the archive's order."""
    data = Path(path).read_bytes()
    version, count = _HEADER.unpack_from(data, 0)
    if version != 1 or count < 0:
        raise ValueError(f"{path}: not a version-1 .testtensor archive")
    offset = _HEADER.size
    names = []
    for _ in range(count):
        (name_len,) = _I32.unpack_from(data, offset)
        offset += _I32.size
        names.append(data[offset : offset + name_len].decode("utf-8"))
        offset += name_len
    out = {}
    for name in names:
        (ndim,) = _I32.unpack_from(data, offset)
        offset += _I32.size
        dims = struct.unpack_from(f"<{ndim}i", data, offset)
        offset += 4 * ndim
        size, nbytes = struct.unpack_from("<ii", data, offset)
        offset += 8
        if size != int(np.prod(dims, dtype=np.int64)) or nbytes != size * 4:
            raise ValueError(f"{path}: tensor {name!r}: inconsistent size fields")
        out[name] = np.frombuffer(data, dtype="<f4", count=size, offset=offset).reshape(dims).copy()
        offset += nbytes
    return out
