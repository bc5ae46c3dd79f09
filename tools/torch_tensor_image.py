"""Dump tensors as grayscale images for visual debugging: the PyTorch/CUDA
port's counterpart of tools/tensor_image.py, reading archives through
vadc_tpu_torch.io.testtensor. It touches no device, so it takes no
--device flag. Imports nothing of JAX or of vadc_tpu.

The reference dumps failing tensors as HDR images via stb_image_write with
automatic near-square shape factoring (test.c:1296-1318). This is the
dependency-free equivalent: any .testtensor archive (or a single tensor in
it) is written as PGM images with the same auto-factoring, viewable in any
image tool.

Usage:
    python tools/torch_tensor_image.py fixture.testtensor [tensor_name] [outdir]
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np


def near_square_factors(n: int) -> tuple[int, int]:
    """Factor n into (h, w) with h <= w, as close to square as possible
    (the reference's aspect-ratio factoring, test.c:1296-1318)."""
    best = (1, n)
    for h in range(1, int(n**0.5) + 1):
        if n % h == 0:
            best = (h, n // h)
    return best


def to_image(arr: np.ndarray) -> np.ndarray:
    """Normalize any tensor into a uint8 2-D image."""
    flat = np.asarray(arr, np.float64).ravel()
    if flat.size == 0:
        return np.zeros((1, 1), np.uint8)
    lo, hi = float(flat.min()), float(flat.max())
    scale = 255.0 / (hi - lo) if hi > lo else 0.0
    img = ((flat - lo) * scale).astype(np.uint8)
    if arr.ndim >= 2:
        h, w = int(np.prod(arr.shape[:-1])), arr.shape[-1]
    else:
        h, w = near_square_factors(flat.size)
    return img.reshape(h, w)


def write_pgm(path: Path, img: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(f"P5\n{img.shape[1]} {img.shape[0]}\n255\n".encode())
        f.write(img.tobytes())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("archive", help="a .testtensor archive")
    ap.add_argument("tensor_name", nargs="?", default=None,
                    help="one tensor of it (default: every tensor)")
    ap.add_argument("outdir", nargs="?", default=".", type=Path,
                    help="where the .pgm files go (default: .)")
    args = ap.parse_args(argv)
    from vadc_tpu_torch.io.testtensor import load_testtensor

    tensors = load_testtensor(args.archive)
    name = args.tensor_name
    args.outdir.mkdir(parents=True, exist_ok=True)
    selected = {name: tensors[name]} if name else tensors
    for tname, arr in selected.items():
        safe = tname.replace("/", "_").replace(".", "_")
        path = args.outdir / f"{safe}.pgm"
        write_pgm(path, to_image(arr))
        print(f"{path}  {arr.shape} -> {to_image(arr).shape}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
