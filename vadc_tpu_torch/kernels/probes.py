"""The two products of the JAX package's on-chip regression tier, as
tensor-core kernels.

Counterparts of the Pallas kernels in tools/tpu_check.py's
`_probe_toolchain_blockers`: `k_bf16_3d` (`pl.pallas_call` at :54), a
batched bf16 product with fp32 sums over a contraction that is not a
multiple of the hardware's tile, and `k_concat` (:77), `[x[:, t] | h] @ W`,
the LSTM's gate product. The CUDA kernels are `csrc/probes.cu` on the
port's GEMM core `csrc/wgmma.cuh`; their headers say what bounds them and
how they are laid out. Each block stages its operands by TMA into
128-byte-swizzled shared memory, or, where a stride or base is no multiple
of 16 bytes, by its threads into the same places (`bf16_dot_staging`,
`concat_dot_staging`: the C entries' rule, mirrored here):

  bf16_dot        mma.sync m16n8k16, fragments by ldmatrix at swizzled
                  addresses
  bf16_dot_wgmma  wgmma m64n64k16, A and B (w as it lies: MN-major) by
                  swizzled shared-memory descriptors
  concat_dot      bf16_3x (hi*hi + hi*lo + lo*hi, nn/precision.split) on
                  wgmma, A's hi and lo as register operands; x[:, t] and h
                  land side by side in one shared tile, the concatenation
                  only there

A CPU tensor takes the plain version; a CUDA tensor launches the kernel
(built at first use) or raises. tools/gpu_check.py and chip_smoke.py hold
them on the card.
"""

from __future__ import annotations

import torch

from vadc_tpu_torch.kernels import _build

#: the largest contraction the kernels stage in shared memory (csrc/probes.cu)
MAX_K = 256

#: the operands an entry stages by TMA (the flags of csrc/probes.cu); the
#: others are copied by the block's threads
X_TMA, W_TMA, OUT_TMA, H_TMA = 1, 2, 4, 8


def _aligned16(address: int) -> bool:
    return address % 16 == 0


def bf16_dot_staging(x: torch.Tensor, w: torch.Tensor, out: torch.Tensor) -> int:
    """The operands bf16_dot's kernels take by TMA at these tensors: each
    whose row stride and base are multiples of 16 bytes (x: K % 8 == 0;
    w: N % 8 == 0; the fp32 out: N % 4 == 0)."""
    k, n = w.shape
    return ((X_TMA if k % 8 == 0 and _aligned16(x.data_ptr()) else 0)
            | (W_TMA if n % 8 == 0 and _aligned16(w.data_ptr()) else 0)
            | (OUT_TMA if n % 4 == 0 and _aligned16(out.data_ptr()) else 0))


def concat_dot_staging(x: torch.Tensor, t: int, h: torch.Tensor, w: torch.Tensor,
                       out: torch.Tensor) -> int:
    """The operands concat_dot's kernel takes by TMA: x[:, t] as a 2-D view
    (row stride T D, base t D, in fp32), h (Dh), w and out (N), each whose
    row stride and base are multiples of 16 bytes."""
    _, seq, d = x.shape
    dh, n = h.shape[1], w.shape[1]
    x_ok = seq * d % 4 == 0 and _aligned16(x.data_ptr() + 4 * t * d)
    return ((X_TMA if x_ok else 0)
            | (H_TMA if dh > 0 and dh % 4 == 0 and _aligned16(h.data_ptr()) else 0)
            | (W_TMA if n % 4 == 0 and _aligned16(w.data_ptr()) else 0)
            | (OUT_TMA if n % 4 == 0 and _aligned16(out.data_ptr()) else 0))


def kernel_staging(entry: str, *args: int) -> int:
    """The C rule itself (`vadc_<entry>_staging` of csrc/probes.cu, the
    pointers and shapes as the entry gets them); needs the library."""
    import ctypes

    p, i = ctypes.c_void_p, ctypes.c_int
    argtypes = {"bf16_dot": [p, p, p, i, i], "concat_dot": [p, i, i, i, p, i, p, p, i]}[entry]
    fn = getattr(_build.library(), f"vadc_{entry}_staging")
    fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return fn(*args)


def bf16_dot_reference(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain version: x @ w in fp32 on the bf16 values (each product of two
    bf16 values is exact in fp32)."""
    return x.float() @ w.float()


def concat_dot_reference(x: torch.Tensor, t: int, h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain version: cat(x[:, t], h) @ w in fp32."""
    return torch.cat([x[:, t], h], -1) @ w


def _check_bf16(who: str, x: torch.Tensor, w: torch.Tensor) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{who}: unsupported device {x.device}")
    for name, a in (("x", x), ("w", w)):
        if a.dtype != torch.bfloat16:
            raise TypeError(f"{who}: {name} must be bfloat16, got {a.dtype}")
        if a.device != x.device:
            raise ValueError(f"{who}: {name} on {a.device}, x on {x.device}")
        if not a.is_contiguous():
            raise ValueError(f"{who}: {name} must be contiguous")
    if x.dim() < 2 or w.dim() != 2 or x.shape[-1] != w.shape[0]:
        raise ValueError(f"{who}: x {tuple(x.shape)} and w {tuple(w.shape)} are not [..., M, K] "
                         "and [K, N]")
    if not 1 <= w.shape[0] <= MAX_K:
        raise ValueError(f"{who}: contraction {w.shape[0]} outside 1..{MAX_K}")
    if x.numel() == 0 or w.numel() == 0:
        raise ValueError(f"{who}: empty operand")


def _bf16_dot(entry: str, fn, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    _check_bf16(entry, x, w)
    k, n = w.shape
    rows = x.numel() // k
    out = torch.empty(*x.shape[:-1], n, dtype=torch.float32, device=x.device)
    lib = _build.library()
    status = getattr(lib, f"vadc_{entry}")(
        x.data_ptr(), w.data_ptr(), out.data_ptr(), rows, k, n,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(status, entry)
    fn.launches += 1
    return out


def bf16_dot(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [..., M, K] bf16 (the leading dims folded into rows) @ w [K, N]
    bf16 -> [..., M, N] fp32, by mma.sync."""
    if x.device.type == "cpu":
        return bf16_dot_reference(x, w)
    return _bf16_dot("bf16_dot", bf16_dot, x, w)


def bf16_dot_wgmma(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """bf16_dot's function by wgmma (one warpgroup per 64 x 64 tile)."""
    if x.device.type == "cpu":
        return bf16_dot_reference(x, w)
    return _bf16_dot("bf16_dot_wgmma", bf16_dot_wgmma, x, w)


def concat_dot(x: torch.Tensor, t: int, h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """cat(x[:, t], h) @ w: x [B, T, D], h [B, Dh], w [D + Dh, N], fp32 ->
    [B, N] fp32, the products by bf16_3x on wgmma (within 2^-16 of fp32
    a term)."""
    if x.device.type == "cpu":
        return concat_dot_reference(x, t, h, w)
    who = "concat_dot"
    if x.device.type != "cuda":
        raise ValueError(f"{who}: unsupported device {x.device}")
    for name, a in (("x", x), ("h", h), ("w", w)):
        if a.dtype != torch.float32:
            raise TypeError(f"{who}: {name} must be float32, got {a.dtype}")
        if a.device != x.device:
            raise ValueError(f"{who}: {name} on {a.device}, x on {x.device}")
        if not a.is_contiguous():
            raise ValueError(f"{who}: {name} must be contiguous")
    if x.dim() != 3 or h.dim() != 2 or w.dim() != 2 or h.shape[0] != x.shape[0] \
            or w.shape[0] != x.shape[2] + h.shape[1]:
        raise ValueError(f"{who}: x {tuple(x.shape)}, h {tuple(h.shape)}, w {tuple(w.shape)} "
                         "are not [B, T, D], [B, Dh], [D + Dh, N]")
    if not 0 <= t < x.shape[1]:
        raise IndexError(f"{who}: t {t} outside 0..{x.shape[1] - 1}")
    if w.shape[0] > MAX_K or x.numel() == 0 or w.numel() == 0:
        raise ValueError(f"{who}: contraction {w.shape[0]} outside 1..{MAX_K}, or empty operand")
    batch, seq, d = x.shape
    out = torch.empty(batch, w.shape[1], dtype=torch.float32, device=x.device)
    status = _build.library().vadc_concat_dot(
        x.data_ptr(), seq, d, t, h.data_ptr(), h.shape[1], w.data_ptr(), out.data_ptr(),
        batch, w.shape[1], torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(status, who)
    concat_dot.launches += 1
    return out


#: kernel launches since each count was last set to 0
bf16_dot.launches = 0
bf16_dot_wgmma.launches = 0
concat_dot.launches = 0
