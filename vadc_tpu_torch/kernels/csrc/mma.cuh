// The tensor-core fragment code of the port: mma.sync bf16 -> fp32 at the
// m16n8k16 and m16n8k8 shapes, the ldmatrix loads that feed them from
// shared memory, and the bf16 rounding and hi/lo split of fp32 operands
// (nn/precision.py: hi = bf16(x), lo = bf16(x - hi), both nearest even).
// probes.cu (the regression tier's two probes, through wgmma.cuh),
// stft_tile.cuh (the spectrum at the bf16 modes) and silero_v31_body.cuh
// (the encoder's products at the bf16 tiers) use it.
//
// Fragments, g = lane / 4 and t = lane % 4 (PTX ISA, mma.m16n8k16 and
// mma.m16n8k8 with .bf16 operands): A (row-major, 16 x k) holds rows g and
// g + 8 at columns 2t, 2t + 1 (and 2t + 8, 2t + 9 at k16), the lower
// column in a register's lower half; B (k x 8, the "col" operand) holds
// rows 2t, 2t + 1 (and 2t + 8, 2t + 9) of column g; C and D hold rows g
// and g + 8 at columns 2t, 2t + 1: d[0], d[1] on the first row, d[2],
// d[3] on the second.
//
// How the port sums with them: mma_add* below runs the MMA on a zero
// accumulator and adds its result to the running fp32 sum with one
// rounded add. The tensor cores' own accumulation rounds differently from
// an fp32 add (it aligns the terms of one MMA to the largest and rounds
// once), so a chain of MMAs over K would collect one such error per step
// against the whole sum; summed from zero, an MMA's error is one of its
// own few terms, and the sum over K is an fp32 sum of per-step partials.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Two fp32 values as one bf16x2 register, each rounded to nearest even:
// `lo_k` (the lower k or column) in the lower half.
__device__ __forceinline__ uint32_t pack_bf16x2(float lo_k, float hi_k) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo_k, hi_k);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// v as bf16_3x's pair, stored: *hi = bf16(v), *lo = bf16(v - hi).
__device__ __forceinline__ void split_store(__nv_bfloat16* hi, __nv_bfloat16* lo, float v) {
  const __nv_bfloat16 h = __float2bfloat16_rn(v);
  *hi = h;
  *lo = __float2bfloat16_rn(v - __bfloat162float(h));
}

// The hi and lo bf16x2 registers of two fp32 values (bf16_3x's split).
__device__ __forceinline__ void split_bf16x2(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  hi = pack_bf16x2(x0, x1);
  const float h0 = __uint_as_float(hi << 16);
  const float h1 = __uint_as_float(hi & 0xFFFF0000u);
  lo = pack_bf16x2(x0 - h0, x1 - h1);
}

// ---- ldmatrix -----------------------------------------------------------------

// Four 8 x 8 bf16 matrices whose rows lanes 0-31 address themselves (lanes
// 8i .. 8i + 7 the rows of matrix i; 16-byte aligned rows of 8 values): r[i]
// as lane l's pair of matrix i, (row l / 4, columns 2 (l % 4) + {0, 1}), or
// with TRANS (rows 2 (l % 4) + {0, 1}, column l / 4). Rows m (lanes 0-15)
// and then the same rows 8 k on (lanes 16-31) give an m16n8k16 A fragment;
// rows k of two n8 tiles, TRANS, two B fragments.
template <bool TRANS>
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* row) {
  const uint32_t addr = smem_addr(row);
  if constexpr (TRANS) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(addr));
  } else {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(addr));
  }
}

// Two 8 x 8 bf16 matrices whose 8 rows each lane 0-15 addresses itself
// (lanes 0-7 the first matrix's rows, 8-15 the second's; 16-byte aligned
// rows of 8 values): r[0] and r[1] as lane l's pairs (row l / 4, columns
// 2 (l % 4) + {0, 1}), or with TRANS (rows 2 (l % 4) + {0, 1}, column l / 4).
// Rows m of a k8 slice give an m16n8k8 A fragment; rows k of an n8 tile,
// TRANS, its B fragment.
template <bool TRANS>
__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2], const __nv_bfloat16* row) {
  const uint32_t addr = smem_addr(row);
  if constexpr (TRANS) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
                 : "=r"(r[0]), "=r"(r[1])
                 : "r"(addr));
  } else {
    asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
                 : "=r"(r[0]), "=r"(r[1])
                 : "r"(addr));
  }
}

// ---- mma.sync -------------------------------------------------------------------

// d += a @ b, m16n8k16, fp32 sums in the tensor core.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a @ b, m16n8k8: a is rows g, g + 8 at k 2t, 2t + 1; b rows 2t, 2t + 1.
__device__ __forceinline__ void mma_k8(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(b));
}

__device__ __forceinline__ void add4(float (&acc)[4], const float (&t)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) acc[i] += t[i];
}

// acc += a @ b over one k16 step: bf16 operands, the MMA from zero.
__device__ __forceinline__ void mma_add(float (&acc)[4], const uint32_t (&a)[4],
                                        const uint32_t (&b)[2]) {
  float t[4] = {0.f, 0.f, 0.f, 0.f};
  mma(t, a, b);
  add4(acc, t);
}

// acc += a @ b over one k16 step by bf16_3x: lo*hi, hi*lo, then hi*hi in
// one chain from zero (the small terms first), added once.
__device__ __forceinline__ void mma_add3(float (&acc)[4], const uint32_t (&a_hi)[4],
                                         const uint32_t (&a_lo)[4], const uint32_t (&b_hi)[2],
                                         const uint32_t (&b_lo)[2]) {
  float t[4] = {0.f, 0.f, 0.f, 0.f};
  mma(t, a_lo, b_hi);
  mma(t, a_hi, b_lo);
  mma(t, a_hi, b_hi);
  add4(acc, t);
}

// The same by bf16_3x over one k8 step (m16n8k8).
__device__ __forceinline__ void mma_add3_k8(float (&acc)[4], const uint32_t (&a_hi)[2],
                                            const uint32_t (&a_lo)[2], uint32_t b_hi,
                                            uint32_t b_lo) {
  float t[4] = {0.f, 0.f, 0.f, 0.f};
  mma_k8(t, a_lo[0], a_lo[1], b_hi);
  mma_k8(t, a_hi[0], a_hi[1], b_lo);
  mma_k8(t, a_hi[0], a_hi[1], b_hi);
  add4(acc, t);
}

}  // namespace
