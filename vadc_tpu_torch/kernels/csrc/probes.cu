// The two products that the JAX package's on-chip regression tier probes,
// on Hopper's tensor cores, fed the way Hopper is built to be fed.
//
// Replaces the two Pallas kernels of tools/tpu_check.py's
// _probe_toolchain_blockers: k_bf16_3d (pallas_call at :54), a batched bf16
// product with fp32 sums over a contraction (48) that is not a multiple of
// the hardware's tile, and k_concat (pallas_call at :77), [x[:, t] | h] @ W,
// the LSTM's gate product. On the TPU they were canaries of the compiler;
// here they are the port's GEMM core (wgmma.cuh) held against plain
// versions: the v4 gate product's shape is 2048 rows, [x | h] = 64 + 64,
// N = 4 x 64.
//
// One block of one warpgroup (128 threads) owns a 64 x 64 tile of the
// output, the whole contraction (K <= 256) in shared memory at once: no
// ring, one mbarrier phase. At the gate shape that is 128 blocks for 132
// SMs, each with all of its loads in flight at once.
//
//   vadc_bf16_dot        x [M, K] bf16 @ w [K, N] bf16 -> fp32 by mma.sync
//                        m16n8k16 (each warp 16 rows x 64 columns), its
//                        fragments read by ldmatrix at swizzled addresses.
//   vadc_bf16_dot_wgmma  the same function and staging, the product by
//                        wgmma m64n64k16 on two shared-memory descriptors:
//                        A K-major, B = w as it lies (MN-major, transpose-B).
//                        The two entries cross-check each other.
//   vadc_concat_dot      cat(x[:, t], h) @ w, fp32 in and out, by bf16_3x
//                        (nn/precision.split; hi*hi + hi*lo + lo*hi, never
//                        TF32): x[:, t] (a 2-D view, row stride T D) and h
//                        land by TMA in adjacent k ranges of one fp32 tile,
//                        the concatenation existing only there (x's range
//                        rounded up to a 32-column panel, the gap zero, and
//                        w's rows placed to match); A is split into bf16 hi
//                        and lo in registers and given to wgmma as register
//                        operands; the block's columns of w land by TMA in
//                        an fp32 staging tile and are split once into two
//                        swizzled bf16 tiles, B of the three products.
//
// Staging, the same tiles two ways, chosen in the C entry by the shapes
// and pointers alone (bf16_dot_staging, concat_dot_staging; mirrored in
// kernels/probes.py): an operand whose row stride and base are multiples
// of 16 bytes comes by TMA (cp.async.bulk.tensor, 128-byte swizzle, zero
// fill outside the tensor replacing the masks and the K tail's padding);
// another (K = 37, D = 19, N = 13) is copied by the block's threads into
// the same swizzled places, coalesced, zeros outside: element by element,
// since such strides leave the rows misaligned for vector loads.
// The output goes the same two ways: the accumulators to a swizzled fp32
// tile in shared memory, then one TMA store per 32-column panel, or
// coalesced masked stores by the threads.
//
// What bounds them on an H100: at the gate shape the bytes (x, h and w in,
// [2048, 256] fp32 out: 2.6-3.3 MB, 0.8-1.0 us at 3.35 TB/s) ahead of the
// operations (134 MFLOP, 0.14 us at 989 TFLOP/s bf16; bf16_3x three times
// that). What paces them is each block's chain of phases, one tile a block
// and one warp a scheduler with nothing to overlap: issuing the loads,
// their latency, concat_dot's split of w, the product, the tile into shared
// memory, the store (`python3 chip_profile.py probes` times each phase by
// clock64() stamps and by knock-outs; PERF.md). At the probe's own shapes a
// launch is all there is.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

#include "mma.cuh"
#include "wgmma.cuh"

namespace {

constexpr int THREADS = 128;  // one warpgroup
constexpr int BM = 64;        // rows of a block's tile
constexpr int BN = 64;        // columns of a block's tile
constexpr int PANEL = BM * 128;  // 64 rows of 128 bytes: 64 bf16 or 32 fp32 a row
constexpr int MAX_K = 256;

// Operands staged by TMA (the others by the threads).
enum : int { X_TMA = 1, W_TMA = 2, OUT_TMA = 4, H_TMA = 8 };

__host__ __device__ constexpr int round_up(int k, int m) { return (k + m - 1) / m * m; }

using bf16 = __nv_bfloat16;

// ---- the output tile ---------------------------------------------------------

// The accumulators, d[4j + e] at row 16 warp + lane / 4 (+ 8 for e >= 2),
// column 8j + 2 (lane % 4) + e % 2 (wgmma's m64nN layout; mma.sync's
// m16n8 tiles j of a warp's 16 rows lie the same), into shared memory as
// two 128-byte-swizzled fp32 panels of 32 columns; then out by TMA or by
// the threads.
__device__ __forceinline__ void store_tile(const float (&d)[32], unsigned char* so,
                                           const CUtensorMap* out_map, float* out, int M, int N,
                                           int row0, int col0, int flags) {
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = 8 * j + 2 * (lane % 4);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = 16 * warp + lane / 4 + 8 * h;
      *reinterpret_cast<float2*>(so + (col / 32) * PANEL + sw128(row, (col % 32) * 4)) =
          make_float2(d[4 * j + 2 * h], d[4 * j + 2 * h + 1]);
    }
  }
  fence_proxy_async();
  __syncthreads();
  if (flags & OUT_TMA) {
    if (tid == 0) {
      for (int q = 0; q < BN / 32; ++q) {
        if (col0 + 32 * q < N) tma_store_2d(out_map, so + q * PANEL, col0 + 32 * q, row0);
      }
      tma_store_drain();
    }
    return;
  }
  for (int i = tid; i < BM * BN; i += THREADS) {
    const int r = i / BN, c = i % BN, row = row0 + r, col = col0 + c;
    if (row < M && col < N) {
      out[static_cast<long long>(row) * N + col] =
          *reinterpret_cast<const float*>(so + (c / 32) * PANEL + sw128(r, (c % 32) * 4));
    }
  }
}

// ---- bf16_dot, bf16_dot_wgmma --------------------------------------------------

// An instance per number of 64-k panels P (K <= 64 P): the contraction is
// staged to 64 P, zeros past K, and the k loops are unrolled without a
// branch between two products (a branch leaves the accumulators to be
// moved, and ptxas then fences before every product). Shared memory: A
// (x's rows) as P K-major panels of 64 rows x 64 k, B (w's columns) as 64
// P rows of 64 n, the output tile.
__host__ __device__ constexpr int bf16_smem(int panels) {
  return panels * PANEL + panels * 64 * 128 + 2 * PANEL + 1024;
}

// x's rows [row0, +64) and k [0, kp) into A's swizzled places, zeros outside.
__device__ __forceinline__ void copy_x_bf16(unsigned char* sa, const bf16* x, int row0, int M,
                                            int K, int kp) {
  for (int i = threadIdx.x; i < BM * kp; i += THREADS) {
    const int r = i / kp, k = i - r * kp, row = row0 + r;
    const bf16 v = (row < M && k < K) ? x[static_cast<long long>(row) * K + k]
                                      : __float2bfloat16_rn(0.0f);
    *reinterpret_cast<bf16*>(sa + (k / 64) * PANEL + sw128(r, (k % 64) * 2)) = v;
  }
}

// w's columns [col0, +64) of k [0, kp) into B's swizzled places.
__device__ __forceinline__ void copy_w_bf16(unsigned char* sb, const bf16* w, int col0, int K,
                                            int N, int kp) {
  for (int i = threadIdx.x; i < kp * BN; i += THREADS) {
    const int k = i / BN, n = i % BN;
    const bf16 v = (k < K && col0 + n < N) ? w[static_cast<long long>(k) * N + col0 + n]
                                           : __float2bfloat16_rn(0.0f);
    *reinterpret_cast<bf16*>(sb + sw128(k, n * 2)) = v;
  }
}

// mma.sync: warp w owns rows 16 w .. + 15 and the 8 n8 tiles; per k16 step
// A's fragment by one ldmatrix.x4, two n8 tiles' B fragments by one
// ldmatrix.x4.trans.
__device__ __forceinline__ void fragments_mma(uint32_t (&a)[4], uint32_t (&b)[BN / 16][4],
                                              const unsigned char* sa, const unsigned char* sb,
                                              int k0) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  ldmatrix_x4<false>(
      a, sa + (k0 / 64) * PANEL + sw128(16 * warp + lane % 16, (k0 % 64 + 8 * (lane / 16)) * 2));
#pragma unroll
  for (int jj = 0; jj < BN / 16; ++jj) {
    ldmatrix_x4<true>(b[jj], sb + sw128(k0 + lane % 16, (16 * jj + 8 * (lane / 16)) * 2));
  }
}

// The fragments of step s + 1 are read before the MMAs of step s.
template <int STEPS>
__device__ __forceinline__ void product_mma(float (&d)[32], const unsigned char* sa,
                                            const unsigned char* sb) {
  uint32_t a[2][4], b[2][BN / 16][4];
  fragments_mma(a[0], b[0], sa, sb, 0);
#pragma unroll
  for (int s = 0; s < STEPS; ++s) {
    if (s + 1 < STEPS) fragments_mma(a[(s + 1) % 2], b[(s + 1) % 2], sa, sb, 16 * (s + 1));
#pragma unroll
    for (int jj = 0; jj < BN / 16; ++jj) {
      const uint32_t b0[2] = {b[s % 2][jj][0], b[s % 2][jj][1]};
      const uint32_t b1[2] = {b[s % 2][jj][2], b[s % 2][jj][3]};
      mma(*reinterpret_cast<float(*)[4]>(d + 8 * jj), a[s % 2], b0);
      mma(*reinterpret_cast<float(*)[4]>(d + 8 * jj + 4), a[s % 2], b1);
    }
  }
}

// wgmma: every k16 step one m64n64k16 on the two tiles, issued back to
// back, one commit, one wait.
template <int STEPS>
__device__ __forceinline__ void product_wgmma(float (&d)[32], const unsigned char* sa,
                                              const unsigned char* sb) {
  wgmma_fence_operand(d);
  wgmma_fence();
#pragma unroll
  for (int s = 0; s < STEPS; ++s) {
    wgmma_ss(d, desc_a(sa + (s / 4) * PANEL + (s % 4) * 32), desc_b_mn(sb + s * 16 * 128));
  }
  wgmma_commit();
  wgmma_wait<0>();
  wgmma_fence_operand(d);
}

template <bool WGMMA, int PANELS>
__global__ void __launch_bounds__(THREADS)
bf16_dot_kernel(const __grid_constant__ CUtensorMap x_map, const __grid_constant__ CUtensorMap w_map,
                const __grid_constant__ CUtensorMap out_map, const bf16* __restrict__ x,
                const bf16* __restrict__ w, float* __restrict__ out, int M, int K, int N,
                int flags) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  __shared__ uint64_t bar;
  constexpr int KP = 64 * PANELS;
  unsigned char* sa = align1024(smem_raw);
  unsigned char* sb = sa + PANELS * PANEL;
  unsigned char* so = sb + KP * 128;
  const int row0 = blockIdx.x * BM, col0 = blockIdx.y * BN;
  if (threadIdx.x == 0) mbar_init(&bar, 1);
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_arrive_expect_tx(&bar, ((flags & X_TMA) ? PANELS * PANEL : 0) +
                                    ((flags & W_TMA) ? KP * 128 : 0));
    if (flags & X_TMA) {
#pragma unroll
      for (int p = 0; p < PANELS; ++p) tma_load_2d(sa + p * PANEL, &x_map, &bar, 64 * p, row0);
    }
    if (flags & W_TMA) tma_load_2d(sb, &w_map, &bar, col0, 0);
  }
  if (!(flags & X_TMA)) copy_x_bf16(sa, x, row0, M, K, KP);
  if (!(flags & W_TMA)) copy_w_bf16(sb, w, col0, K, N, KP);
  fence_proxy_async();
  __syncthreads();
  mbar_wait(&bar, 0);
  float d[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) d[i] = 0.0f;
  if constexpr (WGMMA) {
    product_wgmma<4 * PANELS>(d, sa, sb);
  } else {
    product_mma<4 * PANELS>(d, sa, sb);
  }
  store_tile(d, so, &out_map, out, M, N, row0, col0, flags);
}

// ---- concat_dot ------------------------------------------------------------------

// Shared memory: A, fp32, as 128-byte-swizzled panels of 64 rows x 32 k:
// x[:, t]'s D columns from k 0, h's Dh from k Dx = D rounded up to 32, Ks
// = Dx + Dh rounded up to 32 in all; w's columns as two fp32 panels of K8
// (K rounded up to 8) rows x 32 n; B hi and B lo, Ks rows of 64 n; the
// output tile.
struct ConcatLayout {
  int dx, ks, k8;
  __host__ __device__ ConcatLayout(int D, int Dh, int K)
      : dx(round_up(D, 32)), ks(round_up(D, 32) + round_up(Dh, 32)), k8(round_up(K, 8)) {}
  __host__ __device__ int a_bytes() const { return ks / 32 * PANEL; }
  __host__ __device__ int b_bytes() const { return ks * 128; }
  __host__ __device__ int w_panel() const { return k8 * 128; }
  __host__ __device__ int bytes() const {
    return a_bytes() + 2 * b_bytes() + 2 * w_panel() + 2 * PANEL + 1024;
  }
};

// Element (r, k) of an fp32 tile of 32-column panels.
__device__ __forceinline__ float* at32(unsigned char* tile, int r, int k) {
  return reinterpret_cast<float*>(tile + (k / 32) * PANEL + sw128(r, (k % 32) * 4));
}

// rows [row0, +64) of a row-major fp32 matrix (row stride `ld`, `cols`
// columns) into A's k range [k_at, k_at + span), zeros outside.
__device__ __forceinline__ void copy_a_f32(unsigned char* sa, const float* src, long long ld,
                                           int cols, int row0, int M, int k_at, int span) {
  for (int i = threadIdx.x; i < BM * span; i += THREADS) {
    const int r = i / span, k = i - r * span, row = row0 + r;
    *at32(sa, r, k_at + k) = (row < M && k < cols) ? src[row * ld + k] : 0.0f;
  }
}

// w's columns [col0, +64) of k [0, K) into the fp32 staging panels.
__device__ __forceinline__ void copy_w_f32(unsigned char* sw, int w_panel, const float* w,
                                           int col0, int K, int N) {
  for (int i = threadIdx.x; i < K * BN; i += THREADS) {
    const int k = i / BN, n = i % BN;
    *reinterpret_cast<float*>(sw + (n / 32) * w_panel + sw128(k, (n % 32) * 4)) =
        col0 + n < N ? w[static_cast<long long>(k) * N + col0 + n] : 0.0f;
  }
}

// The staging tile split into B hi and B lo (bf16), w's row k at A's k
// (k < D: k; else k - D + Dx); the rows of A's gaps zero.
__device__ __forceinline__ void split_w(unsigned char* shi, unsigned char* slo,
                                        const unsigned char* sw, const ConcatLayout& L, int D,
                                        int Dh, int K, int col0, int N) {
  // thread (k0, n4) = (tid / 16, 4 (tid % 16)) takes w's rows k0, k0 + 8,
  // ... at columns n4 .. n4 + 3: rows 8 apart share their place in the
  // swizzle, so each address is a base plus 128 bytes a row (B's row of w's
  // row k is k in x's part, k - D + Dx in h's: two bases). Eight float4 are
  // read ahead of their splits and stores.
  const int k0 = threadIdx.x / (BN / 4), n4 = 4 * (threadIdx.x % (BN / 4));
  const bool live = col0 + n4 < N;
  const unsigned char* src = sw + (n4 / 32) * L.w_panel() + sw128(k0, (n4 % 32) * 4) - k0 * 128;
  const int at_x = sw128(k0, n4 * 2) - k0 * 128;
  const int at_h = sw128(k0 + L.dx - D, n4 * 2) - k0 * 128;
  for (int j0 = 0; j0 < (K + 7) / 8; j0 += 8) {
    float4 v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int k = k0 + 8 * (j0 + j);
      v[j] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (live && k < K) v[j] = *reinterpret_cast<const float4*>(src + k * 128);
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int k = k0 + 8 * (j0 + j);
      if (k < K) {
        uint2 hi, lo;
        split_bf16x2(v[j].x, v[j].y, hi.x, lo.x);
        split_bf16x2(v[j].z, v[j].w, hi.y, lo.y);
        const int at = k * 128 + (k < D ? at_x : at_h);
        *reinterpret_cast<uint2*>(shi + at) = hi;
        *reinterpret_cast<uint2*>(slo + at) = lo;
      }
    }
  }
  const int gap1 = L.dx - D, gaps = gap1 + L.ks - L.dx - Dh;
  for (int i = threadIdx.x; i < gaps * 8; i += THREADS) {
    const int g = i / 8, c = i % 8;
    const int sk = g < gap1 ? D + g : L.dx + Dh + (g - gap1);
    *reinterpret_cast<uint4*>(shi + sk * 128 + c * 16) = make_uint4(0, 0, 0, 0);
    *reinterpret_cast<uint4*>(slo + sk * 128 + c * 16) = make_uint4(0, 0, 0, 0);
  }
}

// This thread's A fragments of the k16 step at k0, split: hi and lo.
__device__ __forceinline__ void a_fragments(uint32_t (&hi)[4], uint32_t (&lo)[4],
                                            unsigned char* sa, int k0) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r = 16 * warp + lane / 4, k = k0 + 2 * (lane % 4);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 v = *reinterpret_cast<const float2*>(at32(sa, r + 8 * (i % 2), k + 8 * (i / 2)));
    split_bf16x2(v.x, v.y, hi[i], lo[i]);
  }
}

// bf16_3x by wgmma with A in registers: per k16 step lo*hi, hi*lo, hi*hi
// into one fp32 accumulator. Up to 8 steps (K <= 128) all fragments are read
// and split first, then every product is issued; more go in chunks of 4 in
// two register buffers: a chunk's fragments are read and split while the
// chunk before runs, after the wait for the chunk that last read that
// buffer.
template <int STEPS>
__device__ __forceinline__ void product_bf16x3(float (&d)[32], unsigned char* sa,
                                               const unsigned char* shi,
                                               const unsigned char* slo) {
  constexpr int CHUNK = STEPS <= 8 ? STEPS : 4;
  uint32_t ah[2][CHUNK][4], al[2][CHUNK][4];
  wgmma_fence_operand(d);
#pragma unroll
  for (int c = 0; c < (STEPS + CHUNK - 1) / CHUNK; ++c) {
    if (c >= 2) wgmma_wait<1>();  // chunk c - 2, the last reader of this buffer
#pragma unroll
    for (int s = 0; s < CHUNK; ++s) {
      if (CHUNK * c + s < STEPS) a_fragments(ah[c % 2][s], al[c % 2][s], sa, 16 * (CHUNK * c + s));
    }
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < CHUNK; ++s) {
      const int k0 = 16 * (CHUNK * c + s);
      if (CHUNK * c + s < STEPS) {
        wgmma_rs(d, al[c % 2][s], desc_b_mn(shi + k0 * 128));
        wgmma_rs(d, ah[c % 2][s], desc_b_mn(slo + k0 * 128));
        wgmma_rs(d, ah[c % 2][s], desc_b_mn(shi + k0 * 128));
      }
    }
    wgmma_commit();
  }
  wgmma_wait<0>();
  wgmma_fence_operand(d);
}

// An instance per KS = Ks / 32 (1..9): the k16 steps, 2 KS, unrolled.
template <int KS>
__global__ void __launch_bounds__(THREADS)
concat_dot_kernel(const __grid_constant__ CUtensorMap x_map, const __grid_constant__ CUtensorMap h_map,
                  const __grid_constant__ CUtensorMap w_map, const __grid_constant__ CUtensorMap out_map,
                  const float* __restrict__ x, int T, int D, int t, const float* __restrict__ h,
                  int Dh, const float* __restrict__ w, float* __restrict__ out, int M, int N,
                  int flags) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  __shared__ uint64_t bar[2];
  const int K = D + Dh;
  const ConcatLayout L(D, Dh, K);
  unsigned char* sa = align1024(smem_raw);
  unsigned char* shi = sa + L.a_bytes();
  unsigned char* slo = shi + L.b_bytes();
  unsigned char* sw = slo + L.b_bytes();
  unsigned char* so = sw + 2 * L.w_panel();
  const int row0 = blockIdx.x * BM, col0 = blockIdx.y * BN;
  const int x_panels = L.dx / 32, h_panels = (L.ks - L.dx) / 32;
  // w's boxes of 32 columns that hold a column of w (a box wholly outside
  // is not asked for; split_w reads zeros there)
  const int w_boxes = min(BN / 32, (N - col0 + 31) / 32);
  // w's boxes first, on their own barrier: its split runs while A lands
  if (threadIdx.x == 0) {
    mbar_init(&bar[0], 1);
    mbar_init(&bar[1], 1);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_arrive_expect_tx(&bar[0], (flags & W_TMA) ? w_boxes * K * 128 : 0);
    if (flags & W_TMA) {
      for (int q = 0; q < w_boxes; ++q) {
        tma_load_2d(sw + q * L.w_panel(), &w_map, &bar[0], col0 + 32 * q, 0);
      }
    }
    mbar_arrive_expect_tx(&bar[1], ((flags & X_TMA) ? x_panels * PANEL : 0) +
                                       ((flags & H_TMA) ? h_panels * PANEL : 0));
    if (flags & X_TMA) {
      for (int p = 0; p < x_panels; ++p) tma_load_2d(sa + p * PANEL, &x_map, &bar[1], 32 * p, row0);
    }
    if (flags & H_TMA) {
      for (int p = 0; p < h_panels; ++p) {
        tma_load_2d(sa + (x_panels + p) * PANEL, &h_map, &bar[1], 32 * p, row0);
      }
    }
  }
  if (!(flags & W_TMA)) copy_w_f32(sw, L.w_panel(), w, col0, K, N);
  if (!(flags & X_TMA)) {
    copy_a_f32(sa, x + static_cast<long long>(t) * D, static_cast<long long>(T) * D, D, row0, M,
               0, L.dx);
  }
  if (!(flags & H_TMA)) copy_a_f32(sa, h, Dh, Dh, row0, M, L.dx, L.ks - L.dx);
  __syncthreads();
  mbar_wait(&bar[0], 0);
  split_w(shi, slo, sw, L, D, Dh, K, col0, N);
  fence_proxy_async();
  __syncthreads();
  mbar_wait(&bar[1], 0);
  float d[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) d[i] = 0.0f;
  product_bf16x3<2 * KS>(d, sa, shi, slo);
  store_tile(d, so, &out_map, out, M, N, row0, col0, flags);
}

// ---- host ------------------------------------------------------------------------


int bf16_staging(const void* x, const void* w, const void* out, int K, int N) {
  return (K % 8 == 0 && aligned16(x) ? X_TMA : 0) | (N % 8 == 0 && aligned16(w) ? W_TMA : 0) |
         (N % 4 == 0 && aligned16(out) ? OUT_TMA : 0);
}

int concat_staging(const float* x, int T, int D, int t, const float* h, int Dh, const float* w,
                   const float* out, int N) {
  const bool x_ok = static_cast<long long>(T) * D % 4 == 0 &&
                    aligned16(x + static_cast<long long>(t) * D);
  return (x_ok ? X_TMA : 0) | (Dh > 0 && Dh % 4 == 0 && aligned16(h) ? H_TMA : 0) |
         (N % 4 == 0 && aligned16(w) ? W_TMA : 0) | (N % 4 == 0 && aligned16(out) ? OUT_TMA : 0);
}

constexpr auto MAP_BF16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
constexpr auto MAP_F32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;

// The instance of an entry for `panels` (1..4), and whether each instance
// has had its shared-memory limit raised on each device.
template <bool WGMMA>
auto bf16_instance(int panels) {
  switch (panels) {
    case 1: return bf16_dot_kernel<WGMMA, 1>;
    case 2: return bf16_dot_kernel<WGMMA, 2>;
    case 3: return bf16_dot_kernel<WGMMA, 3>;
    default: return bf16_dot_kernel<WGMMA, 4>;
  }
}
std::atomic<uint64_t> bf16_shared_set[2][4];

// concat_dot's instance for KS = Ks / 32 (1..9), and its shared-memory flags.
auto concat_instance(int ks) {
  switch (ks) {
    case 1: return concat_dot_kernel<1>;
    case 2: return concat_dot_kernel<2>;
    case 3: return concat_dot_kernel<3>;
    case 4: return concat_dot_kernel<4>;
    case 5: return concat_dot_kernel<5>;
    case 6: return concat_dot_kernel<6>;
    case 7: return concat_dot_kernel<7>;
    case 8: return concat_dot_kernel<8>;
    default: return concat_dot_kernel<9>;
  }
}
std::atomic<uint64_t> concat_shared_set[9];

template <bool WGMMA>
int launch_bf16(const void* x, const void* w, float* out, int M, int K, int N, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K > MAX_K) return static_cast<int>(cudaErrorInvalidValue);
  const int panels = (K + 63) / 64;
  const int flags = bf16_staging(x, w, out, K, N);
  CUtensorMap x_map{}, w_map{}, out_map{};
  bool ok = true;
  if (flags & X_TMA) ok &= tensor_map_2d(&x_map, MAP_BF16, x, M, K, K * 2ull, BM, 64);
  if (flags & W_TMA) ok &= tensor_map_2d(&w_map, MAP_BF16, w, K, N, N * 2ull, 64 * panels, BN);
  if (flags & OUT_TMA) ok &= tensor_map_2d(&out_map, MAP_F32, out, M, N, N * 4ull, BM, 32);
  if (!ok) return static_cast<int>(cudaErrorNotSupported);
  const auto kernel = bf16_instance<WGMMA>(panels);
  const int smem = bf16_smem(panels);
  cudaError_t err = allow_shared(kernel, smem, bf16_shared_set[WGMMA][panels - 1]);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
  kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      x_map, w_map, out_map, static_cast<const bf16*>(x), static_cast<const bf16*>(w), out, M, K,
      N, flags);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: [M, K] bf16 row-major; w: [K, N] bf16 row-major; out: [M, N] fp32.
// 1 <= K <= 256. Returns cudaGetLastError() after the launch.
extern "C" int vadc_bf16_dot(const void* x, const void* w, float* out, int M, int K, int N,
                             void* stream) {
  return launch_bf16<false>(x, w, out, M, K, N, stream);
}

// The same function and layouts by wgmma.
extern "C" int vadc_bf16_dot_wgmma(const void* x, const void* w, float* out, int M, int K, int N,
                                   void* stream) {
  return launch_bf16<true>(x, w, out, M, K, N, stream);
}

// x: [M, T, D] fp32; h: [M, Dh] fp32; w: [D + Dh, N] fp32; out: [M, N] fp32
// = cat(x[:, t], h) @ w by bf16_3x. 1 <= D + Dh <= 256, 0 <= t < T.
extern "C" int vadc_concat_dot(const float* x, int T, int D, int t, const float* h, int Dh,
                               const float* w, float* out, int M, int N, void* stream) {
  const int K = D + Dh;
  if (M <= 0 || N <= 0 || D <= 0 || Dh < 0 || K > MAX_K || t < 0 || t >= T) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int flags = concat_staging(x, T, D, t, h, Dh, w, out, N);
  CUtensorMap x_map{}, h_map{}, w_map{}, out_map{};
  bool ok = true;
  if (flags & X_TMA) {
    ok &= tensor_map_2d(&x_map, MAP_F32, x + static_cast<long long>(t) * D, M, D, 4ull * T * D, BM, 32);
  }
  if (flags & H_TMA) ok &= tensor_map_2d(&h_map, MAP_F32, h, M, Dh, Dh * 4ull, BM, 32);
  if (flags & W_TMA) ok &= tensor_map_2d(&w_map, MAP_F32, w, K, N, N * 4ull, K, 32);
  if (flags & OUT_TMA) ok &= tensor_map_2d(&out_map, MAP_F32, out, M, N, N * 4ull, BM, 32);
  if (!ok) return static_cast<int>(cudaErrorNotSupported);
  const ConcatLayout L(D, Dh, K);
  const auto kernel = concat_instance(L.ks / 32);
  // the limit raised once for the instance's largest layout (K = 256)
  cudaError_t err = allow_shared(kernel, ConcatLayout(L.dx, L.ks - L.dx, MAX_K).bytes(),
                                 concat_shared_set[L.ks / 32 - 1]);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
  kernel<<<grid, THREADS, L.bytes(), static_cast<cudaStream_t>(stream)>>>(
      x_map, h_map, w_map, out_map, x, T, D, t, h, Dh, w, out, M, N, flags);
  return static_cast<int>(cudaGetLastError());
}

// Which operands each entry stages by TMA at these pointers and shapes
// (1 x, 2 w, 4 out, 8 h; the others by the threads): the rule the entries
// follow, for kernels/probes.py's mirror of it to be held to.
extern "C" int vadc_bf16_dot_staging(const void* x, const void* w, const void* out, int K, int N) {
  return bf16_staging(x, w, out, K, N);
}

extern "C" int vadc_concat_dot_staging(const float* x, int T, int D, int t, const float* h,
                                       int Dh, const float* w, const float* out, int N) {
  return concat_staging(x, T, D, t, h, Dh, w, out, N);
}
