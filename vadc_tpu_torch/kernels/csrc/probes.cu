// The two products that the JAX package's on-chip regression tier probes,
// on Hopper's tensor cores.
//
// Replaces the two Pallas kernels of tools/tpu_check.py's
// _probe_toolchain_blockers: k_bf16_3d (pallas_call at :54), a batched bf16
// product with fp32 sums over a contraction (48) that is not a multiple of
// the hardware's tile, and k_concat (pallas_call at :77), [x[:, t] | h] @ W,
// the LSTM's gate product. On the TPU they were canaries of the compiler;
// here they are the first tensor-core products of the port, and give the
// time of mma.sync and wgmma at the v4 gate product's shape (2048 rows,
// [x | h] = 64 + 64, N = 4 x 64).
//
// Three entries, each a simple kernel (speed is later work):
//
//   vadc_bf16_dot        x [M, K] bf16 @ w [K, N] bf16 -> fp32, mma.sync
//                        m16n8k16 with fragments from ldmatrix (.trans for
//                        w, which is [K, N] row-major). A block of 4 warps
//                        owns a 64 x 64 tile; a warp 16 rows x 8 n8 tiles.
//   vadc_bf16_dot_wgmma  the same function, one warpgroup per 64-row tile:
//                        wgmma.mma_async m64nNk16 (N = 16 or 64 a block),
//                        both operands read from shared memory through
//                        matrix descriptors (no swizzle, 8 x 8 core
//                        matrices, K-major: w is staged transposed).
//   vadc_concat_dot      cat(x[:, t], h) @ w, fp32 in and out: a block stages
//                        its rows of x[:, t] and h side by side in one shared
//                        row of D + Dh (the concatenation exists only there),
//                        splits every operand into bf16 hi + lo
//                        (nn/precision.split), and sums hi*hi + hi*lo +
//                        lo*hi with mma.sync into fp32 (bf16_3x, the balanced
//                        tier's product mode). W's columns of the block are
//                        staged and split once per block.
//
// Every operand is zero-padded in shared memory: K up to a multiple of 16
// (the instructions' k), rows and columns up to the tile. A stale tail
// would pass at the probe's K = 48 and fail at K = 40.
//
// What bounds them on an H100: at the gate shape the bytes (x, h and w in,
// [2048, 256] fp32 out: 2.7-3.3 MB, about 1 us at 3.35 TB/s) ahead of the
// operations (134 MFLOP, 0.14 us at 989 TFLOP/s bf16; bf16_3x three times
// that). At the probe's own shapes a launch is all there is.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 128;  // 4 warps; one warpgroup
constexpr int BM = 64;        // rows of a block's tile
constexpr int BN = 64;        // columns of a block's tile (mma.sync entries)
constexpr int PAD = 8;        // bf16 of padding a shared row (16 bytes)

__host__ __device__ constexpr int round16(int k) { return (k + 15) / 16 * 16; }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mma.sync m16n8k16 -------------------------------------------------------

// A fragment of a 16 x 16 bf16 tile of a row-major [.][ld] array at `tile`:
// lane l gives the address of row l % 16, columns (l / 16) * 8 ..
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const __nv_bfloat16* tile, int ld,
                                       int lane) {
  const uint32_t addr = smem_addr(tile + (lane % 16) * ld + (lane / 16) * 8);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(addr));
}

// B fragment of a 16 (k) x 8 (n) tile of a row-major [K][ld] array at
// `tile`: lanes 0-15 give the addresses of rows k = 0..15 (lanes 16-31
// repeat them; .x2 reads only the first 16); .trans hands lane l the pairs
// (k = 2 (l % 4) + {0, 1}, n = l / 4), the col operand's layout.
__device__ __forceinline__ void load_b(uint32_t (&b)[2], const __nv_bfloat16* tile, int ld,
                                       int lane) {
  const uint32_t addr = smem_addr(tile + (lane % 16) * ld);
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(b[0]), "=r"(b[1])
               : "r"(addr));
}

// d += a @ b, fp32 sums. d: rows lane/4 and lane/4 + 8, columns 2 (lane % 4)
// and 2 (lane % 4) + 1: d[0], d[1] on the first row, d[2], d[3] on the second.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// A warp's 16 x (8 x n8) fp32 accumulators out to [M, N], masked at the
// edges.
__device__ __forceinline__ void store_tile(const float (&acc)[BN / 8][4], float* out, int M,
                                           int N, int row0, int col0, int lane) {
  const int r = row0 + lane / 4;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int c = col0 + 8 * j + 2 * (lane % 4);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r + 8 * h;
      if (row >= M) continue;
      if (c < N) out[static_cast<long long>(row) * N + c] = acc[j][2 * h];
      if (c + 1 < N) out[static_cast<long long>(row) * N + c + 1] = acc[j][2 * h + 1];
    }
  }
}

// mma.sync: a block of 4 warps owns rows [64 bx, +64) and columns [64 by,
// +64); a warp owns 16 of the rows and all 64 columns (8 n8 tiles). Shared:
// A [64][Kp + 8] and B [Kp][64 + 8], bf16, zero-padded.
__global__ void __launch_bounds__(THREADS)
bf16_dot_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                float* __restrict__ out, int M, int K, int N) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int Kp = round16(K);
  const int lda = Kp + PAD, ldb = BN + PAD;
  __nv_bfloat16* sa = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sb = sa + BM * lda;
  const int row0 = blockIdx.x * BM, col0 = blockIdx.y * BN;
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.0f);
  for (int i = threadIdx.x; i < BM * Kp; i += THREADS) {
    const int r = i / Kp, k = i - r * Kp;
    sa[r * lda + k] = (row0 + r < M && k < K) ? x[static_cast<long long>(row0 + r) * K + k] : zero;
  }
  for (int i = threadIdx.x; i < Kp * BN; i += THREADS) {
    const int k = i / BN, n = i - k * BN;
    sb[k * ldb + n] = (k < K && col0 + n < N) ? w[static_cast<long long>(k) * N + col0 + n] : zero;
  }
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wrow = 16 * warp;
  if (row0 + wrow >= M) return;
  float acc[BN / 8][4] = {};
  for (int k0 = 0; k0 < Kp; k0 += 16) {
    uint32_t a[4];
    load_a(a, sa + wrow * lda + k0, lda, lane);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      if (col0 + 8 * j >= N) break;  // uniform over the warp
      uint32_t b[2];
      load_b(b, sb + k0 * ldb + 8 * j, ldb, lane);
      mma(acc[j], a, b);
    }
  }
  store_tile(acc, out, M, N, row0 + wrow, col0, lane);
}

// The same, on fp32 operands split into bf16 hi + lo, for cat(x[:, t], h) @ w:
// hi*hi + hi*lo + lo*hi into one fp32 sum, k slice by k slice.
__device__ __forceinline__ void split_store(__nv_bfloat16* hi, __nv_bfloat16* lo, float v) {
  const __nv_bfloat16 h = __float2bfloat16_rn(v);
  *hi = h;
  *lo = __float2bfloat16_rn(v - __bfloat162float(h));
}

__global__ void __launch_bounds__(THREADS)
concat_dot_kernel(const float* __restrict__ x, int T, int D, int t, const float* __restrict__ h,
                  int Dh, const float* __restrict__ w, float* __restrict__ out, int M, int N) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int K = D + Dh, Kp = round16(K);
  const int lda = Kp + PAD, ldb = BN + PAD;
  __nv_bfloat16* a_hi = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* a_lo = a_hi + BM * lda;
  __nv_bfloat16* b_hi = a_lo + BM * lda;
  __nv_bfloat16* b_lo = b_hi + Kp * ldb;
  const int row0 = blockIdx.x * BM, col0 = blockIdx.y * BN;
  // the block's rows of [x[:, t] | h], one shared row each
  for (int i = threadIdx.x; i < BM * Kp; i += THREADS) {
    const int r = i / Kp, k = i - r * Kp;
    const long long row = row0 + r;
    float v = 0.0f;
    if (row < M) {
      if (k < D) {
        v = x[(row * T + t) * D + k];
      } else if (k < K) {
        v = h[row * Dh + (k - D)];
      }
    }
    split_store(a_hi + r * lda + k, a_lo + r * lda + k, v);
  }
  // the block's columns of w, staged and split once
  for (int i = threadIdx.x; i < Kp * BN; i += THREADS) {
    const int k = i / BN, n = i - k * BN;
    const float v = (k < K && col0 + n < N) ? w[static_cast<long long>(k) * N + col0 + n] : 0.0f;
    split_store(b_hi + k * ldb + n, b_lo + k * ldb + n, v);
  }
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wrow = 16 * warp;
  if (row0 + wrow >= M) return;
  float acc[BN / 8][4] = {};
  for (int k0 = 0; k0 < Kp; k0 += 16) {
    uint32_t ah[4], al[4];
    load_a(ah, a_hi + wrow * lda + k0, lda, lane);
    load_a(al, a_lo + wrow * lda + k0, lda, lane);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      if (col0 + 8 * j >= N) break;
      uint32_t bh[2], bl[2];
      load_b(bh, b_hi + k0 * ldb + 8 * j, ldb, lane);
      load_b(bl, b_lo + k0 * ldb + 8 * j, ldb, lane);
      mma(acc[j], ah, bh);
      mma(acc[j], ah, bl);
      mma(acc[j], al, bh);
    }
  }
  store_tile(acc, out, M, N, row0 + wrow, col0, lane);
}

// ---- wgmma m64nNk16 ----------------------------------------------------------

// A shared-memory matrix descriptor, no swizzle: the start address >> 4
// (bits 0-13), the leading byte offset >> 4 (bits 16-29: from a core matrix
// to the next along K), the stride byte offset >> 4 (bits 32-45: from a core
// matrix to the next 8 rows), base offset 0 (bits 49-51), layout 0 (bits
// 62-63: no swizzle).
__device__ __forceinline__ uint64_t descriptor(const void* start, uint32_t lbo, uint32_t sbo) {
  uint64_t d = 0;
  d |= static_cast<uint64_t>((smem_addr(start) & 0x3FFFF) >> 4);
  d |= static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16;
  d |= static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32;
  return d;  // base offset 0, swizzle mode 0
}

// An operand of R rows x Kp (K-major) in 8 x 8 core matrices of 128 bytes:
// core matrix (row / 8, k / 8) at ((row / 8) * Kp / 8 + k / 8) * 64 bf16,
// its 8 rows of 8 k values one after the other. LBO = 128 bytes, SBO = Kp / 8
// core matrices.
__device__ __forceinline__ int core_index(int row, int k, int Kp) {
  return ((row / 8) * (Kp / 8) + k / 8) * 64 + (row % 8) * 8 + (k % 8);
}

__device__ __forceinline__ void wgmma_m64n16k16(float (&d)[8], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(desc_a), "l"(desc_b), "r"(1)
      : "memory");
}

__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(1)
      : "memory");
}

template <int NT>
__device__ __forceinline__ void wgmma_step(float (&d)[NT / 2], uint64_t desc_a, uint64_t desc_b) {
  if constexpr (NT == 16) {
    wgmma_m64n16k16(d, desc_a, desc_b);
  } else {
    static_assert(NT == 64, "wgmma tiles of 16 or 64 columns");
    wgmma_m64n64k16(d, desc_a, desc_b);
  }
}

// One warpgroup a block: rows [64 bx, +64), columns [NT by, +NT). Shared: A
// [64 rows][Kp] and w's columns transposed, B [NT rows (n)][Kp], both in core
// matrices, zero-padded. Each k16 step is one wgmma on the two core matrices
// of its 16 k values, at a start address 256 bytes further on.
template <int NT>
__global__ void __launch_bounds__(THREADS)
bf16_dot_wgmma_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                      float* __restrict__ out, int M, int K, int N) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int Kp = round16(K);
  __nv_bfloat16* sa = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sb = sa + BM * Kp;
  const int row0 = blockIdx.x * BM, col0 = blockIdx.y * NT;
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.0f);
  for (int i = threadIdx.x; i < BM * Kp; i += THREADS) {
    const int r = i / Kp, k = i - r * Kp;
    sa[core_index(r, k, Kp)] =
        (row0 + r < M && k < K) ? x[static_cast<long long>(row0 + r) * K + k] : zero;
  }
  for (int i = threadIdx.x; i < Kp * NT; i += THREADS) {
    const int k = i / NT, n = i - k * NT;
    sb[core_index(n, k, Kp)] =
        (k < K && col0 + n < N) ? w[static_cast<long long>(k) * N + col0 + n] : zero;
  }
  // the generic-proxy stores above, seen by wgmma's async proxy
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  const uint32_t lbo = 128, sbo = static_cast<uint32_t>(Kp / 8) * 128;
  float d[NT / 2];
#pragma unroll
  for (int i = 0; i < NT / 2; ++i) d[i] = 0.0f;
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
  for (int k0 = 0; k0 < Kp; k0 += 16) {
    // k0 / 8 core matrices along K: 128 bytes each
    wgmma_step<NT>(d, descriptor(sa + (k0 / 8) * 64, lbo, sbo),
                   descriptor(sb + (k0 / 8) * 64, lbo, sbo));
  }
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  // the accumulators are read only after the wait
#pragma unroll
  for (int i = 0; i < NT / 2; ++i) asm volatile("" : "+f"(d[i])::"memory");
  // d[4j + e]: row 16 warp + lane / 4 (+ 8 for e >= 2), column 8j + 2 (lane % 4) + e % 2
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r = row0 + 16 * warp + lane / 4;
#pragma unroll
  for (int j = 0; j < NT / 8; ++j) {
    const int c = col0 + 8 * j + 2 * (lane % 4);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = r + 8 * (e / 2), col = c + e % 2;
      if (row < M && col < N) out[static_cast<long long>(row) * N + col] = d[4 * j + e];
    }
  }
}

template <class Kernel>
cudaError_t launch(Kernel kernel, dim3 grid, size_t smem, cudaStream_t stream, int M, int K,
                   int N, const __nv_bfloat16* x, const __nv_bfloat16* w, float* out) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<grid, THREADS, smem, stream>>>(x, w, out, M, K, N);
  return cudaGetLastError();
}

}  // namespace

// x: [M, K] bf16 row-major; w: [K, N] bf16 row-major; out: [M, N] fp32.
// 1 <= K <= 256. Returns cudaGetLastError() after the launch.
extern "C" int vadc_bf16_dot(const void* x, const void* w, float* out, int M, int K, int N,
                             void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K > 256) return static_cast<int>(cudaErrorInvalidValue);
  const int Kp = round16(K);
  const size_t smem = sizeof(__nv_bfloat16) * (BM * (Kp + PAD) + Kp * (BN + PAD));
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
  return static_cast<int>(launch(bf16_dot_kernel, grid, smem, static_cast<cudaStream_t>(stream),
                                 M, K, N, static_cast<const __nv_bfloat16*>(x),
                                 static_cast<const __nv_bfloat16*>(w), out));
}

// The same function and layouts by wgmma: 16 columns a block where N <= 16,
// else 64.
extern "C" int vadc_bf16_dot_wgmma(const void* x, const void* w, float* out, int M, int K, int N,
                                   void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K > 256) return static_cast<int>(cudaErrorInvalidValue);
  const int Kp = round16(K);
  const int nt = N <= 16 ? 16 : 64;
  const size_t smem = sizeof(__nv_bfloat16) * (BM + nt) * Kp;
  const dim3 grid((M + BM - 1) / BM, (N + nt - 1) / nt);
  const auto xs = static_cast<const __nv_bfloat16*>(x);
  const auto ws = static_cast<const __nv_bfloat16*>(w);
  const auto s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(nt == 16 ? launch(bf16_dot_wgmma_kernel<16>, grid, smem, s, M, K, N, xs, ws, out)
                                   : launch(bf16_dot_wgmma_kernel<64>, grid, smem, s, M, K, N, xs, ws, out));
}

// x: [M, T, D] fp32; h: [M, Dh] fp32; w: [D + Dh, N] fp32; out: [M, N] fp32
// = cat(x[:, t], h) @ w by bf16_3x. 1 <= D + Dh <= 256, 0 <= t < T.
extern "C" int vadc_concat_dot(const float* x, int T, int D, int t, const float* h, int Dh,
                               const float* w, float* out, int M, int N, void* stream) {
  const int K = D + Dh;
  if (M <= 0 || N <= 0 || D <= 0 || Dh < 0 || K > 256 || t < 0 || t >= T) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int Kp = round16(K);
  const size_t smem = 2 * sizeof(__nv_bfloat16) * (BM * (Kp + PAD) + Kp * (BN + PAD));
  cudaError_t err = cudaFuncSetAttribute(concat_dot_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
  concat_dot_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(x, T, D, t, h, Dh,
                                                                               w, out, M, N);
  return static_cast<int>(cudaGetLastError());
}
