// Spectrum dot + magnitude: out[r, c] = sqrt((A@wr)[r, c]^2 + (A@wi)[r, c]^2).
//
// Replaces the Pallas kernel vadc_tpu/kernels/stft_dotmag.py: dot_magnitude
// (pallas_call at :81). A is the frame matrix of the STFT: row r = (chunk b,
// frame f) starts at frames + b*stride_b + f*stride_f (unit stride along
// n_fft), so the wrapper passes the reflect-padded audio's unfold view and
// no frame matrix is written to device memory. Neither is the spectrum:
// both half-spectrum products stay in registers and only the magnitude is
// stored.
//
// What bounds it on an H100: the fp32 FMAs. At batch 2048 of 1536-sample
// chunks (the v3.1 unfold) a call is 51,200 rows x 256 x 258 x 2 = 6.8
// GFLOP, 0.1013 ms at 67 TFLOP/s, against about 13 MB of audio in and 26 MB
// of magnitude out. Each tier's instance (tier.cuh): fp32 products at
// faithful and bf16 frames and bases at turbo (the JAX package's
// bf16-operand use of this kernel) on the CUDA cores as described below;
// bf16_3x on fp32 frames at balanced and fast on the tensor cores,
// stft_tile.cuh's mma.sync tile: a block splits its 64 rows into bf16 hi and
// lo planes once, [64][n_fft + 8] each, and walks the packed bases in slices
// of 16 taps; the pass's magnitudes are gathered over the rows' planes, then
// written out in whole sectors. That instance's bound is the bytes (0.0123
// ms at B=2048; its three products take 0.0206 ms at 989 TFLOP/s).
//
// Design: stft_tile.cuh's spectrum, the inner loop of stft_mag.cu and of
// the step kernel. A block owns ROWS_PASS rows. Each ring stage holds a
// slice of BK taps of the bases and the same taps of the block's rows
// ([ROWS_PASS][BK + 4], the 4 floats of padding keeping a thread's rows in
// distinct banks), both filled with cp.async while the previous slice is
// computed: 16-byte copies when the base and both strides are 16-byte
// aligned (the unfold of the padded audio is), 4-byte copies otherwise.
// The pass's magnitudes are gathered in shared memory and written out in
// whole sectors. ptxas: 128 registers, no spill, no stack, in all four
// kernels (two instances, aligned or not); 106.2 KB a block at 129 bins
// (87.4 KB at 65), two blocks an SM. On one H100 80GB HBM3 at 700 W
// (chip_smoke.py): 0.2029 ms at the v3.1 unfold B=2048 x 1536, 50 % of the
// bound (the first design, a 64 x 32 tile: 0.32).
#include <cuda_runtime.h>

#include <cstdint>

#include "stft_tile.cuh"

namespace {

using Spectrum256 = stft_block::Geometry<256, 129, 32, 8, 6, 2>;
using Spectrum128 = stft_block::Geometry<128, 65, 32, 8, 6, 2>;
// bf16_3x on the tensor cores: 4 m-tiles (64 rows) a block, 16 taps a slice
using SpectrumMma256 = stft_block::MmaGeometry<256, 129, 16, 4, 2>;

template <class G>
struct Rows {
  static constexpr int LD = G::BK + 4;  // floats of one row's slice
  static constexpr int STAGE = G::ROWS_PASS * LD;
  static constexpr int SMEM_FLOATS = G::BASIS_FLOATS + G::STAGES * STAGE + G::ROWS_PASS * G::BINS;
};

// Slice `slice` of the block's rows into dst [ROWS_PASS][LD]; rows[p] is row
// p's first sample.
template <class G, bool ALIGNED>
__device__ __forceinline__ void load_rows_slice(float* dst, const float* const* rows, int slice) {
  const int k0 = slice * G::BK;
  if (ALIGNED) {
    constexpr int PER_ROW = G::BK / 4;
    for (int i = threadIdx.x; i < G::ROWS_PASS * PER_ROW; i += G::THREADS) {
      const int p = i / PER_ROW;
      const int c = 4 * (i - p * PER_ROW);
      stft_block::cp_async16(dst + p * Rows<G>::LD + c, rows[p] + k0 + c);
    }
  } else {
    for (int i = threadIdx.x; i < G::ROWS_PASS * G::BK; i += G::THREADS) {
      const int p = i / G::BK;
      const int c = i - p * G::BK;
      stft_block::cp_async4(dst + p * Rows<G>::LD + c, rows[p] + k0 + c);
    }
  }
}

template <class G, bool ALIGNED, int M>
__global__ void __launch_bounds__(G::THREADS, 2)
dot_magnitude_kernel(const float* __restrict__ frames, int n_frames, long long stride_b,
                     long long stride_f, int rows, const float* __restrict__ basis,
                     float* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  __shared__ const float* row_ptr[G::ROWS_PASS];
  float* bbuf = smem;
  float* abuf = smem + G::BASIS_FLOATS;
  const int row0 = blockIdx.x * G::ROWS_PASS;
  const int live = min(G::ROWS_PASS, rows - row0);
  // rows past the end copy the last row and are not stored
  for (int p = threadIdx.x; p < G::ROWS_PASS; p += G::THREADS) {
    const int r = row0 + min(p, live - 1);
    const int b = r / n_frames;
    row_ptr[p] = frames + b * stride_b + (r - b * n_frames) * stride_f;
  }
  __syncthreads();

  stft_block::Tile<G, M> tile;
  int off[G::RT];
#pragma unroll
  for (int j = 0; j < G::RT; ++j) off[j] = (tile.row + j) * Rows<G>::LD;
  const int off_nyq = tile.nyq_row >= 0 ? tile.nyq_row * Rows<G>::LD : 0;
  tile.zero();
#pragma unroll
  for (int s = 0; s < G::STAGES - 1; ++s) {
    stft_block::load_basis_slice<G>(bbuf + s * G::SLICE, basis, s);
    load_rows_slice<G, ALIGNED>(abuf + s * Rows<G>::STAGE, row_ptr, s);
    stft_block::cp_async_commit();
  }
  for (int sl = 0; sl < G::N_SLICES; ++sl) {
    stft_block::cp_async_wait<G::STAGES - 2>();
    __syncthreads();
    const int next = sl + G::STAGES - 1;
    if (next < G::N_SLICES) {
      const int stage = next % G::STAGES;
      stft_block::load_basis_slice<G>(bbuf + stage * G::SLICE, basis, next);
      load_rows_slice<G, ALIGNED>(abuf + stage * Rows<G>::STAGE, row_ptr, next);
    }
    stft_block::cp_async_commit();
    const int stage = sl % G::STAGES;
    tile.slice(abuf + stage * Rows<G>::STAGE, off, off_nyq, bbuf + stage * G::SLICE);
  }
  const stft_block::CoalescedStore<G> store{abuf + G::STAGES * Rows<G>::STAGE,
                                            out + static_cast<long long>(row0) * G::BINS};
  tile.store(0, live, store);
  store.pass_done(0, live);
}

// bf16_3x on the tensor cores: the block's rows as bf16 planes [hi |
// lo][ROWS_PASS][LD], row p's tap k at p * LD + k, split from the frames
// once; the pass's magnitudes are gathered over the planes (a barrier after
// the last slice) and written out in whole sectors.
template <class G>
struct RowsMma {
  static constexpr int LD = G::NFFT + 8;  // bf16; rows 16 bytes apart modulo 128
  static constexpr int PLANE = G::ROWS_PASS * LD;
  static constexpr size_t SMEM_BYTES = G::BASIS_BYTES + 4 * static_cast<size_t>(PLANE);
  static_assert(4 * PLANE >= 4 * G::ROWS_PASS * G::BINS, "the magnitudes fit the rows");
};

template <class G>
__global__ void __launch_bounds__(G::THREADS, 2)
dot_magnitude_mma_kernel(const float* __restrict__ frames, int n_frames, long long stride_b,
                         long long stride_f, int rows, const __nv_bfloat16* __restrict__ basis,
                         float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* bbuf = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* a_hi = bbuf + G::STAGES * G::SLICE;
  const int row0 = blockIdx.x * G::ROWS_PASS;
  const int live = min(G::ROWS_PASS, rows - row0);
  // rows past the end are not staged: the tile computes them on the last row
  for (int i = threadIdx.x; i < live * G::NFFT; i += G::THREADS) {
    const int p = i / G::NFFT;
    const int k = i - p * G::NFFT;
    const int r = row0 + p;
    const int b = r / n_frames;
    const float v = frames[b * stride_b + (r - b * n_frames) * stride_f + k];
    split_store(a_hi + p * RowsMma<G>::LD + k, a_hi + RowsMma<G>::PLANE + p * RowsMma<G>::LD + k, v);
  }
  const stft_block::CoalescedStore<G> store{reinterpret_cast<float*>(a_hi),
                                            out + static_cast<long long>(row0) * G::BINS};
  const auto row_at = [](int r) { return r * RowsMma<G>::LD; };
  stft_block::magnitudes_mma<G>(a_hi, RowsMma<G>::PLANE, row_at, G::NFFT, live, basis, bbuf,
                                store);
}

template <class G>
int launch_mma(const float* frames, int n_frames, long long stride_b, long long stride_f,
               int rows, const void* basis, float* out, cudaStream_t stream) {
  const cudaError_t err = stft_block::allow_shared_memory<dot_magnitude_mma_kernel<G>>();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = (rows + G::ROWS_PASS - 1) / G::ROWS_PASS;
  dot_magnitude_mma_kernel<G><<<grid, G::THREADS, RowsMma<G>::SMEM_BYTES, stream>>>(
      frames, n_frames, stride_b, stride_f, rows, static_cast<const __nv_bfloat16*>(basis), out);
  return static_cast<int>(cudaGetLastError());
}

template <class G, bool ALIGNED, int M>
int launch(const float* frames, int n_frames, long long stride_b, long long stride_f, int rows,
           const float* basis, float* out, cudaStream_t stream) {
  constexpr size_t bytes = sizeof(float) * Rows<G>::SMEM_FLOATS;
  const cudaError_t err = stft_block::allow_shared_memory<dot_magnitude_kernel<G, ALIGNED, M>>();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = (rows + G::ROWS_PASS - 1) / G::ROWS_PASS;
  dot_magnitude_kernel<G, ALIGNED, M><<<grid, G::THREADS, bytes, stream>>>(
      frames, n_frames, stride_b, stride_f, rows, basis, out);
  return static_cast<int>(cudaGetLastError());
}

template <class G, int M>
int launch(const float* frames, int n_frames, long long stride_b, long long stride_f, int rows,
           const float* basis, float* out, cudaStream_t stream) {
  const bool aligned = reinterpret_cast<std::uintptr_t>(frames) % 16 == 0 && stride_b % 4 == 0 &&
                       stride_f % 4 == 0;
  return aligned
             ? launch<G, true, M>(frames, n_frames, stride_b, stride_f, rows, basis, out, stream)
             : launch<G, false, M>(frames, n_frames, stride_b, stride_f, rows, basis, out, stream);
}

}  // namespace

// frames: row (b, f) of the frame matrix at frames + b*stride_b + f*stride_f
// (unit stride along n_fft); basis: packed for the tier's STFT operands as
// kernels/stft_dotmag.py: padded_basis packs them (faithful: [n_fft][2][BINS_LD]
// fp32, tap k's real then imaginary basis row, each `cutoff` bins padded
// with zeros to a multiple of 4, and so at turbo; balanced and fast:
// [n_fft][LDB] bf16); out:
// [batch * n_frames, cutoff] row-major; tier: 0 faithful, 1 balanced, 2
// fast, 3 turbo. Takes (n_fft, cutoff) = (256, 129) at every tier, (128, 65)
// at faithful. Returns cudaGetLastError() after the launch.
extern "C" int vadc_dot_magnitude(const float* frames, int batch, int n_frames,
                                  long long stride_b, long long stride_f, const void* basis,
                                  int n_fft, int cutoff, float* out, int tier, void* stream) {
  const int rows = batch * n_frames;
  if (rows <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* fbasis = static_cast<const float*>(basis);
  if (n_fft == 256 && cutoff == 129) {
    // the tier's instance: its STFT operands (tier.cuh)
    return by_tier(tier, [&](auto t) {
      constexpr int M = Tier<decltype(t)::value>::kStft;
      if constexpr (M == P_SPLIT) {
        return launch_mma<SpectrumMma256>(frames, n_frames, stride_b, stride_f, rows, basis,
                                          out, s);
      } else {
        return launch<Spectrum256, M>(frames, n_frames, stride_b, stride_f, rows, fbasis, out, s);
      }
    });
  }
  if (n_fft == 128 && cutoff == 65 && tier == TIER_FAITHFUL) {
    return launch<Spectrum128, P_FP32>(frames, n_frames, stride_b, stride_f, rows, fbasis, out, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
