// The STFT's spectrum with its magnitude epilogue: the one spectrum code of
// the port, shared by stft_mag.cu (frames read from the raw audio through
// the reflect pad), stft_dotmag.cu (frames given as a strided view) and
// silero_v31_fused_audio.cu (the same reflect-padded frames inside the step
// kernel). The kernels differ only in where a frame row's samples come from
// and where a magnitude goes; the products, their order and the epilogue are
// this code, so on the same samples they give the same bits.
//
// out[r, c] = sqrt((A@wr)[r, c]^2 + (A@wi)[r, c]^2), A the frame matrix.
// Every magnitude is one fmaf chain per basis in k order from 0.f, then
// sqrtf(re * re + im * im) (the correctly rounded sqrtf: no
// --use_fast_math). No split-K, no reordering, no TF32. The products'
// operands are a template parameter M (tier.cuh): fp32 (the faithful tier,
// and stft_mag.cu's only instance), bf16_3x on fp32 samples (the balanced
// and fast tiers of the v3.1 spectrum: each sample split where it is read,
// the bases packed as hi/lo pairs, three fmafs a term) or bf16 samples and
// bases (turbo), all on the CUDA cores.
//
// Geometry (a template, one instance per kernel): a block of 256 threads
// computes ROWS_PASS frame rows x all bins per pass. The bins are 4 * BGW *
// SPANS + 1: a warp covers one span of 4 * BGW bins, its lane l the 4 bins
// 4 * (l % BGW).. of the span for RT rows of row group l / BGW, so a warp
// holds (32 / BGW) * RT rows. The last bin (Nyquist, the 129th or 65th)
// rides along: the lanes of the warps of the last span sum it for one row
// each (its imaginary basis column is zero and is accumulated all the same).
// Per tap a thread reads two float4 of the bases (real, imaginary) and RT
// samples for 8 * RT FMAs. With BGW = 8 the 8 lanes of a row group read the
// same 128 bytes of the bases (one wavefront for the warp) and the 4 row
// groups 4 samples in 4 banks (one wavefront each): the loop issues 8 * RT
// FMAs for RT + 2 shared loads. With BGW = 32 (the step kernel's instance,
// one row group of RT rows a warp) the bases take 4 wavefronts a float4.
//
// The bases come as one array [n_fft][2][BINS_LD] (real, imaginary, each
// padded with zeros to a multiple of 4 bins; kernels/stft_mag.py:
// padded_basis), so a slice of BK taps is one contiguous, 16-byte aligned
// run. A ring of STAGES slices in shared memory is filled with cp.async
// while the current slice is computed: one barrier a slice. The slices are
// counted across passes, so the next pass's first slices load during this
// pass's last. The instances: stft_mag.cu and stft_dotmag.cu BK = 32, BGW =
// 8, RT = 6, STAGES = 2 (48 rows a pass at 129 bins, 96 at 65; 122 and 128
// registers, no spill; two blocks an SM); the step kernel BK = 8, BGW = 32,
// RT = 7, STAGES = 2 (56 rows; its 128 registers and 100.9 KB a block are
// the body's). Other constants measured slower: PERF.md (chip_profile.py:
// spectrum_variants).
#pragma once

#include <cuda_runtime.h>

#include "tier.cuh"

namespace {
namespace stft_block {

constexpr int MAX_SHARED_BYTES = 232448;  // a block's shared memory on an H100

// Position of padded sample i of a chunk in its staged copy, skewed by one
// float per hop so that the rows of a thread's group (RT frames, RT hops
// apart) fall in distinct banks; a chunk of n padded samples takes
// skewed_len(n) floats.
__host__ __device__ constexpr int skewed(int i, int hop) { return i + i / hop; }
__host__ __device__ constexpr int skewed_len(int n, int hop) { return skewed(n, hop) + 1; }

// 16 bytes from global to shared memory, asynchronously; both 16-byte aligned.
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d), "l"(src) : "memory");
}
// One float from global to shared memory, asynchronously.
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

template <int NFFT_, int BINS_, int BK_, int BGW_, int RT_, int STAGES_>
struct Geometry {
  static constexpr int THREADS = 256;
  static constexpr int WARPS = THREADS / 32;
  static constexpr int NFFT = NFFT_;      // taps
  static constexpr int BINS = BINS_;      // n_fft / 2 + 1
  static constexpr int BK = BK_;          // taps per slice
  static constexpr int BGW = BGW_;        // groups of 4 bins across a warp
  static constexpr int RT = RT_;          // rows per thread
  static constexpr int STAGES = STAGES_;  // slices in the ring
  static constexpr int BINS_LD = (BINS + 3) / 4 * 4;
  static constexpr int ROW_LD = 2 * BINS_LD;  // one tap: real | imaginary
  static constexpr int SLICE = BK * ROW_LD;
  static constexpr int BASIS_FLOATS = STAGES * SLICE;
  static constexpr int N_SLICES = NFFT / BK;
  static constexpr int SPANS = (BINS - 1) / (4 * BGW);  // warps across the bins
  static constexpr int ROWSETS = WARPS / SPANS;
  static constexpr int ROWS_WARP = (32 / BGW) * RT;
  static constexpr int ROWS_PASS = ROWSETS * ROWS_WARP;
  static_assert(BINS == 4 * BGW * SPANS + 1, "bins are whole spans plus the Nyquist bin");
  static_assert(WARPS % SPANS == 0 && 32 % BGW == 0, "whole row sets of warps");
  static_assert(NFFT % BK == 0 && BK % 8 == 0 && STAGES >= 2, "whole slices of 8 taps");
  static_assert(ROWS_WARP <= 32, "one Nyquist row a lane");
};

// One thread's sums of a pass: RT rows x 4 bins of each basis, and the
// Nyquist bin of one row on the lanes that carry it.
template <class G, int M = P_FP32>
struct Tile {
  int col;      // the first of its 4 bins
  int row;      // its first row in the pass (rows row .. row + RT - 1)
  int nyq_row;  // the row of its Nyquist sum, or -1
  float re[G::RT][4], im[G::RT][4], nyq_re, nyq_im;

  __device__ Tile() {
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int span = warp % G::SPANS;
    const int rowset = warp / G::SPANS;
    col = span * 4 * G::BGW + 4 * (lane % G::BGW);
    row = rowset * G::ROWS_WARP + (lane / G::BGW) * G::RT;
    nyq_row = span == G::SPANS - 1 && lane < G::ROWS_WARP ? rowset * G::ROWS_WARP + lane : -1;
  }

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int j = 0; j < G::RT; ++j) {
#pragma unroll
      for (int c = 0; c < 4; ++c) re[j][c] = im[j][c] = 0.f;
    }
    nyq_re = nyq_im = 0.f;
  }

  // The BK taps of one slice: tap kk of row j's frame at a[off[j] + kk], of
  // the Nyquist row's at a[off_nyq + kk]; bb the slice of the bases.
  __device__ __forceinline__ void slice(const float* a, const int (&off)[G::RT], int off_nyq,
                                        const float* bb) {
#pragma unroll 1
    for (int k8 = 0; k8 < G::BK; k8 += 8) {
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int kk = k8 + u;
        const float4 br = *reinterpret_cast<const float4*>(bb + kk * G::ROW_LD + col);
        const float4 bi = *reinterpret_cast<const float4*>(bb + kk * G::ROW_LD + G::BINS_LD + col);
#pragma unroll
        for (int j = 0; j < G::RT; ++j) {
          const Operand<M> s(a[off[j] + kk]);
          re[j][0] = s.fma(br.x, re[j][0]);
          re[j][1] = s.fma(br.y, re[j][1]);
          re[j][2] = s.fma(br.z, re[j][2]);
          re[j][3] = s.fma(br.w, re[j][3]);
          im[j][0] = s.fma(bi.x, im[j][0]);
          im[j][1] = s.fma(bi.y, im[j][1]);
          im[j][2] = s.fma(bi.z, im[j][2]);
          im[j][3] = s.fma(bi.w, im[j][3]);
        }
        if (nyq_row >= 0) {
          const Operand<M> s(a[off_nyq + kk]);
          nyq_re = s.fma(bb[kk * G::ROW_LD + G::BINS - 1], nyq_re);
          nyq_im = s.fma(bb[kk * G::ROW_LD + G::BINS_LD + G::BINS - 1], nyq_im);
        }
      }
    }
  }

  // store(r, c, v) takes the magnitude v of row row0 + r (r < rows), bin c
  template <class Store>
  __device__ __forceinline__ void store(int row0, int rows, const Store& st) const {
#pragma unroll
    for (int j = 0; j < G::RT; ++j) {
      const int r = row0 + row + j;
      if (r >= rows) continue;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float x = re[j][c];
        const float y = im[j][c];
        st(r, col + c, sqrtf(x * x + y * y));
      }
    }
    if (nyq_row >= 0 && row0 + nyq_row < rows) {
      const float x = nyq_re;
      const float y = nyq_im;
      st(row0 + nyq_row, G::BINS - 1, sqrtf(x * x + y * y));
    }
  }
};

// The magnitudes of a pass gathered in shared memory (`tile`, ROWS_PASS x
// BINS floats), then written to rows row0.. of `out` [rows, BINS] with
// consecutive threads on consecutive floats: whole 32-byte sectors, where
// the threads' own 4 bins of RT rows would write each sector in pieces.
template <class G>
struct CoalescedStore {
  float* tile;
  float* out;
  __device__ void operator()(int r, int c, float v) const {
    tile[(r % G::ROWS_PASS) * G::BINS + c] = v;
  }
  __device__ void pass_done(int row0, int rows) const {
    __syncthreads();
    const int n = min(G::ROWS_PASS, rows - row0) * G::BINS;
    float* dst = out + static_cast<long long>(row0) * G::BINS;
    for (int i = threadIdx.x; i < n; i += G::THREADS) dst[i] = tile[i];
  }
};

// Slice `slice` (0 <= slice < N_SLICES) of the bases into ring buffer dst.
template <class G>
__device__ __forceinline__ void load_basis_slice(float* dst, const float* __restrict__ basis,
                                                 int slice) {
  const float* src = basis + static_cast<long long>(slice) * G::SLICE;
  for (int i = threadIdx.x; i < G::SLICE / 4; i += G::THREADS) cp_async16(dst + 4 * i, src + 4 * i);
}

// Magnitudes of rows 0..rows-1 (row r = stream r / n_frames, frame r %
// n_frames) of staged, skewed chunks (stream s at pad + s * pad_ld, padded
// sample i at skewed(i, hop)) against `basis` [NFFT][2][BINS_LD] in global
// memory; bbuf is BASIS_FLOATS of shared memory, 16-byte aligned. hop is a
// multiple of BK. store(r, c, v) takes each magnitude, and
// store.pass_done(row0, rows) follows each pass's (all threads call it). All
// THREADS threads call magnitudes. Copies the caller issued with cp.async
// before the call complete before the first slice is read; plain stores of
// the staging need a barrier before the call. The caller passes a barrier
// after the call before it reads what store wrote to shared memory. M: the
// products' operands, with `basis` packed for them.
template <class G, int M = P_FP32, class Store>
__device__ __forceinline__ void magnitudes(const float* pad, int pad_ld, int hop, int rows,
                                           int n_frames, const float* __restrict__ basis,
                                           float* bbuf, const Store& store) {
  Tile<G, M> tile;
  const int per_hop = hop / G::BK;  // slices per hop: the skew grows by one float each
  const int n_pass = (rows + G::ROWS_PASS - 1) / G::ROWS_PASS;
  const int total = n_pass * G::N_SLICES;
#pragma unroll
  for (int s = 0; s < G::STAGES - 1; ++s) {
    if (s < total) load_basis_slice<G>(bbuf + s * G::SLICE, basis, s % G::N_SLICES);
    cp_async_commit();
  }
  int t = 0;  // slices walked, across passes
  for (int row0 = 0; row0 < rows; row0 += G::ROWS_PASS) {
    // the staged start of each of this thread's rows; rows past the end
    // compute on row 0 and are not stored
    int off[G::RT];
#pragma unroll
    for (int j = 0; j < G::RT; ++j) {
      const int r = row0 + tile.row + j;
      const int rr = r < rows ? r : 0;
      const int s = rr / n_frames;
      off[j] = s * pad_ld + (rr - s * n_frames) * (hop + 1);
    }
    int off_nyq = 0;
    if (tile.nyq_row >= 0 && row0 + tile.nyq_row < rows) {
      const int r = row0 + tile.nyq_row;
      const int s = r / n_frames;
      off_nyq = s * pad_ld + (r - s * n_frames) * (hop + 1);
    }
    tile.zero();
    for (int sl = 0; sl < G::N_SLICES; ++sl, ++t) {
      cp_async_wait<G::STAGES - 2>();
      __syncthreads();
      const int next = t + G::STAGES - 1;
      if (next < total) {
        load_basis_slice<G>(bbuf + (next % G::STAGES) * G::SLICE, basis, next % G::N_SLICES);
      }
      cp_async_commit();
      const int k0 = sl * G::BK + sl / per_hop;  // the slice's first tap, skewed
      tile.slice(pad + k0, off, off_nyq, bbuf + (t % G::STAGES) * G::SLICE);
    }
    tile.store(row0, rows, store);
    store.pass_done(row0, rows);
  }
}

// Raises `kernel`'s dynamic shared memory limit to all that a block may
// use beside its static shared memory, once per device (the limit only
// permits: a launch's occupancy follows the bytes it asks for), so a launch
// costs no cudaFuncSetAttribute call for it.
template <auto kernel>
cudaError_t allow_shared_memory() {
  constexpr int MAX_DEVICES = 64;
  static bool raised[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < MAX_DEVICES && raised[dev])) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             MAX_SHARED_BYTES - static_cast<int>(attr.sharedSizeBytes));
  if (err == cudaSuccess && dev < MAX_DEVICES) raised[dev] = true;
  return err;
}

}  // namespace stft_block
}  // namespace
