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
// operands are a template parameter M (tier.cuh): fp32 (the faithful tier)
// and bf16 samples and bases (turbo, and v5's fast) on the CUDA cores in
// this tile (Tile, magnitudes; stft_mag.cu and the step kernel round the
// samples once where they stage them and run it at fp32, the same bits);
// bf16_3x on fp32 samples (the balanced and
// fast tiers of the v3.1 and v4 spectrum, v5's balanced) on the tensor
// cores, in the tile at the end of this file (TileMma, magnitudes_mma),
// whose own account, and why the bf16 mode stays here, are there.
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

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "mma.cuh"
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

// ---- bf16_3x on the tensor cores ---------------------------------------------
//
// At M = P_SPLIT the spectrum is an mma.sync product (mma.cuh): frames
// [rows, NFFT] split into bf16 hi and lo times the bases [NFFT, 2 x
// BINS_PAD] split the same way, the bins padded with zeros to a whole
// number of n8 tiles (129 -> 136, 65 -> 72), so the Nyquist bin is a column
// like the others. One shape and one k order in all three kernels, so they
// keep one another's bits: m16n8k8 in k order, each step lo*hi, hi*lo,
// hi*hi in one chain from zero, added to the fp32 sum (mma_add3_k8), then
// sqrtf(re * re + im * im). m16n8k8 keeps the step kernel's ring at 8 taps
// a slice: 16-tap hi + lo slices do not fit beside its staged chunks.
//
// The bf16 mode (P_BF16) stays on the CUDA cores (Tile above). On the
// tensor cores its sums, blocks of 8 products then fp32 adds, agree with
// the k-order fp32 sums of the plain versions (cuBLAS and the CPU's, which
// agree with each other on 99.3 % of the magnitudes) on 25-48 % of the
// magnitudes, where the CUDA-core chain agrees on 80-91 %; v5's spectrum
// feeds its convs' bf16 operands directly, each disagreement can flip a
// bf16 rounding there, and the v5 paths at fast and turbo then broke
// kernels/tier_check.py's PATH_MAX card against CPU (PERF.md). bf16_3x
// operands carry no such rounding, and every path holds it.
//
// Operands. The samples are split once, where they are staged: bf16 hi and
// lo planes with the skew of 8 values (16 bytes) a hop, so that the frame
// rows of an ldmatrix (hop + 8 values apart) fall in 8 distinct 16-byte bank
// groups and stay 16-byte aligned. The bases come packed by the wrapper
// (kernels/stft_dotmag.py: padded_basis): a tap is one row of LDB bf16, the
// real bins of hi then its imaginary ones, the same of lo, then 8 zeros that
// skew the rows of a slice across the banks; a slice of BK taps is one
// contiguous run, copied by cp.async into a ring of STAGES slices as the
// fp32 tile's is. A warp takes m-tile warp % MT of a pass (16 rows) and the
// bin tiles warp / MT, warp / MT + WARPS / MT, ..: both bases of a bin tile
// come from one ldmatrix (.x2.trans), so each thread holds re and im of the
// same (row, bin) for the epilogue.
template <int NFFT_, int BINS_, int BK_, int MT_, int STAGES_>
struct MmaGeometry {
  static constexpr int THREADS = 256;
  static constexpr int WARPS = THREADS / 32;
  static constexpr int NFFT = NFFT_;
  static constexpr int BINS = BINS_;
  static constexpr int BK = BK_;          // taps per slice
  static constexpr int MT = MT_;          // m-tiles of 16 rows a pass
  static constexpr int STAGES = STAGES_;  // slices in the ring
  static constexpr int BIN_TILES = (BINS + 7) / 8;
  static constexpr int BINS_PAD = 8 * BIN_TILES;
  static constexpr int LDB = 4 * BINS_PAD + 8;  // bf16 of one tap of the bases
  static constexpr int SLICE = BK * LDB;        // bf16 of a slice
  static constexpr int BASIS_BYTES = STAGES * SLICE * 2;
  static constexpr int N_SLICES = NFFT / BK;
  static constexpr int TILE_STEP = WARPS / MT;  // from one of a warp's bin tiles to the next
  static constexpr int NTW = (BIN_TILES + TILE_STEP - 1) / TILE_STEP;  // a warp's bin tiles
  static constexpr int ROWS_PASS = 16 * MT;
  static_assert(WARPS % MT == 0 && NFFT % BK == 0 && BK % 8 == 0 && STAGES >= 2,
                "whole row tiles and slices of k8 steps");
};

// Position of padded sample i of a chunk in its staged bf16 planes: skewed by
// 8 values a hop (hop a multiple of 8).
__host__ __device__ constexpr int skewed_bf16(int i, int hop) { return i + (i / hop) * 8; }

// 16 bytes from global to shared memory, asynchronously; both 16-byte aligned.
__device__ __forceinline__ void cp_async16(__nv_bfloat16* dst, const __nv_bfloat16* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d), "l"(src) : "memory");
}

// One thread's sums of a pass: re and im of its rows (lane / 4 and lane / 4
// + 8 of the warp's m-tile) at 2 bins of each of the warp's bin tiles.
template <class G>
struct TileMma {
  int lane;
  int mt;      // the warp's m-tile of the pass
  int j0;      // its first bin tile
  int b_lane;  // this lane's row of an ldmatrix of the bases, in a slice
  float re[G::NTW][4], im[G::NTW][4];

  __device__ TileMma() {
    lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    mt = warp % G::MT;
    j0 = warp / G::MT;
    // lanes 0-7: tap rows of the real bases, 8-15 of the imaginary
    b_lane = (lane % 8) * G::LDB + ((lane / 8) % 2) * G::BINS_PAD;
  }

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < G::NTW; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) re[i][e] = im[i][e] = 0.f;
    }
  }

  // One k8 step: `a` this lane's row of the A operand at the step's first
  // (skewed) tap in the hi plane, `lo_at` the lo plane's offset from it; bb
  // the tap row of the step in the ring's slice.
  __device__ __forceinline__ void step(const __nv_bfloat16* a, int lo_at,
                                       const __nv_bfloat16* bb) {
    uint32_t ah[2], al[2];
    ldmatrix_x2<false>(ah, a);
    ldmatrix_x2<false>(al, a + lo_at);
#pragma unroll
    for (int i = 0; i < G::NTW; ++i) {
      const int j = j0 + i * G::TILE_STEP;
      if (G::BIN_TILES % G::TILE_STEP != 0 && j >= G::BIN_TILES) break;  // uniform in the warp
      uint32_t bh[2], bl[2];
      ldmatrix_x2<true>(bh, bb + b_lane + 8 * j);
      ldmatrix_x2<true>(bl, bb + b_lane + 2 * G::BINS_PAD + 8 * j);
      mma_add3_k8(re[i], ah, al, bh[0], bl[0]);
      mma_add3_k8(im[i], ah, al, bh[1], bl[1]);
    }
  }

  // store(r, c, v) takes the magnitude v of row r (< rows), bin c (< BINS)
  template <class Store>
  __device__ __forceinline__ void store(int row0, int rows, const Store& st) const {
    const int r0 = row0 + 16 * mt + lane / 4;
#pragma unroll
    for (int i = 0; i < G::NTW; ++i) {
      const int c0 = 8 * (j0 + i * G::TILE_STEP) + 2 * (lane % 4);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = r0 + 8 * (e / 2);
        const int c = c0 + e % 2;
        if (r >= rows || c >= G::BINS) continue;
        const float x = re[i][e];
        const float y = im[i][e];
        st(r, c, sqrtf(x * x + y * y));
      }
    }
  }
};

// Slice `slice` of the packed bases into ring buffer dst.
template <class G>
__device__ __forceinline__ void load_basis_slice_mma(__nv_bfloat16* dst,
                                                     const __nv_bfloat16* __restrict__ basis,
                                                     int slice) {
  const __nv_bfloat16* src = basis + static_cast<long long>(slice) * G::SLICE;
  for (int i = threadIdx.x; i < G::SLICE / 8; i += G::THREADS) cp_async16(dst + 8 * i, src + 8 * i);
}

// Magnitudes of rows 0..rows-1 by bf16_3x, as `magnitudes` computes them
// at fp32: row r's tap k at a_hi[row_at(r) + skewed_bf16(k, hop)] and its lo
// at the same place + lo_at, against `basis` [NFFT][LDB] (bf16 hi and lo)
// in global memory; bbuf is G::BASIS_BYTES of shared
// memory, 16-byte aligned. hop is a multiple of BK (NFFT where the rows are
// not skewed). store(r, c, v) takes each magnitude and store.pass_done(row0,
// rows) follows each pass's; a barrier passes before a pass's stores, so
// they may overwrite the staged rows. All THREADS threads call it; plain
// stores of the staging are ordered before the first read by the first
// slice's barrier.
template <class G, class RowAt, class Store>
__device__ __forceinline__ void magnitudes_mma(const __nv_bfloat16* a_hi, int lo_at,
                                               const RowAt& row_at, int hop, int rows,
                                               const __nv_bfloat16* __restrict__ basis,
                                               __nv_bfloat16* bbuf, const Store& store) {
  TileMma<G> tile;
  const int per_hop = hop / G::BK;  // slices per hop: the skew grows by 8 values each
  const int n_pass = (rows + G::ROWS_PASS - 1) / G::ROWS_PASS;
  const int total = n_pass * G::N_SLICES;
#pragma unroll
  for (int s = 0; s < G::STAGES - 1; ++s) {
    if (s < total) load_basis_slice_mma<G>(bbuf + s * G::SLICE, basis, s % G::N_SLICES);
    cp_async_commit();
  }
  int t = 0;  // slices walked, across passes
  for (int row0 = 0; row0 < rows; row0 += G::ROWS_PASS) {
    // this lane's ldmatrix row; rows past the end compute on the last row
    // and are not stored
    const int r = row0 + 16 * tile.mt + tile.lane % 16;
    const __nv_bfloat16* a = a_hi + row_at(r < rows ? r : rows - 1);
    tile.zero();
    for (int sl = 0; sl < G::N_SLICES; ++sl, ++t) {
      cp_async_wait<G::STAGES - 2>();
      __syncthreads();
      const int next = t + G::STAGES - 1;
      if (next < total) {
        load_basis_slice_mma<G>(bbuf + (next % G::STAGES) * G::SLICE, basis, next % G::N_SLICES);
      }
      cp_async_commit();
      const int k0 = sl * G::BK + (sl / per_hop) * 8;  // the slice's first tap, skewed
      const __nv_bfloat16* bb = bbuf + (t % G::STAGES) * G::SLICE;
#pragma unroll
      for (int kk = 0; kk < G::BK; kk += 8) tile.step(a + k0 + kk, lo_at, bb + kk * G::LDB);
    }
    __syncthreads();
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
