// The STFT's spectrum tile with its magnitude epilogue, shared by
// stft_dotmag.cu (frames given as a strided view), stft_mag.cu (frames read
// from the raw audio through the reflect pad) and silero_v31_fused_audio.cu
// (the same reflect-padded frames, tile by tile inside one block). The
// kernels differ only in where a frame row's samples come from and where a
// magnitude goes; the products, their order and the epilogue are this one
// code, so on the same samples they give the same bits.
//
// out[r, c] = sqrt((A@wr)[r, c]^2 + (A@wi)[r, c]^2), A the frame matrix.
// A classic shared-memory tiled SGEMM: a block computes 64 rows x 32 bins
// for BOTH bases; each of its 256 threads holds 4 rows x 2 bins of the real
// and the imaginary sum (16 accumulators), fp32 FMAs in k order. The
// contraction runs in slices of 32: the frame slice is stored transposed in
// shared memory (one float of padding against bank conflicts) and both
// basis slices beside it. Rows past `rows`, taps past n_fft and bins past
// cutoff are masked, so any n_fft and cutoff work (129 and 65 bins are not
// multiples of 32). sqrtf is the correctly rounded one (no --use_fast_math).
//
// stft_block below is the spectrum of silero_v31_fused_audio.cu's blocks: the
// same sums in the same order (so the same bits) with a geometry fitted to
// one block's rows; its comment says what it does differently.
#pragma once

#include <cuda_runtime.h>

namespace {
namespace stft_tile {

constexpr int BM = 64;   // frame rows per block
constexpr int BN = 32;   // bins per block
constexpr int BK = 32;   // contraction slice
constexpr int TM = 4;    // rows per thread
constexpr int TN = 2;    // bins per thread
constexpr int THREADS = (BM / TM) * (BN / TN);  // 256
constexpr int ROWS_PER_LOAD = THREADS / BK;     // 8 rows loaded per pass
constexpr int LOADS = BM / ROWS_PER_LOAD;       // rows a thread loads

struct Smem {
  float As[BK][BM + 1];  // As[k][m]: transposed frame slice
  float Brs[BK][BN];
  float Bis[BK][BN];
};

inline dim3 grid(int rows, int cutoff) {
  return dim3((rows + BM - 1) / BM, (cutoff + BN - 1) / BN);
}

// Src says where the samples of frame row r (0 <= r < rows) are:
//   typename Src::Row   a row's handle, computed once per row;
//   Src::row(r)         the handle of row r;
//   Src::load(row, k)   sample k (0 <= k < n_fft) of that row.
// Store(r, c, v) puts the magnitude v of row r, bin c where it belongs.
// Computes the tile of rows row0.. and bins col0.. with THREADS threads; all
// of them must call it (it has barriers, and ends on one).
template <class Src, class Store>
__device__ __forceinline__ void magnitude_tile_at(Smem& sm, const Src& src, int rows, int row0,
                                                  int col0, const float* __restrict__ wr,
                                                  const float* __restrict__ wi, int n_fft,
                                                  int cutoff, const Store& store) {
  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);  // bin group
  const int ty = tid / (BN / TN);  // row group

  // this thread loads column kk of rows m0, m0 + 8, ... of every frame slice
  const int kk_load = tid % BK;
  const int m0 = tid / BK;
  typename Src::Row row[LOADS];
  bool live[LOADS];
#pragma unroll
  for (int j = 0; j < LOADS; ++j) {
    const int r = row0 + m0 + j * ROWS_PER_LOAD;
    live[j] = r < rows;
    row[j] = src.row(live[j] ? r : 0);
  }

  float acc_r[TM][TN] = {};
  float acc_i[TM][TN] = {};

  for (int k0 = 0; k0 < n_fft; k0 += BK) {
    const int k = k0 + kk_load;
#pragma unroll
    for (int j = 0; j < LOADS; ++j) {
      sm.As[kk_load][m0 + j * ROWS_PER_LOAD] = (live[j] && k < n_fft) ? src.load(row[j], k) : 0.f;
    }
    for (int i = tid; i < BK * BN; i += THREADS) {
      const int kb = i / BN;
      const int n = i % BN;
      const bool ok = (k0 + kb < n_fft) && (col0 + n < cutoff);
      const long long w = static_cast<long long>(k0 + kb) * cutoff + col0 + n;
      sm.Brs[kb][n] = ok ? wr[w] : 0.f;
      sm.Bis[kb][n] = ok ? wi[w] : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kb = 0; kb < BK; ++kb) {
      float a[TM];
      float br[TN];
      float bi[TN];
#pragma unroll
      for (int j = 0; j < TM; ++j) a[j] = sm.As[kb][ty * TM + j];
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        br[j] = sm.Brs[kb][tx * TN + j];
        bi[j] = sm.Bis[kb][tx * TN + j];
      }
#pragma unroll
      for (int m = 0; m < TM; ++m) {
#pragma unroll
        for (int n = 0; n < TN; ++n) {
          acc_r[m][n] = fmaf(a[m], br[n], acc_r[m][n]);
          acc_i[m][n] = fmaf(a[m], bi[n], acc_i[m][n]);
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int m = 0; m < TM; ++m) {
    const int r = row0 + ty * TM + m;
    if (r >= rows) continue;
#pragma unroll
    for (int n = 0; n < TN; ++n) {
      const int col = col0 + tx * TN + n;
      if (col < cutoff) {
        const float re = acc_r[m][n];
        const float im = acc_i[m][n];
        store(r, col, sqrtf(re * re + im * im));
      }
    }
  }
}

// magnitudes row-major [rows, cutoff] in device memory
struct RowMajor {
  float* out;
  int cutoff;
  __device__ void operator()(int r, int c, float v) const {
    out[static_cast<long long>(r) * cutoff + c] = v;
  }
};

// The tile of block (blockIdx.x, blockIdx.y) of a grid(rows, cutoff) launch,
// stored row-major to out [rows, cutoff].
template <class Src>
__device__ __forceinline__ void magnitude_tile(Smem& sm, const Src& src, int rows,
                                               const float* __restrict__ wr,
                                               const float* __restrict__ wi, int n_fft,
                                               int cutoff, float* __restrict__ out) {
  magnitude_tile_at(sm, src, rows, blockIdx.x * BM, blockIdx.y * BN, wr, wi, n_fft, cutoff,
                    RowMajor{out, cutoff});
}

// Frame rows read from raw audio through the reflect pad: row r is frame f
// of chunk b (r = b * n_frames + f); padded sample i of a chunk is
// audio[b, j] with j = i - pad_left, reflected at both edges (edge
// excluded, PyTorch's 'reflect'): j < 0 -> -j, j >= S -> 2S - 2 - j. Each
// pad must be < S.
struct PaddedAudio {
  struct Row {
    const float* chunk;
    int start;  // padded index of the frame's first sample, minus pad_left
  };
  const float* audio;
  int n_frames;
  long long stride_b;
  int samples;
  int pad_left;
  int hop;

  __device__ Row row(int r) const {
    const int b = r / n_frames;
    const int f = r - b * n_frames;
    return Row{audio + b * stride_b, f * hop - pad_left};
  }
  __device__ float load(Row row, int k) const {
    int j = row.start + k;
    j = j < 0 ? -j : j;
    j = j >= samples ? 2 * samples - 2 - j : j;
    return row.chunk[j];
  }
};

}  // namespace stft_tile

// The spectrum of one block of silero_v31_fused_audio.cu: up to 100 frame
// rows (4 streams x 25 frames) x 129 bins, the frames overlapping windows of
// the streams' reflect-padded chunks, which the block has staged in shared
// memory once. Each magnitude is stft_tile's: one fmaf chain per basis in k
// order from 0.f, then sqrtf(re * re + im * im); so the bits are
// dot_magnitude's. What differs is the geometry and the data movement:
//   - a warp is one group of RT = 7 rows and its 32 lanes are the 32 groups
//     of 4 bins that cover bins 0..127: a thread holds 7 x 4 sums for each
//     basis (56 accumulators) and per tap reads two float4 of the bases and
//     7 samples, all broadcast within the warp: 58 FMAs for 12 loads (the
//     64 x 32 tile: 16 for 8). 8 warps cover 56 rows a pass, so 100 rows x
//     129 bins take 2 passes that are 89 % useful (the tile: 10 passes over
//     128 x 160, 63 %);
//   - the Nyquist bin, the 129th, rides along: lane l < 7 of each warp also
//     sums row l of its group against column 128 (its imaginary basis
//     column is zero and is accumulated all the same);
//   - the bases come as one array [n_fft][2][132] (real, imaginary, each
//     padded to a multiple of 4 bins; built once by the wrapper), so a slice
//     of BK = 8 taps is one contiguous, 16-byte aligned run that cp.async
//     copies into one of two buffers while the other slice is computed: one
//     barrier a slice, no scalar refill;
//   - the staged samples are skewed by one float per hop, so the 7 rows of a
//     group (64 samples apart) fall in distinct banks.
namespace stft_block {

constexpr int THREADS = 256;
constexpr int RT = 7;                          // rows per thread
constexpr int ROWS_PASS = (THREADS / 32) * RT;  // 56
constexpr int BK = 8;                          // taps per slice
constexpr int BINS_LD = 132;                   // 129 bins padded to a multiple of 4
constexpr int ROW_LD = 2 * BINS_LD;            // one tap: real | imaginary
constexpr int SLICE = BK * ROW_LD;
constexpr int BASIS_FLOATS = 2 * SLICE;        // the two slice buffers

// Position of padded sample i of a chunk in its staged, skewed copy; a
// chunk of n padded samples takes skewed_len(n) floats.
__host__ __device__ constexpr int skewed(int i, int hop) { return i + i / hop; }
__host__ __device__ constexpr int skewed_len(int n, int hop) { return skewed(n, hop) + 1; }

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d), "l"(src) : "memory");
}

// Magnitudes of rows 0..rows-1 (row r = stream r / n_frames, frame r %
// n_frames) over the staged chunks `pad` (stream s at pad + s * pad_ld,
// skewed) against `basis` [n_fft][2][BINS_LD] in global memory; bbuf is
// BASIS_FLOATS of shared memory, 16-byte aligned. store(r, c, v) takes each
// magnitude. n_fft is a multiple of BK and of hop. All THREADS threads call
// it; the caller passes a barrier after the staging before, and one after
// the call before it reads what store wrote.
template <class Store>
__device__ __forceinline__ void magnitudes(const float* pad, int pad_ld, int hop, int rows,
                                           int n_frames, int n_fft,
                                           const float* __restrict__ basis, float* bbuf,
                                           const Store& store) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_slices = n_fft / BK;
  const int per_hop = hop / BK;  // slices per hop: the skew grows by one float each

  for (int row0 = 0; row0 < rows; row0 += ROWS_PASS) {
    // the staged start of each of this thread's rows; rows past the end
    // compute on row 0 and are not stored
    int off[RT];
#pragma unroll
    for (int j = 0; j < RT; ++j) {
      const int r = row0 + warp * RT + j;
      const int rr = r < rows ? r : 0;
      const int s = rr / n_frames;
      off[j] = s * pad_ld + (rr - s * n_frames) * (hop + 1);
    }
    const int r_nyq = row0 + warp * RT + lane;  // lanes 0..RT-1
    const bool nyq = lane < RT && r_nyq < rows;
    int off_nyq = 0;
    if (nyq) {
      const int s = r_nyq / n_frames;
      off_nyq = s * pad_ld + (r_nyq - s * n_frames) * (hop + 1);
    }
    float acc_r[RT][4] = {};
    float acc_i[RT][4] = {};
    float nyq_r = 0.f, nyq_i = 0.f;

    for (int i = tid; i < SLICE / 4; i += THREADS) cp_async16(bbuf + 4 * i, basis + 4 * i);
    for (int sl = 0; sl < n_slices; ++sl) {
      asm volatile("cp.async.wait_all;" ::: "memory");
      __syncthreads();
      if (sl + 1 < n_slices) {
        float* dst = bbuf + ((sl + 1) & 1) * SLICE;
        const float* src = basis + static_cast<long long>(sl + 1) * SLICE;
        for (int i = tid; i < SLICE / 4; i += THREADS) cp_async16(dst + 4 * i, src + 4 * i);
      }
      const float* bb = bbuf + (sl & 1) * SLICE;
      const int k0 = sl * BK + sl / per_hop;  // the slice's first tap, skewed
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        const float4 br = *reinterpret_cast<const float4*>(bb + kk * ROW_LD + 4 * lane);
        const float4 bi =
            *reinterpret_cast<const float4*>(bb + kk * ROW_LD + BINS_LD + 4 * lane);
#pragma unroll
        for (int j = 0; j < RT; ++j) {
          const float a = pad[off[j] + k0 + kk];
          acc_r[j][0] = fmaf(a, br.x, acc_r[j][0]);
          acc_r[j][1] = fmaf(a, br.y, acc_r[j][1]);
          acc_r[j][2] = fmaf(a, br.z, acc_r[j][2]);
          acc_r[j][3] = fmaf(a, br.w, acc_r[j][3]);
          acc_i[j][0] = fmaf(a, bi.x, acc_i[j][0]);
          acc_i[j][1] = fmaf(a, bi.y, acc_i[j][1]);
          acc_i[j][2] = fmaf(a, bi.z, acc_i[j][2]);
          acc_i[j][3] = fmaf(a, bi.w, acc_i[j][3]);
        }
        if (nyq) {
          const float a = pad[off_nyq + k0 + kk];
          nyq_r = fmaf(a, bb[kk * ROW_LD + 4 * 32], nyq_r);
          nyq_i = fmaf(a, bb[kk * ROW_LD + BINS_LD + 4 * 32], nyq_i);
        }
      }
    }

#pragma unroll
    for (int j = 0; j < RT; ++j) {
      const int r = row0 + warp * RT + j;
      if (r >= rows) continue;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float re = acc_r[j][c];
        const float im = acc_i[j][c];
        store(r, 4 * lane + c, sqrtf(re * re + im * im));
      }
    }
    if (nyq) {
      const float re = nyq_r;
      const float im = nyq_i;
      store(r_nyq, 4 * 32, sqrtf(re * re + im * im));
    }
  }
}

}  // namespace stft_block
}  // namespace
