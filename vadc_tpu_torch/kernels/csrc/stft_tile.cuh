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
}  // namespace
