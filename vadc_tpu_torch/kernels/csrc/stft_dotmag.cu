// Spectrum dot + magnitude: out[r, c] = sqrt((A@wr)[r, c]^2 + (A@wi)[r, c]^2).
//
// Replaces the Pallas kernel vadc_tpu/kernels/stft_dotmag.py: dot_magnitude
// (pallas_call at :81). A is the frame matrix of the STFT: row r = (chunk b,
// frame f) starts at frames + b*stride_b + f*stride_f, so the wrapper passes
// the reflect-padded audio's unfold view and no frame matrix is written to
// device memory. Neither is the spectrum: both half-spectrum products stay
// in registers and only the magnitude is stored.
//
// What bounds it on an H100: the fp32 FMAs. At batch 2048 of 1536-sample
// chunks a step is 51,200 rows x 256 x 258 x 2 = 6.8 GFLOP, against about
// 13 MB of audio in and 26 MB of magnitude out. The faithful tier keeps
// fp32 products, so this runs on the CUDA cores, not on tensor cores (a
// wgmma path on bf16 operands is the later work of the bf16 tiers).
//
// Design: a classic shared-memory tiled SGEMM. A block computes 64 rows x
// 32 bins for BOTH bases; each of its 256 threads holds 4 rows x 2 bins of
// the real and the imaginary sum (16 accumulators). The contraction runs in
// slices of 32: the frame slice is stored transposed in shared memory (with
// one float of padding against bank conflicts) and both basis slices beside
// it. sqrtf is the correctly rounded one (no --use_fast_math).
#include <cuda_runtime.h>

namespace {

constexpr int BM = 64;   // frame rows per block
constexpr int BN = 32;   // bins per block
constexpr int BK = 32;   // contraction slice
constexpr int TM = 4;    // rows per thread
constexpr int TN = 2;    // bins per thread
constexpr int THREADS = (BM / TM) * (BN / TN);  // 256
constexpr int ROWS_PER_LOAD = THREADS / BK;     // 8 rows loaded per pass

__global__ void __launch_bounds__(THREADS) dot_magnitude_kernel(
    const float* __restrict__ frames, int rows, int n_frames,
    long long stride_b, long long stride_f,
    const float* __restrict__ wr, const float* __restrict__ wi,
    int n_fft, int cutoff, float* __restrict__ out) {
  __shared__ float As[BK][BM + 1];  // As[k][m]: transposed frame slice
  __shared__ float Brs[BK][BN];
  __shared__ float Bis[BK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);  // bin group
  const int ty = tid / (BN / TN);  // row group
  const int row0 = blockIdx.x * BM;
  const int col0 = blockIdx.y * BN;

  // this thread loads column kk of rows m0, m0 + 8, ... of every frame slice
  const int kk_load = tid % BK;
  const int m0 = tid / BK;
  const float* row_ptr[BM / ROWS_PER_LOAD];
#pragma unroll
  for (int j = 0; j < BM / ROWS_PER_LOAD; ++j) {
    const int r = row0 + m0 + j * ROWS_PER_LOAD;
    if (r < rows) {
      const int b = r / n_frames;
      const int f = r - b * n_frames;
      row_ptr[j] = frames + b * stride_b + f * stride_f;
    } else {
      row_ptr[j] = nullptr;
    }
  }

  float acc_r[TM][TN] = {};
  float acc_i[TM][TN] = {};

  for (int k0 = 0; k0 < n_fft; k0 += BK) {
    const int k = k0 + kk_load;
#pragma unroll
    for (int j = 0; j < BM / ROWS_PER_LOAD; ++j) {
      As[kk_load][m0 + j * ROWS_PER_LOAD] =
          (row_ptr[j] != nullptr && k < n_fft) ? row_ptr[j][k] : 0.f;
    }
    for (int i = tid; i < BK * BN; i += THREADS) {
      const int kb = i / BN;
      const int n = i % BN;
      const bool ok = (k0 + kb < n_fft) && (col0 + n < cutoff);
      const long long w = static_cast<long long>(k0 + kb) * cutoff + col0 + n;
      Brs[kb][n] = ok ? wr[w] : 0.f;
      Bis[kb][n] = ok ? wi[w] : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kb = 0; kb < BK; ++kb) {
      float a[TM];
      float br[TN];
      float bi[TN];
#pragma unroll
      for (int j = 0; j < TM; ++j) a[j] = As[kb][ty * TM + j];
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        br[j] = Brs[kb][tx * TN + j];
        bi[j] = Bis[kb][tx * TN + j];
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
        out[static_cast<long long>(r) * cutoff + col] = sqrtf(re * re + im * im);
      }
    }
  }
}

}  // namespace

// frames: row (b, f) of the frame matrix at frames + b*stride_b + f*stride_f
// (unit stride along n_fft); wr, wi: [n_fft, cutoff] row-major; out: [batch
// * n_frames, cutoff] row-major. Returns cudaGetLastError() after launch.
extern "C" int vadc_dot_magnitude(const float* frames, int batch, int n_frames,
                                  long long stride_b, long long stride_f,
                                  const float* wr, const float* wi, int n_fft,
                                  int cutoff, float* out, void* stream) {
  const int rows = batch * n_frames;
  if (rows <= 0 || n_fft <= 0 || cutoff <= 0) return cudaErrorInvalidValue;
  dim3 grid((rows + BM - 1) / BM, (cutoff + BN - 1) / BN);
  dot_magnitude_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      frames, rows, n_frames, stride_b, stride_f, wr, wi, n_fft, cutoff, out);
  return static_cast<int>(cudaGetLastError());
}
