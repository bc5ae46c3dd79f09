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
// Design: the tiled SGEMM with a magnitude epilogue of stft_tile.cuh, which
// stft_mag.cu shares; here a row's samples are read from the strided view.
#include <cuda_runtime.h>

#include "stft_tile.cuh"

namespace {

// rows of a strided frame view (unit stride along n_fft)
struct FrameView {
  using Row = const float*;
  const float* frames;
  int n_frames;
  long long stride_b;
  long long stride_f;

  __device__ Row row(int r) const {
    const int b = r / n_frames;
    const int f = r - b * n_frames;
    return frames + b * stride_b + f * stride_f;
  }
  __device__ float load(Row row, int k) const { return row[k]; }
};

__global__ void __launch_bounds__(stft_tile::THREADS)
dot_magnitude_kernel(FrameView src, int rows, const float* __restrict__ wr,
                     const float* __restrict__ wi, int n_fft, int cutoff,
                     float* __restrict__ out) {
  __shared__ stft_tile::Smem sm;
  stft_tile::magnitude_tile(sm, src, rows, wr, wi, n_fft, cutoff, out);
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
  const FrameView src{frames, n_frames, stride_b, stride_f};
  dot_magnitude_kernel<<<stft_tile::grid(rows, cutoff), stft_tile::THREADS, 0,
                         static_cast<cudaStream_t>(stream)>>>(src, rows, wr, wi, n_fft,
                                                              cutoff, out);
  return static_cast<int>(cudaGetLastError());
}
