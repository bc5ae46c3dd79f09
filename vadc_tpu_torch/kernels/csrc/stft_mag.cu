// STFT magnitude from raw audio: reflect pad, framing and the magnitude of
// both half-spectrum products in one kernel.
//
// Replaces the Pallas kernel vadc_tpu/kernels/stft_mag.py:
// stft_magnitude_pallas (pallas_call at :119). audio [B, S] fp32 (row b at
// audio + b*stride_b) -> out [B, F, cutoff], F = (S + pad_left + pad_right
// - n_fft) / hop + 1. The v4 and v5 front-ends run it: v4 pad 96/96 hop 64,
// v5 pad 0/64 hop 128, the v5 8 kHz branch n_fft 128 pad 0/32 hop 64.
//
// The Pallas kernel splits each frame into n_fft/hop hop-sized blocks
// because its compiler could not gather frames; here the reflect pad and
// the framing are index arithmetic in the load of the A operand. Padded
// sample i of chunk b is audio[b, j] with j = i - pad_left, reflected at
// both edges (edge excluded, PyTorch's 'reflect'): j < 0 -> -j, j >= S ->
// 2S - 2 - j. No padded copy, no frame matrix and no spectrum is written to
// device memory: only the magnitude.
//
// What bounds it on an H100: the fp32 FMAs, as for dot_magnitude (v4 16 kHz
// at batch 2048 x 1536: 49,152 rows x 256 x 258 x 2 = 6.5 GFLOP). The tile
// is dot_magnitude's (stft_tile.cuh), so on the same samples the two give
// the same bits.
#include <cuda_runtime.h>

#include "stft_tile.cuh"

namespace {

__global__ void __launch_bounds__(stft_tile::THREADS)
stft_magnitude_kernel(stft_tile::PaddedAudio src, int rows, const float* __restrict__ wr,
                      const float* __restrict__ wi, int n_fft, int cutoff,
                      float* __restrict__ out) {
  __shared__ stft_tile::Smem sm;
  stft_tile::magnitude_tile(sm, src, rows, wr, wi, n_fft, cutoff, out);
}

}  // namespace

// audio: chunk b at audio + b*stride_b, `samples` fp32 each (unit stride);
// wr, wi: [n_fft, cutoff] row-major; out: [batch, n_frames, cutoff]
// row-major. Each pad must be < samples (one reflection). Returns
// cudaGetLastError() after the launch.
extern "C" int vadc_stft_magnitude(const float* audio, int batch, long long stride_b,
                                   int samples, int pad_left, int pad_right, int hop,
                                   const float* wr, const float* wi, int n_fft,
                                   int cutoff, float* out, void* stream) {
  const int padded = samples + pad_left + pad_right;
  if (batch <= 0 || samples <= 0 || hop <= 0 || n_fft <= 0 || cutoff <= 0 ||
      pad_left < 0 || pad_right < 0 || pad_left >= samples || pad_right >= samples ||
      padded < n_fft) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int n_frames = (padded - n_fft) / hop + 1;
  const int rows = batch * n_frames;
  const stft_tile::PaddedAudio src{audio, n_frames, stride_b, samples, pad_left, hop};
  stft_magnitude_kernel<<<stft_tile::grid(rows, cutoff), stft_tile::THREADS, 0,
                          static_cast<cudaStream_t>(stream)>>>(src, rows, wr, wi, n_fft,
                                                               cutoff, out);
  return static_cast<int>(cudaGetLastError());
}
