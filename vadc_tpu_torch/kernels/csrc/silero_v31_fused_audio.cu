// The whole Silero v3.1 step from raw audio in one kernel: STFT magnitude,
// adaptive normalization, four encoder stages, the 2-layer LSTM and the v3
// decoder.
//
// Replaces the Pallas kernel vadc_tpu/kernels/silero_v31_fused.py:
// forward_fused (pallas_call at :286). Input: audio [B, S] fp32 (chunk b at
// audio + b*stride_b, unit stride), S a multiple of 256 in 512..1536, so
// F = S/64 + 1 = 9..25 frames; LSTM state h, c [2, B, 64]. Output: probs
// [B], hn, cn [2, B, 64]. hn/cn may alias h/c: a block reads its streams'
// state before it writes any of it, and blocks own disjoint streams.
//
// A block takes NB = 4 streams with 256 threads, as silero_v31_fused.cu:
//  1. Spectrum. The NB streams' F frames (reflect pad 128/128, hop 64,
//     n_fft 256) against the [256, 129] real and imaginary bases, one 64-row
//     x 32-bin tile at a time, with the tile of stft_tile.cuh reading its
//     rows through the reflect pad as stft_mag.cu does. So every magnitude
//     is dot_magnitude's, bit for bit. Each lands in region A, where the
//     body reads its stage-1 input; the tile's shared memory lies over the
//     regions the body fills only later. The audio and the bases (264 KB)
//     are read from global memory, where they stay in L1 and L2. The Pallas
//     kernel's split of the frames into hop blocks worked around its
//     compiler and is not carried over.
//  2. Adaptive normalization, in place: log1p(2^20 x) by the Pallas
//     kernel's series (_log1p_series), op for op with each op rounded on
//     its own (no contraction into FMAs), so it equals
//     nn/functional.accurate_log1p's; the per-frame channel mean; mean_mean
//     = sum_f norm_w[f] * mean[f], where norm_w folds the 7-tap smoothing,
//     its reflect pad and the frame mean into F weights (host-computed by
//     the wrapper, passed by value); subtracted from every bin.
//  3. The encoder, LSTM and decoder of silero_v31_body.cuh.
//
// What bounds it on an H100: the spectrum's fp32 FMAs (51,200 frames x 256
// x 258 x 2 = 6.8 GFLOP at batch 2048 x 1536, on the CUDA cores: the
// faithful tier keeps fp32 products) beside the body's chain of dependent
// small steps (4.3 GFLOP). A block's 100 rows x 129 bins take the tile 2 x
// 5 passes over 128 x 160, so 63 % of the tile's FMAs are useful (80 % in
// dot_magnitude, whose rows fill whole tiles); what it saves is the
// spectrum's and the features' round trips through device memory (26 MB
// each way at batch 2048) and the front-end's dozen small launches.
#include <cuda_runtime.h>

#include <algorithm>
#include <cstring>

#include "silero_v31_body.cuh"
#include "stft_tile.cuh"

namespace {

constexpr int N_FFT = 256;
constexpr int HOP = 64;
constexpr int PAD = 128;
// the tile's thread mapping is the block's
static_assert(THREADS == stft_tile::THREADS, "one block of threads for the tile and the body");

// the collapsed normalization weights of one chunk size, by value
struct NormW {
  float v[MAX_SEQ0];
};

// fp32 log1p to ~1 ulp for y >= 0 (vadc_tpu/kernels/silero_v31_fused.py
// _log1p_series): z = 1+y split into 2^e * m with m in [sqrt(1/2),
// sqrt(2)), log(m) by the atanh series in t = (m-1)/(m+1), ln2 as a hi/lo
// pair. Every op is rounded on its own, as the plain version's tensor ops
// are; the constants are the fp32 roundings of the same doubles.
__device__ __forceinline__ float log1p_series(float y) {
  const float z = __fadd_rn(1.f, y);
  const int bits = __float_as_int(z);
  const int e = (bits >> 23) - 127;
  float m = __int_as_float((bits & 0x007FFFFF) | 0x3F800000);
  const bool big = m > static_cast<float>(1.4142135);
  m = big ? __fmul_rn(m, 0.5f) : m;
  const float ef = static_cast<float>(e + (big ? 1 : 0));
  const float t = __fdiv_rn(__fsub_rn(m, 1.f), __fadd_rn(m, 1.f));
  const float t2 = __fmul_rn(t, t);
  float poly = __fmul_rn(t2, static_cast<float>(1.0 / 11.0));
  poly = __fmul_rn(t2, __fadd_rn(static_cast<float>(1.0 / 9.0), poly));
  poly = __fmul_rn(t2, __fadd_rn(static_cast<float>(1.0 / 7.0), poly));
  poly = __fmul_rn(t2, __fadd_rn(static_cast<float>(0.2), poly));
  poly = __fmul_rn(t2, __fadd_rn(static_cast<float>(1.0 / 3.0), poly));
  poly = __fadd_rn(1.f, poly);
  const float log_m = __fmul_rn(__fmul_rn(2.f, t), poly);
  return __fadd_rn(__fmul_rn(ef, 0.693359375f),
                   __fadd_rn(log_m, __fmul_rn(ef, static_cast<float>(-2.12194440e-4))));
}

// where the tile puts magnitude (row r = local stream s, frame f; bin c):
// the stage-1 input in region A, and a copy in device memory when asked
struct ToStageInput {
  float* A;
  int sa;
  int n_frames;
  float* spect;  // [B, F, 129] or null
  long long spect_row0;

  __device__ void operator()(int r, int c, float v) const {
    const int s = r / n_frames;
    const int f = r - s * n_frames;
    A[s * sa + f * N_FEAT + c] = v;
    if (spect != nullptr) spect[(spect_row0 + r) * N_FEAT + c] = v;
  }
};

__global__ void __launch_bounds__(THREADS)
silero_v31_fused_audio_kernel(const float* __restrict__ W, Offsets o, NormW norm_w,
                              const float* __restrict__ audio, long long stride_b, int samples,
                              const float* __restrict__ wr, const float* __restrict__ wi,
                              const float* h0, const float* c0, float* probs, float* hn,
                              float* cn, float* spect, int batch, int seq0, int sa, int sh) {
  extern __shared__ float smem[];
  const Block m = carve(smem, sa, sh);
  const int b0 = blockIdx.x * NB;
  const int tid = threadIdx.x;
  const int live = min(NB, batch - b0);
  const int n_in = seq0 * N_FEAT;

  // streams past the batch (a ragged last block) get a zero stage-1 input
  for (int i = tid; i < (NB - live) * n_in; i += blockDim.x) {
    m.A[(live + i / n_in) * sa + i % n_in] = 0.f;
  }

  // 1. spectrum of the live streams' frames into A
  stft_tile::Smem& tile = *reinterpret_cast<stft_tile::Smem*>(m.H);
  const stft_tile::PaddedAudio src{audio + b0 * stride_b, seq0, stride_b, samples, PAD, HOP};
  const ToStageInput store{m.A, sa, seq0, spect, static_cast<long long>(b0) * seq0};
  const int rows = live * seq0;
  for (int row0 = 0; row0 < rows; row0 += stft_tile::BM) {
    for (int col0 = 0; col0 < N_FEAT; col0 += stft_tile::BN) {
      stft_tile::magnitude_tile_at(tile, src, rows, row0, col0, wr, wi, N_FFT, N_FEAT, store);
    }
  }
  __syncthreads();

  // 2. adaptive normalization in place
  for (int i = tid; i < NB * n_in; i += blockDim.x) {
    const int s = i / n_in;
    float* p = m.A + s * sa + (i - s * n_in);
    *p = log1p_series(__fmul_rn(*p, 1048576.f));
  }
  __syncthreads();
  float* mean = m.gates;  // [NB][seq0]; the gates are free until the LSTM
  for (int r = tid; r < NB * seq0; r += blockDim.x) {
    const int s = r / seq0;
    const float* row = m.A + s * sa + (r - s * seq0) * N_FEAT;
    float sum = 0.f;
    for (int c = 0; c < N_FEAT; ++c) sum += row[c];
    mean[r] = sum / N_FEAT;
  }
  __syncthreads();
  float* mean_mean = mean + NB * MAX_SEQ0;  // [NB]
  for (int s = tid; s < NB; s += blockDim.x) {
    float acc = 0.f;
    for (int f = 0; f < seq0; ++f) acc = fmaf(norm_w.v[f], mean[s * seq0 + f], acc);
    mean_mean[s] = acc;
  }
  __syncthreads();
  for (int i = tid; i < NB * n_in; i += blockDim.x) {
    const int s = i / n_in;
    m.A[s * sa + (i - s * n_in)] -= mean_mean[s];
  }

  // 3. the model
  load_state(m, h0, c0, b0, batch);
  __syncthreads();
  encode_lstm_decode(W, o, m, seq0, b0, batch, probs, hn, cn);
}

}  // namespace

// weights, offsets, n_offsets: as vadc_silero_v31_fused; norm_w: host
// float[n_norm_w], the F collapsed normalization weights; audio: chunk b at
// audio + b*stride_b, `samples` fp32 each; wr, wi: [256, 129] row-major;
// h, c, hn, cn [2, batch, 64] (hn, cn may alias h, c); probs [batch];
// spect: [batch, F, 129] for a copy of the magnitudes, or null. Returns
// cudaGetLastError() after the launch.
extern "C" int vadc_silero_v31_fused_audio(const float* weights, const int* offsets,
                                           int n_offsets, const float* norm_w, int n_norm_w,
                                           const float* audio, int batch, long long stride_b,
                                           int samples, const float* wr, const float* wi,
                                           const float* h, const float* c, float* probs,
                                           float* hn, float* cn, float* spect, void* stream) {
  const int seq0 = samples / HOP + 1;
  if (n_offsets != N_SLOTS || batch <= 0 || samples % 256 != 0 || seq0 < MIN_SEQ0 ||
      seq0 > MAX_SEQ0 || n_norm_w != seq0 || stride_b < samples) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Offsets o;
  std::memcpy(o.v, offsets, sizeof(o.v));
  NormW nw{};
  std::memcpy(nw.v, norm_w, sizeof(float) * seq0);
  int sa = 0, sh = 0;
  plan(seq0, &sa, &sh);
  // the tile's shared memory lies over everything after region A
  const int tile_floats = static_cast<int>(sizeof(stft_tile::Smem) / sizeof(float));
  const int floats = std::max(block_floats(sa, sh), NB * sa + tile_floats);
  const size_t bytes = static_cast<size_t>(floats) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(silero_v31_fused_audio_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = (batch + NB - 1) / NB;
  silero_v31_fused_audio_kernel<<<grid, THREADS, bytes, static_cast<cudaStream_t>(stream)>>>(
      weights, o, nw, audio, stride_b, samples, wr, wi, h, c, probs, hn, cn, spect, batch, seq0,
      sa, sh);
  return static_cast<int>(cudaGetLastError());
}
