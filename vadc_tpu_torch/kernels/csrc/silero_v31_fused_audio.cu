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
//  1. Spectrum. The streams' chunks are staged once in shared memory through
//     the reflect pad (128/128), so the F frames of a stream (hop 64, n_fft
//     256) are overlapping windows of 7 KB and nothing is framed again;
//     stft_tile.cuh's spectrum (the instance `Spectrum` below) then forms
//     the magnitudes against the real and imaginary bases, 56 rows x 129
//     bins a pass. Every magnitude is
//     dot_magnitude's, bit for bit. Each lands in region A, where the body
//     reads its stage-1 input; the staged chunks and the basis buffers lie
//     over the regions the body fills only later. The Pallas kernel's split
//     of the frames into hop blocks worked around its compiler and is not
//     carried over.
//  2. Adaptive normalization, in place: log1p(2^20 x) by the Pallas
//     kernel's series (_log1p_series), op for op with each op rounded on
//     its own (no contraction into FMAs), so it equals
//     nn/functional.accurate_log1p's; the per-frame channel mean; mean_mean
//     = sum_f norm_w[f] * mean[f], where norm_w folds the 7-tap smoothing,
//     its reflect pad and the frame mean into F weights (host-computed by
//     the wrapper, passed by value); subtracted from every bin.
//  3. The encoder, LSTM and decoder of silero_v31_body.cuh.
// A second entry, vadc_silero_v31_encode_audio, runs 1, 2 and the encoder
// alone and stores the last stage's output [R, T, 64]: the slab route's
// front half, whose rows are what this kernel hands its own LSTM.
//
// Both entries take the precision tier (tier.cuh) and launch its instance:
// the spectrum at the tier's STFT operands (bf16_3x on fp32 samples at
// balanced and fast, bf16 at turbo), log1pf in place of the series at the
// bf16 tiers, turbo's features stored as bf16, then the body's instance;
// mean_mean stays fp32 at every tier (nn/precision.py says why). The JAX
// package has no tier form of this kernel; the instances are held to the
// plain versions at the tier (kernels/silero_v31_fused.py).
//
// What bounds it on an H100: the spectrum's fp32 FMAs (51,200 frames x 256
// x 258 x 2 = 6.8 GFLOP at batch 2048 x 1536, on the CUDA cores: the
// faithful tier keeps fp32 products, no TF32; the tensor cores come with the
// bf16 tiers, where the tier itself moves the bound) beside the body's chain
// of dependent small steps (4.3 GFLOP). The first design spent 39 % of a
// block's life in the spectrum (chip_profile.py's phase split): 10 passes of
// a 64 x 32 tile over 128 x 160 for 100 x 129 results, each of its 80
// slices refilled by scalar loads between two barriers with nothing in
// flight. stft_tile.cuh's header says what the block-fitted spectrum does
// about each of these; silero_v31_body.cuh's says the same for the body.
#include <cuda_runtime.h>

#include <algorithm>
#include <cstring>

#include "silero_v31_body.cuh"
#include "stft_tile.cuh"

namespace {

constexpr int N_FFT = 256;
constexpr int HOP = 64;
constexpr int PAD = 128;
// stft_tile.cuh's spectrum fitted to the block's constraints (its shared
// memory, 128 registers): 32 lanes across bins 0..127 (BGW = 32), RT = 7 rows
// a warp, so 8 warps cover 56 rows a pass and the 100 rows of 4 streams x
// 25 frames take 2 passes; slices of BK = 8 taps in a ring of two
using Spectrum = stft_block::Geometry<N_FFT, N_FEAT, 8, 32, 7, 2>;
static_assert(THREADS == Spectrum::THREADS, "one block of threads for the spectrum and the body");
static_assert(HOP % Spectrum::BK == 0, "whole slices a hop");

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
  FastDiv by_frames;
  float* spect;  // [B, F, 129] or null
  long long spect_row0;

  __device__ void operator()(int r, int c, float v) const {
    const int s = by_frames.div(r);
    const int f = r - s * by_frames.d;
    A[s * sa + f * N_FEAT + c] = v;
    if (spect != nullptr) spect[(spect_row0 + r) * N_FEAT + c] = v;
  }
  __device__ void pass_done(int, int) const {}
};

// floats of one stream's staged, skewed, reflect-padded chunk (a multiple of 4)
__host__ __device__ inline int staged_chunk_floats(int samples) {
  return (stft_block::skewed_len(samples + 2 * PAD, HOP) + 3) & ~3;
}

// The front-end of both entries, so the two cannot drift: the spectrum of
// the block's live streams into region A, then the adaptive normalization
// in place; streams past `batch` (a ragged last block) get a zero stage-1
// input. The staged chunks and the basis buffers lie over everything after
// region A, which the body fills only later. Ends without a barrier: the
// encoder passes one first.
template <int T>
__device__ void audio_features(const Block& m, const NormW& norm_w,
                               const float* __restrict__ audio, long long stride_b, int samples,
                               const float* __restrict__ basis, float* spect, int b0, int batch,
                               int seq0) {
  const int tid = threadIdx.x;
  const int live = min(NB, batch - b0);
  const int n_in = seq0 * N_FEAT;
  const int sa = m.sa;
  const FastDiv by_in(n_in), by_seq(seq0);

  for (int i = tid; i < (NB - live) * n_in; i += blockDim.x) {
    const int s = by_in.div(i);
    m.A[(live + s) * sa + (i - s * n_in)] = 0.f;
  }

  // 1. the live streams' chunks through the reflect pad into shared memory
  // (padded sample i is audio[j], j = i - PAD reflected at both edges, edge
  // excluded), then their spectrum into A
  float* pad = m.H;
  const int pad_ld = staged_chunk_floats(samples);
  float* bbuf = pad + NB * pad_ld;  // 16-byte aligned: pad_ld is a multiple of 4
  const int padded = samples + 2 * PAD;
  const FastDiv by_padded(padded);
  for (int i = tid; i < live * padded; i += blockDim.x) {
    const int s = by_padded.div(i);
    const int p = i - s * padded;
    int j = p - PAD;
    j = j < 0 ? -j : j;
    j = j >= samples ? 2 * samples - 2 - j : j;
    pad[s * pad_ld + stft_block::skewed(p, HOP)] = audio[(b0 + s) * stride_b + j];
  }
  __syncthreads();
  const ToStageInput store{m.A, sa, by_seq, spect, static_cast<long long>(b0) * seq0};
  stft_block::magnitudes<Spectrum, Tier<T>::kStft>(pad, pad_ld, HOP, live * seq0, seq0, basis,
                                                   bbuf, store);
  __syncthreads();
  PHASE_STAMP(PH_SPECTRUM);

  // 2. adaptive normalization in place
  for (int i = tid; i < NB * n_in; i += blockDim.x) {
    const int s = by_in.div(i);
    float* p = m.A + s * sa + (i - s * n_in);
    const float y = __fmul_rn(*p, 1048576.f);
    if constexpr (Tier<T>::kSeriesLog1p) {
      *p = log1p_series(y);
    } else {
      *p = log1pf(y);
    }
  }
  __syncthreads();
  PHASE_STAMP(PH_LOG1P);
  float* mean = m.gates;  // [NB][seq0]; the gates are free until the LSTM
  for (int r = tid; r < NB * seq0; r += blockDim.x) {
    const int s = by_seq.div(r);
    const float* row = m.A + s * sa + (r - s * seq0) * N_FEAT;
    float sum = 0.f;
#pragma unroll 8
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
    const int s = by_in.div(i);
    float* p = m.A + s * sa + (i - s * n_in);
    *p = store_at<T>(*p - mean_mean[s]);
  }
}

template <int T>
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
silero_v31_fused_audio_kernel(const float* __restrict__ W, const __grid_constant__ Offsets o,
                               const __grid_constant__ NormW norm_w,
                              const float* __restrict__ audio, long long stride_b, int samples,
                              const float* __restrict__ basis, const float* h0, const float* c0, float* probs, float* hn,
                              float* cn, float* spect, int batch, int seq0, int sa, int sh) {
  extern __shared__ __align__(16) float smem[];
  const Block m = carve(smem, sa, sh);
  const int b0 = blockIdx.x * NB;
  PHASE_STAMP(PH_START);
  audio_features<T>(m, norm_w, audio, stride_b, samples, basis, spect, b0, batch, seq0);
  load_state(m, h0, c0, b0, batch);
  __syncthreads();
  PHASE_STAMP(PH_NORM);
  encode_lstm_decode<T>(W, o, m, seq0, b0, batch, probs, hn, cn);
}

// The encoder alone from raw audio: the same front-end, the same four
// stages, and the store of silero_v31_fused.cu's encoder entry. Its rows
// are what the step kernel above hands its own LSTM.
template <int T>
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
silero_v31_encode_audio_kernel(const float* __restrict__ W, const __grid_constant__ Offsets o,
                               const __grid_constant__ NormW norm_w,
                               const float* __restrict__ audio, long long stride_b, int samples,
                               const float* __restrict__ basis, float* __restrict__ y, int rows, int seq0, int sa, int sh) {
  extern __shared__ __align__(16) float smem[];
  const Block m = carve(smem, sa, sh);
  const int b0 = blockIdx.x * NB;
  audio_features<T>(m, norm_w, audio, stride_b, samples, basis, nullptr, b0, rows, seq0);
  const int S = encode<T>(W, o, m, seq0);
  store_encoded(m, S, b0, rows, y);
}

// Checks the arguments both entries share, fills the by-value tables and
// raises the kernel's dynamic shared memory; returns its bytes, or 0 with
// *err set.
template <class Kernel>
size_t prepare(Kernel kernel, const int* offsets, int n_offsets, const float* norm_w,
               int n_norm_w, int batch, long long stride_b, int samples, Offsets* o, NormW* nw,
               int* seq0, int* sa, int* sh, cudaError_t* err) {
  *seq0 = samples / HOP + 1;
  if (n_offsets != N_SLOTS || batch <= 0 || samples % 256 != 0 || *seq0 < MIN_SEQ0 ||
      *seq0 > MAX_SEQ0 || n_norm_w != *seq0 || stride_b < samples) {
    *err = cudaErrorInvalidValue;
    return 0;
  }
  std::memcpy(o->v, offsets, sizeof(o->v));
  *nw = NormW{};
  std::memcpy(nw->v, norm_w, sizeof(float) * *seq0);
  plan(*seq0, sa, sh);
  // the staged chunks and the basis buffers lie over everything after region A
  const int front = NB * staged_chunk_floats(samples) + Spectrum::BASIS_FLOATS;
  const int floats = NB * *sa + std::max(tail_floats(*sh), front);
  const size_t bytes = static_cast<size_t>(floats) * sizeof(float);
  *err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
  return bytes;
}

template <int T>
int launch_step(const float* weights, const int* offsets, int n_offsets, const float* norm_w,
                int n_norm_w, const float* audio, int batch, long long stride_b, int samples,
                const float* basis, const float* h, const float* c, float* probs, float* hn,
                float* cn, float* spect, cudaStream_t stream) {
  Offsets o;
  NormW nw;
  int seq0 = 0, sa = 0, sh = 0;
  cudaError_t err = cudaSuccess;
  const size_t bytes = prepare(silero_v31_fused_audio_kernel<T>, offsets, n_offsets, norm_w,
                               n_norm_w, batch, stride_b, samples, &o, &nw, &seq0, &sa, &sh, &err);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = (batch + NB - 1) / NB;
  silero_v31_fused_audio_kernel<T><<<grid, THREADS, bytes, stream>>>(
      weights, o, nw, audio, stride_b, samples, basis, h, c, probs, hn, cn, spect, batch, seq0, sa,
      sh);
  return static_cast<int>(cudaGetLastError());
}

template <int T>
int launch_encode_audio(const float* weights, const int* offsets, int n_offsets,
                        const float* norm_w, int n_norm_w, const float* audio, int rows,
                        long long stride_b, int samples, const float* basis, float* y,
                        cudaStream_t stream) {
  Offsets o;
  NormW nw;
  int seq0 = 0, sa = 0, sh = 0;
  cudaError_t err = cudaSuccess;
  const size_t bytes = prepare(silero_v31_encode_audio_kernel<T>, offsets, n_offsets, norm_w,
                               n_norm_w, rows, stride_b, samples, &o, &nw, &seq0, &sa, &sh, &err);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = (rows + NB - 1) / NB;
  silero_v31_encode_audio_kernel<T><<<grid, THREADS, bytes, stream>>>(
      weights, o, nw, audio, stride_b, samples, basis, y, rows, seq0, sa, sh);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// weights, offsets, n_offsets: as vadc_silero_v31_fused (packed for the
// tier); norm_w: host float[n_norm_w], the F collapsed normalization
// weights; audio: chunk
// b at audio + b*stride_b, `samples` fp32 each; basis: [256][2][132], tap
// k's real then imaginary basis row, each 129 bins padded with zeros to 132,
// packed for the tier's STFT; h, c, hn, cn [2, batch, 64] (hn, cn may alias
// h, c); probs [batch]; spect: [batch, F, 129] for a copy of the
// magnitudes, or null; tier: 0 faithful, 1 balanced, 2 fast, 3 turbo.
// Returns cudaGetLastError() after the launch.
extern "C" int vadc_silero_v31_fused_audio(const float* weights, const int* offsets,
                                           int n_offsets, const float* norm_w, int n_norm_w,
                                           const float* audio, int batch, long long stride_b,
                                           int samples, const float* basis, const float* h,
                                           const float* c, float* probs, float* hn, float* cn,
                                           float* spect, int tier, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return by_tier(tier, [&](auto t) {
    return launch_step<decltype(t)::value>(weights, offsets, n_offsets, norm_w, n_norm_w, audio,
                                           batch, stride_b, samples, basis, h, c, probs, hn, cn,
                                           spect, s);
  });
}

// The encoder alone from raw audio: audio as above (`rows` chunks) -> y
// [rows, T, 64], T the frame count after the strides 2, 2, 1, 1 (3..7).
// Returns cudaGetLastError() after the launch.
extern "C" int vadc_silero_v31_encode_audio(const float* weights, const int* offsets,
                                            int n_offsets, const float* norm_w, int n_norm_w,
                                            const float* audio, int rows, long long stride_b,
                                            int samples, const float* basis, float* y, int tier,
                                            void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return by_tier(tier, [&](auto t) {
    return launch_encode_audio<decltype(t)::value>(weights, offsets, n_offsets, norm_w, n_norm_w,
                                                   audio, rows, stride_b, samples, basis, y, s);
  });
}

#ifdef VADC_PHASE_PROBE
// The stamps of the last launch (synchronizes the device): clocks and ids
// [blocks][slots], counts [blocks], ns [blocks][2] into host arrays sized by
// vadc_phase_probe_shape. Only in the probe library of chip_profile.py.
extern "C" void vadc_phase_probe_shape(int* blocks, int* slots) {
  *blocks = PROBE_BLOCKS;
  *slots = PROBE_SLOTS;
}
extern "C" int vadc_phase_probe_read(long long* clocks, int* ids, int* counts,
                                     unsigned long long* ns) {
  cudaError_t err = cudaDeviceSynchronize();
  if (err == cudaSuccess) err = cudaMemcpyFromSymbol(clocks, probe_clock, sizeof(probe_clock));
  if (err == cudaSuccess) err = cudaMemcpyFromSymbol(ids, probe_id, sizeof(probe_id));
  if (err == cudaSuccess) err = cudaMemcpyFromSymbol(counts, probe_count, sizeof(probe_count));
  if (err == cudaSuccess) err = cudaMemcpyFromSymbol(ns, probe_ns, sizeof(probe_ns));
  return static_cast<int>(err);
}
#endif
