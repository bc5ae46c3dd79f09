// STFT magnitude from raw audio: reflect pad, framing and the magnitude of
// both half-spectrum products in one kernel.
//
// Replaces the Pallas kernel vadc_tpu/kernels/stft_mag.py:
// stft_magnitude_pallas (pallas_call at :119). audio [B, S] fp32 (row b at
// audio + b*stride_b) -> out [B, F, cutoff], F = (S + pad_left + pad_right
// - n_fft) / hop + 1. The v4 and v5 front-ends run it: v4 pad 96/96 hop 64,
// v5 pad 0/64 hop 128 (n_fft 256, 129 bins), the v5 8 kHz branch n_fft 128
// pad 0/32 hop 64 (65 bins).
//
// A block owns a group of whole streams (the wrapper's launch_plan chooses
// how many, so that their rows fill whole passes). It stages each stream's
// reflect-padded chunk once in shared memory with cp.async, the reflect
// arithmetic done at staging time (padded sample i of chunk b is audio[b,
// j], j = i - pad_left reflected at both edges, edge excluded: PyTorch's
// 'reflect'), skewed by one float per hop; the frame rows are then
// overlapping windows of the staged chunks, and stft_tile.cuh's spectrum
// forms their magnitudes. No padded copy, no frame matrix and no spectrum
// is written to device memory: only the magnitude.
//
// What bounds it on an H100: the fp32 FMAs (v4 16 kHz at batch 2048 x 1536:
// 49,152 rows x 256 x 258 x 2 = 6.5 GFLOP, 0.0973 ms at 67 TFLOP/s, against
// 12.6 MB of audio in and 25.4 MB of magnitude out, 0.0113 ms at 3.35
// TB/s). The design's answer: 8 * RT = 48 FMAs for 8 shared loads a tap and
// thread (BGW = 8 lanes across 32 bins, 4 row groups of RT = 6 rows), slices
// of BK = 32 taps (one barrier per 32 taps) in a ring of two filled by
// cp.async, two blocks of 256 threads an SM, and each pass's magnitudes
// gathered in shared memory and written out in whole sectors. ptxas: 122
// registers at fp32, 124 at bf16_3x, 120 at bf16, no spill, no stack, at
// both geometries; at v4 B=2048 a block owns 2 streams (48 rows, one pass)
// in 106.6 KB, two blocks an SM. On one
// H100 80GB HBM3 at 700 W (chip_smoke.py): 0.1828 ms at v4 B=2048 x 1536,
// 53 % of the bound (the first design, a 64 x 32 tile: 0.32); what holds
// it there is measured in PERF.md (chip_profile.py: spectrum_variants).
//
// Precision tiers (tier.cuh): the kernel is templated on the products'
// operand mode M as well, 3 modes x 2 geometries = 6 instances: fp32 (the
// faithful tier) and bf16 samples and bases on the CUDA-core tile above,
// and bf16_3x on fp32 samples on the tensor cores (stft_tile.cuh's
// mma.sync tile: each staged sample split once into bf16 hi and lo planes,
// the bases packed by the wrapper as bf16 planes, 64 rows a pass, slices of
// 16 taps in a ring of two; stft_tile.cuh says why the bf16 mode stays on
// the CUDA cores). The wrapper chooses the mode from the tier and the family
// (nn/precision.py: stft_mode: v4 bf16_3x at balanced and fast, bf16 at
// turbo; v5 bf16_3x at balanced, bf16 at fast and turbo) and packs the
// bases for it. The JAX package's Pallas kernel has no mode: these are the
// counterparts of its models' XLA spectrum at the tier, on the ported
// kernel. The bf16 instance rounds each staged sample once and runs the
// fp32 tile (a product of bf16 values is exact in fp32: the same bits as a
// rounding at every read, which cost 16 % more, PERF.md). What
// bounds the bf16_3x instance: the bytes (the same 12.6 MB in and 25.4 MB
// out at v4 B=2048, 0.0113 ms) and, on the chip, the bases: a pass of 64
// rows walks all of them (283 KB) from L2. The CUDA-core instance it
// replaces took 0.5736 ms there (PERF.md).
#include <cuda_runtime.h>

#include "stft_tile.cuh"

namespace {

// the two instances: n_fft 256 with 129 bins, n_fft 128 with 65 bins
using Spectrum256 = stft_block::Geometry<256, 129, 32, 8, 6, 2>;
using Spectrum128 = stft_block::Geometry<128, 65, 32, 8, 6, 2>;
// and by bf16_3x on the tensor cores: 4 m-tiles (64 rows) a pass, 16 taps a
// slice
using SpectrumMma256 = stft_block::MmaGeometry<256, 129, 16, 4, 2>;
using SpectrumMma128 = stft_block::MmaGeometry<128, 65, 16, 4, 2>;

template <class G, int M>
__global__ void __launch_bounds__(G::THREADS, 2)
stft_magnitude_kernel(const float* __restrict__ audio, int batch, long long stride_b, int samples,
                      int pad_left, int hop, int n_frames, int streams, int pad_ld,
                      const float* __restrict__ basis, float* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  float* bbuf = smem;
  float* tile = smem + G::BASIS_FLOATS;
  float* pad = tile + G::ROWS_PASS * G::BINS;
  const int b0 = blockIdx.x * streams;
  const int live = min(streams, batch - b0);
  const int staged = (n_frames - 1) * hop + G::NFFT;  // padded samples the frames read
  for (int s = 0; s < live; ++s) {
    const float* chunk = audio + (b0 + s) * stride_b;
    float* dst = pad + s * pad_ld;
    for (int p = threadIdx.x; p < staged; p += G::THREADS) {
      int j = p - pad_left;
      j = j < 0 ? -j : j;
      j = j >= samples ? 2 * samples - 2 - j : j;
      stft_block::cp_async4(dst + stft_block::skewed(p, hop), chunk + j);
    }
  }
  if constexpr (M == P_BF16) {
    // the samples rounded once, in place, for the fp32 tile to read: a
    // product of bf16 values is exact in fp32, so its sums are the bf16
    // mode's, bit for bit, without a rounding at every read
    stft_block::cp_async_commit();
    stft_block::cp_async_wait<0>();
    __syncthreads();
    for (int i = threadIdx.x; i < live * pad_ld; i += G::THREADS) pad[i] = bf16_rn(pad[i]);
  }
  // the staging lands with the first slice of the bases
  const stft_block::CoalescedStore<G> store{
      tile, out + static_cast<long long>(b0) * n_frames * G::BINS};
  stft_block::magnitudes<G, M == P_BF16 ? P_FP32 : M>(pad, pad_ld, hop, live * n_frames,
                                                      n_frames, basis, bbuf, store);
}

// The same by bf16_3x, on the tensor cores: the streams' chunks are staged
// as bf16 planes (hi, then lo, each stream at s * pad_ld of a plane, padded
// sample i at skewed_bf16(i, hop)).
template <class G>
__global__ void __launch_bounds__(G::THREADS, 2)
stft_magnitude_mma_kernel(const float* __restrict__ audio, int batch, long long stride_b,
                          int samples, int pad_left, int hop, int n_frames, int streams,
                          int pad_ld, const __nv_bfloat16* __restrict__ basis,
                          float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* bbuf = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  float* tile = reinterpret_cast<float*>(smem_raw + G::BASIS_BYTES);
  __nv_bfloat16* pad = reinterpret_cast<__nv_bfloat16*>(tile + G::ROWS_PASS * G::BINS);
  const int lo_at = streams * pad_ld;  // the lo plane after the hi plane
  const int b0 = blockIdx.x * streams;
  const int live = min(streams, batch - b0);
  const int staged = (n_frames - 1) * hop + G::NFFT;  // padded samples the frames read
  for (int s = 0; s < live; ++s) {
    const float* chunk = audio + (b0 + s) * stride_b;
    __nv_bfloat16* dst = pad + s * pad_ld;
    for (int p = threadIdx.x; p < staged; p += G::THREADS) {
      int j = p - pad_left;
      j = j < 0 ? -j : j;
      j = j >= samples ? 2 * samples - 2 - j : j;
      const int at = stft_block::skewed_bf16(p, hop);
      split_store(dst + at, dst + lo_at + at, chunk[j]);
    }
  }
  const stft_block::CoalescedStore<G> store{
      tile, out + static_cast<long long>(b0) * n_frames * G::BINS};
  const auto row_at = [=](int r) {
    const int s = r / n_frames;
    return s * pad_ld + (r - s * n_frames) * (hop + 8);
  };
  stft_block::magnitudes_mma<G>(pad, lo_at, row_at, hop, live * n_frames, basis, bbuf, store);
}

// bf16 values of a stream's staged plane: its skewed samples, rounded up to
// whole 16 bytes and on until the next stream's rows continue the skew's
// bank groups (pad_ld = F * (hop + 8) mod 64)
inline int staged_plane_ld(int n_frames, int hop, int n_fft) {
  const int staged = (n_frames - 1) * hop + n_fft;
  const int len = (stft_block::skewed_bf16(staged - 1, hop) + 1 + 7) / 8 * 8;
  return len + ((n_frames * (hop + 8) - len) % 64 + 64) % 64;
}

template <class G>
int launch_mma(const float* audio, int batch, long long stride_b, int samples, int pad_left,
               int hop, int n_frames, int streams, const void* basis, float* out,
               cudaStream_t stream) {
  if (hop % G::BK != 0 || hop % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int pad_ld = staged_plane_ld(n_frames, hop, G::NFFT);
  const size_t bytes = G::BASIS_BYTES + sizeof(float) * G::ROWS_PASS * G::BINS +
                       4 * static_cast<size_t>(streams) * pad_ld;
  if (bytes > stft_block::MAX_SHARED_BYTES) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = stft_block::allow_shared_memory<stft_magnitude_mma_kernel<G>>();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = (batch + streams - 1) / streams;
  stft_magnitude_mma_kernel<G><<<grid, G::THREADS, bytes, stream>>>(
      audio, batch, stride_b, samples, pad_left, hop, n_frames, streams, pad_ld,
      static_cast<const __nv_bfloat16*>(basis), out);
  return static_cast<int>(cudaGetLastError());
}

template <class G, int M>
int launch(const float* audio, int batch, long long stride_b, int samples, int pad_left,
           int hop, int n_frames, int streams, const float* basis, float* out,
           cudaStream_t stream) {
  if (hop % G::BK != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int staged = (n_frames - 1) * hop + G::NFFT;
  // stream s at s * pad_ld: pad_ld = F * (hop + 1) mod 32 keeps the skew's
  // banks running on from one stream's frames to the next's
  const int len = stft_block::skewed_len(staged, hop);
  const int pad_ld = len + ((n_frames * (hop + 1) - len) % 32 + 32) % 32;
  const size_t bytes = sizeof(float) * (G::BASIS_FLOATS + G::ROWS_PASS * G::BINS +
                                        static_cast<size_t>(streams) * pad_ld);
  if (bytes > stft_block::MAX_SHARED_BYTES) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = stft_block::allow_shared_memory<stft_magnitude_kernel<G, M>>();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = (batch + streams - 1) / streams;
  stft_magnitude_kernel<G, M><<<grid, G::THREADS, bytes, stream>>>(
      audio, batch, stride_b, samples, pad_left, hop, n_frames, streams, pad_ld, basis, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// audio: chunk b at audio + b*stride_b, `samples` fp32 each (unit stride);
// basis: at fp32 and bf16 [n_fft][2][BINS_LD] fp32, tap k's real then
// imaginary basis row, each `cutoff` bins padded with zeros to a multiple
// of 4; at bf16_3x [n_fft][LDB] bf16 (stft_tile.cuh: MmaGeometry); both as
// kernels/stft_dotmag.py: padded_basis packs them; out: [batch, n_frames, cutoff]
// row-major; streams: the streams a block owns (kernels/stft_mag.py:
// launch_plan); mode: the products' operands, 0 fp32, 1 bf16_3x, 2 bf16
// (tier.cuh ProductMode). Takes (n_fft, cutoff) = (256, 129) or (128, 65)
// at every mode, hop a multiple of 32 dividing n_fft, padded length a
// multiple of hop, each pad < samples (one reflection), and the block's
// staged chunks within shared memory. Returns cudaGetLastError() after the
// launch.
extern "C" int vadc_stft_magnitude(const float* audio, int batch, long long stride_b,
                                   int samples, int pad_left, int pad_right, int hop,
                                   const void* basis, int n_fft, int cutoff, int streams,
                                   float* out, int mode, void* stream) {
  const int padded = samples + pad_left + pad_right;
  if (batch <= 0 || samples <= 0 || hop <= 0 || streams <= 0 || pad_left < 0 ||
      pad_right < 0 || pad_left >= samples || pad_right >= samples || padded < n_fft ||
      padded % hop != 0 || n_fft % hop != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int n_frames = (padded - n_fft) / hop + 1;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return by_mode(mode, [&](auto m) {
    constexpr int M = decltype(m)::value;
    if constexpr (M == P_SPLIT) {
      if (n_fft == 256 && cutoff == 129) {
        return launch_mma<SpectrumMma256>(audio, batch, stride_b, samples, pad_left, hop,
                                          n_frames, streams, basis, out, s);
      }
      if (n_fft == 128 && cutoff == 65) {
        return launch_mma<SpectrumMma128>(audio, batch, stride_b, samples, pad_left, hop,
                                          n_frames, streams, basis, out, s);
      }
    } else {
      const float* fbasis = static_cast<const float*>(basis);
      if (n_fft == 256 && cutoff == 129) {
        return launch<Spectrum256, M>(audio, batch, stride_b, samples, pad_left, hop, n_frames,
                                      streams, fbasis, out, s);
      }
      if (n_fft == 128 && cutoff == 65) {
        return launch<Spectrum128, M>(audio, batch, stride_b, samples, pad_left, hop, n_frames,
                                      streams, fbasis, out, s);
      }
    }
    return static_cast<int>(cudaErrorInvalidValue);
  });
}
