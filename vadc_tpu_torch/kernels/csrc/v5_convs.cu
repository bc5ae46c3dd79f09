// Silero v5's encoder after the spectrum: four k3 convs (pad 1, strides 1,
// 2, 2, 1), each with its bias and a ReLU, in one kernel.
//
// Replaces no TPU kernel: the JAX package leaves these convs to XLA
// (vadc_tpu/models/silero_v5.py: encode, four conv1d ops). The port's
// plain version, which the CPU runs, is models/silero_v5.py: _convs
// (nn/functional.py: conv1d_nlc, three shifted products a conv); on a card
// that chain is some 25 launches a piece and its products copy each
// weight to every row.
//
// spect [rows, 4, C_IN] fp32 (row-major; C_IN 129 at 16 kHz, 65 in the 8
// kHz branch) -> out [rows, 1, 128] fp32: 129|65 -> 128 (stride 1, 4
// frames), 128 -> 64 (2, 2 frames), 64 -> 64 (2, 1 frame), 64 -> 128 (1,
// 1 frame). A tap that reads only the pad's zeros for an output frame adds
// an exact zero in the plain version and is skipped here: 10, 5, 2 and 1
// taps a chunk, 222,464 multiply-adds.
//
// What bounds it on an H100: the fp32 FMAs. A 4,096-row piece of the batch
// CLI is 1.82 GFLOP against 10.6 MB of spectrum in and features out: 27 us
// at 67 TFLOP/s, 3.2 us at 3.35 TB/s. The design keeps everything but the
// spectrum in and the features out off device memory:
//  * a block of 256 threads owns CHUNKS = 32 whole chunks (a 4,096-row
//    piece is 128 blocks, one wave over the 132 SMs); it stages its
//    chunks' spectrum in shared memory channel-major ([C][chunk][frame])
//    with cp.async, and each conv's output goes to shared memory in the
//    same layout as the next conv's input; only conv 4's [32, 128] goes out;
//  * the weights, packed once per Params and tier by the wrapper
//    (kernels/v5_convs.py: packed_weights) as slices of SLICE floats (a
//    tap's [BK input channels][C_out], BK = SLICE / C_out), only of the
//    taps some output frame uses, are streamed from L2 through a ring of
//    STAGES slices filled by cp.async, one barrier a slice, the ring
//    running on from one conv into the next;
//  * a thread owns 2 chunks x every output frame x C_out / 16 outputs
//    (out_of), so per input channel it reads its chunks' frames (2 x L_in
//    floats, two float4 at conv 1, which 16 lanes share) and its weights
//    (float4s, 16 lanes' one run of 256 bytes) for up to 64 FMAs into
//    registers (conv 1: 2 x 4 x 8); the tap's frame offsets are
//    compile-time, so a skipped tap costs nothing.
// ptxas: 167 to 180 registers, no spill; 160,272 bytes of shared memory at
// C_IN 129, one block an SM. On one H100 80GB HBM3 at 700 W (chip_smoke.py):
// 62.5 us of device time at 4,096 rows, 43 % of the bound (2,048 rows take
// as long: 64 blocks on 64 SMs, each block's own time).
//
// Sums: an output's sum over a tap's input channels is one fmaf chain in
// channel order from 0, in registers (acc); the taps' sums are added to y
// in tap order, then the bias, then the ReLU, as conv1d_nlc adds its
// products. Each sum's order is fixed by this code, nothing is summed
// across chunks, so a chunk's bits do not depend on the rows launched with
// it. At every tier (tier.cuh) the products are CUDA-core fmafs: fp32 at
// faithful; bf16_3x (three fmafs on a packed word) at balanced; bf16
// operands at fast and turbo, the activations rounded to bf16 once where
// they are staged (a product of bf16 values is exact in fp32: the same
// bits as a rounding at every read); turbo also rounds each tap's sum,
// each partial sum of the taps and the bias-add where conv1d_nlc stores
// them (store_at), so the chain's bf16 storage is the plain version's.
#include <cuda_runtime.h>

#include "stft_tile.cuh"
#include "tier.cuh"

namespace {
namespace v5_convs {

constexpr int THREADS = 256;
constexpr int CHUNKS = 32;  // chunks a block owns
constexpr int PAIRS = CHUNKS / 2;  // a thread's 2 chunks: 16 chunk groups x 16 output groups
constexpr int GROUPS = THREADS / PAIRS;
constexpr int FRAMES = 4;  // spectrum frames a chunk
constexpr int OUT = 128;   // features a chunk
constexpr int SLICE = 2048;  // floats of a weight slice
constexpr int STAGES = 3;    // slices in the ring
constexpr int PAD = 4;       // floats after each channel's row of a staged activation

// Output frame f of a k3 conv with pad 1 over l_in frames reads input
// frame f * stride + tap - 1; a tap is used if some output frame reads a
// real frame through it.
__host__ __device__ constexpr bool reads(int l_in, int stride, int f, int tap) {
  return f * stride + tap - 1 >= 0 && f * stride + tap - 1 < l_in;
}
__host__ __device__ constexpr bool used(int l_in, int stride, int tap) {
  for (int f = 0; f < (l_in - 1) / stride + 1; ++f) {
    if (reads(l_in, stride, f, tap)) return true;
  }
  return false;
}

// One conv of the chain over L_IN_ frames: C_IN_ -> C_OUT_, k3, pad 1.
template <int C_IN_, int C_OUT_, int L_IN_, int STRIDE_>
struct Conv {
  static constexpr int C_IN = C_IN_, C_OUT = C_OUT_, L_IN = L_IN_, STRIDE = STRIDE_;
  static constexpr int L_OUT = (L_IN - 1) / STRIDE + 1;
  static constexpr int BK = SLICE / C_OUT;         // input channels a slice
  static constexpr int KS = (C_IN + BK - 1) / BK;  // slices a tap
  static constexpr int LD_IN = CHUNKS * L_IN + PAD;   // a channel's row of the input
  static constexpr int LD_OUT = CHUNKS * L_OUT + PAD;  // ... of the output
  static constexpr int OPT = C_OUT / GROUPS;  // outputs a thread, QUADS float4s
  static constexpr int QUADS = OPT / 4;
  static constexpr int SLICES =
      (used(L_IN, STRIDE, 0) + used(L_IN, STRIDE, 1) + used(L_IN, STRIDE, 2)) * KS;
  static_assert(SLICE % C_OUT == 0 && C_OUT % (4 * GROUPS) == 0, "whole float4s a thread");
};

template <int C_IN>
struct Chain {
  using C1 = Conv<C_IN, 128, FRAMES, 1>;
  using C2 = Conv<128, 64, C1::L_OUT, 2>;
  using C3 = Conv<64, 64, C2::L_OUT, 2>;
  using C4 = Conv<64, OUT, C3::L_OUT, 1>;
  static_assert(C4::L_OUT == 1, "one feature frame a chunk");
  static constexpr int SLICES = C1::SLICES + C2::SLICES + C3::SLICES + C4::SLICES;
  // shared memory: the ring, then two activation buffers used in turn (A:
  // the spectrum, conv 2's output; B: conv 1's output, conv 3's output)
  static constexpr int A_FLOATS =
      C_IN * C1::LD_IN > C2::C_OUT * C2::LD_OUT ? C_IN * C1::LD_IN : C2::C_OUT * C2::LD_OUT;
  static constexpr int B_FLOATS =
      C1::C_OUT * C1::LD_OUT > C3::C_OUT * C3::LD_OUT ? C1::C_OUT * C1::LD_OUT
                                                     : C3::C_OUT * C3::LD_OUT;
  static constexpr int SMEM_FLOATS = STAGES * SLICE + A_FLOATS + B_FLOATS;
  static_assert(A_FLOATS % 4 == 0 && B_FLOATS % 4 == 0, "16-byte aligned buffers");
};

// The weight slices in the order the convs read them, through a ring of
// STAGES buffers: next() waits for slice t, makes it visible to the block
// (one barrier), starts the copy of slice t + STAGES - 1 into the buffer
// that slice t - 1 left, and returns slice t.
struct Ring {
  float* buf;
  const float* w;
  int total;
  int t = 0;

  __device__ __forceinline__ void load(int s) const {
    const float* src = w + static_cast<long long>(s) * SLICE;
    float* dst = buf + (s % STAGES) * SLICE;
    for (int i = threadIdx.x; i < SLICE / 4; i += THREADS) {
      stft_block::cp_async16(dst + 4 * i, src + 4 * i);
    }
  }
  // the first STAGES - 1 slices, each its own group (the caller's staging
  // copies join the first)
  __device__ __forceinline__ void start() const {
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
      if (s < total) load(s);
      stft_block::cp_async_commit();
    }
  }
  __device__ __forceinline__ const float* next() {
    stft_block::cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (t + STAGES - 1 < total) load(t + STAGES - 1);
    stft_block::cp_async_commit();
    return buf + (t++ % STAGES) * SLICE;
  }
};

// n consecutive floats from shared memory, 16-byte aligned where n allows
template <int N>
__device__ __forceinline__ void load_run(float (&v)[N], const float* p) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const float4 q = *reinterpret_cast<const float4*>(p + i);
      v[i] = q.x, v[i + 1] = q.y, v[i + 2] = q.z, v[i + 3] = q.w;
    }
  } else if constexpr (N == 2) {
    const float2 q = *reinterpret_cast<const float2*>(p);
    v[0] = q.x, v[1] = q.y;
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = p[i];
  }
}

template <int N>
__device__ __forceinline__ void store_run(float* p, const float (&v)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      *reinterpret_cast<float4*>(p + i) = make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
    }
  } else if constexpr (N == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) p[i] = v[i];
  }
}

// output j of the OPT a thread of output group og owns: 4 consecutive
// outputs a quarter of C_OUT / QUADS, so the 16 groups' float4s of one
// quarter are one run
template <class C>
__device__ __forceinline__ int out_of(int og, int j) {
  return (j / 4) * (C::C_OUT / C::QUADS) + 4 * og + (j % 4);
}

// The products' operands as the tier reads an activation: bf16 operands
// come rounded from the staging, so they take the fp32 form
template <int T>
__host__ __device__ constexpr int operand_mode() {
  return Tier<T>::kProducts == P_BF16 ? P_FP32 : Tier<T>::kProducts;
}

// acc += this thread's products over KC input channels of one slice of
// tap TAP: x at the slice's first channel (the thread's chunks), w the
// slice
template <int T, class C, int TAP, int KC>
__device__ __forceinline__ void channels(const float* x, const float* w, int og,
                                         float (&acc)[2][C::L_OUT][C::OPT]) {
#pragma unroll 4
  for (int k = 0; k < KC; ++k) {
    float xv[2 * C::L_IN];
    load_run(xv, x + k * C::LD_IN);
    float wv[C::OPT];
#pragma unroll
    for (int q = 0; q < C::QUADS; ++q) {
      const float4 v =
          *reinterpret_cast<const float4*>(w + k * C::C_OUT + q * (C::C_OUT / C::QUADS) + 4 * og);
      wv[4 * q] = v.x, wv[4 * q + 1] = v.y, wv[4 * q + 2] = v.z, wv[4 * q + 3] = v.w;
    }
#pragma unroll
    for (int cc = 0; cc < 2; ++cc) {
#pragma unroll
      for (int f = 0; f < C::L_OUT; ++f) {
        if (reads(C::L_IN, C::STRIDE, f, TAP)) {
          const Operand<operand_mode<T>()> a(xv[cc * C::L_IN + f * C::STRIDE + TAP - 1]);
#pragma unroll
          for (int j = 0; j < C::OPT; ++j) acc[cc][f][j] = a.fma(wv[j], acc[cc][f][j]);
        }
      }
    }
  }
}

// One tap of a conv: its slices' sums over the input channels (acc), then
// y = y + acc at the tier's storage, for the frames that read a real frame
template <int T, class C, int TAP>
__device__ __forceinline__ void tap(const float* x, Ring& ring, int og,
                                    float (&y)[2][C::L_OUT][C::OPT]) {
  if constexpr (used(C::L_IN, C::STRIDE, TAP)) {
    float acc[2][C::L_OUT][C::OPT];
#pragma unroll
    for (int cc = 0; cc < 2; ++cc) {
#pragma unroll
      for (int f = 0; f < C::L_OUT; ++f) {
#pragma unroll
        for (int j = 0; j < C::OPT; ++j) acc[cc][f][j] = 0.f;
      }
    }
    constexpr int REST = C::C_IN % C::BK;
#pragma unroll 1
    for (int s = 0; s < C::KS - (REST ? 1 : 0); ++s) {
      const float* w = ring.next();
      channels<T, C, TAP, C::BK>(x + s * C::BK * C::LD_IN, w, og, acc);
    }
    if constexpr (REST != 0) {
      const float* w = ring.next();
      channels<T, C, TAP, REST>(x + (C::KS - 1) * C::BK * C::LD_IN, w, og, acc);
    }
#pragma unroll
    for (int cc = 0; cc < 2; ++cc) {
#pragma unroll
      for (int f = 0; f < C::L_OUT; ++f) {
        if (reads(C::L_IN, C::STRIDE, f, TAP)) {
#pragma unroll
          for (int j = 0; j < C::OPT; ++j) {
            y[cc][f][j] = store_at<T>(y[cc][f][j] + store_at<T>(acc[cc][f][j]));
          }
        }
      }
    }
  }
}

// One conv over the block's chunks: x the input in shared memory, bias its
// C_OUT biases (stored as the tier stores them); sink(cc, v) takes the
// thread's outputs of chunk cc of its pair, v[f][j] after the bias and the
// ReLU.
template <int T, class C, class Sink>
__device__ __forceinline__ void conv(const float* x, Ring& ring, const float* __restrict__ bias,
                                     const Sink& sink) {
  const int og = threadIdx.x % GROUPS;
  const int pair = threadIdx.x / GROUPS;
  const float* xt = x + pair * 2 * C::L_IN;
  float y[2][C::L_OUT][C::OPT];
#pragma unroll
  for (int cc = 0; cc < 2; ++cc) {
#pragma unroll
    for (int f = 0; f < C::L_OUT; ++f) {
#pragma unroll
      for (int j = 0; j < C::OPT; ++j) y[cc][f][j] = 0.f;
    }
  }
  tap<T, C, 0>(xt, ring, og, y);
  tap<T, C, 1>(xt, ring, og, y);
  tap<T, C, 2>(xt, ring, og, y);
  float b[C::OPT];
#pragma unroll
  for (int j = 0; j < C::OPT; ++j) b[j] = __ldg(bias + out_of<C>(og, j));
#pragma unroll
  for (int cc = 0; cc < 2; ++cc) {
#pragma unroll
    for (int f = 0; f < C::L_OUT; ++f) {
#pragma unroll
      for (int j = 0; j < C::OPT; ++j) {
        const float v = store_at<T>(y[cc][f][j] + b[j]);
        y[cc][f][j] = v < 0.f ? 0.f : v;  // ReLU; a NaN passes, as torch.relu's
      }
    }
    sink(og, pair, cc, y[cc]);
  }
}

// A conv's output as the next conv's input: channel-major in shared
// memory, rounded to bf16 where the next products take bf16 operands
template <int T, class C>
struct SharedSink {
  float* dst;
  __device__ __forceinline__ void operator()(int og, int pair, int cc,
                                             const float (&v)[C::L_OUT][C::OPT]) const {
#pragma unroll
    for (int j = 0; j < C::OPT; ++j) {
      float run[C::L_OUT];
#pragma unroll
      for (int f = 0; f < C::L_OUT; ++f) {
        run[f] = Tier<T>::kProducts == P_BF16 ? bf16_rn(v[f][j]) : v[f][j];
      }
      store_run(dst + out_of<C>(og, j) * C::LD_OUT + (2 * pair + cc) * C::L_OUT, run);
    }
  }
};

// The last conv's output, one frame a chunk, to out [rows, 128]
template <class C>
struct GlobalSink {
  float* out;
  int chunk0;
  int rows;
  __device__ __forceinline__ void operator()(int og, int pair, int cc,
                                             const float (&v)[1][C::OPT]) const {
    const int row = chunk0 + 2 * pair + cc;
    if (row >= rows) return;
    float* dst = out + static_cast<long long>(row) * C::C_OUT;
#pragma unroll
    for (int q = 0; q < C::QUADS; ++q) {
      *reinterpret_cast<float4*>(dst + out_of<C>(og, 4 * q)) =
          make_float4(v[0][4 * q], v[0][4 * q + 1], v[0][4 * q + 2], v[0][4 * q + 3]);
    }
  }
};

template <int C_IN, int T>
__global__ void __launch_bounds__(THREADS, 1)
v5_convs_kernel(const float* __restrict__ spect, int rows, const float* __restrict__ packed,
                float* __restrict__ out) {
  using K = Chain<C_IN>;
  extern __shared__ __align__(16) float smem[];
  float* a = smem + STAGES * SLICE;
  float* b = a + K::A_FLOATS;
  const int chunk0 = blockIdx.x * CHUNKS;
  const int live = min(CHUNKS, rows - chunk0);
  // the spectrum of the block's chunks, channel-major: (c, chunk, frame)
  // at a[c * LD_IN + chunk * FRAMES + frame]; chunks past the rows zero
  constexpr int PER_CHUNK = FRAMES * C_IN;
  const float* src = spect + static_cast<long long>(chunk0) * PER_CHUNK;
  const int n = live * PER_CHUNK;
  const auto at = [](int i) {
    const int ch = i / PER_CHUNK;
    const int f = (i - ch * PER_CHUNK) / C_IN;
    const int c = i - ch * PER_CHUNK - f * C_IN;
    return c * K::C1::LD_IN + ch * FRAMES + f;
  };
  for (int i = threadIdx.x; i < n; i += THREADS) stft_block::cp_async4(a + at(i), src + i);
  for (int i = n + threadIdx.x; i < CHUNKS * PER_CHUNK; i += THREADS) a[at(i)] = 0.f;
  Ring ring{smem, packed, K::SLICES};
  ring.start();
  if constexpr (Tier<T>::kProducts == P_BF16) {
    // this thread's copies landed: round them in place (the first slice's
    // barrier shows them to the block)
    stft_block::cp_async_wait<0>();
    for (int i = threadIdx.x; i < n; i += THREADS) a[at(i)] = bf16_rn(a[at(i)]);
  }
  const float* bias = packed + static_cast<long long>(K::SLICES) * SLICE;
  conv<T, typename K::C1>(a, ring, bias, SharedSink<T, typename K::C1>{b});
  conv<T, typename K::C2>(b, ring, bias + K::C1::C_OUT, SharedSink<T, typename K::C2>{a});
  conv<T, typename K::C3>(a, ring, bias + K::C1::C_OUT + K::C2::C_OUT,
                          SharedSink<T, typename K::C3>{b});
  conv<T, typename K::C4>(b, ring, bias + K::C1::C_OUT + K::C2::C_OUT + K::C3::C_OUT,
                          GlobalSink<typename K::C4>{out, chunk0, rows});
}

template <int C_IN, int T>
int launch(const float* spect, int rows, const float* packed, float* out, cudaStream_t stream) {
  constexpr size_t bytes = sizeof(float) * Chain<C_IN>::SMEM_FLOATS;
  static_assert(bytes <= stft_block::MAX_SHARED_BYTES, "one block's shared memory");
  const cudaError_t err = stft_block::allow_shared_memory<v5_convs_kernel<C_IN, T>>();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = (rows + CHUNKS - 1) / CHUNKS;
  v5_convs_kernel<C_IN, T><<<grid, THREADS, bytes, stream>>>(spect, rows, packed, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace v5_convs
}  // namespace

// spect: [rows, 4, c_in] fp32, contiguous; packed: the weight slices and
// the biases as kernels/v5_convs.py: packed_weights lays them out for the
// tier; out: [rows, 128] fp32. c_in 129 or 65, rows >= 1, tier 0-3
// (tier.cuh). Returns cudaGetLastError() after the launch.
extern "C" int vadc_v5_convs(const float* spect, int rows, int c_in, const float* packed,
                             float* out, int tier, void* stream) {
  if (rows <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return by_tier(tier, [&](auto t) {
    constexpr int T = decltype(t)::value;
    if (c_in == 129) return v5_convs::launch<129, T>(spect, rows, packed, out, s);
    if (c_in == 65) return v5_convs::launch<65, T>(spect, rows, packed, out, s);
    return static_cast<int>(cudaErrorInvalidValue);
  });
}
