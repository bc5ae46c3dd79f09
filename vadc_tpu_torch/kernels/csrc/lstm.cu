// Multi-layer LSTM over a whole sequence in one launch, in two variants that
// give the same bits.
//
// Replaces the Pallas kernel vadc_tpu/kernels/lstm.py: lstm_fused
// (pallas_call at :204). x [B, T, H], h0/c0 [L, B, H], the fused weight
// transposed to wt [L, 2H, 4H] (rows: the H inputs, then the H recurrent
// units; columns: gates i, f, g, o) and the pre-summed bias b [L, 4H] ->
// y [B, T, H] (the top layer's h at every step), hn, cn [L, B, H]. v4 runs
// it at L=2, H=64; v5 at L=1, H=128. hn/cn may alias h0/c0: a block reads
// its streams' state before it writes any, and blocks own disjoint streams.
//
// What bounds it on an H100: not FLOPs (2 x 2H x 4H multiply-adds per stream
// per layer-step: 0.54 GFLOP for v5 at batch 2048, T=1) but the chain of T x
// L dependent steps and the weight reads.
//
// The streaming-weights variant (lstm_kernel, vadc_lstm_fused), for calls of
// one or two steps (v5's and the short v4 chunks' one frame a chunk), where
// loading the weights onto the SM first does not pay. Streams are independent, so a block takes NB
// streams and walks every step for them with h, c, the input row and the
// gates in shared memory (a few KB). Thread j owns gate column j (4H
// threads: 256 for H=64, 512 for H=128) and keeps NB sums in registers, so
// each weight it reads serves NB streams. The weights (128 KB a layer at
// H=64, 512 KB at H=128) are read from global memory with __ldg, where they
// stay in L2; neighbouring threads read neighbouring columns. A ragged last
// block computes on zero rows and stores only its real streams. With many
// blocks on every SM the L2 latency of those reads is hidden; at batch 1
// (the CLI's minibatched path: T = 96 chunks x frames) one block walks the
// whole sequence and every step waits on them.
//
// The resident-weights variant (vadc_lstm_fused_resident, the kernels of
// lstm_resident.cuh), for three steps and more: the recurrent weights stay on the SM
// for the whole launch, the input half of layer 0 is computed for all frames
// before the chain, and the two layers of v4 run as a wavefront; v5's one
// layer of 128 units is split over a cluster of two blocks. What bounds it
// then (the fmaf chains, the shared-memory pipe, the latency of the
// activations) is in that header. kernels/lstm.py chooses between the two from the shapes.
//
// Numerics: sigmoid as 1/(1+expf(-x)), no --use_fast_math. Both variants
// take the precision tier T as a template parameter (tier.cuh), an instance
// each, with the tier's tanh (the accurate tanh of
// vadc_tpu/nn/functional.py accurate_tanh at faithful and balanced, tanhf at
// fast and turbo; lstm_cell.cuh). At faithful the gate sums are fp32 fmaf
// chains in k order (inputs, then recurrent units, then the bias). At the
// bf16 tiers they run on the tensor cores (lstm_mma.cuh: each k16 step's
// MMA from zero, added in k order, the input steps, then the recurrent
// ones, then the bias) from the gate fragments the wrapper packs; both
// variants and the step kernels' LSTM call that one function, so the two
// variants give the same bits at every tier. The JAX package's Pallas
// lstm_fused has no tier (it sums at HIGHEST); its v4/v5 models run
// nn.functional.lstm, whose gates take the tier's products: the tier
// instances compute that.
#include <cuda_runtime.h>

#include "lstm_cell.cuh"
#include "lstm_mma.cuh"
#include "lstm_resident.cuh"

namespace {

constexpr int NB = 4;  // streams per block

template <int H, int T>
__global__ void __launch_bounds__(4 * H)
lstm_kernel(const float* __restrict__ x, const float* h0, const float* c0,
            const float* __restrict__ wt, const float* __restrict__ bias,
            float* __restrict__ y, float* hn, float* cn, int batch, int seq, int layers) {
  constexpr int G = 4 * H;  // gate columns = threads
  extern __shared__ float smem[];
  float* xin = smem;                     // [NB][H]
  float* hs = xin + NB * H;              // [L][NB][H]
  float* cs = hs + layers * NB * H;      // [L][NB][H]
  float* gates = cs + layers * NB * H;   // [NB][G]
  const int b0 = blockIdx.x * NB;
  const int tid = threadIdx.x;

  for (int i = tid; i < layers * NB * H; i += G) {
    const int layer = i / (NB * H);
    const int s = (i / H) % NB;
    const int u = i % H;
    const bool ok = b0 + s < batch;
    const long long g = (static_cast<long long>(layer) * batch + b0 + s) * H + u;
    hs[i] = ok ? h0[g] : 0.f;
    cs[i] = ok ? c0[g] : 0.f;
  }

  for (int t = 0; t < seq; ++t) {
    for (int i = tid; i < NB * H; i += G) {
      const int s = i / H;
      const int u = i % H;
      xin[i] = b0 + s < batch ? x[(static_cast<long long>(b0 + s) * seq + t) * H + u] : 0.f;
    }
    __syncthreads();
    for (int layer = 0; layer < layers; ++layer) {
      const float* w = wt + static_cast<long long>(layer) * 2 * H * G;
      const float* in = layer == 0 ? xin : hs + (layer - 1) * NB * H;
      float* h_l = hs + layer * NB * H;
      float* c_l = cs + layer * NB * H;
      {
        using Op = Operand<Tier<T>::kProducts>;
        const int j = tid;
        float acc[NB];
#pragma unroll
        for (int s = 0; s < NB; ++s) acc[s] = 0.f;
#pragma unroll 8
        for (int k = 0; k < H; ++k) {
          const float wv = __ldg(w + k * G + j);
#pragma unroll
          for (int s = 0; s < NB; ++s) acc[s] = Op(in[s * H + k]).fma(wv, acc[s]);
        }
#pragma unroll 8
        for (int k = 0; k < H; ++k) {
          const float wv = __ldg(w + (H + k) * G + j);
#pragma unroll
          for (int s = 0; s < NB; ++s) acc[s] = Op(h_l[s * H + k]).fma(wv, acc[s]);
        }
        const float b = __ldg(bias + layer * G + j);
#pragma unroll
        for (int s = 0; s < NB; ++s) gates[s * G + j] = acc[s] + b;
      }
      __syncthreads();
      for (int i = tid; i < NB * H; i += G) {
        const int s = i / H;
        const int u = i % H;
        const float* g = gates + s * G;
        float c_new = c_l[i];
        const float h_new =
            lstm_cell<T>(gate_activation<T>(0, g[u]), gate_activation<T>(1, g[H + u]),
                         gate_activation<T>(2, g[2 * H + u]), gate_activation<T>(3, g[3 * H + u]),
                         c_new);
        c_l[i] = c_new;
        h_l[i] = h_new;
        if (layer == layers - 1 && b0 + s < batch) {
          y[(static_cast<long long>(b0 + s) * seq + t) * H + u] = h_new;
        }
      }
      __syncthreads();
    }
  }

  for (int i = tid; i < layers * NB * H; i += G) {
    const int layer = i / (NB * H);
    const int s = (i / H) % NB;
    const int u = i % H;
    if (b0 + s >= batch) continue;
    const long long g = (static_cast<long long>(layer) * batch + b0 + s) * H + u;
    hn[g] = hs[i];
    cn[g] = cs[i];
  }
}

// The streaming-weights variant at the bf16 tiers (lstm_mma.cuh): a block
// of 8 warps takes nb <= 8 streams (the n8 tile of the gate sums), warp w
// the gate tiles w * TPW .. + TPW - 1 of every layer, their A fragments
// read from global memory (L2) where they are used, as the faithful
// kernel reads its weights. Per layer-step: every warp's sums (x or the
// layer below's new h, then the layer's old h) stored for the real
// streams, a barrier, one thread a cell (c in shared memory, since the
// depth is a run-time value), a barrier. wt is the layers' packed
// fragments, one after the other.
constexpr int STREAM_THREADS = 256;

template <int H>
__host__ __device__ constexpr int mma_ld() {
  return H + 8;  // a stream's row pitch: the float2 reads of b_frag fall on distinct banks
}

template <int H>
constexpr size_t mma_smem_bytes(int layers) {
  return sizeof(float) * gate_mma::kMaxStreams *
         (mma_ld<H>() * (1 + 2 * layers) + gate_mma::kGatesLd<H>);
}

// Two blocks an SM: up to 128 registers a thread, so that ptxas keeps the
// fragment loads in flight in registers (left to itself it took 48 and
// spilled the balanced H=64 instance).
template <int H, int T>
__global__ void __launch_bounds__(STREAM_THREADS, 2)
lstm_mma_kernel(const float* __restrict__ x, const float* h0, const float* c0,
                const float* __restrict__ wt, const float* __restrict__ bias,
                float* __restrict__ y, float* hn, float* cn, int batch, int seq, int layers,
                int nb) {
  using namespace gate_mma;
  using Geo = Geometry<H>;
  constexpr int M = Tier<T>::kProducts;
  constexpr int LD = mma_ld<H>();
  constexpr int GLD = kGatesLd<H>;
  constexpr int TPW = Geo::kTiles / (STREAM_THREADS / 32);  // tiles a warp
  constexpr int ROWS = kMaxStreams * LD;
  extern __shared__ float4 mma_smem4[];
  float* xin = reinterpret_cast<float*>(mma_smem4);  // [8][LD]
  float* hs = xin + ROWS;                            // [L][8][LD]
  float* cs = hs + layers * ROWS;                    // [L][8][LD]
  float* gates = cs + layers * ROWS;                 // [8][GLD]
  const int b0 = blockIdx.x * nb;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int g = lane_id() >> 2;

  for (int i = tid; i < (1 + 2 * layers) * ROWS; i += STREAM_THREADS) xin[i] = 0.f;
  __syncthreads();
  for (int i = tid; i < layers * kMaxStreams * H; i += STREAM_THREADS) {
    const int layer = i / (kMaxStreams * H);
    const int s = (i / H) % kMaxStreams;
    const int u = i % H;
    if (s >= nb || b0 + s >= batch) continue;
    const long long at = (static_cast<long long>(layer) * batch + b0 + s) * H + u;
    hs[layer * ROWS + s * LD + u] = h0[at];
    cs[layer * ROWS + s * LD + u] = c0[at];
  }

  for (int t = 0; t < seq; ++t) {
    for (int i = tid; i < kMaxStreams * H; i += STREAM_THREADS) {
      const int s = i / H;
      if (s < nb && b0 + s < batch) {
        xin[s * LD + i % H] = x[(static_cast<long long>(b0 + s) * seq + t) * H + i % H];
      }
    }
    __syncthreads();
    for (int layer = 0; layer < layers; ++layer) {
      const float* w = wt + static_cast<long long>(layer) * planes<M>() * Geo::kPlaneWords;
      const float* in = (layer == 0 ? xin : hs + (layer - 1) * ROWS) + g * LD;
      const float* h_l = hs + layer * ROWS + g * LD;
#pragma unroll
      for (int k = 0; k < TPW; ++k) {
        const int m = warp * TPW + k;
        float acc[4] = {0.f, 0.f, 0.f, 0.f};
        gate_sum<M, Geo::kInSteps>(
            acc, [=](int s, int p) { return frag_global<H>(w, p, m, s); },
            [=](int s, uint32_t(&bh)[2], uint32_t(&bl)[2]) { b_frag<M>(in, 16 * s, bh, bl); });
        gate_sum<M, Geo::kInSteps>(
            acc, [=](int s, int p) { return frag_global<H>(w, p, m, Geo::kInSteps + s); },
            [=](int s, uint32_t(&bh)[2], uint32_t(&bl)[2]) { b_frag<M>(h_l, 16 * s, bh, bl); });
        add_bias(acc, tile_bias<H>(bias + layer * 4 * H, m));
        store_gates<H>(acc, gates, GLD, m, nb);
      }
      __syncthreads();
      for (int i = tid; i < nb * H; i += STREAM_THREADS) {
        const int s = i / H;
        const int u = i % H;
        float* c = cs + layer * ROWS + s * LD + u;
        const float h_new = cell_from_gates<T, H>(gates + s * GLD, u, *c);
        hs[layer * ROWS + s * LD + u] = h_new;
        if (layer == layers - 1 && b0 + s < batch) {
          y[(static_cast<long long>(b0 + s) * seq + t) * H + u] = h_new;
        }
      }
      __syncthreads();
    }
  }

  for (int i = tid; i < layers * kMaxStreams * H; i += STREAM_THREADS) {
    const int layer = i / (kMaxStreams * H);
    const int s = (i / H) % kMaxStreams;
    const int u = i % H;
    if (s >= nb || b0 + s >= batch) continue;
    const long long at = (static_cast<long long>(layer) * batch + b0 + s) * H + u;
    hn[at] = hs[layer * ROWS + s * LD + u];
    cn[at] = cs[layer * ROWS + s * LD + u];
  }
}

template <int H, int T>
int launch_mma(const float* x, const float* h0, const float* c0, const float* wt,
               const float* bias, float* y, float* hn, float* cn, int batch, int seq,
               int layers, int nb, cudaStream_t stream) {
  const size_t bytes = mma_smem_bytes<H>(layers);
  if (bytes > 48 * 1024 || nb < 1 || nb > gate_mma::kMaxStreams) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int grid = (batch + nb - 1) / nb;
  lstm_mma_kernel<H, T><<<grid, STREAM_THREADS, bytes, stream>>>(x, h0, c0, wt, bias, y, hn, cn,
                                                             batch, seq, layers, nb);
  return static_cast<int>(cudaGetLastError());
}

template <int H, int T>
int launch(const float* x, const float* h0, const float* c0, const float* wt,
           const float* bias, float* y, float* hn, float* cn, int batch, int seq,
           int layers, int nb, cudaStream_t stream) {
  if constexpr (T != TIER_FAITHFUL) {
    return launch_mma<H, T>(x, h0, c0, wt, bias, y, hn, cn, batch, seq, layers, nb, stream);
  } else {
    const size_t floats = static_cast<size_t>(NB) * H * (1 + 2 * layers) + NB * 4 * H;
    const size_t bytes = floats * sizeof(float);
    if (bytes > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
    const int grid = (batch + NB - 1) / NB;
    lstm_kernel<H, T><<<grid, 4 * H, bytes, stream>>>(x, h0, c0, wt, bias, y, hn, cn, batch,
                                                      seq, layers);
    return static_cast<int>(cudaGetLastError());
  }
}

// One launch of the H=128, L=1 recurrent kernel over pre [batch, frames, 512]
// at tier T: at faithful cluster1_kernel at 1, 2 or 4 streams a cluster, at
// the bf16 tiers cluster_mma_kernel at `streams`.
template <int T>
cudaError_t launch_cluster(const float* pre, const float* h0, const float* c0, const float* wt,
                           const float* bias, float* y, long long y_stride_b, float* hn,
                           float* cn, int batch, int frames, int streams, cudaStream_t stream) {
  if constexpr (T != TIER_FAITHFUL) {
    return resident::launch_cluster_mma<T>(pre, h0, c0, wt, bias, y, y_stride_b, hn, cn, batch,
                                           frames, streams, stream);
  } else {
    using resident::launch_cluster1;
    int nb = 0;
    const cudaError_t err = resident::streams_per_block(batch, &nb);
    if (err != cudaSuccess) return err;
    if (nb == 1) {
      return launch_cluster1<1, T>(pre, h0, c0, wt, bias, y, y_stride_b, hn, cn, batch, frames,
                                   stream);
    }
    if (nb == 2) {
      return launch_cluster1<2, T>(pre, h0, c0, wt, bias, y, y_stride_b, hn, cn, batch, frames,
                                   stream);
    }
    return launch_cluster1<4, T>(pre, h0, c0, wt, bias, y, y_stride_b, hn, cn, batch, frames,
                                 stream);
  }
}

// The resident-weights variant at tier T (vadc_lstm_fused_resident).
template <int T>
int fused_resident(const float* x, const float* h0, const float* c0, const float* wt,
                   const float* bias, float* pre, long long pre_rows, float* y, float* hn,
                   float* cn, int batch, int seq, int hidden, int layers, int streams,
                   int* launched, cudaStream_t s) {
  using namespace resident;
  if (hidden == 64 && layers == 2) {
    return run_in_passes<H2, T, StoreY<T>::kMma>(
        x, h0, c0, wt, pre, pre_rows, hn, cn, batch, seq, 1,
        [=](int f0, int n, const float* h, const float* c) {
          const StoreY<T> top{y + static_cast<long long>(f0) * H2,
                              static_cast<long long>(seq) * H2};
          return launch_wavefront(pre, h, c, wt, bias, hn, cn, batch, n, streams, top, s);
        },
        launched, s);
  }
  if (hidden == 128 && layers == 1) {
    return run_in_passes<H1, T, T != TIER_FAITHFUL>(
        x, h0, c0, wt, pre, pre_rows, hn, cn, batch, seq, 1,
        [=](int f0, int n, const float* h, const float* c) {
          return launch_cluster<T>(pre, h, c, wt, bias, y + static_cast<long long>(f0) * H1,
                                   static_cast<long long>(seq) * H1, hn, cn, batch, n, streams,
                                   s);
        },
        launched, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// x [batch, seq, hidden]; h0, c0, hn, cn [layers, batch, hidden] (hn, cn
// may alias h0, c0); bias [layers, 4*hidden]; y [batch, seq, hidden]; all
// contiguous fp32. wt: at faithful the transposed weight [layers, 2*hidden,
// 4*hidden]; at the bf16 tiers each layer's gate fragments
// (kernels/lstm.py: gate_fragments), and `streams` (1 to 8) the streams a
// block takes, which the faithful kernel (4 a block) ignores. hidden is 64
// or 128; tier: 0 faithful, 1 balanced, 2 fast, 3 turbo. Returns
// cudaGetLastError() after the launch.
extern "C" int vadc_lstm_fused(const float* x, const float* h0, const float* c0,
                               const float* wt, const float* bias, float* y, float* hn,
                               float* cn, int batch, int seq, int hidden, int layers, int tier,
                               int streams, void* stream) {
  if (batch <= 0 || seq <= 0 || layers <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return by_tier(tier, [&](auto t) {
    constexpr int T = decltype(t)::value;
    if (hidden == 64) {
      return launch<64, T>(x, h0, c0, wt, bias, y, hn, cn, batch, seq, layers, streams, s);
    }
    if (hidden == 128) {
      return launch<128, T>(x, h0, c0, wt, bias, y, hn, cn, batch, seq, layers, streams, s);
    }
    return static_cast<int>(cudaErrorInvalidValue);
  });
}

// The same function by the resident-weights variant. Beyond vadc_lstm_fused:
// pre is scratch of pre_rows x 4*hidden floats (pre_rows >= batch; fewer
// rows than batch * seq make passes over the frames); hidden 64 takes
// layers 2, hidden 128 layers 1; tier, wt and streams (a block's at the
// bf16 tiers, a cluster's at H=128) as vadc_lstm_fused's; *launched
// receives the number of kernels it launched (the pre-pass and the
// recurrent kernel of every pass). Returns the first CUDA error of its
// launches.
extern "C" int vadc_lstm_fused_resident(const float* x, const float* h0, const float* c0,
                                        const float* wt, const float* bias, float* pre,
                                        long long pre_rows, float* y, float* hn, float* cn,
                                        int batch, int seq, int hidden, int layers, int tier,
                                        int streams, int* launched, void* stream) {
  *launched = 0;
  if (batch <= 0 || seq <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return by_tier(tier, [&](auto t) {
    return fused_resident<decltype(t)::value>(x, h0, c0, wt, bias, pre, pre_rows, y, hn, cn,
                                              batch, seq, hidden, layers, streams, launched, s);
  });
}
