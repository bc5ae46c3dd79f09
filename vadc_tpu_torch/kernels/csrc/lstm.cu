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
// Numerics are the faithful tier's: fp32 sums in k order (inputs, then
// recurrent units, then the bias), sigmoid as 1/(1+expf(-x)), the accurate
// tanh of vadc_tpu/nn/functional.py accurate_tanh, no --use_fast_math.
#include <cuda_runtime.h>

#include "lstm_cell.cuh"
#include "lstm_resident.cuh"

namespace {

constexpr int NB = 4;  // streams per block

template <int H>
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
        const int j = tid;
        float acc[NB];
#pragma unroll
        for (int s = 0; s < NB; ++s) acc[s] = 0.f;
#pragma unroll 8
        for (int k = 0; k < H; ++k) {
          const float wv = __ldg(w + k * G + j);
#pragma unroll
          for (int s = 0; s < NB; ++s) acc[s] = fmaf(in[s * H + k], wv, acc[s]);
        }
#pragma unroll 8
        for (int k = 0; k < H; ++k) {
          const float wv = __ldg(w + (H + k) * G + j);
#pragma unroll
          for (int s = 0; s < NB; ++s) acc[s] = fmaf(h_l[s * H + k], wv, acc[s]);
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
        const float ig = sigmoidf(g[u]);
        const float fg = sigmoidf(g[H + u]);
        const float gg = accurate_tanhf(g[2 * H + u]);
        const float og = sigmoidf(g[3 * H + u]);
        const float c_new = fg * c_l[i] + ig * gg;
        const float h_new = og * accurate_tanhf(c_new);
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

template <int H>
int launch(const float* x, const float* h0, const float* c0, const float* wt,
           const float* bias, float* y, float* hn, float* cn, int batch, int seq,
           int layers, cudaStream_t stream) {
  const size_t floats = static_cast<size_t>(NB) * H * (1 + 2 * layers) + NB * 4 * H;
  const size_t bytes = floats * sizeof(float);
  if (bytes > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  const int grid = (batch + NB - 1) / NB;
  lstm_kernel<H><<<grid, 4 * H, bytes, stream>>>(x, h0, c0, wt, bias, y, hn, cn, batch,
                                                 seq, layers);
  return static_cast<int>(cudaGetLastError());
}

// One launch of the H=128, L=1 recurrent kernel over pre [batch, frames, 512],
// at 1, 2 or 4 streams a cluster.
cudaError_t launch_cluster(const float* pre, const float* h0, const float* c0, const float* wt,
                           const float* bias, float* y, long long y_stride_b, float* hn,
                           float* cn, int batch, int frames, cudaStream_t stream) {
  using resident::launch_cluster1;
  int nb = 0;
  const cudaError_t err = resident::streams_per_block(batch, &nb);
  if (err != cudaSuccess) return err;
  if (nb == 1) {
    return launch_cluster1<1>(pre, h0, c0, wt, bias, y, y_stride_b, hn, cn, batch, frames, stream);
  }
  if (nb == 2) {
    return launch_cluster1<2>(pre, h0, c0, wt, bias, y, y_stride_b, hn, cn, batch, frames, stream);
  }
  return launch_cluster1<4>(pre, h0, c0, wt, bias, y, y_stride_b, hn, cn, batch, frames, stream);
}

}  // namespace

// x [batch, seq, hidden]; h0, c0, hn, cn [layers, batch, hidden] (hn, cn
// may alias h0, c0); wt [layers, 2*hidden, 4*hidden]; bias [layers,
// 4*hidden]; y [batch, seq, hidden]; all contiguous fp32. hidden is 64 or
// 128. Returns cudaGetLastError() after the launch.
extern "C" int vadc_lstm_fused(const float* x, const float* h0, const float* c0,
                               const float* wt, const float* bias, float* y, float* hn,
                               float* cn, int batch, int seq, int hidden, int layers,
                               void* stream) {
  if (batch <= 0 || seq <= 0 || layers <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hidden == 64) return launch<64>(x, h0, c0, wt, bias, y, hn, cn, batch, seq, layers, s);
  if (hidden == 128) return launch<128>(x, h0, c0, wt, bias, y, hn, cn, batch, seq, layers, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The same function by the resident-weights variant. Beyond vadc_lstm_fused:
// pre is scratch of pre_rows x 4*hidden floats (pre_rows >= batch; fewer
// rows than batch * seq make passes over the frames); hidden 64 takes
// layers 2, hidden 128 layers 1; *launched receives the number of kernels it
// launched (the pre-pass and the recurrent kernel of every pass). Returns
// the first CUDA error of its launches.
extern "C" int vadc_lstm_fused_resident(const float* x, const float* h0, const float* c0,
                                        const float* wt, const float* bias, float* pre,
                                        long long pre_rows, float* y, float* hn, float* cn,
                                        int batch, int seq, int hidden, int layers,
                                        int* launched, void* stream) {
  *launched = 0;
  if (batch <= 0 || seq <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  using namespace resident;
  if (hidden == 64 && layers == 2) {
    return run_in_passes<H2>(
        x, h0, c0, wt, pre, pre_rows, hn, cn, batch, seq, 1,
        [=](int f0, int n, const float* h, const float* c) {
          const StoreY top{y + static_cast<long long>(f0) * H2, static_cast<long long>(seq) * H2};
          return launch_wavefront(pre, h, c, wt, bias, hn, cn, batch, n, top, s);
        },
        launched, s);
  }
  if (hidden == 128 && layers == 1) {
    return run_in_passes<H1>(
        x, h0, c0, wt, pre, pre_rows, hn, cn, batch, seq, 1,
        [=](int f0, int n, const float* h, const float* c) {
          return launch_cluster(pre, h, c, wt, bias, y + static_cast<long long>(f0) * H1,
                                static_cast<long long>(seq) * H1, hn, cn, batch, n, s);
        },
        launched, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
