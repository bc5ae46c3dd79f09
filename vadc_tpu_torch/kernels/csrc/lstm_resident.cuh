// The resident-weights variant of the two recurrent kernels: lstm_fused's
// for chains of three steps and more (kernels/lstm.py holds the measured
// crossover), lstm_decoder_fused's at every shape. lstm.cu (replaces the
// Pallas kernel vadc_tpu/kernels/lstm.py: lstm_fused) and lstm_decoder.cu
// (replaces vadc_tpu/kernels/lstm.py: lstm_decoder_fused) launch it; their
// headers describe the functions. It gives the bits of the
// streaming-weights variant (lstm.cu's lstm_kernel and lstm_mma_kernel) and
// of the step kernels' LSTM (silero_v31_body.cuh:
// lstm_decoder_steps_hoisted) at every tier.
//
// What bounded the streaming variant on an H100 at few streams: every
// layer-step read its layer's weights again from L2 (128 KB at H=64, 512 KB
// at H=128), a few dependent-latency loads in flight for one block of 8
// warps on an SM, with nothing else there to hide them; the input half of
// layer 0, which depends on nothing recurrent, sat on the same chain; and
// the two layers ran one after the other.
//
// The design here:
//  - the input half of layer 0 is hoisted: input_gates_kernel computes
//    pre[row, j] = sum_k x[row, k] * wt0[k, j] for all frames of all streams
//    at once, each sum one fmaf chain from 0.f over k = 0..H-1. The recurrent
//    kernel starts each gate's chain from pre (read a step ahead into
//    registers), continues with the H recurrent terms in k order, then adds
//    the bias: the same sequence of fmafs as the streaming variant, so the
//    same bits;
//  - the weights stay on the SM for the whole launch, in registers wherever
//    they fit, and the layers run as a wavefront (layer 1 a frame or two
//    behind layer 0), so a sequence of F frames is F+1 or F+2 iterations,
//    not 2F layer-steps. Three kernels:
//    wavefront3_kernel (H=64, L=2, one stream a block: up to as many streams
//    as SMs): 384 threads with 128 weights each in registers, three stages;
//    see its own note.
//    wavefront2_kernel (H=64, L=2, 2 or 4 streams a block): 512 threads,
//    threads 0-255 own layer 0's gate columns, 256-511 layer 1's; a thread
//    keeps its column of W_hh in 64 registers and layer 1's input weight
//    W_ih1 (64 KB) lies in shared memory, column-contiguous (thread j in bank
//    j mod 32).
//    cluster1_kernel (H=128, L=1): W_hh is 256 KB, so a cluster of 2 blocks
//    of 256 threads splits the units; a thread keeps its column's 128
//    weights in registers, a block's cell update is local, and it writes its
//    64 new h values into both blocks' shared memory (distributed shared
//    memory), a cluster barrier ending the step;
//  - each gate column's sum stays one thread's fmaf chain in k order (a
//    split over threads would change the bits); h is read from shared memory
//    as float4 broadcasts (one load for four terms);
//  - the thread of a gate column applies the gate's activation to its sum
//    (one expf and one division each, all columns at once), so the 64
//    threads a stream that update the cells have one tanh left, not five
//    activations in a row; c, and the decoder's running sum, live in the
//    registers of the thread that updates them; a block takes 1, 2 or 4
//    streams (the fewest that still leave no more blocks than SMs), because
//    every stream more costs a block its fmafs and broadcasts again.
//
// What bounds them (NVIDIA H100 80GB HBM3, 700.00 W; chip_smoke.py's "time
// variants" lines, which timed these alternatives while they could be
// selected): with W_hh in shared memory (all three weights there, 192 KB) an
// iteration at one stream a block took 1.69 us, with W_hh in registers
// 1.24 us, with all weights in registers and three stages 1.09 us (0.7579,
// 0.5550 and 0.4881 ms for 64 streams x 448 frames; the streaming variant
// 9.54 ms, torch.nn.LSTM 0.57): the first two are paced by the
// shared-memory pipe (16 warps each reading W_ih1 and every h value), the
// last by latency that no thread can share: the 64-term chains, then expf
// and a division for the gate, then the same again for tanh(c), with two
// block barriers between them. W_hh in shared memory lost at every shape
// measured and is gone; so is wavefront2_kernel at one stream a block. At
// 2048 streams x 56 frames 2 streams a block took 0.9377 ms, 4 took 0.7896.
//
// Precision tiers (tier.cuh): lstm_decoder.cu's instances take the tier of
// the v3.1 model (its `Top`, DecoderSum<T>, carries it, and the pre-pass
// takes it as a template parameter), lstm.cu's the same way (StoreY<T>,
// the cluster kernel's T), the v4/v5 models' F.lstm at the tier. The
// kernels above are the faithful instances, and turbo's of
// lstm_decoder.cu. Where a tier's gates run on the tensor cores (a Top's
// kMma) the pre-pass is input_gates_mma_kernel and the recurrent kernels
// wavefront_mma_kernel and cluster_mma_kernel (below): the gate sums of
// lstm_mma.cuh, the one order of those instances (the step kernels' LSTM
// and lstm.cu's streaming kernel too), so a slab still equals the loop of
// steps and the variants one another bit for bit, with the tier's tanh and
// the same cell update.
//
// The scratch `pre` is the wrapper's (rows x 4H fp32); when it holds fewer
// rows than the call has, the launchers below walk the frames in passes,
// the state going through hn/cn between them (fp32 there as in the block, so
// the bits do not change).
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "lstm_cell.cuh"
#include "lstm_mma.cuh"

namespace {
namespace resident {

namespace cg = cooperative_groups;

constexpr int PRE_ROWS = 8;       // rows of x a block of the pre-pass takes
constexpr int PRE_THREADS = 256;  // one gate column each

// pre[r, j] = sum_k x_r[k] * wt0[k, j], r = b * frames + f over `rows` rows,
// x_r at x + b * stride_b + f * H; wt0 [>= H, 4H] (the H input rows of layer
// 0's transposed weight). A thread takes column j of PRE_ROWS rows, so each
// weight it reads serves them all. Tier T's products.
template <int H, int T>
__global__ void __launch_bounds__(PRE_THREADS)
input_gates_kernel(const float* __restrict__ x, long long stride_b, int frames,
                   const float* __restrict__ wt0, float* __restrict__ pre, long long rows) {
  constexpr int G = 4 * H;
  __shared__ float4 xs4[PRE_ROWS * H / 4];
  float* xs = reinterpret_cast<float*>(xs4);
  const long long r0 = static_cast<long long>(blockIdx.x) * PRE_ROWS;
  const int j = blockIdx.y * PRE_THREADS + threadIdx.x;
  for (int i = threadIdx.x; i < PRE_ROWS * H; i += PRE_THREADS) {
    const long long r = r0 + i / H;
    float v = 0.f;
    if (r < rows) {
      const long long b = r / frames;
      v = x[b * stride_b + (r - b * frames) * H + i % H];
    }
    xs[i] = v;
  }
  __syncthreads();
  float acc[PRE_ROWS];
#pragma unroll
  for (int r = 0; r < PRE_ROWS; ++r) acc[r] = 0.f;
#pragma unroll 4
  for (int k = 0; k < H; k += 4) {
    const float w0 = __ldg(wt0 + (k + 0) * G + j);
    const float w1 = __ldg(wt0 + (k + 1) * G + j);
    const float w2 = __ldg(wt0 + (k + 2) * G + j);
    const float w3 = __ldg(wt0 + (k + 3) * G + j);
#pragma unroll
    for (int r = 0; r < PRE_ROWS; ++r) {
      const float4 v = xs4[(r * H + k) / 4];
      using Op = Operand<Tier<T>::kProducts>;
      acc[r] = Op(v.x).fma(w0, acc[r]);
      acc[r] = Op(v.y).fma(w1, acc[r]);
      acc[r] = Op(v.z).fma(w2, acc[r]);
      acc[r] = Op(v.w).fma(w3, acc[r]);
    }
  }
#pragma unroll
  for (int r = 0; r < PRE_ROWS; ++r) {
    if (r0 + r < rows) pre[(r0 + r) * G + j] = acc[r];
  }
}

// The pre-pass at the bf16 tiers: the same sums by the gate-sum function of
// lstm_mma.cuh, from wt0 = layer 0's packed fragments (its input k steps).
// A block stages MMA_PRE_ROWS rows of x in shared memory; warp w holds the
// A fragments of TPW gate tiles in registers and runs them over the rows'
// n8 tiles, each sum from 0.f over the input steps in order, stored to
// pre [rows, 4H] in the natural gate order.
constexpr int MMA_PRE_ROWS = 64;

template <int H, int T>
__global__ void __launch_bounds__(PRE_THREADS)
input_gates_mma_kernel(const float* __restrict__ x, long long stride_b, int frames,
                       const float* __restrict__ wt0, float* __restrict__ pre, long long rows) {
  using namespace gate_mma;
  constexpr int M = Tier<T>::kProducts;
  constexpr int K = Geometry<H>::kInSteps;
  constexpr int LD = H + 8;
  constexpr int TPW = 128 / H;  // the warp's tiles: 8 fragments a warp at H = 64 and 128
  __shared__ float4 xs4[MMA_PRE_ROWS * LD / 4];
  float* xs = reinterpret_cast<float*>(xs4);
  const long long r0 = static_cast<long long>(blockIdx.x) * MMA_PRE_ROWS;
  const int warp = threadIdx.x >> 5;
  const int g = lane_id() >> 2;
  for (int i = threadIdx.x; i < MMA_PRE_ROWS * H; i += PRE_THREADS) {
    const long long r = r0 + i / H;
    float v = 0.f;
    if (r < rows) {
      const long long b = r / frames;
      v = x[b * stride_b + (r - b * frames) * H + i % H];
    }
    xs[(i / H) * LD + i % H] = v;
  }
  uint4 hi[TPW][K], lo[TPW][K];
#pragma unroll
  for (int k = 0; k < TPW; ++k) {
    const int m = (blockIdx.y * (PRE_THREADS / 32) + warp) * TPW + k;
#pragma unroll
    for (int s = 0; s < K; ++s) {
      hi[k][s] = frag_global<H>(wt0, 0, m, s);
      if constexpr (M == P_SPLIT) lo[k][s] = frag_global<H>(wt0, 1, m, s);
    }
  }
  __syncthreads();
  for (int n = 0; n < MMA_PRE_ROWS / 8; ++n) {
    uint32_t bh[K][2], bl[K][2];
#pragma unroll
    for (int s = 0; s < K; ++s) b_frag<M>(xs + (8 * n + g) * LD, 16 * s, bh[s], bl[s]);
#pragma unroll
    for (int k = 0; k < TPW; ++k) {
      const int m = (blockIdx.y * (PRE_THREADS / 32) + warp) * TPW + k;
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      gate_sum<M, K>(
          acc, [&](int s, int p) { return p == 0 ? hi[k][s] : lo[k][s]; },
          [&](int s, uint32_t(&h)[2], uint32_t(&l)[2]) {
            h[0] = bh[s][0], h[1] = bh[s][1], l[0] = bl[s][0], l[1] = bl[s][1];
          });
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const long long r = r0 + 8 * n + 2 * (lane_id() & 3) + (e & 1);
        if (r < rows) pre[r * 4 * H + gate_row<H>(m, g + 8 * (e >> 1))] = acc[e];
      }
    }
  }
}

template <int H, int T, bool MMA>
cudaError_t launch_input_gates(const float* x, long long stride_b, int frames, const float* wt0,
                               float* pre, long long rows, cudaStream_t stream) {
  if constexpr (!MMA) {
    const dim3 grid(static_cast<unsigned>((rows + PRE_ROWS - 1) / PRE_ROWS), 4 * H / PRE_THREADS);
    input_gates_kernel<H, T><<<grid, PRE_THREADS, 0, stream>>>(x, stride_b, frames, wt0, pre,
                                                               rows);
  } else {
    constexpr int tiles_a_block = (PRE_THREADS / 32) * (128 / H);
    const dim3 grid(static_cast<unsigned>((rows + MMA_PRE_ROWS - 1) / MMA_PRE_ROWS),
                    gate_mma::Geometry<H>::kTiles / tiles_a_block);
    input_gates_mma_kernel<H, T><<<grid, PRE_THREADS, 0, stream>>>(x, stride_b, frames, wt0, pre,
                                                                   rows);
  }
  return cudaGetLastError();
}

// acc[s] = fmaf(h_s[k], w_k, acc[s]) for k = 0..H-1 in order, h [NB][H] in
// shared memory read as float4 broadcasts, w(k) the thread's weight for k;
// products of mode M (tier.cuh).
template <int NB, int H, int M = P_FP32, class W>
__device__ __forceinline__ void gate_terms(const float* h, W w, float (&acc)[NB]) {
#pragma unroll
  for (int k = 0; k < H; k += 4) {
    const float w0 = w(k), w1 = w(k + 1), w2 = w(k + 2), w3 = w(k + 3);
#pragma unroll
    for (int s = 0; s < NB; ++s) {
      const float4 v = *reinterpret_cast<const float4*>(h + s * H + k);
      acc[s] = Operand<M>(v.x).fma(w0, acc[s]);
      acc[s] = Operand<M>(v.y).fma(w1, acc[s]);
      acc[s] = Operand<M>(v.z).fma(w2, acc[s]);
      acc[s] = Operand<M>(v.w).fma(w3, acc[s]);
    }
  }
}

// Streams a block takes: the fewest of 1, 2, 4 that leave no more blocks
// than the current device has SMs (4 beyond that).
inline cudaError_t streams_per_block(int batch, int* nb) {
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  *nb = batch <= sms ? 1 : (batch <= 2 * sms ? 2 : 4);
  return cudaSuccess;
}

// The pre-pass, then recurrent(f0, n, h0, c0) (the launch of a recurrent
// kernel on the pre of frames f0 .. f0 + n - 1, from the state h0, c0 into
// hn, cn), over the `frames` frames of each of `batch` streams, x [batch,
// frames, H]: in passes of as many frames as `pre` (pre_rows x 4H floats)
// holds, each a multiple of `unit` (the decoder's chunk), the state going
// through hn, cn from pass to pass. Adds one to *launched for every kernel
// it launched (two a pass). Returns the first CUDA error. T: the pre-pass's
// tier; MMA: whether its sums are lstm_mma.cuh's (the recurrent kernel's
// kMma).
template <int H, int T, bool MMA, class Recurrent>
int run_in_passes(const float* x, const float* h0, const float* c0, const float* wt, float* pre,
                  long long pre_rows, float* hn, float* cn, int batch, int frames, int unit,
                  Recurrent recurrent, int* launched, cudaStream_t stream) {
  const long long fit = pre_rows / batch / unit * unit;
  if (fit <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int per = static_cast<int>(fit < frames ? fit : frames);
  for (int f0 = 0; f0 < frames; f0 += per) {
    const int n = min(per, frames - f0);
    cudaError_t err = launch_input_gates<H, T, MMA>(x + static_cast<long long>(f0) * H,
                                            static_cast<long long>(frames) * H, n, wt, pre,
                                            static_cast<long long>(batch) * n, stream);
    if (err != cudaSuccess) return static_cast<int>(err);
    ++*launched;
    err = recurrent(f0, n, h0, c0);
    if (err != cudaSuccess) return static_cast<int>(err);
    ++*launched;
    h0 = hn;
    c0 = cn;
  }
  return 0;
}

// ---- H = 64, L = 2: one block, the two layers as a wavefront ---------------

constexpr int H2 = 64;
constexpr int G2 = 4 * H2;        // gate columns a layer
constexpr int THREADS2 = 2 * G2;  // one gate column of one layer each

// What is done with the top layer's h of frame f of stream b, unit u: store
// it (lstm_fused's y [batch, seq, 64], stride_b = seq * 64; tier T's
// products and tanh) ...
template <int T>
struct StoreY {
  static constexpr bool kDecoder = false;
  static constexpr int kTier = T;
  static constexpr bool kMma = T != TIER_FAITHFUL;  // gate sums of lstm_mma.cuh
  float* y;
  long long stride_b;
  __device__ void frame(int b, int f, int u, float h) const {
    y[b * stride_b + static_cast<long long>(f) * H2 + u] = h;
  }
};

// ... or add relu(h) to the v3 decoder's sum over the chunk's frames, which
// at the chunk's end gives probs[b, chunk] = sigmoid(mean . dec_w1 + dec_b1)
// (silero_v31_body.cuh's decode_probs at tier T: the same dec / T, the same
// chain over the 64 units).
template <int T>
struct DecoderSum {
  static constexpr bool kDecoder = true;
  static constexpr int kTier = T;
  static constexpr bool kMma = gate_mma::v31_gates_on_mma<T>();
  const float* dec_w1;  // [64], logit 1's row of dec_w
  const float* dec_b1;  // [1]
  float* probs;  // [batch, chunks], at the pass's first chunk
  int chunks;
  int frames;    // a chunk
  __device__ void decode(const float* mean, int b, int chunk) const {
    float acc = 0.f;
    for (int u = 0; u < H2; ++u) {
      acc = Operand<Tier<T>::kProducts>(mean[u]).fma(__ldg(dec_w1 + u), acc);
    }
    probs[static_cast<long long>(b) * chunks + chunk] = sigmoidf(acc + __ldg(dec_b1));
  }
};

template <int NB>
constexpr size_t wavefront2_smem_bytes() {
  return sizeof(float) * (H2 * G2 + NB * (2 * H2 + 2 * G2 + H2));
}

// pre [batch, frames, 256] (layer 0's input gate sums); h0, c0, hn, cn
// [2, batch, 64]; wt [2, 128, 256]; bias [2, 256]. A block takes NB streams
// through all `frames` frames; a stream past the batch starts from zeros,
// reads the last real stream's pre and is never stored.
template <int NB, class Top>
__global__ void __launch_bounds__(THREADS2, 1)
wavefront2_kernel(const float* __restrict__ pre, const float* h0, const float* c0,
                  const float* __restrict__ wt, const float* __restrict__ bias, float* hn,
                  float* cn, int batch, int frames, Top top) {
  constexpr int PAIRS = NB * H2;  // (stream, unit) pairs a layer
  static_assert(PAIRS <= G2, "a thread updates at most one pair");
  extern __shared__ float4 smem4[];
  float* w_in1 = reinterpret_cast<float*>(smem4);  // [64][256] layer 1's input weight
  float* hs = w_in1 + H2 * G2;                     // [2][NB][64]
  float* gates = hs + 2 * PAIRS;                   // [2][NB][256], activated
  float* mean = gates + 2 * NB * G2;               // [NB][64] a finished chunk's sum / T
  const int tid = threadIdx.x;
  const int layer = tid >> 8;
  const int col = tid & (G2 - 1);
  const int b0 = blockIdx.x * NB;

  {
    const float4* src = reinterpret_cast<const float4*>(wt + 2 * H2 * G2);
    float4* dst = reinterpret_cast<float4*>(w_in1);
    for (int i = tid; i < H2 * G2 / 4; i += THREADS2) dst[i] = __ldg(src + i);
  }
  float wreg[H2];  // this thread's column of its layer's W_hh
#pragma unroll
  for (int k = 0; k < H2; ++k) wreg[k] = __ldg(wt + (layer * 2 * H2 + H2 + k) * G2 + col);
  const float bj = __ldg(bias + layer * G2 + col);

  // this thread's pair of its layer: stream ps, unit pu; c and the decoder's
  // sum stay in its registers
  const int ps = col / H2;
  const int pu = col % H2;
  const bool has_pair = col < PAIRS;
  const bool stores = has_pair && b0 + ps < batch;
  const long long state_at = (static_cast<long long>(layer) * batch + b0 + ps) * H2 + pu;
  float c_reg = stores ? c0[state_at] : 0.f;
  float d_reg = 0.f;
  if (has_pair) hs[layer * PAIRS + col] = stores ? h0[state_at] : 0.f;
  const float* pre_s[NB];
  float cur[NB];
#pragma unroll
  for (int s = 0; s < NB; ++s) {
    pre_s[s] = pre + static_cast<long long>(min(b0 + s, batch - 1)) * frames * G2 + col;
    cur[s] = layer == 0 ? __ldg(pre_s[s]) : 0.f;
  }
  __syncthreads();

  int t_in_chunk = 0, chunk = 0, pending = -1;  // the decoder's: uniform over the block
  for (int i = 0; i <= frames; ++i) {
    if constexpr (Top::kDecoder) {
      if (pending >= 0) {
        if (tid < NB && b0 + tid < batch) top.decode(mean + tid * H2, b0 + tid, pending);
        pending = -1;
      }
    }
    float nxt[NB];
#pragma unroll
    for (int s = 0; s < NB; ++s) {
      nxt[s] = layer == 0 && i + 1 < frames
                   ? __ldg(pre_s[s] + static_cast<long long>(i + 1) * G2) : 0.f;
    }
    // layer 0 takes frame i, layer 1 frame i - 1
    const bool active = layer == 0 ? i < frames : i > 0;
    if (active) {
      float acc[NB];
      if (layer == 0) {
#pragma unroll
        for (int s = 0; s < NB; ++s) acc[s] = cur[s];
      } else {
#pragma unroll
        for (int s = 0; s < NB; ++s) acc[s] = 0.f;
        const float* w = w_in1 + col;
        gate_terms<NB, H2, Tier<Top::kTier>::kProducts>(hs, [w](int k) { return w[k * G2]; }, acc);
      }
      gate_terms<NB, H2, Tier<Top::kTier>::kProducts>(hs + layer * PAIRS,
                                                      [&wreg](int k) { return wreg[k]; }, acc);
      // the column's thread applies its gate's activation: all 256 at once,
      // not four in a row in the 64 threads a stream that update the cells
#pragma unroll
      for (int s = 0; s < NB; ++s) {
        gates[(layer * NB + s) * G2 + col] = gate_activation<Top::kTier>(col / H2, acc[s] + bj);
      }
    }
    __syncthreads();
    if (active && has_pair) {
      const float* g = gates + (layer * NB + ps) * G2 + pu;
      const float h_new = lstm_cell<Top::kTier>(g[0], g[H2], g[2 * H2], g[3 * H2], c_reg);
      hs[layer * PAIRS + col] = h_new;
      if (layer == 1) {
        if constexpr (Top::kDecoder) {
          d_reg += fmaxf(h_new, 0.f);
          if (t_in_chunk + 1 == top.frames) {
            mean[col] = d_reg / top.frames;
            d_reg = 0.f;
          }
        } else {
          if (stores) top.frame(b0 + ps, i - 1, pu, h_new);
        }
      }
    }
    if constexpr (Top::kDecoder) {
      if (i > 0 && ++t_in_chunk == top.frames) {
        t_in_chunk = 0;
        pending = chunk++;
      }
    }
    __syncthreads();
#pragma unroll
    for (int s = 0; s < NB; ++s) cur[s] = nxt[s];
  }
  if constexpr (Top::kDecoder) {
    if (pending >= 0 && tid < NB && b0 + tid < batch) {
      top.decode(mean + tid * H2, b0 + tid, pending);
    }
  }
  if (stores) {
    hn[state_at] = hs[layer * PAIRS + col];
    cn[state_at] = c_reg;
  }
}

template <int NB, class Top>
cudaError_t launch_wavefront2(const float* pre, const float* h0, const float* c0, const float* wt,
                              const float* bias, float* hn, float* cn, int batch, int frames,
                              Top top, cudaStream_t stream) {
  constexpr size_t bytes = wavefront2_smem_bytes<NB>();
  auto kernel = wavefront2_kernel<NB, Top>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  kernel<<<(batch + NB - 1) / NB, THREADS2, bytes, stream>>>(pre, h0, c0, wt, bias, hn, cn,
                                                             batch, frames, top);
  return cudaGetLastError();
}

// One stream a block (up to as many streams as SMs), ALL weights in
// registers: what bounds wavefront2_kernel there is the shared-memory pipe,
// 16 warps each reading W_ih1 and every h value as broadcasts, not the fmaf
// chain. Here 384 threads hold 128 weights each and the wavefront has three
// stages. Group A (threads 0-255, thread j) in iteration i continues layer
// 0's column j of frame i from pre with h0(i-1) . W_hh0, and starts layer
// 1's column j of frame i-1 with the same h0(i-1) . W_ih1 (a chain from 0.f,
// handed on through shared memory: fp32 there as in a register). Group B
// (threads 256-383, thread t) continues layer 1's columns t and t + 128 of
// frame i-2 from that sum with h1(i-3) . W_hh1, then the bias. So each
// thread runs two independent 64-term chains on one set of h broadcasts, no
// weight comes from shared memory, and F frames are F + 2 iterations. Every
// column's sum keeps its order (inputs, recurrent units, bias): the same
// bits.
constexpr int THREADS3 = G2 + G2 / 2;

template <class Top>
__global__ void __launch_bounds__(THREADS3, 1)
wavefront3_kernel(const float* __restrict__ pre, const float* h0, const float* c0,
                  const float* __restrict__ wt, const float* __restrict__ bias, float* hn,
                  float* cn, int batch, int frames, Top top) {
  __shared__ float4 hs4[2 * H2 / 4];
  __shared__ float gates[2 * G2];    // [2][256], activated
  __shared__ float partial[2 * G2];  // [2][256] layer 1's input sums, double-buffered
  __shared__ float mean[H2];         // a finished chunk's sum / T
  float* hs = reinterpret_cast<float*>(hs4);  // [2][64]
  const int tid = threadIdx.x;
  const bool group_a = tid < G2;
  const int layer = group_a ? 0 : 1;
  // the two columns of this thread's chains, in their layer's [128][256]
  const int col_a = group_a ? tid : tid - G2;
  const int col_b = group_a ? tid : tid - G2 + G2 / 2;
  const int b = blockIdx.x;

  // A: W_hh0[:, j] then W_ih1[:, j]; B: W_hh1[:, t] then W_hh1[:, t + 128]
  float w[2 * H2];
  {
    const float* wa = wt + (group_a ? H2 : 3 * H2) * G2 + col_a;
    const float* wb = wt + (group_a ? 2 * H2 : 3 * H2) * G2 + col_b;
#pragma unroll
    for (int k = 0; k < H2; ++k) {
      w[k] = __ldg(wa + k * G2);
      w[H2 + k] = __ldg(wb + k * G2);
    }
  }
  const float bias_a = __ldg(bias + layer * G2 + col_a);
  const float bias_b = __ldg(bias + layer * G2 + col_b);

  // the cells: threads 0-63 layer 0's units, 256-319 layer 1's
  const bool has_cell = col_a < H2;
  const long long state_at = (static_cast<long long>(layer) * batch + b) * H2 + col_a;
  float c_reg = has_cell ? c0[state_at] : 0.f;
  float d_reg = 0.f;
  if (has_cell) hs[layer * H2 + col_a] = h0[state_at];
  const float* pre_j = pre + static_cast<long long>(b) * frames * G2 + col_a;
  float cur = group_a ? __ldg(pre_j) : 0.f;
  __syncthreads();

  int t_in_chunk = 0, chunk = 0, pending = -1;  // the decoder's: uniform over the block
  for (int i = 0; i < frames + 2; ++i) {
    if constexpr (Top::kDecoder) {
      if (pending >= 0) {
        if (tid == 0) top.decode(mean, b, pending);
        pending = -1;
      }
    }
    const float nxt = group_a && i + 1 < frames
                          ? __ldg(pre_j + static_cast<long long>(i + 1) * G2) : 0.f;
    // layer 0 takes frame i, layer 1's input sums frame i - 1, its cells i - 2
    const bool cell_now = group_a ? i < frames : i >= 2;
    if (group_a ? i <= frames : i >= 2) {
      float acc[2];
      acc[0] = group_a ? cur : partial[((i - 1) & 1) * G2 + col_a];
      acc[1] = group_a ? 0.f : partial[((i - 1) & 1) * G2 + col_b];
      const float* h = hs + layer * H2;
#pragma unroll
      for (int k = 0; k < H2; k += 4) {
        using Op = Operand<Tier<Top::kTier>::kProducts>;
        const float4 v = *reinterpret_cast<const float4*>(h + k);
        const Op x(v.x), y(v.y), z(v.z), u(v.w);
        acc[0] = x.fma(w[k], acc[0]);
        acc[1] = x.fma(w[H2 + k], acc[1]);
        acc[0] = y.fma(w[k + 1], acc[0]);
        acc[1] = y.fma(w[H2 + k + 1], acc[1]);
        acc[0] = z.fma(w[k + 2], acc[0]);
        acc[1] = z.fma(w[H2 + k + 2], acc[1]);
        acc[0] = u.fma(w[k + 3], acc[0]);
        acc[1] = u.fma(w[H2 + k + 3], acc[1]);
      }
      if (group_a) {
        if (cell_now) gates[col_a] = gate_activation<Top::kTier>(col_a / H2, acc[0] + bias_a);
        partial[(i & 1) * G2 + col_a] = acc[1];
      } else {
        gates[G2 + col_a] = gate_activation<Top::kTier>(col_a / H2, acc[0] + bias_a);
        gates[G2 + col_b] = gate_activation<Top::kTier>(col_b / H2, acc[1] + bias_b);
      }
    }
    __syncthreads();
    if (cell_now && has_cell) {
      const float* g = gates + layer * G2 + col_a;
      const float h_new = lstm_cell<Top::kTier>(g[0], g[H2], g[2 * H2], g[3 * H2], c_reg);
      hs[layer * H2 + col_a] = h_new;
      if (!group_a) {
        if constexpr (Top::kDecoder) {
          d_reg += fmaxf(h_new, 0.f);
          if (t_in_chunk + 1 == top.frames) {
            mean[col_a] = d_reg / top.frames;
            d_reg = 0.f;
          }
        } else {
          top.frame(b, i - 2, col_a, h_new);
        }
      }
    }
    if constexpr (Top::kDecoder) {
      if (i >= 2 && ++t_in_chunk == top.frames) {
        t_in_chunk = 0;
        pending = chunk++;
      }
    }
    __syncthreads();
    cur = nxt;
  }
  if constexpr (Top::kDecoder) {
    if (pending >= 0 && tid == 0) top.decode(mean, b, pending);
  }
  if (has_cell) {
    hn[state_at] = hs[layer * H2 + col_a];
    cn[state_at] = c_reg;
  }
}

// ---- the bf16 tiers: the gate sums on the tensor cores (lstm_mma.cuh) -----
//
// The recurrent kernels of the tiers hold a block of nb <= 8 streams (one n8
// tile: the MMAs cost a block the same whatever nb, so the wrapper gives a
// block as many streams as leave no more blocks than SMs, 8 beyond that)
// in 16 warps. A step is two phases and two barriers. Sums: warp w runs
// gate tile w of its layer(s) and stores the sums of the real streams
// (lstm_mma.cuh: store_gates). Cells: one thread a (layer, stream, unit)
// applies the activations and updates the cell (lstm_mma.cuh:
// cell_from_gates), c and the decoder's running sum in its registers, new
// h to shared memory (fp32), rounded where the next step's sums read it.
// A warp updating the cells of its own tile would run the activations for
// all 8 columns of the n8 tile, 7 of 8 of them padding at one stream a
// block; this way a block runs them for its real streams only. A warp's
// bf16 hi fragments stay in its registers for the launch; at balanced the
// lo fragments lie in shared memory, read once a step by each warp as one
// 16-byte load a lane (bank-conflict free), since hi and lo together would
// not leave the registers a step needs.
constexpr int MMA_WARPS = 16;
constexpr int MMA_THREADS = 32 * MMA_WARPS;
constexpr int MMA_LD2 = H2 + 8;  // a stream's row of h: b_frag's float2 reads on distinct banks

// A warp's A fragments over N k steps: hi in registers, lo in shared memory.
template <int N>
struct RegFrags {
  uint4 hi[N];
  const uint4* lo;  // [N][32 lanes], this warp's
  __device__ __forceinline__ uint4 operator()(int s, int p) const {
    return p == 0 ? hi[s] : lo[s * 32 + gate_mma::lane_id()];
  }
};

// Loads fragment j (k step ks of tile m of a packed layer) of a warp: hi
// into its registers, lo (bf16_3x) into its shared memory.
template <int H, int M, int N>
__device__ __forceinline__ void load_frag(RegFrags<N>& f, uint4* lo, int j, const float* layer,
                                          int m, int ks) {
  f.hi[j] = gate_mma::frag_global<H>(layer, 0, m, ks);
  if constexpr (M == P_SPLIT) lo[j * 32 + gate_mma::lane_id()] = gate_mma::frag_global<H>(layer, 1, m, ks);
}

// at bf16_3x the lo fragments of the K k steps of each warp's tiles
template <int M, int K>
constexpr size_t mma_dynamic_smem_bytes() {
  return M == P_SPLIT ? sizeof(uint4) * MMA_WARPS * K * 32 : 0;
}

// This lane's four input sums of gate tile m (rows g and g + 8, streams 2t
// and 2t + 1 of the block's nb from b0) in pre [batch][frames][4H], the
// natural gate order: their frame-0 offsets, zeros where there is none,
// and each frame's read one step ahead of its use.
template <int H>
struct PreSums {
  const float* pre;
  long long at[4];
  bool ok[4];
  int frames;

  __device__ __forceinline__ PreSums(const float* pre_, int m, int b0, int nb, int batch,
                                     int frames_)
      : pre(pre_), frames(frames_) {
    const int g = gate_mma::lane_id() >> 2;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int s = 2 * (gate_mma::lane_id() & 3) + (e & 1);
      ok[e] = s < nb && b0 + s < batch;
      at[e] = static_cast<long long>(ok[e] ? b0 + s : 0) * frames * (4 * H) +
              gate_mma::gate_row<H>(m, g + 8 * (e >> 1));
    }
  }
  __device__ __forceinline__ void read(int f, float (&v)[4]) const {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      v[e] = ok[e] && f < frames ? __ldg(pre + at[e] + static_cast<long long>(f) * (4 * H)) : 0.f;
    }
  }
};

// pre [batch, frames, 256] (layer 0's input gate sums, natural gate order);
// h0, c0, hn, cn [2, batch, 64]; wt the two layers' packed fragments; bias
// [2, 256]. Warp w: tile w of both layers. Iteration i runs layer 0's frame
// i from h0(i - 1) and layer 1's frame i - 1 from the same h0(i - 1) and
// h1(i - 2): F frames are F + 1 iterations. Layer 1's sum: 0.f, its input
// steps, its recurrent steps, the bias, as every site sums it. Thread k
// updates cells k and k + 512 of the block's 2 x nb x 64 (layer, stream,
// unit).
template <class Top>
__global__ void __launch_bounds__(MMA_THREADS, 1)
wavefront_mma_kernel(const float* __restrict__ pre, const float* h0, const float* c0,
                     const float* __restrict__ wt, const float* __restrict__ bias, float* hn,
                     float* cn, int batch, int frames, int nb, Top top) {
  using namespace gate_mma;
  using Geo = Geometry<H2>;
  constexpr int T = Top::kTier;
  constexpr int M = Tier<T>::kProducts;
  constexpr int K = Geo::kInSteps;
  constexpr int ROWS = kMaxStreams * MMA_LD2;
  constexpr int GLD = kGatesLd<H2>;
  __shared__ float4 hbuf4[2 * ROWS / 4];                // [layer][8][LD] h
  __shared__ float4 gates4[2 * kMaxStreams * GLD / 4];  // [layer][8][GLD] the step's sums
  __shared__ float mean[2][kMaxStreams * H2];           // a finished chunk's sum / T, by its parity
  extern __shared__ uint4 lo_smem[];                    // [warp][3K][32] at balanced
  float* hbuf = reinterpret_cast<float*>(hbuf4);
  float* gates = reinterpret_cast<float*>(gates4);
  const int tid = threadIdx.x;
  const int m = tid >> 5;
  const int g = lane_id() >> 2;
  const int b0 = blockIdx.x * nb;

  // fragments j: 0..K-1 layer 0's recurrent steps, K..2K-1 layer 1's input
  // steps, 2K..3K-1 its recurrent steps
  RegFrags<3 * K> f;
  uint4* lo = lo_smem + m * 3 * K * 32;
  f.lo = lo;
  const float* w1 = wt + planes<M>() * Geo::kPlaneWords;
#pragma unroll
  for (int j = 0; j < 3 * K; ++j) {
    load_frag<H2, M>(f, lo, j, j < K ? wt : w1, m, j < K ? K + j : j - K);
  }
  const TileBias bias0 = tile_bias<H2>(bias, m), bias1 = tile_bias<H2>(bias + G2, m);
  for (int i = tid; i < 2 * ROWS; i += MMA_THREADS) hbuf[i] = 0.f;
  __syncthreads();
  // this thread's cells: (layer, stream, unit) of k = tid, tid + 512, of
  // which at most one is layer 1's (the decoder's running sum d_reg); h
  // stays in hbuf, c in c_reg
  const int cells = 2 * nb * H2;
  float c_reg[2], d_reg = 0.f;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int k = tid + j * MMA_THREADS;
    const int l = k / (nb * H2), s = (k / H2) % nb, u = k % H2;
    const bool real = k < cells && b0 + s < batch;
    const long long at = (static_cast<long long>(l) * batch + b0 + s) * H2 + u;
    c_reg[j] = real ? c0[at] : 0.f;
    if (k < cells) hbuf[l * ROWS + s * MMA_LD2 + u] = real ? h0[at] : 0.f;
  }
  // this lane's four input sums of layer 0
  const PreSums<H2> sums(pre, m, b0, nb, batch, frames);
  float cur[4];
  sums.read(0, cur);
  __syncthreads();

  int t_in_chunk = 0, chunk = 0, pending = -1;  // the decoder's: uniform over the block
  for (int i = 0; i <= frames; ++i) {
    if constexpr (Top::kDecoder) {
      if (pending >= 0) {
        if (tid < nb && b0 + tid < batch) top.decode(mean[pending & 1] + tid * H2, b0 + tid, pending);
        pending = -1;
      }
    }
    float nxt[4];
    sums.read(i + 1, nxt);
    // the sums: h0(i - 1) feeds layer 0's recurrent half and layer 1's
    // input half, h1(i - 2) layer 1's recurrent half; a layer with no frame
    // in this iteration (layer 0 at i = frames, layer 1 at i = 0) sums what
    // its cells will not use
    {
      uint32_t bh[K][2], bl[K][2];
#pragma unroll
      for (int s = 0; s < K; ++s) b_frag<M>(hbuf + g * MMA_LD2, 16 * s, bh[s], bl[s]);
      auto b0v = [&](int s, uint32_t(&h)[2], uint32_t(&l)[2]) {
        h[0] = bh[s][0], h[1] = bh[s][1], l[0] = bl[s][0], l[1] = bl[s][1];
      };
      const float* h1v = hbuf + ROWS + g * MMA_LD2;
      float acc0[4] = {cur[0], cur[1], cur[2], cur[3]};
      float acc1[4] = {0.f, 0.f, 0.f, 0.f};
      gate_sum<M, K>(acc0, [&](int s, int p) { return f(s, p); }, b0v);
      gate_sum<M, K>(acc1, [&](int s, int p) { return f(K + s, p); }, b0v);
      gate_sum<M, K>(acc1, [&](int s, int p) { return f(2 * K + s, p); },
                     [&](int s, uint32_t(&h)[2], uint32_t(&l)[2]) { b_frag<M>(h1v, 16 * s, h, l); });
      add_bias(acc0, bias0);
      add_bias(acc1, bias1);
      store_gates<H2>(acc0, gates, GLD, m, nb);
      store_gates<H2>(acc1, gates + kMaxStreams * GLD, GLD, m, nb);
    }
    __syncthreads();
    // the cells
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int k = tid + j * MMA_THREADS;
      const int l = k / (nb * H2), s = (k / H2) % nb, u = k % H2;
      if (k < cells && (l == 0 ? i < frames : i > 0)) {
        const float h = cell_from_gates<T, H2>(gates + (l * kMaxStreams + s) * GLD, u, c_reg[j]);
        hbuf[l * ROWS + s * MMA_LD2 + u] = h;
        if (l == 1) {
          if constexpr (Top::kDecoder) {
            d_reg += fmaxf(h, 0.f);
            if (t_in_chunk + 1 == top.frames) {
              mean[chunk & 1][s * H2 + u] = d_reg / top.frames;
              d_reg = 0.f;
            }
          } else {
            if (b0 + s < batch) top.frame(b0 + s, i - 1, u, h);
          }
        }
      }
    }
    if constexpr (Top::kDecoder) {
      if (i > 0 && ++t_in_chunk == top.frames) {
        t_in_chunk = 0;
        pending = chunk++;
      }
    }
    __syncthreads();
#pragma unroll
    for (int e = 0; e < 4; ++e) cur[e] = nxt[e];
  }
  if constexpr (Top::kDecoder) {
    if (pending >= 0 && tid < nb && b0 + tid < batch) {
      top.decode(mean[pending & 1] + tid * H2, b0 + tid, pending);
    }
  }
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int k = tid + j * MMA_THREADS;
    const int l = k / (nb * H2), s = (k / H2) % nb, u = k % H2;
    if (k < cells && b0 + s < batch) {
      const long long at = (static_cast<long long>(l) * batch + b0 + s) * H2 + u;
      hn[at] = hbuf[l * ROWS + s * MMA_LD2 + u];
      cn[at] = c_reg[j];
    }
  }
}

// One launch of the H=64, L=2 recurrent kernel over pre [batch, frames, 256]:
// where the Top's gates run on the tensor cores, wavefront_mma_kernel at nb
// streams a block; else (faithful, and the v3.1 LSTM at turbo; nb ignored)
// wavefront3_kernel at one stream a block, else wavefront2_kernel at 2 or 4.
template <class Top>
cudaError_t launch_wavefront(const float* pre, const float* h0, const float* c0, const float* wt,
                             const float* bias, float* hn, float* cn, int batch, int frames,
                             int streams, Top top, cudaStream_t stream) {
  if constexpr (Top::kMma) {
    constexpr size_t bytes = mma_dynamic_smem_bytes<Tier<Top::kTier>::kProducts,
                                                    3 * gate_mma::Geometry<H2>::kInSteps>();
    if (streams < 1 || streams > gate_mma::kMaxStreams) return cudaErrorInvalidValue;
    auto kernel = wavefront_mma_kernel<Top>;
    if (bytes > 0) {
      const cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
      if (err != cudaSuccess) return err;
    }
    kernel<<<(batch + streams - 1) / streams, MMA_THREADS, bytes, stream>>>(
        pre, h0, c0, wt, bias, hn, cn, batch, frames, streams, top);
    return cudaGetLastError();
  } else {
    int nb = 0;
    const cudaError_t err = streams_per_block(batch, &nb);
    if (err != cudaSuccess) return err;
    if (nb == 1) {
      wavefront3_kernel<<<batch, THREADS3, 0, stream>>>(pre, h0, c0, wt, bias, hn, cn, batch,
                                                        frames, top);
      return cudaGetLastError();
    }
    if (nb == 2) {
      return launch_wavefront2<2>(pre, h0, c0, wt, bias, hn, cn, batch, frames, top, stream);
    }
    return launch_wavefront2<4>(pre, h0, c0, wt, bias, hn, cn, batch, frames, top, stream);
  }
}

// ---- H = 128, L = 1: a cluster of two blocks, half of the units each -------

constexpr int H1 = 128;
constexpr int G1 = 4 * H1;
constexpr int HALF = H1 / 2;        // units a block of the cluster owns
constexpr int THREADS1 = 4 * HALF;  // one gate column each

// pre [batch, frames, 512]; h0, c0, hn, cn [1, batch, 128]; wt [1, 256, 512];
// bias [1, 512]; y [batch, seq, 128] at the pass's first frame, y_stride_b =
// seq * 128. Block `rank` of a cluster owns units rank * 64 .. + 63: thread
// (gate, uu) their column gate * 128 + rank * 64 + uu. Both blocks hold all
// of h (double-buffered: a block writes the next step's h into its peer
// while the peer may still read this step's). Tier T's products and tanh.
template <int NB, int T>
__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(THREADS1, 1)
cluster1_kernel(const float* __restrict__ pre, const float* h0, const float* c0,
                const float* __restrict__ wt, const float* __restrict__ bias,
                float* __restrict__ y, long long y_stride_b, float* hn, float* cn, int batch,
                int frames) {
  constexpr int PAIRS = NB * HALF;  // (stream, unit) pairs of this block, <= THREADS1
  static_assert(PAIRS <= THREADS1, "a thread updates at most one pair");
  __shared__ float4 hs4[2 * NB * H1 / 4];
  __shared__ float gates[NB * THREADS1];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  float* hs = reinterpret_cast<float*>(hs4);  // [2][NB][128]
  float* peer = cluster.map_shared_rank(hs, rank ^ 1);
  const int tid = threadIdx.x;
  const int col = (tid / HALF) * H1 + rank * HALF + tid % HALF;
  const int b0 = (blockIdx.x / 2) * NB;

  float wreg[H1];
#pragma unroll
  for (int k = 0; k < H1; ++k) wreg[k] = __ldg(wt + static_cast<long long>(H1 + k) * G1 + col);
  const float bj = __ldg(bias + col);
  for (int i = tid; i < NB * H1; i += THREADS1) {
    const int s = i / H1;
    hs[i] = b0 + s < batch ? h0[static_cast<long long>(b0 + s) * H1 + i % H1] : 0.f;
  }
  // this thread's pair: stream ps, unit pu
  const int ps = tid / HALF;
  const int pu = rank * HALF + tid % HALF;
  const bool has_pair = tid < PAIRS;
  const bool stores = has_pair && b0 + ps < batch;
  float c_reg = stores ? c0[static_cast<long long>(b0 + ps) * H1 + pu] : 0.f;
  const float* pre_s[NB];
  float cur[NB];
#pragma unroll
  for (int s = 0; s < NB; ++s) {
    pre_s[s] = pre + static_cast<long long>(min(b0 + s, batch - 1)) * frames * G1 + col;
    cur[s] = __ldg(pre_s[s]);
  }
  // both blocks run and hold their state before either writes into the other
  cluster.sync();

  int buf = 0;
  for (int t = 0; t < frames; ++t) {
    float nxt[NB];
#pragma unroll
    for (int s = 0; s < NB; ++s) {
      nxt[s] = t + 1 < frames ? __ldg(pre_s[s] + static_cast<long long>(t + 1) * G1) : 0.f;
    }
    float acc[NB];
#pragma unroll
    for (int s = 0; s < NB; ++s) acc[s] = cur[s];
    gate_terms<NB, H1, Tier<T>::kProducts>(hs + buf * NB * H1, [&wreg](int k) { return wreg[k]; },
                                           acc);
#pragma unroll
    for (int s = 0; s < NB; ++s) {
      gates[s * THREADS1 + tid] = gate_activation<T>(tid / HALF, acc[s] + bj);
    }
    __syncthreads();
    if (has_pair) {
      const float* g = gates + ps * THREADS1 + tid % HALF;
      const float h_new = lstm_cell<T>(g[0], g[HALF], g[2 * HALF], g[3 * HALF], c_reg);
      const int at = (buf ^ 1) * NB * H1 + ps * H1 + pu;
      hs[at] = h_new;
      peer[at] = h_new;
      if (stores) y[(b0 + ps) * y_stride_b + static_cast<long long>(t) * H1 + pu] = h_new;
    }
    cluster.sync();
    buf ^= 1;
#pragma unroll
    for (int s = 0; s < NB; ++s) cur[s] = nxt[s];
  }
  if (stores) {
    const long long g = static_cast<long long>(b0 + ps) * H1 + pu;
    hn[g] = hs[buf * NB * H1 + ps * H1 + pu];
    cn[g] = c_reg;
  }
}

// The same at the bf16 tiers: a cluster of two blocks of 16 warps, warp w
// of block `rank` running gate tile 16 rank + w (units 64 rank + 4w .. + 3)
// with its recurrent fragments (hi in registers, lo in shared memory at
// balanced); a cluster takes nb <= 8 streams. Thread k < 64 nb of a block
// updates its block's unit k % 64 of stream k / 64 and writes the new h
// into both blocks' shared memory, a cluster barrier ending the step.
constexpr int MMA_LD1 = H1 + 8;

template <int T>
__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(MMA_THREADS, 1)
cluster_mma_kernel(const float* __restrict__ pre, const float* h0, const float* c0,
                   const float* __restrict__ wt, const float* __restrict__ bias,
                   float* __restrict__ y, long long y_stride_b, float* hn, float* cn, int batch,
                   int frames, int nb) {
  using namespace gate_mma;
  constexpr int M = Tier<T>::kProducts;
  constexpr int K = Geometry<H1>::kInSteps;
  constexpr int ROWS = kMaxStreams * MMA_LD1;
  constexpr int GLD = kGatesLd<H1>;
  __shared__ float4 hbuf4[2 * ROWS / 4];             // [buf][8][LD] h, all 128 units
  __shared__ float4 gates4[kMaxStreams * GLD / 4];   // [8][GLD] the step's sums (this block's units)
  extern __shared__ uint4 lo_smem[];                 // [warp][K][32] at balanced
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  float* hbuf = reinterpret_cast<float*>(hbuf4);
  float* gates = reinterpret_cast<float*>(gates4);
  float* peer = cluster.map_shared_rank(hbuf, rank ^ 1);
  const int tid = threadIdx.x;
  const int m = (MMA_THREADS / 32) * rank + (tid >> 5);
  const int g = lane_id() >> 2;
  const int b0 = (blockIdx.x / 2) * nb;
  // this thread's cell: stream cs, unit cu (of this block's 64)
  const int cs = tid / HALF;
  const int cu = rank * HALF + tid % HALF;
  const bool has_cell = cs < nb;
  const bool real = has_cell && b0 + cs < batch;

  RegFrags<K> f;
  uint4* lo = lo_smem + (tid >> 5) * K * 32;
  f.lo = lo;
#pragma unroll
  for (int j = 0; j < K; ++j) load_frag<H1, M>(f, lo, j, wt, m, K + j);
  const TileBias tb = tile_bias<H1>(bias, m);
  for (int i = tid; i < 2 * ROWS; i += MMA_THREADS) {
    const int s = (i / MMA_LD1) % kMaxStreams;
    const int k = i % MMA_LD1;
    hbuf[i] = i < ROWS && k < H1 && s < nb && b0 + s < batch
                  ? h0[static_cast<long long>(b0 + s) * H1 + k] : 0.f;
  }
  float c_reg = real ? c0[static_cast<long long>(b0 + cs) * H1 + cu] : 0.f;
  float h_last = real ? h0[static_cast<long long>(b0 + cs) * H1 + cu] : 0.f;
  const PreSums<H1> sums(pre, m, b0, nb, batch, frames);
  float cur[4];
  sums.read(0, cur);
  // both blocks run and hold their state before either writes into the other
  cluster.sync();

  for (int t = 0; t < frames; ++t) {
    float nxt[4];
    sums.read(t + 1, nxt);
    const int buf = t & 1;
    const float* hv = hbuf + buf * ROWS + g * MMA_LD1;
    float acc[4] = {cur[0], cur[1], cur[2], cur[3]};
    gate_sum<M, K>(acc, [&](int s, int p) { return f(s, p); },
                   [&](int s, uint32_t(&h)[2], uint32_t(&l)[2]) { b_frag<M>(hv, 16 * s, h, l); });
    add_bias(acc, tb);
    store_gates<H1>(acc, gates, GLD, m, nb);
    __syncthreads();
    if (has_cell) {
      h_last = cell_from_gates<T, H1>(gates + cs * GLD, cu, c_reg);
      const int at = (buf ^ 1) * ROWS + cs * MMA_LD1 + cu;
      hbuf[at] = h_last;
      peer[at] = h_last;
      if (real) y[(b0 + cs) * y_stride_b + static_cast<long long>(t) * H1 + cu] = h_last;
    }
    cluster.sync();
#pragma unroll
    for (int e = 0; e < 4; ++e) cur[e] = nxt[e];
  }
  if (real) {
    hn[static_cast<long long>(b0 + cs) * H1 + cu] = h_last;
    cn[static_cast<long long>(b0 + cs) * H1 + cu] = c_reg;
  }
}

template <int T>
cudaError_t launch_cluster_mma(const float* pre, const float* h0, const float* c0,
                               const float* wt, const float* bias, float* y, long long y_stride_b,
                               float* hn, float* cn, int batch, int frames, int streams,
                               cudaStream_t stream) {
  constexpr size_t bytes =
      mma_dynamic_smem_bytes<Tier<T>::kProducts, gate_mma::Geometry<H1>::kInSteps>();
  if (streams < 1 || streams > gate_mma::kMaxStreams) return cudaErrorInvalidValue;
  auto kernel = cluster_mma_kernel<T>;
  if (bytes > 0) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (err != cudaSuccess) return err;
  }
  const int clusters = (batch + streams - 1) / streams;
  kernel<<<2 * clusters, MMA_THREADS, bytes, stream>>>(pre, h0, c0, wt, bias, y, y_stride_b, hn,
                                                       cn, batch, frames, streams);
  return cudaGetLastError();
}

template <int NB, int T>
cudaError_t launch_cluster1(const float* pre, const float* h0, const float* c0, const float* wt,
                            const float* bias, float* y, long long y_stride_b, float* hn,
                            float* cn, int batch, int frames, cudaStream_t stream) {
  const int clusters = (batch + NB - 1) / NB;
  cluster1_kernel<NB, T><<<2 * clusters, THREADS1, 0, stream>>>(pre, h0, c0, wt, bias, y,
                                                               y_stride_b, hn, cn, batch, frames);
  return cudaGetLastError();
}

}  // namespace resident
}  // namespace
