// The resident-weights variant of the two recurrent kernels, for chains of
// three steps and more (kernels/lstm.py holds the measured crossover).
// lstm.cu (replaces the Pallas kernel vadc_tpu/kernels/lstm.py: lstm_fused)
// and lstm_decoder.cu (replaces vadc_tpu/kernels/lstm.py:
// lstm_decoder_fused) launch it; their headers describe the functions. It
// gives the bits of the streaming-weights variant (lstm.cu's lstm_kernel,
// silero_v31_body.cuh's lstm_decoder_steps).
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
// takes it as a template parameter): each x and h value is an operand of
// the tier's products where it is read, against weights the wrapper packed
// for the tier, in the same chains, with the tier's tanh, exactly as
// silero_v31_body.cuh's step LSTM does, so a slab still equals the loop of
// steps bit for bit. lstm.cu's instances take the tier the same way
// (StoreY<T>, cluster1_kernel<NB, T>), the v4/v5 models' F.lstm at the
// tier, and give the bits of lstm.cu's streaming variant at every tier.
//
// The scratch `pre` is the wrapper's (rows x 4H fp32); when it holds fewer
// rows than the call has, the launchers below walk the frames in passes,
// the state going through hn/cn between them (fp32 there as in the block, so
// the bits do not change).
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "lstm_cell.cuh"

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

template <int H, int T>
cudaError_t launch_input_gates(const float* x, long long stride_b, int frames, const float* wt0,
                               float* pre, long long rows, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((rows + PRE_ROWS - 1) / PRE_ROWS), 4 * H / PRE_THREADS);
  input_gates_kernel<H, T><<<grid, PRE_THREADS, 0, stream>>>(x, stride_b, frames, wt0, pre, rows);
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
// tier.
template <int H, int T = TIER_FAITHFUL, class Recurrent>
int run_in_passes(const float* x, const float* h0, const float* c0, const float* wt, float* pre,
                  long long pre_rows, float* hn, float* cn, int batch, int frames, int unit,
                  Recurrent recurrent, int* launched, cudaStream_t stream) {
  const long long fit = pre_rows / batch / unit * unit;
  if (fit <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int per = static_cast<int>(fit < frames ? fit : frames);
  for (int f0 = 0; f0 < frames; f0 += per) {
    const int n = min(per, frames - f0);
    cudaError_t err = launch_input_gates<H, T>(x + static_cast<long long>(f0) * H,
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

// One launch of the H=64, L=2 recurrent kernel over pre [batch, frames, 256]:
// wavefront3_kernel at one stream a block, else wavefront2_kernel at 2 or 4.
template <class Top>
cudaError_t launch_wavefront(const float* pre, const float* h0, const float* c0, const float* wt,
                             const float* bias, float* hn, float* cn, int batch, int frames,
                             Top top, cudaStream_t stream) {
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
