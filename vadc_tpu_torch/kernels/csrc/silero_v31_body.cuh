// The Silero v3.1 model after its front-end, as device code shared by three
// sources: silero_v31_fused.cu (normalized features in; and its encoder-only
// entry), silero_v31_fused_audio.cu (raw audio in, the spectrum and the
// adaptive normalization computed in the same block first; and its
// encoder-only entry) and lstm_decoder.cu (the encoder's output in: the LSTM
// and the decoder alone, over several chunks of a stream in order). All run
// this one code for the encoder, the LSTM and the decoder, so on the same
// input they give the same bits.
//
// Per stage (widths 129->16->32->32->64, frames 25->13->7->7->7):
//   residual = proj(x) (identity on stage 3); x = relu(dwconv5(x)) in place;
//   h = relu(pw(x) + residual); h += out_proj(attention(h)); h = LN1(h);
//   h = LN2(h + lin2(relu(lin1(h)))); y = relu(bn(conv1x1(h[::stride]))).
// Attention keeps Silero's order: scores = k.q^T / sqrt(hd), softmax over
// the q axis. Then the LSTM runs over the last stage's frames with the
// decoder folded into a running sum of relu(h_top): prob = sigmoid(mean_t
// relu(h_top) . dec_w[1] + dec_b[1]).
//
// A block takes NB = 4 streams with 256 threads and walks every stage and
// every LSTM step for them with all activations in shared memory.
//
// What bounds it on an H100, and what the design does about it. Not the
// card's arithmetic: 4.2 M multiply-adds a block, against a block's life of
// hundreds of microseconds even when it has an SM to itself (measured by
// chip_profile.py's phase split). The time is latency: dependent loads,
// index arithmetic and some sixty barrier-separated phases of a few hundred
// items each. The first design read every weight with __ldg inside the k
// loop of each product (one round trip to L2 per few multiply-adds, five
// load instructions for four FMAs), its LSTM streamed 128 KB of gate
// weights from L2 for each of its 14 layer-steps, and its phases spent as
// much on `/` and `%` by run-time frame counts and on a table of offsets
// copied to local memory as on their arithmetic. So:
//   - the weights of each product (124,632 floats in all, packed once by the
//     wrapper into one buffer with an offset table, every matrix 16-byte
//     aligned) come through shared memory: cp.async copies the next
//     product's matrix into one of two 16 KB buffers as soon as that buffer
//     is free, a phase or more ahead; a product waits only at the barrier it
//     had anyway;
//   - a product is register-tiled: a thread takes R rows x 4 columns, reads
//     its weights as one float4 from shared memory and each activation once
//     for four FMAs (R = 4, 2 or 1, the largest that still gives half the
//     block's threads a tile: stage 1 has only 16 columns, stage 4 only 28
//     rows); its row pointers are worked out once, before the k loop;
//   - indices are split with FastDiv (one multiply-high), the offset table
//     and the normalization weights are __grid_constant__ parameters read
//     in place, the layer norm holds its row in registers, and the
//     full-precision divisions of the softmax and the decoder are spread
//     over the block instead of queued in one thread per row;
//   - the LSTM keeps layer 0's recurrent weights in registers (thread j owns
//     gate column j: 64 floats), computes layer 0's input half for all the
//     chunk's frames in one pass before the recurrence (64 more weights in
//     the same registers, each serving 28 rows), reads h as float4, and
//     streams only layer 1's 128 KB a frame from L2, sixteen loads in flight
//     a thread.
// Every sum keeps its order (one fmaf chain from 0.f in k order, then the
// bias; the norms and the softmax add in the order they did), so the bits
// are those of the first design. Every function that computes takes the
// precision tier T as a template parameter (tier.cuh): the faithful
// instance is the code it was (fp32 products on the CUDA cores, accurate
// tanh, the exp form of vadc_tpu/nn/functional.py accurate_tanh, sigmoid as
// 1/(1+expf(-x)), 1/sqrtf for the norms, no --use_fast_math and no TF32);
// the bf16 tiers round or split each product's activation where it is read,
// against weights the wrapper packed for the tier, in the same fmaf chains
// on the CUDA cores, and turbo rounds the encoder's activations where they
// are stored. The tensor cores are later work, where the tier itself moves
// the bound (67 TFLOP/s fp32 here). Tried on the card and not kept (chip_ab.py, PERF.md):
// the phase functions as __noinline__ (13 % slower), a software-pipelined k
// loop, float4 sample loads in the spectrum, 48 rows of layer 1's weight
// resident in shared memory (each within 2 % either way).
#pragma once

#include <cuda_runtime.h>

#include "lstm_cell.cuh"  // sigmoidf, accurate_tanhf, tanh_at, lstm_cell
#include "tier.cuh"

namespace {

// Phase stamps for chip_profile.py's split of the step kernel. They exist
// only in a library compiled with -DVADC_PHASE_PROBE (chip_profile.py
// builds that one beside the package's); without the define PHASE_STAMP
// expands to nothing, so the library the package loads carries no stamp and
// no branch for one. Thread 0 of each of the first PROBE_BLOCKS blocks
// writes (phase id, clock64()) after the barrier that ends a phase, and the
// global nanosecond timer at its first and last stamp.
enum Phase : int {
  PH_START, PH_SPECTRUM, PH_LOG1P, PH_NORM, PH_PROJ, PH_DW, PH_PW, PH_QKV, PH_SCORES,
  PH_SOFTMAX, PH_MIX, PH_OUT_PROJ, PH_LN1, PH_LIN1, PH_LIN2, PH_LN2, PH_CONV, PH_LSTM_PRE,
  PH_LSTM, PH_END
};
#ifdef VADC_PHASE_PROBE
constexpr int PROBE_BLOCKS = 512;
constexpr int PROBE_SLOTS = 96;
__device__ long long probe_clock[PROBE_BLOCKS][PROBE_SLOTS];
__device__ int probe_id[PROBE_BLOCKS][PROBE_SLOTS];
__device__ int probe_count[PROBE_BLOCKS];
__device__ unsigned long long probe_ns[PROBE_BLOCKS][2];
__device__ __forceinline__ void phase_stamp(int id) {
  __shared__ int cursor;
  if (threadIdx.x != 0 || blockIdx.x >= PROBE_BLOCKS) return;
  if (id == PH_START) cursor = 0;
  if (id == PH_START || id == PH_END) {
    unsigned long long ns;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns));
    probe_ns[blockIdx.x][id == PH_END] = ns;
  }
  if (cursor < PROBE_SLOTS) {
    probe_clock[blockIdx.x][cursor] = clock64();
    probe_id[blockIdx.x][cursor] = id;
    probe_count[blockIdx.x] = ++cursor;
  }
}
#define PHASE_STAMP(id) phase_stamp(id)
#else
#define PHASE_STAMP(id)
#endif

constexpr int N_STAGES = 4;
constexpr int N_FEAT = 129;
constexpr int HIDDEN = 64;
constexpr int GATES = 4 * HIDDEN;  // 256: one gate column per thread
constexpr int THREADS = 256;
// Streams per block. 4 gives 512 blocks at batch 2048: two blocks an SM
// (about 100 KB of shared memory each, up to 128 registers a thread), 264
// at a time, so two nearly full waves. 8 a block measured slower on an H100
// with the first design (1.14 vs 0.88 ms at batch 2048).
constexpr int NB = 4;
constexpr int BLOCKS_PER_SM = 2;
// One of the two shared-memory buffers a product's weights are staged in:
// the largest matrix staged at once (64 x 64; stage 4's 64 x 192 qkv goes
// through as three column blocks).
constexpr int WBUF = 64 * 64;
// Row pitch of the last stage's output, the LSTM's input: a multiple of 4,
// so that the LSTM reads it as float4.
constexpr int ENC_LD = HIDDEN + 4;
constexpr int MIN_SEQ0 = 9;
constexpr int MAX_SEQ0 = 25;
constexpr float LN_EPS = 1e-5f;

__host__ __device__ constexpr int c_in(int st) {
  return st == 0 ? N_FEAT : (st == 1 ? 16 : 32);
}
__host__ __device__ constexpr int c_out(int st) {
  return st == 0 ? 16 : (st == 1 ? 32 : (st == 2 ? 32 : 64));
}
__host__ __device__ constexpr int stride_of(int st) { return st < 2 ? 2 : 1; }
// odd row pitch in shared memory: rows of one column fall in distinct banks
__host__ __device__ constexpr int pitch(int c) { return c | 1; }

// Division of a small index by a divisor known only at run time (a frame
// count, a width): one multiply-high where the compiler's sequence for `/`
// takes some twenty instructions, which weighed as much as the arithmetic
// in phases of a few hundred items. Exact for 0 <= n < 2^32 / d.
struct FastDiv {
  unsigned m;
  int d;
  __device__ explicit FastDiv(int divisor) : m(0xFFFFFFFFu / divisor + 1u), d(divisor) {}
  __device__ int div(int n) const {
    return d > 1 ? static_cast<int>(__umulhi(static_cast<unsigned>(n), m)) : n;
  }
  __device__ int mod(int n) const { return n - div(n) * d; }
};

// 16 bytes from global to shared memory, asynchronously; both 16-byte aligned.
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d), "l"(src) : "memory");
}
// The barrier of a phase after which staged weights are read: every thread
// waits for its own copies, then for the block.
__device__ __forceinline__ void block_sync() {
  asm volatile("cp.async.wait_all;" ::: "memory");
  __syncthreads();
}
// Start the copy of columns [0, ncols) of K rows of a row-major matrix with
// row length ldw (src at its first column) into dst [K][ncols]. ncols, ldw
// and src's offset are multiples of 4 floats.
__device__ __forceinline__ void stage_weights(float* dst, const float* __restrict__ src, int K,
                                              int ncols, int ldw) {
  const int per_row = ncols / 4;
  const FastDiv by_row(per_row);
  for (int i = threadIdx.x; i < K * per_row; i += blockDim.x) {
    const int k = by_row.div(i);
    const int c = 4 * (i - k * per_row);
    cp_async16(dst + k * ncols + c, src + k * ldw + c);
  }
}

// Offset table, in float elements of the packed weight buffer. The order
// must match _STAGE_SLOTS / _TAIL_SLOTS in kernels/silero_v31_fused2d.py.
// *_WT are transposed [in, out]; DW_W is [5, C]; BN_* are the folded affine.
enum StageSlot {
  DW_W, DW_B, PW_WT, PW_B, PROJ_WT, PROJ_B, QKV_WT, QKV_B, AP_WT, AP_B,
  N1_W, N1_B, L1_WT, L1_B, L2_WT, L2_B, N2_W, N2_B, CONV_WT, CONV_B,
  BN_SCALE, BN_SHIFT, STAGE_SLOTS
};
enum TailSlot {
  LSTM_WT0 = N_STAGES * STAGE_SLOTS, LSTM_WT1, LSTM_B0, LSTM_B1, DEC_W, DEC_B,
  N_SLOTS
};

struct Offsets {
  int v[N_SLOTS];
};

// Shared-memory activations of NB streams: element (stream s, frame f,
// channel c) at p[s * ss + f * ld + c].
struct Act {
  float* p;
  int ss;
  int ld;
  __device__ float* at(int s, int f) const { return p + s * ss + f * ld; }
};

enum : int { EP_ACC = 1, EP_RELU = 2, EP_AFFINE = 4 };

// out(s, f, col0 + n) = epilogue(sum_k in(s, f * in_step, k) * ws[k * N + n]
// + b[n]) for f < S, n < N. ws is the staged matrix in shared memory, b its
// bias in global memory. Epilogue in order: + out (EP_ACC), * scale + shift
// (EP_AFFINE), relu (EP_RELU). A thread takes R rows x 4 columns: per step
// of k one float4 of weights and R activations for 4 R FMAs; neighbouring
// threads take neighbouring columns, so a warp reads a run of weights and
// broadcasts its few activations. Each sum is one fmaf chain from 0.f in k
// order, whatever R. At tier T each activation is an operand of the tier's
// products (split once for its 4 columns), and in turbo each result is
// stored as the JAX package's bf16 ops give it: the product, the bias, the
// residual and the affine each rounded.
template <int T, int R>
__device__ void linear_tiled(const float* ws, const float* __restrict__ b, Act in, int in_step,
                             Act out, int col0, int S, int K, int N, int flags,
                             const float* __restrict__ scale, const float* __restrict__ shift) {
  const int rows = NB * S;
  const int groups = (rows + R - 1) / R;
  const int ncg = N / 4;
  const FastDiv by_ncg(ncg), by_S(S);
  for (int item = threadIdx.x; item < groups * ncg; item += blockDim.x) {
    const int g = by_ncg.div(item);
    const int cg = item - g * ncg;
    const int valid = min(R, rows - g * R);
    const float* src[R];
    float* dst[R];
    float acc[R][4];
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int r = g * R + min(j, valid - 1);
      const int s = by_S.div(r);
      src[j] = in.at(s, (r - s * S) * in_step);
      dst[j] = out.at(s, r - s * S) + col0 + 4 * cg;
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[j][c] = 0.f;
    }
    // the epilogue's constants now, so that their latency passes under the k loop
    float bias[4], sc[4], sf[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      bias[c] = __ldg(b + 4 * cg + c);
      sc[c] = (flags & EP_AFFINE) ? __ldg(scale + 4 * cg + c) : 1.f;
      sf[c] = (flags & EP_AFFINE) ? __ldg(shift + 4 * cg + c) : 0.f;
    }
    const float* wcol = ws + 4 * cg;
#pragma unroll 4
    for (int k = 0; k < K; ++k) {
      const float4 w = *reinterpret_cast<const float4*>(wcol + k * N);
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const Operand<Tier<T>::kProducts> a(src[j][k]);
        acc[j][0] = a.fma(w.x, acc[j][0]);
        acc[j][1] = a.fma(w.y, acc[j][1]);
        acc[j][2] = a.fma(w.z, acc[j][2]);
        acc[j][3] = a.fma(w.w, acc[j][3]);
      }
    }
#pragma unroll
    for (int j = 0; j < R; ++j) {
      if (j >= valid) break;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float v;
        if constexpr (Tier<T>::kStore) {
          v = bf16_rn(__fadd_rn(bf16_rn(acc[j][c]), bias[c]));
          if (flags & EP_ACC) v = bf16_rn(__fadd_rn(v, dst[j][c]));
          if (flags & EP_AFFINE) v = bf16_rn(__fadd_rn(bf16_rn(__fmul_rn(v, sc[c])), sf[c]));
        } else {
          v = acc[j][c] + bias[c];
          if (flags & EP_ACC) v += dst[j][c];
          if (flags & EP_AFFINE) v = v * sc[c] + sf[c];
        }
        if (flags & EP_RELU) v = fmaxf(v, 0.f);
        dst[j][c] = v;
      }
    }
  }
}

// linear_tiled with the largest R that still gives half the block a tile.
template <int T>
__device__ void linear(const float* ws, const float* __restrict__ b, Act in, int in_step, Act out,
                       int col0, int S, int K, int N, int flags,
                       const float* __restrict__ scale = nullptr,
                       const float* __restrict__ shift = nullptr) {
  const int rows = NB * S;
  const int ncg = N / 4;
  if (((rows + 3) / 4) * ncg >= THREADS / 2) {
    linear_tiled<T, 4>(ws, b, in, in_step, out, col0, S, K, N, flags, scale, shift);
  } else if (((rows + 1) / 2) * ncg >= THREADS / 2) {
    linear_tiled<T, 2>(ws, b, in, in_step, out, col0, S, K, N, flags, scale, shift);
  } else {
    linear_tiled<T, 1>(ws, b, in, in_step, out, col0, S, K, N, flags, scale, shift);
  }
}

// x = relu(depthwise conv k5, zero pad 2, over frames) in place. A thread
// walks one (stream, channel) column down the frames with a five-value
// window in registers, so it overwrites frame f only after reading it. In
// turbo every product and sum is a bf16 op, rounded on its own, as the JAX
// package's bf16 elementwise ops are (weights and bias packed as bf16).
template <int T>
__device__ void depthwise_relu_inplace(Act x, int S, int C, const float* __restrict__ w,
                                       const float* __restrict__ b) {
  const FastDiv by_C(C);
  for (int item = threadIdx.x; item < NB * C; item += blockDim.x) {
    const int s = by_C.div(item);
    const int c = item - s * C;
    float* col = x.at(s, 0) + c;
    const float w0 = __ldg(w + 0 * C + c), w1 = __ldg(w + 1 * C + c),
                w2 = __ldg(w + 2 * C + c), w3 = __ldg(w + 3 * C + c),
                w4 = __ldg(w + 4 * C + c), bias = __ldg(b + c);
    float xm2 = 0.f, xm1 = 0.f;
    float x0 = col[0];
    float xp1 = S > 1 ? col[x.ld] : 0.f;
    for (int f = 0; f < S; ++f) {
      const float xp2 = f + 2 < S ? col[(f + 2) * x.ld] : 0.f;
      if constexpr (Tier<T>::kStore) {
        float y = bf16_rn(__fmul_rn(xm2, w0));
        y = bf16_rn(__fadd_rn(y, bf16_rn(__fmul_rn(xm1, w1))));
        y = bf16_rn(__fadd_rn(y, bf16_rn(__fmul_rn(x0, w2))));
        y = bf16_rn(__fadd_rn(y, bf16_rn(__fmul_rn(xp1, w3))));
        y = bf16_rn(__fadd_rn(y, bf16_rn(__fmul_rn(xp2, w4))));
        col[f * x.ld] = fmaxf(bf16_rn(__fadd_rn(y, bias)), 0.f);
      } else {
        float y = xm2 * w0;
        y = y + xm1 * w1;
        y = y + x0 * w2;
        y = y + xp1 * w3;
        y = y + xp2 * w4;
        col[f * x.ld] = fmaxf(y + bias, 0.f);
      }
      xm2 = xm1;
      xm1 = x0;
      x0 = xp1;
      xp1 = xp2;
    }
  }
}

__device__ void copy_act(Act dst, Act src, int S, int C) {
  const FastDiv by_C(C), by_S(S);
  for (int item = threadIdx.x; item < NB * S * C; item += blockDim.x) {
    const int r = by_C.div(item);
    const int c = item - r * C;
    const int s = by_S.div(r);
    dst.at(s, r - s * S)[c] = src.at(s, r - s * S)[c];
  }
}

// LayerNorm over channels, one thread per (stream, frame) row, the row in
// registers (C is 16, 32 or 64): all its loads go out at once, and the
// three passes run on registers in the order of the plain loop, so the sums
// keep their order. Statistics in fp32 at every tier; turbo stores the row
// as bf16.
template <int T, int C>
__device__ void layer_norm_c(Act x, int S, const float* __restrict__ w,
                             const float* __restrict__ b) {
  const FastDiv by_S(S);
  for (int r = threadIdx.x; r < NB * S; r += blockDim.x) {
    const int s = by_S.div(r);
    float* row = x.at(s, r - s * S);
    float v[C];
#pragma unroll
    for (int c = 0; c < C; ++c) v[c] = row[c];
    float sum = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) sum += v[c];
    const float mean = sum / C;
    float sq = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const float d = v[c] - mean;
      sq += d * d;
    }
    const float inv = 1.f / sqrtf(sq / C + LN_EPS);
#pragma unroll
    for (int c = 0; c < C; ++c) {
      row[c] = store_at<T>((v[c] - mean) * inv * __ldg(w + c) + __ldg(b + c));
    }
  }
}

template <int T>
__device__ void layer_norm(Act x, int S, int C, const float* __restrict__ w,
                           const float* __restrict__ b) {
  if (C == 16) {
    layer_norm_c<T, 16>(x, S, w, b);
  } else if (C == 32) {
    layer_norm_c<T, 32>(x, S, w, b);
  } else {
    layer_norm_c<T, 64>(x, S, w, b);
  }
}

// Two-head attention of one stage. qkv rows are [q | k | v], heads are
// contiguous column blocks of hd = C / 2. sc holds [stream][head][S(k)][S(q)].
// The scores and the mix are fp32 sums at every tier (the JAX package sums
// them elementwise, outside its matmul precision); turbo stores alpha and
// the heads' output as bf16.
template <int T>
__device__ void attention(Act qkv, float* sc, int sc_ss, Act ao, int S, int C) {
  const int hd = C / 2;
  const float scale = sqrtf(static_cast<float>(hd));
  const int SS = S * S;
  const FastDiv by_S(S), by_C(C), by_2S(2 * S);
  // the rows' sums of exponentials, NB * 2 * S floats, where stream 0's
  // attention output goes only after they are used
  float* sums = ao.at(0, 0);
  for (int item = threadIdx.x; item < NB * 2 * SS; item += blockDim.x) {
    const int row = by_S.div(item);   // (stream, head, k frame)
    const int j = item - row * S;     // q frame
    const int sh = by_S.div(row);     // (stream, head)
    const int i = row - sh * S;       // k frame
    const int head = sh & 1;
    const int s = sh >> 1;
    const float* k = qkv.at(s, i) + C + head * hd;
    const float* q = qkv.at(s, j) + head * hd;
    float acc = 0.f;
#pragma unroll 8
    for (int d = 0; d < hd; ++d) acc = fmaf(k[d], q[d], acc);
    sc[s * sc_ss + head * SS + i * S + j] = acc / scale;
  }
  __syncthreads();
  PHASE_STAMP(PH_SCORES);
  for (int r = threadIdx.x; r < NB * 2 * S; r += blockDim.x) {
    const int s = by_2S.div(r);
    float* row = sc + s * sc_ss + (r - s * 2 * S) * S;
    float mx = row[0];
#pragma unroll 8
    for (int j = 1; j < S; ++j) mx = fmaxf(mx, row[j]);
    float sum = 0.f;
#pragma unroll 8
    for (int j = 0; j < S; ++j) {
      const float e = expf(row[j] - mx);
      row[j] = e;
      sum += e;
    }
    sums[r] = sum;
  }
  __syncthreads();
  // e / sum by a thread per element, not S divisions one after the other
  for (int item = threadIdx.x; item < NB * 2 * SS; item += blockDim.x) {
    const int row = by_S.div(item);  // (stream, head, k frame)
    const int s = by_2S.div(row);
    float* e = sc + s * sc_ss + (row - s * 2 * S) * S + (item - row * S);
    *e = store_at<T>(*e / sums[row]);
  }
  __syncthreads();
  PHASE_STAMP(PH_SOFTMAX);
  for (int item = threadIdx.x; item < NB * S * C; item += blockDim.x) {
    const int r = by_C.div(item);  // (stream, frame)
    const int c = item - r * C;
    const int s = by_S.div(r);
    const int i = r - s * S;
    const int head = c >= hd;
    const float* alpha = sc + s * sc_ss + head * SS + i * S;
    float acc = 0.f;
#pragma unroll 8
    for (int j = 0; j < S; ++j) acc = fmaf(alpha[j], qkv.at(s, j)[2 * C + c], acc);
    ao.at(s, i)[c] = store_at<T>(acc);
  }
}

// Shared-memory floats per stream: region A holds a stage's input and then
// its scratch (qkv, scores, attention output; the FF hidden reuses qkv) and
// its output; region H holds the stage's running activation.
__host__ __device__ inline void plan(int seq0, int* sa, int* sh) {
  int a = seq0 * pitch(N_FEAT);
  int h = 0;
  int S = seq0;
  for (int st = 0; st < N_STAGES; ++st) {
    const int C = c_out(st);
    const int scratch = S * pitch(3 * C) + 2 * S * S + S * pitch(C);
    a = a > scratch ? a : scratch;
    h = h > S * pitch(C) ? h : S * pitch(C);
    S = (S + stride_of(st) - 1) / stride_of(st);
  }
  a = a > S * ENC_LD ? a : S * ENC_LD;
  *sa = (a + 3) & ~3;  // a stream's region stays 16-byte aligned for float4 reads
  *sh = h;
}

// A block's shared memory, carved from the dynamic allocation: region A
// [NB][sa] (the stage-1 input, then each stage's scratch and output),
// region H [NB][sh], the LSTM's gates [NB][GATES], its state hs, cs
// [2][NB][HIDDEN], the decoder's running sum dec [NB][HIDDEN] and the two
// weight buffers wbuf [2][WBUF] (after the encoder: the hoisted input half
// of the LSTM's layer 0). `cur` says which buffer the next product reads.
struct Block {
  float* A;
  float* H;
  float* gates;
  float* hs;
  float* cs;
  float* dec;
  float* wbuf;
  int sa;
  int sh;
};

// floats after region A
__host__ __device__ inline int tail_floats(int sh) {
  return NB * sh + NB * GATES + 5 * NB * HIDDEN + 2 * WBUF;
}

__host__ __device__ inline int block_floats(int sa, int sh) { return NB * sa + tail_floats(sh); }

__device__ inline Block carve(float* smem, int sa, int sh) {
  Block m;
  m.A = smem;
  m.H = m.A + NB * sa;
  m.gates = m.H + NB * sh;
  m.hs = m.gates + NB * GATES;
  m.cs = m.hs + 2 * NB * HIDDEN;
  m.dec = m.cs + 2 * NB * HIDDEN;
  m.wbuf = m.dec + NB * HIDDEN;
  m.sa = sa;
  m.sh = sh;
  return m;
}

// The products of a stage in the order they run, as (slot of the transposed
// weight, first column, columns, K, row length): what stage_weights copies.
struct WeightOp {
  int slot;
  int col0;
  int ncols;
  int K;
  int ldw;
};

// The first product of stage st: the projection, or pw where there is none.
__device__ inline WeightOp first_op(int st, const int* off) {
  const int slot = off[PROJ_WT] >= 0 ? PROJ_WT : PW_WT;
  return WeightOp{slot, 0, c_out(st), c_in(st), c_out(st)};
}

// Which of the two weight buffers the running product reads, and the copy
// of the next product's matrix into the other one. The other buffer was
// read last by the product before the running one, a barrier ago.
struct WeightStage {
  float* buf;
  int cur;
  __device__ const float* now() const { return buf + cur * WBUF; }
  __device__ void prefetch(const float* __restrict__ W, const int* off, WeightOp op) {
    stage_weights(buf + (cur ^ 1) * WBUF, W + off[op.slot] + op.col0, op.K, op.ncols, op.ldw);
  }
  __device__ void flip() { cur ^= 1; }
};

// One encoder stage. On entry the weights of its first product are in
// ws.now() (copied and a block_sync() passed); on exit those of the next
// stage's first product are (next_off not null), and region A holds the
// stage's output.
template <int T>
__device__ void encoder_stage(int st, const float* __restrict__ W, const int* off,
                              const int* next_off, WeightStage& ws, float* A, int sa, float* H,
                              int sh, int S) {
  const int cin = c_in(st);
  const int cout = c_out(st);
  const int stride = stride_of(st);
  const int s_out = (S + stride - 1) / stride;
  const bool last = st == N_STAGES - 1;
  Act x{A, sa, pitch(cin)};
  Act h{H, sh, pitch(cout)};
  const WeightOp pw{PW_WT, 0, cout, cin, cout};
  // qkv in column blocks that fit a weight buffer: one block, or q, k, v
  const int qkv_cols = 3 * cout * cout <= WBUF ? 3 * cout : cout;
  const WeightOp square{0, 0, cout, cout, cout};

  if (off[PROJ_WT] >= 0) {
    ws.prefetch(W, off, pw);
    linear<T>(ws.now(), W + off[PROJ_B], x, 1, h, 0, S, cin, cout, 0);
    block_sync();
    ws.flip();
  } else {
    copy_act(h, x, S, cin);
    __syncthreads();
  }
  PHASE_STAMP(PH_PROJ);
  // each copy starts as soon as its buffer is free, a phase or more before
  // the product that waits for it
  ws.prefetch(W, off, WeightOp{QKV_WT, 0, qkv_cols, cout, 3 * cout});
  depthwise_relu_inplace<T>(x, S, cin, W + off[DW_W], W + off[DW_B]);
  __syncthreads();
  PHASE_STAMP(PH_DW);
  linear<T>(ws.now(), W + off[PW_B], x, 1, h, 0, S, cin, cout, EP_ACC | EP_RELU);
  block_sync();
  ws.flip();
  PHASE_STAMP(PH_PW);

  // region A is free now: attention scratch
  Act qkv{A, sa, pitch(3 * cout)};
  float* sc = A + S * pitch(3 * cout);
  Act ao{sc + 2 * S * S, sa, pitch(cout)};
  for (int col0 = 0; col0 < 3 * cout; col0 += qkv_cols) {
    WeightOp next = square;
    if (col0 + qkv_cols < 3 * cout) {
      next = WeightOp{QKV_WT, col0 + qkv_cols, qkv_cols, cout, 3 * cout};
    } else {
      next.slot = AP_WT;
    }
    ws.prefetch(W, off, next);
    linear<T>(ws.now(), W + off[QKV_B] + col0, h, 1, qkv, col0, S, cout, qkv_cols, 0);
    block_sync();
    ws.flip();
  }
  PHASE_STAMP(PH_QKV);
  WeightOp next = square;
  next.slot = L1_WT;
  ws.prefetch(W, off, next);
  attention<T>(qkv, sc, sa, ao, S, cout);
  __syncthreads();
  PHASE_STAMP(PH_MIX);
  linear<T>(ws.now(), W + off[AP_B], ao, 1, h, 0, S, cout, cout, EP_ACC);
  block_sync();
  ws.flip();
  PHASE_STAMP(PH_OUT_PROJ);
  next.slot = L2_WT;
  ws.prefetch(W, off, next);
  layer_norm<T>(h, S, cout, W + off[N1_W], W + off[N1_B]);
  __syncthreads();
  PHASE_STAMP(PH_LN1);
  Act ff{A, sa, pitch(cout)};  // qkv is dead
  linear<T>(ws.now(), W + off[L1_B], h, 1, ff, 0, S, cout, cout, EP_RELU);
  block_sync();
  ws.flip();
  PHASE_STAMP(PH_LIN1);
  next.slot = CONV_WT;
  ws.prefetch(W, off, next);
  linear<T>(ws.now(), W + off[L2_B], ff, 1, h, 0, S, cout, cout, EP_ACC);
  block_sync();
  ws.flip();
  PHASE_STAMP(PH_LIN2);
  if (next_off != nullptr) ws.prefetch(W, next_off, first_op(st + 1, next_off));
  layer_norm<T>(h, S, cout, W + off[N2_W], W + off[N2_B]);
  __syncthreads();
  PHASE_STAMP(PH_LN2);
  // the next stage's input; the last stage's rows at the LSTM's pitch
  Act y{A, sa, last ? ENC_LD : pitch(cout)};
  linear<T>(ws.now(), W + off[CONV_B], h, stride, y, 0, s_out, cout, cout, EP_AFFINE | EP_RELU,
         W + off[BN_SCALE], W + off[BN_SHIFT]);
  block_sync();
  ws.flip();
  PHASE_STAMP(PH_CONV);
}

// The LSTM state h0, c0 [2, batch, 64] of the block's streams (zeros past
// the batch) into hs, cs; the decoder sum to zero. No barrier.
__device__ void load_state(const Block& m, const float* h0, const float* c0, int b0, int batch) {
  const int tid = threadIdx.x;
  for (int i = tid; i < 2 * NB * HIDDEN; i += blockDim.x) {
    const int layer = i / (NB * HIDDEN);
    const int s = (i / HIDDEN) % NB;
    const int u = i % HIDDEN;
    const bool ok = b0 + s < batch;
    const long long g = (static_cast<long long>(layer) * batch + b0 + s) * HIDDEN + u;
    m.hs[i] = ok ? h0[g] : 0.f;
    m.cs[i] = ok ? c0[g] : 0.f;
  }
  for (int i = tid; i < NB * HIDDEN; i += blockDim.x) m.dec[i] = 0.f;
}

// The hidden and cell state hs, cs of the block's real streams to hn, cn
// [2, batch, 64]. No barrier.
__device__ void store_state(const Block& m, int b0, int batch, float* hn, float* cn) {
  for (int i = threadIdx.x; i < 2 * NB * HIDDEN; i += blockDim.x) {
    const int layer = i / (NB * HIDDEN);
    const int s = (i / HIDDEN) % NB;
    const int u = i % HIDDEN;
    if (b0 + s >= batch) continue;
    const long long g = (static_cast<long long>(layer) * batch + b0 + s) * HIDDEN + u;
    hn[g] = m.hs[i];
    cn[g] = m.cs[i];
  }
}

// The four encoder stages over region A (the stage-1 input, written by all
// threads; no barrier needed before the call). Returns the frame count S of
// the last stage's output, which A then holds as [NB][S][ENC_LD].
template <int T>
__device__ int encode(const float* __restrict__ W, const Offsets& o, const Block& m, int seq0) {
  WeightStage ws{m.wbuf, 1};
  ws.prefetch(W, o.v, first_op(0, o.v));
  block_sync();
  ws.flip();
  int S = seq0;
  for (int st = 0; st < N_STAGES; ++st) {
    const int* next_off = st + 1 < N_STAGES ? o.v + (st + 1) * STAGE_SLOTS : nullptr;
    encoder_stage<T>(st, W, o.v + st * STAGE_SLOTS, next_off, ws, m.A, m.sa, m.H, m.sh, S);
    S = (S + stride_of(st) - 1) / stride_of(st);
  }
  return S;
}

// The encoder's output, which region A holds as [NB][S][ENC_LD], of the
// block's real streams to y [rows, S, 64]. No barrier.
__device__ void store_encoded(const Block& m, int S, int b0, int rows, float* __restrict__ y) {
  const FastDiv by_S(S);
  for (int i = threadIdx.x; i < NB * S * HIDDEN; i += blockDim.x) {
    const int u = i % HIDDEN;
    const int r = i / HIDDEN;
    const int s = by_S.div(r);
    if (b0 + s >= rows) continue;
    y[(static_cast<long long>(b0 + s) * S + (r - s * S)) * HIDDEN + u] =
        m.A[s * m.sa + (r - s * S) * ENC_LD + u];
  }
}

// The 2-layer LSTM over S frames of NB streams with the decoder's running
// sum: in(s, t) is frame t of stream s (64 floats), wt[l] the layer's
// transposed weight [2H][4H], bias[l] its [4H]. Updates hs, cs in place and
// adds relu(h_top) of every frame to dec. Expects hs, cs, dec loaded and a
// barrier passed; ends on a barrier. The streaming form: every weight comes
// from global memory (L2) at every step. lstm_decoder.cu's streaming kernel
// runs it; the fused kernels run lstm_decoder_steps_hoisted below, the same
// sums in the same order.
template <class In>
__device__ void lstm_decoder_steps(const float* const* wt_l, const float* const* bias_l, In in,
                                   int S, const Block& m) {
  const int tid = threadIdx.x;
  float* hs = m.hs;
  float* cs = m.cs;
  float* gates = m.gates;
  float* dec = m.dec;
  for (int t = 0; t < S; ++t) {
    for (int layer = 0; layer < 2; ++layer) {
      const float* wt = wt_l[layer];  // [2H][4H]
      float* h_l = hs + layer * NB * HIDDEN;
      float* c_l = cs + layer * NB * HIDDEN;
      {
        const int j = tid;  // gate column
        float acc[NB];
#pragma unroll
        for (int s = 0; s < NB; ++s) acc[s] = 0.f;
        // unroll 8: eight weight loads from L2 in flight instead of one; each
        // sum keeps its order of additions, so the bits do not change
#pragma unroll 8
        for (int k = 0; k < HIDDEN; ++k) {
          const float w = __ldg(wt + k * GATES + j);
#pragma unroll
          for (int s = 0; s < NB; ++s) {
            const float x = layer == 0 ? in(s, t)[k] : hs[s * HIDDEN + k];
            acc[s] = fmaf(x, w, acc[s]);
          }
        }
#pragma unroll 8
        for (int k = 0; k < HIDDEN; ++k) {
          const float w = __ldg(wt + (HIDDEN + k) * GATES + j);
#pragma unroll
          for (int s = 0; s < NB; ++s) acc[s] = fmaf(h_l[s * HIDDEN + k], w, acc[s]);
        }
        const float bias = __ldg(bias_l[layer] + j);
#pragma unroll
        for (int s = 0; s < NB; ++s) gates[s * GATES + j] = acc[s] + bias;
      }
      __syncthreads();
      for (int i = tid; i < NB * HIDDEN; i += blockDim.x) {
        const int s = i / HIDDEN;
        const int u = i % HIDDEN;
        const float* g = gates + s * GATES;
        const float ig = sigmoidf(g[u]);
        const float fg = sigmoidf(g[HIDDEN + u]);
        const float gg = accurate_tanhf(g[2 * HIDDEN + u]);
        const float og = sigmoidf(g[3 * HIDDEN + u]);
        const float c_new = fg * c_l[i] + ig * gg;
        const float h_new = og * accurate_tanhf(c_new);
        c_l[i] = c_new;
        h_l[i] = h_new;
        if (layer == 1) dec[i] += fmaxf(h_new, 0.f);
      }
      __syncthreads();
    }
  }
}

// The same LSTM for the fused kernels, on the encoder's output in region A
// ([NB][S][ENC_LD]): the same sums in the same order as lstm_decoder_steps
// (each gate one fmaf chain from 0.f over the 64 input terms and then the
// 64 recurrent terms in k order, then the bias; the cell update of
// lstm_cell.cuh), so the same bits. Thread j owns gate column j:
//   - layer 0's input half for all S frames first, its 64 weights in
//     registers, each serving NB x S rows; the partial sums go to `pre`
//     ([NB][S][GATES] in the weight buffers, which the encoder has left),
//     where only thread j reads column j again, so no barrier;
//   - then W_hh of layer 0 in the same 64 registers for all frames: a
//     layer-0 step reads only h (as float4) and its partial sum;
//   - layer 1's 128 weights a frame from L2, sixteen loads in flight.
// At tier T each x and h value is an operand of the tier's products, in the
// same chains (lstm_resident.cuh does the same, so the bits stay equal).
template <int T>
__device__ void lstm_decoder_steps_hoisted(const float* const* wt_l, const float* const* bias_l,
                                           int S, const Block& m) {
  const int tid = threadIdx.x;
  const int j = tid;  // gate column
  float* hs = m.hs;
  float* cs = m.cs;
  float* gates = m.gates;
  float* dec = m.dec;
  float* pre = m.wbuf;
  using Op = Operand<Tier<T>::kProducts>;
  static_assert(NB * 7 * GATES <= 2 * WBUF, "the hoisted sums fit the weight buffers");
  float w0[HIDDEN];
#pragma unroll
  for (int k = 0; k < HIDDEN; ++k) w0[k] = __ldg(wt_l[0] + k * GATES + j);
  for (int t = 0; t < S; ++t) {
    float acc[NB];
#pragma unroll
    for (int s = 0; s < NB; ++s) acc[s] = 0.f;
#pragma unroll
    for (int k4 = 0; k4 < HIDDEN / 4; ++k4) {
#pragma unroll
      for (int s = 0; s < NB; ++s) {
        const float4 x = *reinterpret_cast<const float4*>(m.A + s * m.sa + t * ENC_LD + 4 * k4);
        acc[s] = Op(x.x).fma(w0[4 * k4 + 0], acc[s]);
        acc[s] = Op(x.y).fma(w0[4 * k4 + 1], acc[s]);
        acc[s] = Op(x.z).fma(w0[4 * k4 + 2], acc[s]);
        acc[s] = Op(x.w).fma(w0[4 * k4 + 3], acc[s]);
      }
    }
#pragma unroll
    for (int s = 0; s < NB; ++s) pre[(s * S + t) * GATES + j] = acc[s];
  }
#pragma unroll
  for (int k = 0; k < HIDDEN; ++k) w0[k] = __ldg(wt_l[0] + (HIDDEN + k) * GATES + j);
  const float bias0 = __ldg(bias_l[0] + j);
  const float bias1 = __ldg(bias_l[1] + j);
  const float* wt1 = wt_l[1] + j;
  PHASE_STAMP(PH_LSTM_PRE);

  for (int t = 0; t < S; ++t) {
    for (int layer = 0; layer < 2; ++layer) {
      float* h_l = hs + layer * NB * HIDDEN;
      float* c_l = cs + layer * NB * HIDDEN;
      float acc[NB];
      if (layer == 0) {
#pragma unroll
        for (int s = 0; s < NB; ++s) acc[s] = pre[(s * S + t) * GATES + j];
#pragma unroll
        for (int k4 = 0; k4 < HIDDEN / 4; ++k4) {
#pragma unroll
          for (int s = 0; s < NB; ++s) {
            const float4 x = *reinterpret_cast<const float4*>(h_l + s * HIDDEN + 4 * k4);
            acc[s] = Op(x.x).fma(w0[4 * k4 + 0], acc[s]);
            acc[s] = Op(x.y).fma(w0[4 * k4 + 1], acc[s]);
            acc[s] = Op(x.z).fma(w0[4 * k4 + 2], acc[s]);
            acc[s] = Op(x.w).fma(w0[4 * k4 + 3], acc[s]);
          }
        }
#pragma unroll
        for (int s = 0; s < NB; ++s) gates[s * GATES + j] = acc[s] + bias0;
      } else {
#pragma unroll
        for (int s = 0; s < NB; ++s) acc[s] = 0.f;
        // the input half (layer 0's new h), then the recurrent half
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const float* src = half == 0 ? hs : h_l;
          const float* wh = wt1 + half * HIDDEN * GATES;
#pragma unroll 4
          for (int k4 = 0; k4 < HIDDEN / 4; ++k4) {
            float w[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) w[i] = __ldg(wh + (4 * k4 + i) * GATES);
#pragma unroll
            for (int s = 0; s < NB; ++s) {
              const float4 x = *reinterpret_cast<const float4*>(src + s * HIDDEN + 4 * k4);
              acc[s] = Op(x.x).fma(w[0], acc[s]);
              acc[s] = Op(x.y).fma(w[1], acc[s]);
              acc[s] = Op(x.z).fma(w[2], acc[s]);
              acc[s] = Op(x.w).fma(w[3], acc[s]);
            }
          }
        }
#pragma unroll
        for (int s = 0; s < NB; ++s) gates[s * GATES + j] = acc[s] + bias1;
      }
      __syncthreads();
      for (int i = tid; i < NB * HIDDEN; i += blockDim.x) {
        const int s = i / HIDDEN;
        const int u = i % HIDDEN;
        const float* g = gates + s * GATES;
        const float ig = sigmoidf(g[u]);
        const float fg = sigmoidf(g[HIDDEN + u]);
        const float gg = tanh_at<T>(g[2 * HIDDEN + u]);
        const float og = sigmoidf(g[3 * HIDDEN + u]);
        float c = c_l[i];
        const float h_new = lstm_cell<T>(ig, fg, gg, og, c);
        c_l[i] = c;
        h_l[i] = h_new;
        if (layer == 1) dec[i] += fmaxf(h_new, 0.f);
      }
      __syncthreads();
    }
  }
}

// The v3 decoder on one stream's running sum dec_s [64] over S frames:
// sigmoid(mean_t relu(h_top) . dec_w1 + dec_b1), channel 1 of dec_w [2, 64].
// One thread a stream: lstm_decoder.cu's streaming kernel calls it; the
// fused kernels run decode_probs below, the same operations.
__device__ float decode_prob(const float* dec_s, int S, const float* __restrict__ dec_w1,
                             float dec_b1) {
  float acc = 0.f;
  for (int u = 0; u < HIDDEN; ++u) acc = fmaf(dec_s[u] / S, __ldg(dec_w1 + u), acc);
  return sigmoidf(acc + dec_b1);
}

// Everything after the stage-1 input: the four encoder stages over A, the
// 2-layer LSTM over the last stage's frames, the decoder; stores probs [B]
// and hn, cn [2, B, 64] of the block's real streams. Expects A, hs, cs and
// dec written (no barrier needed: encode passes one first).
// decode_prob for the block's NB streams, the same operations spread over
// the block: every unit's dec / S by a thread of its own (64 full-precision
// divisions one after the other in one thread were 3 % of the step
// kernel's time), then one thread a stream chains the 64 FMAs in order.
// Expects a barrier passed since dec was written; gates is scratch. At tier
// T the mean is an operand of the tier's product against dec_w1 as packed
// (the JAX kernel's dot(dec_acc / seq, dec_w), silero_v31_fused2d.py:224).
template <int T>
__device__ void decode_probs(const Block& m, int S, const float* __restrict__ dec_w1, float dec_b1,
                             int b0, int batch, float* probs) {
  float* mean = m.gates;           // [NB][HIDDEN]: dec / S
  float* w = mean + NB * HIDDEN;   // [HIDDEN]
  for (int i = threadIdx.x; i < NB * HIDDEN; i += blockDim.x) mean[i] = m.dec[i] / S;
  for (int u = threadIdx.x; u < HIDDEN; u += blockDim.x) w[u] = __ldg(dec_w1 + u);
  __syncthreads();
  for (int s = threadIdx.x; s < NB; s += blockDim.x) {
    if (b0 + s >= batch) continue;
    float acc = 0.f;
#pragma unroll
    for (int u = 0; u < HIDDEN; ++u) {
      acc = Operand<Tier<T>::kProducts>(mean[s * HIDDEN + u]).fma(w[u], acc);
    }
    probs[b0 + s] = sigmoidf(acc + dec_b1);
  }
}

template <int T>
__device__ void encode_lstm_decode(const float* __restrict__ W, const Offsets& o, const Block& m,
                                   int seq0, int b0, int batch, float* probs, float* hn,
                                   float* cn) {
  const int S = encode<T>(W, o, m, seq0);
  const float* const wt[2] = {W + o.v[LSTM_WT0], W + o.v[LSTM_WT1]};
  const float* const bias[2] = {W + o.v[LSTM_B0], W + o.v[LSTM_B1]};
  lstm_decoder_steps_hoisted<T>(wt, bias, S, m);
  PHASE_STAMP(PH_LSTM);

  const float* dec_w1 = W + o.v[DEC_W] + HIDDEN;
  const float dec_b1 = __ldg(W + o.v[DEC_B] + 1);
  store_state(m, b0, batch, hn, cn);
  decode_probs<T>(m, S, dec_w1, dec_b1, b0, batch, probs);
  PHASE_STAMP(PH_END);
}

}  // namespace
