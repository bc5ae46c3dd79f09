// The Silero v3.1 model after its front-end, as device code shared by three
// sources: silero_v31_fused.cu (normalized features in; and its encoder-only
// entry), silero_v31_fused_audio.cu (raw audio in, the spectrum and the
// adaptive normalization computed in the same block first) and
// lstm_decoder.cu (the encoder's output in: the LSTM and the decoder alone,
// over several chunks of a stream in order). All run this one code for the
// encoder, the LSTM and the decoder, so on the same input they give the
// same bits.
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
// A block takes NB streams and walks every stage and every LSTM step for
// them with all activations in shared memory; the weights (124,632 floats,
// 0.5 MB, packed once by the wrapper into one buffer with an offset table)
// are read from global memory, where they stay in L2. Each weight a thread
// reads serves NB streams: in the LSTM, thread j owns gate column j and
// keeps NB sums in registers. A ragged last block computes on zero rows and
// stores only its real streams.
//
// Numerics are the faithful tier's: fp32 throughout, accurate tanh (the
// exp form of vadc_tpu/nn/functional.py accurate_tanh), sigmoid as
// 1/(1+expf(-x)), 1/sqrtf for the norms, and no --use_fast_math.
#pragma once

#include <cuda_runtime.h>

#include "lstm_cell.cuh"  // sigmoidf, accurate_tanhf

namespace {

constexpr int N_STAGES = 4;
constexpr int N_FEAT = 129;
constexpr int HIDDEN = 64;
constexpr int GATES = 4 * HIDDEN;  // 256: one gate column per thread
constexpr int THREADS = 256;
// Streams per block. 4 gives 512 blocks at batch 2048, about 4 per SM, and
// 68 KB of shared memory each; 8 measured slower on an H100 (1.14 vs
// 0.88 ms at batch 2048: 256 blocks cannot fill 132 SMs evenly, and 136 KB
// a block leaves one block per SM).
constexpr int NB = 4;
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

// out(s, f, n) = epilogue(sum_k in(s, f * in_step, k) * wt[k * N + n] + b[n])
// for f < S. Epilogue in order: + out (EP_ACC), * scale + shift
// (EP_AFFINE), relu (EP_RELU). A thread takes one output column n of R rows,
// so each weight it reads serves R rows; neighbouring threads take
// neighbouring n and read neighbouring weights.
__device__ void linear(const float* __restrict__ wt, const float* __restrict__ b,
                       Act in, int in_step, Act out, int S, int K, int N, int flags,
                       const float* __restrict__ scale = nullptr,
                       const float* __restrict__ shift = nullptr) {
  constexpr int R = 4;
  const int rows = NB * S;
  const int groups = (rows + R - 1) / R;
  for (int item = threadIdx.x; item < groups * N; item += blockDim.x) {
    const int n = item % N;
    const int g = item / N;
    const int valid = min(R, rows - g * R);
    const float* src[R];
    float acc[R];
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int r = g * R + min(j, valid - 1);
      const int s = r / S;
      src[j] = in.at(s, (r - s * S) * in_step);
      acc[j] = 0.f;
    }
    for (int k = 0; k < K; ++k) {
      const float w = __ldg(wt + k * N + n);
#pragma unroll
      for (int j = 0; j < R; ++j) acc[j] = fmaf(src[j][k], w, acc[j]);
    }
    const float bias = __ldg(b + n);
#pragma unroll
    for (int j = 0; j < R; ++j) {
      if (j >= valid) break;
      const int r = g * R + j;
      const int s = r / S;
      float* o = out.at(s, r - s * S) + n;
      float v = acc[j] + bias;
      if (flags & EP_ACC) v += *o;
      if (flags & EP_AFFINE) v = v * __ldg(scale + n) + __ldg(shift + n);
      if (flags & EP_RELU) v = fmaxf(v, 0.f);
      *o = v;
    }
  }
}

// x = relu(depthwise conv k5, zero pad 2, over frames) in place. A thread
// walks one (stream, channel) column down the frames with a five-value
// window in registers, so it overwrites frame f only after reading it.
__device__ void depthwise_relu_inplace(Act x, int S, int C, const float* __restrict__ w,
                                       const float* __restrict__ b) {
  for (int item = threadIdx.x; item < NB * C; item += blockDim.x) {
    const int c = item % C;
    const int s = item / C;
    float* col = x.at(s, 0) + c;
    const float w0 = __ldg(w + 0 * C + c), w1 = __ldg(w + 1 * C + c),
                w2 = __ldg(w + 2 * C + c), w3 = __ldg(w + 3 * C + c),
                w4 = __ldg(w + 4 * C + c), bias = __ldg(b + c);
    float xm2 = 0.f, xm1 = 0.f;
    float x0 = col[0];
    float xp1 = S > 1 ? col[x.ld] : 0.f;
    for (int f = 0; f < S; ++f) {
      const float xp2 = f + 2 < S ? col[(f + 2) * x.ld] : 0.f;
      float y = xm2 * w0;
      y = y + xm1 * w1;
      y = y + x0 * w2;
      y = y + xp1 * w3;
      y = y + xp2 * w4;
      col[f * x.ld] = fmaxf(y + bias, 0.f);
      xm2 = xm1;
      xm1 = x0;
      x0 = xp1;
      xp1 = xp2;
    }
  }
}

__device__ void copy_act(Act dst, Act src, int S, int C) {
  for (int item = threadIdx.x; item < NB * S * C; item += blockDim.x) {
    const int c = item % C;
    const int r = item / C;
    const int s = r / S;
    dst.at(s, r - s * S)[c] = src.at(s, r - s * S)[c];
  }
}

// LayerNorm over channels, one thread per (stream, frame) row.
__device__ void layer_norm(Act x, int S, int C, const float* __restrict__ w,
                           const float* __restrict__ b) {
  for (int r = threadIdx.x; r < NB * S; r += blockDim.x) {
    const int s = r / S;
    float* row = x.at(s, r - s * S);
    float sum = 0.f;
    for (int c = 0; c < C; ++c) sum += row[c];
    const float mean = sum / C;
    float sq = 0.f;
    for (int c = 0; c < C; ++c) {
      const float d = row[c] - mean;
      sq += d * d;
    }
    const float inv = 1.f / sqrtf(sq / C + LN_EPS);
    for (int c = 0; c < C; ++c) row[c] = (row[c] - mean) * inv * __ldg(w + c) + __ldg(b + c);
  }
}

// Two-head attention of one stage. qkv rows are [q | k | v], heads are
// contiguous column blocks of hd = C / 2. sc holds [stream][head][S(k)][S(q)].
__device__ void attention(Act qkv, float* sc, int sc_ss, Act ao, int S, int C) {
  const int hd = C / 2;
  const float scale = sqrtf(static_cast<float>(hd));
  const int SS = S * S;
  for (int item = threadIdx.x; item < NB * 2 * SS; item += blockDim.x) {
    const int j = item % S;  // q frame
    const int i = (item / S) % S;  // k frame
    const int head = (item / SS) % 2;
    const int s = item / (2 * SS);
    const float* k = qkv.at(s, i) + C + head * hd;
    const float* q = qkv.at(s, j) + head * hd;
    float acc = 0.f;
    for (int d = 0; d < hd; ++d) acc = fmaf(k[d], q[d], acc);
    sc[s * sc_ss + head * SS + i * S + j] = acc / scale;
  }
  __syncthreads();
  for (int r = threadIdx.x; r < NB * 2 * S; r += blockDim.x) {
    const int s = r / (2 * S);
    float* row = sc + s * sc_ss + (r - s * 2 * S) * S;
    float mx = row[0];
    for (int j = 1; j < S; ++j) mx = fmaxf(mx, row[j]);
    float sum = 0.f;
    for (int j = 0; j < S; ++j) {
      const float e = expf(row[j] - mx);
      row[j] = e;
      sum += e;
    }
    for (int j = 0; j < S; ++j) row[j] = row[j] / sum;
  }
  __syncthreads();
  for (int item = threadIdx.x; item < NB * S * C; item += blockDim.x) {
    const int c = item % C;
    const int i = (item / C) % S;
    const int s = item / (C * S);
    const int head = c / hd;
    const float* alpha = sc + s * sc_ss + head * SS + i * S;
    float acc = 0.f;
    for (int j = 0; j < S; ++j) acc = fmaf(alpha[j], qkv.at(s, j)[2 * C + c], acc);
    ao.at(s, i)[c] = acc;
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
  *sa = a;
  *sh = h;
}

__device__ void encoder_stage(int st, const float* __restrict__ W, const int* off,
                              float* A, int sa, float* H, int sh, int S) {
  const int cin = c_in(st);
  const int cout = c_out(st);
  const int stride = stride_of(st);
  const int s_out = (S + stride - 1) / stride;
  Act x{A, sa, pitch(cin)};
  Act h{H, sh, pitch(cout)};

  if (off[PROJ_WT] >= 0) {
    linear(W + off[PROJ_WT], W + off[PROJ_B], x, 1, h, S, cin, cout, 0);
  } else {
    copy_act(h, x, S, cin);
  }
  __syncthreads();
  depthwise_relu_inplace(x, S, cin, W + off[DW_W], W + off[DW_B]);
  __syncthreads();
  linear(W + off[PW_WT], W + off[PW_B], x, 1, h, S, cin, cout, EP_ACC | EP_RELU);
  __syncthreads();

  // region A is free now: attention scratch
  Act qkv{A, sa, pitch(3 * cout)};
  float* sc = A + S * pitch(3 * cout);
  Act ao{sc + 2 * S * S, sa, pitch(cout)};
  linear(W + off[QKV_WT], W + off[QKV_B], h, 1, qkv, S, cout, 3 * cout, 0);
  __syncthreads();
  attention(qkv, sc, sa, ao, S, cout);
  __syncthreads();
  linear(W + off[AP_WT], W + off[AP_B], ao, 1, h, S, cout, cout, EP_ACC);
  __syncthreads();
  layer_norm(h, S, cout, W + off[N1_W], W + off[N1_B]);
  __syncthreads();
  Act ff{A, sa, pitch(cout)};  // qkv is dead
  linear(W + off[L1_WT], W + off[L1_B], h, 1, ff, S, cout, cout, EP_RELU);
  __syncthreads();
  linear(W + off[L2_WT], W + off[L2_B], ff, 1, h, S, cout, cout, EP_ACC);
  __syncthreads();
  layer_norm(h, S, cout, W + off[N2_W], W + off[N2_B]);
  __syncthreads();
  Act y{A, sa, pitch(cout)};  // the next stage's input
  linear(W + off[CONV_WT], W + off[CONV_B], h, stride, y, s_out, cout, cout,
         EP_AFFINE | EP_RELU, W + off[BN_SCALE], W + off[BN_SHIFT]);
  __syncthreads();
}

// A block's shared memory, carved from the dynamic allocation: region A
// [NB][sa] (the stage-1 input, then each stage's scratch and output),
// region H [NB][sh], the LSTM's gates [NB][GATES], its state hs, cs
// [2][NB][HIDDEN] and the decoder's running sum dec [NB][HIDDEN].
struct Block {
  float* A;
  float* H;
  float* gates;
  float* hs;
  float* cs;
  float* dec;
  int sa;
  int sh;
};

__host__ __device__ inline int block_floats(int sa, int sh) {
  return NB * (sa + sh) + NB * GATES + 5 * NB * HIDDEN;
}

__device__ inline Block carve(float* smem, int sa, int sh) {
  Block m;
  m.A = smem;
  m.H = m.A + NB * sa;
  m.gates = m.H + NB * sh;
  m.hs = m.gates + NB * GATES;
  m.cs = m.hs + 2 * NB * HIDDEN;
  m.dec = m.cs + 2 * NB * HIDDEN;
  m.sa = sa;
  m.sh = sh;
  return m;
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

// The four encoder stages over region A (the stage-1 input, a barrier
// passed). Returns the frame count S of the last stage's output, which A
// then holds as [NB][S][pitch(64)].
__device__ int encode(const float* __restrict__ W, const Offsets& o, const Block& m, int seq0) {
  int S = seq0;
  for (int st = 0; st < N_STAGES; ++st) {
    encoder_stage(st, W, o.v + st * STAGE_SLOTS, m.A, m.sa, m.H, m.sh, S);
    S = (S + stride_of(st) - 1) / stride_of(st);
  }
  return S;
}

// The encoder's output rows in region A, as the LSTM's input.
struct ActRows {
  Act a;
  __device__ const float* operator()(int s, int t) const { return a.at(s, t); }
};

// The 2-layer LSTM over S frames of NB streams with the decoder's running
// sum: in(s, t) is frame t of stream s (64 floats), wt[l] the layer's
// transposed weight [2H][4H], bias[l] its [4H]. Updates hs, cs in place and
// adds relu(h_top) of every frame to dec. Expects hs, cs, dec loaded and a
// barrier passed; ends on a barrier. This one function is the LSTM of every
// kernel that includes this header (the fused ones and lstm_decoder.cu), so
// on the same inputs they give the same bits.
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

// The v3 decoder on one stream's running sum dec_s [64] over S frames:
// sigmoid(mean_t relu(h_top) . dec_w1 + dec_b1), channel 1 of dec_w [2, 64].
__device__ float decode_prob(const float* dec_s, int S, const float* __restrict__ dec_w1,
                             float dec_b1) {
  float acc = 0.f;
  for (int u = 0; u < HIDDEN; ++u) acc = fmaf(dec_s[u] / S, __ldg(dec_w1 + u), acc);
  return sigmoidf(acc + dec_b1);
}

// Everything after the stage-1 input: the four encoder stages over A, the
// 2-layer LSTM over the last stage's frames, the decoder; stores probs [B]
// and hn, cn [2, B, 64] of the block's real streams. Expects A, hs, cs and
// dec loaded and a barrier passed.
__device__ void encode_lstm_decode(const float* __restrict__ W, const Offsets& o, const Block& m,
                                   int seq0, int b0, int batch, float* probs, float* hn,
                                   float* cn) {
  const int S = encode(W, o, m, seq0);
  const float* const wt[2] = {W + o.v[LSTM_WT0], W + o.v[LSTM_WT1]};
  const float* const bias[2] = {W + o.v[LSTM_B0], W + o.v[LSTM_B1]};
  lstm_decoder_steps(wt, bias, ActRows{Act{m.A, m.sa, pitch(HIDDEN)}}, S, m);

  const float* dec_w1 = W + o.v[DEC_W] + HIDDEN;
  const float dec_b1 = __ldg(W + o.v[DEC_B] + 1);
  for (int s = threadIdx.x; s < NB; s += blockDim.x) {
    if (b0 + s >= batch) continue;
    probs[b0 + s] = decode_prob(m.dec + s * HIDDEN, S, dec_w1, dec_b1);
  }
  store_state(m, b0, batch, hn, cn);
}

}  // namespace
