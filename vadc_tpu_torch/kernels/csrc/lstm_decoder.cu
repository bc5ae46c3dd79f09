// 2-layer LSTM with the v3 decoder folded in, over several chunks of each
// stream in order, in one launch.
//
// Replaces the Pallas kernel vadc_tpu/kernels/lstm.py: lstm_decoder_fused
// (pallas_call at :153, body _lstm_decoder_kernel). x [B, K, T, 64] is the
// encoder's output for K consecutive chunks of each of B streams, T frames a
// chunk (3..7); h0/c0 [2, B, 64]; the fused weight transposed to wt
// [2, 128, 256] (rows: the 64 inputs, then the 64 recurrent units; columns:
// gates i, f, g, o), b [2, 256]; dec_w [2, 64], dec_b [2]. For chunk k of a
// stream it walks the T frames through both layers, sums relu(h_top) over
// the frames, and gives probs[b, k] = sigmoid(mean . dec_w[1] + dec_b[1]);
// the state goes on into chunk k+1 and the sum starts again. hn, cn
// [2, B, 64] is the state after the last chunk. K = 1 is the Pallas kernel's
// function. hn/cn may alias h0/c0: a block reads its streams' state before
// it writes any, and blocks own disjoint streams.
//
// The K chunks are here because only the LSTM carries anything from chunk
// to chunk: the slab scan runs the encoder of every chunk of a slab at once
// (vadc_silero_v31_encode) and then this kernel once. The state stays in
// shared memory between chunks and is fp32 there as in global memory, so a
// K-chunk launch equals K launches of one chunk bit for bit.
//
// Two variants that give the same bits; kernels/lstm.py chooses between
// them from the shapes.
//
// What bounds it on an H100: the bytes of x (B*K*T*256 B) are small and the
// FLOPs (2 x 128 x 256 multiply-adds per layer-step and stream) modest, so
// it is the chain of K*T*2 dependent layer-steps.
//
// The streaming-weights variant (lstm_decoder_kernel,
// vadc_lstm_decoder_fused): the simple design of lstm.cu, the one that shares
// its device code with the fused kernels. NB = 4 streams a block, thread j
// owns gate column j and keeps NB sums in registers so each weight it reads
// serves NB streams, the weights stay in L2 (256 KB), x is read from global
// memory where it is used (a row serves all 256 threads through L1), 9 KB of
// shared memory for gates, state and the decoder's sum. A ragged last block
// reads its last real stream's rows again and stores only its real streams.
// Every layer-step waits on its layer's 128 KB of weights from L2, which
// only many blocks on an SM hide: over the K*T frames of a slab at few
// streams, or of the CLI's window at batch 1, that latency was all of its
// time. Since the resident variant it runs only calls of one or two frames,
// which no model gives it (a chunk has 3 to 7 frames): chip_smoke.py and the
// card's tests launch it at every shape as the witness of the bits.
//
// The resident-weights variant (vadc_lstm_decoder_fused_resident, the
// kernels of lstm_resident.cuh), for three frames and more: the recurrent
// weights stay on the SM for the whole launch, the input half of layer 0 is
// computed for all frames before the chain, and the two layers run as a
// wavefront. What bounds it then (the fmaf chains, the shared-memory pipe,
// the latency of the activations) is in that header.
//
// The LSTM steps and the decoder of the streaming variant are the device
// code of silero_v31_body.cuh that silero_v31_fused.cu runs after its
// encoder (same order of the two 64-term products, same sigmoid and tanh,
// the same dec / T then fmaf), and the resident variant keeps every sum's
// order, so either on vadc_silero_v31_encode's output equals the fused
// kernel bit for bit. fp32 state, no --use_fast_math.
//
// Precision tiers (tier.cuh): the resident variant has an instance of each
// tier, the one that every slab and CLI window runs after the encoder's
// instance of the same tier (the same products and tanh as the body's step
// LSTM, so a slab equals the loop of steps at every tier); the streaming
// variant is faithful only (kernels/lstm_decoder.py takes the resident one
// at the bf16 tiers).
#include <cuda_runtime.h>

#include "lstm_resident.cuh"
#include "silero_v31_body.cuh"

namespace {

// Frame t of chunk k of the block's stream s in x [batch, chunks, frames,
// 64]; a stream past the batch reads the last real one (never stored).
struct GlobalRows {
  const float* x;
  int b0;
  int batch;
  int chunks;
  int frames;
  int k;
  __device__ const float* operator()(int s, int t) const {
    const long long b = min(b0 + s, batch - 1);
    return x + ((b * chunks + k) * frames + t) * HIDDEN;
  }
};

__global__ void __launch_bounds__(THREADS)
lstm_decoder_kernel(const float* __restrict__ x, const float* h0, const float* c0,
                    const float* __restrict__ wt, const float* __restrict__ b,
                    const float* __restrict__ dec_w, const float* __restrict__ dec_b,
                    float* __restrict__ probs, float* hn, float* cn, int batch, int chunks,
                    int frames) {
  __shared__ float smem[NB * GATES + 5 * NB * HIDDEN];
  Block m;
  m.A = nullptr;
  m.H = nullptr;
  m.gates = smem;
  m.hs = m.gates + NB * GATES;
  m.cs = m.hs + 2 * NB * HIDDEN;
  m.dec = m.cs + 2 * NB * HIDDEN;
  m.wbuf = nullptr;
  m.sa = 0;
  m.sh = 0;
  const int b0 = blockIdx.x * NB;
  const int tid = threadIdx.x;
  const float* const wt_l[2] = {wt, wt + 2 * HIDDEN * GATES};
  const float* const bias_l[2] = {b, b + GATES};
  const float* dec_w1 = dec_w + HIDDEN;
  const float dec_b1 = __ldg(dec_b + 1);

  load_state(m, h0, c0, b0, batch);  // also zeroes dec
  __syncthreads();
  for (int k = 0; k < chunks; ++k) {
    lstm_decoder_steps(wt_l, bias_l, GlobalRows{x, b0, batch, chunks, frames, k}, frames, m);
    if (tid < NB) {
      if (b0 + tid < batch) {
        probs[static_cast<long long>(b0 + tid) * chunks + k] =
            decode_prob(m.dec + tid * HIDDEN, frames, dec_w1, dec_b1);
      }
    }
    __syncthreads();
    for (int i = tid; i < NB * HIDDEN; i += blockDim.x) m.dec[i] = 0.f;
    __syncthreads();
  }
  store_state(m, b0, batch, hn, cn);
}

}  // namespace

// x [batch, chunks, frames, 64]; h0, c0, hn, cn [2, batch, 64] (hn, cn may
// alias h0, c0); wt [2, 128, 256]; b [2, 256]; dec_w [2, 64]; dec_b [2];
// probs [batch, chunks]; all contiguous fp32. Returns cudaGetLastError()
// after the launch.
extern "C" int vadc_lstm_decoder_fused(const float* x, const float* h0, const float* c0,
                                       const float* wt, const float* b, const float* dec_w,
                                       const float* dec_b, float* probs, float* hn, float* cn,
                                       int batch, int chunks, int frames, void* stream) {
  if (batch <= 0 || chunks <= 0 || frames <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int grid = (batch + NB - 1) / NB;
  lstm_decoder_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      x, h0, c0, wt, b, dec_w, dec_b, probs, hn, cn, batch, chunks, frames);
  return static_cast<int>(cudaGetLastError());
}

// The same function by the resident-weights variant. Beyond
// vadc_lstm_decoder_fused: pre is scratch of pre_rows x 256 floats
// (pre_rows >= batch * frames; fewer rows than batch * chunks * frames make
// passes over whole chunks); *launched receives the number of kernels it
// launched (the pre-pass and the recurrent kernel of every pass); wt and
// dec_w are packed for `tier` (0 faithful, 1 balanced, 2 fast, 3 turbo).
// Returns the first CUDA error of its launches.
extern "C" int vadc_lstm_decoder_fused_resident(
    const float* x, const float* h0, const float* c0, const float* wt, const float* b,
    const float* dec_w, const float* dec_b, float* pre, long long pre_rows, float* probs,
    float* hn, float* cn, int batch, int chunks, int frames, int tier, int* launched,
    void* stream) {
  *launched = 0;
  if (batch <= 0 || chunks <= 0 || frames <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return by_tier(tier, [&](auto t) {
    constexpr int T = decltype(t)::value;
    return resident::run_in_passes<resident::H2, T>(
        x, h0, c0, wt, pre, pre_rows, hn, cn, batch, chunks * frames, frames,
        [=](int f0, int n, const float* h, const float* c) {
          const resident::DecoderSum<T> top{dec_w + HIDDEN, dec_b + 1, probs + f0 / frames, chunks,
                                            frames};
          return resident::launch_wavefront(pre, h, c, wt, b, hn, cn, batch, n, top, s);
        },
        launched, s);
  });
}
