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
// (vadc_silero_v31_encode_audio) and then this kernel once. The state stays
// on the SM between chunks and is fp32 there as in global memory, so a
// K-chunk launch equals K launches of one chunk bit for bit.
//
// What bounds it on an H100: the bytes of x (B*K*T*256 B) are small and the
// FLOPs (2 x 128 x 256 multiply-adds per layer-step and stream) modest, so
// it is the chain of K*T*2 dependent layer-steps.
//
// It runs the resident-weights kernels of lstm_resident.cuh at every shape
// (the streaming-weights kernel it had for calls of one or two frames, which
// no model gives it, is gone): the recurrent weights stay on the SM for the
// whole launch, the input half of layer 0 is computed for all frames before
// the chain, and the two layers run as a wavefront. What bounds it then is
// in that header.
//
// Every sum keeps the order of the step kernels' LSTM
// (silero_v31_body.cuh: lstm_decoder_steps_hoisted, the same activations and
// cell update, the same dec / T then the decoder's chain), so on
// vadc_silero_v31_encode's output it equals the fused kernel bit for bit,
// at every tier. fp32 state, no --use_fast_math.
//
// Precision tiers (tier.cuh): an instance of each tier, the one that every
// slab and CLI window runs after the encoder's instance of the same tier.
// At balanced and fast the gate sums run on the tensor cores
// (lstm_mma.cuh); at faithful and turbo they are the CUDA-core fmaf chains
// (lstm_mma.cuh: v31_gates_on_mma), as in the step kernels' LSTM, so a slab
// equals the loop of steps at every tier.
#include <cuda_runtime.h>

#include "lstm_resident.cuh"

// x [batch, chunks, frames, 64]; h0, c0, hn, cn [2, batch, 64] (hn, cn may
// alias h0, c0); b [2, 256]; dec_w [2, 64]; dec_b [2]; probs [batch,
// chunks]; all contiguous fp32. wt: where the tier's gates run on the
// tensor cores the two layers' gate fragments (kernels/lstm.py:
// gate_fragments), else the transposed weight [2, 128, 256] packed for the
// tier's products; dec_w packed for `tier` (0 faithful, 1 balanced, 2 fast,
// 3 turbo). pre is scratch of pre_rows x 256 floats
// (pre_rows >= batch * frames; fewer rows than batch * chunks * frames make
// passes over whole chunks); `streams` the streams a block takes on the
// tensor cores (1 to 8); *launched receives the number of kernels it
// launched (the pre-pass and the recurrent kernel of every pass). Returns
// the first CUDA error of its launches.
extern "C" int vadc_lstm_decoder_fused_resident(
    const float* x, const float* h0, const float* c0, const float* wt, const float* b,
    const float* dec_w, const float* dec_b, float* pre, long long pre_rows, float* probs,
    float* hn, float* cn, int batch, int chunks, int frames, int tier, int streams, int* launched,
    void* stream) {
  *launched = 0;
  if (batch <= 0 || chunks <= 0 || frames <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return by_tier(tier, [&](auto t) {
    constexpr int T = decltype(t)::value;
    using resident::H2;
    return resident::run_in_passes<H2, T, resident::DecoderSum<T>::kMma>(
        x, h0, c0, wt, pre, pre_rows, hn, cn, batch, chunks * frames, frames,
        [=](int f0, int n, const float* h, const float* c) {
          const resident::DecoderSum<T> top{dec_w + H2, dec_b + 1, probs + f0 / frames, chunks,
                                            frames};
          return resident::launch_wavefront(pre, h, c, wt, b, hn, cn, batch, n, streams, top, s);
        },
        launched, s);
  });
}
