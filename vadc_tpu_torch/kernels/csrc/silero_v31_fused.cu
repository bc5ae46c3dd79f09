// Silero v3.1 encoder + 2-layer LSTM + v3 decoder in one kernel.
//
// Replaces the Pallas kernels vadc_tpu/kernels/silero_v31_fused2d.py:
// forward_fused2d (pallas_call at :270) and
// vadc_tpu/kernels/silero_v31_fused3d.py: forward_fused3d (pallas_call at
// :211). The two compute the same function and differ only in what the TPU
// compiler of their day could lower (2-D selection matmuls and block-diagonal
// attention vs batched 3-D dots); here one kernel serves both entry points.
//
// Input: normalized features x [B, S0, 129] (S0 = 9..25 frames for 512..1536
// sample chunks), LSTM state h, c [2, B, 64]. Output: probs [B], hn, cn
// [2, B, 64]. hn/cn may alias h/c: a block reads its streams' state before
// it writes any of it, and blocks own disjoint streams.
//
// The encoder, LSTM and decoder are the device code of silero_v31_body.cuh,
// which silero_v31_fused_audio.cu shares; its header says what they compute.
//
// What bounds it on an H100: not FLOPs (about 1.05 M multiply-adds per stream
// at 25 frames, 44 % of them in the LSTM: 4.3 GFLOP at batch 2048, on the
// CUDA cores: the faithful tier keeps fp32 products, no TF32; the tensor
// cores come with the bf16 tiers, where the tier itself moves the bound) but
// the latency of a chain of dependent small steps. Streams are independent,
// so a block takes NB = 4 streams and walks every stage and every LSTM step
// for them with all activations in shared memory (a stream's stage-1 input
// alone is 25 x 129 x 4 = 12.9 KB); the weights come through shared memory
// and registers. silero_v31_body.cuh's header says how. The batch does not
// have to divide by NB: a ragged last block computes on zero rows and stores
// only its real streams.
//
// A second entry, vadc_silero_v31_encode, runs the four encoder stages alone
// and stores the last stage's output [R, T, 64] (T = 3..7 frames). It
// replaces no Pallas kernel (the JAX package leaves its encoder to XLA); it
// feeds lstm_decoder.cu on the slab route, where the encoders of all the
// chunks of a slab run at once and only the LSTM walks them in order. It
// stages and computes exactly as the full kernel does, so its rows equal
// what the full kernel hands its own LSTM.

#include <cuda_runtime.h>

#include <cstring>

#include "silero_v31_body.cuh"

namespace {

// stage-1 input of the block's streams into region A: rows of 129 floats,
// pitch(129) = 129, so a stream's features are one contiguous run; zeros
// past the batch. No barrier (the encoder passes one first).
__device__ void load_features(const Block& m, const float* __restrict__ x, int b0, int batch,
                              int seq0) {
  const int n_in = seq0 * N_FEAT;
  const FastDiv by_in(n_in);
  for (int i = threadIdx.x; i < NB * n_in; i += blockDim.x) {
    const int s = by_in.div(i);
    const int r = i - s * n_in;
    m.A[s * m.sa + r] = b0 + s < batch ? x[static_cast<long long>(b0 + s) * n_in + r] : 0.f;
  }
}

__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
silero_v31_fused_kernel(const float* __restrict__ W, const __grid_constant__ Offsets o,
                        const float* __restrict__ x, const float* h0, const float* c0,
                        float* probs, float* hn, float* cn, int batch, int seq0,
                        int sa, int sh) {
  extern __shared__ __align__(16) float smem[];
  const Block m = carve(smem, sa, sh);
  const int b0 = blockIdx.x * NB;
  load_features(m, x, b0, batch, seq0);
  load_state(m, h0, c0, b0, batch);
  encode_lstm_decode(W, o, m, seq0, b0, batch, probs, hn, cn);
}

__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
silero_v31_encode_kernel(const float* __restrict__ W, const __grid_constant__ Offsets o,
                         const float* __restrict__ x,
                         float* __restrict__ y, int rows, int seq0, int sa, int sh) {
  extern __shared__ __align__(16) float smem[];
  const Block m = carve(smem, sa, sh);
  const int b0 = blockIdx.x * NB;
  load_features(m, x, b0, rows, seq0);
  const int S = encode(W, o, m, seq0);
  store_encoded(m, S, b0, rows, y);
}

// The dynamic shared memory of a block at seq0 frames, raised as the
// kernel's limit; *err says whether the card took it.
template <class Kernel>
size_t prepare(Kernel kernel, int seq0, int* sa, int* sh, cudaError_t* err) {
  plan(seq0, sa, sh);
  const size_t bytes = static_cast<size_t>(block_floats(*sa, *sh)) * sizeof(float);
  *err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
  return bytes;
}

}  // namespace

// weights: the packed fp32 buffer; offsets: host int32[n_offsets] (N_SLOTS
// entries, -1 for an absent projection); x [batch, seq0, 129]; h, c, hn, cn
// [2, batch, 64] (hn, cn may alias h, c); probs [batch]. Returns
// cudaGetLastError() after the launch.
extern "C" int vadc_silero_v31_fused(const float* weights, const int* offsets,
                                     int n_offsets, const float* x, const float* h,
                                     const float* c, float* probs, float* hn, float* cn,
                                     int batch, int seq0, void* stream) {
  if (n_offsets != N_SLOTS || batch <= 0 || seq0 < MIN_SEQ0 || seq0 > MAX_SEQ0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Offsets o;
  std::memcpy(o.v, offsets, sizeof(o.v));
  int sa = 0, sh = 0;
  cudaError_t err;
  const size_t bytes = prepare(silero_v31_fused_kernel, seq0, &sa, &sh, &err);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = (batch + NB - 1) / NB;
  silero_v31_fused_kernel<<<grid, THREADS, bytes, static_cast<cudaStream_t>(stream)>>>(
      weights, o, x, h, c, probs, hn, cn, batch, seq0, sa, sh);
  return static_cast<int>(cudaGetLastError());
}

// The encoder alone: x [rows, seq0, 129] -> y [rows, T, 64], T the frame
// count after the strides 2, 2, 1, 1 (3..7). weights and offsets as above.
// Returns cudaGetLastError() after the launch.
extern "C" int vadc_silero_v31_encode(const float* weights, const int* offsets, int n_offsets,
                                      const float* x, float* y, int rows, int seq0,
                                      void* stream) {
  if (n_offsets != N_SLOTS || rows <= 0 || seq0 < MIN_SEQ0 || seq0 > MAX_SEQ0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Offsets o;
  std::memcpy(o.v, offsets, sizeof(o.v));
  int sa = 0, sh = 0;
  cudaError_t err;
  const size_t bytes = prepare(silero_v31_encode_kernel, seq0, &sa, &sh, &err);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = (rows + NB - 1) / NB;
  silero_v31_encode_kernel<<<grid, THREADS, bytes, static_cast<cudaStream_t>(stream)>>>(
      weights, o, x, y, rows, seq0, sa, sh);
  return static_cast<int>(cudaGetLastError());
}
