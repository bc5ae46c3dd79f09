// The LSTM gate sums of the bf16 tiers on the tensor cores: the one gate-sum
// function that every tensor-core instance of the port's LSTMs calls
// (lstm.cu's streaming kernel, lstm_resident.cuh's pre-pass and recurrent
// kernels, silero_v31_body.cuh's step LSTM), and the cell update from its
// result. Replaces the CUDA-core fmaf chains of the kernels that port
// vadc_tpu/kernels/lstm.py: lstm_fused at every bf16 tier, and of
// lstm_decoder_fused and the v3.1 step kernels' LSTM
// (vadc_tpu/kernels/silero_v31_fused.py: forward_fused) at balanced and
// fast (v31_gates_on_mma below); the faithful instances, and turbo's v3.1
// ones, keep those chains and their bits.
//
// Roles. A gate tile is 16 gate rows: the i, f, g and o rows of 4 units
// (tile m, row r: gate r / 4 of unit 4m + r % 4), so a layer of H units is
// H / 4 tiles. The weights are the A operand of mma.sync m16n8k16 (16 gate
// rows x 16 inputs a fragment) and the streams lie along N, one n8 tile of
// up to 8 streams: a block of the recurrent kernels holds 1 to 8 streams,
// and streams along M would leave most of 16 rows idle. The wrapper packs
// each layer's weight once per params object and tier
// (kernels/lstm.py: gate_fragments): for each tile m and k16 step ks (the
// H/16 input steps, then the H/16 recurrent steps) the 32 lanes' A
// fragments, four 32-bit words a lane, one plane of bf16 hi and, at
// bf16_3x, a second plane of lo = bf16(w - hi).
//
// Sums. A tile's sum over a range of k steps runs every k16 MMA from zero
// and adds its result to the fp32 sum once a k step (mma.cuh: mma_add,
// mma_add3, the small terms first at bf16_3x: lo*hi, hi*lo, hi*hi in one
// chain), the input steps first, then the recurrent ones, then the bias.
// An MMA's result for one (row, stream) depends only on that row's weights
// and that stream's 16 inputs, so every site that adds the same k steps in
// the same order gives the same bits: the pre-pass's input sums continued
// by a recurrent kernel equal the streaming kernel's, and the step
// kernel's LSTM equals lstm_decoder_fused's. Because each k step's MMA
// starts from zero the MMAs of one sum are independent and in flight
// together; only the fp32 adds stay serial, a chain of 2H / 16 adds where
// the CUDA-core form had a chain of 2H fmafs.
//
// Cells. Lane l of a warp (g = l / 4, t = l % 4) receives rows g and g + 8
// of the tile for streams 2t and 2t + 1. The sums of the real streams go to
// shared memory (store_gates), and after a barrier one thread a cell
// applies the activations and updates it (cell_from_gates; lstm_cell.cuh:
// the same activations and the same contraction of c as every other LSTM
// of the package). The lanes of a tile's warp hold all 8 columns of the n8
// tile, so updating the cells there would run the activations for the
// padding columns too, 7 of 8 at one stream a block.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "lstm_cell.cuh"
#include "mma.cuh"
#include "tier.cuh"

namespace {
namespace gate_mma {

constexpr int kFragWords = 128;  // one tile's A fragment at one k step: 32 lanes x 4 words
constexpr int kMaxStreams = 8;   // one n8 tile of streams

template <int H>
struct Geometry {
  static constexpr int kTiles = H / 4;         // gate tiles a layer
  static constexpr int kInSteps = H / 16;      // k16 steps of the input half
  static constexpr int kSteps = 2 * H / 16;    // the input steps, then the recurrent ones
  static constexpr int kPlaneWords = kTiles * kSteps * kFragWords;  // 4 H^2
};

// Which LSTMs of tier T sum their gates here. lstm_fused (v4, v5): every
// bf16 tier. The v3.1 LSTM (lstm_decoder_fused and the step kernels' LSTM,
// which must give each other's bits): balanced and fast; turbo keeps the
// CUDA-core fmaf chains, because on the tensor cores its
// lstm_decoder_fused probabilities broke kernels/tier_check.py's limit
// (PERF.md, PR 14).
template <int T>
__host__ __device__ constexpr bool v31_gates_on_mma() {
  return T == TIER_BALANCED || T == TIER_FAST;
}

// planes of a packed weight: bf16 hi, and lo at bf16_3x
template <int M>
__host__ __device__ constexpr int planes() {
  return M == P_SPLIT ? 2 : 1;
}

// the natural gate row (blocks i, f, g, o of H rows) of row r of tile m
template <int H>
__device__ __forceinline__ int gate_row(int m, int r) {
  return (r >> 2) * H + 4 * m + (r & 3);
}

__device__ __forceinline__ int lane_id() { return threadIdx.x & 31; }

// The A fragment of tile m at k step ks from a packed layer (plane 0 hi,
// plane 1 lo), where the 32 lanes' words lie together.
template <int H>
__device__ __forceinline__ uint4 frag_global(const float* layer, int plane, int m, int ks) {
  const float* at = layer + static_cast<long long>(plane) * Geometry<H>::kPlaneWords +
                    (m * Geometry<H>::kSteps + ks) * kFragWords;
  return __ldg(reinterpret_cast<const uint4*>(at) + lane_id());
}

// B fragments of one k16 step from fp32 activations: this lane's stream
// row (its column g = lane / 4 of the n8 tile), k0 the step's first input.
// Rounded (and split at bf16_3x) as they are read: the same bf16 values
// wherever a stream's activations are read. `row` may be null for a
// padding column: zeros.
template <int M>
__device__ __forceinline__ void b_frag(const float* row, int k0, uint32_t (&hi)[2],
                                       uint32_t (&lo)[2]) {
  const int t = lane_id() & 3;
  float2 v0 = make_float2(0.f, 0.f), v1 = v0;
  if (row != nullptr) {
    v0 = *reinterpret_cast<const float2*>(row + k0 + 2 * t);
    v1 = *reinterpret_cast<const float2*>(row + k0 + 8 + 2 * t);
  }
  if constexpr (M == P_SPLIT) {
    split_bf16x2(v0.x, v0.y, hi[0], lo[0]);
    split_bf16x2(v1.x, v1.y, hi[1], lo[1]);
  } else {
    hi[0] = pack_bf16x2(v0.x, v0.y);
    hi[1] = pack_bf16x2(v1.x, v1.y);
    lo[0] = lo[1] = 0u;
  }
}

// THE gate sum: acc (a tile's D fragment) += the products of N k steps, k
// step s's A fragment a(s, plane) and B fragment b(s, hi, lo), each MMA
// from zero and added once, in s order. Products of mode M (tier.cuh).
template <int M, int N, class A, class B>
__device__ __forceinline__ void gate_sum(float (&acc)[4], A a, B b) {
#pragma unroll
  for (int s = 0; s < N; ++s) {
    uint32_t bh[2], bl[2];
    b(s, bh, bl);
    const uint4 h = a(s, 0);
    const uint32_t ah[4] = {h.x, h.y, h.z, h.w};
    if constexpr (M == P_SPLIT) {
      const uint4 l = a(s, 1);
      const uint32_t al[4] = {l.x, l.y, l.z, l.w};
      mma_add3(acc, ah, al, bh, bl);
    } else {
      mma_add(acc, ah, bh);
    }
  }
}

// This lane's two bias values of tile m: rows g and g + 8.
struct TileBias {
  float lo, hi;
};

template <int H>
__device__ __forceinline__ TileBias tile_bias(const float* bias, int m) {
  const int g = lane_id() >> 2;
  return {__ldg(bias + gate_row<H>(m, g)), __ldg(bias + gate_row<H>(m, g + 8))};
}

// acc = 0 (or the four pre-summed input sums), the tile's bias added after
// the recurrent steps: d[0], d[1] are row g's, d[2], d[3] row g + 8's.
__device__ __forceinline__ void add_bias(float (&acc)[4], TileBias b) {
  acc[0] += b.lo;
  acc[1] += b.lo;
  acc[2] += b.hi;
  acc[3] += b.hi;
}


// The pitch of a stream's row of gate sums [4H] in shared memory: 4 floats
// more than a row, so that store_gates' lanes write at most two to a bank.
template <int H>
constexpr int kGatesLd = 4 * H + 4;

// Stores a tile's gate sums d (the bias added) of the real streams (columns
// below `streams`) to gates [stream][ld] in the natural gate order, where
// one thread a cell reads them (cell_from_gates).
template <int H>
__device__ __forceinline__ void store_gates(const float (&d)[4], float* gates, int ld, int m,
                                            int streams) {
  const int g = lane_id() >> 2;
  const int t = lane_id() & 3;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int s = 2 * t + (e & 1);
    if (s < streams) gates[s * ld + gate_row<H>(m, g + 8 * (e >> 1))] = d[e];
  }
}

// The cell update of unit u of a stream from its gate sums (`gates` the
// stream's row, gates i, f, g, o H apart): the tier's activations and
// lstm_cell, as every LSTM of the package. Updates c, returns the new h.
template <int T, int H>
__device__ __forceinline__ float cell_from_gates(const float* gates, int u, float& c) {
  return lstm_cell<T>(gate_activation<T>(0, gates[u]), gate_activation<T>(1, gates[H + u]),
                      gate_activation<T>(2, gates[2 * H + u]),
                      gate_activation<T>(3, gates[3 * H + u]), c);
}

}  // namespace gate_mma
}  // namespace
