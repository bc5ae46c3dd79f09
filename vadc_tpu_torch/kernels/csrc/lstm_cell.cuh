// The LSTM's activations, shared by every kernel of the package that runs an
// LSTM step (silero_v31_body.cuh, lstm.cu, lstm_resident.cuh), and the cell
// update of the resident-weights kernels, so that on the same gate sums all
// give the same bits.
//
// Numerics: sigmoid as 1/(1+expf(-x)) at every tier; tanh by the tier
// (tier.cuh): the accurate tanh of vadc_tpu/nn/functional.py accurate_tanh
// (the exp form) at faithful and balanced, tanhf at fast and turbo; fp32
// state, no --use_fast_math. The templates default to the faithful tier.
#pragma once

#include <cuda_runtime.h>

#include "tier.cuh"

namespace {

__device__ __forceinline__ float sigmoidf(float x) { return 1.f / (1.f + expf(-x)); }

__device__ __forceinline__ float accurate_tanhf(float x) {
  const float e = expf(-2.f * fabsf(x));
  const float r = (1.f - e) / (1.f + e);
  return x > 0.f ? r : (x < 0.f ? -r : 0.f);
}

// tier T's tanh
template <int T = TIER_FAITHFUL>
__device__ __forceinline__ float tanh_at(float x) {
  if constexpr (Tier<T>::kExpTanh) {
    return accurate_tanhf(x);
  } else {
    return tanhf(x);
  }
}

// Gate column `gate` (0 i, 1 f, 2 g, 3 o) of the sum z: tanh for g, sigmoid
// for the others.
template <int T = TIER_FAITHFUL>
__device__ __forceinline__ float gate_activation(int gate, float z) {
  return gate == 2 ? tanh_at<T>(z) : sigmoidf(z);
}

// One unit's cell update from its four activated gates: updates c, returns
// the new h. c_new is written out as the compiler contracts the step loops'
// `fg * c + ig * gg` (silero_v31_body.cuh, lstm.cu; read from their SASS,
// CUDA 12.8, sm_90a): the product fg * c rounded, then one fused
// multiply-add with ig * gg. Written with the operator it was contracted
// the other way round here, and c differed in its last bit.
template <int T = TIER_FAITHFUL>
__device__ __forceinline__ float lstm_cell(float ig, float fg, float gg, float og, float& c) {
  c = fmaf(ig, gg, __fmul_rn(fg, c));
  return og * tanh_at<T>(c);
}

}  // namespace
