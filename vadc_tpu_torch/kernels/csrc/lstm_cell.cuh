// The LSTM's activations, shared by every kernel of the package that runs an
// LSTM step (silero_v31_body.cuh, lstm.cu, lstm_resident.cuh), and the cell
// update of the resident-weights kernels, so that on the same gate sums all
// give the same bits.
//
// Numerics are the faithful tier's: sigmoid as 1/(1+expf(-x)), the accurate
// tanh of vadc_tpu/nn/functional.py accurate_tanh (the exp form), fp32, no
// --use_fast_math.
#pragma once

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float sigmoidf(float x) { return 1.f / (1.f + expf(-x)); }

__device__ __forceinline__ float accurate_tanhf(float x) {
  const float e = expf(-2.f * fabsf(x));
  const float r = (1.f - e) / (1.f + e);
  return x > 0.f ? r : (x < 0.f ? -r : 0.f);
}

// Gate column `gate` (0 i, 1 f, 2 g, 3 o) of the sum z: tanh for g, sigmoid
// for the others.
__device__ __forceinline__ float gate_activation(int gate, float z) {
  return gate == 2 ? accurate_tanhf(z) : sigmoidf(z);
}

// One unit's cell update from its four activated gates: updates c, returns
// the new h. c_new is written out as the compiler contracts the step loops'
// `fg * c + ig * gg` (silero_v31_body.cuh, lstm.cu; read from their SASS,
// CUDA 12.8, sm_90a): the product fg * c rounded, then one fused
// multiply-add with ig * gg. Written with the operator it was contracted
// the other way round here, and c differed in its last bit.
__device__ __forceinline__ float lstm_cell(float ig, float fg, float gg, float og, float& c) {
  c = fmaf(ig, gg, __fmul_rn(fg, c));
  return og * accurate_tanhf(c);
}

}  // namespace
