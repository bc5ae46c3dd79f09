// The precision tiers as template parameters of the kernels (the v3.1 fused
// body, the spectrum tile, both variants of the LSTM), and the arithmetic of
// one product term at a tier. vadc_tpu_torch/nn/precision.py defines the
// tiers; the kernels' plain versions compute the same thing with torch ops.
//
//   tier      products       v3.1/v4 STFT    v5 STFT  tanh      log1p    encoder storage
//   faithful  fp32           fp32            fp32     exp form  series   fp32
//   balanced  bf16_3x        bf16_3x         bf16_3x  exp form  log1pf   fp32
//   fast      bf16 operands  bf16_3x         bf16     tanhf     log1pf   fp32
//   turbo     bf16 operands  bf16 operands   bf16     tanhf     log1pf   bf16
//
// Tier<T>::kStft is the log-sensitive (v3.1, v4) column; stft_mag.cu, which
// both families run, takes the product mode itself (by_mode), chosen by the
// wrapper (nn/precision.py: stft_mode).
//
// The v3.1 encoder's products at the bf16 tiers, the spectrum at bf16_3x
// and the LSTMs' gate sums (lstm_mma.cuh says which) run on the tensor
// cores (mma.cuh; silero_v31_body.cuh: linear_mma, stft_tile.cuh: TileMma):
// bf16 products summed in fp32, bf16_3x as three MMAs (lo*hi, hi*lo,
// hi*hi) from zero, added to the fp32 sum once a k step, their operands
// staged as bf16 planes or fragments. The rest of this account is the
// CUDA-core form, which the spectrum at bf16 operands (stft_tile.cuh says
// why), turbo's v3.1 LSTM and the decoder still take:
//
// A product term a * w adds to an fp32 sum by fmaf. At the bf16 tiers a is
// rounded to bf16 (nearest even) where it is read, and w was rounded when
// the wrapper packed it: a product of two bf16 values is exact in fp32, so
// one fmaf adds it with one rounding. bf16_3x splits both: hi = bf16(x), lo
// = bf16(x - hi) (x - hi is exact in fp32); the wrapper packs w's pair in
// one 32-bit word, hi in the upper half and lo in the lower, so a packed
// weight takes the bytes and the shared-memory staging of an fp32 one, and
// the term is three fmafs, hi*hi, hi*lo, lo*hi. At the bf16 tiers a weight's
// lower half is zero, so the word IS the bf16 value as a float. The faithful
// instance reads its fp32 weights as they are: its code is the code it was.
//
// Turbo stores the encoder's activations (the normalized features and each
// stage's results) as bf16 where the JAX package holds them in bf16: an fp32
// value rounded in place (store_at), in the same shared memory, never a
// second copy. The statistics of the softmax and the layer norms, the
// attention's two sums, the LSTM, the decoder and the state stay fp32.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace {

enum TierId : int { TIER_FAITHFUL = 0, TIER_BALANCED = 1, TIER_FAST = 2, TIER_TURBO = 3 };

// A product's operands: fp32, bf16_3x or bf16.
enum ProductMode : int { P_FP32 = 0, P_SPLIT = 1, P_BF16 = 2 };

template <int T>
struct Tier {
  static constexpr int kProducts = T == TIER_FAITHFUL ? P_FP32 : (T == TIER_BALANCED ? P_SPLIT : P_BF16);
  static constexpr int kStft = T == TIER_FAITHFUL ? P_FP32 : (T == TIER_TURBO ? P_BF16 : P_SPLIT);
  static constexpr bool kExpTanh = T == TIER_FAITHFUL || T == TIER_BALANCED;
  static constexpr bool kSeriesLog1p = T == TIER_FAITHFUL;
  static constexpr bool kStore = T == TIER_TURBO;
};

__device__ __forceinline__ float bf16_rn(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}
// the halves of a packed bf16_3x weight
__device__ __forceinline__ float packed_hi(float w) {
  return __uint_as_float(__float_as_uint(w) & 0xFFFF0000u);
}
__device__ __forceinline__ float packed_lo(float w) { return __uint_as_float(__float_as_uint(w) << 16); }

// An activation as an operand of mode M, split once and used for every
// weight it meets.
template <int M>
struct Operand {
  float hi;
  float lo;
  __device__ __forceinline__ explicit Operand(float a) {
    if constexpr (M == P_FP32) {
      hi = a;
      lo = 0.f;
    } else if constexpr (M == P_BF16) {
      hi = bf16_rn(a);
      lo = 0.f;
    } else {
      hi = bf16_rn(a);
      lo = bf16_rn(a - hi);
    }
  }
  // acc + this * w, w packed for mode M
  __device__ __forceinline__ float fma(float w, float acc) const {
    if constexpr (M == P_SPLIT) {
      const float wh = packed_hi(w);
      acc = fmaf(hi, wh, acc);
      acc = fmaf(hi, packed_lo(w), acc);
      return fmaf(lo, wh, acc);
    } else {
      return fmaf(hi, w, acc);
    }
  }
};

// f(std::integral_constant<int, T>{}) for the tier id's T: how a C entry
// point launches the instance of the tier it was given; an unknown id is
// cudaErrorInvalidValue.
template <class F>
int by_tier(int tier, F&& f) {
  switch (tier) {
    case TIER_FAITHFUL:
      return f(std::integral_constant<int, TIER_FAITHFUL>{});
    case TIER_BALANCED:
      return f(std::integral_constant<int, TIER_BALANCED>{});
    case TIER_FAST:
      return f(std::integral_constant<int, TIER_FAST>{});
    case TIER_TURBO:
      return f(std::integral_constant<int, TIER_TURBO>{});
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// f(std::integral_constant<int, M>{}) for the product mode's M: how a C
// entry point that takes a mode (the spectrum's operands, which depend on
// the family as well as the tier) launches its instance; an unknown mode is
// cudaErrorInvalidValue.
template <class F>
int by_mode(int mode, F&& f) {
  switch (mode) {
    case P_FP32:
      return f(std::integral_constant<int, P_FP32>{});
    case P_SPLIT:
      return f(std::integral_constant<int, P_SPLIT>{});
    case P_BF16:
      return f(std::integral_constant<int, P_BF16>{});
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// an encoder activation as tier T stores it
template <int T>
__device__ __forceinline__ float store_at(float x) {
  if constexpr (Tier<T>::kStore) {
    return bf16_rn(x);
  } else {
    return x;
  }
}

}  // namespace
