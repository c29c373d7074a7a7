// The output epilogue of quant_matmul, shared by qmatmul.cuh (float x) and
// qmatmul_int8dot.cu (int8 x): csinn2_tpu/kernels/qmatmul.py _kernel :261-269
// and, for the fixed-point requantize, :247-260 with kernels/requant.py
// requant_int.
//
// Float epilogue, as the JAX kernel's compiled code rounds it (XLA on the
// CPU fuses the multiply before the bias add): v [· s[col]] [· e] [+ b[col]],
// where with a bias the last multiply and the add are one fmaf.  Then the
// cast: f32 / bf16 (round to nearest even); int8 / uint8 / int16 as
// clip(rint(v) + zp) (rint rounds half to even, as jnp.round); int32 as a
// plain cast (truncation).
//
// Fixed-point requantize (gemmlowp SRDHM + rounding divide by 2^right, the
// chain of core.quant.requantize_int) in 64-bit integers.
#pragma once

#include <climits>

#include "common.cuh"

enum OutKind : int { OUT_F32 = 0, OUT_BF16 = 1, OUT_I8 = 2, OUT_U8 = 3, OUT_I16 = 4, OUT_I32 = 5 };

struct Epi {
  const float* ch_scale;   // [N] channel scales, or null
  const float* bias;       // [N] f32, or null
  float e;                 // epilogue scale (applied when has_e)
  int has_e;
  float zp;                // output zero point of the integer outputs
  int out_kind;            // OutKind
};

// epi_float of a column whose channel scale s and bias b are loaded already
// (each read only when ep has it)
__device__ __forceinline__ float epi_float_col(float v, float s, float b, const Epi& ep) {
  const bool ch = ep.ch_scale != nullptr;
  if (ep.bias == nullptr) {
    if (ch) v *= s;
    if (ep.has_e) v *= ep.e;
    return v;
  }
  if (ch && ep.has_e) return fmaf(v * s, ep.e, b);
  if (ch) return fmaf(v, s, b);
  if (ep.has_e) return fmaf(v, ep.e, b);
  return v + b;
}

__device__ __forceinline__ float epi_float(float v, int col, const Epi& ep) {
  return epi_float_col(v, ep.ch_scale != nullptr ? ep.ch_scale[col] : 1.f,
                       ep.bias != nullptr ? ep.bias[col] : 0.f, ep);
}

__device__ __forceinline__ float clip_round(float v, float zp, float lo, float hi) {
  return fminf(fmaxf(rintf(v) + zp, lo), hi);
}

// out[idx] = v (already through epi_float), cast to the output kind
__device__ __forceinline__ void store_kind(void* out, size_t idx, float v, const Epi& ep) {
  switch (ep.out_kind) {
    case OUT_F32: static_cast<float*>(out)[idx] = v; break;
    case OUT_BF16: static_cast<__nv_bfloat16*>(out)[idx] = __float2bfloat16_rn(v); break;
    case OUT_I8:
      static_cast<int8_t*>(out)[idx] = static_cast<int8_t>(clip_round(v, ep.zp, -128.f, 127.f));
      break;
    case OUT_U8:
      static_cast<uint8_t*>(out)[idx] = static_cast<uint8_t>(clip_round(v, ep.zp, 0.f, 255.f));
      break;
    case OUT_I16:
      static_cast<int16_t*>(out)[idx] =
          static_cast<int16_t>(clip_round(v, ep.zp, -32768.f, 32767.f));
      break;
    default: static_cast<int32_t*>(out)[idx] = __float2int_rz(v); break;
  }
}

// core.quant.requantize_int on one int32 accumulator (bias already added),
// without a branch: the saturating left shift; SRDHM, whose nudge and
// truncating division by 2^31 come to (x·mult + 2^30) >> 31 for either sign
// of the product (an arithmetic shift); the rounding right shift in 32-bit
// integers, whose result past a shift of 31 is 0 (-1 for INT_MIN >> 32).
__device__ __forceinline__ int requant_fixed(int acc, int mult, int shift, int zp, int qmin,
                                             int qmax) {
  const int left = shift > 0 ? shift : 0, right = shift < 0 ? -shift : 0;
  const long long v = static_cast<long long>(acc) << (left & 63);
  const int x = v < INT_MIN ? INT_MIN : (v > INT_MAX ? INT_MAX : static_cast<int>(v));
  const long long h = (static_cast<long long>(x) * mult + (1LL << 30)) >> 31;
  const int y = h > INT_MAX ? INT_MAX : static_cast<int>(h);      // h >= INT_MIN
  const int r = right < 31 ? right : 31;
  const int mask = static_cast<int>((1u << r) - 1u);
  const int threshold = (mask >> 1) + (y < 0 ? 1 : 0);
  int z = (y >> r) + ((y & mask) > threshold ? 1 : 0);
  if (right > 31) z = right == 32 && y == INT_MIN ? -1 : 0;
  z += zp;
  return z < qmin ? qmin : (z > qmax ? qmax : z);
}
