// The batched decode step's attention prologue, one launch a layer: RoPE on
// the q and k heads, the new K and V rows quantised to the int8 cache (or
// kept as bf16 in a bf16 cache) and stored at each lane's own position.
//
// decode_prologue_launch — replaces no TPU kernel.  The JAX engine's
//   batched decode (csinn2_tpu/llm/engine.py) writes RoPE, the K/V
//   quantisation and the per-lane scatter as XLA ops, which XLA fuses; run
//   op by op in PyTorch they were ~25 kernels a layer (the plain version,
//   llm/model.py decode_prologue_ref: rope_rotate, quantize_kv, a gather, a
//   where and an index_put for each of K and V).
//
// Bound: bytes.  A read of the q|k|v heads (bf16) and the step's cos / sin
//   tables (f32), a write of q (bf16) and of one K and one V row a lane
//   (int8 or bf16): 0.36 MB at b = 16, GQA 32/8, d = 128, about 0.1 us at
//   3.35 TB/s.  At that size the launch is the cost, so the design is the
//   fewest steps: one thread a (lane, head, pair of the head dim), 128 a CTA,
//   nothing staged in shared memory, no barrier; the grid is (pairs of the
//   hq + 2 hk heads / 128, lanes).  Loads and stores are element by element,
//   so any even d and any strides of the inputs and the cache work; a warp
//   still reads and writes 64 neighbouring elements.
//
// Arithmetic, bit for bit the plain version as PyTorch runs it on the card:
//   each product and the difference / sum of rope_rotate rounded on its own
//   (no FMA contraction: __fmul_rn, __fsub_rn, __fadd_rn), the rotated pair
//   rounded to bf16 (round to nearest even); quantize_kv's `t.float() /
//   scale` is, for a Python float scale on a CUDA tensor, PyTorch's product
//   with the scale's reciprocal taken in double and rounded to f32 (the
//   wrapper passes that reciprocal; an f32 division, or the f32 reciprocal
//   of the f32 scale, differ in the last bit at some scales), then rintf
//   (half to even), a clamp to ±127 and the int8 cast.  A lane at pos >= S
//   writes no K/V row (the JAX scatter's mode="drop"); its q is still
//   written.

#include "common.cuh"

namespace {

constexpr int PRO_THREADS = 128;

__device__ __forceinline__ int8_t quant_kv(__nv_bfloat16 x, float inv_scale) {
  const float r = fminf(fmaxf(rintf(__fmul_rn(__bfloat162float(x), inv_scale)), -127.f), 127.f);
  return static_cast<int8_t>(static_cast<int>(r));
}

__device__ __forceinline__ void put_pair(int8_t* dst, __nv_bfloat16 a, __nv_bfloat16 b,
                                         float inv_scale) {
  dst[0] = quant_kv(a, inv_scale);
  dst[1] = quant_kv(b, inv_scale);
}

__device__ __forceinline__ void put_pair(__nv_bfloat16* dst, __nv_bfloat16 a, __nv_bfloat16 b,
                                         float) {
  dst[0] = a;
  dst[1] = b;
}

// qk: the q|k heads [b, hq + hk, d] (lane stride qk_sb, head stride qk_sh);
// v: [b, hk, d]; cos_t / sin_t: [b, d / 2] f32; q_out: [b, hq, d] bf16,
// contiguous; k_cache / v_cache: one layer of the cache, [>= b, S, hk, d]
// through (lane, row, head) strides c_sb, c_ss, c_sh.
template <typename KV>
__global__ void __launch_bounds__(PRO_THREADS)
decode_prologue_kernel(const __nv_bfloat16* __restrict__ qk, long long qk_sb, long long qk_sh,
                       const __nv_bfloat16* __restrict__ v, long long v_sb, long long v_sh,
                       const float* __restrict__ cos_t, const float* __restrict__ sin_t,
                       const int* __restrict__ pos, __nv_bfloat16* __restrict__ q_out,
                       KV* __restrict__ k_cache, KV* __restrict__ v_cache, long long c_sb,
                       long long c_ss, long long c_sh, int S, int hq, int hk, int d,
                       float inv_scale) {
  const int half = d / 2;
  const long long lane = blockIdx.y;
  const long long i = static_cast<long long>(blockIdx.x) * PRO_THREADS + threadIdx.x;
  if (i >= static_cast<long long>(hq + 2 * hk) * half) return;
  const int h = static_cast<int>(i / half), j = static_cast<int>(i % half);
  const int p = pos[lane];
  const bool store = p >= 0 && p < S;
  const long long row = lane * c_sb + p * c_ss + 2 * j;
  if (h >= hq + hk) {                              // v: stored as it is
    if (store) {
      const __nv_bfloat16* src = v + lane * v_sb + (h - hq - hk) * v_sh + 2 * j;
      put_pair(v_cache + row + (h - hq - hk) * c_sh, src[0], src[1], inv_scale);
    }
    return;
  }
  const __nv_bfloat16* src = qk + lane * qk_sb + h * qk_sh + 2 * j;
  const float x0 = __bfloat162float(src[0]), x1 = __bfloat162float(src[1]);
  const float c = cos_t[lane * half + j], s = sin_t[lane * half + j];
  const __nv_bfloat16 r0 = __float2bfloat16_rn(__fsub_rn(__fmul_rn(x0, c), __fmul_rn(x1, s)));
  const __nv_bfloat16 r1 = __float2bfloat16_rn(__fadd_rn(__fmul_rn(x0, s), __fmul_rn(x1, c)));
  if (h < hq) {
    __nv_bfloat16* dst = q_out + (lane * hq + h) * d + 2 * j;
    dst[0] = r0;
    dst[1] = r1;
  } else if (store) {
    put_pair(k_cache + row + (h - hq) * c_sh, r0, r1, inv_scale);
  }
}

}  // namespace

// kv_int8: the cache holds int8 carriers (quantised by inv_scale, the
// reciprocal of the cache's scale as PyTorch takes it), else bf16.  d even; b lanes of the
// cache's first b.  Returns cudaGetLastError() after the launch.
extern "C" int decode_prologue_launch(const void* qk, long long qk_sb, long long qk_sh,
                                      const void* v, long long v_sb, long long v_sh,
                                      const float* cos_t, const float* sin_t, const int* pos,
                                      void* q_out, void* k_cache, void* v_cache, long long c_sb,
                                      long long c_ss, long long c_sh, int b, int S, int hq,
                                      int hk, int d, int kv_int8, float inv_scale,
                                      void* stream) {
  if (b < 1 || b > 65535 || S < 1 || hq < 1 || hk < 1 || d < 2 || d % 2 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long pairs = static_cast<long long>(hq + 2 * hk) * (d / 2);
  const dim3 grid(static_cast<unsigned>((pairs + PRO_THREADS - 1) / PRO_THREADS),
                  static_cast<unsigned>(b));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* qk_b = static_cast<const __nv_bfloat16*>(qk);
  const auto* v_b = static_cast<const __nv_bfloat16*>(v);
  auto* q_b = static_cast<__nv_bfloat16*>(q_out);
  if (kv_int8) {
    decode_prologue_kernel<int8_t><<<grid, PRO_THREADS, 0, st>>>(
        qk_b, qk_sb, qk_sh, v_b, v_sb, v_sh, cos_t, sin_t, pos, q_b,
        static_cast<int8_t*>(k_cache), static_cast<int8_t*>(v_cache), c_sb, c_ss, c_sh, S, hq,
        hk, d, inv_scale);
  } else {
    decode_prologue_kernel<__nv_bfloat16><<<grid, PRO_THREADS, 0, st>>>(
        qk_b, qk_sb, qk_sh, v_b, v_sb, v_sh, cos_t, sin_t, pos, q_b,
        static_cast<__nv_bfloat16*>(k_cache), static_cast<__nv_bfloat16*>(v_cache), c_sb, c_ss,
        c_sh, S, hq, hk, d, inv_scale);
  }
  return static_cast<int>(cudaGetLastError());
}
