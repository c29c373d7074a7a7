// Attention kernels for Hopper (sm_90a) over an int8 (or bf16) KV cache.
//
// decode_attention_launch — replaces csinn2_tpu/kernels/flash_attention.py
//   decode_attention → _decode_attn_kernel: one query per (row, query head)
//   over the row's whole KV window [0, kv_len), exact two-pass softmax.
//   One CTA per (query head, row).  Bound: the K/V bytes (2·S·d per head),
//   read once; warps take whole keys so each key row is one coalesced read.
//
// attention_fwd_launch — replaces prefill_attention → _prefill_attn_kernel
//   and flash_attention (bshd) → _attn_kernel: causal (or not) attention with
//   per-row q_offset / kv_len, GQA head map h / (hq / hk), online softmax
//   over 32-key tiles.  One CTA per (32-query block, query head, row); keys
//   past the block's last causal position are never read.  Bound: at 7B
//   prefill the QK and PV flops (4·sq·S·d per head, halved by causality);
//   this SIMT f32 kernel trades speed for the reference's f32 numerics, and
//   tensor-core (wgmma) tiles are later work.
//
// Both fold kv_scale as the TPU kernels do: into the QK scale (qk_scale) and
// into the PV epilogue (out_scale).  A row whose softmax denominator is 0
// (kv_len == 0, or every key masked) outputs 0, never NaN.
//
// K/V are read through (batch, head, seq) strides with a contiguous last dim,
// so the cache's [b, S, hk, d] layout is consumed in place (no transpose).
#include "common.cuh"

namespace {

constexpr float NEG_INF = -1e30f;

// four consecutive K/V elements as f32 (8-bit: one 4-byte load; bf16: 8 bytes)
__device__ __forceinline__ void load4(const int8_t* p, float f[4]) {
  const char4 c = *reinterpret_cast<const char4*>(p);
  f[0] = c.x; f[1] = c.y; f[2] = c.z; f[3] = c.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float f[4]) {
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(p);
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(p + 2);
  f[0] = __low2float(a); f[1] = __high2float(a);
  f[2] = __low2float(b); f[3] = __high2float(b);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

constexpr int DEC_THREADS = 256;
constexpr int DEC_WARPS = DEC_THREADS / 32;
constexpr int DEC_MAX_D = 256;

// Block-wide reduction through `scratch` (DEC_WARPS floats); every thread
// gets the result.
template <bool IS_MAX>
__device__ float block_reduce(float v, float* scratch) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  v = IS_MAX ? warp_max(v) : warp_sum(v);
  __syncthreads();
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  float r = scratch[0];
  for (int i = 1; i < DEC_WARPS; ++i) r = IS_MAX ? fmaxf(r, scratch[i]) : r + scratch[i];
  return r;
}

template <typename KV>
__global__ void __launch_bounds__(DEC_THREADS)
decode_attn_kernel(const __nv_bfloat16* __restrict__ q, long long q_sb, long long q_sh,
                   const KV* __restrict__ k, long long k_sb, long long k_sh, long long k_ss,
                   const KV* __restrict__ v, long long v_sb, long long v_sh, long long v_ss,
                   const int* __restrict__ kv_len,        // [b]
                   __nv_bfloat16* __restrict__ out,       // [b, hq, d]
                   int hq, int hk, int S, int d, float qk_scale, float out_scale) {
  extern __shared__ float smem[];
  float* qs = smem;                        // [d] scaled query
  float* sc = qs + d;                      // [S] scores, then probabilities
  float* part = sc + S;                    // [DEC_WARPS, d] PV partial sums
  float* scratch = part + DEC_WARPS * d;   // [DEC_WARPS]

  const int h = blockIdx.x, bi = blockIdx.y;
  const int hkid = h / (hq / hk);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int L = max(0, min(kv_len[bi], S));
  const __nv_bfloat16* qrow = q + bi * q_sb + h * q_sh;
  const KV* kb = k + bi * k_sb + hkid * k_sh;
  const KV* vb = v + bi * v_sb + hkid * v_sh;

  for (int c = threadIdx.x; c < d; c += DEC_THREADS)
    qs[c] = __bfloat162float(qrow[c]) * qk_scale;
  __syncthreads();

  // scores: one warp per key, four dims per lane
  float local_max = NEG_INF;
  for (int j = warp; j < L; j += DEC_WARPS) {
    float dot = 0.f;
    for (int c = lane * 4; c < d; c += 128) {
      float f[4];
      load4(kb + j * k_ss + c, f);
      dot += qs[c] * f[0] + qs[c + 1] * f[1] + qs[c + 2] * f[2] + qs[c + 3] * f[3];
    }
    dot = warp_sum(dot);
    if (lane == 0) sc[j] = dot;
    local_max = fmaxf(local_max, dot);
  }
  const float m = block_reduce<true>(local_max, scratch);  // syncs: sc visible

  float local_sum = 0.f;
  for (int j = threadIdx.x; j < L; j += DEC_THREADS) {
    const float p = expf(sc[j] - m);
    sc[j] = p;
    local_sum += p;
  }
  const float l = block_reduce<false>(local_sum, scratch);  // syncs: p visible

  // PV: one warp per key, four dims per lane
  float acc[DEC_MAX_D / 128][4] = {};
  for (int j = warp; j < L; j += DEC_WARPS) {
    const float p = sc[j];
#pragma unroll
    for (int t = 0; t < DEC_MAX_D / 128; ++t) {
      const int c = lane * 4 + t * 128;
      if (c < d) {
        float f[4];
        load4(vb + j * v_ss + c, f);
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[t][e] += p * f[e];
      }
    }
  }
#pragma unroll
  for (int t = 0; t < DEC_MAX_D / 128; ++t) {
    const int c = lane * 4 + t * 128;
    if (c < d)
#pragma unroll
      for (int e = 0; e < 4; ++e) part[warp * d + c + e] = acc[t][e];
  }
  __syncthreads();
  const float inv = 1.f / fmaxf(l, 1e-30f);
  __nv_bfloat16* orow = out + ((size_t)bi * hq + h) * d;
  for (int c = threadIdx.x; c < d; c += DEC_THREADS) {
    float sum = 0.f;
    for (int w = 0; w < DEC_WARPS; ++w) sum += part[w * d + c];
    orow[c] = __float2bfloat16_rn(sum * out_scale * inv);
  }
}

constexpr int FWD_THREADS = 256;
constexpr int BQ = 32;    // queries per CTA: 8 threads per query row
constexpr int BKV = 32;   // keys per tile

template <int D>
constexpr size_t fwd_smem_bytes() {
  return sizeof(float) * (BQ * (D + 1) + D * (BKV + 1) + BKV * D + BQ * (BKV + 1));
}

template <int D, typename KV>
__global__ void __launch_bounds__(FWD_THREADS)
attn_fwd_kernel(const __nv_bfloat16* __restrict__ q, long long q_sb, long long q_ss, long long q_sh,
                const KV* __restrict__ k, long long k_sb, long long k_sh, long long k_ss,
                const KV* __restrict__ v, long long v_sb, long long v_sh, long long v_ss,
                const int* __restrict__ q_offset, const int* __restrict__ kv_len,
                __nv_bfloat16* __restrict__ out, long long o_sb, long long o_ss, long long o_sh,
                int sq, int hq, int hk, int S, int causal, float qk_scale, float out_scale) {
  extern __shared__ float smem[];
  float* Qs = smem;                       // [BQ][D+1]  scaled queries
  float* Kt = Qs + BQ * (D + 1);          // [D][BKV+1] key tile, transposed
  float* Vs = Kt + D * (BKV + 1);         // [BKV][D]   value tile
  float* Ps = Vs + BKV * D;               // [BQ][BKV+1] probabilities

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, bi = blockIdx.z;
  const int hkid = h / (hq / hk);
  const int tid = threadIdx.x;
  const int r = tid / 8, c = tid % 8;     // query row r, lane c of its 8
  const int qoff = q_offset[bi];
  const int L = max(0, min(kv_len[bi], S));
  const int qpos = qoff + q0 + r;

  const __nv_bfloat16* qb = q + bi * q_sb + h * q_sh;
  for (int idx = tid; idx < BQ * D; idx += FWD_THREADS) {
    const int rr = idx / D, cc = idx % D;
    const int qi = q0 + rr;
    Qs[rr * (D + 1) + cc] = qi < sq ? __bfloat162float(qb[qi * q_ss + cc]) * qk_scale : 0.f;
  }
  int kend = L;
  if (causal) kend = min(kend, qoff + min(q0 + BQ, sq));

  const KV* kb = k + bi * k_sb + hkid * k_sh;
  const KV* vb = v + bi * v_sb + hkid * v_sh;
  float m = NEG_INF, l = 0.f;
  float acc[D / 8];
#pragma unroll
  for (int t = 0; t < D / 8; ++t) acc[t] = 0.f;

  for (int kt = 0; kt < kend; kt += BKV) {
    __syncthreads();   // previous tile fully consumed (and Qs written)
    for (int idx = tid; idx < BKV * D; idx += FWD_THREADS) {
      const int j = idx / D, cc = idx % D;
      const int kj = kt + j;
      const bool ok = kj < L;
      Kt[cc * (BKV + 1) + j] = ok ? to_float(kb[kj * k_ss + cc]) : 0.f;
      Vs[j * D + cc] = ok ? to_float(vb[kj * v_ss + cc]) : 0.f;
    }
    __syncthreads();

    float sv[BKV / 8];
#pragma unroll
    for (int i = 0; i < BKV / 8; ++i) sv[i] = 0.f;
#pragma unroll 4
    for (int dd = 0; dd < D; ++dd) {
      const float qv = Qs[r * (D + 1) + dd];
#pragma unroll
      for (int i = 0; i < BKV / 8; ++i) sv[i] = fmaf(qv, Kt[dd * (BKV + 1) + c + 8 * i], sv[i]);
    }
    bool valid[BKV / 8];
    float mx = NEG_INF;
#pragma unroll
    for (int i = 0; i < BKV / 8; ++i) {
      const int kpos = kt + c + 8 * i;
      valid[i] = kpos < L && (!causal || kpos <= qpos);
      sv[i] = valid[i] ? sv[i] : NEG_INF;
      mx = fmaxf(mx, sv[i]);
    }
    // the 8 threads of a row are 8 consecutive lanes of one warp
#pragma unroll
    for (int o = 4; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    const float m_new = fmaxf(m, mx);
    const float alpha = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int i = 0; i < BKV / 8; ++i) {
      const float p = valid[i] ? expf(sv[i] - m_new) : 0.f;
      Ps[r * (BKV + 1) + c + 8 * i] = p;
      psum += p;
    }
#pragma unroll
    for (int o = 4; o > 0; o >>= 1) psum += __shfl_xor_sync(0xffffffffu, psum, o);
    l = l * alpha + psum;
    m = m_new;
    __syncwarp();      // Ps row r is written and read by the same 8 lanes

#pragma unroll
    for (int t = 0; t < D / 8; ++t) acc[t] *= alpha;
#pragma unroll 4
    for (int j = 0; j < BKV; ++j) {
      const float p = Ps[r * (BKV + 1) + j];
#pragma unroll
      for (int t = 0; t < D / 8; ++t) acc[t] = fmaf(p, Vs[j * D + c + 8 * t], acc[t]);
    }
  }

  if (q0 + r < sq) {
    const float denom = l == 0.f ? 1.f : l;
    __nv_bfloat16* ob = out + bi * o_sb + (q0 + r) * o_ss + h * o_sh;
#pragma unroll
    for (int t = 0; t < D / 8; ++t)
      ob[c + 8 * t] = __float2bfloat16_rn(acc[t] / denom * out_scale);
  }
}

template <int D, typename KV>
int launch_fwd(const void* q, const long long* qs, const void* k, const long long* ks,
               const void* v, const long long* vs, const int* q_offset, const int* kv_len,
               void* out, const long long* os, int b, int sq, int hq, int hk, int S,
               int causal, float qk_scale, float out_scale, cudaStream_t stream) {
  constexpr size_t smem = fwd_smem_bytes<D>();
  auto kern = attn_fwd_kernel<D, KV>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((sq + BQ - 1) / BQ, hq, b);
  kern<<<grid, FWD_THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), qs[0], qs[1], qs[2],
      static_cast<const KV*>(k), ks[0], ks[1], ks[2],
      static_cast<const KV*>(v), vs[0], vs[1], vs[2], q_offset, kv_len,
      static_cast<__nv_bfloat16*>(out), os[0], os[1], os[2],
      sq, hq, hk, S, causal, qk_scale, out_scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q bf16 [b, hq, d] through strides (batch, head); k/v [b, hk, S, d] through
// element strides (batch, head, seq); d contiguous everywhere; K/V int8
// (kv_int8 != 0) or bf16; kv_len int32 [b]; out bf16 [b, hq, d] contiguous.
// d % 4 == 0, d <= 256.
extern "C" int decode_attention_launch(const void* q, long long q_sb, long long q_sh,
                                       const void* k, long long k_sb,
                                       long long k_sh, long long k_ss, const void* v,
                                       long long v_sb, long long v_sh, long long v_ss,
                                       const int* kv_len, void* out, int b, int hq, int hk,
                                       int S, int d, int kv_int8, float qk_scale,
                                       float out_scale, void* stream) {
  if (d > DEC_MAX_D || d % 4 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) * (d + S + DEC_WARPS * d + DEC_WARPS);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dim3 grid(hq, b);
  cudaError_t e;
  if (kv_int8) {
    e = cudaFuncSetAttribute(decode_attn_kernel<int8_t>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    decode_attn_kernel<int8_t><<<grid, DEC_THREADS, smem, st>>>(
        static_cast<const __nv_bfloat16*>(q), q_sb, q_sh, static_cast<const int8_t*>(k), k_sb,
        k_sh, k_ss,
        static_cast<const int8_t*>(v), v_sb, v_sh, v_ss, kv_len,
        static_cast<__nv_bfloat16*>(out), hq, hk, S, d, qk_scale, out_scale);
  } else {
    e = cudaFuncSetAttribute(decode_attn_kernel<__nv_bfloat16>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    decode_attn_kernel<__nv_bfloat16><<<grid, DEC_THREADS, smem, st>>>(
        static_cast<const __nv_bfloat16*>(q), q_sb, q_sh, static_cast<const __nv_bfloat16*>(k),
        k_sb, k_sh, k_ss, static_cast<const __nv_bfloat16*>(v), v_sb, v_sh, v_ss, kv_len,
        static_cast<__nv_bfloat16*>(out), hq, hk, S, d, qk_scale, out_scale);
  }
  return static_cast<int>(cudaGetLastError());
}

// q bf16 [b, sq, hq, d] and out bf16 through strides {batch, seq, head};
// k/v [b, hk, S, d] through strides {batch, head, seq}; contiguous d in all;
// q_offset / kv_len int32 [b].  d in {64, 128}.
extern "C" int attention_fwd_launch(const void* q, const long long* q_strides, const void* k,
                                    const long long* k_strides, const void* v,
                                    const long long* v_strides, const int* q_offset,
                                    const int* kv_len, void* out, const long long* o_strides,
                                    int b, int sq, int hq, int hk, int S, int d, int kv_int8,
                                    int causal, float qk_scale, float out_scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define CSINN2_FWD(D, KV)                                                                    \
  return launch_fwd<D, KV>(q, q_strides, k, k_strides, v, v_strides, q_offset, kv_len, out, \
                           o_strides, b, sq, hq, hk, S, causal, qk_scale, out_scale, st)
  if (d == 128) {
    if (kv_int8) CSINN2_FWD(128, int8_t);
    CSINN2_FWD(128, __nv_bfloat16);
  }
  if (d == 64) {
    if (kv_int8) CSINN2_FWD(64, int8_t);
    CSINN2_FWD(64, __nv_bfloat16);
  }
#undef CSINN2_FWD
  return static_cast<int>(cudaErrorInvalidValue);
}
