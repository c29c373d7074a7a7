// Weight-only quantized GEMM for Hopper (sm_90a), every float-activation
// mode of quant_matmul:
//   y[M,N] = epilogue(x[M,K] · dequant(w)),  f32 accumulation, optionally
//   followed by the SwiGLU pair epilogue (out [M, N/2]).
//
// Replaces: csinn2_tpu/kernels/qmatmul.py quant_matmul → _kernel (:116,
// pallas_call :592) with a float (or int8, converted exactly) x:
//   * block scales s[K/32, N] (Q8_0, Q4_0: the in-loop dequant, :217-235);
//   * channel scales s[N] (INT8_CHANNEL, INT4_CHANNEL: the epilogue multiply,
//     :262-263), or none (scale_mode "none": the channel kernels without a
//     scale);
//   * int8 values [K, N], or packed int4 [K/2, N] (:158-168, :189-210): byte
//     b·16+j of a 32-row block holds rows b·32+j (low nibble) and b·32+16+j
//     (high nibble), sign-extended;
//   * TRANS, the rearranged layout (w_transposed, :170-188, :239-241): int8
//     [N, K] with block scales [N, K/32] or channel scales, or packed
//     [N, K/2] (byte g·16+j of a row holds k = g·32+j low and g·32+16+j high);
//   * the epilogue of epilogue.cuh (:261-269): channel scale, epilogue_scale,
//     bias, and the f32 / bf16 / int8 / uint8 / int16 / int32 cast;
//   * swiglu (:270-277): out[m, g·128+l] = silu(h[m, g·256+l]) ·
//     h[m, g·256+128+l] over the 128-column pair layout of a fused w1|w3.
// Two libraries instantiate it: qmatmul.cu (int8 values) and qmatmul_int4.cu
// (packed int4), built in parallel.
//
// Numerics.  The decode kernels (M <= 16) follow the f32 reference
// quant_matmul_ref: x · (q · s) with q · s formed in f32 per weight for
// block scales, (x · q) · s for channel scales.  The prefill kernel (M > 16)
// computes what the JAX body computes (csinn2_tpu/kernels/qmatmul.py
// :232-235, :225, :203): each weight of a block-scaled tile becomes
// bf16(bf16(q) · bf16(s)) — one rounding of the exact product — and x (bf16)
// meets it on the tensor cores with f32 accumulation; with channel scales
// or none, q stays exact in bf16 and the scale is applied to the f32 sum in
// the epilogue.  quant_matmul_ref stays the yardstick: the bf16 w·s moves a
// sum by ~2^-9 of its size, inside the gates (cosine 0.9999, 1e-2·max|y|).
//
// Bound.  At decode (M <= 16) the weight stream: K·N bytes (int8) or K·N/2
// (packed) plus the scales, read once, against 2·M·K·N flops.
// qmm_decode_kernel serves it: one CTA covers all M rows of a 128-column
// strip, so the weight is read exactly once, each weight is dequantized once
// in registers and feeds M FMAs, and K is split across CTAs (split-K, sized
// by plan_split_k) until the grid fills the card.  Each thread reads two
// adjacent (byte) rows per 8-byte load pair; in the packed layout those give
// four weight rows, whose activations are two bf16x2 loads.  At prefill
// (M > 16) the 2·M·K·N flops and, at M <= 128, the weight stream bound it:
// the prefill kernels (their notes below) stream x and the raw quantized
// bytes through a 5-stage cp.async ring in shared memory (134-171 KB, one
// CTA of 128 tokens × 256 columns an SM) and widen the weights in
// registers, into wgmma A operands (qmm_wgmma_kernel, [K, N] layouts) or
// mma.sync B fragments (qmm_mma_t_kernel, [N, K] layouts).  TMA loads and a
// producer warp are later work.
//
// TRANS.  At decode (M <= 16) qmm_t_decode_kernel gives each warp one
// output column: its 32 lanes stream 16 contiguous bytes of the column's K
// row each (a whole packed block, or half an int8 block, with one scale),
// dequantize in f32 and FMA against all M activation rows, then sum across
// the warp.  No split-K: N/8 CTAs fill the card.
//
// Epilogue.  Without a split, without swiglu, with a float output and an
// epilogue of at most one rounding (a channel scale or a bias), the GEMM
// kernel writes the output itself (direct_epi).  Otherwise it writes f32
// sums to a workspace [splits, M, N] and qmm_reduce sums the splits, applies
// the whole epilogue (epi_float: the fmaf of a scale and a bias,
// epilogue_scale) to the complete sum and, with swiglu, pairs columns c and
// c+128 of each 256-column group; it also writes the integer outputs.  (The
// whole epilogue inlined into the prefill kernel cost its w13 M=128 shape
// 4-9 %, with the registers unchanged.)  The pair's two halves are 128
// columns apart, in different 128-column CTA strips, and under split-K
// neither is complete before the reduce, so the SwiGLU epilogue runs there,
// over the f32 sums: the workspace round trip is M·N·8 bytes, small beside
// the weight stream at decode and a few percent of the prefill GEMM.
#pragma once

#include <algorithm>
#include <type_traits>

#include "epilogue.cuh"

namespace {

constexpr int BK = 32;
constexpr int BN = 128;
constexpr int THREADS = 256;
constexpr int SWIGLU_HALF = 128;   // columns per half of a swiglu pair

__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const void* p, bool trans) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  if (trans)
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
  else
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

// d += a · b on the tensor cores: m16n8k16, bf16 inputs, f32 accumulate
__device__ __forceinline__ void mma_bf16(float d[4], const uint32_t a[4], const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t pack_bf162(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// sign-extended nibbles of a packed byte: row j (low) and row j+16 (high)
__device__ __forceinline__ int lo_nibble(int8_t b) { return static_cast<int8_t>(b << 4) >> 4; }
__device__ __forceinline__ int hi_nibble(int8_t b) { return b >> 4; }

// Packed staging for the tensor cores without I2F (16 results/clk/SM on
// sm_90): a nibble n XORed with NIBBLE_BIAS is u = n + 8 (two's complement).
constexpr uint32_t NIBBLE_BIAS = 0x88888888u;

// bf16 pair (u0 - 8, u1 - 8) from biased nibbles u0 (bits 0-3) and u1 (bits
// 16-19): the bf16 bits 0x4300 | u are the value 128 + u, exact.
__device__ __forceinline__ uint32_t biased_nibble_pair_bf162(uint32_t u) {
  const uint32_t bits = u | 0x43004300u;
  const __nv_bfloat162 v = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&bits),
                                   __floats2bfloat162_rn(136.f, 136.f));
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The GEMM kernels' direct write: a channel scale or a bias, never both
// and no epilogue_scale (run() sends those through qmm_reduce).
template <bool CHANNEL>
__device__ __forceinline__ float direct_epi(float v, int col, const Epi& ep) {
  if constexpr (CHANNEL) {
    if (ep.ch_scale != nullptr) v *= ep.ch_scale[col];
  }
  return ep.bias != nullptr ? v + ep.bias[col] : v;
}

// ---------------------------------------------------------------------------
// Prefill (M > 16): a multi-stage cp.async pipeline into tensor-core tiles
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// BYTES (16 or 4) from global to shared, asynchronously; ok == false fills
// zeros and reads nothing
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src, bool ok) {
  const int n = ok ? BYTES : 0;
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
                 "l"(src), "r"(n));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(smem_u32(dst)),
                 "l"(src), "n"(BYTES), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ __nv_bfloat162 as_bf162(uint32_t v) {
  return *reinterpret_cast<const __nv_bfloat162*>(&v);
}

// bf16 pair (b0, b1) from int8 bytes b0 (bits 0-7) and b1 (bits 16-23),
// exact and without I2F: with the sign bit t and the low bits l of a byte,
// b = l - 128·t = (128 + l) - (128 + 128·t), and both terms are bf16 bit
// patterns 0x4300 | l and 0x4300 | (t << 7).
__device__ __forceinline__ uint32_t i8_pair_bf162(uint32_t p) {
  const uint32_t lo = (p & 0x007F007Fu) | 0x43004300u;
  const uint32_t hi = (p & 0x00800080u) | 0x43004300u;
  return as_u32(__hsub2(as_bf162(lo), as_bf162(hi)));
}

constexpr int PF_BM = 128;          // CTA tile rows (M)
constexpr int PF_BN = 256;          // CTA tile columns (N)
constexpr int PF_SK = 64;           // k per pipeline stage: two quant blocks
constexpr int PF_STAGES = 5;        // stages in the shared-memory ring
constexpr int PF_X_BYTES = PF_BM * PF_SK * 2;                 // bf16 x tile
constexpr int PF_S_BYTES = (PF_SK / BK) * PF_BN * 4;          // f32 block scales

// One stage of the ring: the x tile (bf16 [128][64], 16-byte chunk c of
// row r at c ^ (r & 7): wgmma's 128-byte swizzle), the raw weight bytes as
// they lie in memory, and the block scales (f32 [2][256]).  Raw weight
// layouts, each swizzled so that the ldmatrix reads below are conflict-free:
//   [K, N] int8:   64 k rows × 256 bytes      (chunk c at c ^ (k & 7))
//   [K/2, N] int4: 32 byte rows × 256 bytes   (chunk c at c ^ (row & 7))
//   [N, K] int8:   256 n rows × 64 bytes      (chunk c at c ^ ((n >> 1) & 3))
//   [N, K/2] int4: 256 n rows × 32 bytes      (chunk c at c ^ ((n >> 2) & 1))
template <bool PACKED>
struct Pf {
  static constexpr int W_BYTES = PF_SK * PF_BN / (PACKED ? 2 : 1);
  static constexpr int STAGE = PF_X_BYTES + W_BYTES + PF_S_BYTES;
  static constexpr int SMEM = PF_STAGES * STAGE + 1024;   // + alignment to 1024 bytes
};
static_assert(Pf<false>::SMEM <= 232448, "the ring must fit a CTA's shared memory");

// Outputs (row, col) and (row, col + 1), col < N: f32 partial sums, or the
// output through the direct epilogue.
template <bool CHANNEL, typename OutT>
__device__ __forceinline__ void store_pair(float v0, float v1, int row, int col, const Epi& ep,
                                           OutT* __restrict__ out, float* __restrict__ partial,
                                           int M, int N) {
  if (partial != nullptr) {
    *reinterpret_cast<float2*>(partial + ((size_t)blockIdx.z * M + row) * N + col) =
        make_float2(v0, v1);
    return;
  }
  const float e0 = direct_epi<CHANNEL>(v0, col, ep), e1 = direct_epi<CHANNEL>(v1, col + 1, ep);
  OutT* dst = out + (size_t)row * N + col;
  if constexpr (sizeof(OutT) == 4) *reinterpret_cast<float2*>(dst) = make_float2(e0, e1);
  else *reinterpret_cast<uint32_t*>(dst) = pack_bf162(e0, e1);
}

// Stage t of a split (blocks kb_begin + 2t, +1) into a ring slot: x rows m0
// .. m0+127, the raw weight bytes of columns n0 .. n0+255 and their block
// scales, zero-filled past M, N and the split's last block (kb_end); one
// cp.async group, committed by the caller.
template <bool PACKED, bool CHANNEL, bool TRANS>
__device__ __forceinline__ void pf_load_stage(unsigned char* xs, const __nv_bfloat16* x,
                                              const int8_t* w, const float* s, int M, int N,
                                              int K, int m0, int n0, int kb0, int kb_end) {
  using C = Pf<PACKED>;
  constexpr int KN_CH = PF_BN / 16;            // 16-byte chunks of a [K, N] tile row
  const int tid = threadIdx.x, nb = K / BK, k0 = kb0 * BK;
  unsigned char* ws = xs + PF_X_BYTES;
  float* ss = reinterpret_cast<float*>(ws + C::W_BYTES);
#pragma unroll
  for (int i = tid; i < PF_BM * 8; i += THREADS) {          // x: 8 chunks a row
    const int r = i / 8, c = i % 8;
    const bool ok = m0 + r < M && kb0 + c / 4 < kb_end;
    cp_async<16>(xs + r * 128 + ((c ^ (r & 7)) << 4),
                 ok ? x + (size_t)(m0 + r) * K + k0 + c * 8 : x, ok);
  }
  if constexpr (!TRANS) {                                    // 64 k rows / 32 byte rows
    constexpr int ROWS = PACKED ? PF_SK / 2 : PF_SK;
#pragma unroll
    for (int i = tid; i < ROWS * KN_CH; i += THREADS) {
      const int kr = i / KN_CH, c = i % KN_CH;
      const bool ok = kb0 + kr / (PACKED ? 16 : BK) < kb_end && n0 + c * 16 < N;
      const size_t row = PACKED ? (size_t)kb0 * 16 + kr : (size_t)k0 + kr;
      cp_async<16>(ws + kr * PF_BN + ((c ^ (kr & 7)) << 4),
                   ok ? w + row * N + n0 + c * 16 : w, ok);
    }
  } else if constexpr (!PACKED) {
#pragma unroll
    for (int i = tid; i < PF_BN * 4; i += THREADS) {
      const int nr = i / 4, c = i % 4;
      const bool ok = n0 + nr < N && kb0 + c / 2 < kb_end;
      cp_async<16>(ws + nr * 64 + ((c ^ ((nr >> 1) & 3)) << 4),
                   ok ? w + (size_t)(n0 + nr) * K + k0 + c * 16 : w, ok);
    }
  } else {
#pragma unroll
    for (int i = tid; i < PF_BN * 2; i += THREADS) {
      const int nr = i / 2, c = i % 2;
      const bool ok = n0 + nr < N && kb0 + c < kb_end;
      cp_async<16>(ws + nr * 32 + ((c ^ ((nr >> 2) & 1)) << 4),
                   ok ? w + (size_t)(n0 + nr) * (K / 2) + (kb0 + c) * 16 : w, ok);
    }
  }
  if constexpr (!CHANNEL) {
    if constexpr (TRANS) {                                   // [N, K/32]: one float each
#pragma unroll
      for (int i = tid; i < PF_BN * 2; i += THREADS) {
        const int nr = i / 2, b = i % 2;
        const bool ok = n0 + nr < N && kb0 + b < kb_end;
        cp_async<4>(ss + b * PF_BN + nr, ok ? s + (size_t)(n0 + nr) * nb + kb0 + b : s, ok);
      }
    } else if (tid < 2 * PF_BN / 4) {                        // [K/32, N]: 4 floats each
      const int b = tid / (PF_BN / 4), c = tid % (PF_BN / 4);
      const bool ok = kb0 + b < kb_end && n0 + c * 4 < N;
      cp_async<16>(ss + b * PF_BN + c * 4, ok ? s + (size_t)(kb0 + b) * N + n0 + c * 4 : s, ok);
    }
  }
}

__device__ __forceinline__ uint32_t pair_i8_scaled(uint32_t p, uint32_t sc, bool scale) {
  const uint32_t v = i8_pair_bf162(p);
  return scale ? as_u32(__hmul2(as_bf162(v), as_bf162(sc))) : v;
}

// d[0..63] += A · B on the tensor cores, one warpgroup: A bf16 m64 × k16 in
// registers (each warp 16 rows, the mma.sync A fragment), B bf16 k16 × n128
// in shared memory (K-major, 128-byte swizzle, descriptor bdesc), f32 sums
__device__ __forceinline__ void wgmma_m64n128k16(float* d, const uint32_t* a, uint64_t bdesc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n"
      "}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(bdesc), "r"(1));
}

// The shared-memory descriptor of a K-major bf16 tile with 128-byte rows in
// the 128-byte swizzle (16-byte chunk c of row r at c ^ (r & 7)), 8-row
// groups 1024 bytes apart
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// Prefill variant (M > 16), [K, N] and [K/2, N] layouts: a 128-token ×
// 256-column output tile per CTA, on wgmma.  The product is taken
// transposed, out^T[n][m] = Σ_k W[k][n] · x[m][k]: each warpgroup owns 128
// weight columns as two m64 tiles whose A operand (the weights) it widens
// into registers, and x in shared memory is the B operand as it lies
// (K-major, 128-byte swizzle, n = 128 tokens).  So each weight byte is
// widened exactly once per CTA and each x tile feeds 256 columns.  Raw
// weight bytes, x and block scales stream through a PF_STAGES ring of 64-k
// stages by cp.async, loads PF_STAGES - 2 stages ahead, one barrier per
// stage.  ldmatrix.trans regroups a [k][n] byte tile into k pairs of two
// columns, which become bf16 without I2F (i8_pair_bf162,
// biased_nibble_pair_bf162), times the block scales as bf16 (the JAX body's
// bf16(q)·bf16(s)); a warp's 16 A rows are the even (rows 0-7) and odd
// (rows 8-15) columns of a 16-column chunk.  The A registers are rewritten
// only after the previous stage's wgmmas have finished (a register written
// while a wgmma may read it makes ptxas serialise the wgmmas, C7513).
template <bool PACKED, bool CHANNEL, typename OutT>
__global__ void __launch_bounds__(THREADS, 1)
qmm_wgmma_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ w,
                 const float* __restrict__ s, Epi ep,
                 OutT* __restrict__ out, float* __restrict__ partial,
                 int M, int N, int K, int blocks_per_split) {
  using C = Pf<PACKED>;
  extern __shared__ __align__(16) unsigned char pf_raw[];
  unsigned char* pf_smem = pf_raw + ((1024 - (smem_u32(pf_raw) & 1023)) & 1023);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wg = warp / 4, wq = warp % 4;      // warpgroup: columns wg*128 ..; warp: 16 of each m64
  const int g = lane / 4, tig = lane % 4;
  const int lm = lane / 8, li = lane % 8;
  const int m0 = blockIdx.x * PF_BM;
  const int n0 = blockIdx.y * PF_BN;
  const int kb_begin = blockIdx.z * blocks_per_split;
  const int kb_end = min(K / BK, kb_begin + blocks_per_split);
  const int n_st = max(0, (kb_end - kb_begin + 1) / 2);
  // this warp's two 16-column chunks (one per m64 tile), relative to n0
  const int cb0 = wg * 128 + wq * 16, cb1 = cb0 + 64;

  float acc[2][64];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int e = 0; e < 64; ++e) acc[mt][e] = 0.f;
  uint32_t af[PF_SK / 16][2][4];               // [k16 of the stage][m64 tile][fragment]

  // the A fragments of ring slot st
  auto widen = [&](int st) {
    const unsigned char* ws = pf_smem + st * C::STAGE + PF_X_BYTES;
    const float* ss = reinterpret_cast<const float*>(ws + C::W_BYTES);
    const int cl = (lm < 2 ? cb0 : cb1) / 16;  // the chunk this lane's ldmatrix row reads
#pragma unroll
    for (int b = 0; b < PF_SK / BK; ++b) {
      uint32_t sc[2][2] = {{0, 0}, {0, 0}};    // [m64 tile][even, odd column]
      if constexpr (!CHANNEL) {
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const float2 f =
              *reinterpret_cast<const float2*>(ss + b * PF_BN + (mt ? cb1 : cb0) + 2 * g);
          const __nv_bfloat16 e = __float2bfloat16_rn(f.x), o = __float2bfloat16_rn(f.y);
          sc[mt][0] = as_u32(__halves2bfloat162(e, e));
          sc[mt][1] = as_u32(__halves2bfloat162(o, o));
        }
      }
      if constexpr (PACKED) {
        uint32_t r[4];                         // byte rows 0-7 / 8-15 of the block, tiles 0 / 1
        const int jr = b * 16 + li + 8 * (lm & 1);
        ldmatrix_x4(r, ws + jr * PF_BN + ((cl ^ (jr & 7)) << 4), true);
#pragma unroll
        for (int ks = 0; ks < 2; ++ks)
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int h = 0; h < 2; ++h) {      // k 0-7 (a0, a1) or 8-15 (a2, a3) of the k16
              const uint32_t u = r[2 * mt + h] ^ NIBBLE_BIAS;
              uint32_t e = biased_nibble_pair_bf162((u >> (4 * ks)) & 0x000F000Fu);
              uint32_t o = biased_nibble_pair_bf162((u >> (8 + 4 * ks)) & 0x000F000Fu);
              if constexpr (!CHANNEL) {
                e = as_u32(__hmul2(as_bf162(e), as_bf162(sc[mt][0])));
                o = as_u32(__hmul2(as_bf162(o), as_bf162(sc[mt][1])));
              }
              af[2 * b + ks][mt][2 * h] = e;
              af[2 * b + ks][mt][2 * h + 1] = o;
            }
      } else {
#pragma unroll
        for (int ks = 0; ks < 2; ++ks) {
          uint32_t r[4];                       // k rows 0-7 / 8-15 of the k16, tiles 0 / 1
          const int kr = b * BK + ks * 16 + li + 8 * (lm & 1);
          ldmatrix_x4(r, ws + kr * PF_BN + ((cl ^ (kr & 7)) << 4), true);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const uint32_t q = r[2 * mt + h];
              af[2 * b + ks][mt][2 * h] =
                  pair_i8_scaled(__byte_perm(q, 0, 0x4240), sc[mt][0], !CHANNEL);
              af[2 * b + ks][mt][2 * h + 1] =
                  pair_i8_scaled(__byte_perm(q, 0, 0x4341), sc[mt][1], !CHANNEL);
            }
        }
      }
    }
  };

#pragma unroll
  for (int t = 0; t < PF_STAGES - 2; ++t) {
    if (t < n_st)
      pf_load_stage<PACKED, CHANNEL, false>(pf_smem + t * C::STAGE, x, w, s, M, N, K, m0, n0,
                                            kb_begin + 2 * t, kb_end);
    cp_async_commit();
  }
  for (int t = 0; t < n_st; ++t) {
    const int st = t % PF_STAGES;
    cp_async_wait<PF_STAGES - 3>();            // stage t has landed
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");   // ... for wgmma too
    __syncthreads();                           // ... for every thread
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");   // stage t-1's wgmmas
    widen(st);
    const int nt = t + PF_STAGES - 2;          // into the slot of stage t-2, long done
    if (nt < n_st)
      pf_load_stage<PACKED, CHANNEL, false>(pf_smem + (nt % PF_STAGES) * C::STAGE, x, w, s, M,
                                            N, K, m0, n0, kb_begin + 2 * nt, kb_end);
    cp_async_commit();
    const uint64_t bd = sw128_desc(pf_smem + st * C::STAGE);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int k4 = 0; k4 < PF_SK / 16; ++k4)
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) wgmma_m64n128k16(acc[mt], af[k4][mt], bd + 2 * k4);
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)               // the sums are read after the wait
#pragma unroll
    for (int e = 0; e < 64; ++e) asm volatile("" : "+f"(acc[mt][e])::"memory");
  cp_async_wait<0>();

  // acc[mt][4j + e]: token 8j + 2tig + (e & 1), A row 16·wq + g + 8·(e >> 1),
  // i.e. column cb + 2g (rows 0-7) or cb + 2g + 1 (rows 8-15)
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    const int col = n0 + (mt ? cb1 : cb0) + 2 * g;
    if (col >= N) continue;
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int row = m0 + 8 * j + 2 * tig + e;
        if (row >= M) continue;
        store_pair<CHANNEL>(acc[mt][4 * j + e], acc[mt][4 * j + 2 + e], row, col, ep, out,
                            partial, M, N);
      }
  }
}

// Prefill variant (M > 16), [N, K] and [N, K/2] layouts: the same tile and
// ring (loads PF_STAGES - 1 stages ahead) on mma.sync m16n8k16 with 8 warps
// of 64 × 64.  B is read from the raw
// bytes with plain ldmatrix, which gives a thread k = 4·tig .. 4·tig+3 of
// its column, widened in registers; x is read with 8-byte loads in the same
// permuted k order.
template <bool PACKED, bool CHANNEL, typename OutT>
__global__ void __launch_bounds__(THREADS, 1)
qmm_mma_t_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ w,
                 const float* __restrict__ s, Epi ep,
                 OutT* __restrict__ out, float* __restrict__ partial,
                 int M, int N, int K, int blocks_per_split) {
  using C = Pf<PACKED>;
  constexpr int WN = PF_BN / 4, NQ = WN / 32;  // warp columns, their 32-column groups
  extern __shared__ __align__(16) unsigned char pf_raw[];
  unsigned char* pf_smem = pf_raw + ((1024 - (smem_u32(pf_raw) & 1023)) & 1023);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wm = warp / 4, wn = warp % 4;      // warp tile rows wm*64, cols wn*WN
  const int g = lane / 4, tig = lane % 4;      // mma fragment coordinates
  const int lm = lane / 8, li = lane % 8;      // ldmatrix: matrix and row of this lane
  const int m0 = blockIdx.x * PF_BM;
  const int n0 = blockIdx.y * PF_BN;
  const int kb_begin = blockIdx.z * blocks_per_split;
  const int kb_end = min(K / BK, kb_begin + blocks_per_split);
  const int n_st = max(0, (kb_end - kb_begin + 1) / 2);

  float acc[4][4 * NQ][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4 * NQ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  auto compute = [&](int st, int t) {
    const unsigned char* xs = pf_smem + st * C::STAGE;
    const unsigned char* ws = xs + PF_X_BYTES;
    const float* ss = reinterpret_cast<const float*>(ws + C::W_BYTES);
#pragma unroll
    for (int b = 0; b < PF_SK / BK; ++b) {
      if (kb_begin + 2 * t + b >= kb_end) break;             // uniform: the split's tail
      uint32_t sc[4 * NQ];                                   // column scales as bf16 pairs
      if constexpr (!CHANNEL) {
#pragma unroll
        for (int j = 0; j < 4 * NQ; ++j) {
          const __nv_bfloat16 h = __float2bfloat16_rn(ss[b * PF_BN + wn * WN + 8 * j + g]);
          sc[j] = as_u32(__halves2bfloat162(h, h));
        }
      }
      uint32_t raw[NQ][4];                                   // packed: both k16 steps
      if constexpr (PACKED) {
#pragma unroll
        for (int q = 0; q < NQ; ++q) {
          const int nr = wn * WN + 32 * q + 8 * lm + li;
          ldmatrix_x4(raw[q], ws + nr * 32 + ((b ^ ((nr >> 2) & 1)) << 4), false);
#pragma unroll
          for (int j = 0; j < 4; ++j) raw[q][j] ^= NIBBLE_BIAS;
        }
      }
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        const int kk = b * BK + ks * 16;                     // k within the stage
        uint32_t a[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {                        // k = kk + 4·tig .. +3
          const int c = kk / 8 + tig / 2;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = wm * 64 + i * 16 + g + 8 * h;
            const uint2 v = *reinterpret_cast<const uint2*>(
                xs + r * 128 + ((c ^ (r & 7)) << 4) + (tig & 1) * 8);
            a[i][h] = v.x;
            a[i][2 + h] = v.y;
          }
        }
#pragma unroll
        for (int q = 0; q < NQ; ++q) {
          uint32_t bf[4][2];
          if constexpr (PACKED) {
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const uint32_t p0 = __byte_perm(raw[q][j], 0, 0x4140) >> (4 * ks);
              const uint32_t p1 = __byte_perm(raw[q][j], 0, 0x4342) >> (4 * ks);
              bf[j][0] = biased_nibble_pair_bf162(p0 & 0x000F000Fu);
              bf[j][1] = biased_nibble_pair_bf162(p1 & 0x000F000Fu);
            }
          } else {
            uint32_t r4[4];
            const int nr = wn * WN + 32 * q + 8 * lm + li;
            const int c = kk / 16;
            ldmatrix_x4(r4, ws + nr * 64 + ((c ^ ((nr >> 1) & 3)) << 4), false);
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              bf[j][0] = i8_pair_bf162(__byte_perm(r4[j], 0, 0x4140));
              bf[j][1] = i8_pair_bf162(__byte_perm(r4[j], 0, 0x4342));
            }
          }
          if constexpr (!CHANNEL) {
#pragma unroll
            for (int j = 0; j < 4; ++j)
#pragma unroll
              for (int h = 0; h < 2; ++h)
                bf[j][h] = as_u32(__hmul2(as_bf162(bf[j][h]), as_bf162(sc[4 * q + j])));
          }
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) mma_bf16(acc[i][4 * q + j], a[i], bf[j]);
        }
      }
    }
  };

#pragma unroll
  for (int t = 0; t < PF_STAGES - 1; ++t) {
    if (t < n_st)
      pf_load_stage<PACKED, CHANNEL, true>(pf_smem + t * C::STAGE, x, w, s, M, N, K, m0, n0,
                                           kb_begin + 2 * t, kb_end);
    cp_async_commit();
  }
  for (int t = 0; t < n_st; ++t) {
    cp_async_wait<PF_STAGES - 2>();   // stage t has landed (later ones may be in flight)
    __syncthreads();                  // ... for every thread; stage t-1's slot is free
    const int nt = t + PF_STAGES - 1;
    if (nt < n_st)
      pf_load_stage<PACKED, CHANNEL, true>(pf_smem + (nt % PF_STAGES) * C::STAGE, x, w, s, M,
                                           N, K, m0, n0, kb_begin + 2 * nt, kb_end);
    cp_async_commit();
    compute(t % PF_STAGES, t);
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + wm * 64 + i * 16 + g + 8 * h;
      if (row >= M) continue;
#pragma unroll
      for (int j = 0; j < 4 * NQ; ++j) {
        const int col = n0 + wn * WN + 8 * j + 2 * tig;
        if (col < N)
          store_pair<CHANNEL>(acc[i][j][2 * h], acc[i][j][2 * h + 1], row, col, ep, out, partial,
                              M, N);
      }
    }
}

// Decode variant (M <= 16): no shared-memory staging of the weight, since
// each weight is used by exactly one thread.  Thread (tx, tk) owns columns
// tx*8 .. tx*8+7 and, for ALL MT activation rows, two adjacent weight rows
// of a block per 8-byte load: int8 rows 2·tk and 2·tk+1 of every block;
// packed byte rows 2·tp and 2·tp+1 (tp = tk % 8) of every other block (tk / 8
// picks which), i.e. rows 2·tp, 2·tp+1 (low nibbles) and 2·tp+16, 2·tp+17
// (high nibbles).  Each weight is loaded and dequantized once and feeds MT
// FMAs; the activations of a row pair are one bf16x2 load, and one scale
// load serves 16 (int8) or 32 (packed) weights.  U blocks are loaded into
// registers before any is used, to keep loads in flight.  The 16 row lanes
// are summed at the end (a shuffle within each warp, then shared memory).
template <int MT, bool PACKED, bool CHANNEL, typename OutT>
__global__ void __launch_bounds__(THREADS)
qmm_decode_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ w,
                  const float* __restrict__ s, Epi ep,
                  OutT* __restrict__ out, float* __restrict__ partial,
                  int M, int N, int K, int blocks_per_split) {
  // blocks loaded ahead: a packed step loads as many bytes as an int8 one
  // but twice the activations, so it holds fewer to stay at 2+ CTAs per SM
  constexpr int U = !PACKED ? (MT <= 4 ? 4 : 2) : (MT <= 2 ? 4 : MT <= 8 ? 2 : 1);
  constexpr int HALVES = PACKED ? 2 : 1;       // nibble halves (row pairs) per load pair
  constexpr int BSTEP = PACKED ? 2 : 1;        // block lanes among the 16 row lanes
  __shared__ float red[THREADS / 32][BN];
  const int tid = threadIdx.x;
  const int tx = tid % 16, tk = tid / 16;
  const int lane = tid % 32, warp = tid / 32;
  const int n0 = blockIdx.x * BN;
  const int n = n0 + tx * 8;
  const int row0 = PACKED ? (tk % 8) * 2 : tk * 2;   // first (byte) row within a block
  const int kb_begin = blockIdx.z * blocks_per_split + (PACKED ? tk / 8 : 0);
  const int kb_end = min(K / BK, blockIdx.z * blocks_per_split + blocks_per_split);

  float acc[MT][8];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[m][j] = 0.f;

  if (n < N) {
    for (int kb = kb_begin; kb < kb_end; kb += U * BSTEP) {
      int2 wv[U][2];                 // (byte) rows row0 and row0 + 1
      float4 sv[U][CHANNEL ? 1 : 2];
      __nv_bfloat162 xv[U][MT][HALVES];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int b = kb + u * BSTEP;
        if (b < kb_end) {
          if constexpr (PACKED) {
            const int8_t* wb = w + ((size_t)b * (BK / 2) + row0) * N + n;
            wv[u][0] = __ldg(reinterpret_cast<const int2*>(wb));
            wv[u][1] = __ldg(reinterpret_cast<const int2*>(wb + N));
#pragma unroll
            for (int m = 0; m < MT; ++m)
#pragma unroll
              for (int h = 0; h < HALVES; ++h)
                xv[u][m][h] = m < M ? *reinterpret_cast<const __nv_bfloat162*>(
                                          x + (size_t)m * K + b * BK + row0 + h * (BK / 2))
                                    : __floats2bfloat162_rn(0.f, 0.f);
          } else {   // written out apart: the shared form cost these kernels 24-44 registers
            const int k = b * BK + tk * 2;
            wv[u][0] = __ldg(reinterpret_cast<const int2*>(w + (size_t)k * N + n));
            wv[u][1] = __ldg(reinterpret_cast<const int2*>(w + (size_t)(k + 1) * N + n));
#pragma unroll
            for (int m = 0; m < MT; ++m)
              xv[u][m][0] = m < M ? *reinterpret_cast<const __nv_bfloat162*>(x + (size_t)m * K + k)
                                  : __floats2bfloat162_rn(0.f, 0.f);
          }
          if constexpr (!CHANNEL) {
            sv[u][0] = __ldg(reinterpret_cast<const float4*>(s + (size_t)b * N + n));
            sv[u][1] = __ldg(reinterpret_cast<const float4*>(s + (size_t)b * N + n + 4));
          }
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (kb + u * BSTEP >= kb_end) break;
#pragma unroll
        for (int h = 0; h < HALVES; ++h)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int8_t* wb = reinterpret_cast<const int8_t*>(&wv[u][r]);
            float wf[8];
            if constexpr (PACKED) {
#pragma unroll
              for (int j = 0; j < 8; ++j)
                wf[j] = static_cast<float>(h == 0 ? lo_nibble(wb[j]) : hi_nibble(wb[j]));
            } else {
#pragma unroll
              for (int j = 0; j < 8; ++j) wf[j] = static_cast<float>(wb[j]);
            }
            if constexpr (!CHANNEL) {
              const float sc[8] = {sv[u][0].x, sv[u][0].y, sv[u][0].z, sv[u][0].w,
                                   sv[u][1].x, sv[u][1].y, sv[u][1].z, sv[u][1].w};
#pragma unroll
              for (int j = 0; j < 8; ++j) wf[j] *= sc[j];
            }
#pragma unroll
            for (int m = 0; m < MT; ++m) {
              const float xm = r == 0 ? __low2float(xv[u][m][h]) : __high2float(xv[u][m][h]);
#pragma unroll
              for (int j = 0; j < 8; ++j) acc[m][j] = fmaf(xm, wf[j], acc[m][j]);
            }
          }
      }
    }
  }

  // lanes l and l+16 of a warp hold row lanes 2w and 2w+1 of the same columns
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[m][j] += __shfl_xor_sync(0xffffffffu, acc[m][j], 16);

#pragma unroll
  for (int m = 0; m < MT; ++m) {
    if (m >= M) break;   // uniform across the block
    if (lane < 16) {
#pragma unroll
      for (int j = 0; j < 8; ++j) red[warp][tx * 8 + j] = acc[m][j];
    }
    __syncthreads();
    const int col = n0 + tid;
    if (tid < BN && col < N) {
      float v = 0.f;
#pragma unroll
      for (int i = 0; i < THREADS / 32; ++i) v += red[i][tid];
      if (partial != nullptr) {
        partial[((size_t)blockIdx.z * M + m) * N + col] = v;
      } else {
        store_out(out + (size_t)m * N + col, direct_epi<CHANNEL>(v, col, ep));
      }
    }
    __syncthreads();
  }
}

// TRANS decode variant (M <= 16): warp w of the CTA owns output column
// blockIdx.x·8 + w; lane l streams bytes 16·(l + 32·i) of the column's K row
// (int8: k .. k+15, one block scale; packed: one whole block, k = g·32 + j
// from the low nibbles and g·32 + 16 + j from the high ones), U loads ahead.
template <int MT, bool PACKED, bool CHANNEL, typename OutT>
__global__ void __launch_bounds__(THREADS)
qmm_t_decode_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ w,
                    const float* __restrict__ s, Epi ep, OutT* __restrict__ out,
                    float* __restrict__ partial, int M, int N, int K, int) {
  constexpr int U = 4;
  const int lane = threadIdx.x % 32;
  const int n = blockIdx.x * (THREADS / 32) + threadIdx.x / 32;
  if (n >= N) return;                            // whole warp
  const int row_bytes = PACKED ? K / 2 : K;
  const int8_t* wrow = w + (size_t)n * row_bytes;
  const float* srow = s + (size_t)n * (K / BK);

  float acc[MT];
#pragma unroll
  for (int m = 0; m < MT; ++m) acc[m] = 0.f;

  for (int base = lane * 16; base < row_bytes; base += 32 * 16 * U) {
    int4 wv[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int off = base + u * 32 * 16;
      wv[u] = off < row_bytes ? __ldg(reinterpret_cast<const int4*>(wrow + off))
                              : make_int4(0, 0, 0, 0);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int off = base + u * 32 * 16;
      if (off >= row_bytes) break;
      const int8_t* q = reinterpret_cast<const int8_t*>(&wv[u]);
      const int k0 = PACKED ? off * 2 : off;      // first k of the 16 bytes
      const float sc = CHANNEL ? 1.f : __ldg(srow + k0 / BK);
      float wf[PACKED ? 32 : 16];
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        if constexpr (PACKED) {
          wf[j] = static_cast<float>(lo_nibble(q[j])) * sc;
          wf[16 + j] = static_cast<float>(hi_nibble(q[j])) * sc;
        } else {
          wf[j] = static_cast<float>(q[j]) * sc;
        }
      }
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        if (m >= M) break;
        const uint4* xp = reinterpret_cast<const uint4*>(x + (size_t)m * K + k0);
#pragma unroll
        for (int h = 0; h < (PACKED ? 4 : 2); ++h) {
          const uint4 xv = __ldg(xp + h);
          const __nv_bfloat162* x2 = reinterpret_cast<const __nv_bfloat162*>(&xv);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            acc[m] = fmaf(__low2float(x2[j]), wf[h * 8 + 2 * j], acc[m]);
            acc[m] = fmaf(__high2float(x2[j]), wf[h * 8 + 2 * j + 1], acc[m]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) acc[m] += __shfl_xor_sync(0xffffffffu, acc[m], o);
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    if (m >= M || lane != m % 32) continue;
    if (partial != nullptr) partial[(size_t)m * N + n] = acc[m];
    else store_out(out + (size_t)m * N + n, direct_epi<CHANNEL>(acc[m], n, ep));
  }
}

__device__ __forceinline__ float column_sum(const float* __restrict__ partial, size_t total,
                                            int splits, size_t i) {
  float v = 0.f;
  for (int z = 0; z < splits; ++z) v += partial[z * total + i];
  return v;
}

// Sum the f32 partials [splits, M, N], then the epilogue, into the output
// [M, N] of ep.out_kind; with SWIGLU into [M, N/2]: out[m, g·128+l] =
// silu(h[m, g·256+l]) · h[m, g·256+128+l].
template <bool SWIGLU>
__global__ void qmm_reduce(const float* __restrict__ partial, Epi ep, void* __restrict__ out,
                           int M, int N, int splits) {
  const size_t total = (size_t)M * N;
  const int n_out = SWIGLU ? N / 2 : N;
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)M * n_out) return;
  const size_t m = i / n_out;
  const int c = static_cast<int>(i % n_out);
  if constexpr (SWIGLU) {
    const int c1 = (c / SWIGLU_HALF) * 2 * SWIGLU_HALF + c % SWIGLU_HALF;
    const int c3 = c1 + SWIGLU_HALF;
    const float h1 = epi_float(column_sum(partial, total, splits, m * N + c1), c1, ep);
    const float h3 = epi_float(column_sum(partial, total, splits, m * N + c3), c3, ep);
    store_kind(out, i, h1 / (1.f + expf(-h1)) * h3, ep);
  } else {
    store_kind(out, i, epi_float(column_sum(partial, total, splits, i), c, ep), ep);
  }
}

struct Launch {
  const void *x, *w, *s;
  Epi ep;              // ep.ch_scale: the channel scales (or null: block / none)
  void* out;
  float* partial;      // workspace [splits, M, N], or null: the GEMM kernel writes `out`
  int M, N, K, splits, blocks_per_split;
  bool swiglu;
  cudaStream_t stream;
};

void reduce(const Launch& a) {
  const size_t n = (size_t)a.M * (a.swiglu ? a.N / 2 : a.N);
  const unsigned grid = static_cast<unsigned>((n + 255) / 256);
  if (a.swiglu)
    qmm_reduce<true><<<grid, 256, 0, a.stream>>>(a.partial, a.ep, a.out, a.M, a.N, a.splits);
  else
    qmm_reduce<false><<<grid, 256, 0, a.stream>>>(a.partial, a.ep, a.out, a.M, a.N, a.splits);
}

// kernel: qmm_decode_kernel<MT, ...> or qmm_t_decode_kernel<MT, ...> (M <=
// 16; the TRANS decode kernel takes 8 columns per CTA and no M tiles or
// splits) or qmm_wgmma_kernel / qmm_mma_t_kernel (M > 16: 128-token tiles, M
// the fastest grid dimension, so the CTAs in flight share each weight tile
// and x stays in L2)
template <typename OutT, typename Kernel>
void launch(Kernel kernel, const Launch& a, bool t_decode = false, int smem = 0) {
  dim3 grid = t_decode ? dim3((a.N + THREADS / 32 - 1) / (THREADS / 32))
              : smem ? dim3((a.M + PF_BM - 1) / PF_BM, (a.N + PF_BN - 1) / PF_BN, a.splits)
                     : dim3((a.N + BN - 1) / BN, 1, a.splits);
  if (smem && cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem) !=
                  cudaSuccess)
    return;                                      // the error stays for run() to return
  const bool ws = a.partial != nullptr;
  kernel<<<grid, THREADS, smem, a.stream>>>(
      static_cast<const __nv_bfloat16*>(a.x), static_cast<const int8_t*>(a.w),
      static_cast<const float*>(a.s), a.ep, static_cast<OutT*>(a.out), a.partial, a.M, a.N,
      a.K, a.blocks_per_split);
  if (ws && cudaPeekAtLastError() == cudaSuccess) reduce(a);
}

constexpr int DECODE_MAX_M = 16;   // M <= 16: qmm_decode_kernel, one M tile

template <bool PACKED, bool CHANNEL, bool TRANS, typename OutT>
void dispatch_m(const Launch& a) {
#define CSINN2_QMM(MT)                                                                   \
  if constexpr (TRANS)                                                                   \
    launch<OutT>(qmm_t_decode_kernel<MT, PACKED, CHANNEL, OutT>, a, true);               \
  else                                                                                   \
    launch<OutT>(qmm_decode_kernel<MT, PACKED, CHANNEL, OutT>, a)
  if (a.M <= 1) { CSINN2_QMM(1); }
  else if (a.M <= 2) { CSINN2_QMM(2); }
  else if (a.M <= 4) { CSINN2_QMM(4); }
  else if (a.M <= 8) { CSINN2_QMM(8); }
  else if (a.M <= DECODE_MAX_M) { CSINN2_QMM(16); }
  else if constexpr (TRANS)
    launch<OutT>(qmm_mma_t_kernel<PACKED, CHANNEL, OutT>, a, false, Pf<PACKED>::SMEM);
  else
    launch<OutT>(qmm_wgmma_kernel<PACKED, CHANNEL, OutT>, a, false, Pf<PACKED>::SMEM);
#undef CSINN2_QMM
}

// The GEMM kernels write f32 (partials, or the output) or bf16; an integer
// output always goes through the workspace and qmm_reduce.
template <bool PACKED, bool TRANS>
void dispatch_t(const Launch& a, bool channel) {
  const bool bf16 = a.ep.out_kind == OUT_BF16 && a.partial == nullptr;
  if (channel) {
    if (bf16) dispatch_m<PACKED, true, TRANS, __nv_bfloat16>(a);
    else dispatch_m<PACKED, true, TRANS, float>(a);
  } else {
    if (bf16) dispatch_m<PACKED, false, TRANS, __nv_bfloat16>(a);
    else dispatch_m<PACKED, false, TRANS, float>(a);
  }
}

template <bool PACKED>
void dispatch(const Launch& a, bool channel, bool trans) {
  if (trans) dispatch_t<PACKED, true>(a, channel);
  else dispatch_t<PACKED, false>(a, channel);
}

struct SplitK {
  int splits, blocks_per_split;
};

// Prefill cost model of plan_split_k, in thirds of a nanosecond: a CTA's
// 32-k block of a 128 × 128 tile takes ~210 ns of mma.sync on one SM (2 ·
// 128 · 128 · 32 flops at ~5 TFLOP/s), and a third of the split partials'
// round trip (8 · splits · M · N bytes at ~3 TB/s) shows beside the
// weight stream.
constexpr long long PF_BLOCK_COST = 1260;
constexpr int PF_MAX_SPLITS = 16;

// Split K across CTAs.  Decode: until the grid holds about 4 CTAs per SM
// (weight-stream bound: more loads in flight); the TRANS decode kernel is
// not split.  Prefill: the split count (at most PF_MAX_SPLITS, at least one
// 64-k stage a split) that minimises the waves of CTAs on the busiest SM
// times each CTA's blocks, plus the partials' cost: with 172 tiles (w13 at
// M <= 128) on 132 SMs, one split leaves 40 SMs two whole tiles.
cudaError_t plan_split_k(int M, int N, int K, bool trans, int device, SplitK* plan) {
  static int sm_count[64];   // per device, read once
  if (device < 0 || device >= 64) return cudaErrorInvalidDevice;
  if (sm_count[device] == 0) {
    const cudaError_t e =
        cudaDeviceGetAttribute(&sm_count[device], cudaDevAttrMultiProcessorCount, device);
    if (e != cudaSuccess) return e;
  }
  const int n_blocks = K / BK;
  const int sms = sm_count[device];
  if (M > DECODE_MAX_M) {
    const long long tiles =
        (long long)((M + PF_BM - 1) / PF_BM) * ((N + PF_BN - 1) / PF_BN);
    long long best = -1;
    const int max_s = std::max(1, std::min(PF_MAX_SPLITS, n_blocks / 2));
    for (int sp = 1; sp <= max_s; ++sp) {
      const int bps = (n_blocks + sp - 1) / sp;
      if ((n_blocks + bps - 1) / bps != sp) continue;   // the same plan as fewer splits
      const long long waves = (tiles * sp + sms - 1) / sms;
      const long long cost =
          waves * bps * PF_BLOCK_COST + (sp > 1 ? 8LL * sp * M * N / 3000 : 0);
      if (best < 0 || cost < best) {
        best = cost;
        plan->splits = sp;
        plan->blocks_per_split = bps;
      }
    }
    return cudaSuccess;
  }
  if (trans) {
    plan->splits = 1;
    plan->blocks_per_split = n_blocks;
    return cudaSuccess;
  }
  const int tiles = (N + BN - 1) / BN;
  const int want = std::max(1, std::min(n_blocks, (4 * sms + tiles - 1) / tiles));
  const int bps = std::max(1, (n_blocks + want - 1) / want);
  plan->blocks_per_split = bps;
  plan->splits = std::max(1, (n_blocks + bps - 1) / bps);
  return cudaSuccess;
}

// Floats of f32 workspace for [M,K]·[K,N] on `device`: the split-K partial
// sums, also needed without a split when the swiglu epilogue pairs columns
// or the epilogue goes through qmm_reduce (reduce_epi: an integer output,
// an epilogue_scale, or a channel scale with a bias); 0 when none of these.
long long workspace_floats(int M, int N, int K, bool swiglu, bool reduce_epi, bool trans,
                           int device, cudaError_t* err) {
  SplitK plan;
  *err = plan_split_k(M, N, K, trans, device, &plan);
  if (*err != cudaSuccess) return -1;
  return plan.splits > 1 || swiglu || reduce_epi ? (long long)plan.splits * M * N : 0;
}

// The body of each library's C entry point: plan, check the workspace,
// launch, and return the launch's CUDA error.  scale_kind: 0 block, 1
// channel, 2 none; out_kind: epilogue.cuh OutKind.
template <bool PACKED>
int run(const void* x, const void* w, const void* s, const void* bias, void* out, int out_kind,
        int scale_kind, int swiglu, int trans, float e, int has_e, float zp, void* workspace,
        long long ws_floats, int M, int N, int K, int device, void* stream) {
  SplitK plan;
  const bool reduce_epi = out_kind >= OUT_I8 || has_e || (scale_kind == 1 && bias != nullptr);
  cudaError_t err = plan_split_k(M, N, K, trans != 0, device, &plan);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long need =
      workspace_floats(M, N, K, swiglu != 0, reduce_epi, trans != 0, device, &err);
  if (need > 0 && (workspace == nullptr || ws_floats < need))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool channel = scale_kind != 0;
  Epi ep{scale_kind == 1 ? static_cast<const float*>(s) : nullptr,
         static_cast<const float*>(bias), e, has_e, zp, out_kind};
  Launch a{x, w, s, ep, out, need > 0 ? static_cast<float*>(workspace) : nullptr,
           M, N, K, plan.splits, plan.blocks_per_split, swiglu != 0,
           static_cast<cudaStream_t>(stream)};
  dispatch<PACKED>(a, channel, trans != 0);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
