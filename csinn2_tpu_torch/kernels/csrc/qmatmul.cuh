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
// Numerics.  Every kernel computes what the JAX body computes
// (csinn2_tpu/kernels/qmatmul.py :232-235, :225, :203, :189-208 packed,
// :170-188 transposed packed): each weight of a block-scaled tile becomes
// bf16(bf16(q) · bf16(s)) — one rounding of the exact product — and x (bf16)
// meets it on the tensor cores with f32 accumulation; with channel scales
// or none, q stays exact in bf16 and the scale is applied to the f32 sum in
// the epilogue.  quant_matmul_ref (f32 q · s) stays the yardstick: the bf16
// w·s moves a sum by ~2^-9 of its size, inside the gates (cosine 0.9999,
// 1e-2·max|y|).
//
// Bound.  At decode (M <= 16) the weight stream: K·N bytes (int8) or K·N/2
// (packed) plus the scales, read once, against 2·M·K·N flops (3 µs of tensor
// cores at w13).  qmm_decode_kernel serves it in both layouts: a CTA takes a
// 256-column strip and one K split, streams the raw weight bytes, their
// scales and the few x rows through a cp.async ring (60-96 KB, two CTAs an
// SM, 32 KB of weights in flight per CTA), widens the bytes in
// registers without I2F and multiplies on mma.sync m16n8k16 with the
// product taken transposed (the weights are A, x^T is B: one n8 tile for M
// <= 8, two for M <= 16).  The split plan fills the card's CTA slots in one
// wave; the last CTA of each strip finishes the split sums in the same
// launch.  At prefill (M > 16) the 2·M·K·N flops and, at M <= 128, the
// weight stream bound it: the prefill kernels (their notes below) stream x
// and the raw quantized bytes through a 5-stage cp.async ring in shared
// memory (134-171 KB, one CTA of 128 tokens × 256 columns an SM) and widen
// the weights in registers, into wgmma A operands (qmm_wgmma_kernel, [K, N]
// layouts) or mma.sync B fragments (qmm_mma_t_kernel, [N, K] layouts).  TMA
// loads and a producer warp are later work.  One pair of widening functions
// serves all of them: widen_kn for [k][n] bytes regrouped by ldmatrix.trans,
// widen_nk for [n][k] bytes through plain ldmatrix.
//
// Epilogue.  Decode: the kernel applies the whole epilogue itself
// (epi_float, then store_kind's cast, every output type): from its own sums
// without a split or swiglu; else each split writes its f32 partial tile to
// the workspace [splits, M, N], takes a ticket on its strip's counter, and
// the strip's last CTA sums the partials in split order (deterministic),
// runs the epilogue and, with swiglu, pairs columns c and c+128 of its
// 256-column strip, then zeroes the counter for the next launch.  Prefill:
// without a split, without swiglu, with a float output and an epilogue of
// at most one rounding (a channel scale or a bias), the GEMM kernel writes
// the output itself (direct_epi).  Otherwise it writes f32 sums to the
// workspace and qmm_reduce sums the splits, applies the whole epilogue and
// the swiglu pairs, and writes the integer outputs.  (The whole epilogue
// inlined into the prefill kernel cost its w13 M=128 shape 4-9 %, with the
// registers unchanged.)
#pragma once

#include <algorithm>
#include <type_traits>

#include "epilogue.cuh"

namespace {

constexpr int BK = 32;
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

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ __nv_bfloat162 as_bf162(uint32_t v) {
  return *reinterpret_cast<const __nv_bfloat162*>(&v);
}

// lop3.b32: any bitwise function of three words, by its truth table (the
// constants stay in registers, so a mask and a bias take one instruction)
template <int LUT>
__device__ __forceinline__ uint32_t lop3(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t d;
  asm("lop3.b32 %0, %1, %2, %3, %4;\n" : "=r"(d) : "r"(a), "r"(b), "r"(c), "n"(LUT));
  return d;
}
constexpr int LOP3_AND_XOR = 0x6A;   // (a & b) ^ c
constexpr int LOP3_AND_OR = 0xEA;    // (a & b) | c

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

// BYTES (16, 8 or 4) from global to the shared address dst, asynchronously;
// ok == false fills zeros and reads nothing.  L2_256: ask the L2 to fetch the
// whole 256-byte block around src (the next stages of a row that a stage
// reads in short pieces).
template <int BYTES, bool L2_256 = false>
__device__ __forceinline__ void cp_async_s(uint32_t dst, const void* src, bool ok) {
  const int n = ok ? BYTES : 0;
  if constexpr (BYTES == 16 && L2_256)
    asm volatile("cp.async.cg.shared.global.L2::256B [%0], [%1], 16, %2;\n" ::"r"(dst),
                 "l"(src), "r"(n));
  else if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(n));
  else if constexpr (L2_256)
    asm volatile("cp.async.ca.shared.global.L2::256B [%0], [%1], %2, %3;\n" ::"r"(dst),
                 "l"(src), "n"(BYTES), "r"(n));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(dst), "l"(src),
                 "n"(BYTES), "r"(n));
}
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src, bool ok) {
  cp_async_s<BYTES>(smem_u32(dst), src, ok);
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// bf16 pair (b0, b1) from int8 bytes b0 (bits 0-7) and b1 (bits 16-23) of
// p (its other bits ignored), exact and without I2F: with the sign bit t and
// the low bits l of a byte, b = l - 128·t = (128 + l) - (128 + 128·t), and
// both terms are bf16 bit patterns 0x4300 | l and 0x4300 | (t << 7), one
// LOP3 each.
__device__ __forceinline__ uint32_t i8_pair_bf162(uint32_t p) {
  const uint32_t lo = lop3<LOP3_AND_OR>(p, 0x007F007Fu, 0x43004300u);
  const uint32_t hi = lop3<LOP3_AND_OR>(p, 0x00800080u, 0x43004300u);
  return as_u32(__hsub2(as_bf162(lo), as_bf162(hi)));
}

// bf16 pair (n0, n1) from the two's-complement nibbles at bits 0-3 and
// 16-19 of p (its other bits ignored), exact and without I2F: one LOP3
// masks them, flips their sign bits (n + 8) and sets the exponent, (p &
// 0x000F000F) ^ 0x43084308 = the bf16 bit patterns of 128 + n + 8; one HSUB2
// takes 136 off.
__device__ __forceinline__ uint32_t nibble_pair_bf162(uint32_t p) {
  const uint32_t v = lop3<LOP3_AND_XOR>(p, 0x000F000Fu, 0x43084308u);
  return as_u32(__hsub2(as_bf162(v), as_bf162(0x43084308u)));   // 0x4308: 136
}

__device__ __forceinline__ uint32_t hmul2_u32(uint32_t a, uint32_t b) {
  return as_u32(__hmul2(as_bf162(a), as_bf162(b)));
}

// The widening of every GEMM kernel here: raw weight bytes as ldmatrix
// delivers them → bf16 pairs for mma.sync / wgmma, exact and without I2F
// (a shift or a PRMT where the pair is not in place, one or two LOP3s and an
// HSUB2 a pair), then, with SCALE, times the block scale as one bf16 HMUL2
// (the JAX body's bf16(q) · bf16(s), one rounding).
//
// widen_kn: a [k][n] byte tile regrouped by ldmatrix.trans, r = bytes (k,
// c), (k, c+1), (k+1, c), (k+1, c+1) of int8 values; or packed bytes of byte
// rows j, j+1, whose low (ks = 0) or high (ks = 1) nibbles are k = j + 16·ks.
// e = the pair (k, k+1) of the even column c, times sc_e; o = that of the
// odd column c + 1, times sc_o.
template <bool PACKED, bool SCALE>
__device__ __forceinline__ void widen_kn(uint32_t r, int ks, uint32_t sc_e, uint32_t sc_o,
                                         uint32_t& e, uint32_t& o) {
  if constexpr (PACKED) {
    e = nibble_pair_bf162(r >> (4 * ks));
    o = nibble_pair_bf162(r >> (8 + 4 * ks));
  } else {
    e = i8_pair_bf162(r);                      // bytes 0 and 2 are in place
    o = i8_pair_bf162(r >> 8);
  }
  if constexpr (SCALE) {
    e = hmul2_u32(e, sc_e);
    o = hmul2_u32(o, sc_o);
  }
}

// The mma A fragment of 16 columns × k16 (rows 0-7 the even, rows 8-15 the
// odd columns of a 16-column chunk) from its two ldmatrix.trans registers:
// r[0] k rows 0-7, r[1] k rows 8-15 (packed: byte rows, nibble half ks).
template <bool PACKED, bool SCALE>
__device__ __forceinline__ void kn_a_fragment(const uint32_t* r, int ks, const uint32_t* sc,
                                              uint32_t* a) {
#pragma unroll
  for (int h = 0; h < 2; ++h) widen_kn<PACKED, SCALE>(r[h], ks, sc[0], sc[1], a[2 * h], a[2 * h + 1]);
}

// widen_nk: an [n][k] byte tile through plain ldmatrix, r = k 4t .. 4t+3 of
// one column (int8), or packed bytes whose low (ks = 0) or high (ks = 1)
// nibbles are those k (+16·ks).  p[0] = the pair (4t, 4t+1), p[1] = (4t+2,
// 4t+3), times the column's scale sc: the k order of an mma fragment
// permuted, so the other operand takes the same permutation (8-byte loads).
template <bool PACKED, bool SCALE>
__device__ __forceinline__ void widen_nk(uint32_t r, int ks, uint32_t sc, uint32_t* p) {
  if constexpr (PACKED) {
    p[0] = nibble_pair_bf162(__byte_perm(r, 0, 0x4140) >> (4 * ks));
    p[1] = nibble_pair_bf162(__byte_perm(r, 0, 0x4342) >> (4 * ks));
  } else {
    p[0] = i8_pair_bf162(__byte_perm(r, 0, 0x4140));
    p[1] = i8_pair_bf162(__byte_perm(r, 0, 0x4342));
  }
  if constexpr (SCALE) {
    p[0] = hmul2_u32(p[0], sc);
    p[1] = hmul2_u32(p[1], sc);
  }
}

// A column's (or a column pair's) f32 block scales as duplicated bf16 pairs
__device__ __forceinline__ uint32_t bf16_dup(float s) {
  const __nv_bfloat16 h = __float2bfloat16_rn(s);
  return as_u32(__halves2bfloat162(h, h));
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
// nibble_pair_bf162), times the block scales as bf16 (the JAX body's
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
          sc[mt][0] = bf16_dup(f.x);
          sc[mt][1] = bf16_dup(f.y);
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
            kn_a_fragment<true, !CHANNEL>(r + 2 * mt, ks, sc[mt], af[2 * b + ks][mt]);
      } else {
#pragma unroll
        for (int ks = 0; ks < 2; ++ks) {
          uint32_t r[4];                       // k rows 0-7 / 8-15 of the k16, tiles 0 / 1
          const int kr = b * BK + ks * 16 + li + 8 * (lm & 1);
          ldmatrix_x4(r, ws + kr * PF_BN + ((cl ^ (kr & 7)) << 4), true);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
            kn_a_fragment<false, !CHANNEL>(r + 2 * mt, ks, sc[mt], af[2 * b + ks][mt]);
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
      uint32_t sc[4 * NQ] = {};                              // column scales as bf16 pairs
      if constexpr (!CHANNEL) {
#pragma unroll
        for (int j = 0; j < 4 * NQ; ++j) sc[j] = bf16_dup(ss[b * PF_BN + wn * WN + 8 * j + g]);
      }
      uint32_t raw[NQ][4];                                   // packed: both k16 steps
      if constexpr (PACKED) {
#pragma unroll
        for (int q = 0; q < NQ; ++q) {
          const int nr = wn * WN + 32 * q + 8 * lm + li;
          ldmatrix_x4(raw[q], ws + nr * 32 + ((b ^ ((nr >> 2) & 1)) << 4), false);
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
          uint32_t r4[4];
          if constexpr (PACKED) {
#pragma unroll
            for (int j = 0; j < 4; ++j) r4[j] = raw[q][j];
          } else {
            const int nr = wn * WN + 32 * q + 8 * lm + li;
            const int c = kk / 16;
            ldmatrix_x4(r4, ws + nr * 64 + ((c ^ ((nr >> 1) & 3)) << 4), false);
          }
#pragma unroll
          for (int j = 0; j < 4; ++j) widen_nk<PACKED, !CHANNEL>(r4[j], ks, sc[4 * q + j], bf[j]);
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

// ---------------------------------------------------------------------------
// Decode (M <= 16): a cp.async ring of raw weight bytes into mma.sync tiles
// ---------------------------------------------------------------------------

constexpr int DECODE_MAX_M = 16;   // M <= 16: qmm_decode_kernel
constexpr int DC_BN = 256;         // columns of a CTA strip (a whole swiglu pair group)
constexpr int DC_CTAS_PER_SM = 2;  // resident CTAs an SM, which the split plan fills
constexpr int DC_MT = 16;          // x rows a stage holds (two n8 tiles of tokens)
constexpr int DC_ZLOADS = 8;       // partial float4 loads in flight a thread (the finish)
constexpr int DC_SPLIT_ALIGN = 4;  // a split's blocks: a multiple of 4 (whole stages, and
                                   // [N, K] scale copies of 8 / 16 bytes)

// One ring stage: the raw weight bytes as a tile of ROWS rows of ROW bytes,
// 16-byte chunk c of row r at c ^ (r & 7) — [K, N] int8 / [K/2, N] packed: 64
// (byte) rows of the strip's 256 columns (16 KB, 64 / 128 k); [N, K] / [N,
// K/2]: 128 bytes of each of the strip's 256 rows (32 KB, 128 / 256 k: a row's
// DRAM reads twice as long as with 64 bytes) — their block scales (f32
// [SB][256]; [N, K]: [256][SB]) and the x rows (bf16 [16][SK], chunk c of row
// r at c ^ (r & 7)): the ldmatrix reads below are free of bank conflicts.
// [K, N] keeps 3 slots, [N, K] 2 (two CTAs an SM either way).  After the
// loop the ring holds the CTA's f32 sums (the finish tile, [DC_MT][DC_BN]).
template <bool PACKED, bool TRANS>
struct Dc {
  static constexpr int ROW = TRANS ? 128 : DC_BN;     // bytes of a weight tile row
  static constexpr int ROWS = TRANS ? DC_BN : 64;     // weight tile rows
  static constexpr int SB = (TRANS ? 2 : 1) * (PACKED ? 4 : 2);   // 32-k blocks a stage
  static constexpr int SK = SB * BK;                  // k a stage
  static constexpr int W_BYTES = ROW * ROWS;
  static constexpr int S_BYTES = SB * DC_BN * 4;
  static constexpr int X_ROW = SK * 2;                // bytes of an x row
  static constexpr int STAGE = W_BYTES + S_BYTES + DC_MT * X_ROW;
  static constexpr int STAGES = TRANS ? 2 : 3;        // ring slots, loads STAGES - 1 ahead
  static constexpr int SMEM = STAGES * STAGE;
};
// two CTAs an SM (228 KB of shared memory, 1 KB of it reserved per CTA)
static_assert(DC_CTAS_PER_SM * (Dc<true, true>::SMEM + 1024 + 16) <= 233472 &&
                  DC_CTAS_PER_SM * (Dc<true, false>::SMEM + 1024 + 16) <= 233472,
              "two decode CTAs an SM");
static_assert(THREADS == DC_BN && DECODE_MAX_M <= DC_MT &&
                  DC_MT * DC_BN * 4 <= Dc<false, false>::SMEM,
              "the finish: a thread a column, the tile in the ring");

// A thread's share of every ring stage of its split, stage after stage:
// the raw weight bytes of columns n0 .. n0+255, their block scales and x
// rows 0 .. 8·NT - 1, zero-filled past M, N and the split's last block.  A
// thread copies the same chunks of every stage, so their shared offsets and
// column predicates are set up once and its global pointers advance by a
// constant a stage.  One cp.async group a stage, committed by the caller.
template <int NT, bool PACKED, bool CHANNEL, bool TRANS>
struct DcLoader {
  using C = Dc<PACKED, TRANS>;
  static constexpr int W_ITERS = C::W_BYTES / 16 / THREADS;         // weight chunks, 4096 B apart
  static constexpr int W_CH = C::ROW / 16;                           // chunks of a tile row
  // [N, K]: the L2 fetches 256 bytes around each read of a row, the next
  // stage's bytes too (measured with 64-byte stages on the H100: w13 Q8_0
  // 15 % faster; [K, N] reads 256-byte rows already and gained nothing)
  static constexpr bool L2_256 = TRANS;
  static constexpr int XCH = C::SK / 8;                              // chunks of an x row
  static constexpr int X_ITERS = (8 * NT * XCH + THREADS - 1) / THREADS;
  static constexpr int X_RSTEP = THREADS / XCH;                      // x rows between them
  const int8_t* w0;          // a valid address for the chunks that read nothing
  const float* s0;
  const __nv_bfloat16* x0;
  const int8_t* wp;          // the thread's first weight chunk of the next stage
  size_t w_step, w_adv;      // bytes between its chunks of a stage; a stage's advance
  const float* sp;           // its scale copy of the next stage
  size_t s_adv;
  const __nv_bfloat16* xp;   // its first x chunk of the next stage
  size_t x_step;             // elements between its x chunks
  uint32_t w_sm, s_sm, x_sm; // shared offsets within a stage
  int w_blk, s_blk, x_blk;   // blocks of the chunks within a stage
  int left;                  // blocks of the split from the next stage on
  bool w_ok[W_ITERS], s_on, s_ok, s_vec, x_ok[X_ITERS];

  __device__ __forceinline__ DcLoader(const __nv_bfloat16* x, const int8_t* w, const float* s,
                                      int M, int N, int K, int n0, int kb_begin, int kb_end)
      : w0(w), s0(s), x0(x) {
    const int tid = threadIdx.x, nb = K / BK;
    left = kb_end - kb_begin;
    const int r = tid / W_CH, c = tid % W_CH;  // tile row r + (THREADS / W_CH)·j, chunk c
    w_sm = r * C::ROW + ((c ^ (r & 7)) << 4);
    if constexpr (!TRANS) {                    // byte rows of the k range, 256 columns
      const int rows = PACKED ? BK / 2 : BK;   // byte rows of a block
      wp = w + ((size_t)kb_begin * rows + r) * N + n0 + c * 16;
      w_step = (size_t)(THREADS / W_CH) * N;
      w_adv = (size_t)C::ROWS * N;
      w_blk = 0;
#pragma unroll
      for (int j = 0; j < W_ITERS; ++j) w_ok[j] = n0 + c * 16 < N;
    } else {                                   // the strip's rows, ROW bytes of each
      const size_t row = PACKED ? K / 2 : K;
      wp = w + (size_t)(n0 + r) * row + (size_t)kb_begin * (PACKED ? BK / 2 : BK) + c * 16;
      w_step = (THREADS / W_CH) * row;
      w_adv = C::ROW;
      w_blk = PACKED ? c : c / 2;
#pragma unroll
      for (int j = 0; j < W_ITERS; ++j) w_ok[j] = n0 + r + (THREADS / W_CH) * j < N;
    }
    s_on = false;
    if constexpr (!CHANNEL) {
      if constexpr (TRANS) {                   // [N, K/32] → [256][SB], a row's SB floats
        sp = s + (size_t)(n0 + tid) * nb + kb_begin;
        s_adv = C::SB;
        s_sm = tid * C::SB * 4;
        s_blk = 0;
        s_on = true;
        s_ok = n0 + tid < N;
        s_vec = nb % 4 == 0;                   // kb_begin % 4 == 0 (the plan): aligned
      } else {                                 // [K/32, N] → [SB][256], 4 floats a copy
        const int b = tid / (DC_BN / 4), c = tid % (DC_BN / 4);
        sp = s + (size_t)(kb_begin + b) * N + n0 + c * 4;
        s_adv = (size_t)C::SB * N;
        s_sm = (b * DC_BN + c * 4) * 4;
        s_blk = b;
        s_on = tid < C::SB * DC_BN / 4;
        s_ok = n0 + c * 4 < N;
      }
    }
    const int xr = tid / XCH, xc = tid % XCH;  // x row xr + X_RSTEP·j, chunk xc
    xp = x + (size_t)xr * K + (size_t)kb_begin * BK + xc * 8;
    x_step = (size_t)X_RSTEP * K;
    x_sm = xr * C::X_ROW + ((xc ^ (xr & 7)) << 4);
    x_blk = xc / 4;
#pragma unroll
    for (int j = 0; j < X_ITERS; ++j) x_ok[j] = xr + X_RSTEP * j < M;
  }

  // the next stage into the ring slot at shared address st
  __device__ __forceinline__ void load(uint32_t st) {
#pragma unroll
    for (int j = 0; j < W_ITERS; ++j) {
      const int blk = TRANS ? w_blk : (PACKED ? j : j / 2);
      const bool ok = w_ok[j] && blk < left;
      cp_async_s<16, L2_256>(st + w_sm + j * 4096, ok ? wp + j * w_step : w0, ok);
    }
    if constexpr (!CHANNEL) {
      const uint32_t ss = st + C::W_BYTES + s_sm;
      if constexpr (TRANS) {
        if (s_vec) {                           // kb0 % 4 == 0: 4 blocks a 16-byte copy
#pragma unroll
          for (int h = 0; h < C::SB / 4; ++h) {
            const bool ok = s_ok && 4 * h < left;
            cp_async_s<16, L2_256>(ss + h * 16, ok ? sp + 4 * h : s0, ok);
          }
        } else {
#pragma unroll
          for (int b = 0; b < C::SB; ++b) {
            const bool ok = s_ok && b < left;
            cp_async_s<4>(ss + b * 4, ok ? sp + b : s0, ok);
          }
        }
      } else if (s_on) {
        const bool ok = s_ok && s_blk < left;
        cp_async_s<16>(ss, ok ? sp : s0, ok);
      }
      sp += s_adv;
    }
#pragma unroll
    for (int j = 0; j < X_ITERS; ++j) {       // rows 0 .. 8·NT - 1 (zeros past M)
      if (X_ITERS > 1 || (int)threadIdx.x < 8 * NT * XCH) {
        const bool ok = x_ok[j] && x_blk < left;
        cp_async_s<16>(st + C::W_BYTES + C::S_BYTES + x_sm + j * X_RSTEP * C::X_ROW,
                       ok ? xp + j * x_step : x0, ok);
      }
    }
    wp += w_adv;
    xp += C::SK;
    left -= C::SB;
  }
};

// The end of a decode CTA: its f32 sums of columns n0 .. n0+255 (tile, row
// m at m·DC_BN, in shared memory) through the split partials and the strip's
// counter when K is split, then the epilogue (notes at the top).  The
// partials move as float4s (a thread 4 columns of a row); one thread fences
// the CTA's partial (ordered by the barrier) and takes the ticket; the
// strip's last CTA issues every partial load of a thread (up to DC_ZLOADS)
// before it sums them in split order, so the finish costs a few L2 round
// trips, not one a row and split.
template <int NT>
__device__ __forceinline__ void dc_finish(float* tile, const Epi& ep, void* out,
                                          float* partial, int* counters, int M, int N,
                                          int splits, bool swiglu) {
  constexpr int P = (8 * NT * DC_BN / 4 + THREADS - 1) / THREADS;  // float4s a thread
  constexpr int ZB = (DC_ZLOADS + P - 1) / P;                      // splits a round
  __shared__ int last;
  const int tid = threadIdx.x, strip = blockIdx.x, n0 = strip * DC_BN;
  if (splits > 1) {
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int i = tid + p * THREADS, m = i / (DC_BN / 4), c = i % (DC_BN / 4) * 4;
      if (m < M && n0 + c < N)                 // N % 16 == 0: all 4 columns or none
        *reinterpret_cast<float4*>(partial + ((size_t)blockIdx.y * M + m) * N + n0 + c) =
            *reinterpret_cast<const float4*>(tile + m * DC_BN + c);
    }
    __syncthreads();
    if (tid == 0) {
      __threadfence();                         // the CTA's partial before its ticket
      last = atomicAdd(counters + strip, 1) == splits - 1;
      if (last) counters[strip] = 0;           // every split has taken its ticket
      __threadfence();
    }
    __syncthreads();
    if (!last) return;
    const size_t zs = (size_t)M * N;           // a split's stride
    float4 v[P];
    bool ok[P];
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int i = tid + p * THREADS, m = i / (DC_BN / 4), c = i % (DC_BN / 4) * 4;
      v[p] = make_float4(0.f, 0.f, 0.f, 0.f);
      ok[p] = m < M && n0 + c < N;
    }
    for (int z0 = 0; z0 < splits; z0 += ZB) {
      float4 q[ZB][P];
#pragma unroll
      for (int j = 0; j < ZB; ++j)
#pragma unroll
        for (int p = 0; p < P; ++p) {
          const int i = tid + p * THREADS, m = i / (DC_BN / 4), c = i % (DC_BN / 4) * 4;
          if (ok[p] && z0 + j < splits)
            q[j][p] = __ldcg(reinterpret_cast<const float4*>(partial + (z0 + j) * zs +
                                                             (size_t)m * N + n0 + c));
        }
#pragma unroll
      for (int j = 0; j < ZB; ++j)             // in split order: the same bits every call
#pragma unroll
        for (int p = 0; p < P; ++p)
          if (ok[p] && z0 + j < splits) {
            v[p].x += q[j][p].x;
            v[p].y += q[j][p].y;
            v[p].z += q[j][p].z;
            v[p].w += q[j][p].w;
          }
    }
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int i = tid + p * THREADS, m = i / (DC_BN / 4), c = i % (DC_BN / 4) * 4;
      if (ok[p]) *reinterpret_cast<float4*>(tile + m * DC_BN + c) = v[p];
    }
    __syncthreads();
  }
  const int col = n0 + tid;                    // a thread a column from here
  const float cs = ep.ch_scale != nullptr && col < N ? ep.ch_scale[col] : 1.f;
  const float cb = ep.bias != nullptr && col < N ? ep.bias[col] : 0.f;
  if (!swiglu) {
    if (col < N)
      for (int m = 0; m < M; ++m)
        store_kind(out, (size_t)m * N + col, epi_float_col(tile[m * DC_BN + tid], cs, cb, ep),
                   ep);
    return;
  }
  for (int m = 0; m < M; ++m)                  // swiglu: N % 256 == 0, the strip is whole
    tile[m * DC_BN + tid] = epi_float_col(tile[m * DC_BN + tid], cs, cb, ep);
  __syncthreads();
  if (tid < SWIGLU_HALF)
    for (int m = 0; m < M; ++m) {
      const float h1 = tile[m * DC_BN + tid], h3 = tile[m * DC_BN + SWIGLU_HALF + tid];
      store_kind(out, (size_t)m * (N / 2) + strip * SWIGLU_HALF + tid,
                 h1 / (1.f + expf(-h1)) * h3, ep);
    }
}

// Decode variant (M <= 16), every layout: [K, N] int8 and [K/2, N] packed,
// or with TRANS [N, K] int8 and [N, K/2] packed.  CTA (strip, split) owns
// columns n0 .. n0+255 and the split's 32-k blocks; warp w owns 32 of the
// columns as two 16-column mma tiles, over every k.  The product is taken
// transposed, out^T[n][m] = Σ_k W[k][n] · x[m][k]: the weights are
// m16n8k16's A, widened from the ring by ldmatrix.trans + kn_a_fragment, or
// by ldmatrix + widen_nk with the k order of a fragment permuted; x^T is B,
// read by ldmatrix (TRANS: 8-byte loads in the permuted order), NT n8 tiles
// of tokens whose rows past M are zeros.  Loads run C::STAGES - 1 stages
// ahead, one barrier a stage; then the finish (dc_finish).  STREAM: the
// ring alone, no math and no output (the bench's copy rate).
template <int NT, bool PACKED, bool CHANNEL, bool TRANS, bool STREAM = false>
__global__ void __launch_bounds__(THREADS, DC_CTAS_PER_SM)
qmm_decode_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ w,
                  const float* __restrict__ s, Epi ep, void* __restrict__ out,
                  float* __restrict__ partial, int* __restrict__ counters, int M, int N,
                  int K, int blocks_per_split, int splits, int swiglu) {
  using C = Dc<PACKED, TRANS>;
  extern __shared__ __align__(16) unsigned char dc_smem[];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, tig = lane % 4;      // mma fragment coordinates
  const int lm = lane / 8, li = lane % 8;      // ldmatrix: matrix and row of this lane
  const int n0 = blockIdx.x * DC_BN;
  const int kb_begin = blockIdx.y * blocks_per_split;
  const int kb_end = min(K / BK, kb_begin + blocks_per_split);
  const int n_st = max(0, (kb_end - kb_begin + C::SB - 1) / C::SB);
  const int cb = warp * 32;                    // this warp's columns, relative to n0

  float acc[2][NT][4];                         // [column tile][token tile][fragment]
#pragma unroll
  for (int t = 0; t < 2; ++t)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[t][nt][e] = 0.f;

  // blocks past the split's end are zero-filled (their scales may be real):
  // they add zeros, so every stage runs whole
  auto compute = [&](const unsigned char* st) {
    const float* ss = reinterpret_cast<const float*>(st + C::W_BYTES);
    const unsigned char* xs = st + C::W_BYTES + C::S_BYTES;
#pragma unroll
    for (int b = 0; b < C::SB; ++b) {
      uint32_t xb[NT][2][2];                   // B of the block's two k16 steps
      if constexpr (!TRANS) {
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          uint32_t r[4];                       // k 0-7, 8-15, 16-23, 24-31 of the block
          const int row = nt * 8 + li, c = b * 4 + lm;
          ldmatrix_x4(r, xs + row * C::X_ROW + ((c ^ (row & 7)) << 4), false);
#pragma unroll
          for (int j = 0; j < 4; ++j) xb[nt][j / 2][j % 2] = r[j];
        }
      } else {                                 // k = 16·ks + 4·tig .. +3 of the block
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int ks = 0; ks < 2; ++ks) {
            const int row = nt * 8 + g, c = b * 4 + 2 * ks + tig / 2;
            const uint2 v = *reinterpret_cast<const uint2*>(
                xs + row * C::X_ROW + ((c ^ (row & 7)) << 4) + (tig & 1) * 8);
            xb[nt][ks][0] = v.x;
            xb[nt][ks][1] = v.y;
          }
      }
      uint32_t sc[2][2] = {};                  // [tile][even, odd column / rows g, g + 8]
      uint32_t r[4];
      if constexpr (!TRANS) {
        if constexpr (!CHANNEL) {
#pragma unroll
          for (int t = 0; t < 2; ++t) {
            const float2 f =
                *reinterpret_cast<const float2*>(ss + b * DC_BN + cb + 16 * t + 2 * g);
            sc[t][0] = bf16_dup(f.x);
            sc[t][1] = bf16_dup(f.y);
          }
        }
        const int cl = cb / 16 + (lm >> 1);    // the chunk this lane's ldmatrix row reads
#pragma unroll
        for (int ks = 0; ks < 2; ++ks) {
          if (!PACKED || ks == 0) {            // packed: one load, both nibble halves
            const int kr = (PACKED ? b * 16 : b * BK + ks * 16) + li + 8 * (lm & 1);
            ldmatrix_x4(r, st + kr * C::ROW + ((cl ^ (kr & 7)) << 4), true);
          }
#pragma unroll
          for (int t = 0; t < 2; ++t) {
            uint32_t a[4];
            kn_a_fragment<PACKED, !CHANNEL>(r + 2 * t, ks, sc[t], a);
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) mma_bf16(acc[t][nt], a, xb[nt][ks]);
          }
        }
      } else {
        if constexpr (!CHANNEL) {
#pragma unroll
          for (int t = 0; t < 2; ++t)
#pragma unroll
            for (int h = 0; h < 2; ++h) sc[t][h] = bf16_dup(ss[(cb + 16 * t + 8 * h + g) * C::SB + b]);
        }
        const int nr = cb + 8 * lm + li;       // the row this lane's ldmatrix reads
#pragma unroll
        for (int ks = 0; ks < 2; ++ks) {
          if (!PACKED || ks == 0) {            // packed: one 16-byte block, both halves
            const int c = PACKED ? b : 2 * b + ks;
            ldmatrix_x4(r, st + nr * C::ROW + ((c ^ (nr & 7)) << 4), false);
          }
#pragma unroll
          for (int t = 0; t < 2; ++t) {
            uint32_t p0[2], p1[2];             // rows g and g + 8 of the tile
            widen_nk<PACKED, !CHANNEL>(r[2 * t], ks, sc[t][0], p0);
            widen_nk<PACKED, !CHANNEL>(r[2 * t + 1], ks, sc[t][1], p1);
            const uint32_t a[4] = {p0[0], p1[0], p0[1], p1[1]};
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) mma_bf16(acc[t][nt], a, xb[nt][ks]);
          }
        }
      }
    }
  };

  DcLoader<NT, PACKED, CHANNEL, TRANS> loader(x, w, s, M, N, K, n0, kb_begin, kb_end);
  const uint32_t ring = smem_u32(dc_smem);
#pragma unroll
  for (int t = 0; t < C::STAGES - 1; ++t) {
    if (t < n_st) loader.load(ring + t * C::STAGE);
    cp_async_commit();
  }
  for (int t = 0; t < n_st; ++t) {
    cp_async_wait<C::STAGES - 2>();            // stage t has landed (later ones may not)
    __syncthreads();                           // ... for every thread; stage t-1's slot is free
    const int nt = t + C::STAGES - 1;
    if (nt < n_st) loader.load(ring + (nt % C::STAGES) * C::STAGE);
    cp_async_commit();
    if constexpr (!STREAM) compute(dc_smem + (t % C::STAGES) * C::STAGE);
  }
  cp_async_wait<0>();
  if constexpr (!STREAM) {
    __syncthreads();                           // the ring becomes the finish tile
    // acc[t][nt][e]: token 8·nt + 2·tig + (e & 1); [K, N]: column cb + 16t + 2g
    // (e < 2) or + 1 (e >= 2); TRANS: column cb + 16t + g (e < 2) or + 8
    float* tile = reinterpret_cast<float*>(dc_smem);
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        float* row = tile + (8 * nt + 2 * tig) * DC_BN;
        const int c = TRANS ? cb + 16 * t + g : cb + 16 * t + 2 * g;
        const int c2 = TRANS ? c + 8 : c + 1;
        row[c] = acc[t][nt][0];
        row[DC_BN + c] = acc[t][nt][1];
        row[c2] = acc[t][nt][2];
        row[DC_BN + c2] = acc[t][nt][3];
      }
    __syncthreads();
    dc_finish<NT>(tile, ep, out, partial, counters, M, N, splits, swiglu != 0);
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
  float* partial;      // workspace [splits, M, N], or null (see workspace_floats)
  int* counters;       // decode: one per 256-column strip, zero between launches
  int M, N, K, splits, blocks_per_split;
  bool swiglu;
  cudaStream_t stream;
};

long long reduce_launches = 0;   // qmm_reduce launches of this library (host count)

void reduce(const Launch& a) {
  ++reduce_launches;
  const size_t n = (size_t)a.M * (a.swiglu ? a.N / 2 : a.N);
  const unsigned grid = static_cast<unsigned>((n + 255) / 256);
  if (a.swiglu)
    qmm_reduce<true><<<grid, 256, 0, a.stream>>>(a.partial, a.ep, a.out, a.M, a.N, a.splits);
  else
    qmm_reduce<false><<<grid, 256, 0, a.stream>>>(a.partial, a.ep, a.out, a.M, a.N, a.splits);
}

// qmm_decode_kernel (M <= 16): grid (strips, splits), one launch whatever
// the epilogue
template <bool PACKED, bool CHANNEL, bool TRANS, bool STREAM = false>
void launch_decode(const Launch& a) {
  auto kernel = qmm_decode_kernel<1, PACKED, CHANNEL, TRANS, STREAM>;
  if constexpr (!STREAM) {
    if (a.M > 8) kernel = qmm_decode_kernel<2, PACKED, CHANNEL, TRANS, STREAM>;
  }
  constexpr int smem = Dc<PACKED, TRANS>::SMEM;
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem) !=
      cudaSuccess)
    return;                                      // the error stays for run() to return
  const dim3 grid((a.N + DC_BN - 1) / DC_BN, a.splits);
  kernel<<<grid, THREADS, smem, a.stream>>>(
      static_cast<const __nv_bfloat16*>(a.x), static_cast<const int8_t*>(a.w),
      static_cast<const float*>(a.s), a.ep, a.out, a.partial, a.counters, a.M, a.N, a.K,
      a.blocks_per_split, a.splits, a.swiglu ? 1 : 0);
}

// qmm_wgmma_kernel / qmm_mma_t_kernel (M > 16): 128-token tiles, M the
// fastest grid dimension, so the CTAs in flight share each weight tile and x
// stays in L2; qmm_reduce after it when the workspace is in use
template <typename OutT, typename Kernel>
void launch_prefill(Kernel kernel, const Launch& a, int smem) {
  const dim3 grid((a.M + PF_BM - 1) / PF_BM, (a.N + PF_BN - 1) / PF_BN, a.splits);
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem) !=
      cudaSuccess)
    return;
  kernel<<<grid, THREADS, smem, a.stream>>>(
      static_cast<const __nv_bfloat16*>(a.x), static_cast<const int8_t*>(a.w),
      static_cast<const float*>(a.s), a.ep, static_cast<OutT*>(a.out), a.partial, a.M, a.N,
      a.K, a.blocks_per_split);
  if (a.partial != nullptr && cudaPeekAtLastError() == cudaSuccess) reduce(a);
}

template <bool PACKED, bool CHANNEL, bool TRANS, typename OutT>
void dispatch_prefill(const Launch& a) {
  if constexpr (TRANS)
    launch_prefill<OutT>(qmm_mma_t_kernel<PACKED, CHANNEL, OutT>, a, Pf<PACKED>::SMEM);
  else
    launch_prefill<OutT>(qmm_wgmma_kernel<PACKED, CHANNEL, OutT>, a, Pf<PACKED>::SMEM);
}

// The prefill kernels write f32 (partials, or the output) or bf16; an
// integer output always goes through the workspace and qmm_reduce.
template <bool PACKED, bool TRANS>
void dispatch_t(const Launch& a, bool channel) {
  if (a.M <= DECODE_MAX_M) {
    if (channel) launch_decode<PACKED, true, TRANS>(a);
    else launch_decode<PACKED, false, TRANS>(a);
    return;
  }
  const bool bf16 = a.ep.out_kind == OUT_BF16 && a.partial == nullptr;
  if (channel) {
    if (bf16) dispatch_prefill<PACKED, true, TRANS, __nv_bfloat16>(a);
    else dispatch_prefill<PACKED, true, TRANS, float>(a);
  } else {
    if (bf16) dispatch_prefill<PACKED, false, TRANS, __nv_bfloat16>(a);
    else dispatch_prefill<PACKED, false, TRANS, float>(a);
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

// Split K across CTAs; the plan does not depend on the weight layout.
// Decode: as many splits (of a multiple of DC_SPLIT_ALIGN blocks) as let
// the strips' CTAs fill the card's DC_CTAS_PER_SM slots an SM in one wave
// (w13: 86 strips × 3 splits on 132 SMs; wo: 16 × 16; w2: 16 × 15), since
// the weight stream needs every SM's loads in flight and a second wave would
// leave a tail.  Prefill: the split count
// (at most PF_MAX_SPLITS, at least one 64-k stage a split) that minimises
// the waves of CTAs on the busiest SM times each CTA's blocks, plus the
// partials' cost: with 172 tiles (w13 at M <= 128) on 132 SMs, one split
// leaves 40 SMs two whole tiles.
cudaError_t plan_split_k(int M, int N, int K, int device, SplitK* plan) {
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
  const int strips = (N + DC_BN - 1) / DC_BN;
  const int want = std::max(1, std::min(n_blocks, DC_CTAS_PER_SM * sms / strips));
  const int bps = (std::max(1, (n_blocks + want - 1) / want) + DC_SPLIT_ALIGN - 1) /
                  DC_SPLIT_ALIGN * DC_SPLIT_ALIGN;
  plan->blocks_per_split = bps;
  plan->splits = std::max(1, (n_blocks + bps - 1) / bps);
  return cudaSuccess;
}

// Floats of f32 workspace for [M,K]·[K,N] on `device`: the split partial
// sums [splits, M, N].  Decode: when K is split or the swiglu epilogue pairs
// columns.  Prefill: also without a split when the epilogue goes through
// qmm_reduce (reduce_epi: an integer output, an epilogue_scale, or a channel
// scale with a bias).  0 when none of these.
long long workspace_floats(int M, int N, int K, bool swiglu, bool reduce_epi, int device,
                           cudaError_t* err) {
  SplitK plan;
  *err = plan_split_k(M, N, K, device, &plan);
  if (*err != cudaSuccess) return -1;
  const bool need = plan.splits > 1 || swiglu || (M > DECODE_MAX_M && reduce_epi);
  return need ? (long long)plan.splits * M * N : 0;
}

// The body of each library's C entry point: plan, check the workspace and
// the decode counters, launch, and return the launch's CUDA error.
// scale_kind: 0 block, 1 channel, 2 none; out_kind: epilogue.cuh OutKind.
template <bool PACKED>
int run(const void* x, const void* w, const void* s, const void* bias, void* out, int out_kind,
        int scale_kind, int swiglu, int trans, float e, int has_e, float zp, void* workspace,
        long long ws_floats, void* counters, int counter_slots, int M, int N, int K,
        int device, void* stream) {
  SplitK plan;
  const bool reduce_epi = out_kind >= OUT_I8 || has_e || (scale_kind == 1 && bias != nullptr);
  cudaError_t err = plan_split_k(M, N, K, device, &plan);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long need = workspace_floats(M, N, K, swiglu != 0, reduce_epi, device, &err);
  if (need > 0 && (workspace == nullptr || ws_floats < need))
    return static_cast<int>(cudaErrorInvalidValue);
  if (M <= DECODE_MAX_M && plan.splits > 1 &&
      (counters == nullptr || (N + DC_BN - 1) / DC_BN > counter_slots))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool channel = scale_kind != 0;
  Epi ep{scale_kind == 1 ? static_cast<const float*>(s) : nullptr,
         static_cast<const float*>(bias), e, has_e, zp, out_kind};
  Launch a{x, w, s, ep, out, need > 0 ? static_cast<float*>(workspace) : nullptr,
           static_cast<int*>(counters), M, N, K, plan.splits, plan.blocks_per_split,
           swiglu != 0, static_cast<cudaStream_t>(stream)};
  dispatch<PACKED>(a, channel, trans != 0);
  return static_cast<int>(cudaGetLastError());
}

// The decode ring alone (qmm_decode_kernel<…, STREAM>: no math, no output)
// over a block-scaled [K, N] / [K/2, N] weight, its scales and x (M <= 8),
// with the decode plan: the copy rate the kernel's loads reach.
template <bool PACKED>
int run_ring(const void* x, const void* w, const void* s, int M, int N, int K, int device,
             void* stream) {
  if (M < 1 || M > 8) return static_cast<int>(cudaErrorInvalidValue);
  SplitK plan;
  const cudaError_t err = plan_split_k(M, N, K, device, &plan);
  if (err != cudaSuccess) return static_cast<int>(err);
  Launch a{x, w, s, Epi{}, nullptr, nullptr, nullptr, M, N, K, plan.splits,
           plan.blocks_per_split, false, static_cast<cudaStream_t>(stream)};
  launch_decode<PACKED, false, false, true>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
