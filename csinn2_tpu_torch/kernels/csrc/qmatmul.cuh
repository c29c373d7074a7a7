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
// Numerics follow the f32 reference quant_matmul_ref: x · (q · s) with f32
// accumulation for block scales, (x · q) · s for channel scales.  The decode
// kernel forms q · s in f32 per weight; the prefill kernel forms the exact
// products x · q on the tensor cores (q is exact in bf16, x is bf16) and
// applies each 32-row block's f32 scale to that block's f32 partial sum, or,
// with channel scales, the column scale once to the whole sum.
//
// Bound.  At decode (M <= 16) the weight stream: K·N bytes (int8) or K·N/2
// (packed) plus the scales, read once, against 2·M·K·N flops.
// qmm_decode_kernel serves it: one CTA covers all M rows of a 128-column
// strip, so the weight is read exactly once, each weight is dequantized once
// in registers and feeds M FMAs, and K is split across CTAs (split-K, sized
// by plan_split_k) until the grid fills the card.  Each thread reads two
// adjacent (byte) rows per 8-byte load pair; in the packed layout those give
// four weight rows, whose activations are two bf16x2 loads.  At prefill
// (M > 16) the 2·M·K·N flops bound it: qmm_mma_kernel stages each 32-row
// block of weights in shared memory as bf16 (a packed block unpacks its 16
// byte rows into 32 rows there) and runs mma.sync bf16 tiles.  wgmma/TMA
// pipelines are later work.
//
// TRANS.  [N, K] is the natural "col" B operand of mma.sync: the prefill
// kernel stages each 128 × 32 weight tile as [n][k] bf16 rows (16 contiguous
// bytes per thread) and reads B with a non-transposing ldmatrix.  At decode
// (M <= 16) qmm_t_decode_kernel gives each warp one output column: its 32
// lanes stream 16 contiguous bytes of the column's K row each (a whole
// packed block, or half an int8 block, with one scale), dequantize in f32
// and FMA against all M activation rows, then sum across the warp.  No
// split-K: N/8 CTAs fill the card.
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

constexpr int MMA_BM = 64;
constexpr int XS_STRIDE = BK + 8;   // bf16 elements per smem row: conflict-free ldmatrix
constexpr int WS_STRIDE = BN + 8;
constexpr int WT_STRIDE = BK + 8;   // TRANS: [n][k] rows

// The GEMM kernels' direct write: a channel scale or a bias, never both
// and no epilogue_scale (run() sends those through qmm_reduce).
template <bool CHANNEL>
__device__ __forceinline__ float direct_epi(float v, int col, const Epi& ep) {
  if constexpr (CHANNEL) {
    if (ep.ch_scale != nullptr) v *= ep.ch_scale[col];
  }
  return ep.bias != nullptr ? v + ep.bias[col] : v;
}

// Prefill variant (M > 16): 64 × 128 output tile, 8 warps of 32 × 32.  Per
// 32-row quant block the weights are staged in shared memory as bf16 (exact
// for int8 and int4 values), x stays bf16, and the tensor cores form the
// block's partial product P = x · q with exact products and f32
// accumulation.  Block scales fold in per block as acc += s · P; channel
// scales skip P (acc += x · q directly) and apply once in the epilogue.
// TRANS stages the tile as [n][k] (see the note at the top).
template <bool PACKED, bool CHANNEL, bool TRANS, typename OutT>
__global__ void __launch_bounds__(THREADS)
qmm_mma_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ w,
               const float* __restrict__ s, Epi ep,
               OutT* __restrict__ out, float* __restrict__ partial,
               int M, int N, int K, int blocks_per_split) {
  __shared__ __align__(16) __nv_bfloat16 xs[MMA_BM * XS_STRIDE];
  __shared__ __align__(16) __nv_bfloat16 ws[TRANS ? BN * WT_STRIDE : BK * WS_STRIDE];
  __shared__ __align__(16) float ss[BN];

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wm = warp / 4, wn = warp % 4;      // warp tile rows wm*32, cols wn*32
  const int g = lane / 4, tig = lane % 4;      // mma fragment coordinates
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * MMA_BM;
  const int kb_begin = blockIdx.z * blocks_per_split;
  const int kb_end = min(K / BK, kb_begin + blocks_per_split);

  // loader roles (N % 16 == 0 and 16-byte aligned rows: checked by the
  // wrapper).  int8: 32 rows × 8 threads × 16 weights.  packed: 16 byte rows
  // × 16 threads × 8 bytes, each byte giving rows wr (low) and wr+16 (high).
  // TRANS: row n0 + tid/2 of the weight, bytes (tid%2)·16 (int8: k) or
  // (tid%2)·8 (packed: k and k+16) of this step's 32 k.
  const int wr = TRANS ? tid / 2 : (PACKED ? tid / 16 : tid / 8);
  const int wc = TRANS ? (tid % 2) * (PACKED ? 8 : 16)
                       : (PACKED ? (tid % 16) * 8 : (tid % 8) * 16);
  const bool w_ok = TRANS ? n0 + wr < N : n0 + wc < N;
  const int xr = tid / 4, xc = (tid % 4) * 8;            // 8 activations
  const bool x_ok = m0 + xr < M;
  // block scales: 4 per thread ([K/32, N]) or one per thread (TRANS, [N, K/32])
  const bool s_loader = !CHANNEL && tid < (TRANS ? BN : BN / 4);
  const bool s_ok = s_loader && n0 + (TRANS ? tid : tid * 4) < N;

  int4 w_reg = make_int4(0, 0, 0, 0);
  uint4 x_reg = make_uint4(0, 0, 0, 0);
  float4 s_reg = make_float4(0.f, 0.f, 0.f, 0.f);
  auto fetch = [&](int kb) {
    const int k0 = kb * BK;
    if (w_ok) {
      if constexpr (TRANS && PACKED) {
        const int2 v = __ldg(reinterpret_cast<const int2*>(
            w + (size_t)(n0 + wr) * (K / 2) + kb * (BK / 2) + wc));
        w_reg.x = v.x;
        w_reg.y = v.y;
      } else if constexpr (TRANS) {
        w_reg = __ldg(reinterpret_cast<const int4*>(w + (size_t)(n0 + wr) * K + k0 + wc));
      } else if constexpr (PACKED) {
        const int2 v = __ldg(reinterpret_cast<const int2*>(
            w + (size_t)(kb * (BK / 2) + wr) * N + n0 + wc));
        w_reg.x = v.x;
        w_reg.y = v.y;
      } else {
        w_reg = __ldg(reinterpret_cast<const int4*>(w + (size_t)(k0 + wr) * N + n0 + wc));
      }
    }
    if (x_ok)
      x_reg = __ldg(reinterpret_cast<const uint4*>(x + (size_t)(m0 + xr) * K + k0 + xc));
    if (s_ok) {
      if constexpr (TRANS) s_reg.x = __ldg(s + (size_t)(n0 + tid) * (K / BK) + kb);
      else s_reg = __ldg(reinterpret_cast<const float4*>(s + (size_t)kb * N + n0 + tid * 4));
    }
  };

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  if (kb_begin < kb_end) fetch(kb_begin);
  for (int kb = kb_begin; kb < kb_end; ++kb) {
    *reinterpret_cast<uint4*>(&xs[xr * XS_STRIDE + xc]) = x_reg;
    {
      if constexpr (PACKED) {
        const uint32_t* wq = reinterpret_cast<const uint32_t*>(&w_reg);
        uint32_t lo[4], hi[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {   // columns 2i (bits 0-7) and 2i+1 (bits 8-15) of p
          const uint32_t p = (wq[i / 2] ^ NIBBLE_BIAS) >> ((i % 2) * 16);
          lo[i] = biased_nibble_pair_bf162((p & 0x000Fu) | ((p & 0x0F00u) << 8));
          hi[i] = biased_nibble_pair_bf162(((p >> 4) & 0x000Fu) | ((p & 0xF000u) << 4));
        }
        // bytes 0..7 are 8 consecutive columns ([K/2, N]) or k ([N, K/2])
        if constexpr (TRANS) {
          *reinterpret_cast<uint4*>(&ws[wr * WT_STRIDE + wc]) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
          *reinterpret_cast<uint4*>(&ws[wr * WT_STRIDE + BK / 2 + wc]) =
              make_uint4(hi[0], hi[1], hi[2], hi[3]);
        } else {
          *reinterpret_cast<uint4*>(&ws[wr * WS_STRIDE + wc]) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
          *reinterpret_cast<uint4*>(&ws[(wr + BK / 2) * WS_STRIDE + wc]) =
              make_uint4(hi[0], hi[1], hi[2], hi[3]);
        }
      } else {
        const int8_t* q = reinterpret_cast<const int8_t*>(&w_reg);
        uint32_t u[8];
#pragma unroll
        for (int i = 0; i < 8; ++i)
          u[i] = pack_bf162(static_cast<float>(q[2 * i]), static_cast<float>(q[2 * i + 1]));
        uint4* dst = reinterpret_cast<uint4*>(
            &ws[TRANS ? wr * WT_STRIDE + wc : wr * WS_STRIDE + wc]);
        dst[0] = make_uint4(u[0], u[1], u[2], u[3]);
        dst[1] = make_uint4(u[4], u[5], u[6], u[7]);
      }
    }
    if (s_loader) {
      if constexpr (TRANS) ss[tid] = s_reg.x;
      else *reinterpret_cast<float4*>(&ss[tid * 4]) = s_reg;
    }
    __syncthreads();
    if (kb + 1 < kb_end) fetch(kb + 1);   // in flight while this tile is used

    float p[2][4][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) p[i][j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t a[2][4], b[4][2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        ldmatrix_x4(a[i], &xs[(wm * 32 + i * 16 + lane % 16) * XS_STRIDE + kk + (lane / 16) * 8],
                    false);
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        uint32_t r[4];
        if constexpr (TRANS)
          ldmatrix_x4(r, &ws[(wn * 32 + jj * 16 + (lane / 16) * 8 + lane % 8) * WT_STRIDE + kk +
                             ((lane / 8) % 2) * 8],
                      false);
        else
          ldmatrix_x4(r, &ws[(kk + lane % 8 + ((lane / 8) % 2) * 8) * WS_STRIDE + wn * 32 +
                             jj * 16 + (lane / 16) * 8],
                      true);
        b[2 * jj][0] = r[0]; b[2 * jj][1] = r[1];
        b[2 * jj + 1][0] = r[2]; b[2 * jj + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if constexpr (CHANNEL) mma_bf16(acc[i][j], a[i], b[j]);
          else mma_bf16(p[i][j], a[i], b[j]);
        }
    }
    if constexpr (!CHANNEL) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float s0 = ss[wn * 32 + j * 8 + tig * 2], s1 = ss[wn * 32 + j * 8 + tig * 2 + 1];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          acc[i][j][0] = fmaf(s0, p[i][j][0], acc[i][j][0]);
          acc[i][j][1] = fmaf(s1, p[i][j][1], acc[i][j][1]);
          acc[i][j][2] = fmaf(s0, p[i][j][2], acc[i][j][2]);
          acc[i][j][3] = fmaf(s1, p[i][j][3], acc[i][j][3]);
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + wn * 32 + j * 8 + tig * 2;
      if (col >= N) continue;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = m0 + wm * 32 + i * 16 + g + half * 8;
        if (row >= M) continue;
        float v0 = acc[i][j][2 * half], v1 = acc[i][j][2 * half + 1];
        if (partial != nullptr) {
          float* dst = partial + ((size_t)blockIdx.z * M + row) * N + col;
          dst[0] = v0;
          dst[1] = v1;
        } else {
          OutT* dst = out + (size_t)row * N + col;
          store_out(dst, direct_epi<CHANNEL>(v0, col, ep));
          store_out(dst + 1, direct_epi<CHANNEL>(v1, col + 1, ep));
        }
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

// kernel: qmm_mma_kernel<...> (M > 16), qmm_decode_kernel<MT, ...> or
// qmm_t_decode_kernel<MT, ...> (M <= 16); the TRANS decode kernel takes 8
// columns per CTA and no M tiles or splits
template <typename OutT, typename Kernel>
void launch(Kernel kernel, int bm, const Launch& a, bool t_decode = false) {
  dim3 grid = t_decode ? dim3((a.N + THREADS / 32 - 1) / (THREADS / 32))
                       : dim3((a.N + BN - 1) / BN, (a.M + bm - 1) / bm, a.splits);
  const bool ws = a.partial != nullptr;
  kernel<<<grid, THREADS, 0, a.stream>>>(
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
    launch<OutT>(qmm_t_decode_kernel<MT, PACKED, CHANNEL, OutT>, DECODE_MAX_M, a, true); \
  else                                                                                   \
    launch<OutT>(qmm_decode_kernel<MT, PACKED, CHANNEL, OutT>, DECODE_MAX_M, a)
  if (a.M <= 1) { CSINN2_QMM(1); }
  else if (a.M <= 2) { CSINN2_QMM(2); }
  else if (a.M <= 4) { CSINN2_QMM(4); }
  else if (a.M <= 8) { CSINN2_QMM(8); }
  else if (a.M <= DECODE_MAX_M) { CSINN2_QMM(16); }
  else launch<OutT>(qmm_mma_kernel<PACKED, CHANNEL, TRANS, OutT>, MMA_BM, a);
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

// Split K across CTAs until the grid holds about 4 CTAs per SM at decode
// (weight-stream bound: more loads in flight) and 2 per SM at prefill.  The
// TRANS decode kernel is not split.
cudaError_t plan_split_k(int M, int N, int K, bool trans, int device, SplitK* plan) {
  static int sm_count[64];   // per device, read once
  if (device < 0 || device >= 64) return cudaErrorInvalidDevice;
  if (sm_count[device] == 0) {
    const cudaError_t e =
        cudaDeviceGetAttribute(&sm_count[device], cudaDevAttrMultiProcessorCount, device);
    if (e != cudaSuccess) return e;
  }
  const bool decode = M <= DECODE_MAX_M;
  if (decode && trans) {
    plan->splits = 1;
    plan->blocks_per_split = K / BK;
    return cudaSuccess;
  }
  const int bm = decode ? DECODE_MAX_M : MMA_BM;
  const int tiles = ((N + BN - 1) / BN) * ((M + bm - 1) / bm);
  const int per_sm = decode ? 4 : 2;
  const int n_blocks = K / BK;
  const int want =
      std::max(1, std::min(n_blocks, (per_sm * sm_count[device] + tiles - 1) / tiles));
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
