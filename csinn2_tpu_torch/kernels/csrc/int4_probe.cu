// Q4_0 decode dequant-strategy probes for Hopper (sm_90a): one kernel
// instantiation per pipeline of the JAX probe.
//
// Replaces: examples/int4_dequant_probe.py, the nine bodies `_mk_call` (:75,
// pallas_call :78) launches and `run_w4a8` (:530, pallas_call :560):
//   K1 k1_planes<MT, EXTRACT, SCALE, PLANES, EPI>: the bf16 plane bodies,
//      _split_kernel :91 (shifts "i32" → EX_I32, "i8" → EX_I8),
//      _bitcast_kernel :173 (EX_LOP3), _andmask_kernel :234 (EX_AND),
//      _andmask_bf16s_kernel :395 (EX_AND, SC_BF16), _noscale_kernel :440
//      (EX_AND, SC_NONE) and _halfq8_kernel :460 (EX_BYTE, one plane);
//   K2 k2_native<MT>: _i4_kernel :141 (one unsplit plane);
//   K3 k3_stream: _stream_kernel :294;
//   K4 k4_int8<MT, W4A8>: _intdot_kernel :327 and _w4a8_kernel :497.
//
// Bound.  At M <= 16 every kernel reads the packed weight once: K·N/2 bytes
// plus the scales (f32 or bf16) and the activations, against 2·M·K·N
// operations, so HBM bounds them all (kernels/int4_probe.py notes the
// bytes of each).  The design is the port's decode GEMM (qmm_decode_kernel
// in qmatmul.cuh): one CTA of 256 threads covers `cols` output columns for
// all M rows and a K range of `ksplit` rows (split-K; the splits are
// summed by probe_reduce), each weight is loaded once, dequantized once in
// registers and feeds M FMAs (or dp4a), and U blocks are loaded before any
// is used, to keep loads in flight.  The kernels differ in their dequant
// body only, so their times rank the pipelines against quant_matmul's.
// K1 and K2 hold M·8 f32 sums and the dequantized pairs per thread: with
// the decode GEMM's U (2 blocks ahead at M = 8) they took 149-224 registers,
// one CTA per SM; capped at two CTAs per SM (<= 128 registers) with one
// block ahead they ran 22-31 % faster at w13, M = 8 (PERF.md, Findings).
//
// Thread layout.  K1 and K3 (and K2) give a thread 8 adjacent columns (an
// 8-byte load per byte row): TX = cols / 8 column groups × TK = 256 / TX row
// lanes.  K1 takes byte rows 2·(tk % 8) and +1 of every (TK / 8)-th block: a
// row pair holds rows j, j+1 (low nibbles) and j+16, j+17 (high nibbles),
// whose activations are one bf16x2 load in each of x_lo and x_hi.  K2 takes
// K rows 2·tk, 2·tk+1 of its split, TK rows pairs apart.  K4 gives a thread 4
// columns and a whole block (16 byte rows of 4 bytes, transposed 4 × 4 with
// __byte_perm so each column's 4 consecutive k sit in one word for dp4a):
// TX = cols / 4, TK = 256 / TX block lanes.  The row lanes are summed
// through shared memory at the end.
//
// Dequant pipelines (all round w·s to bf16 with one __hmul2, as the TPU
// bodies' bf16 multiplies do, then accumulate x·(w·s) in f32):
//   EX_I32  int32 shifts: (p << (28 - 8j)) >> 28, >> 28 of << (24 - 8j);
//           int → float → bf16 pairs;
//   EX_I8   byte-lane SIMD: (p & 0x0F0F0F0F) ^ 0x08.., minus 0x08.. (__vsub4)
//           sign-extends four nibbles per instruction; byte → float → bf16;
//   EX_LOP3 re-biased nibbles spread into 16-bit lanes (__byte_perm), then
//           (t & 0x000F000F) | 0x43004300 is the bf16 pair 128 + raw'
//           exactly: no int → float conversion;
//   EX_AND  p & 0x0F0F0F0F = w_lo + 8 and p & 0xF0F0F0F0 = 16·w_hi (signed
//           bytes) of the mixed pack; byte → float → bf16;
//   EX_BYTE the whole packed byte as a signed int8 (halfq8's one plane).
// K4 masks the mixed pack the same way and sums s8×s8 in int32 with
// __dp4a per 32-row block; p_lo + (p_hi >> 4) is exact (p_hi = 16·Σ).
//
// Timing-only bodies write the JAX function's value and fold the bytes the
// TPU moves but never reads (stream: the unsampled weight rows; noscale:
// the scale tile; halfq8: the x_hi tile) into a per-warp XOR checksum in
// `side`, so the loads stay in the program.
#include <algorithm>

#include "common.cuh"

namespace {

constexpr int BLK = 32;          // rows per quant block
constexpr int HB = BLK / 2;      // byte rows per block
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_M = 16;

enum Kind { SPLIT_I32, SPLIT_I8, I4NATIVE, BITCAST, ANDMASK, ANDMASK_BF16S, STREAM, INTDOT,
            W4A8, NOSCALE, HALFQ8, N_KINDS };
enum Extract { EX_I32, EX_I8, EX_LOP3, EX_AND, EX_BYTE };
enum Scale { SC_F32, SC_BF16, SC_NONE };
// what is added to the finished sum: nothing, s16[(K/bk-1)·bk/32, (n/bn)·bn]
// (noscale), x_hi[0, (K/bk-1)·bk/2] (halfq8), xw[m, n] (stream)
enum Epi { EPI_NONE, EPI_S16, EPI_XHI, EPI_XW };

struct Args {
  const void* xa;        // x_lo bf16/int8 [M, K/2], or x [M, K] (i4native bf16, w4a8 int8)
  const void* xb;        // x_hi [M, K/2]
  const float* sx;       // intdot: per-block activation scales [M, K/32]
  const int8_t* w;       // packed weights
  const void* s;         // scales [K/32, N], f32 or bf16
  const float* xw;       // stream: [M, N]
  float* out;            // [M, N]
  float* partial;        // [splits, M, N] or null (one split: the kernel writes out)
  uint32_t* side;        // checksum words [grid CTAs · WARPS] or null
  int M, N, K, cols, blocks_per_split, splits, tile_bn, tile_bk;
};

template <int EPI>
__device__ __forceinline__ float addend(const Args& a, int m, int col) {
  if constexpr (EPI == EPI_S16) {
    const int row = (a.K / a.tile_bk - 1) * (a.tile_bk / BLK);
    return __bfloat162float(
        static_cast<const __nv_bfloat16*>(a.s)[(size_t)row * a.N + (col / a.tile_bn) * a.tile_bn]);
  } else if constexpr (EPI == EPI_XHI) {
    return __bfloat162float(
        static_cast<const __nv_bfloat16*>(a.xb)[(a.K / a.tile_bk - 1) * (a.tile_bk / 2)]);
  } else if constexpr (EPI == EPI_XW) {
    return a.xw[(size_t)m * a.N + col];
  } else {
    return 0.f;
  }
}

template <int EPI>
__device__ __forceinline__ void store(const Args& a, int m, int col, float v) {
  if (a.partial != nullptr)
    a.partial[((size_t)blockIdx.y * a.M + m) * a.N + col] = v;
  else
    a.out[(size_t)m * a.N + col] = v + addend<EPI>(a, m, col);
}

// Sum the TK row lanes of each output column through shared memory and
// store rows m < M.  acc[m][j] is column tx·CPT + j of the CTA's strip.
template <int MT, int CPT, int EPI>
__device__ __forceinline__ void finish(const float (&acc)[MT][CPT], const Args& a, int tx,
                                       int tk, int TK) {
  __shared__ float red[THREADS * 8];
  const int tid = threadIdx.x, cols = a.cols;
  const int col = blockIdx.x * cols + tid;
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    if (m >= a.M) break;   // uniform across the block
#pragma unroll
    for (int j = 0; j < CPT; ++j) red[tk * cols + tx * CPT + j] = acc[m][j];
    __syncthreads();
    if (tid < cols && col < a.N) {
      float v = 0.f;
      for (int l = 0; l < TK; ++l) v += red[l * cols + tid];
      store<EPI>(a, m, col, v);
    }
    __syncthreads();
  }
}

__device__ __forceinline__ void write_checksum(const Args& a, uint32_t chk) {
  chk = __reduce_xor_sync(0xffffffffu, chk);
  if (threadIdx.x % 32 == 0)
    a.side[((size_t)blockIdx.y * gridDim.x + blockIdx.x) * WARPS + threadIdx.x / 32] = chk;
}

__device__ __forceinline__ __nv_bfloat162 bits_bf162(uint32_t u) {
  return *reinterpret_cast<const __nv_bfloat162*>(&u);
}

__device__ __forceinline__ __nv_bfloat162 int_pair(int a, int b) {
  return __floats2bfloat162_rn(static_cast<float>(a), static_cast<float>(b));
}

__device__ __forceinline__ int sbyte(uint32_t v, int i) {
  return static_cast<int8_t>(static_cast<uint8_t>(v >> (8 * i)));
}

// The plane values of columns 2h and 2h+1 of word q (bytes = 4 columns):
// lo and hi as bf16 pairs (EX_BYTE: lo only).
template <int EX>
__device__ __forceinline__ void extract(uint32_t q, int h, __nv_bfloat162& lo, __nv_bfloat162& hi) {
  if constexpr (EX == EX_I32) {
    const int p = static_cast<int>(q);
    lo = int_pair((p << (28 - 16 * h)) >> 28, (p << (20 - 16 * h)) >> 28);
    hi = int_pair((p << (24 - 16 * h)) >> 28, (p << (16 - 16 * h)) >> 28);
  } else if constexpr (EX == EX_I8) {
    const uint32_t l4 = __vsub4((q & 0x0F0F0F0Fu) ^ 0x08080808u, 0x08080808u);
    const uint32_t h4 = __vsub4(((q >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u, 0x08080808u);
    lo = int_pair(sbyte(l4, 2 * h), sbyte(l4, 2 * h + 1));
    hi = int_pair(sbyte(h4, 2 * h), sbyte(h4, 2 * h + 1));
  } else if constexpr (EX == EX_LOP3) {
    const uint32_t t = __byte_perm(q, 0u, h ? 0x4342u : 0x4140u);   // bytes 2h, 2h+1 → 16-bit lanes
    lo = bits_bf162((t & 0x000F000Fu) | 0x43004300u);
    hi = bits_bf162(((t >> 4) & 0x000F000Fu) | 0x43004300u);
  } else if constexpr (EX == EX_AND) {
    const uint32_t l8 = q & 0x0F0F0F0Fu, h8 = q & 0xF0F0F0F0u;
    lo = int_pair(sbyte(l8, 2 * h), sbyte(l8, 2 * h + 1));
    hi = int_pair(sbyte(h8, 2 * h), sbyte(h8, 2 * h + 1));
  } else {   // EX_BYTE
    lo = int_pair(sbyte(q, 2 * h), sbyte(q, 2 * h + 1));
    hi = lo;
  }
}

__device__ __forceinline__ uint32_t xor_words(uint4 v) { return v.x ^ v.y ^ v.z ^ v.w; }

// K1: the bf16 plane bodies on a [K/2, N] pack; x_lo/x_hi bf16 [M, K/2].
template <int MT, int EX, int SC, int PLANES, int EPI>
__global__ void __launch_bounds__(THREADS, 2) k1_planes(Args a) {
  constexpr int U = MT <= 2 ? 2 : 1;
  constexpr bool CHK_S = SC == SC_NONE;        // noscale: scale tile moved, not read
  constexpr bool CHK_XHI = PLANES == 1;        // halfq8: x_hi tile moved, not read
  const int TX = a.cols / 8, TK = THREADS / TX;
  const int tid = threadIdx.x, tx = tid % TX, tk = tid / TX;
  const int n = blockIdx.x * a.cols + tx * 8;
  const int row0 = (tk % 8) * 2;               // byte-row pair within a block
  const int bstep = TK / 8;                    // blocks side by side
  const int G = a.K / BLK, half_k = a.K / 2;
  const int kb_split = blockIdx.y * a.blocks_per_split;
  const int kb_end = min(G, kb_split + a.blocks_per_split);
  const __nv_bfloat16* xlo = static_cast<const __nv_bfloat16*>(a.xa);
  const __nv_bfloat16* xhi = static_cast<const __nv_bfloat16*>(a.xb);

  float acc[MT][8];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[m][j] = 0.f;
  uint32_t chk = 0;

  if (n < a.N) {
    for (int kb = kb_split + tk / 8; kb < kb_end; kb += U * bstep) {
      int2 wv[U][2];
      uint4 sv[U][2];                          // f32: 8 floats; bf16: sv[u][0] holds 8
      __nv_bfloat162 xl[U][MT], xh[U][MT];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int b = kb + u * bstep;
        if (b < kb_end) {
          const int8_t* wb = a.w + ((size_t)b * HB + row0) * a.N + n;
          wv[u][0] = __ldg(reinterpret_cast<const int2*>(wb));
          wv[u][1] = __ldg(reinterpret_cast<const int2*>(wb + a.N));
          if constexpr (SC == SC_F32) {
            const float* sp = static_cast<const float*>(a.s) + (size_t)b * a.N + n;
            sv[u][0] = __ldg(reinterpret_cast<const uint4*>(sp));
            sv[u][1] = __ldg(reinterpret_cast<const uint4*>(sp + 4));
          } else {
            sv[u][0] = __ldg(reinterpret_cast<const uint4*>(
                static_cast<const __nv_bfloat16*>(a.s) + (size_t)b * a.N + n));
          }
#pragma unroll
          for (int m = 0; m < MT; ++m) {
            const size_t xi = (size_t)m * half_k + b * HB + row0;
            const bool live = m < a.M;
            xl[u][m] = live ? *reinterpret_cast<const __nv_bfloat162*>(xlo + xi)
                            : __floats2bfloat162_rn(0.f, 0.f);
            xh[u][m] = live ? *reinterpret_cast<const __nv_bfloat162*>(xhi + xi)
                            : __floats2bfloat162_rn(0.f, 0.f);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (kb + u * bstep >= kb_end) break;
        // the scales of the 8 columns as 4 bf16 pairs
        __nv_bfloat162 sp[4];
        if constexpr (SC == SC_F32) {
          sp[0] = __floats2bfloat162_rn(__uint_as_float(sv[u][0].x), __uint_as_float(sv[u][0].y));
          sp[1] = __floats2bfloat162_rn(__uint_as_float(sv[u][0].z), __uint_as_float(sv[u][0].w));
          sp[2] = __floats2bfloat162_rn(__uint_as_float(sv[u][1].x), __uint_as_float(sv[u][1].y));
          sp[3] = __floats2bfloat162_rn(__uint_as_float(sv[u][1].z), __uint_as_float(sv[u][1].w));
        } else if constexpr (SC == SC_BF16) {
          sp[0] = bits_bf162(sv[u][0].x);
          sp[1] = bits_bf162(sv[u][0].y);
          sp[2] = bits_bf162(sv[u][0].z);
          sp[3] = bits_bf162(sv[u][0].w);
        } else {
          chk ^= xor_words(sv[u][0]);
        }
        if constexpr (CHK_XHI) {
#pragma unroll
          for (int m = 0; m < MT; ++m) chk ^= *reinterpret_cast<const uint32_t*>(&xh[u][m]);
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const uint32_t words[2] = {static_cast<uint32_t>(wv[u][r].x),
                                     static_cast<uint32_t>(wv[u][r].y)};
#pragma unroll
          for (int i = 0; i < 4; ++i) {       // column pair i: columns 2i, 2i+1
            __nv_bfloat162 lo, hi;
            extract<EX>(words[i / 2], i % 2, lo, hi);
            if constexpr (SC != SC_NONE) {
              lo = __hmul2(lo, sp[i]);
              if constexpr (PLANES == 2) hi = __hmul2(hi, sp[i]);
            }
            const float l0 = __low2float(lo), l1 = __high2float(lo);
            const float h0 = __low2float(hi), h1 = __high2float(hi);
#pragma unroll
            for (int m = 0; m < MT; ++m) {
              const float xa = r == 0 ? __low2float(xl[u][m]) : __high2float(xl[u][m]);
              acc[m][2 * i] = fmaf(xa, l0, acc[m][2 * i]);
              acc[m][2 * i + 1] = fmaf(xa, l1, acc[m][2 * i + 1]);
              if constexpr (PLANES == 2) {
                const float xb = r == 0 ? __low2float(xh[u][m]) : __high2float(xh[u][m]);
                acc[m][2 * i] = fmaf(xb, h0, acc[m][2 * i]);
                acc[m][2 * i + 1] = fmaf(xb, h1, acc[m][2 * i + 1]);
              }
            }
          }
        }
      }
    }
  }
  if constexpr (CHK_S || CHK_XHI) write_checksum(a, chk);
  finish<MT, 8, EPI>(acc, a, tx, tk, TK);
}

// K2: one unsplit plane on the [K, N/2] carrier of jnp.int4 [K, N] (byte j
// of a row: column 2j low, 2j+1 high); x bf16 [M, K]; f32 block scales.
template <int MT>
__global__ void __launch_bounds__(THREADS, 2) k2_native(Args a) {
  constexpr int U = MT <= 2 ? 2 : 1;
  const int TX = a.cols / 8, TK = THREADS / TX;
  const int tid = threadIdx.x, tx = tid % TX, tk = tid / TX;
  const int n = blockIdx.x * a.cols + tx * 8;
  const int G = a.K / BLK, row_bytes = a.N / 2;
  const int k_lo = blockIdx.y * a.blocks_per_split * BLK;
  const int k_hi = min(G, (blockIdx.y + 1) * a.blocks_per_split) * BLK;
  const __nv_bfloat16* x = static_cast<const __nv_bfloat16*>(a.xa);
  const float* s = static_cast<const float*>(a.s);

  float acc[MT][8];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[m][j] = 0.f;

  if (n < a.N) {
    for (int k = k_lo + 2 * tk; k < k_hi; k += 2 * TK * U) {
      uint32_t wv[U][2];
      uint4 sv[U][2];
      __nv_bfloat162 xv[U][MT];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int kk = k + u * 2 * TK;
        if (kk < k_hi) {
          const int8_t* wr = a.w + (size_t)kk * row_bytes + n / 2;
          wv[u][0] = __ldg(reinterpret_cast<const uint32_t*>(wr));
          wv[u][1] = __ldg(reinterpret_cast<const uint32_t*>(wr + row_bytes));
          const float* sp = s + (size_t)(kk / BLK) * a.N + n;
          sv[u][0] = __ldg(reinterpret_cast<const uint4*>(sp));
          sv[u][1] = __ldg(reinterpret_cast<const uint4*>(sp + 4));
#pragma unroll
          for (int m = 0; m < MT; ++m)
            xv[u][m] = m < a.M ? *reinterpret_cast<const __nv_bfloat162*>(x + (size_t)m * a.K + kk)
                               : __floats2bfloat162_rn(0.f, 0.f);
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (k + u * 2 * TK >= k_hi) break;
        const float f[8] = {__uint_as_float(sv[u][0].x), __uint_as_float(sv[u][0].y),
                            __uint_as_float(sv[u][0].z), __uint_as_float(sv[u][0].w),
                            __uint_as_float(sv[u][1].x), __uint_as_float(sv[u][1].y),
                            __uint_as_float(sv[u][1].z), __uint_as_float(sv[u][1].w)};
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int p = static_cast<int>(wv[u][r]);
#pragma unroll
          for (int j = 0; j < 4; ++j) {        // byte j: columns 2j (low), 2j+1 (high)
            __nv_bfloat162 v = int_pair((p << (28 - 8 * j)) >> 28, (p << (24 - 8 * j)) >> 28);
            v = __hmul2(v, __floats2bfloat162_rn(f[2 * j], f[2 * j + 1]));
            const float w0 = __low2float(v), w1 = __high2float(v);
#pragma unroll
            for (int m = 0; m < MT; ++m) {
              const float xm = r == 0 ? __low2float(xv[u][m]) : __high2float(xv[u][m]);
              acc[m][2 * j] = fmaf(xm, w0, acc[m][2 * j]);
              acc[m][2 * j + 1] = fmaf(xm, w1, acc[m][2 * j + 1]);
            }
          }
        }
      }
    }
  }
  finish<MT, 8, EPI_NONE>(acc, a, tx, tk, TK);
}

// K3: the pure weight stream.  Every byte row of the split is loaded; rows
// t·bk/2 + i·(bk/16) (i < 8, t < K/bk) are summed per column, the others
// go to the checksum.  out[m, n] = xw[m, n] + that sum (exact integers).
__global__ void __launch_bounds__(THREADS) k3_stream(Args a) {
  constexpr int U = 4;
  const int TX = a.cols / 8, TK = THREADS / TX;
  const int tid = threadIdx.x, tx = tid % TX, tk = tid / TX;
  const int n = blockIdx.x * a.cols + tx * 8;
  const int G = a.K / BLK;
  const int r_lo = blockIdx.y * a.blocks_per_split * HB;
  const int r_hi = min(G, (blockIdx.y + 1) * a.blocks_per_split) * HB;
  const int tile_rows = a.tile_bk / 2, every = a.tile_bk / 16, n_tiles = a.K / a.tile_bk;

  int sum[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  uint32_t chk = 0;
  if (n < a.N) {
    for (int row = r_lo + tk; row < r_hi; row += TK * U) {
      int2 wv[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int rr = row + u * TK;
        wv[u] = rr < r_hi ? __ldg(reinterpret_cast<const int2*>(a.w + (size_t)rr * a.N + n))
                          : make_int2(0, 0);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int rr = row + u * TK;
        if (rr >= r_hi) break;
        const int in_tile = rr % tile_rows;
        if (rr / tile_rows < n_tiles && in_tile % every == 0) {
          const uint32_t w2[2] = {static_cast<uint32_t>(wv[u].x), static_cast<uint32_t>(wv[u].y)};
#pragma unroll
          for (int j = 0; j < 8; ++j) sum[j] += sbyte(w2[j / 4], j % 4);
        } else {
          chk ^= static_cast<uint32_t>(wv[u].x) ^ static_cast<uint32_t>(wv[u].y);
        }
      }
    }
  }
  write_checksum(a, chk);
  float acc[1][8];
#pragma unroll
  for (int j = 0; j < 8; ++j) acc[0][j] = static_cast<float>(sum[j]);
  // one sum for every row m: reduce once, then write the M rows
  __shared__ float red[THREADS * 8];
#pragma unroll
  for (int j = 0; j < 8; ++j) red[tk * a.cols + tx * 8 + j] = acc[0][j];
  __syncthreads();
  const int col = blockIdx.x * a.cols + tid;
  if (tid < a.cols && col < a.N) {
    float v = 0.f;
    for (int l = 0; l < TK; ++l) v += red[l * a.cols + tid];
    for (int m = 0; m < a.M; ++m) store<EPI_XW>(a, m, col, v);
  }
}

// K4: W4A8 integer dots on the mixed pack.  Per 32-row block b and column
// n: z = Σ_j x_lo[j]·(p_j & 0x0F) + (Σ_j x_hi[j]·(p_j & 0xF0)) >> 4, exact
// in int32 (dp4a), then acc += z·(sx[m, b]·s[b, n]) (intdot: x_lo/x_hi int8
// [M, K/2], sx [M, K/32]) or acc += z·s[b, n] (w4a8: xq int8 [M, K]).
template <int MT, bool W4A8_X>
__global__ void __launch_bounds__(THREADS) k4_int8(Args a) {
  const int TX = a.cols / 4, TK = THREADS / TX;
  const int tid = threadIdx.x, tx = tid % TX, tk = tid / TX;
  const int n = blockIdx.x * a.cols + tx * 4;
  const int G = a.K / BLK;
  const int kb_end = min(G, (blockIdx.y + 1) * a.blocks_per_split);
  const int8_t* xa = static_cast<const int8_t*>(a.xa);
  const int8_t* xb = static_cast<const int8_t*>(a.xb);
  const float* s = static_cast<const float*>(a.s);

  float acc[MT][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[m][j] = 0.f;

  if (n < a.N) {
    for (int kb = blockIdx.y * a.blocks_per_split + tk; kb < kb_end; kb += TK) {
      uint32_t r[HB];
#pragma unroll
      for (int i = 0; i < HB; ++i)
        r[i] = __ldg(reinterpret_cast<const uint32_t*>(a.w + ((size_t)kb * HB + i) * a.N + n));
      const float4 sc = __ldg(reinterpret_cast<const float4*>(s + (size_t)kb * a.N + n));
      // t[g][c]: bytes of rows 4g..4g+3 of column c
      uint32_t t[4][4];
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        const uint32_t a01 = __byte_perm(r[4 * g], r[4 * g + 1], 0x5140u);
        const uint32_t a23 = __byte_perm(r[4 * g + 2], r[4 * g + 3], 0x5140u);
        const uint32_t b01 = __byte_perm(r[4 * g], r[4 * g + 1], 0x7362u);
        const uint32_t b23 = __byte_perm(r[4 * g + 2], r[4 * g + 3], 0x7362u);
        t[g][0] = __byte_perm(a01, a23, 0x5410u);
        t[g][1] = __byte_perm(a01, a23, 0x7632u);
        t[g][2] = __byte_perm(b01, b23, 0x5410u);
        t[g][3] = __byte_perm(b01, b23, 0x7632u);
      }
      const float sn[4] = {sc.x, sc.y, sc.z, sc.w};
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        if (m >= a.M) break;
        int4 xl, xh;
        if constexpr (W4A8_X) {
          const int8_t* xr = xa + (size_t)m * a.K + kb * BLK;
          xl = __ldg(reinterpret_cast<const int4*>(xr));
          xh = __ldg(reinterpret_cast<const int4*>(xr + HB));
        } else {
          const size_t xi = (size_t)m * (a.K / 2) + kb * HB;
          xl = __ldg(reinterpret_cast<const int4*>(xa + xi));
          xh = __ldg(reinterpret_cast<const int4*>(xb + xi));
        }
        const int xlw[4] = {xl.x, xl.y, xl.z, xl.w}, xhw[4] = {xh.x, xh.y, xh.z, xh.w};
        const float sxm = W4A8_X ? 1.f : a.sx[(size_t)m * G + kb];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          int zl = 0, zh = 0;
#pragma unroll
          for (int g = 0; g < 4; ++g) {
            zl = __dp4a(static_cast<int>(t[g][c] & 0x0F0F0F0Fu), xlw[g], zl);
            zh = __dp4a(static_cast<int>(t[g][c] & 0xF0F0F0F0u), xhw[g], zh);
          }
          const int z = zl + (zh >> 4);
          const float scale = W4A8_X ? sn[c] : sxm * sn[c];
          acc[m][c] = fmaf(static_cast<float>(z), scale, acc[m][c]);
        }
      }
    }
  }
  finish<MT, 4, EPI_NONE>(acc, a, tx, tk, TK);
}

// Sum the split-K partials [splits, M, N] into out, plus the kind's addend.
template <int EPI>
__global__ void probe_reduce(Args a) {
  const size_t total = (size_t)a.M * a.N;
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  float v = 0.f;
  for (int z = 0; z < a.splits; ++z) v += a.partial[z * total + i];
  a.out[i] = v + addend<EPI>(a, static_cast<int>(i / a.N), static_cast<int>(i % a.N));
}

using KernelFn = void (*)(Args);

template <int MT>
KernelFn select_mt(int kind) {
  switch (kind) {
    case SPLIT_I32: return k1_planes<MT, EX_I32, SC_F32, 2, EPI_NONE>;
    case SPLIT_I8: return k1_planes<MT, EX_I8, SC_F32, 2, EPI_NONE>;
    case BITCAST: return k1_planes<MT, EX_LOP3, SC_F32, 2, EPI_NONE>;
    case ANDMASK: return k1_planes<MT, EX_AND, SC_F32, 2, EPI_NONE>;
    case ANDMASK_BF16S: return k1_planes<MT, EX_AND, SC_BF16, 2, EPI_NONE>;
    case NOSCALE: return k1_planes<MT, EX_AND, SC_NONE, 2, EPI_S16>;
    case HALFQ8: return k1_planes<MT, EX_BYTE, SC_BF16, 1, EPI_XHI>;
    case I4NATIVE: return k2_native<MT>;
    case STREAM: return k3_stream;
    case INTDOT: return k4_int8<MT, false>;
    case W4A8: return k4_int8<MT, true>;
    default: return nullptr;
  }
}

KernelFn select_kernel(int kind, int M) {
  if (M <= 1) return select_mt<1>(kind);
  if (M <= 2) return select_mt<2>(kind);
  if (M <= 4) return select_mt<4>(kind);
  if (M <= 8) return select_mt<8>(kind);
  return select_mt<16>(kind);
}

void launch(KernelFn fn, dim3 grid, cudaStream_t stream, const Args& a) {
  fn<<<grid, THREADS, 0, stream>>>(a);
}

int epi_of(int kind) {
  return kind == NOSCALE ? EPI_S16 : kind == HALFQ8 ? EPI_XHI : kind == STREAM ? EPI_XW : EPI_NONE;
}

bool valid_geometry(int M, int N, int K, int cols, int ksplit) {
  return M >= 1 && M <= MAX_M && N > 0 && N % 8 == 0 && K > 0 && K % BLK == 0 &&
         (cols == 32 || cols == 64 || cols == 128 || cols == 256) && ksplit > 0 &&
         ksplit % BLK == 0;
}

int n_splits(int K, int ksplit) {
  const int bps = ksplit / BLK;
  return (K / BLK + bps - 1) / bps;
}

}  // namespace

// f32 workspace floats (the split-K partials) for this launch geometry; 0
// when one split covers K (the kernel writes the output itself).
extern "C" long long int4_probe_workspace(int M, int N, int K, int cols, int ksplit) {
  if (!valid_geometry(M, N, K, cols, ksplit)) return 0;
  const int splits = n_splits(K, ksplit);
  return splits > 1 ? (long long)splits * M * N : 0;
}

// checksum words: one per warp of each CTA
extern "C" long long int4_probe_side_words(int N, int K, int cols, int ksplit) {
  if (cols <= 0 || ksplit < BLK || K < BLK) return 0;
  return (long long)((N + cols - 1) / cols) * n_splits(K, ksplit) * WARPS;
}

// Launch the kernel of `kind` (enum Kind) and, under a split, probe_reduce.
// tile_bn / tile_bk: the TPU tile whose elements noscale, halfq8 and stream
// read.  Returns the launch's CUDA error.
extern "C" int int4_probe_launch(int kind, const void* xa, const void* xb, const void* sx,
                                 const void* w, const void* s, const void* xw, void* out,
                                 void* workspace, long long ws_floats, void* side,
                                 long long side_words, int M, int N, int K, int cols, int ksplit,
                                 int tile_bn, int tile_bk, void* stream) {
  if (kind < 0 || kind >= N_KINDS || !valid_geometry(M, N, K, cols, ksplit) || tile_bn <= 0 ||
      tile_bk < BLK || tile_bk % BLK || tile_bk > K)
    return static_cast<int>(cudaErrorInvalidValue);
  const int splits = n_splits(K, ksplit);
  const long long need = int4_probe_workspace(M, N, K, cols, ksplit);
  if ((need > 0 && (workspace == nullptr || ws_floats < need)) ||
      side == nullptr || side_words < int4_probe_side_words(N, K, cols, ksplit))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{xa, xb, static_cast<const float*>(sx), static_cast<const int8_t*>(w), s,
         static_cast<const float*>(xw), static_cast<float*>(out),
         need > 0 ? static_cast<float*>(workspace) : nullptr, static_cast<uint32_t*>(side),
         M, N, K, cols, ksplit / BLK, splits, tile_bn, tile_bk};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  launch(select_kernel(kind, M), dim3((N + cols - 1) / cols, splits), st, a);
  if (need > 0 && cudaPeekAtLastError() == cudaSuccess) {
    const dim3 rgrid(static_cast<unsigned>(((size_t)M * N + THREADS - 1) / THREADS));
    const int epi = epi_of(kind);
    launch(epi == EPI_S16 ? probe_reduce<EPI_S16> : epi == EPI_XHI ? probe_reduce<EPI_XHI>
           : epi == EPI_XW ? probe_reduce<EPI_XW> : probe_reduce<EPI_NONE>, rgrid, st, a);
  }
  return static_cast<int>(cudaGetLastError());
}

// Registers per thread, static shared memory and CTAs per SM of the kernel
// that serves (kind, M): the tile tuner's fit check.
extern "C" int int4_probe_attrs(int kind, int M, int device, int* regs, int* smem, int* ctas) {
  if (kind < 0 || kind >= N_KINDS || M < 1 || M > MAX_M)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const KernelFn fn = select_kernel(kind, M);
  cudaFuncAttributes attr;
  e = cudaFuncGetAttributes(&attr, reinterpret_cast<const void*>(fn));
  if (e != cudaSuccess) return static_cast<int>(e);
  *regs = attr.numRegs;
  *smem = static_cast<int>(attr.sharedSizeBytes);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      ctas, reinterpret_cast<const void*>(fn), THREADS, 0));
}
