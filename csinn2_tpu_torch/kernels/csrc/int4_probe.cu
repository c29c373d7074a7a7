// Q4_0 decode dequant-strategy probes for Hopper (sm_90a): one kernel
// instantiation per pipeline of the JAX probe.
//
// Replaces: examples/int4_dequant_probe.py, the nine bodies `_mk_call` (:75,
// pallas_call :78) launches and `run_w4a8` (:530, pallas_call :560):
//   K1 k_planes<NT, KIND, WV>, the bf16 plane bodies on the tensor cores:
//      _split_kernel :91 (shifts "i32" → EX_I32, "i8" → EX_I8),
//      _bitcast_kernel :173 (EX_LOP3), _andmask_kernel :234 (EX_AND),
//      _andmask_bf16s_kernel :395 (EX_AND, SC_BF16), _noscale_kernel :440
//      (EX_AND, SC_NONE), _halfq8_kernel :460 (EX_BYTE, one plane) and
//      _i4_kernel :141 (i4native: one unsplit plane of the [K, N/2] carrier);
//   K3 k3_stream: _stream_kernel :294;
//   K4 k4_int8<MT, W4A8>: _intdot_kernel :327 and _w4a8_kernel :497.
//
// Bound.  At M <= 16 every kernel reads the packed weight once: K·N/2 bytes
// plus the scales (f32 or bf16) and the activations, against 2·M·K·N
// operations, so HBM bounds them all (kernels/int4_probe.py notes the
// bytes of each).
//
// K1 design.  The skeleton of the port's decode GEMM, qmm_decode_kernel
// (qmatmul.cuh), from the header both share (decode_ring.cuh): a CTA of 256
// threads owns a 256-column strip and one K split (the split plan of
// qmatmul.py gemm_plan by default: the strips' CTAs fill two slots an SM in
// one wave); the raw weight bytes, their block scales and the x rows stream
// through a 3-slot cp.async ring of 16 KB weight stages (4 quant blocks);
// each warp widens its 32 columns from ldmatrix.trans registers into
// mma.sync m16n8k16 A fragments (the weights are A, x^T is B: one n8 tile of
// tokens at M <= 8, two at M <= 16), and the strip's last CTA sums the
// splits' partials in split order in the same launch (no reduce kernel:
// the same bits every call).  The kinds differ in their widening only, so a
// kind's time minus cur(quant_matmul)'s is the cost of its widening.
//   * Two-plane kinds ([K/2, N] packs): byte row j of a block holds k = j in
//     its low nibble and k = j + 16 in its high nibble, so the low plane is
//     the block's first k16 step and the high plane its second.  The loader
//     stages x_lo [M, K/2] and x_hi rows as the k 0-15 and 16-31 halves of
//     each block of an x row: x_lo is the B operand of the first step, x_hi
//     of the second.  halfq8 runs the first step only.
//   * i4native ([K, N/2], byte j of a row: column 2j low nibble, 2j+1 high):
//     an ldmatrix.trans register holds four columns 4g .. 4g+3 at k, k+1,
//     not two.  The strip's column order is permuted inside the mma tile:
//     rows g and g + 8 of tile t are columns 4g + 2t and 4g + 2t + 1 of the
//     warp's 32 (the low and high nibbles of bytes t and t + 2 of the
//     register), and the finish tile's stores undo it.  x stays B.
//   * Widening, as the JAX body and the earlier SIMT probe define it, each
//     into the bf16 pairs (k, k+1) of columns c and c+1: EX_I32 int32 shifts,
//     then I2F; EX_I8 __vsub4 sign extension, then I2F; EX_LOP3 (t &
//     0x000F000F) | 0x43004300 = 128 + raw' with no conversion; EX_AND p &
//     0x0F (= w_lo + 8) and p & 0xF0 (= 16·w_hi as a signed byte), then
//     I2F; EX_BYTE the whole byte, then I2F.  Then times the block scale in
//     one HMUL2 (the JAX body's bf16 multiply): SC_F32 rounds the f32 scale
//     to bf16, SC_BF16 takes it as it is, SC_NONE multiplies by nothing.
//     The conversions are what the probe measures: the decode GEMM's own
//     LOP3 widening (nibble_pair_bf162) is not used here.
//   * Timing-only kinds move the bytes the TPU moves but never reads
//     (noscale: the scale tile; halfq8: the x_hi tile) through the ring:
//     cp.async copies stay in the program, so they need no checksum (K3
//     keeps its side buffer).  Their addends (EPI_S16, EPI_XHI) are added
//     by the finish.
//   * Narrow copies: a [K/2, N] row at N % 16 != 0 (or a [K, N/2] row at N %
//     32 != 0) does not start on 16 bytes; those launches copy the weight in
//     8-byte (4-byte) pieces (WV), everything else as the decode GEMM does.
//
// K3 and K4 (SIMT).  A CTA of 256 threads covers `cols` output columns for
// all M rows and a K range of `ksplit` rows; the splits are summed by
// probe_reduce.  K3 gives a thread 8 adjacent columns (an 8-byte load per
// byte row): TX = cols / 8 column groups × TK = 256 / TX row lanes.  K4
// gives a thread 4 columns and a whole block (16 byte rows of 4 bytes,
// transposed 4 × 4 with __byte_perm so each column's 4 consecutive k sit in
// one word for dp4a): TX = cols / 4, TK = 256 / TX block lanes.  The row
// lanes are summed through shared memory at the end.  K4 masks the mixed
// pack as EX_AND does and sums s8×s8 in int32 with __dp4a per 32-row block;
// p_lo + (p_hi >> 4) is exact (p_hi = 16·Σ).  K3 loads every weight byte
// and folds the rows it does not sum into a per-warp XOR checksum in
// `side`, so the loads stay.
#include <algorithm>
#include <type_traits>

#include "decode_ring.cuh"

namespace {

constexpr int HB = BK / 2;       // byte rows per block
constexpr int WARPS = THREADS / 32;

enum Kind { SPLIT_I32, SPLIT_I8, I4NATIVE, BITCAST, ANDMASK, ANDMASK_BF16S, STREAM, INTDOT,
            W4A8, NOSCALE, HALFQ8, N_KINDS };
enum Extract { EX_I32, EX_I8, EX_LOP3, EX_AND, EX_BYTE };
enum Scale { SC_F32, SC_BF16, SC_NONE };
// what is added to the finished sum: nothing, s16[(K/bk-1)·bk/32, (n/bn)·bn]
// (noscale), x_hi[0, (K/bk-1)·bk/2] (halfq8), xw[m, n] (stream)
enum Epi { EPI_NONE, EPI_S16, EPI_XHI, EPI_XW };

__host__ __device__ constexpr bool is_planes(int k) {
  return k != STREAM && k != INTDOT && k != W4A8;
}
__host__ __device__ constexpr int ex_of(int k) {
  return k == SPLIT_I32 || k == I4NATIVE ? EX_I32 : k == SPLIT_I8 ? EX_I8
         : k == BITCAST ? EX_LOP3 : k == HALFQ8 ? EX_BYTE : EX_AND;
}
__host__ __device__ constexpr int sc_of(int k) {
  return k == ANDMASK_BF16S || k == HALFQ8 ? SC_BF16 : k == NOSCALE ? SC_NONE : SC_F32;
}
__host__ __device__ constexpr int epi_of(int k) {   // a plane kind's addend
  return k == NOSCALE ? EPI_S16 : k == HALFQ8 ? EPI_XHI : EPI_NONE;
}

struct Args {
  const void* xa;        // x_lo bf16/int8 [M, K/2], or x [M, K] (i4native bf16, w4a8 int8)
  const void* xb;        // x_hi [M, K/2]
  const float* sx;       // intdot: per-block activation scales [M, K/32]
  const int8_t* w;       // packed weights
  const void* s;         // scales [K/32, N], f32 or bf16
  const float* xw;       // stream: [M, N]
  float* out;            // [M, N]
  float* partial;        // [splits, M, N] or null (one split: the kernel writes out)
  uint32_t* side;        // stream: checksum words [grid CTAs · WARPS]
  int* counters;         // K1: one per 256-column strip, zero between launches
  int M, N, K, cols, blocks_per_split, splits, tile_bn, tile_bk;
};

template <int EPI>
__device__ __forceinline__ float addend(const Args& a, int m, int col) {
  if constexpr (EPI == EPI_S16) {
    const int row = (a.K / a.tile_bk - 1) * (a.tile_bk / BK);
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

// int → float → the bf16 pair (a, b), as a register
__device__ __forceinline__ uint32_t int_pair(int a, int b) {
  return as_u32(__floats2bfloat162_rn(static_cast<float>(a), static_cast<float>(b)));
}

__device__ __forceinline__ int sbyte(uint32_t v, int i) {
  return static_cast<int8_t>(static_cast<uint8_t>(v >> (8 * i)));
}

// The two-plane kinds' widening of an ldmatrix.trans register r of a [K/2,
// N] pack: bytes (j, c), (j, c+1), (j+1, c), (j+1, c+1) of byte rows j, j+1
// and columns c, c+1, whose low (ks = 0) or high (ks = 1) nibbles are the
// plane values (EX_BYTE: the whole bytes, ks = 0).  e = column c's pair (k,
// k+1), o = column c+1's, unscaled.
template <int EX>
__device__ __forceinline__ void widen_plane(uint32_t r, int ks, uint32_t& e, uint32_t& o) {
  if constexpr (EX == EX_I32) {
    const int p = static_cast<int>(r);
    e = int_pair((p << (28 - 4 * ks)) >> 28, (p << (12 - 4 * ks)) >> 28);
    o = int_pair((p << (20 - 4 * ks)) >> 28, (p << (4 - 4 * ks)) >> 28);
  } else if constexpr (EX == EX_I8) {
    const uint32_t v = __vsub4(((r >> (4 * ks)) & 0x0F0F0F0Fu) ^ 0x08080808u, 0x08080808u);
    e = int_pair(sbyte(v, 0), sbyte(v, 2));
    o = int_pair(sbyte(v, 1), sbyte(v, 3));
  } else if constexpr (EX == EX_LOP3) {
    e = ((r >> (4 * ks)) & 0x000F000Fu) | 0x43004300u;
    o = ((r >> (8 + 4 * ks)) & 0x000F000Fu) | 0x43004300u;
  } else if constexpr (EX == EX_AND) {
    const uint32_t v = r & (ks ? 0xF0F0F0F0u : 0x0F0F0F0Fu);
    e = int_pair(sbyte(v, 0), sbyte(v, 2));
    o = int_pair(sbyte(v, 1), sbyte(v, 3));
  } else {   // EX_BYTE
    e = int_pair(sbyte(r, 0), sbyte(r, 2));
    o = int_pair(sbyte(r, 1), sbyte(r, 3));
  }
}

// i4native's widening of an ldmatrix.trans register of the [K, N/2]
// carrier: bytes (k, 2g), (k, 2g+1), (k+1, 2g), (k+1, 2g+1) of a 16-byte
// chunk, columns 4g .. 4g+3 at k, k+1.  Tile t takes bytes t and t + 2: e =
// column 4g + 2t (their low nibbles), o = column 4g + 2t + 1 (high); int32
// shifts, then I2F.
__device__ __forceinline__ void widen_native(uint32_t r, int t, uint32_t& e, uint32_t& o) {
  const int p = static_cast<int>(r);
  e = int_pair((p << (28 - 8 * t)) >> 28, (p << (12 - 8 * t)) >> 28);
  o = int_pair((p << (24 - 8 * t)) >> 28, (p << (8 - 8 * t)) >> 28);
}

// K1's ring: the decode GEMM's [K/2, N] stage (NATIVE: [K, N/2]) with the
// kind's scale type; x from its block halves except for i4native
template <int KIND>
using PlaneRing = Dc<true, false, sc_of(KIND) == SC_F32 ? 4 : 2, KIND == I4NATIVE>;

// K1: CTA (strip, split); warp w owns columns cb = 32w .. 32w + 31 of the
// strip as two mma tiles over every k (notes at the top).
template <int NT, int KIND, int WV>
__global__ void __launch_bounds__(THREADS, DC_CTAS_PER_SM) k_planes(Args a) {
  constexpr int SC = sc_of(KIND);
  constexpr bool NATIVE = KIND == I4NATIVE;
  constexpr int PLANES = KIND == HALFQ8 ? 1 : 2;   // k16 steps of a block that are read
  using ST = std::conditional_t<SC == SC_F32, float, __nv_bfloat16>;
  using C = PlaneRing<KIND>;
  extern __shared__ __align__(16) unsigned char dc_smem[];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, tig = lane % 4;      // mma fragment coordinates
  const int lm = lane / 8, li = lane % 8;      // ldmatrix: matrix and row of this lane
  const int n0 = blockIdx.x * DC_BN;
  const int kb_begin = blockIdx.y * a.blocks_per_split;
  const int kb_end = min(a.K / BK, kb_begin + a.blocks_per_split);
  const int n_st = max(0, (kb_end - kb_begin + C::SB - 1) / C::SB);
  const int cb = warp * 32;
  // rows g and g + 8 of tile t are columns cc[t] and cc[t] + 1 of the strip
  const int cc[2] = {NATIVE ? cb + 4 * g : cb + 2 * g, NATIVE ? cb + 4 * g + 2 : cb + 16 + 2 * g};

  float acc[2][NT][4];                         // [column tile][token tile][fragment]
#pragma unroll
  for (int t = 0; t < 2; ++t)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[t][nt][e] = 0.f;

  // blocks past the split's end are zero-filled (weights, scales and x):
  // they add zeros, so every stage runs whole
  auto compute = [&](const unsigned char* st) {
    const unsigned char* ss = st + C::W_BYTES;
    const unsigned char* xs = ss + C::S_BYTES;
#pragma unroll
    for (int b = 0; b < C::SB; ++b) {
      uint32_t xb[NT][2][2];                   // B of the block's two k16 steps
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        uint32_t r[4];                         // k 0-7, 8-15, 16-23, 24-31 of the block
        const int row = nt * 8 + li, c = b * 4 + lm;
        ldmatrix_x4(r, xs + row * C::X_ROW + ((c ^ (row & 7)) << 4), false);
#pragma unroll
        for (int j = 0; j < 4; ++j) xb[nt][j / 2][j % 2] = r[j];
      }
      uint32_t sc[2][2] = {};                  // [tile][rows g, g + 8]
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        if constexpr (SC == SC_F32) {
          const float2 f = *reinterpret_cast<const float2*>(ss + (b * DC_BN + cc[t]) * 4);
          sc[t][0] = bf16_dup(f.x);
          sc[t][1] = bf16_dup(f.y);
        } else if constexpr (SC == SC_BF16) {
          const uint32_t v = *reinterpret_cast<const uint32_t*>(ss + (b * DC_BN + cc[t]) * 2);
          sc[t][0] = __byte_perm(v, 0, 0x1010);
          sc[t][1] = __byte_perm(v, 0, 0x3232);
        }
      }
      uint32_t r[4];
      if constexpr (!NATIVE) {                 // byte rows 0-7 / 8-15 of the tiles' chunks
        const int kr = b * HB + li + 8 * (lm & 1), cl = cb / 16 + (lm >> 1);
        ldmatrix_x4(r, st + kr * C::ROW + ((cl ^ (kr & 7)) << 4), true);
      } else {                                 // k rows 0-7 .. 24-31 of the warp's chunk
        const int kr = b * BK + 8 * lm + li;
        ldmatrix_x4(r, st + kr * C::ROW + ((warp ^ (kr & 7)) << 4), true);
      }
#pragma unroll
      for (int ks = 0; ks < PLANES; ++ks)
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          uint32_t af[4];
#pragma unroll
          for (int h = 0; h < 2; ++h) {        // k 0-7 (h = 0) and 8-15 of the step
            uint32_t e, o;
            if constexpr (NATIVE) widen_native(r[2 * ks + h], t, e, o);
            else widen_plane<ex_of(KIND)>(r[2 * t + h], ks, e, o);
            if constexpr (SC != SC_NONE) {
              e = hmul2_u32(e, sc[t][0]);
              o = hmul2_u32(o, sc[t][1]);
            }
            af[2 * h] = e;
            af[2 * h + 1] = o;
          }
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) mma_bf16(acc[t][nt], af, xb[nt][ks]);
        }
    }
  };

  DcLoader<NT, true, false, false, ST, !NATIVE, NATIVE, WV> loader(
      static_cast<const __nv_bfloat16*>(a.xa), a.w, static_cast<const ST*>(a.s), a.M, a.N, a.K,
      n0, kb_begin, kb_end, static_cast<const __nv_bfloat16*>(a.xb));
  dc_ring<C>(loader, n_st, dc_smem, compute);
  float* tile = reinterpret_cast<float*>(dc_smem);
  dc_tile_store<NT>(tile, acc, cc, 1, tig);
  if (!dc_sum_splits<NT>(tile, a.partial, a.counters, a.M, a.N, a.splits)) return;
  const int col = n0 + tid;                    // a thread a column from here
  if (col < a.N) {
    const float add = addend<epi_of(KIND)>(a, 0, col);
    for (int m = 0; m < a.M; ++m) a.out[(size_t)m * a.N + col] = tile[m * DC_BN + tid] + add;
  }
}

// K3: the pure weight stream.  Every byte row of the split is loaded; rows
// t·bk/2 + i·(bk/16) (i < 8, t < K/bk) are summed per column, the others
// go to the checksum.  out[m, n] = xw[m, n] + that sum (exact integers).
__global__ void __launch_bounds__(THREADS) k3_stream(Args a) {
  constexpr int U = 4;
  const int TX = a.cols / 8, TK = THREADS / TX;
  const int tid = threadIdx.x, tx = tid % TX, tk = tid / TX;
  const int n = blockIdx.x * a.cols + tx * 8;
  const int G = a.K / BK;
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
  const int G = a.K / BK;
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
          const int8_t* xr = xa + (size_t)m * a.K + kb * BK;
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

// A K1 instantiation and its dynamic shared memory (the ring)
struct PlaneKernel {
  KernelFn fn;
  int smem;
};

template <int KIND>
PlaneKernel plane_kernel(int M, bool wide) {
  // narrow copies: [K, N/2] rows start on 4 bytes, [K/2, N] rows on 8 (N % 8 == 0)
  constexpr int NARROW = KIND == I4NATIVE ? 4 : 8;
  const KernelFn fn = M <= 8 ? (wide ? k_planes<1, KIND, 16> : k_planes<1, KIND, NARROW>)
                             : (wide ? k_planes<2, KIND, 16> : k_planes<2, KIND, NARROW>);
  return {fn, PlaneRing<KIND>::SMEM};
}

// The K1 kernel of (kind, M, N): 16-byte weight copies where every row
// starts on 16 bytes
PlaneKernel select_planes(int kind, int M, int N) {
  const bool wide = N % (kind == I4NATIVE ? 32 : 16) == 0;
  switch (kind) {
    case SPLIT_I32: return plane_kernel<SPLIT_I32>(M, wide);
    case SPLIT_I8: return plane_kernel<SPLIT_I8>(M, wide);
    case I4NATIVE: return plane_kernel<I4NATIVE>(M, wide);
    case BITCAST: return plane_kernel<BITCAST>(M, wide);
    case ANDMASK: return plane_kernel<ANDMASK>(M, wide);
    case ANDMASK_BF16S: return plane_kernel<ANDMASK_BF16S>(M, wide);
    case NOSCALE: return plane_kernel<NOSCALE>(M, wide);
    case HALFQ8: return plane_kernel<HALFQ8>(M, wide);
    default: return {nullptr, 0};
  }
}

// K3 and K4 (one instantiation per M class)
template <int MT>
KernelFn select_mt(int kind) {
  switch (kind) {
    case STREAM: return k3_stream;
    case INTDOT: return k4_int8<MT, false>;
    case W4A8: return k4_int8<MT, true>;
    default: return nullptr;
  }
}

KernelFn select_simt(int kind, int M) {
  if (M <= 1) return select_mt<1>(kind);
  if (M <= 2) return select_mt<2>(kind);
  if (M <= 4) return select_mt<4>(kind);
  if (M <= 8) return select_mt<8>(kind);
  return select_mt<16>(kind);
}

// K1 strips are DC_BN columns; K3 and K4 take any power of two 32 .. 256
bool valid_geometry(int kind, int M, int N, int K, int cols, int ksplit) {
  const bool cols_ok = is_planes(kind) ? cols == DC_BN
                                       : cols == 32 || cols == 64 || cols == 128 || cols == 256;
  return M >= 1 && M <= DECODE_MAX_M && N > 0 && N % 8 == 0 && K > 0 && K % BK == 0 && cols_ok &&
         ksplit > 0 && ksplit % BK == 0;
}

int n_splits(int K, int ksplit) {
  const int bps = ksplit / BK;
  return (K / BK + bps - 1) / bps;
}

}  // namespace

// f32 workspace floats (the split-K partials) for this launch geometry; 0
// when one split covers K (the kernel writes the output itself).
extern "C" long long int4_probe_workspace(int M, int N, int K, int cols, int ksplit) {
  if (M < 1 || N <= 0 || K < BK || cols <= 0 || ksplit < BK) return 0;
  const int splits = n_splits(K, ksplit);
  return splits > 1 ? (long long)splits * M * N : 0;
}

// stream's checksum words: one per warp of each CTA
extern "C" long long int4_probe_side_words(int N, int K, int cols, int ksplit) {
  if (cols <= 0 || ksplit < BK || K < BK) return 0;
  return (long long)((N + cols - 1) / cols) * n_splits(K, ksplit) * WARPS;
}

// Launch the kernel of `kind` (enum Kind): K1 (the plane kinds) in one
// launch, with `counters` (int32, counter_slots >= ceil(N / 256) when K is
// split; zero before the launch and left zero by it, one stream at a time);
// K3 / K4 and, under a split, probe_reduce.  cols / ksplit: the CTA's
// columns (K1: 256) and K rows per split; tile_bn / tile_bk: the TPU tile
// whose elements noscale, halfq8 and stream read.  Returns the launch's CUDA
// error.
extern "C" int int4_probe_launch(int kind, const void* xa, const void* xb, const void* sx,
                                 const void* w, const void* s, const void* xw, void* out,
                                 void* workspace, long long ws_floats, void* side,
                                 long long side_words, void* counters, int counter_slots, int M,
                                 int N, int K, int cols, int ksplit, int tile_bn, int tile_bk,
                                 void* stream) {
  if (kind < 0 || kind >= N_KINDS || !valid_geometry(kind, M, N, K, cols, ksplit) ||
      tile_bn <= 0 || tile_bk < BK || tile_bk % BK || tile_bk > K)
    return static_cast<int>(cudaErrorInvalidValue);
  const int splits = n_splits(K, ksplit), strips = (N + cols - 1) / cols;
  const long long need = int4_probe_workspace(M, N, K, cols, ksplit);
  if ((need > 0 && (workspace == nullptr || ws_floats < need)) ||
      (kind == STREAM &&
       (side == nullptr || side_words < int4_probe_side_words(N, K, cols, ksplit))) ||
      (is_planes(kind) && splits > 1 && (counters == nullptr || counter_slots < strips)))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{xa, xb, static_cast<const float*>(sx), static_cast<const int8_t*>(w), s,
         static_cast<const float*>(xw), static_cast<float*>(out),
         need > 0 ? static_cast<float*>(workspace) : nullptr, static_cast<uint32_t*>(side),
         static_cast<int*>(counters), M, N, K, cols, ksplit / BK, splits, tile_bn, tile_bk};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(strips, splits);
  if (is_planes(kind)) {
    const PlaneKernel k = select_planes(kind, M, N);
    const cudaError_t e = cudaFuncSetAttribute(
        reinterpret_cast<const void*>(k.fn), cudaFuncAttributeMaxDynamicSharedMemorySize, k.smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    k.fn<<<grid, THREADS, k.smem, st>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
  select_simt(kind, M)<<<grid, THREADS, 0, st>>>(a);
  if (need > 0 && cudaPeekAtLastError() == cudaSuccess) {
    const dim3 rgrid(static_cast<unsigned>(((size_t)M * N + THREADS - 1) / THREADS));
    if (kind == STREAM) probe_reduce<EPI_XW><<<rgrid, THREADS, 0, st>>>(a);
    else probe_reduce<EPI_NONE><<<rgrid, THREADS, 0, st>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

// Registers per thread, static and dynamic shared memory and CTAs per SM
// (with that dynamic shared memory) of the kernel that serves (kind, M) at a
// 16-byte aligned N: the tile tuner's fit check.
extern "C" int int4_probe_attrs(int kind, int M, int device, int* regs, int* smem, int* dyn_smem,
                                int* ctas) {
  if (kind < 0 || kind >= N_KINDS || M < 1 || M > DECODE_MAX_M)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  KernelFn fn;
  int dyn = 0;
  if (is_planes(kind)) {
    const PlaneKernel k = select_planes(kind, M, 32 * DC_BN);
    fn = k.fn;
    dyn = k.smem;
    e = cudaFuncSetAttribute(reinterpret_cast<const void*>(fn),
                             cudaFuncAttributeMaxDynamicSharedMemorySize, dyn);
    if (e != cudaSuccess) return static_cast<int>(e);
  } else {
    fn = select_simt(kind, M);
  }
  cudaFuncAttributes attr;
  e = cudaFuncGetAttributes(&attr, reinterpret_cast<const void*>(fn));
  if (e != cudaSuccess) return static_cast<int>(e);
  *regs = attr.numRegs;
  *smem = static_cast<int>(attr.sharedSizeBytes);
  *dyn_smem = dyn;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      ctas, reinterpret_cast<const void*>(fn), THREADS, dyn));
}
