// Q4_0 decode dequant-strategy probes for Hopper (sm_90a): one kernel
// instantiation per pipeline of the JAX probe, every one on the skeleton of
// the port's decode GEMM.
//
// Replaces: examples/int4_dequant_probe.py, the nine bodies `_mk_call` (:75,
// pallas_call :78) launches and `run_w4a8` (:530, pallas_call :560):
//   k_planes<NT, KIND, WV>, the bf16 plane bodies on the tensor cores:
//      _split_kernel :91 (shifts "i32" → EX_I32, "i8" → EX_I8),
//      _bitcast_kernel :173 (EX_LOP3), _andmask_kernel :234 (EX_AND),
//      _andmask_bf16s_kernel :395 (EX_AND, SC_BF16), _noscale_kernel :440
//      (EX_AND, SC_NONE), _halfq8_kernel :460 (EX_BYTE, one plane) and
//      _i4_kernel :141 (i4native: one unsplit plane of the [K, N/2] carrier);
//   k_stream<WV>: _stream_kernel :294;
//   k_int8<NT, W4A8, WV>: _intdot_kernel :327 and _w4a8_kernel :497, on the
//      int8 tensor cores.
//
// Bound.  At M <= 16 every kernel reads the packed weight once: K·N/2 bytes
// plus the scales (f32 or bf16) and the activations, against 2·M·K·N
// operations, so HBM bounds them all (kernels/int4_probe.py notes the
// bytes of each).
//
// The skeleton, every kernel (decode_ring.cuh, shared with
// qmm_decode_kernel in qmatmul.cuh and qmm_i8_decode_kernel in
// qmatmul_int8dot.cu): a CTA of 256 threads owns a 256-column strip and one
// K split (the split plan of qmatmul.py gemm_plan by default: the strips'
// CTAs fill two slots an SM in one wave; a call may set the split length);
// the raw weight bytes, and the scales and x rows a kind reads, stream
// through a 3-slot cp.async ring of 16 KB weight stages (64 byte rows, 4
// quant blocks); the strip's last CTA sums the splits' partials in split
// order in the same launch (no reduce kernel: the same bits every call).  A
// [K/2, N] row at N % 16 != 0 (or a [K, N/2] row at N % 32 != 0) does not
// start on 16 bytes; those launches copy the weight in 8-byte (4-byte)
// pieces (WV), everything else as the decode GEMM does.
//
// k_planes.  Each warp widens its 32 columns from ldmatrix.trans registers
// into mma.sync m16n8k16 A fragments (the weights are A, x^T is B: one n8
// tile of tokens at M <= 8, two at M <= 16).  The kinds differ in their
// widening only, so a kind's time minus cur(quant_matmul)'s is the cost of
// its widening.
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
//     cp.async copies stay in the program, so they need no checksum.  Their
//     addends (EPI_S16, EPI_XHI) are added by the finish.
//
// k_int8.  The int8-x decode GEMM's ring and A operand
// (qmm_i8_decode_kernel's packed path; I8Dc / I8Loader): a stage holds the
// raw mixed-pack bytes as I8Dc<W_PACKED_KN> lays them out and the int8 x
// tile [16][128] (block b's 32 bytes: x_lo[b], then x_hi[b]; w4a8's xq [M,
// K] lies that way, intdot's loader copies the 16-byte chunks from its two
// halves), then the f32 block scales [4][256] and intdot's sx [16][4].  The
// regrouping ldmatrix.trans gives each column's k quads; the low nibbles
// masked as they are (v & 0x0F0F0F0F = w_lo + 8, not re-biased) and the
// high ones sign-extended (nib_signed(v >> 4) = w_hi) are the A fragments
// of one mma.sync m16n8k32 s8 a block, column tile and token tile, into a
// zeroed int32 fragment: z = Σ_j x_lo[j]·(p_j & 0x0F) + (Σ_j x_hi[j]·(p_j &
// 0xF0)) >> 4 exactly, the JAX body's p_lo + (p_hi >> 4), its +8 bias left
// in z for the outside correction.  |z| <= 32·127·15 < 2^22, so z goes to
// f32 by the 1.5·2^23 add (IADD, FADD; no I2F, which runs at a quarter of
// their rate; on the H100 I2F in its place measured within 1 %, never
// faster) and is multiply-added with its scale: intdot sx[token, b] ·
// s[b, col], the f32 product first as the JAX forms sc; w4a8 s[b, col].
//
// k_stream.  The weight stream alone: the [K/2, N] pack's stages through the
// ring with no scales and no x.  Per stage a thread sums its column's
// sampled byte rows (every bk/16-th row of the first K/bk whole bk-row
// tiles, the rows kernel_ref samples) from shared memory in int32; the
// splits' sums, integers and so exact in f32, meet in the strip's last CTA,
// which adds xw once (all M loads in flight before the stores): bit for bit
// the plain version.  The copies of the rows it does not sum stay in the
// program (cp.async), so no checksum is needed.  The ring keeps the decode
// GEMM's 3 slots: 5 weight-only slots (the same shared memory) measured no
// faster on the H100, so the stages' pace, not the bytes in flight, sets
// its rate.
#include <algorithm>
#include <type_traits>

#include "decode_ring.cuh"

namespace {

constexpr int HB = BK / 2;       // byte rows per block

enum Kind { SPLIT_I32, SPLIT_I8, I4NATIVE, BITCAST, ANDMASK, ANDMASK_BF16S, STREAM, INTDOT,
            W4A8, NOSCALE, HALFQ8, N_KINDS };
enum Extract { EX_I32, EX_I8, EX_LOP3, EX_AND, EX_BYTE };
enum Scale { SC_F32, SC_BF16, SC_NONE };
// what a plane kind adds to the finished sum: nothing, s16[(K/bk-1)·bk/32,
// (n/bn)·bn] (noscale), x_hi[0, (K/bk-1)·bk/2] (halfq8)
enum Epi { EPI_NONE, EPI_S16, EPI_XHI };

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
  float* partial;        // [splits, M, N] (stream: [splits, N]), or null for one split
  int* counters;         // one per 256-column strip, zero between launches
  int M, N, K, blocks_per_split, splits, tile_bn, tile_bk;
};

template <int EPI>
__device__ __forceinline__ float addend(const Args& a, int col) {
  if constexpr (EPI == EPI_S16) {
    const int row = (a.K / a.tile_bk - 1) * (a.tile_bk / BK);
    return __bfloat162float(
        static_cast<const __nv_bfloat16*>(a.s)[(size_t)row * a.N + (col / a.tile_bn) * a.tile_bn]);
  } else if constexpr (EPI == EPI_XHI) {
    return __bfloat162float(
        static_cast<const __nv_bfloat16*>(a.xb)[(a.K / a.tile_bk - 1) * (a.tile_bk / 2)]);
  } else {
    return 0.f;
  }
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

// k_planes' ring: the decode GEMM's [K/2, N] stage (NATIVE: [K, N/2]) with the
// kind's scale type; x from its block halves except for i4native
template <int KIND>
using PlaneRing = Dc<true, false, sc_of(KIND) == SC_F32 ? 4 : 2, KIND == I4NATIVE>;

// k_planes: CTA (strip, split); warp w owns columns cb = 32w .. 32w + 31 of the
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
    const float add = addend<epi_of(KIND)>(a, col);
    for (int m = 0; m < a.M; ++m) a.out[(size_t)m * a.N + col] = tile[m * DC_BN + tid] + add;
  }
}

// k_int8's ring stage: I8Dc<W_PACKED_KN>'s (the weight bytes, then the int8
// x tile [16][128]), then the f32 block scales [4][256] and intdot's sx
// [16][4] (w4a8 leaves them unused)
struct I8Ring {
  using W = I8Dc<W_PACKED_KN>;
  static constexpr int SB = W::SB;                         // 32-k blocks a stage
  static constexpr int S_OFF = W::STAGE;
  static constexpr int SX_OFF = S_OFF + SB * DC_BN * 4;
  static constexpr int STAGE = SX_OFF + DC_MT * SB * 4;
  static constexpr int STAGES = W::STAGES;
  static constexpr int SMEM = STAGES * STAGE;
};
static_assert(DC_CTAS_PER_SM * (I8Ring::SMEM + 1024 + 16) <= 233472 &&
                  DC_MT * DC_BN * 4 <= I8Ring::SMEM,
              "two k_int8 CTAs an SM; the finish tile in the ring");

// k_int8's loader: the weights and x by I8Loader; the scales one 16-byte
// copy of 4 a thread ([K/32, N] → [4][256]; N % 8 == 0, so a copy is whole
// or past N) and intdot's sx as 4-byte copies (its rows start on 4 bytes)
// into [16][4]; zero-filled past M, N and the split
template <bool SX, int WV>
struct I8ProbeLoader {
  I8Loader<W_PACKED_KN, SX, WV> wx;          // intdot (SX): x from its two halves
  const float* s0;
  const float* sp;                           // the thread's scale copy of the next stage
  const float* sxp;                          // SX: its sx element of the next stage
  size_t s_adv;
  uint32_t s_sm, sx_sm;
  int s_blk, sx_blk, left;
  bool s_ok, sx_on, sx_ok;

  __device__ __forceinline__ I8ProbeLoader(const Args& a, int n0, int kb_begin, int kb_end)
      : wx(static_cast<const int8_t*>(a.xa), a.w, a.M, a.N, a.K, n0, kb_begin, kb_end,
           static_cast<const int8_t*>(a.xb)) {
    const int tid = threadIdx.x, b = tid / (DC_BN / 4), c = tid % (DC_BN / 4);
    const float* s = static_cast<const float*>(a.s);
    s0 = s;
    sp = s + (size_t)(kb_begin + b) * a.N + n0 + 4 * c;
    s_adv = (size_t)I8Ring::SB * a.N;
    s_sm = I8Ring::S_OFF + (b * DC_BN + 4 * c) * 4;
    s_blk = b;
    s_ok = n0 + 4 * c < a.N;
    left = kb_end - kb_begin;
    if constexpr (SX) {
      const int r = tid / I8Ring::SB, bb = tid % I8Ring::SB;   // sx row r, block bb
      sxp = a.sx + (size_t)r * (a.K / BK) + kb_begin + bb;
      sx_sm = I8Ring::SX_OFF + (r * I8Ring::SB + bb) * 4;
      sx_blk = bb;
      sx_on = tid < DC_MT * I8Ring::SB;
      sx_ok = r < a.M;
    }
  }

  __device__ __forceinline__ void load(uint32_t st) {
    wx.load(st);
    const bool ok = s_ok && s_blk < left;
    cp_async_s<16>(st + s_sm, ok ? sp : s0, ok);
    sp += s_adv;
    if constexpr (SX) {
      if (sx_on) {
        const bool okx = sx_ok && sx_blk < left;
        cp_async_s<4>(st + sx_sm, okx ? sxp : s0, okx);
      }
      sxp += I8Ring::SB;
    }
    left -= I8Ring::SB;
  }
};

// an int |v| < 2^22 as f32, exactly and without I2F: v + 1.5·2^23 is v in
// the low mantissa bits of 1.5·2^23's float
__device__ __forceinline__ float small_int_to_float(int v) {
  return __int_as_float(0x4B400000 + v) - 12582912.f;
}

// k_int8: CTA (strip, split); warp w owns columns cb = 32w .. 32w + 31 of the
// strip as two m16 tiles (rows g and g + 8 of tile t: columns cb + 16t + 2g
// and + 1), B the NT n8 tiles of tokens (notes at the top).
template <int NT, bool W4A8_X, int WV>
__global__ void __launch_bounds__(THREADS, DC_CTAS_PER_SM) k_int8(Args a) {
  using C = I8Dc<W_PACKED_KN>;
  extern __shared__ __align__(16) unsigned char dc_smem[];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, tig = lane % 4;      // mma fragment coordinates
  const int lm = lane / 8, li = lane % 8;      // ldmatrix: matrix and row of this lane
  const int n0 = blockIdx.x * DC_BN;
  const int kb_begin = blockIdx.y * a.blocks_per_split;
  const int kb_end = min(a.K / BK, kb_begin + a.blocks_per_split);
  const int n_st = max(0, (kb_end - kb_begin + C::SB - 1) / C::SB);
  const int cb = warp * 32;
  const int cc[2] = {cb + 2 * g, cb + 16 + 2 * g};

  float acc[2][NT][4];                         // [column tile][token tile][fragment]
#pragma unroll
  for (int t = 0; t < 2; ++t)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[t][nt][e] = 0.f;

  // the lane's ldmatrix addresses within a stage
  const int xrow = NT == 2 ? 8 * (lm >> 1) + li : li;
  const int xoff = xrow * C::SK;
  const int xswz = x_swz<C::XCH>(xrow);
  const int rr = regroup_row(lane, false);     // byte rows 0-15 of a block
  const int rswz = kn_swz(rr);
  // blocks past the split's end are zero-filled (weights, x, scales): z = 0
  auto compute = [&](const unsigned char* st) {
    const unsigned char* xs = st + C::W_BYTES;
    const float* ss = reinterpret_cast<const float*>(st + I8Ring::S_OFF);
    const float* sxs = reinterpret_cast<const float*>(st + I8Ring::SX_OFF);
#pragma unroll
    for (int b = 0; b < C::SB; ++b) {
      uint32_t xb[NT][2];                      // k 0-15 (x_lo) and 16-31 (x_hi) of the block
      const int xc = 2 * b + (lm & 1);
      if constexpr (NT == 2) {
        uint32_t r[4];
        ldmatrix_x4(r, xs + xoff + ((xc ^ xswz) << 4), false);
        xb[0][0] = r[0]; xb[0][1] = r[1]; xb[1][0] = r[2]; xb[1][1] = r[3];
      } else {
        ldmatrix_x2(xb[0], xs + xoff + ((xc ^ xswz) << 4));
      }
      uint32_t r[4];                           // byte rows 0-15 of block b, both chunks
      const int chunk = cb / 16 + (lm >> 1);
      ldmatrix_x4(r, st + (b * HB + rr) * C::ROW + ((chunk ^ rswz) << 4), true);
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const uint32_t qe = quad_even(r[2 * t], r[2 * t + 1]);
        const uint32_t qo = quad_odd(r[2 * t], r[2 * t + 1]);
        const uint32_t af[4] = {qe & 0x0F0F0F0Fu, qo & 0x0F0F0F0Fu, nib_signed(qe >> 4),
                                nib_signed(qo >> 4)};
        const float2 s2 = *reinterpret_cast<const float2*>(ss + b * DC_BN + cc[t]);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          int z[4] = {0, 0, 0, 0};             // tokens 8nt + 2tig, +1 × columns cc[t], +1
          mma_s8(z, af, xb[nt]);
          float f[4] = {s2.x, s2.x, s2.y, s2.y};
          if constexpr (!W4A8_X) {
            const float x0 = sxs[(8 * nt + 2 * tig) * I8Ring::SB + b];
            const float x1 = sxs[(8 * nt + 2 * tig + 1) * I8Ring::SB + b];
            f[0] = x0 * s2.x;
            f[1] = x1 * s2.x;
            f[2] = x0 * s2.y;
            f[3] = x1 * s2.y;
          }
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[t][nt][e] = fmaf(small_int_to_float(z[e]), f[e], acc[t][nt][e]);
        }
      }
    }
  };

  I8ProbeLoader<!W4A8_X, WV> loader(a, n0, kb_begin, kb_end);
  dc_ring<I8Ring>(loader, n_st, dc_smem, compute);
  float* tile = reinterpret_cast<float*>(dc_smem);
  dc_tile_store<NT>(tile, acc, cc, 1, tig);
  if (!dc_sum_splits<NT>(tile, a.partial, a.counters, a.M, a.N, a.splits)) return;
  const int col = n0 + tid;                    // a thread a column from here
  if (col < a.N)
    for (int m = 0; m < a.M; ++m) a.out[(size_t)m * a.N + col] = tile[m * DC_BN + tid];
}

// k_stream's ring: the [K/2, N] pack's 16 KB weight stages alone
struct StreamRing {
  using W = Dc<true, false>;
  static constexpr int SB = W::SB, ROW = W::ROW, ROWS = W::ROWS;
  static constexpr int STAGE = W::W_BYTES;
  static constexpr int STAGES = W::STAGES;
  static constexpr int SMEM = STAGES * STAGE;
};

// k_stream: CTA (strip, split); thread t sums column n0 + t's sampled rows
template <int WV>
__global__ void __launch_bounds__(THREADS, DC_CTAS_PER_SM) k_stream(Args a) {
  using C = StreamRing;
  extern __shared__ __align__(16) unsigned char dc_smem[];
  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * DC_BN;
  const int kb_begin = blockIdx.y * a.blocks_per_split;
  const int kb_end = min(a.K / BK, kb_begin + a.blocks_per_split);
  const int n_st = max(0, (kb_end - kb_begin + C::SB - 1) / C::SB);
  const int every = a.tile_bk / 16;                     // byte rows between samples
  const int lim = a.K / a.tile_bk * (a.tile_bk / 2);    // byte rows of the whole tiles
  const int chunk = tid / 16, byte = tid % 16;          // the column's byte in a tile row
  int row0 = kb_begin * HB;                             // byte row of the next stage's row 0
  int sum = 0;
  // rows past the split's end are zero-filled: sampled or not, they add 0
  auto compute = [&](const unsigned char* st) {
    for (int r = (every - row0 % every) % every; r < C::ROWS && row0 + r < lim; r += every)
      sum += static_cast<int8_t>(st[r * C::ROW + ((chunk ^ (r & 7)) << 4) + byte]);
    row0 += C::ROWS;
  };

  DcLoader<1, true, true, false, float, false, false, WV, false> loader(
      nullptr, a.w, nullptr, a.M, a.N, a.K, n0, kb_begin, kb_end);
  dc_ring<C>(loader, n_st, dc_smem, compute);
  float* tile = reinterpret_cast<float*>(dc_smem);    // one row: the strip's sums
  __syncthreads();                                    // every thread is done with the ring
  tile[tid] = static_cast<float>(sum);                // exact: |sum| < 2^24
  __syncthreads();
  if (!dc_sum_splits<1>(tile, a.partial, a.counters, 1, a.N, a.splits)) return;
  const int col = n0 + tid;
  if (col < a.N) {
    const float v = tile[tid];
    float y[DC_MT];
#pragma unroll
    for (int m = 0; m < DC_MT; ++m)            // every xw load in flight before the stores
      if (m < a.M) y[m] = a.xw[(size_t)m * a.N + col];
#pragma unroll
    for (int m = 0; m < DC_MT; ++m)
      if (m < a.M) a.out[(size_t)m * a.N + col] = y[m] + v;
  }
}

using KernelFn = void (*)(Args);

// A kernel instantiation and its dynamic shared memory (the ring)
struct RingKernel {
  KernelFn fn;
  int smem;
};

template <int KIND>
RingKernel plane_kernel(int M, bool wide) {
  // narrow copies: [K, N/2] rows start on 4 bytes, [K/2, N] rows on 8 (N % 8 == 0)
  constexpr int NARROW = KIND == I4NATIVE ? 4 : 8;
  const KernelFn fn = M <= 8 ? (wide ? k_planes<1, KIND, 16> : k_planes<1, KIND, NARROW>)
                             : (wide ? k_planes<2, KIND, 16> : k_planes<2, KIND, NARROW>);
  return {fn, PlaneRing<KIND>::SMEM};
}

template <bool W4A8_X>
RingKernel int8_kernel(int M, bool wide) {
  const KernelFn fn = M <= 8 ? (wide ? k_int8<1, W4A8_X, 16> : k_int8<1, W4A8_X, 8>)
                             : (wide ? k_int8<2, W4A8_X, 16> : k_int8<2, W4A8_X, 8>);
  return {fn, I8Ring::SMEM};
}

// The kernel of (kind, M, N): 16-byte weight copies where every row starts
// on 16 bytes; one token tile at M <= 8, two at M <= 16
RingKernel select_kernel(int kind, int M, int N) {
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
    case STREAM: return {wide ? k_stream<16> : k_stream<8>, StreamRing::SMEM};
    case INTDOT: return int8_kernel<false>(M, wide);
    case W4A8: return int8_kernel<true>(M, wide);
    default: return {nullptr, 0};
  }
}

bool valid_geometry(int M, int N, int K, int ksplit) {
  return M >= 1 && M <= DECODE_MAX_M && N > 0 && N % 8 == 0 && K > 0 && K % BK == 0 &&
         ksplit > 0 && ksplit % BK == 0;
}

int n_splits(int K, int ksplit) {
  const int bps = ksplit / BK;
  return (K / BK + bps - 1) / bps;
}

}  // namespace

// f32 workspace floats (the split partials) for this launch geometry; 0 when
// one split covers K (the kernel writes the output itself).
extern "C" long long int4_probe_workspace(int M, int N, int K, int ksplit) {
  if (M < 1 || N <= 0 || K < BK || ksplit < BK) return 0;
  const int splits = n_splits(K, ksplit);
  return splits > 1 ? (long long)splits * M * N : 0;
}

// Launch the kernel of `kind` (enum Kind) in one launch: 256-column strips ×
// splits of `ksplit` K rows, with `counters` (int32, counter_slots >=
// ceil(N / 256) when K is split; zero before the launch and left zero by
// it, one stream at a time).  tile_bn / tile_bk: the TPU tile whose
// elements noscale, halfq8 and stream read.  Returns the launch's CUDA
// error.
extern "C" int int4_probe_launch(int kind, const void* xa, const void* xb, const void* sx,
                                 const void* w, const void* s, const void* xw, void* out,
                                 void* workspace, long long ws_floats, void* counters,
                                 int counter_slots, int M, int N, int K, int ksplit, int tile_bn,
                                 int tile_bk, void* stream) {
  if (kind < 0 || kind >= N_KINDS || !valid_geometry(M, N, K, ksplit) || tile_bn <= 0 ||
      tile_bk < BK || tile_bk % BK || tile_bk > K)
    return static_cast<int>(cudaErrorInvalidValue);
  const int splits = n_splits(K, ksplit), strips = (N + DC_BN - 1) / DC_BN;
  const long long need = int4_probe_workspace(M, N, K, ksplit);
  if ((need > 0 && (workspace == nullptr || ws_floats < need)) ||
      (splits > 1 && (counters == nullptr || counter_slots < strips)))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{xa, xb, static_cast<const float*>(sx), static_cast<const int8_t*>(w), s,
         static_cast<const float*>(xw), static_cast<float*>(out),
         need > 0 ? static_cast<float*>(workspace) : nullptr, static_cast<int*>(counters), M, N,
         K, ksplit / BK, splits, tile_bn, tile_bk};
  const RingKernel k = select_kernel(kind, M, N);
  const cudaError_t e = cudaFuncSetAttribute(
      reinterpret_cast<const void*>(k.fn), cudaFuncAttributeMaxDynamicSharedMemorySize, k.smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  k.fn<<<dim3(strips, splits), THREADS, k.smem, static_cast<cudaStream_t>(stream)>>>(a);
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
  const RingKernel k = select_kernel(kind, M, 32 * DC_BN);
  e = cudaFuncSetAttribute(reinterpret_cast<const void*>(k.fn),
                           cudaFuncAttributeMaxDynamicSharedMemorySize, k.smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaFuncAttributes attr;
  e = cudaFuncGetAttributes(&attr, reinterpret_cast<const void*>(k.fn));
  if (e != cudaSuccess) return static_cast<int>(e);
  *regs = attr.numRegs;
  *smem = static_cast<int>(attr.sharedSizeBytes);
  *dyn_smem = k.smem;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      ctas, reinterpret_cast<const void*>(k.fn), THREADS, k.smem));
}
