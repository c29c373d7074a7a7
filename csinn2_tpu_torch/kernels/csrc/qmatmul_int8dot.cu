// Integer GEMM for Hopper (sm_90a): int8 activations × int8 weights, the
// products summed exactly in int32 on the tensor cores, then the
// quant_matmul epilogue:
//   y[M,N] = epilogue(Σ_k x[m,k] · q[k,n])
//
// Replaces: csinn2_tpu/kernels/qmatmul.py quant_matmul → _kernel (:116,
// pallas_call :592) on its int_dot path (:212-216, chosen at :484-486: int8 x
// and int8 weights, channel or no scales, not packed [N, K/2]) with
//   * the float epilogue (:261-269): channel scale, epilogue_scale, f32 bias,
//     then f32 / bf16, int8 / uint8 / int16 (clip(round(y) + zp)) or int32
//     (a plain cast) — epilogue.cuh epi_float_col / store_kind;
//   * the swiglu pairs after it (:270-277): out[m, g·128+l] =
//     silu(h[m, g·256+l]) · h[m, g·256+128+l], h the float epilogue's f32;
//   * the fixed-point requantize (:247-260, rq_mult / rq_shift with
//     kernels/requant.py requant_int): an int32 bias added to the exact sum,
//     then SRDHM and the rounding shift in 64-bit integers
//     (epilogue.cuh requant_fixed) — bit for bit the oracle
//     core.quant.requantize_int.
// Weights: int8 [K, N] (W_KN), int8 [N, K] (W_NK, the rearranged layout), or
// packed int4 [K/2, N] (W_PACKED_KN, llama.cpp nibble order: byte b·16+j of a
// 32-row block holds rows b·32+j (low) and b·32+16+j (high)).
//
// Bound.  2·M·N·K integer operations against the weight stream (K·N bytes,
// K·N/2 packed) plus x and the output: at M <= 128 the weight bytes bound it
// (1979 TOP/s int8 against 3.35 TB/s is 590 operations a byte, 2·M a weight
// byte here), above it the operations do.
//
// Design.  Both kernels take the product transposed, out^T[n][m] = Σ_k
// q[k][n] · x[m][k], with the weights as the A operand (output columns as
// its m rows) and x, k-contiguous as it lies, as B; the int32 sums wrap as
// the TPU's int32 accumulator (no .satfinite).  An int8 fragment wants four
// consecutive k of one column in a register: [N, K] bytes are that already
// (plain ldmatrix); [K, N] and packed [K/2, N] bytes are regrouped with
// ldmatrix.trans, its eight rows addressed as k rows {0,1,4,5,8,9,12,13} and
// {2,3,6,7,10,11,14,15} so that one PRMT of the two registers gives a
// column's k quad (weight tiles swizzled so that those rows read free of bank
// conflicts; the fragment helpers in int8_frag.cuh, the decode ring's
// stage and loader, I8Dc / I8Loader, in decode_ring.cuh).
//   * M <= 16, qmm_i8_decode_kernel: the float decode GEMM's skeleton
//     (decode_ring.cuh): 256-column strips × K splits filling two CTAs an SM,
//     the raw weight bytes and the x rows in a cp.async ring (16 KB weight
//     stages, 32 KB for [N, K]), mma.sync m16n8k32 s8 with one or two n8
//     tiles of tokens, and with a split the strip's last CTA summing the
//     splits' int32 partials in split order in the same launch
//     (dc_sum_splits<NT, int>), then the epilogue.  Packed nibbles are taken
//     biased, u = (v & 0x0F) ^ 0x08 = n + 8 (one LOP3 for four), and each
//     split subtracts 8·Σ_k x[m,k] over its k range from its sums (the x
//     rows summed by dp4a as they pass through the ring): exact in int32.
//   * M > 16, qmm_i8_prefill_kernel: a 128-token × 256-column tile a CTA
//     (one CTA an SM), x and the raw weight bytes through a 4-stage cp.async
//     ring of 128-k stages loaded two ahead, wgmma m64n128k32 s8 with the
//     regrouped weights as register A (each warpgroup two m64 column tiles)
//     and the x tile as the shared-memory B (K-major, 128-byte swizzle);
//     packed nibbles sign-extended in three ops for four (((v & 0x0F) ^
//     0x08) + 0x78) ^ 0x80.  K splits (a plan of waves × blocks plus the
//     partials' round trip) finish in the launch: every split writes its
//     int32 tile, the tile's last CTA adds the others'.
// Both end in a finish tile of int32 sums in shared memory, where a thread a
// column applies the epilogue (coalesced stores) and swiglu pairs columns c
// and c + 128 of a 256-column strip.
#include "decode_ring.cuh"
#include "epilogue.cuh"

namespace {

constexpr int SWIGLU_HALF = 128;       // columns per half of a swiglu pair

struct Requant {
  bool on;                 // the fixed-point requantize (else the float epilogue)
  const int* mult;         // [N] int32 multipliers, or null: mult_s for every column
  const int* shift;        // [N] int32 shifts, or null: shift_s
  int mult_s, shift_s;
  const int* bias_i32;     // [N] or null
  int qmin, qmax;
};

// The epilogue of a finish tile of int32 sums (row m at m·stride, rows
// output rows m0 ..): thread tid owns column n0 + tid, its stores coalesced
// across the CTA, the output type's store chosen once.  With swiglu (N % 256
// == 0, the strip whole) the f32 epilogue goes back into the tile and
// columns tid, tid + 128 pair.
__device__ __forceinline__ void i8_tile_epilogue(int* tile, int stride, int rows, int m0,
                                                 int n0, const Epi& ep, const Requant& rq,
                                                 void* out, int N, bool swiglu) {
  const int tid = threadIdx.x, col = n0 + tid;
  if (rq.on) {
    if (col >= N) return;
    const int mult = rq.mult != nullptr ? rq.mult[col] : rq.mult_s;
    const int shift = rq.shift != nullptr ? rq.shift[col] : rq.shift_s;
    const int b = rq.bias_i32 != nullptr ? rq.bias_i32[col] : 0;
    auto rows_store = [&](auto store) {
      for (int m = 0; m < rows; ++m)     // the int32 bias first, wrapping as the TPU's add
        store((size_t)(m0 + m) * N + col,
              requant_fixed(wrap_add(tile[m * stride + tid], b), mult, shift,
                            static_cast<int>(ep.zp), rq.qmin, rq.qmax));
    };
    switch (ep.out_kind) {
      case OUT_I8: rows_store([&](size_t i, int y) { static_cast<int8_t*>(out)[i] = y; }); break;
      case OUT_U8: rows_store([&](size_t i, int y) { static_cast<uint8_t*>(out)[i] = y; }); break;
      default: rows_store([&](size_t i, int y) { static_cast<int16_t*>(out)[i] = y; }); break;
    }
    return;
  }
  const float cs = ep.ch_scale != nullptr && col < N ? ep.ch_scale[col] : 1.f;
  const float cb = ep.bias != nullptr && col < N ? ep.bias[col] : 0.f;
  if (!swiglu) {
    if (col >= N) return;
    auto rows_store = [&](auto store) {
      for (int m = 0; m < rows; ++m)
        store((size_t)(m0 + m) * N + col,
              epi_float_col(static_cast<float>(tile[m * stride + tid]), cs, cb, ep));
    };
    switch (ep.out_kind) {
      case OUT_F32: rows_store([&](size_t i, float v) { static_cast<float*>(out)[i] = v; }); break;
      case OUT_BF16:
        rows_store([&](size_t i, float v) {
          static_cast<__nv_bfloat16*>(out)[i] = __float2bfloat16_rn(v);
        });
        break;
      default: rows_store([&](size_t i, float v) { store_kind(out, i, v, ep); }); break;
    }
    return;
  }
  float* ft = reinterpret_cast<float*>(tile);
  for (int m = 0; m < rows; ++m)
    ft[m * stride + tid] = epi_float_col(static_cast<float>(tile[m * stride + tid]), cs, cb, ep);
  __syncthreads();
  if (tid < SWIGLU_HALF)
    for (int m = 0; m < rows; ++m) {
      const float h1 = ft[m * stride + tid], h3 = ft[m * stride + SWIGLU_HALF + tid];
      store_kind(out, (size_t)(m0 + m) * (N / 2) + n0 / 2 + tid, h1 / (1.f + expf(-h1)) * h3,
                 ep);
    }
}

// ---------------------------------------------------------------------------
// Decode (M <= 16): the float decode GEMM's ring, int8 mma.sync
// ---------------------------------------------------------------------------

// Decode, every layout: CTA (strip, split) owns columns n0 .. n0+255 and
// the split's 32-k blocks; warp w owns 32 of the columns as two m16 tiles.
// A: [K, N] / packed through the regrouping ldmatrix.trans (rows g and g + 8
// of tile t: columns 32w + 16t + 2g and + 1), [N, K] through plain ldmatrix
// (columns 32w + 16t + g and + 8); B: NT n8 tiles of tokens by ldmatrix,
// rows past M zeros.
template <int NT, int WL>
__global__ void __launch_bounds__(THREADS, DC_CTAS_PER_SM)
qmm_i8_decode_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w, Epi ep,
                     Requant rq, void* __restrict__ out, int* __restrict__ partial,
                     int* __restrict__ counters, int M, int N, int K, int blocks_per_split,
                     int splits, int swiglu) {
  using C = I8Dc<WL>;
  extern __shared__ __align__(16) unsigned char dc_smem[];
  __shared__ int corr[DC_MT];                  // packed: 8·Σ_k x[m, k] over the split
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, tig = lane % 4;
  const int lm = lane / 8, li = lane % 8;
  const int n0 = blockIdx.x * DC_BN;
  const int nb = (K + BK - 1) / BK;
  const int kb_begin = blockIdx.y * blocks_per_split;
  const int kb_end = min(nb, kb_begin + blocks_per_split);
  const int n_st = max(0, (kb_end - kb_begin + C::SB - 1) / C::SB);
  const int cb = warp * 32;                    // this warp's columns, relative to n0

  int acc[2][NT][4];
#pragma unroll
  for (int t = 0; t < 2; ++t)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[t][nt][e] = 0;
  int xsum = 0;                                // packed: this lane's share of Σ x

  // the lane's ldmatrix addresses within a stage
  const int xrow = NT == 2 ? 8 * (lm >> 1) + li : li;
  const int xoff = xrow * C::SK;
  const int xswz = x_swz<C::XCH>(xrow);
  const int rr = regroup_row(lane, !C::PK);    // [K, N]: k 0-31; packed: byte rows 0-15
  const int rswz = kn_swz(rr);
  auto compute = [&](const unsigned char* st) {
    const unsigned char* xs = st + C::W_BYTES;
    if constexpr (C::PK) {                     // tokens 2w, 2w + 1: 16 lanes a row
      const int* xw = reinterpret_cast<const int*>(xs + (2 * warp + (lane >> 4)) * C::SK);
#pragma unroll
      for (int i = 0; i < C::SK / 64; ++i) xsum = __dp4a(xw[(lane & 15) + 16 * i], 0x01010101, xsum);
    }
#pragma unroll
    for (int b = 0; b < C::SB; ++b) {
      uint32_t xb[NT][2];
      const int xc = 2 * b + (lm & 1);
      if constexpr (NT == 2) {
        uint32_t r[4];
        ldmatrix_x4(r, xs + xoff + ((xc ^ xswz) << 4), false);
        xb[0][0] = r[0]; xb[0][1] = r[1]; xb[1][0] = r[2]; xb[1][1] = r[3];
      } else {
        ldmatrix_x2(xb[0], xs + xoff + ((xc ^ xswz) << 4));
      }
      uint32_t a[2][4];
      if constexpr (C::NK) {
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          const int nr = cb + 16 * t + 8 * (lm & 1) + li;
          const int c = 2 * b + (lm >> 1);
          ldmatrix_x4(a[t], st + nr * C::ROW + ((c ^ (nr & 7)) << 4), false);
        }
      } else if constexpr (C::PK) {           // byte rows 0-15 of block b, both chunks
        uint32_t r[4];
        const int chunk = cb / 16 + (lm >> 1);
        ldmatrix_x4(r, st + (b * 16 + rr) * C::ROW + ((chunk ^ rswz) << 4), true);
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          const uint32_t qe = quad_even(r[2 * t], r[2 * t + 1]);
          const uint32_t qo = quad_odd(r[2 * t], r[2 * t + 1]);
          a[t][0] = nib_biased(qe);
          a[t][1] = nib_biased(qo);
          a[t][2] = nib_biased(qe >> 4);
          a[t][3] = nib_biased(qo >> 4);
        }
      } else {
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          uint32_t r[4];
          const int chunk = cb / 16 + t;
          ldmatrix_x4(r, st + (b * BK + rr) * C::ROW + ((chunk ^ rswz) << 4), true);
          a[t][0] = quad_even(r[0], r[1]);
          a[t][1] = quad_odd(r[0], r[1]);
          a[t][2] = quad_even(r[2], r[3]);
          a[t][3] = quad_odd(r[2], r[3]);
        }
      }
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) mma_s8(acc[t][nt], a[t], xb[nt]);
    }
  };

  I8Loader<WL> loader(x, w, M, N, K, n0, kb_begin, kb_end);
  dc_ring<C>(loader, n_st, dc_smem, compute);
  if constexpr (C::PK) {
#pragma unroll
    for (int o = 8; o > 0; o >>= 1) xsum += __shfl_xor_sync(0xffffffffu, xsum, o);
    if ((lane & 15) == 0) corr[2 * warp + (lane >> 4)] = 8 * xsum;
  }
  const int col[2] = {C::NK ? cb + g : cb + 2 * g, C::NK ? cb + 16 + g : cb + 16 + 2 * g};
  int* tile = reinterpret_cast<int*>(dc_smem);
  dc_tile_store<NT>(tile, acc, col, C::NK ? 8 : 1, tig);
  if constexpr (C::PK) {                       // the biased nibbles' 8·Σ x, this split's
#pragma unroll
    for (int m = 0; m < 8 * NT; ++m)
      tile[m * DC_BN + tid] = static_cast<int>(static_cast<unsigned>(tile[m * DC_BN + tid]) -
                                               static_cast<unsigned>(corr[m]));
    __syncthreads();
  }
  if (!dc_sum_splits<NT, int>(tile, partial, counters, M, N, splits)) return;
  i8_tile_epilogue(tile, DC_BN, M, 0, n0, ep, rq, out, N, swiglu != 0);
}

// ---------------------------------------------------------------------------
// Prefill (M > 16): a 4-stage cp.async ring into int8 wgmma
// ---------------------------------------------------------------------------

constexpr int PI_BM = 128;          // CTA tile rows (tokens)
constexpr int PI_SK = 128;          // k a stage
constexpr int PI_XCH = PI_SK / 16;  // 16-byte chunks of an x row
constexpr int PI_SPLIT_ALIGN = PI_SK / BK;   // a split's blocks: whole stages

// One stage: the x tile (int8 [128][PI_SK], chunk c of row r at c ^
// x_swz(r): wgmma's 128-byte swizzle), then the raw weight bytes — [K, N]:
// PI_SK k rows × BN bytes (chunk c of row r at c ^ kn_swz(r)); packed:
// PI_SK / 2 byte rows × BN; [N, K]: BN rows × PI_SK bytes (chunk c at c ^
// x_swz(n)).  After the loop the ring holds the finish tile (int32 [128][BN
// + 4]).
template <int WL>
struct I8Pf {
  static constexpr int BN = DC_BN;                      // columns a CTA (one an SM)
  static constexpr int MT = BN / 128;                   // m64 column tiles a warpgroup
  static constexpr int STAGES = 4;                      // 192 KB
  static constexpr int X_BYTES = PI_BM * PI_SK;
  static constexpr int W_BYTES = (WL == W_PACKED_KN ? PI_SK / 2 : PI_SK) * BN;
  static constexpr int STAGE = X_BYTES + W_BYTES;
  static constexpr int RING = STAGES * STAGE;
  static constexpr int TS = BN + 4;                     // finish tile row stride (skewed)
  static constexpr int TILE = PI_BM * TS * 4;
  static constexpr int SMEM = (RING > TILE ? RING : TILE) + 1024;   // + alignment to 1024
};
static_assert(I8Pf<W_KN>::SMEM <= 232448 && I8Pf<W_NK>::SMEM <= 232448,
              "the ring must fit a CTA's shared memory");

// The shared-memory descriptor of a K-major tile with PI_SK-byte rows in the
// matching swizzle (64 bytes: chunk c of row r at c ^ ((r >> 1) & 3), 8-row
// groups 512 bytes apart; 128 bytes: c ^ (r & 7), 1024 apart)
__device__ __forceinline__ uint64_t kmajor_desc(const void* p) {
  constexpr uint64_t layout = PI_SK == 128 ? 1 : 2;      // 128- / 64-byte swizzle
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(8 * PI_SK >> 4) << 32) | (layout << 62);
}

// d[0..63] += A · B, one warpgroup: A s8 m64 × k32 in registers (each warp
// 16 rows, the mma.sync m16n8k32 A fragment), B s8 k32 × n128 in shared
// memory (K-major, 128-byte swizzle), s32 sums that wrap
__device__ __forceinline__ void wgmma_s8_m64n128k32(int* d, const uint32_t* a, uint64_t bdesc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p;\n"
      "}\n"
      :
        "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
        "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(bdesc), "r"(1));
}

// d[0..63] += A · B, one warpgroup, A s8 m64 × k32 and B s8 k32 × n128 both
// in shared memory (K-major, 128-byte swizzle): the [N, K] weights as they
// lie, with no register hazard, so stages overlap
__device__ __forceinline__ void wgmma_s8_m64n128k32_ss(int* d, uint64_t adesc, uint64_t bdesc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n"
      "}\n"
      :
        "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
        "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(adesc), "l"(bdesc), "r"(1));
}

// Stage t of the split (k from k0) into the ring slot at xs: x rows m0 ..
// m0+127 and the raw weight bytes of columns n0 .. n0+BN-1, zero-filled past
// M, N and k_lim (packed: byte rows past the split's blocks); one cp.async
// group, committed by the caller.
template <int WL, int BN>
__device__ __forceinline__ void pi_load_stage(unsigned char* xs, const int8_t* x,
                                              const int8_t* w, int M, int N, int K, int m0,
                                              int n0, int k0, int k_lim) {
  const int tid = threadIdx.x;
  unsigned char* ws = xs + PI_BM * PI_SK;
#pragma unroll
  for (int i = tid; i < PI_BM * PI_XCH; i += THREADS) {     // x
    const int r = i / PI_XCH, c = i % PI_XCH;
    const bool ok = m0 + r < M && k0 + c * 16 < k_lim;
    cp_async_s<16>(smem_u32(xs + r * PI_SK + ((c ^ x_swz<PI_XCH>(r)) << 4)),
                   ok ? x + (size_t)(m0 + r) * K + k0 + c * 16 : x, ok);
  }
  if constexpr (WL == W_NK) {
#pragma unroll
    for (int i = tid; i < BN * PI_XCH; i += THREADS) {
      const int r = i / PI_XCH, c = i % PI_XCH;
      const bool ok = n0 + r < N && k0 + c * 16 < k_lim;
      cp_async_s<16>(smem_u32(ws + r * PI_SK + ((c ^ x_swz<PI_XCH>(r)) << 4)),
                     ok ? w + (size_t)(n0 + r) * K + k0 + c * 16 : w, ok);
    }
  } else {
    constexpr bool PK = WL == W_PACKED_KN;
    constexpr int ROWS = PK ? PI_SK / 2 : PI_SK, CH = BN / 16;
    const int row0 = PK ? k0 / 2 : k0;                       // K % 32 == 0 when packed
    const int row_lim = PK ? k_lim / 2 : k_lim;
#pragma unroll
    for (int i = tid; i < ROWS * CH; i += THREADS) {
      const int r = i / CH, c = i % CH;
      const bool ok = row0 + r < row_lim && n0 + c * 16 < N;
      cp_async_s<16>(smem_u32(ws + r * BN + ((c ^ kn_swz(r)) << 4)),
                     ok ? w + (size_t)(row0 + r) * N + n0 + c * 16 : w, ok);
    }
  }
}

// Prefill, every layout: CTA (strip, split, m-tile) owns tokens m0 ..
// m0+127 and columns n0 .. n0+255; warpgroup wg the columns wg·128 .. as two
// m64 tiles, x the B operand as it lies.  [N, K]: A is the ring's weight
// tile as it lies (no regroup), each stage's wgmmas done before the next
// barrier, and loads three stages ahead (the weight stream's bytes in
// flight bound it at M = 128); [K, N] / packed: the warps regroup A rows
// (16 a warp) from the ring into registers after the previous stage's
// wgmmas are done (a register written while a wgmma may read it serialises
// them), loads two stages ahead.
template <int WL>
__global__ void __launch_bounds__(THREADS, 1)
qmm_i8_prefill_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w, Epi ep,
                      Requant rq, void* __restrict__ out, int* __restrict__ partial,
                      int* __restrict__ counters, int M, int N, int K, int blocks_per_split,
                      int splits, int swiglu) {
  using C = I8Pf<WL>;
  constexpr int BN = C::BN, MT = C::MT, S = C::STAGES;
  extern __shared__ __align__(16) unsigned char pi_raw[];
  unsigned char* smem = pi_raw + ((1024 - (smem_u32(pi_raw) & 1023)) & 1023);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wg = warp / 4, wq = warp % 4;
  const int g = lane / 4, tig = lane % 4;
  const int lm = lane / 8, li = lane % 8;
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.z * PI_BM;
  const int nb = (K + BK - 1) / BK;
  const int kb_begin = blockIdx.y * blocks_per_split;
  const int kb_end = min(nb, kb_begin + blocks_per_split);
  const int n_st = max(0, (kb_end - kb_begin + PI_SPLIT_ALIGN - 1) / PI_SPLIT_ALIGN);
  const int k_lim = min(K, kb_end * BK);
  int cb[MT];                                  // this warp's 16-column chunk of each m64 tile
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) cb[mt] = wg * (BN / 2) + mt * 64 + wq * 16;

  int acc[MT][64];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int e = 0; e < 64; ++e) acc[mt][e] = 0;
  uint32_t af[PI_SK / BK][MT][4];              // [k32 of the stage][m64 tile][fragment]

  const int rr = regroup_row(lane, WL == W_KN);
  const int rswz = kn_swz(rr);
  auto regroup = [&](int st) {                 // [K, N] / packed: the A fragments of slot st
    const unsigned char* ws = smem + st * C::STAGE + C::X_BYTES;
#pragma unroll
    for (int kb = 0; kb < PI_SK / BK; ++kb) {
      if constexpr (WL == W_PACKED_KN) {
        uint32_t r[4];                         // byte rows 0-15 of block kb, tiles 0 / 1
        const int chunk = cb[lm >> 1] / 16;
        ldmatrix_x4(r, ws + (kb * 16 + rr) * BN + ((chunk ^ rswz) << 4), true);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const uint32_t qe = quad_even(r[2 * mt], r[2 * mt + 1]);
          const uint32_t qo = quad_odd(r[2 * mt], r[2 * mt + 1]);
          af[kb][mt][0] = nib_signed(qe);
          af[kb][mt][1] = nib_signed(qo);
          af[kb][mt][2] = nib_signed(qe >> 4);
          af[kb][mt][3] = nib_signed(qo >> 4);
        }
      } else {
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          uint32_t r[4];
          ldmatrix_x4(r, ws + (kb * BK + rr) * BN + (((cb[mt] / 16) ^ rswz) << 4), true);
          af[kb][mt][0] = quad_even(r[0], r[1]);
          af[kb][mt][1] = quad_odd(r[0], r[1]);
          af[kb][mt][2] = quad_even(r[2], r[3]);
          af[kb][mt][3] = quad_odd(r[2], r[3]);
        }
      }
    }
  };

  // [N, K] waits for each stage's wgmmas before the next barrier, so its
  // loads run S - 1 stages ahead, into the slot of stage t - 1; [K, N] /
  // packed, whose barrier overlaps the previous stage's wgmmas, S - 2
  constexpr int AHEAD = WL == W_NK ? S - 1 : S - 2;
  const int k_begin = kb_begin * BK;
#pragma unroll
  for (int t = 0; t < AHEAD; ++t) {
    if (t < n_st)
      pi_load_stage<WL, BN>(smem + t * C::STAGE, x, w, M, N, K, m0, n0, k_begin + t * PI_SK,
                            k_lim);
    cp_async_commit();
  }
  for (int t = 0; t < n_st; ++t) {
    const int st = t % S;
    cp_async_wait<AHEAD - 1>();                // stage t has landed
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");   // ... for wgmma too
    __syncthreads();                           // ... for every thread
    const uint64_t bd = kmajor_desc(smem + st * C::STAGE);
    if constexpr (WL == W_NK) {                // A from the ring: no register hazard
      const unsigned char* ws = smem + st * C::STAGE + C::X_BYTES + wg * (BN / 2) * PI_SK;
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int kb = 0; kb < PI_SK / BK; ++kb)
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          wgmma_s8_m64n128k32_ss(acc[mt], kmajor_desc(ws + mt * 64 * PI_SK) + 2 * kb,
                                 bd + 2 * kb);
    } else {
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");   // stage t-1's
      regroup(st);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int kb = 0; kb < PI_SK / BK; ++kb)
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) wgmma_s8_m64n128k32(acc[mt], af[kb][mt], bd + 2 * kb);
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    const int nt = t + AHEAD;                  // into a slot whose wgmmas are done
    if (nt < n_st)                             // issued under this stage's wgmmas
      pi_load_stage<WL, BN>(smem + (nt % S) * C::STAGE, x, w, M, N, K, m0, n0,
                            k_begin + nt * PI_SK, k_lim);
    cp_async_commit();
    if constexpr (WL == W_NK)                  // this stage's wgmmas, before the next barrier
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)              // the sums are read after the wait
#pragma unroll
    for (int e = 0; e < 64; ++e) asm volatile("" : "+r"(acc[mt][e])::"memory");
  cp_async_wait<0>();
  __syncthreads();                             // every warp is done with the ring

  // acc[mt][4j + e]: token 8j + 2tig + (e & 1), A row 16·wq + g + 8·(e >> 1):
  // column cb + 2g (+1 for rows 8-15) of [K, N] / packed, cb + g (+8) of [N, K]
  int* tile = reinterpret_cast<int*>(smem);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = WL == W_NK ? cb[mt] + g + 8 * (e >> 1) : cb[mt] + 2 * g + (e >> 1);
        tile[(8 * j + 2 * tig + (e & 1)) * C::TS + c] = acc[mt][4 * j + e];
      }
  __syncthreads();
  const int rows = min(PI_BM, M - m0);
  if (splits > 1) {
    // every split's int32 tile to the partials [splits, M, N]; the tile's
    // last CTA adds the others' (integer sums: the same bits in any order)
    constexpr int V = BN / 4;                  // int4s of a tile row
    __shared__ int last;
    const size_t zs = (size_t)M * N;
    for (int i = tid; i < rows * V; i += THREADS) {
      const int m = i / V, c = i % V * 4;
      if (n0 + c < N)
        *reinterpret_cast<int4*>(partial + blockIdx.y * zs + (size_t)(m0 + m) * N + n0 + c) =
            *reinterpret_cast<const int4*>(tile + m * C::TS + c);
    }
    __syncthreads();
    int* counter = counters + blockIdx.z * gridDim.x + blockIdx.x;
    if (tid == 0) {
      __threadfence();                         // the CTA's partial before its ticket
      last = atomicAdd(counter, 1) == splits - 1;
      if (last) *counter = 0;                  // every split has taken its ticket
      __threadfence();
    }
    __syncthreads();
    if (!last) return;
    constexpr int GP = 8;                      // int4s of a thread in flight per split
    for (int i0 = tid; i0 < rows * V; i0 += GP * THREADS) {
      int4 v[GP];
#pragma unroll
      for (int p = 0; p < GP; ++p) {
        const int i = i0 + p * THREADS, m = i / V, c = i % V * 4;
        v[p] = i < rows * V ? *reinterpret_cast<const int4*>(tile + m * C::TS + c) : int4{};
      }
      for (int z = 0; z < splits; ++z) {
        if (z == (int)blockIdx.y) continue;
        int4 q[GP];
#pragma unroll
        for (int p = 0; p < GP; ++p) {
          const int i = i0 + p * THREADS, m = i / V, c = i % V * 4;
          q[p] = i < rows * V && n0 + c < N
                     ? __ldcg(reinterpret_cast<const int4*>(partial + z * zs +
                                                            (size_t)(m0 + m) * N + n0 + c))
                     : int4{};
        }
#pragma unroll
        for (int p = 0; p < GP; ++p) add4(v[p], q[p]);
      }
#pragma unroll
      for (int p = 0; p < GP; ++p) {
        const int i = i0 + p * THREADS, m = i / V, c = i % V * 4;
        if (i < rows * V) *reinterpret_cast<int4*>(tile + m * C::TS + c) = v[p];
      }
    }
    __syncthreads();
  }
  i8_tile_epilogue(tile, C::TS, rows, m0, n0, ep, rq, out, N, swiglu != 0);
}

// ---------------------------------------------------------------------------
// Plan and launch
// ---------------------------------------------------------------------------

struct I8Plan {
  int splits, blocks_per_split;
};

// Prefill cost model, in thirds of a nanosecond: a CTA's 32-k block of a
// 128 × 256 tile (8 KB of weights, 1 M MACs) takes ~200 ns on one SM, and
// the int32 partials' round trip (8 · splits · M · N bytes at ~3 TB/s)
// shows beside it.
constexpr long long PI_BLOCK_COST = 600;
constexpr int PI_MAX_SPLITS = 16;

// Decode (M <= 16): the float decode GEMM's plan (qmatmul.cuh
// plan_split_k) over ceil(K / 32) blocks: as many splits of a multiple of
// DC_SPLIT_ALIGN blocks as let the strips fill DC_CTAS_PER_SM CTAs an SM.
// Prefill: the split count (whole 128-k stages, at most PI_MAX_SPLITS) that
// minimises waves of tiles over the card's CTA slots × blocks a split plus
// the partials' cost; no split when the tiles outnumber the counter slots.
cudaError_t plan_i8(int M, int N, int K, int device, int counter_slots, I8Plan* plan) {
  static int sm_count[64];   // per device, read once
  if (device < 0 || device >= 64) return cudaErrorInvalidDevice;
  if (sm_count[device] == 0) {
    const cudaError_t e =
        cudaDeviceGetAttribute(&sm_count[device], cudaDevAttrMultiProcessorCount, device);
    if (e != cudaSuccess) return e;
  }
  const int sms = sm_count[device];
  const int nb = (K + BK - 1) / BK;
  const int strips = (N + DC_BN - 1) / DC_BN;
  if (M <= DECODE_MAX_M) {
    const int want = max(1, min(nb, DC_CTAS_PER_SM * sms / strips));
    const int bps = (max(1, (nb + want - 1) / want) + DC_SPLIT_ALIGN - 1) / DC_SPLIT_ALIGN *
                    DC_SPLIT_ALIGN;
    plan->blocks_per_split = bps;
    plan->splits = max(1, (nb + bps - 1) / bps);
    return cudaSuccess;
  }
  const long long tiles = (long long)((M + PI_BM - 1) / PI_BM) * strips;
  plan->splits = 1;
  plan->blocks_per_split = nb;
  if (tiles > counter_slots) return cudaSuccess;
  long long best = -1;
  const int max_s = max(1, min(PI_MAX_SPLITS, nb / PI_SPLIT_ALIGN));
  for (int sp = 1; sp <= max_s; ++sp) {
    const int bps = ((nb + sp - 1) / sp + PI_SPLIT_ALIGN - 1) / PI_SPLIT_ALIGN * PI_SPLIT_ALIGN;
    if ((nb + bps - 1) / bps != sp) continue;  // the same plan as fewer splits
    const long long waves = (tiles * sp + sms - 1) / sms;
    const long long cost =
        waves * bps * PI_BLOCK_COST + (sp > 1 ? 8LL * sp * M * N / 1000 : 0);
    if (best < 0 || cost < best) {
      best = cost;
      plan->splits = sp;
      plan->blocks_per_split = bps;
    }
  }
  return cudaSuccess;
}

template <class Kernel>
cudaError_t launch_i8(Kernel kernel, dim3 grid, int smem, cudaStream_t st, const int8_t* x,
                      const int8_t* w, const Epi& ep, const Requant& rq, void* out,
                      int* partial, int* counters, int M, int N, int K, const I8Plan& p,
                      int swiglu) {
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  kernel<<<grid, THREADS, smem, st>>>(x, w, ep, rq, out, partial, counters, M, N, K,
                                      p.blocks_per_split, p.splits, swiglu);
  return cudaGetLastError();
}

template <int WL>
cudaError_t dispatch_i8(const int8_t* x, const int8_t* w, const Epi& ep, const Requant& rq,
                        void* out, int* partial, int* counters, int M, int N, int K,
                        const I8Plan& p, int swiglu, cudaStream_t st) {
  if (M <= DECODE_MAX_M) {
    const dim3 grid((N + DC_BN - 1) / DC_BN, p.splits);
    auto kernel = M > 8 ? qmm_i8_decode_kernel<2, WL> : qmm_i8_decode_kernel<1, WL>;
    return launch_i8(kernel, grid, I8Dc<WL>::SMEM, st, x, w, ep, rq, out, partial, counters,
                     M, N, K, p, swiglu);
  }
  const dim3 grid((N + DC_BN - 1) / DC_BN, p.splits, (M + PI_BM - 1) / PI_BM);
  return launch_i8(qmm_i8_prefill_kernel<WL>, grid, I8Pf<WL>::SMEM, st, x, w, ep, rq, out,
                   partial, counters, M, N, K, p, swiglu);
}

}  // namespace

// The launch plan for [M,K]·[K,N] on `device` with counter_slots tile
// counters: *splits and *blocks_per_split (32-k blocks), and the int32
// workspace quant_matmul_int8dot needs (splits · M · N with a split, else 0),
// or -1 with the CUDA error in *err.  The plan does not depend on the layout.
extern "C" long long quant_matmul_int8dot_plan(int M, int N, int K, int device,
                                               int counter_slots, int* splits,
                                               int* blocks_per_split, int* err) {
  I8Plan p;
  const cudaError_t e = plan_i8(M, N, K, device, counter_slots, &p);
  *err = static_cast<int>(e);
  if (e != cudaSuccess) return -1;
  *splits = p.splits;
  *blocks_per_split = p.blocks_per_split;
  return p.splits > 1 ? (long long)p.splits * M * N : 0;
}

// x int8 [M,K]; w int8 [K,N] (layout 0), [N,K] (1) or packed [K/2,N] (2);
// ch_scale f32 [N] or null; bias f32 [N] (float epilogue) or int32 [N] (with
// requant != 0), or null; with requant the multipliers and shifts int32 [N]
// (rq_mult, rq_shift), or null for the scalars mult_s / shift_s; out [M,N]
// of out_kind (epilogue.cuh OutKind; with requant: int8, uint8 or int16), or
// [M,N/2] with swiglu != 0 (float epilogue, N % 256 == 0); workspace int32
// of ws_ints (at least quant_matmul_int8dot_plan's); counters int32 of
// counter_slots (as in its plan), zero before the launch and left zero by
// it, used by one stream at a time.  K % 16 == 0 (packed: % 32), N % 16 ==
// 0, all pointers 16-byte aligned.
extern "C" int quant_matmul_int8dot(const void* x, const void* w, int layout,
                                    const void* ch_scale, const void* bias, int requant,
                                    const void* rq_mult, const void* rq_shift, int mult_s,
                                    int shift_s, void* out, int out_kind, float e, int has_e,
                                    float zp, int swiglu, void* workspace, long long ws_ints,
                                    void* counters, int counter_slots, int M, int N, int K,
                                    int device, void* stream) {
  if ((requant && (out_kind < OUT_I8 || out_kind > OUT_I16 || swiglu)) || layout < W_KN ||
      layout > W_PACKED_KN)
    return static_cast<int>(cudaErrorInvalidValue);
  I8Plan p;
  cudaError_t err = plan_i8(M, N, K, device, counter_slots, &p);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int ctas_per_split = (N + DC_BN - 1) / DC_BN *
                             (M <= DECODE_MAX_M ? 1 : (M + PI_BM - 1) / PI_BM);
  if (p.splits > 1 && (workspace == nullptr || ws_ints < (long long)p.splits * M * N ||
                       counters == nullptr || ctas_per_split > counter_slots))
    return static_cast<int>(cudaErrorInvalidValue);
  Epi ep{static_cast<const float*>(ch_scale), requant ? nullptr : static_cast<const float*>(bias),
         e, has_e, zp, out_kind};
  const int qmin = out_kind == OUT_I8 ? -128 : (out_kind == OUT_U8 ? 0 : -32768);
  const int qmax = out_kind == OUT_I8 ? 127 : (out_kind == OUT_U8 ? 255 : 32767);
  Requant r{requant != 0, static_cast<const int*>(rq_mult), static_cast<const int*>(rq_shift),
            mult_s, shift_s, requant ? static_cast<const int*>(bias) : nullptr, qmin, qmax};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* xp = static_cast<const int8_t*>(x);
  const int8_t* wp = static_cast<const int8_t*>(w);
  int* part = static_cast<int*>(workspace);
  int* cnt = static_cast<int*>(counters);
  if (layout == W_KN)
    err = dispatch_i8<W_KN>(xp, wp, ep, r, out, part, cnt, M, N, K, p, swiglu, st);
  else if (layout == W_NK)
    err = dispatch_i8<W_NK>(xp, wp, ep, r, out, part, cnt, M, N, K, p, swiglu, st);
  else
    err = dispatch_i8<W_PACKED_KN>(xp, wp, ep, r, out, part, cnt, M, N, K, p, swiglu, st);
  return static_cast<int>(err);
}
