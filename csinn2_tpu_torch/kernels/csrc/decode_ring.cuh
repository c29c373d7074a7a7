// The decode GEMM's skeleton, shared by qmm_decode_kernel (qmatmul.cuh) and
// the Q4_0 dequant probes' tensor-core kernel (int4_probe.cu): a CTA of 256
// threads owns a 256-column strip and one K split; its raw weight bytes, their
// block scales and the few x rows stream through a cp.async ring of 16 KB
// weight stages (DcLoader, dc_ring); warps widen the bytes in registers into
// mma.sync m16n8k16 A fragments (the weights are A, x^T is B); the sums land
// in the ring as a finish tile (dc_tile_store), and with a split the strip's
// last CTA sums the splits' partials in split order (dc_sum_splits).  The
// widening and the output epilogue are each kernel's own.  The int8-x
// decode GEMM (qmatmul_int8dot.cu) shares the ring, the tile store and the
// split finish with int32 sums (T = int: exact, wrapping adds), through its
// own stage and loader (I8Dc, I8Loader, at the end), which the W4A8 probes
// share too.
#pragma once

#include "common.cuh"
#include "int8_frag.cuh"

namespace {

constexpr int BK = 32;             // k of a quant block
constexpr int THREADS = 256;

__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const void* p, bool trans) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  if (trans)
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
  else
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x2(uint32_t r[2], const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1]) : "r"(a));
}

// d += a · b on the tensor cores: m16n8k16, bf16 inputs, f32 accumulate
__device__ __forceinline__ void mma_bf16(float d[4], const uint32_t a[4], const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ __nv_bfloat162 as_bf162(uint32_t v) {
  return *reinterpret_cast<const __nv_bfloat162*>(&v);
}

__device__ __forceinline__ uint32_t hmul2_u32(uint32_t a, uint32_t b) {
  return as_u32(__hmul2(as_bf162(a), as_bf162(b)));
}

// A column's (or a column pair's) f32 block scales as duplicated bf16 pairs
__device__ __forceinline__ uint32_t bf16_dup(float s) {
  const __nv_bfloat16 h = __float2bfloat16_rn(s);
  return as_u32(__halves2bfloat162(h, h));
}

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
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

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
// DRAM reads twice as long as with 64 bytes); NATIVE, the [K, N/2] carrier
// packed along N: 128 k rows of the strip's 128 bytes (16 KB, 128 k) — their
// block scales (S_ES-byte elements, [SB][256]; [N, K]: [256][SB]) and the x
// rows (bf16 [16][SK], chunk c of row r at c ^ (r & 7)): the ldmatrix reads
// are free of bank conflicts.  [K, N] keeps 3 slots, [N, K] 2 (two CTAs an SM
// either way).  After the loop the ring holds the CTA's f32 sums (the finish
// tile, [DC_MT][DC_BN]).
template <bool PACKED, bool TRANS, int S_ES = 4, bool NATIVE = false>
struct Dc {
  static_assert(!NATIVE || (PACKED && !TRANS), "the native carrier is a packed [K, N/2]");
  static constexpr int ROW = TRANS ? 128 : NATIVE ? DC_BN / 2 : DC_BN;   // bytes of a tile row
  static constexpr int ROWS = TRANS ? DC_BN : NATIVE ? 128 : 64;          // weight tile rows
  static constexpr int SB = (TRANS ? 2 : 1) * (PACKED ? 4 : 2);   // 32-k blocks a stage
  static constexpr int SK = SB * BK;                  // k a stage
  static constexpr int W_BYTES = ROW * ROWS;
  static constexpr int S_BYTES = SB * DC_BN * S_ES;
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
                  DC_MT * DC_BN * 4 <= Dc<false, false>::SMEM &&
                  DC_MT * DC_BN * 4 <= Dc<true, false, 2>::SMEM,
              "the finish: a thread a column, the tile in the ring");

// A thread's share of every ring stage of its split, stage after stage:
// the raw weight bytes of columns n0 .. n0+255, their block scales and x
// rows 0 .. 8·NT - 1, zero-filled past M, N and the split's last block.  A
// thread copies the same chunks of every stage, so their shared offsets and
// column predicates are set up once and its global pointers advance by a
// constant a stage.  One cp.async group a stage, committed by the caller.
// The probes' variants: ST, the scale type (bf16 scales: 8 a copy); XH, x
// given as its block halves x_lo / x_hi [M, K/2] (k 0-15 and 16-31 of each
// block), staged as the rows of x; NATIVE, the [K, N/2] carrier; WV < 16,
// weight copies of WV bytes, for [K, N] rows whose byte stride is not a
// multiple of 16; XS = false, no x rows (the weight stream alone).
template <int NT, bool PACKED, bool CHANNEL, bool TRANS, typename ST = float, bool XH = false,
          bool NATIVE = false, int WV = 16, bool XS = true>
struct DcLoader {
  using C = Dc<PACKED, TRANS, (int)sizeof(ST), NATIVE>;
  static_assert(WV == 16 || !TRANS, "narrow weight copies: [K, N] layouts only");
  static constexpr int W_ITERS = C::W_BYTES / 16 / THREADS;         // weight chunks, 4096 B apart
  static constexpr int W_CH = C::ROW / 16;                           // chunks of a tile row
  static constexpr int W_PIECES = 16 / WV;                           // copies of a chunk
  // [N, K]: the L2 fetches 256 bytes around each read of a row, the next
  // stage's bytes too (measured with 64-byte stages on the H100: w13 Q8_0
  // 15 % faster; [K, N] reads 256-byte rows already and gained nothing)
  static constexpr bool L2_256 = TRANS;
  static constexpr int S_ES = sizeof(ST);
  static constexpr int S_PER = 16 / S_ES;                            // scales of a copy
  static constexpr int XCH = C::SK / 8;                              // chunks of an x row
  static constexpr int X_ITERS = (8 * NT * XCH + THREADS - 1) / THREADS;
  static constexpr int X_RSTEP = THREADS / XCH;                      // x rows between them
  static constexpr int X_ADV = XH ? C::SK / 2 : C::SK;               // x elements a stage
  const int8_t* w0;          // a valid address for the chunks that read nothing
  const ST* s0;
  const __nv_bfloat16* x0;
  const int8_t* wp;          // the thread's first weight chunk of the next stage
  size_t w_step, w_adv;      // bytes between its chunks of a stage; a stage's advance
  const ST* sp;              // its scale copy of the next stage
  size_t s_adv;
  const __nv_bfloat16* xp;   // its first x chunk of the next stage
  size_t x_step;             // elements between its x chunks
  uint32_t w_sm, s_sm, x_sm; // shared offsets within a stage
  int w_blk, s_blk, x_blk;   // blocks of the chunks within a stage
  int left;                  // blocks of the split from the next stage on
  bool w_ok[W_ITERS], s_on, s_ok, s_vec, x_ok[X_ITERS];
  bool w_okp[W_PIECES];      // WV < 16: the pieces of a chunk inside its row

  __device__ __forceinline__ DcLoader(const __nv_bfloat16* x, const int8_t* w, const ST* s,
                                      int M, int N, int K, int n0, int kb_begin, int kb_end,
                                      const __nv_bfloat16* x_hi = nullptr)
      : w0(w), s0(s), x0(x) {
    const int tid = threadIdx.x, nb = K / BK;
    left = kb_end - kb_begin;
    const int r = tid / W_CH, c = tid % W_CH;  // tile row r + (THREADS / W_CH)·j, chunk c
    w_sm = r * C::ROW + ((c ^ (r & 7)) << 4);
    if constexpr (!TRANS) {                    // byte rows of the k range, the strip's bytes
      const int rows = PACKED && !NATIVE ? BK / 2 : BK;   // byte rows of a block
      const int rb = NATIVE ? N / 2 : N;       // bytes of a row
      wp = w + ((size_t)kb_begin * rows + r) * rb + (NATIVE ? n0 / 2 : n0) + c * 16;
      w_step = (size_t)(THREADS / W_CH) * rb;
      w_adv = (size_t)C::ROWS * rb;
      w_blk = 0;
#pragma unroll
      for (int j = 0; j < W_ITERS; ++j) w_ok[j] = (NATIVE ? n0 / 2 : n0) + c * 16 < rb;
      if constexpr (WV < 16) {
#pragma unroll
        for (int p = 0; p < W_PIECES; ++p) w_okp[p] = (NATIVE ? n0 / 2 : n0) + c * 16 + p * WV < rb;
      }
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
      } else {                                 // [K/32, N] → [SB][256], S_PER scales a copy
        const int b = tid / (DC_BN / S_PER), c = tid % (DC_BN / S_PER);
        sp = s + (size_t)(kb_begin + b) * N + n0 + c * S_PER;
        s_adv = (size_t)C::SB * N;
        s_sm = (b * DC_BN + c * S_PER) * S_ES;
        s_blk = b;
        s_on = tid < C::SB * DC_BN / S_PER;
        s_ok = n0 + c * S_PER < N;
      }
    }
    const int xr = tid / XCH, xc = tid % XCH;  // x row xr + X_RSTEP·j, chunk xc
    if constexpr (!XS) {
      return;
    } else if constexpr (XH) {                 // chunk xc: block xc / 4, k 8·(xc % 4) .. +7
      xp = ((xc & 2) ? x_hi : x) + (size_t)xr * (K / 2) + (size_t)(kb_begin + xc / 4) * (BK / 2) +
           (xc & 1) * 8;
      x_step = (size_t)X_RSTEP * (K / 2);
    } else {
      xp = x + (size_t)xr * K + (size_t)kb_begin * BK + xc * 8;
      x_step = (size_t)X_RSTEP * K;
    }
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
      if constexpr (WV == 16) {
        const bool ok = w_ok[j] && blk < left;
        cp_async_s<16, L2_256>(st + w_sm + j * 4096, ok ? wp + j * w_step : w0, ok);
      } else {
#pragma unroll
        for (int p = 0; p < W_PIECES; ++p) {
          const bool ok = w_okp[p] && blk < left;
          cp_async_s<WV>(st + w_sm + j * 4096 + p * WV, ok ? wp + j * w_step + p * WV : w0, ok);
        }
      }
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
    if constexpr (XS) {
#pragma unroll
      for (int j = 0; j < X_ITERS; ++j) {     // rows 0 .. 8·NT - 1 (zeros past M)
        if (X_ITERS > 1 || (int)threadIdx.x < 8 * NT * XCH) {
          const bool ok = x_ok[j] && x_blk < left;
          cp_async_s<16>(st + C::W_BYTES + C::S_BYTES + x_sm + j * X_RSTEP * C::X_ROW,
                         ok ? xp + j * x_step : x0, ok);
        }
      }
    }
    wp += w_adv;
    if constexpr (XS) xp += X_ADV;
    left -= C::SB;
  }
};

// The ring: loads run C::STAGES - 1 stages ahead, one barrier a stage, and
// compute(stage) runs on each of the split's n_st stages in turn.
template <class C, class Loader, class Compute>
__device__ __forceinline__ void dc_ring(Loader& loader, int n_st, unsigned char* smem,
                                        Compute&& compute) {
  const uint32_t ring = smem_u32(smem);
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
    compute(smem + (t % C::STAGES) * C::STAGE);
  }
  cp_async_wait<0>();
}

// The ring becomes the finish tile: acc[t][nt][e] is token 8·nt + 2·tig +
// (e & 1) of column col[t] (e < 2) or col[t] + dcol (e >= 2).  T: float
// sums, or the int8-x kernel's int32 ones.
template <int NT, typename T>
__device__ __forceinline__ void dc_tile_store(T* tile, const T (&acc)[2][NT][4],
                                              const int (&col)[2], int dcol, int tig) {
  __syncthreads();                             // every warp is done with the ring
#pragma unroll
  for (int t = 0; t < 2; ++t)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      T* row = tile + (8 * nt + 2 * tig) * DC_BN;
      const int c = col[t], c2 = c + dcol;
      row[c] = acc[t][nt][0];
      row[DC_BN + c] = acc[t][nt][1];
      row[c2] = acc[t][nt][2];
      row[DC_BN + c2] = acc[t][nt][3];
    }
  __syncthreads();
}

// Four sums of a finish tile: float4 (f32 sums) or int4 (int32 sums, added
// as unsigned: the wrap of the TPU's int32 accumulator, in any order)
template <typename T> struct Vec4 { using type = float4; };
template <> struct Vec4<int> { using type = int4; };
__device__ __forceinline__ void add4(float4& a, const float4& b) {
  a.x += b.x;
  a.y += b.y;
  a.z += b.z;
  a.w += b.w;
}
__device__ __forceinline__ int wrap_add(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
}
__device__ __forceinline__ void add4(int4& a, const int4& b) {
  a.x = wrap_add(a.x, b.x);
  a.y = wrap_add(a.y, b.y);
  a.z = wrap_add(a.z, b.z);
  a.w = wrap_add(a.w, b.w);
}

// With a split, the CTA's sums of columns n0 .. n0+255 (tile, row m at
// m·DC_BN, in shared memory) through the split partials [splits, M, N] and
// the strip's counter: false in every CTA but the strip's last, whose tile
// then holds the sums of all splits.  The partials move as float4s / int4s
// (a thread 4 columns of a row; N % 4 == 0); one thread fences the CTA's
// partial (ordered by the barrier) and takes the ticket; the strip's last
// CTA issues every partial load of a thread (up to DC_ZLOADS) before it sums
// them in split order, so the finish costs a few L2 round trips, not one a
// row and split, and gives the same bits every call.
template <int NT, typename T = float>
__device__ __forceinline__ bool dc_sum_splits(T* tile, T* partial, int* counters, int M,
                                              int N, int splits) {
  using V = typename Vec4<T>::type;
  constexpr int P = (8 * NT * DC_BN / 4 + THREADS - 1) / THREADS;  // vectors a thread
  constexpr int ZB = (DC_ZLOADS + P - 1) / P;                      // splits a round
  __shared__ int last;
  const int tid = threadIdx.x, strip = blockIdx.x, n0 = strip * DC_BN;
  if (splits > 1) {
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int i = tid + p * THREADS, m = i / (DC_BN / 4), c = i % (DC_BN / 4) * 4;
      if (m < M && n0 + c < N)                 // N % 4 == 0: all 4 columns or none
        *reinterpret_cast<V*>(partial + ((size_t)blockIdx.y * M + m) * N + n0 + c) =
            *reinterpret_cast<const V*>(tile + m * DC_BN + c);
    }
    __syncthreads();
    if (tid == 0) {
      __threadfence();                         // the CTA's partial before its ticket
      last = atomicAdd(counters + strip, 1) == splits - 1;
      if (last) counters[strip] = 0;           // every split has taken its ticket
      __threadfence();
    }
    __syncthreads();
    if (!last) return false;
    const size_t zs = (size_t)M * N;           // a split's stride
    V v[P];
    bool ok[P];
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int i = tid + p * THREADS, m = i / (DC_BN / 4), c = i % (DC_BN / 4) * 4;
      v[p] = V{};
      ok[p] = m < M && n0 + c < N;
    }
    for (int z0 = 0; z0 < splits; z0 += ZB) {
      V q[ZB][P];
#pragma unroll
      for (int j = 0; j < ZB; ++j)
#pragma unroll
        for (int p = 0; p < P; ++p) {
          const int i = tid + p * THREADS, m = i / (DC_BN / 4), c = i % (DC_BN / 4) * 4;
          if (ok[p] && z0 + j < splits)
            q[j][p] = __ldcg(reinterpret_cast<const V*>(partial + (z0 + j) * zs +
                                                        (size_t)m * N + n0 + c));
        }
#pragma unroll
      for (int j = 0; j < ZB; ++j)             // in split order: the same bits every call
#pragma unroll
        for (int p = 0; p < P; ++p)
          if (ok[p] && z0 + j < splits) add4(v[p], q[j][p]);
    }
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int i = tid + p * THREADS, m = i / (DC_BN / 4), c = i % (DC_BN / 4) * 4;
      if (ok[p]) *reinterpret_cast<V*>(tile + m * DC_BN + c) = v[p];
    }
    __syncthreads();
  }
  return true;
}

// ---------------------------------------------------------------------------
// The int8-x decode ring (qmatmul_int8dot.cu qmm_i8_decode_kernel, and the
// W4A8 probes' k_int8 in int4_probe.cu): [K, N] int8, [N, K] int8 or packed
// [K/2, N] weights and int8 x
// ---------------------------------------------------------------------------

constexpr int W_KN = 0, W_NK = 1, W_PACKED_KN = 2;

// One ring stage: the raw weight bytes — [K, N]: 64 k rows × the strip's 256
// bytes (16 KB, 64 k; chunk c of row r at c ^ kn_swz(r)); packed [K/2, N]:
// 64 byte rows × 256 (16 KB, 128 k); [N, K]: 128 bytes of each of the
// strip's 256 rows (32 KB, 128 k; chunk c at c ^ (n & 7)) — then the x rows
// (int8 [16][SK], chunk c of row r at c ^ x_swz(r)).  [K, N] keeps 3 slots,
// [N, K] 2 (two CTAs an SM either way), as the float decode GEMM.
template <int WL>
struct I8Dc {
  static constexpr bool NK = WL == W_NK, PK = WL == W_PACKED_KN;
  static constexpr int ROW = NK ? 128 : DC_BN;          // bytes of a weight tile row
  static constexpr int ROWS = NK ? DC_BN : 64;          // weight tile rows
  static constexpr int SB = NK || PK ? 4 : 2;           // 32-k blocks a stage
  static constexpr int SK = SB * BK;                    // k a stage
  static constexpr int W_BYTES = ROW * ROWS;
  static constexpr int XCH = SK / 16;                   // 16-byte chunks of an x row
  static constexpr int STAGE = W_BYTES + DC_MT * SK;
  static constexpr int STAGES = NK ? 2 : 3;
  static constexpr int SMEM = STAGES * STAGE;
};
static_assert(DC_CTAS_PER_SM * (I8Dc<W_NK>::SMEM + 1024 + 128) <= 233472 &&
                  DC_CTAS_PER_SM * (I8Dc<W_PACKED_KN>::SMEM + 1024 + 128) <= 233472 &&
                  DC_MT * DC_BN * 4 <= I8Dc<W_KN>::SMEM,
              "two int8 decode CTAs an SM; the finish tile in the ring");

// the x tile's swizzle: 8 chunks a row (128 k) at c ^ (r & 7), 4 (64 k) at
// c ^ ((r >> 1) & 3): an ldmatrix of 8 rows reads 8 distinct bank groups
template <int XCH>
__device__ __forceinline__ int x_swz(int r) {
  return XCH == 8 ? (r & 7) : ((r >> 1) & 3);
}

// A thread's share of every ring stage of its split, stage after stage: the
// same chunks each time, zero-filled past M, N and the split's k range
// (k_lim: the split's end, or K); one cp.async group a stage, committed by
// the caller.  The W4A8 probes' variants: XH, x given as its block halves
// x_lo / x_hi [M, K/2] (k 0-15 and 16-31 of each block), staged as the rows
// of x; WV < 16, weight copies of WV bytes for [K, N] / packed rows whose
// byte stride is not a multiple of 16.
template <int WL, bool XH = false, int WV = 16>
struct I8Loader {
  using C = I8Dc<WL>;
  static_assert(WV == 16 || !C::NK, "narrow weight copies: [K, N] layouts only");
  static constexpr int W_CH = C::ROW / 16;               // chunks of a tile row
  static constexpr int W_RSTEP = THREADS / W_CH;         // tile rows between a thread's chunks
  static constexpr int W_ITERS = C::ROWS / W_RSTEP;
  static constexpr int W_PIECES = 16 / WV;               // copies of a chunk
  const int8_t* w0;
  const int8_t* x0;
  const int8_t* wp;          // the thread's first weight chunk of the next stage
  const int8_t* xp;          // its x chunk of the next stage (x_on)
  size_t w_step, w_adv;      // bytes between its chunks of a stage; a stage's advance
  uint32_t w_sm, x_sm;       // shared offsets within a stage
  int wpos, wlim;            // [K, N] / packed: the k (byte) row of its first chunk and the
                             // split's end; [N, K]: the k of its chunks and k_lim
  int xk, klim;              // the k of its x chunk, k_lim
  bool w_ok[W_ITERS], x_on, x_ok;
  bool w_okp[W_PIECES];      // WV < 16: the pieces of a chunk inside its row

  __device__ __forceinline__ I8Loader(const int8_t* x, const int8_t* w, int M, int N, int K,
                                      int n0, int kb_begin, int kb_end,
                                      const int8_t* x_hi = nullptr)
      : w0(w), x0(x) {
    const int tid = threadIdx.x;
    klim = min(K, kb_end * BK);
    const int r = tid / W_CH, c = tid % W_CH;  // tile row r + W_RSTEP·j, chunk c
    if constexpr (C::NK) {
      wp = w + (size_t)(n0 + r) * K + (size_t)kb_begin * BK + c * 16;
      w_step = (size_t)W_RSTEP * K;
      w_adv = C::ROW;
      w_sm = r * C::ROW + ((c ^ (r & 7)) << 4);
      wpos = kb_begin * BK + c * 16;
      wlim = klim;
#pragma unroll
      for (int j = 0; j < W_ITERS; ++j) w_ok[j] = n0 + r + W_RSTEP * j < N;
    } else {                                   // k (byte) rows, the strip's 256 bytes
      const int rows_blk = C::PK ? BK / 2 : BK;
      wp = w + ((size_t)kb_begin * rows_blk + r) * N + n0 + c * 16;
      w_step = (size_t)W_RSTEP * N;
      w_adv = (size_t)C::ROWS * N;
      w_sm = r * C::ROW + ((c ^ kn_swz(r)) << 4);
      wpos = kb_begin * rows_blk + r;
      wlim = C::PK ? kb_end * rows_blk : klim;
#pragma unroll
      for (int j = 0; j < W_ITERS; ++j) w_ok[j] = n0 + c * 16 < N;
      if constexpr (WV < 16) {
#pragma unroll
        for (int p = 0; p < W_PIECES; ++p) w_okp[p] = n0 + c * 16 + p * WV < N;
      }
    }
    const int xr = tid / C::XCH, xc = tid % C::XCH;
    x_on = tid < DC_MT * C::XCH;
    x_ok = x_on && xr < M;
    if constexpr (XH)                          // chunk xc: block xc / 2, half xc % 2
      xp = ((xc & 1) ? x_hi : x) + (size_t)xr * (K / 2) + (size_t)(kb_begin + xc / 2) * (BK / 2);
    else
      xp = x + (size_t)xr * K + (size_t)kb_begin * BK + xc * 16;
    xk = kb_begin * BK + xc * 16;
    x_sm = C::W_BYTES + xr * C::SK + ((xc ^ x_swz<C::XCH>(xr)) << 4);
  }

  __device__ __forceinline__ void load(uint32_t st) {
#pragma unroll
    for (int j = 0; j < W_ITERS; ++j) {
      if constexpr (WV == 16) {
        const bool ok = w_ok[j] && (C::NK ? wpos : wpos + W_RSTEP * j) < wlim;
        cp_async_s<16, C::NK>(st + w_sm + j * (W_RSTEP * C::ROW), ok ? wp + j * w_step : w0, ok);
      } else {
#pragma unroll
        for (int p = 0; p < W_PIECES; ++p) {
          const bool ok = w_okp[p] && wpos + W_RSTEP * j < wlim;
          cp_async_s<WV>(st + w_sm + j * (W_RSTEP * C::ROW) + p * WV,
                         ok ? wp + j * w_step + p * WV : w0, ok);
        }
      }
    }
    if (x_on) {
      const bool ok = x_ok && xk < klim;
      cp_async_s<16>(st + x_sm, ok ? xp : x0, ok);
    }
    wp += w_adv;
    wpos += C::NK ? C::SK : C::ROWS;
    xp += XH ? C::SK / 2 : C::SK;
    xk += C::SK;
  }
};

}  // namespace
