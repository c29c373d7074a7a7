// Attention kernels for Hopper (sm_90a) over an int8 (or bf16) KV cache.
//
// decode_attention_launch — replaces csinn2_tpu/kernels/flash_attention.py
//   decode_attention → _decode_attn_kernel: one query per (row, query head)
//   over the row's KV window [0, kv_len).  Bound: the K/V bytes, read once
//   (25.3 MB of int8 KV at the 7B decode shape: 0.0076 ms).  A split-KV
//   decode on the CUDA cores (decode_attn_kernel): one CTA per (chunk of
//   keys, KV head, row), so the longest row's bytes stream on every SM and
//   a chunk past kv_len returns at once; the GQA group's query heads share
//   each K/V row the CTA reads.  All the chunk's K and V rows are requested
//   at once by cp.async through the cache's strides into shared memory
//   (32 KB a CTA at the 7B shape), so the whole byte stream is in flight
//   before any is used.  Within a chunk the max and the sum are exact (two
//   passes over the chunk's scores in shared memory, as the JAX body takes
//   them over the whole window); attn_combine_kernel merges the chunks'
//   (max, sum, output).  Any d <=
//   256: 16-, 8-, 4-byte or element loads by the rows' alignment.
//
// attention_fwd_launch — replaces prefill_attention → _prefill_attn_kernel
//   and flash_attention (bshd and bhsd) → _attn_kernel: causal (or not)
//   attention with per-row q_offset / kv_len and the GQA head map
//   h / (hq / hk), on the tensor cores.  The m rows of a CTA are
//   (query, head of the KV head's group) pairs, so GQA heads share each
//   K/V tile.  Two bounds, by shape:
//   - prefill (sq·group > 64): the QK and PV products, 4·sq·S·d per head
//     (halved by causality), 34.4 GFLOP at 7B sq = 2048: 0.035 ms at the
//     bf16 peak.  FlashAttention-2 on mma.sync m16n8k16 (bf16 in, f32
//     sums), as the JAX body runs bf16 dots on the MXU: a warp owns 16
//     query rows, a CTA up to 8 warps (fewer where the card would not
//     fill), K/V tiles of 64 keys (32 at d = 256) in a two-stage cp.async
//     ring, so the next tile loads under this tile's products.  Q is
//     rounded to bf16 as it is staged (the JAX q.astype(bf16)); Q·Kᵀ reads
//     Q and K with ldmatrix, P is rounded to bf16 in registers and is P·V's
//     A operand as it stands (the JAX p.astype(bf16)), V comes through
//     ldmatrix.trans; exp2 runs on the SFU.  int8 K/V land raw and are
//     widened to bf16 in shared memory once per CTA (exact), so 128 query
//     rows share each widening and two 8-warp CTAs (128 registers a
//     thread) share an SM; kv_scale folds into qk_scale and out_scale.
//     Causal: tiles past the CTA's last position are never loaded, only the
//     diagonal tiles are masked, and the CTAs with the most tiles start
//     first.  What holds it back: each K/V fragment feeds one 16-row product
//     from registers (mma.sync, not wgmma's shared-memory operands), and
//     the int8 widening costs a pass and a barrier per tile.
//   - flash decode (sq·group <= 64): the K/V bytes, 25.3 MB of int8 KV at
//     the 7B decode shape (0.0076 ms).  The GQA group's queries × sq are
//     the m rows of one CTA (16 a warp, zero-padded, Q in registers); the
//     KV window is split into chunks of `chunk` keys, one CTA per (chunk,
//     KV head, row), so the bytes stream on every SM and a chunk past
//     kv_len returns at once.  The warps a CTA has beyond its row groups
//     take key slices of each tile (their partials merge through shared
//     memory), each CTA writes its (max, sum, unnormalised output) to f32
//     scratch, and attn_combine_kernel merges the chunks of each row.
//   Any d <= 256: d pads to 64, 128 or 256 as the JAX kernels pad to 128;
//   the dims past d are zero in shared memory, not in a copy of the cache.
//   K/V rows load 16, 8 or 4 bytes at a time (`vec`, the widest width the
//   rows and strides allow), element by element where none does.
//
// attention_wide_launch — the same three functions at d > 256
//   (decode_attention → _decode_attn_kernel, prefill_attention →
//   _prefill_attn_kernel, flash_attention → _attn_kernel, which pad d to a
//   multiple of 128 with no cap), on the tensor cores (attn_wide_mma_kernel).
//   Bounds as above: the K/V bytes at decode (15.8 MB of int8 KV at b = 4,
//   GQA 32/8, S = 2048, d = 320: 0.0047 ms) and at short prefill, where q
//   and out weigh as much as the products (sq = S = 512: 23.6 MB, 0.0070
//   ms, against 5.4 GFLOP, 0.0054 ms), the products at long prefill.  What
//   stops the d <= 256 kernel is O: a warp holding 16 rows × d in registers
//   (160 f32 a thread at d = 320).  So a CTA takes 64 m rows (one wgmma m64
//   tile) and splits O over up to 3 warpgroups of 128 columns (64 f32 a
//   thread), and over CTAs past 384 columns, each CTA recomputing S.  Both
//   products run on wgmma with their operands in shared memory, which read
//   a 64-row tile's operands once where mma.sync reads them for each 16
//   rows: S = Q·Kᵀ over two warpgroups of 32 keys, whose row maxima meet in
//   shared memory, P as bf16 in a swizzled tile, P·V with V MN-major.  The
//   copy engine brings K/V tiles by tensor map where rows are 16-byte
//   aligned (bf16 straight into wgmma's swizzle), cp.async elsewhere, the
//   next tile while S runs; int8 widens once per CTA.  Where the unsplit
//   grid is far under the SMs (the decode, a short sq·group, absorbed
//   MLA's 128 heads on one latent head), the KV window splits over CTAs
//   (one per chunk, column slice, KV head, row; the grid nearest 2 CTAs an
//   SM) so its bytes stream on every SM, merged by attn_combine_kernel.  Where Q and whole K rows
//   outgrow shared memory, Q·Kᵀ streams blocks of dims through the ring, so
//   no d is refused for its tiles (notes at the kernel).
//
// A row whose softmax denominator is 0 (kv_len == 0, or every key masked)
// outputs 0, never NaN.  K/V are read through (batch, head, seq) strides
// with a contiguous last dim, so the cache's [b, S, hk, d] layout is
// consumed in place (no transpose).  q and out are bf16, f16 or f32
// (dtype codes DT_*); out is written from the f32 sums in its own dtype.
#include <cuda.h>   // CUtensorMap; the encoder comes through the runtime
#include <cuda_fp16.h>

#include "common.cuh"

namespace {

constexpr float LOG2E = 1.4426950408889634f;

enum : int { DT_BF16 = 0, DT_F16 = 1, DT_F32 = 2 };

// q element i rounded to bf16, as the JAX bodies' q.astype(bfloat16)
__device__ __forceinline__ __nv_bfloat16 load_q_bf16(const void* p, long long i, int dt) {
  if (dt == DT_F32) return __float2bfloat16_rn(static_cast<const float*>(p)[i]);
  if (dt == DT_F16) return __float2bfloat16_rn(__half2float(static_cast<const __half*>(p)[i]));
  return static_cast<const __nv_bfloat16*>(p)[i];
}

__device__ __forceinline__ void store_dt(void* p, long long i, int dt, float v) {
  if (dt == DT_F32)
    static_cast<float*>(p)[i] = v;
  else if (dt == DT_F16)
    static_cast<__half*>(p)[i] = __float2half_rn(v);
  else
    static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16_rn(v);
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

// ---------------------------------------------------------------------------
// attn_fwd_kernel: tensor-core flash attention (prefill and split-KV decode)
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const void* p, bool trans) {
  const uint32_t a = smem_u32(p);
  if (trans)
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
  else
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

// d += a · b on the tensor cores: m16n8k16, bf16 inputs, f32 accumulate
__device__ __forceinline__ void mma_bf16(float d[4], const uint32_t a[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf162(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// BYTES from global to shared, asynchronously; ok == false fills zeros and
// reads nothing
template <int BYTES>
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src, bool ok) {
  const int n = ok ? BYTES : 0;
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(n));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(dst), "l"(src),
                 "n"(BYTES), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// four int8 (one word) → two bf16 pairs, exact: byte x + 128 is the low
// mantissa byte of the f32 2^23 + x + 128 (no I2F, 16 results/clk/SM)
__device__ __forceinline__ void i8x4_to_bf16(uint32_t w, uint32_t& lo, uint32_t& hi) {
  const uint32_t u = w ^ 0x80808080u;
  const float base = 8388736.f;  // 2^23 + 128
  const float f0 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540)) - base;
  const float f1 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7541)) - base;
  const float f2 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7542)) - base;
  const float f3 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7543)) - base;
  lo = pack_bf162(f0, f1);
  hi = pack_bf162(f2, f3);
}

template <typename T>
__device__ __forceinline__ T kv_zero();
template <>
__device__ __forceinline__ int8_t kv_zero<int8_t>() { return 0; }
template <>
__device__ __forceinline__ __nv_bfloat16 kv_zero<__nv_bfloat16>() {
  return __float2bfloat16_rn(0.f);
}

constexpr int FWD_MAX_WARPS = 8;
constexpr int NSTAGE = 2;   // K/V tiles in flight + 1

// 2^x on the SFU, subnormal results flushed (p below 2^-126 of the row max
// adds nothing to an f32 sum); -inf gives 0
__device__ __forceinline__ float fexp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <int DP, typename KV, bool SLICED>
struct Fwd {
  static constexpr int BKV = DP == 256 ? 32 : 64;  // keys per tile
  static constexpr bool I8 = sizeof(KV) == 1;
  // Q fragments in registers for the few-row (key-sliced) launches; the
  // long prefill reads them from shared memory, so that two CTAs of 8 warps
  // fit an SM's registers
  static constexpr bool Q_REGS = DP <= 128 && SLICED;
  // key slices come with at most 4 warps (rw·kw <= 4); CTAs per SM that
  // the shared memory allows, so registers do not allow fewer (int8 at
  // d <= 128: 3 sliced CTAs of 67 KB, 2 prefill CTAs of 102 KB)
  static constexpr int MAX_THREADS = SLICED ? 128 : 32 * FWD_MAX_WARPS;
  static constexpr int MIN_CTAS = DP > 128 ? 1 : !SLICED ? 2 : I8 ? 3 : 1;
  static constexpr int KS = DP / 16;               // k-steps of Q·Kᵀ
  static constexpr int NT = BKV / 8;               // 8-key n-tiles of S
  static constexpr int DT = DP / 8;                // 8-dim n-tiles of O
  static constexpr int ROW = DP + 8;               // bf16 per smem row: conflict-free ldmatrix
  static constexpr int RAW_ROW = I8 ? DP : ROW * 2;  // bytes per row of the load ring
  static constexpr int RAW_TILE = BKV * RAW_ROW;     // bytes of one K or V tile as loaded
  static constexpr int BF_TILE = BKV * ROW * 2;      // bytes of a widened bf16 tile
  static constexpr int MERGE = DT * 4 + 4;           // floats a lane hands over per warp
  static constexpr int TILES = NSTAGE * 2 * RAW_TILE + (I8 ? 2 * BF_TILE : 0);
  // Q (16·rw rows) lives where the last tiles go (the widened tiles, or the
  // last ring stage) until its fragments are in registers; otherwise it
  // stays in shared memory past the tiles
  static constexpr size_t smem(int rw) {
    return size_t(TILES) + (Q_REGS ? 0 : size_t(16) * rw * ROW * 2);
  }
  static_assert(!Q_REGS || 16 * FWD_MAX_WARPS * ROW * 2 <= 2 * BF_TILE, "Q must fit the alias");
  static_assert(3 * 32 * MERGE * 4 <= TILES, "the merge must fit the tiles");
};

// The warps of a CTA: rw row groups of 16 query rows × kw key slices.  Row
// group w % rw owns m rows m0 + 16·(w % rw) ...; with SLICED, slice w / rw
// takes the n-tiles [slice·NT/kw, (slice+1)·NT/kw) of every K/V tile, and
// the slices' (max, sum, output) merge at the end (kw = 1 without).
template <int DP, typename KV, bool SLICED>
__global__ void __launch_bounds__((Fwd<DP, KV, SLICED>::MAX_THREADS),
                                  (Fwd<DP, KV, SLICED>::MIN_CTAS))
attn_fwd_kernel(const void* __restrict__ q, int q_dt, long long q_sb, long long q_ss,
                long long q_sh, const KV* __restrict__ k, long long k_sb, long long k_sh,
                long long k_ss, const KV* __restrict__ v, long long v_sb, long long v_sh,
                long long v_ss, const int* __restrict__ q_offset, int off0,
                const int* __restrict__ kv_len, int len0, void* __restrict__ out, int o_dt,
                long long o_sb, long long o_ss, long long o_sh, float* __restrict__ part_ml,
                float* __restrict__ part_acc, int sq, int hq, int hk, int S, int d, int causal,
                int vec, int rw, int chunk, int n_chunks, float qk_scale, float out_scale) {
  using C = Fwd<DP, KV, SLICED>;
  constexpr int BKV = C::BKV, ROW = C::ROW, NT = C::NT;
  extern __shared__ __align__(16) unsigned char fsm[];
  unsigned char* ring = fsm;                                   // [NSTAGE][K, V][BKV][RAW_ROW]
  __nv_bfloat16* kvb = reinterpret_cast<__nv_bfloat16*>(fsm + NSTAGE * 2 * C::RAW_TILE);
  __nv_bfloat16* Qs = C::Q_REGS
      ? (C::I8 ? kvb
               : reinterpret_cast<__nv_bfloat16*>(ring + (NSTAGE - 1) * 2 * C::RAW_TILE))
      : reinterpret_cast<__nv_bfloat16*>(fsm + C::TILES);     // [16·rw][ROW]

  const int tid = threadIdx.x, nthr = blockDim.x;
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, tq = lane % 4;
  const int kw = SLICED ? nthr / 32 / rw : 1, rwi = warp % rw, slice = warp / rw;
  const int n_lo = slice * (NT / kw), n_hi = n_lo + NT / kw;   // this warp's n-tiles
  const int BM = 16 * rw;
  const int group = hq / hk, MR = sq * group;                  // m rows: (i, head in group)
  const int n_mb = (MR + BM - 1) / BM;
  const int mb = n_mb - 1 - static_cast<int>(blockIdx.x) / n_chunks;  // longest first
  const int ch = blockIdx.x % n_chunks;
  const int hkid = blockIdx.y, bi = blockIdx.z;
  const int m0 = mb * BM;
  const int qoff = q_offset ? q_offset[bi] : off0;
  const int L = max(0, min(kv_len ? kv_len[bi] : len0, S));
  const int i_first = m0 / group, i_last = min(sq - 1, (m0 + BM - 1) / group);
  const int kend = causal ? max(0, min(L, qoff + i_last + 1)) : L;
  const int kbeg = ch * chunk;
  const int kstop = min(kend, kbeg + chunk);
  const bool split = n_chunks > 1;
  // partials of this CTA's rows: ((bi, hkid, ch), row) → [m, l] and [d]
  const long long pbase = ((long long)(bi * hk + hkid) * n_chunks + ch) * MR;

  if (split && kbeg >= kstop) {       // a chunk past this row's window
    for (int r = tid; r < MR; r += nthr) part_ml[(pbase + r) * 2] = -INFINITY;
    return;
  }
  const int n_t = max(0, (kstop - kbeg + BKV - 1) / BKV);

  const KV* kb = k + bi * k_sb + hkid * k_sh;
  const KV* vb = v + bi * v_sb + hkid * v_sh;
  const bool full16 = vec == 16 && d == DP;   // whole rows in 16-byte loads

  // tile t into ring stage t % NSTAGE (nothing past the last tile), as one
  // cp.async group either way
  auto load_tile = [&](int t) {
    const int k0 = kbeg + t * BKV, st = t % NSTAGE;
#pragma unroll
    for (int which = 0; which < 2; ++which) {
      if (t >= n_t) break;
      unsigned char* dst = ring + (st * 2 + which) * C::RAW_TILE;
      const KV* src = which ? vb : kb;
      const long long rs = which ? v_ss : k_ss;
      if (full16) {
        constexpr int CPR = DP * static_cast<int>(sizeof(KV)) / 16;   // loads per row
        for (int idx = tid; idx < BKV * CPR; idx += nthr) {
          const int j = idx / CPR, cc = idx % CPR;
          const bool ok = k0 + j < L;
          cp_async<16>(smem_u32(dst + j * C::RAW_ROW + cc * 16),
                       reinterpret_cast<const char*>(src + (ok ? (k0 + j) * rs : 0)) + cc * 16, ok);
        }
      } else if (vec) {
        const int cpr = d * static_cast<int>(sizeof(KV)) / vec;
        for (int idx = tid; idx < BKV * cpr; idx += nthr) {
          const int j = idx / cpr, cc = idx % cpr;
          const bool ok = k0 + j < L;
          const char* gp = reinterpret_cast<const char*>(src + (ok ? (k0 + j) * rs : 0)) + cc * vec;
          const uint32_t sp = smem_u32(dst + j * C::RAW_ROW + cc * vec);
          if (vec == 16)
            cp_async<16>(sp, gp, ok);
          else if (vec == 8)
            cp_async<8>(sp, gp, ok);
          else
            cp_async<4>(sp, gp, ok);
        }
      } else {        // rows not 4-byte aligned: element by element
        for (int idx = tid; idx < BKV * d; idx += nthr) {
          const int j = idx / d, c = idx % d;
          reinterpret_cast<KV*>(dst + j * C::RAW_ROW)[c] =
              k0 + j < L ? src[(k0 + j) * rs + c] : kv_zero<KV>();
        }
      }
    }
    cp_async_commit();
  };

  // the first NSTAGE - 1 tiles go ahead; the last stage may hold Q for now
#pragma unroll
  for (int t = 0; t < NSTAGE - 1; ++t) load_tile(t);

  // widen the landed int8 K/V tiles of ring stage st to bf16 (exact)
  auto widen = [&](int st) {
    constexpr int CH = DP / 16;                // 16-byte words per raw row
    for (int idx = tid; idx < 2 * BKV * CH; idx += nthr) {
      const int which = idx / (BKV * CH), rem = idx % (BKV * CH);
      const int j = rem / CH, c16 = rem % CH;
      const uint4 w = *reinterpret_cast<const uint4*>(
          ring + (st * 2 + which) * C::RAW_TILE + j * C::RAW_ROW + c16 * 16);
      uint4 a, b;
      i8x4_to_bf16(w.x, a.x, a.y);
      i8x4_to_bf16(w.y, a.z, a.w);
      i8x4_to_bf16(w.z, b.x, b.y);
      i8x4_to_bf16(w.w, b.z, b.w);
      uint4* dst = reinterpret_cast<uint4*>(kvb + which * BKV * ROW + j * ROW + c16 * 16);
      dst[0] = a;
      dst[1] = b;
    }
  };

  // Q rows of this CTA as bf16, zero past d and past the last m row; 8
  // elements a load where q's rows allow
  const int qsz = q_dt == DT_F32 ? 4 : 2;
  const bool qv = ((q_sb | q_ss | q_sh | static_cast<long long>(d)) & 7) == 0 &&
                  reinterpret_cast<uintptr_t>(q) % (8 * qsz) == 0;
  if (qv) {
    for (int idx = tid; idx < BM * (DP / 8); idx += nthr) {
      const int rr = idx / (DP / 8), c = idx % (DP / 8) * 8, r = m0 + rr;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (r < MR && c < d) {
        const long long e = bi * q_sb + (r / group) * q_ss + (hkid * group + r % group) * q_sh + c;
        if (q_dt == DT_BF16) {
          val = *reinterpret_cast<const uint4*>(static_cast<const __nv_bfloat16*>(q) + e);
        } else if (q_dt == DT_F32) {
          const float4 a = *reinterpret_cast<const float4*>(static_cast<const float*>(q) + e);
          const float4 b = *reinterpret_cast<const float4*>(static_cast<const float*>(q) + e + 4);
          val = make_uint4(pack_bf162(a.x, a.y), pack_bf162(a.z, a.w), pack_bf162(b.x, b.y),
                           pack_bf162(b.z, b.w));
        } else {
          const uint4 h = *reinterpret_cast<const uint4*>(static_cast<const __half*>(q) + e);
          const __half2* hp = reinterpret_cast<const __half2*>(&h);
          val = make_uint4(pack_bf162(__low2float(hp[0]), __high2float(hp[0])),
                           pack_bf162(__low2float(hp[1]), __high2float(hp[1])),
                           pack_bf162(__low2float(hp[2]), __high2float(hp[2])),
                           pack_bf162(__low2float(hp[3]), __high2float(hp[3])));
        }
      }
      *reinterpret_cast<uint4*>(Qs + rr * ROW + c) = val;
    }
  } else {
    for (int idx = tid; idx < BM * DP; idx += nthr) {
      const int rr = idx / DP, c = idx % DP, r = m0 + rr;
      __nv_bfloat16 val = __float2bfloat16_rn(0.f);
      if (r < MR && c < d)
        val = load_q_bf16(q, bi * q_sb + (r / group) * q_ss + (hkid * group + r % group) * q_sh + c,
                          q_dt);
      Qs[rr * ROW + c] = val;
    }
  }
  __syncthreads();

  const __nv_bfloat16* Qw = Qs + rwi * 16 * ROW;
  uint32_t qf[C::Q_REGS ? C::KS : 1][4];
  if constexpr (C::Q_REGS) {
#pragma unroll
    for (int ks = 0; ks < C::KS; ++ks)
      ldmatrix_x4(qf[ks], Qw + (lane % 16) * ROW + ks * 16 + (lane / 16) * 8, false);
  }
  if (d < DP) {
    // the dims past d stay zero in every stage (the loads write [0, d)); Q
    // may sit over the last stage, so every warp has its fragments first
    if (C::Q_REGS && !C::I8) __syncthreads();
    const int pad = DP - d;
    for (int idx = tid; idx < NSTAGE * 2 * BKV * pad; idx += nthr)
      reinterpret_cast<KV*>(ring + idx / pad * C::RAW_ROW)[d + idx % pad] = kv_zero<KV>();
  }

  // this thread's two rows: g and g + 8 of its row group's 16
  int qpos[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int r = m0 + rwi * 16 + g + rr * 8;
    qpos[rr] = qoff + min(r / group, sq - 1);
  }
  const float sl = qk_scale * LOG2E;   // scores in log2 units: exp2 below
  float o[C::DT][4];
#pragma unroll
  for (int n = 0; n < C::DT; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float mrow[2] = {-INFINITY, -INFINITY}, lrow[2] = {0.f, 0.f};
  // n-tile n belongs to this warp (always without key slices)
  auto mine = [&](int n) { return !SLICED || (n >= n_lo && n < n_hi); };

  for (int t = 0; t < n_t; ++t) {
    const int st = t % NSTAGE;
    cp_async_wait<NSTAGE - 2>();   // tile t has landed (later ones may be in flight)
    __syncthreads();               // ... for every thread; tile t-1's buffers are free
    load_tile(t + NSTAGE - 1);     // into tile t-1's stage
    const __nv_bfloat16* Kt;
    const __nv_bfloat16* Vt;
    if constexpr (C::I8) {
      widen(st);
      __syncthreads();
      Kt = kvb;
      Vt = kvb + BKV * ROW;
    } else {
      Kt = reinterpret_cast<const __nv_bfloat16*>(ring + (st * 2) * C::RAW_TILE);
      Vt = reinterpret_cast<const __nv_bfloat16*>(ring + (st * 2 + 1) * C::RAW_TILE);
    }

    // S = Q·Kᵀ over this warp's n-tiles: B[k = dim][n = key] is K's row,
    // read without transposing
    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < C::KS; ++ks) {
      uint32_t qa[4];
      if constexpr (C::Q_REGS) {
        qa[0] = qf[ks][0]; qa[1] = qf[ks][1]; qa[2] = qf[ks][2]; qa[3] = qf[ks][3];
      } else {
        ldmatrix_x4(qa, Qw + (lane % 16) * ROW + ks * 16 + (lane / 16) * 8, false);
      }
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        if (!mine(2 * np)) continue;
        uint32_t r[4];
        ldmatrix_x4(r, Kt + (np * 16 + (lane / 16) * 8 + lane % 8) * ROW + ks * 16 +
                           ((lane / 8) % 2) * 8, false);
        mma_bf16(s[2 * np], qa, r[0], r[1]);
        mma_bf16(s[2 * np + 1], qa, r[2], r[3]);
      }
    }

    // online softmax over this warp's keys of the tile (log2 units)
    const int k0 = kbeg + t * BKV;
    const bool need_mask = k0 + BKV > L || (causal && k0 + BKV - 1 > qoff + i_first);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      if (!mine(n)) continue;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int rr = e / 2, key = k0 + n * 8 + 2 * tq + (e % 2);
        float val = s[n][e] * sl;
        if (need_mask && !(key < L && (!causal || key <= qpos[rr]))) val = -INFINITY;
        s[n][e] = val;
        mx[rr] = fmaxf(mx[rr], val);
      }
    }
    float alpha[2], mu[2];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 1));
      mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 2));
      const float m_new = fmaxf(mrow[rr], mx[rr]);
      mu[rr] = m_new == -INFINITY ? 0.f : m_new;   // a row with no key yet: p = 0
      alpha[rr] = fexp2(mrow[rr] - mu[rr]);
      mrow[rr] = m_new;
    }
    float psum[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      if (!mine(n)) continue;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = fexp2(s[n][e] - mu[e / 2]);
        s[n][e] = p;
        psum[e / 2] += p;
      }
    }
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) lrow[rr] = lrow[rr] * alpha[rr] + psum[rr];
#pragma unroll
    for (int n = 0; n < C::DT; ++n) {
      o[n][0] *= alpha[0]; o[n][1] *= alpha[0];
      o[n][2] *= alpha[1]; o[n][3] *= alpha[1];
    }

    // O += P·V: P (bf16) from the S accumulators as the A operand; V through
    // ldmatrix.trans (B[k = key][n = dim] from V's rows)
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {
      if (!mine(2 * kk)) continue;
      const uint32_t pa[4] = {pack_bf162(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf162(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf162(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf162(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < C::DT / 2; ++dp) {
        uint32_t r[4];
        ldmatrix_x4(r, Vt + (kk * 16 + ((lane / 8) % 2) * 8 + lane % 8) * ROW + dp * 16 +
                           (lane / 16) * 8, true);
        mma_bf16(o[2 * dp], pa, r[0], r[1]);
        mma_bf16(o[2 * dp + 1], pa, r[2], r[3]);
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    lrow[rr] += __shfl_xor_sync(0xffffffffu, lrow[rr], 1);
    lrow[rr] += __shfl_xor_sync(0xffffffffu, lrow[rr], 2);
  }
  if (SLICED && kw > 1) {
    // slices 1.. hand (m, l, o) to slice 0 of their row group through the
    // tile buffers, element-major so the 32 lanes hit 32 banks
    __syncthreads();   // every warp is done with the tiles
    float* mg = reinterpret_cast<float*>(fsm);
    if (slice > 0) {
      float* w = mg + ((slice - 1) * rw + rwi) * 32 * C::MERGE + lane;
      w[0] = mrow[0]; w[32] = mrow[1]; w[64] = lrow[0]; w[96] = lrow[1];
#pragma unroll
      for (int n = 0; n < C::DT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) w[(4 + n * 4 + e) * 32] = o[n][e];
    }
    __syncthreads();
    if (slice > 0) return;
    for (int sl2 = 1; sl2 < kw; ++sl2) {
      const float* w = mg + ((sl2 - 1) * rw + rwi) * 32 * C::MERGE + lane;
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const float m2 = w[rr * 32], l2 = w[(2 + rr) * 32];
        const float M = fmaxf(mrow[rr], m2);
        const float mm = M == -INFINITY ? 0.f : M;
        const float a1 = fexp2(mrow[rr] - mm), a2 = fexp2(m2 - mm);
        lrow[rr] = lrow[rr] * a1 + l2 * a2;
        mrow[rr] = M;
#pragma unroll
        for (int n = 0; n < C::DT; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            o[n][rr * 2 + e] = o[n][rr * 2 + e] * a1 + w[(4 + n * 4 + rr * 2 + e) * 32] * a2;
      }
    }
  }

#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int r = m0 + rwi * 16 + g + rr * 8;
    if (r >= MR) continue;
    if (split) {
      const long long pr = pbase + r;
      if (tq == 0) {
        part_ml[pr * 2] = mrow[rr];
        part_ml[pr * 2 + 1] = lrow[rr];
      }
#pragma unroll
      for (int n = 0; n < C::DT; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = n * 8 + 2 * tq + e;
          if (c < d) part_acc[pr * d + c] = o[n][rr * 2 + e];
        }
    } else {
      const int i = r / group, h = hkid * group + r % group;
      const long long ob = bi * o_sb + i * o_ss + h * o_sh;
      const float f = lrow[rr] > 0.f ? out_scale / lrow[rr] : 0.f;
#pragma unroll
      for (int n = 0; n < C::DT; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = n * 8 + 2 * tq + e;
          if (c < d) store_dt(out, ob + c, o_dt, o[n][rr * 2 + e] * f);
        }
    }
  }
}

// Merge the split-KV partials of one m row (a query of one head): chunks
// whose max is -inf saw no key (or never ran) and are skipped.
__global__ void __launch_bounds__(128)
attn_combine_kernel(const float* __restrict__ part_ml, const float* __restrict__ part_acc,
                    void* __restrict__ out, int o_dt, long long o_sb, long long o_ss,
                    long long o_sh, int sq, int hq, int hk, int d, int n_chunks,
                    float out_scale) {
  const int r = blockIdx.x, hkid = blockIdx.y, bi = blockIdx.z;
  const int group = hq / hk, MR = sq * group;
  const long long base = (long long)(bi * hk + hkid) * n_chunks * MR + r;   // chunk c: + c·MR
  float M = -INFINITY;
  for (int c = 0; c < n_chunks; ++c) M = fmaxf(M, part_ml[(base + (long long)c * MR) * 2]);
  float l = 0.f;
  for (int c = 0; c < n_chunks; ++c) {
    const float m = part_ml[(base + (long long)c * MR) * 2];
    if (m != -INFINITY) l += exp2f(m - M) * part_ml[(base + (long long)c * MR) * 2 + 1];
  }
  const float f = l > 0.f ? out_scale / l : 0.f;
  const int i = r / group, h = hkid * group + r % group;
  const long long ob = bi * o_sb + i * o_ss + h * o_sh;
  for (int col = threadIdx.x; col < d; col += blockDim.x) {
    float acc = 0.f;
    for (int c = 0; c < n_chunks; ++c) {
      const long long pr = base + (long long)c * MR;
      const float m = part_ml[pr * 2];
      if (m != -INFINITY) acc += exp2f(m - M) * part_acc[pr * d + col];
    }
    store_dt(out, ob + col, o_dt, acc * f);
  }
}

// ---------------------------------------------------------------------------
// decode_attn_kernel: split-KV decode on the CUDA cores
// ---------------------------------------------------------------------------

constexpr int DEC_THREADS = 128;
constexpr int DEC_WARPS = DEC_THREADS / 32;
constexpr int MAX_D = 256;

// Elements of a K/V row a lane covers: one 16-byte segment.
template <typename KV>
__host__ __device__ constexpr int seg_elems() { return 16 / static_cast<int>(sizeof(KV)); }

// Lanes a row takes (a power of two); a row holds lanes × 16 bytes in shared
// memory.
template <typename KV>
__host__ __device__ inline int dec_lanes(int d) {
  int l = 1;
  while (l * seg_elems<KV>() < d) l *= 2;
  return l;
}

// Dynamic shared memory of decode_attn_kernel: the chunk's K and V rows,
// then f32 q [group][dpad], scores [group][chunk], (max, sum) [group], and
// the warps' P·V sums [DEC_WARPS][HB][dpad].
template <typename KV>
__host__ __device__ inline size_t dec_smem(int d, int group, int chunk, int hb) {
  const int rb = dec_lanes<KV>(d) * 16, dpad = rb / static_cast<int>(sizeof(KV));
  return (size_t)2 * chunk * rb +
         sizeof(float) * ((size_t)group * dpad + (size_t)group * chunk + 2 * group +
                          (size_t)DEC_WARPS * hb * dpad);
}

// 16 int8 as f32 without I2F (16 results/clk/SM): byte x + 128 is the low
// mantissa byte of the f32 2^23 + x + 128
__device__ __forceinline__ void widen_seg(const uint4& r, float f[16], int8_t) {
  const uint32_t* wd = reinterpret_cast<const uint32_t*>(&r);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t u = wd[i] ^ 0x80808080u;
#pragma unroll
    for (int e = 0; e < 4; ++e)
      f[4 * i + e] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 + e)) - 8388736.f;
  }
}
__device__ __forceinline__ void widen_seg(const uint4& r, float f[8], __nv_bfloat16) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    f[2 * e] = __low2float(h[e]);
    f[2 * e + 1] = __high2float(h[e]);
  }
}

// One CTA per (chunk of `chunk` keys, KV head, batch row): the GQA group's
// query heads share every K/V row it reads.  All the chunk's K and V rows
// are requested at once, by cp.async of VB bytes (16, 8, 4; element loads at
// VB = 0) through the cache's strides into shared memory, so the CTA's
// whole byte stream is in flight before any is used (pass 1 waits for the
// K rows only).  A key row is then L lanes of 16 bytes (L a power of two,
// L·EPL >= d; the dims past d are zero in shared memory).  Pass 1 writes
// the chunk's scores (log2 units) to shared memory; the exact max and sum
// of each head follow; pass 2 sums p·v for HB heads per sweep over the V
// rows.  With one chunk the output is written here, else the chunk's (max,
// sum, unnormalised output) go to part_ml / part_acc for attn_combine_kernel.
template <typename KV, int VB, int HB>
__global__ void __launch_bounds__(DEC_THREADS)
decode_attn_kernel(const void* __restrict__ q, int q_dt, long long q_sb, long long q_sh,
                   const KV* __restrict__ k, long long k_sb, long long k_sh, long long k_ss,
                   const KV* __restrict__ v, long long v_sb, long long v_sh, long long v_ss,
                   const int* __restrict__ kv_len, void* __restrict__ out, int o_dt,
                   float* __restrict__ part_ml, float* __restrict__ part_acc, int hq, int hk,
                   int S, int d, int chunk, int n_chunks, float qk_scale, float out_scale) {
  constexpr int EPL = seg_elems<KV>();
  constexpr int ES = static_cast<int>(sizeof(KV));
  extern __shared__ __align__(16) unsigned char dsm_raw[];
  const int group = hq / hk;
  const int L = dec_lanes<KV>(d), rb = L * 16, dpad = L * EPL;
  unsigned char* kvs = dsm_raw;                                   // [2][chunk][rb]
  float* qs = reinterpret_cast<float*>(dsm_raw + (size_t)2 * chunk * rb);   // [group][dpad]
  float* sc = qs + group * dpad;                // [group][chunk] scores, then p
  float* ml = sc + group * chunk;               // [group][2] max, sum
  float* red = ml + 2 * group;                  // [DEC_WARPS][HB][dpad]

  const int ch = blockIdx.x, hkid = blockIdx.y, bi = blockIdx.z;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int kpw = 32 / L, kpr = DEC_WARPS * kpw;       // keys a warp, a CTA
  const int slot = warp * kpw + lane / L, c = (lane % L) * EPL;
  const int Lk = max(0, min(kv_len[bi], S));
  const int kbeg = ch * chunk, kstop = min(Lk, kbeg + chunk), n = kstop - kbeg;
  const bool split = n_chunks > 1;
  const long long pbase = ((long long)(bi * hk + hkid) * n_chunks + ch) * group;

  if (n <= 0) {                                  // a chunk past this row's window
    if (split) {
      for (int h = tid; h < group; h += DEC_THREADS) part_ml[(pbase + h) * 2] = -INFINITY;
    } else {
      for (int i = tid; i < group * d; i += DEC_THREADS)
        store_dt(out, ((long long)bi * hq + hkid * group + i / d) * d + i % d, o_dt, 0.f);
    }
    return;
  }
  const KV* kb = k + bi * k_sb + hkid * k_sh + kbeg * k_ss;
  const KV* vb = v + bi * v_sb + hkid * v_sh + kbeg * v_ss;
  {
    const int pieces = VB ? d * ES / VB : d;     // loads a row
#pragma unroll
    for (int which = 0; which < 2; ++which) {    // K, then V: one cp.async group each
      const KV* base = which ? vb : kb;
      const long long rs = which ? v_ss : k_ss;
      for (int i = tid; i < n * pieces; i += DEC_THREADS) {
        const int j = i / pieces, p = i % pieces;
        const KV* src = base + j * rs;
        unsigned char* dst = kvs + ((size_t)which * chunk + j) * rb;
        if constexpr (VB == 16) cp_async<16>(smem_u32(dst + p * 16), src + p * (16 / ES), true);
        else if constexpr (VB == 8) cp_async<8>(smem_u32(dst + p * 8), src + p * (8 / ES), true);
        else if constexpr (VB == 4) cp_async<4>(smem_u32(dst + p * 4), src + p * (4 / ES), true);
        else reinterpret_cast<KV*>(dst)[p] = src[p];
      }
      cp_async_commit();
    }
    if (d < dpad) {                              // the dims past d read as 0
      const int pad = (dpad - d) * ES;
      for (int i = tid; i < 2 * n * pad; i += DEC_THREADS) {
        const int row = i / pad, which = row / n, j = row % n;
        kvs[((size_t)which * chunk + j) * rb + d * ES + i % pad] = 0;
      }
    }
  }
  const float sl = qk_scale * LOG2E;
  for (int i = tid; i < group * dpad; i += DEC_THREADS) {
    const int h = i / dpad, cc = i % dpad;
    qs[i] = cc < d ? __bfloat162float(load_q_bf16(
                         q, bi * q_sb + (long long)(hkid * group + h) * q_sh + cc, q_dt)) * sl
                   : 0.f;
  }
  cp_async_wait<1>();                            // the K rows (V may still be landing)
  __syncthreads();

  // pass 1: scores; the rounds are uniform across the CTA (shuffles)
  for (int base = 0; base < n; base += kpr) {
    const int j = base + slot;
    float f[EPL];
    widen_seg(j < n ? *reinterpret_cast<const uint4*>(kvs + (size_t)j * rb + c * ES)
                    : make_uint4(0, 0, 0, 0), f, KV());
    for (int h = 0; h < group; ++h) {
      const float* qh = qs + h * dpad + c;
      float dot = 0.f;
#pragma unroll
      for (int e = 0; e < EPL; ++e) dot = fmaf(qh[e], f[e], dot);
      for (int o = L / 2; o > 0; o >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
      if (lane % L == 0 && j < n) sc[h * chunk + j] = dot;
    }
  }
  __syncthreads();

  // the exact max and sum of each head over the chunk; p = 2^(s - max)
  for (int h = warp; h < group; h += DEC_WARPS) {
    float m = -INFINITY;
    for (int j = lane; j < n; j += 32) m = fmaxf(m, sc[h * chunk + j]);
    m = warp_max(m);
    float l = 0.f;
    for (int j = lane; j < n; j += 32) {
      const float p = exp2f(sc[h * chunk + j] - m);
      sc[h * chunk + j] = p;
      l += p;
    }
    l = warp_sum(l);
    if (lane == 0) {
      ml[2 * h] = m;
      ml[2 * h + 1] = l;
    }
  }
  cp_async_wait<0>();                            // the V rows
  __syncthreads();

  // pass 2: P·V, HB heads a sweep over the chunk's V rows
  const unsigned char* vs = kvs + (size_t)chunk * rb;
  for (int h0 = 0; h0 < group; h0 += HB) {
    const int nh = min(HB, group - h0);
    float acc[HB][EPL];
#pragma unroll
    for (int h = 0; h < HB; ++h)
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc[h][e] = 0.f;
    for (int j = slot; j < n; j += kpr) {
      float f[EPL];
      widen_seg(*reinterpret_cast<const uint4*>(vs + (size_t)j * rb + c * ES), f, KV());
#pragma unroll
      for (int h = 0; h < HB; ++h) {
        if (h >= nh) break;
        const float p = sc[(h0 + h) * chunk + j];
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[h][e] = fmaf(p, f[e], acc[h][e]);
      }
    }
    // the key slots of a warp, then the warps, through shared memory
#pragma unroll
    for (int h = 0; h < HB; ++h) {
      if (h >= nh) break;                        // uniform
#pragma unroll
      for (int e = 0; e < EPL; ++e)
        for (int o = L; o < 32; o <<= 1) acc[h][e] += __shfl_xor_sync(0xffffffffu, acc[h][e], o);
      if (lane < L) {
#pragma unroll
        for (int e = 0; e < EPL; ++e) red[(warp * HB + h) * dpad + c + e] = acc[h][e];
      }
    }
    __syncthreads();
    for (int i = tid; i < nh * d; i += DEC_THREADS) {
      const int h = i / d, cc = i % d, hg = h0 + h;
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < DEC_WARPS; ++w) sum += red[(w * HB + h) * dpad + cc];
      if (split) {
        part_acc[(pbase + hg) * d + cc] = sum;
      } else {
        const float l = ml[2 * hg + 1];
        store_dt(out, ((long long)bi * hq + hkid * group + hg) * d + cc, o_dt,
                 l > 0.f ? sum * out_scale / l : 0.f);
      }
    }
    __syncthreads();
  }
  if (split)
    for (int h = tid; h < group; h += DEC_THREADS) {
      part_ml[(pbase + h) * 2] = ml[2 * h];
      part_ml[(pbase + h) * 2 + 1] = ml[2 * h + 1];
    }
}

// ---------------------------------------------------------------------------
// attn_wide_mma_kernel: any head dim above 256, on wgmma
// ---------------------------------------------------------------------------

constexpr int WIDE_ROWS = 64;              // m rows a CTA: one wgmma m64 tile
constexpr int WIDE_MAX_WG = 3;             // warpgroups a CTA, 128 O columns each
constexpr int WIDE_OW = 128;               // O columns a warpgroup: 64 f32 a thread
constexpr size_t WIDE_SMEM_MAX = 232448;   // dynamic shared memory a CTA may have

// d[0..15] (+)= A · B, one warpgroup, m64n32k16: A and B bf16 in shared
// memory (K-major, 128-byte swizzle, descriptors ad / bd), f32 sums; scale_d
// = 0 overwrites d
__device__ __forceinline__ void wgmma_ss_n32(float* d, uint64_t ad, uint64_t bd, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(ad), "l"(bd), "r"(scale_d));
}

// d[0..63] += A · B, one warpgroup, m64n128k16: A bf16 in shared memory
// (K-major, 128-byte swizzle, descriptor ad), B bf16 in shared memory
// MN-major (rows of 64 n, 128-byte swizzle, descriptor bd), f32 sums
__device__ __forceinline__ void wgmma_ss_t_n128(float* d, uint64_t ad, uint64_t bd) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
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
      : "l"(ad), "l"(bd), "r"(1));
}

// The bf16 pair of int8 bytes `sel` (a PRMT selector putting them at bits
// 0-7 and 16-23) of w, exact and without I2F: bits 0-6 under the exponent
// of 128 give 128 + (x & 127), bit 7 gives 128 or 256, and one HSUB2 of
// the two is x
__device__ __forceinline__ uint32_t i8_pair_bf16(uint32_t w, uint32_t sel) {
  const uint32_t p = __byte_perm(w, 0, sel);
  const uint32_t lo = (p & 0x007F007Fu) | 0x43004300u, hi = (p & 0x00800080u) | 0x43004300u;
  const __nv_bfloat162 r = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&lo),
                                   *reinterpret_cast<const __nv_bfloat162*>(&hi));
  return *reinterpret_cast<const uint32_t*>(&r);
}

// mbarrier of a ring stage fed by the tensor-map loads: init (one arrival
// a phase), the arrival announcing `bytes` of loads, a box of K or V
// [b][hk][S][d] at (dim c, row k, head h, batch bi) by the copy engine
// (completing on the barrier), and the wait for phase `parity`
__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void tma_box(uint32_t dst, const CUtensorMap* map, int c, int k, int h,
                                        int bi, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c), "r"(k), "r"(h), "r"(bi), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
}

// The descriptor of a bf16 tile in the 128-byte swizzle (rows of 64
// elements, 16-byte chunk c of row r at c ^ (r & 7), 8-row groups 1024
// bytes apart), `lbo` bytes between 64-element blocks of the rows (used by
// MN-major operands)
__device__ __forceinline__ uint64_t sw128_desc(const void* p, uint32_t lbo) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// Element (r, c) of a swizzled tile of `rows` rows: [c / 64][rows][64]
__device__ __forceinline__ int sw_at(int rows, int r, int c) {
  return (c >> 6) * rows * 64 + r * 64 + ((((c >> 3) & 7) ^ (r & 7)) << 3) + (c & 7);
}

// Shared memory of one attn_wide_mma_kernel launch (bytes from a 1024-byte
// aligned base, each region rounded up to 1024; the host sizes the launch
// with 1024 more, and kernels/flash_attention.py _wide_smem mirrors it):
// `stages` ring stages of [K: bkv rows × qc dims][V: bkv rows × vcols columns]
// [Q: 64 rows × qc dims, streamed only] — bf16 swizzled tiles, or for int8
// K/V the rows as they lie, 16 bytes apart (the widening's reads then miss
// each other's banks), widened into one swizzled K and V tile — then Q (64
// rows × qc dims, swizzled) unless streamed, P (64 rows × 64 keys, bf16,
// swizzled), the exchange of the row maxima and sums ([2][2][64] f32), and
// a stage's mbarrier each (the tensor-map loads).
// vcols = min(128·wg, d padded to 64): a warpgroup's columns past d read
// whatever follows the V tile and are never stored.  qc >= d: Q and whole K
// rows stay resident (qc is d padded to 64); qc < d: Q·Kᵀ streams qc-dim
// blocks of Q and K through the ring, so no size here grows with d.
struct WideSmem {
  int vcols, kraw, vraw;  // V tile columns; bytes a raw int8 row of the ring: K, V
  size_t stage, v_off, q_off, kw_off, vw_off, qres_off, p_off, red_off, bar_off, total;
};

__host__ __device__ inline size_t wide_al(size_t x) { return (x + 1023) & ~static_cast<size_t>(1023); }

__host__ __device__ inline WideSmem wide_smem(int wg, int bkv, int qc, int stages, int d, int es) {
  WideSmem m;
  const bool streamed = qc < d, i8 = es == 1;
  m.vcols = min(wg * WIDE_OW, (d + 63) / 64 * 64);
  m.kraw = qc + 16;
  m.vraw = m.vcols + 16;
  const size_t q = static_cast<size_t>(WIDE_ROWS) * qc * 2, k = static_cast<size_t>(bkv) * qc * 2,
               v = static_cast<size_t>(bkv) * m.vcols * 2;
  m.v_off = i8 ? wide_al(static_cast<size_t>(bkv) * m.kraw) : k;
  m.q_off = m.v_off + (i8 ? wide_al(static_cast<size_t>(bkv) * m.vraw) : v);
  m.stage = m.q_off + (streamed ? q : 0);
  m.kw_off = stages * m.stage;
  m.vw_off = m.kw_off + (i8 ? k : 0);
  m.qres_off = m.vw_off + (i8 ? v : 0);
  m.p_off = m.qres_off + (streamed ? 0 : q);
  m.red_off = m.p_off + WIDE_ROWS * 64 * 2;
  m.bar_off = m.red_off + 4 * WIDE_ROWS * 4;
  m.total = m.bar_off + 16;
  return m;
}

// Everything one launch needs, by value (the tensor maps 64-byte aligned).
struct alignas(64) WideArgs {
  CUtensorMap kmap, vmap;       // K / V as [b][hk][S][d] boxes of 64 dims × bkv rows, or unused
  const void* q;
  long long q_sb, q_ss, q_sh;   // q and out: (batch, seq, head) strides
  const void* k;
  long long k_sb, k_sh, k_ss;   // K and V: (batch, head, seq) strides
  const void* v;
  long long v_sb, v_sh, v_ss;
  void* out;
  long long o_sb, o_ss, o_sh;
  const int* q_offset;
  const int* kv_len;
  float* part_ml;
  float* part_acc;
  float qk_scale, out_scale;
  int q_dt, o_dt, off0, len0, sq, hq, hk, S, d, causal, vec;
  int wg, slices, qc, stages, chunk, n_chunks, tma;
};

// Rows × `per` items of a loop spread over the CTA's threads, without a
// division in the loop: item (r, c) after (r, c - 1), (r + 1, 0) after (r,
// per - 1)
struct Walk {
  int r, c, dr, dc, per;
  __device__ __forceinline__ Walk(int per_, int tid, int nthr)
      : r(tid / per_), c(tid % per_), dr(nthr / per_), dc(nthr % per_), per(per_) {}
  __device__ __forceinline__ void next() {
    r += dr;
    c += dc;
    if (c >= per) {
      c -= per;
      ++r;
    }
  }
};

// One CTA per (64 m rows of a KV head's GQA group, column slice of O, chunk
// of keys, KV head, batch row); m row r is (query r / group, head hkid·group
// + r % group), as in attn_fwd_kernel.  The CTA's wg warpgroups each own
// 128 columns of its slice of O, 64 rows × 128 in registers (64 f32 a
// thread, where the d <= 256 kernel would hold d / 2); slices wider than
// 128·wg are more CTAs, each computing the same S.  Per K/V tile of bkv
// keys, bkv / 32 warpgroups each run S = Q·Kᵀ for 32 keys on wgmma, both
// operands in shared memory, while the next tile's loads go out and int8 V
// widens; their row maxima meet in shared memory (a row lies in a
// quad of lanes); they write p = 2^(s - max) as bf16 (the JAX
// p.astype(bf16)) to a shared P tile and keep the f32 sums of their keys;
// then every warpgroup rescales its O and adds P·V on wgmma, P K-major and
// V MN-major from shared memory.  K/V tiles arrive in a ring of `stages`
// stages: by tensor map where the cache's rows and strides are 16-byte
// aligned (one thread asks for 64-dim boxes; an mbarrier a stage says they
// landed; bf16 lands in wgmma's swizzle, bf16 V rows past kv_len are then
// zeroed), otherwise by cp.async through the strides (`vec`-byte copies,
// element copies at vec = 0); int8 lands raw and is widened once per CTA
// (exact, free of bank conflicts).  Where Q and whole K
// rows do not fit (qc < d), each tile is nblk ring steps of qc dims of Q and
// K, S accumulating over them (the last also brings V).  No branch on the
// warpgroup that the compiler cannot see as warp-uniform surrounds a wgmma
// (ptxas would serialise them): the warpgroup index is a shuffled value,
// and a warpgroup past d computes P·V on spare columns and stores nothing.
// With n_chunks > 1 each CTA writes its (max, sum) (slice 0) and its columns
// of the unnormalised output to f32 scratch for attn_combine_kernel.  Keys
// past kv_len and, when causal, past a row's position are masked; only
// tiles that may hold such keys test it.
template <typename KV, int BKV>
__global__ void __launch_bounds__(WIDE_MAX_WG * 128, 1)
attn_wide_mma_kernel(const __grid_constant__ WideArgs a) {
  constexpr bool I8 = sizeof(KV) == 1;
  constexpr int ES = static_cast<int>(sizeof(KV));
  extern __shared__ __align__(16) unsigned char wraw[];
  unsigned char* wsm = wraw + ((1024 - (smem_u32(wraw) & 1023)) & 1023);
  const int d = a.d, qc = a.qc;
  const WideSmem sm = wide_smem(a.wg, BKV, qc, a.stages, d, ES);

  const int tid = threadIdx.x, nthr = blockDim.x;
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, tq = lane % 4;
  // warpgroup (uniform across a warp, as the compiler must see it for the
  // wgmmas in its branches) and its warp: rows 16·wq ..
  const int wgi = __shfl_sync(0xffffffffu, warp / 4, 0), wq = warp % 4;
  const int group = a.hq / a.hk, MR = a.sq * group;
  const int n_mb = (MR + WIDE_ROWS - 1) / WIDE_ROWS;
  int bx = static_cast<int>(blockIdx.x);
  const int ch = bx % a.n_chunks;
  bx /= a.n_chunks;
  const int slice = bx % a.slices;
  const int mb = n_mb - 1 - bx / a.slices;                   // the longest rows first
  const int hkid = blockIdx.y, bi = blockIdx.z, m0 = mb * WIDE_ROWS;
  const int qoff = a.q_offset ? a.q_offset[bi] : a.off0;
  const int L = max(0, min(a.kv_len ? a.kv_len[bi] : a.len0, a.S));
  const int i_first = m0 / group, i_last = min(a.sq - 1, (m0 + WIDE_ROWS - 1) / group);
  const int kend = a.causal ? max(0, min(L, qoff + i_last + 1)) : L;
  const int kbeg = ch * a.chunk, kstop = min(kend, kbeg + a.chunk);
  const bool split = a.n_chunks > 1;
  const long long pbase = ((long long)(bi * a.hk + hkid) * a.n_chunks + ch) * MR;

  if (split && kbeg >= kstop) {       // a chunk past these rows' window
    if (slice == 0)
      for (int r = m0 + tid; r < min(MR, m0 + WIDE_ROWS); r += nthr)
        a.part_ml[(pbase + r) * 2] = -INFINITY;
    return;
  }
  const int n_t = kstop > kbeg ? (kstop - kbeg + BKV - 1) / BKV : 0;
  const int nblk = (d + qc - 1) / qc;                        // ring steps a tile
  const bool streamed = nblk > 1;
  const int n_steps = n_t * nblk;
  const int cwid = a.wg * WIDE_OW, c0 = slice * cwid, cv = min(cwid, d - c0);   // O columns
  constexpr int SW = BKV / 32;                 // warpgroups computing S: 32 keys each
  const bool s_wg = wgi < SW;
  const int wc0 = wgi * WIDE_OW, wcols = max(0, min(WIDE_OW, cv - wc0));   // this warpgroup's

  const KV* kb = static_cast<const KV*>(a.k) + bi * a.k_sb + hkid * a.k_sh;
  const KV* vb = static_cast<const KV*>(a.v) + bi * a.v_sb + hkid * a.v_sh;

  // BKV rows from k0 of `ncols` elements from `col` (zeros past kv_len), as
  // they lie (raw) or into a swizzled tile
  auto load_rows = [&](unsigned char* dst, bool raw, int rowb, const KV* src, long long rs,
                       int k0, int col, int ncols) {
    const int vec = a.vec;
    const int per = vec ? ncols * ES / vec : ncols;           // copies a row
    for (Walk w(per, tid, nthr); w.r < BKV; w.next()) {
      const bool ok = k0 + w.r < L;
      const int e = vec ? w.c * (vec / ES) : w.c;               // first element of the copy
      unsigned char* sp = dst + (raw ? w.r * rowb + e * ES : sw_at(BKV, w.r, e) * 2);
      const KV* gp = src + (ok ? (long long)(k0 + w.r) * rs : 0) + col + e;
      if (vec == 16)
        cp_async<16>(smem_u32(sp), gp, ok);
      else if (vec == 8)
        cp_async<8>(smem_u32(sp), gp, ok);
      else if (vec == 4)
        cp_async<4>(smem_u32(sp), gp, ok);
      else
        *reinterpret_cast<KV*>(sp) = ok ? *gp : kv_zero<KV>();
    }
  };

  // Q rows m0 .. m0 + 64, dims [col, col + ncols) as bf16 into a swizzled
  // tile, zero past d (to the next 16) and past the last m row; 8 elements
  // a load where q allows
  const bool qvec = ((a.q_sb | a.q_ss | a.q_sh | static_cast<long long>(d)) & 7) == 0 &&
                    reinterpret_cast<uintptr_t>(a.q) % (8 * (a.q_dt == DT_F32 ? 4 : 2)) == 0;
  auto stage_q = [&](__nv_bfloat16* dst, int col, int ncols) {
    const int n16 = (ncols + 15) / 16 * 16;
    if (qvec) {
      for (Walk w(n16 / 8, tid, nthr); w.r < WIDE_ROWS; w.next()) {
        const int c = w.c * 8, r = m0 + w.r;
        uint4 val = make_uint4(0, 0, 0, 0);
        if (r < MR && c < ncols) {
          const long long e =
              bi * a.q_sb + (r / group) * a.q_ss + (hkid * group + r % group) * a.q_sh + col + c;
          if (a.q_dt == DT_BF16) {
            val = *reinterpret_cast<const uint4*>(static_cast<const __nv_bfloat16*>(a.q) + e);
          } else if (a.q_dt == DT_F32) {
            const float4 x = *reinterpret_cast<const float4*>(static_cast<const float*>(a.q) + e);
            const float4 y = *reinterpret_cast<const float4*>(static_cast<const float*>(a.q) + e + 4);
            val = make_uint4(pack_bf162(x.x, x.y), pack_bf162(x.z, x.w), pack_bf162(y.x, y.y),
                             pack_bf162(y.z, y.w));
          } else {
            const uint4 h = *reinterpret_cast<const uint4*>(static_cast<const __half*>(a.q) + e);
            const __half2* hp = reinterpret_cast<const __half2*>(&h);
            val = make_uint4(pack_bf162(__low2float(hp[0]), __high2float(hp[0])),
                             pack_bf162(__low2float(hp[1]), __high2float(hp[1])),
                             pack_bf162(__low2float(hp[2]), __high2float(hp[2])),
                             pack_bf162(__low2float(hp[3]), __high2float(hp[3])));
          }
        }
        *reinterpret_cast<uint4*>(dst + sw_at(WIDE_ROWS, w.r, c)) = val;
      }
    } else {
      for (Walk w(n16, tid, nthr); w.r < WIDE_ROWS; w.next()) {
        const int c = w.c, r = m0 + w.r;
        __nv_bfloat16 val = __float2bfloat16_rn(0.f);
        if (r < MR && c < ncols)
          val = load_q_bf16(
              a.q, bi * a.q_sb + (r / group) * a.q_ss + (hkid * group + r % group) * a.q_sh + col + c,
              a.q_dt);
        dst[sw_at(WIDE_ROWS, w.r, c)] = val;
      }
    }
  };

  // ring step s (tile s / nblk, dims block s % nblk) into stage s % stages:
  // one cp.async group; K's dims past d (to the next 16) written as 0
  auto load_step = [&](int s) {
    if (s >= n_steps) return;
    const int t = s / nblk, j = s % nblk;
    unsigned char* stg = wsm + static_cast<size_t>(s % a.stages) * sm.stage;
    const int k0 = kbeg + t * BKV, col = j * qc, qv = min(qc, d - col);
    const bool withv = j == nblk - 1;
    if (a.tma) {
      // one thread asks the copy engine for the 64-dim boxes of K and V
      // (dims past d and rows past S read as 0)
      if (tid == 0) {
        const uint32_t bar = smem_u32(wsm + sm.bar_off + 8 * (s % a.stages));
        const int nk = (qv + 63) / 64, nv = withv ? (cv + 63) / 64 : 0;
        mbar_expect(bar, (nk + nv) * 64 * BKV * ES);
        for (int b = 0; b < nk; ++b)
          tma_box(smem_u32(stg + b * 64 * BKV * ES), &a.kmap, col + 64 * b, k0, hkid, bi, bar);
        for (int b = 0; b < nv; ++b)
          tma_box(smem_u32(stg + sm.v_off + b * 64 * BKV * ES), &a.vmap, c0 + 64 * b, k0, hkid,
                  bi, bar);
      }
    } else {
      load_rows(stg, I8, sm.kraw, kb, a.k_ss, k0, col, qv);
      const int pad = (qv + 15) / 16 * 16 - qv;
      if (pad)
        for (Walk w(pad, tid, nthr); w.r < BKV; w.next()) {
          if constexpr (I8) stg[w.r * sm.kraw + qv + w.c] = 0;
          else reinterpret_cast<__nv_bfloat16*>(stg)[sw_at(BKV, w.r, qv + w.c)] = kv_zero<KV>();
        }
      if (withv) load_rows(stg + sm.v_off, I8, sm.vraw, vb, a.v_ss, k0, c0, cv);
    }
    if (streamed) stage_q(reinterpret_cast<__nv_bfloat16*>(stg + sm.q_off), col, qv);
    cp_async_commit();
  };

  // BKV raw int8 rows → a swizzled bf16 tile (exact), the first `words`
  // 16-byte words of each row: rows `rowb` bytes apart, as cp.async lays
  // them (16 bytes past a row's length, so that 8 neighbouring threads,
  // taking neighbouring rows, read and write 8 distinct bank groups), or
  // the copy engine's 64-byte box rows, boxes 64·BKV bytes apart (the loop
  // runs over whole boxes: a word past `words` is skipped)
  auto widen = [&](const unsigned char* raw, int rowb, __nv_bfloat16* dst, int words) {
    const int rs = a.tma ? 64 : rowb, bs = a.tma ? 64 * BKV : 64;
    const int nw = a.tma ? (words + 3) / 4 * 4 : words;
    for (int idx = tid; idx < BKV * nw; idx += nthr) {
      // box rows: a row's 4 words, then the next row (8 threads read 128
      // contiguous bytes); padded rows: the next row's word
      const int wr = a.tma ? idx / 4 % BKV : idx % BKV;
      const int wc = a.tma ? idx / (4 * BKV) * 4 + idx % 4 : idx / BKV;
      if (wc >= words) continue;
      const uint4 x =
          *reinterpret_cast<const uint4*>(raw + wr * rs + (wc >> 2) * bs + (wc & 3) * 16);
      const uint4 lo = make_uint4(i8_pair_bf16(x.x, 0x4140), i8_pair_bf16(x.x, 0x4342),
                                  i8_pair_bf16(x.y, 0x4140), i8_pair_bf16(x.y, 0x4342));
      const uint4 hi = make_uint4(i8_pair_bf16(x.z, 0x4140), i8_pair_bf16(x.z, 0x4342),
                                  i8_pair_bf16(x.w, 0x4140), i8_pair_bf16(x.w, 0x4342));
      *reinterpret_cast<uint4*>(dst + sw_at(BKV, wr, wc * 16)) = lo;
      *reinterpret_cast<uint4*>(dst + sw_at(BKV, wr, wc * 16 + 8)) = hi;
    }
  };

  if (a.tma) {
    if (tid == 0)
      for (int st = 0; st < a.stages; ++st) mbar_init(smem_u32(wsm + sm.bar_off + 8 * st));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    __syncthreads();
  }
  load_step(0);
  if (!streamed) stage_q(reinterpret_cast<__nv_bfloat16*>(wsm + sm.qres_off), 0, d);

  int qpos[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr)
    qpos[rr] = qoff + min((m0 + 16 * wq + g + rr * 8) / group, a.sq - 1);
  const float sl = a.qk_scale * LOG2E;    // scores in log2 units: exp2 below
  __nv_bfloat16* Ps = reinterpret_cast<__nv_bfloat16*>(wsm + sm.p_off);   // P [64][64]
  float* red = reinterpret_cast<float*>(wsm + sm.red_off);   // [max, sum][SW][64]
  __nv_bfloat16* Kw = reinterpret_cast<__nv_bfloat16*>(wsm + sm.kw_off);  // widened K
  __nv_bfloat16* Vw = reinterpret_cast<__nv_bfloat16*>(wsm + sm.vw_off);  // widened V
  float s[16];                            // S of this warpgroup's 32 keys: n-tile n at s[4n ..]
  float o[64];                            // O: 8-column n-tile j at o[4j ..], rows g / g + 8
#pragma unroll
  for (int i = 0; i < 64; ++i) o[i] = 0.f;
  float mrow[2] = {-INFINITY, -INFINITY}, lrow[2] = {0.f, 0.f};
  const int row0 = 16 * wq + g;           // this thread's rows: row0, row0 + 8

  for (int step = 0; step < n_steps; ++step) {
    const int t = step / nblk, j = step % nblk, st = step % a.stages;
    const bool last = j == nblk - 1;
    const int qv = min(qc, d - j * qc), k0 = kbeg + t * BKV;
    unsigned char* stg = wsm + static_cast<size_t>(st) * sm.stage;
    if (a.tma) {             // this step's loads have landed ...
      mbar_wait(smem_u32(wsm + sm.bar_off + 8 * st), (step / a.stages) & 1);
      if (!I8 && last && k0 + BKV > L) {
        // bf16 V rows past kv_len may hold anything (a NaN times p = 0 is
        // NaN): zero them
        const int r0 = max(0, L - k0), cb = (cv + 63) / 64;
        for (int i = tid; i < (BKV - r0) * cb * 8; i += nthr) {
          const int r = r0 + i / (cb * 8), c = i % (cb * 8);
          *reinterpret_cast<uint4*>(stg + sm.v_off + (c / 8) * BKV * 128 + r * 128 + (c % 8) * 16) =
              make_uint4(0, 0, 0, 0);
        }
      }
    } else {
      cp_async_wait<0>();
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");   // ... for wgmma too
    __syncthreads();         // ... for every thread; the last step's buffers are free
    const __nv_bfloat16* Kt = I8 ? Kw : reinterpret_cast<const __nv_bfloat16*>(stg);
    const __nv_bfloat16* Vt = I8 ? Vw : reinterpret_cast<const __nv_bfloat16*>(stg + sm.v_off);
    if (I8) {
      widen(stg, sm.kraw, Kw, (qv + 15) / 16);
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncthreads();
    }
    const __nv_bfloat16* Qt = reinterpret_cast<const __nv_bfloat16*>(
        streamed ? stg + sm.q_off : wsm + sm.qres_off);

    // S (+)= Q·Kᵀ over this block's dims for keys 32·wgi .. (the S
    // warpgroups): k16 step ks at 32-byte offsets within a 64-dim block,
    // blocks WIDE_ROWS (Q) and BKV (K) rows apart
    if (s_wg) {
      const uint64_t qd = sw128_desc(Qt, 16), kd = sw128_desc(Kt + wgi * 32 * 64, 16);
      const int nks = (qv + 15) / 16;
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
      for (int ks = 0; ks < nks; ++ks) {
        const uint32_t qo = ((ks >> 2) * WIDE_ROWS * 128 + (ks & 3) * 32) >> 4;
        const uint32_t ko = ((ks >> 2) * BKV * 128 + (ks & 3) * 32) >> 4;
        wgmma_ss_n32(s, qd + qo, kd + ko, j > 0 || ks > 0);
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    }
    // the next step's loads go out, and int8 V widens, while the tensor
    // cores take S
    if (a.stages > 1) load_step(step + 1);
    if (I8 && last) widen(stg + sm.v_off, sm.vraw, Vw, (cv + 15) / 16);
    if (s_wg) {
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
      for (int i = 0; i < 16; ++i) asm volatile("" : "+f"(s[i])::"memory");
    }

    if (last) {
      // online softmax over the tile (log2 units): the S warpgroups' row
      // maxima meet in `red`; they write p as bf16 to P and keep the sums
      // of their keys; every warpgroup rescales its O by the same alpha
      if (s_wg) {
        const bool need_mask = k0 + BKV > L || (a.causal && k0 + BKV - 1 > qoff + i_first);
        float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int rr = e / 2, key = k0 + wgi * 32 + n * 8 + 2 * tq + (e % 2);
            float val = s[4 * n + e] * sl;
            if (need_mask && !(key < L && (!a.causal || key <= qpos[rr]))) val = -INFINITY;
            s[4 * n + e] = val;
            mx[rr] = fmaxf(mx[rr], val);
          }
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 1));
          mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 2));
          if (tq == 0) red[wgi * WIDE_ROWS + row0 + rr * 8] = mx[rr];
        }
      }
      __syncthreads();
      float alpha[2], mu[2];
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        float m = -INFINITY;
#pragma unroll
        for (int w = 0; w < SW; ++w) m = fmaxf(m, red[w * WIDE_ROWS + row0 + rr * 8]);
        const float m_new = fmaxf(mrow[rr], m);
        mu[rr] = m_new == -INFINITY ? 0.f : m_new;   // a row with no key yet: p = 0
        alpha[rr] = fexp2(mrow[rr] - mu[rr]);
        mrow[rr] = m_new;
      }
      if (s_wg) {
        float psum[2] = {0.f, 0.f};
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          const float p0 = fexp2(s[4 * n] - mu[0]), p1 = fexp2(s[4 * n + 1] - mu[0]);
          const float p2 = fexp2(s[4 * n + 2] - mu[1]), p3 = fexp2(s[4 * n + 3] - mu[1]);
          psum[0] += p0 + p1;
          psum[1] += p2 + p3;
          const int key = wgi * 32 + n * 8 + 2 * tq;
          *reinterpret_cast<uint32_t*>(Ps + sw_at(WIDE_ROWS, row0, key)) = pack_bf162(p0, p1);
          *reinterpret_cast<uint32_t*>(Ps + sw_at(WIDE_ROWS, row0 + 8, key)) = pack_bf162(p2, p3);
        }
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) lrow[rr] = lrow[rr] * alpha[rr] + psum[rr];
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");   // P and V, for wgmma
      __syncthreads();
#pragma unroll
      for (int n = 0; n < 16; ++n) {
        o[4 * n] *= alpha[0]; o[4 * n + 1] *= alpha[0];
        o[4 * n + 2] *= alpha[1]; o[4 * n + 3] *= alpha[1];
      }
      // O += P·V, both from shared memory: P's 16-key steps 32 bytes apart,
      // V's rows of 16 keys 2048 bytes apart, its 64-column blocks BKV·128
      // bytes apart; every warpgroup runs it (one past d on spare columns:
      // a branch on the warpgroup would serialise the wgmmas)
      const uint64_t pd = sw128_desc(Ps, 16);
      const uint64_t vd = sw128_desc(Vt + (wc0 / 64) * BKV * 64, BKV * 128);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk)
        wgmma_ss_t_n128(o, pd + kk * (32 >> 4), vd + kk * (2048 >> 4));
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
      for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(o[i])::"memory");
    }
    if (a.stages == 1) {    // one stage: the next step loads once this one is read
      __syncthreads();
      load_step(step + 1);
    }
  }
  cp_async_wait<0>();

  // the row sums: the S warpgroups' partial sums meet in `red`
  if (s_wg)
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      lrow[rr] += __shfl_xor_sync(0xffffffffu, lrow[rr], 1);
      lrow[rr] += __shfl_xor_sync(0xffffffffu, lrow[rr], 2);
      if (tq == 0) red[(SW + wgi) * WIDE_ROWS + row0 + rr * 8] = lrow[rr];
    }
  __syncthreads();
  if (wcols == 0) return;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int r = m0 + row0 + rr * 8;
    float l = 0.f;
#pragma unroll
    for (int w = 0; w < SW; ++w) l += red[(SW + w) * WIDE_ROWS + row0 + rr * 8];
    if (r >= MR) continue;
    if (split) {
      const long long pr = pbase + r;
      if (slice == 0 && wgi == 0 && tq == 0) {
        a.part_ml[pr * 2] = mrow[rr];
        a.part_ml[pr * 2 + 1] = l;
      }
#pragma unroll
      for (int n = 0; n < 16; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = n * 8 + 2 * tq + e;
          if (c < wcols) a.part_acc[pr * d + c0 + wc0 + c] = o[4 * n + rr * 2 + e];
        }
    } else {
      const int i = r / group, h = hkid * group + r % group;
      const long long ob = bi * a.o_sb + i * a.o_ss + h * a.o_sh + c0 + wc0;
      const float f = l > 0.f ? a.out_scale / l : 0.f;
#pragma unroll
      for (int n = 0; n < 16; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = n * 8 + 2 * tq + e;
          if (c < wcols) store_dt(a.out, ob + c, a.o_dt, o[4 * n + rr * 2 + e] * f);
        }
    }
  }
}

// cuTensorMapEncodeTiled, through the runtime (no link against libcuda)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) ==
            cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The tensor map of K or V [b][hk][S][d] (element strides sb, sh, ss; d
// contiguous) in boxes of 64 dims × bkv rows: bf16 in the 128-byte swizzle
// (wgmma's layout), int8 as the rows lie; reads past d and S give 0
bool kv_tensor_map(CUtensorMap* m, const void* base, int es, const long long* st, int b, int hk,
                   int S, int d, int bkv) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(hk), static_cast<cuuint64_t>(b)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(st[2] * es),
                                 static_cast<cuuint64_t>(st[1] * es),
                                 static_cast<cuuint64_t>(st[0] * es)};
  const cuuint32_t box[4] = {64, static_cast<cuuint32_t>(bkv), 1, 1}, one[4] = {1, 1, 1, 1};
  return enc(m, es == 1 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
             const_cast<void*>(base), dims, strides, box, one, CU_TENSOR_MAP_INTERLEAVE_NONE,
             es == 1 ? CU_TENSOR_MAP_SWIZZLE_NONE : CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename KV, int BKV>
int launch_wide(const WideArgs& a, int b, cudaStream_t stream) {
  const size_t smem = wide_smem(a.wg, BKV, a.qc, a.stages, a.d,
                                static_cast<int>(sizeof(KV))).total + 1024;
  if (smem > WIDE_SMEM_MAX) return static_cast<int>(cudaErrorInvalidValue);
  auto kern = attn_wide_mma_kernel<KV, BKV>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const int MR = a.sq * (a.hq / a.hk), n_mb = (MR + WIDE_ROWS - 1) / WIDE_ROWS;
  kern<<<dim3(n_mb * a.slices * a.n_chunks, a.hk, b), 128 * a.wg, smem, stream>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess || a.n_chunks == 1) return static_cast<int>(e);
  attn_combine_kernel<<<dim3(MR, a.hk, b), 128, 0, stream>>>(
      a.part_ml, a.part_acc, a.out, a.o_dt, a.o_sb, a.o_ss, a.o_sh, a.sq, a.hq, a.hk, a.d,
      a.n_chunks, a.out_scale);
  return static_cast<int>(cudaGetLastError());
}

template <int DP, typename KV>
int launch_fwd(const void* q, int q_dt, const long long* qs, const void* k, const long long* ks,
               const void* v, const long long* vs, const int* q_offset, int off0,
               const int* kv_len, int len0, void* out, int o_dt, const long long* os,
               float* part_ml, float* part_acc, int b, int sq, int hq, int hk, int S, int d,
               int causal, int vec, int rw, int kw, int chunk, int n_chunks, float qk_scale,
               float out_scale, cudaStream_t stream) {
  using C = Fwd<DP, KV, false>;
  if (chunk % C::BKV != 0 || C::NT % kw != 0 || C::NT / kw < 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = kw > 1 ? Fwd<DP, KV, true>::smem(rw) : C::smem(rw);
  auto kern = kw > 1 ? attn_fwd_kernel<DP, KV, true> : attn_fwd_kernel<DP, KV, false>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const int MR = sq * (hq / hk);
  const int n_mb = (MR + 16 * rw - 1) / (16 * rw);
  dim3 grid(n_mb * n_chunks, hk, b);
  kern<<<grid, 32 * rw * kw, smem, stream>>>(
      q, q_dt, qs[0], qs[1], qs[2], static_cast<const KV*>(k), ks[0], ks[1], ks[2],
      static_cast<const KV*>(v), vs[0], vs[1], vs[2], q_offset, off0, kv_len, len0, out, o_dt,
      os[0], os[1], os[2], part_ml, part_acc, sq, hq, hk, S, d, causal, vec, rw, chunk,
      n_chunks, qk_scale, out_scale);
  e = cudaGetLastError();
  if (e != cudaSuccess || n_chunks == 1) return static_cast<int>(e);
  attn_combine_kernel<<<dim3(MR, hk, b), 128, 0, stream>>>(
      part_ml, part_acc, out, o_dt, os[0], os[1], os[2], sq, hq, hk, d, n_chunks, out_scale);
  return static_cast<int>(cudaGetLastError());
}

bool valid_dt(int dt) { return dt == DT_BF16 || dt == DT_F16 || dt == DT_F32; }

}  // namespace

// q [b, hq, d] through strides (batch, head) and out [b, hq, d] contiguous,
// each bf16, f16 or f32 (q_dt / o_dt: 0 / 1 / 2); k/v [b, hk, S, d] through
// element strides (batch, head, seq); d contiguous everywhere; K/V int8
// (kv_int8 != 0) or bf16; kv_len int32 [b].  d <= 256; vec: bytes per K/V
// load (16, 8 or 4; 0: element by element), dividing d·sizeof(KV), every
// row start and stride.  The KV window is cut into n_chunks chunks of
// `chunk` keys (chunk·n_chunks >= S); n_chunks > 1 writes f32 partials to
// part_ml [b, hk, n_chunks, hq/hk, 2] and part_acc [.., d], merged by
// attn_combine_kernel.
extern "C" int decode_attention_launch(const void* q, int q_dt, long long q_sb, long long q_sh,
                                       const void* k, long long k_sb, long long k_sh,
                                       long long k_ss, const void* v, long long v_sb,
                                       long long v_sh, long long v_ss, const int* kv_len,
                                       void* out, int o_dt, float* part_ml, float* part_acc,
                                       int b, int hq, int hk, int S, int d, int kv_int8, int vec,
                                       int chunk, int n_chunks, float qk_scale, float out_scale,
                                       void* stream) {
  const bool ok_vec = vec == 0 || vec == 4 || vec == 8 || vec == 16;
  if (d < 1 || d > MAX_D || !valid_dt(q_dt) || !valid_dt(o_dt) || !ok_vec || hk < 1 ||
      hq % hk != 0 || chunk < 1 || n_chunks < 1 || (long long)chunk * n_chunks < S ||
      (n_chunks > 1 && (part_ml == nullptr || part_acc == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int group = hq / hk;
  const int hb = group == 1 ? 1 : 4;
  const size_t smem = kv_int8 ? dec_smem<int8_t>(d, group, chunk, hb)
                              : dec_smem<__nv_bfloat16>(d, group, chunk, hb);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(n_chunks, hk, b);
  cudaError_t e = cudaSuccess;
#define CSINN2_DEC(KV, VB, HB)                                                                  \
  {                                                                                             \
    auto kern = decode_attn_kernel<KV, VB, HB>;                                                 \
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,                 \
                             static_cast<int>(smem));                                           \
    if (e != cudaSuccess) return static_cast<int>(e);                                           \
    kern<<<grid, DEC_THREADS, smem, st>>>(q, q_dt, q_sb, q_sh, static_cast<const KV*>(k), k_sb, \
                                          k_sh, k_ss, static_cast<const KV*>(v), v_sb, v_sh,    \
                                          v_ss, kv_len, out, o_dt, part_ml, part_acc, hq, hk,   \
                                          S, d, chunk, n_chunks, qk_scale, out_scale);          \
  }
#define CSINN2_DEC_HB(KV, VB) \
  if (hb == 1) CSINN2_DEC(KV, VB, 1) else CSINN2_DEC(KV, VB, 4)
#define CSINN2_DEC_VEC(KV)                                       \
  if (vec == 16) { CSINN2_DEC_HB(KV, 16) }                       \
  else if (vec == 8) { CSINN2_DEC_HB(KV, 8) }                    \
  else if (vec == 4) { CSINN2_DEC_HB(KV, 4) }                    \
  else { CSINN2_DEC_HB(KV, 0) }
  if (kv_int8) {
    CSINN2_DEC_VEC(int8_t)
  } else {
    CSINN2_DEC_VEC(__nv_bfloat16)
  }
#undef CSINN2_DEC_VEC
#undef CSINN2_DEC_HB
#undef CSINN2_DEC
  e = cudaGetLastError();
  if (e != cudaSuccess || n_chunks == 1) return static_cast<int>(e);
  attn_combine_kernel<<<dim3(group, hk, b), 128, 0, st>>>(
      part_ml, part_acc, out, o_dt, (long long)hq * d, 0, d, 1, hq, hk, d, n_chunks, out_scale);
  return static_cast<int>(cudaGetLastError());
}

// q [b, sq, hq, d] and out through strides {batch, seq, head}, each bf16,
// f16 or f32 (q_dt / o_dt: 0 / 1 / 2); k/v [b, hk, S, d] through strides
// {batch, head, seq}; contiguous d in all; q_offset / kv_len int32 [b], or
// null for one off0 / len0 for every row.  d <= 256.  vec: bytes per K/V
// load (16, 8 or 4; 0: element by element), dividing d·sizeof(KV), every
// row start and stride.  A CTA is rw × kw warps: rw (1-8) groups of 16
// query rows, each tile's keys cut in kw slices (at least 16 keys each;
// tiles are 64 keys, 32 at d > 128; rw·kw <= 4 with slices).  The KV
// window is cut into n_chunks chunks of `chunk` keys (a multiple of 64;
// chunk·n_chunks >= S); n_chunks > 1 runs one CTA per chunk with f32
// partials in part_ml [b, hk, n_chunks, sq·hq/hk, 2] and part_acc [.., d],
// merged by a second kernel; it needs sq·hq/hk <= 16·rw.
extern "C" int attention_fwd_launch(const void* q, const long long* q_strides, int q_dt,
                                    const void* k, const long long* k_strides, const void* v,
                                    const long long* v_strides, const int* q_offset, int off0,
                                    const int* kv_len, int len0, void* out,
                                    const long long* o_strides, int o_dt, float* part_ml,
                                    float* part_acc, int b, int sq, int hq, int hk, int S, int d,
                                    int kv_int8, int causal, int vec, int rw, int kw, int chunk,
                                    int n_chunks, float qk_scale, float out_scale,
                                    void* stream) {
  const bool ok_vec = vec == 0 || vec == 4 || vec == 8 || vec == 16;
  const bool ok_warps = (rw == 1 || rw == 2 || rw == 4 || rw == 8) &&
                        (kw == 1 || kw == 2 || kw == 4) && rw * kw <= (kw > 1 ? 4 : FWD_MAX_WARPS);
  if (d < 1 || d > MAX_D || !ok_vec || !ok_warps || !valid_dt(q_dt) || !valid_dt(o_dt) ||
      n_chunks < 1 || chunk < 1 || (long long)chunk * n_chunks < S || hk < 1 || hq % hk != 0 ||
      (n_chunks > 1 && (part_ml == nullptr || part_acc == nullptr || sq * (hq / hk) > 16 * rw)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define CSINN2_FWD(D, KV)                                                                     \
  return launch_fwd<D, KV>(q, q_dt, q_strides, k, k_strides, v, v_strides, q_offset, off0,   \
                           kv_len, len0, out, o_dt, o_strides, part_ml, part_acc, b, sq, hq, \
                           hk, S, d, causal, vec, rw, kw, chunk, n_chunks, qk_scale,          \
                           out_scale, st)
  if (d <= 64) {
    if (kv_int8) CSINN2_FWD(64, int8_t);
    CSINN2_FWD(64, __nv_bfloat16);
  }
  if (d <= 128) {
    if (kv_int8) CSINN2_FWD(128, int8_t);
    CSINN2_FWD(128, __nv_bfloat16);
  }
  if (kv_int8) CSINN2_FWD(256, int8_t);
  CSINN2_FWD(256, __nv_bfloat16);
#undef CSINN2_FWD
}

// attn_wide_mma_kernel for any head dim (the wrappers send it d > 256): q
// and out through strides {batch, seq, head}, each bf16, f16 or f32 (q_dt /
// o_dt: 0 / 1 / 2); k/v [b, hk, S, d] through strides {batch, head, seq};
// contiguous d in all; q_offset / kv_len int32 [b], or null for one off0 /
// len0 for every row; causal or not (decode: sq = 1, not causal).  vec:
// bytes per K/V copy (16, 8 or 4; 0: element by element), dividing
// d·sizeof(KV), every row start and stride; at 16 the copy engine loads
// the tiles by tensor map.  The plan (kernels/flash_attention.py
// _wide_plan): wg (1-3) warpgroups of 128 O columns each, `slices` CTAs
// over the columns (128·wg each, covering d once), bkv keys a tile (32 or
// 64), qc dims of Q and K a ring step (a multiple of 64: d padded to 64
// keeps them resident, less streams them), 1 or 2 ring stages, and the KV
// window cut into n_chunks chunks of `chunk`
// keys (a multiple of bkv; chunk·n_chunks >= S); n_chunks > 1 writes f32
// partials to part_ml [b, hk, n_chunks, sq·hq/hk, 2] and part_acc [.., d],
// merged by attn_combine_kernel.
extern "C" int attention_wide_launch(const void* q, const long long* q_strides, int q_dt,
                                     const void* k, const long long* k_strides, const void* v,
                                     const long long* v_strides, const int* q_offset, int off0,
                                     const int* kv_len, int len0, void* out,
                                     const long long* o_strides, int o_dt, float* part_ml,
                                     float* part_acc, int b, int sq, int hq, int hk, int S, int d,
                                     int kv_int8, int causal, int vec, int wg, int slices, int bkv,
                                     int qc, int stages, int chunk, int n_chunks,
                                     float qk_scale, float out_scale, void* stream) {
  const bool ok_vec = vec == 0 || vec == 4 || vec == 8 || vec == 16;
  const bool ok_plan = wg >= 1 && wg <= WIDE_MAX_WG && slices >= 1 &&
                       (long long)slices * wg * WIDE_OW >= d &&
                       (long long)(slices - 1) * wg * WIDE_OW < d &&
                       (bkv == 32 || bkv == 64) && qc >= 64 && qc % 64 == 0 && qc < d + 64 &&
                       (stages == 1 || stages == 2) && chunk >= bkv && chunk % bkv == 0 &&
                       n_chunks >= 1 && (long long)chunk * n_chunks >= S;
  if (d < 1 || !ok_vec || !ok_plan || !valid_dt(q_dt) || !valid_dt(o_dt) || b < 1 || sq < 1 ||
      hk < 1 || hq % hk != 0 || (n_chunks > 1 && (part_ml == nullptr || part_acc == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  WideArgs a = {};
  a.q = q;
  a.q_sb = q_strides[0]; a.q_ss = q_strides[1]; a.q_sh = q_strides[2];
  a.k = k;
  a.k_sb = k_strides[0]; a.k_sh = k_strides[1]; a.k_ss = k_strides[2];
  a.v = v;
  a.v_sb = v_strides[0]; a.v_sh = v_strides[1]; a.v_ss = v_strides[2];
  a.out = out;
  a.o_sb = o_strides[0]; a.o_ss = o_strides[1]; a.o_sh = o_strides[2];
  a.q_offset = q_offset;
  a.kv_len = kv_len;
  a.part_ml = part_ml;
  a.part_acc = part_acc;
  a.qk_scale = qk_scale;
  a.out_scale = out_scale;
  a.q_dt = q_dt; a.o_dt = o_dt; a.off0 = off0; a.len0 = len0;
  a.sq = sq; a.hq = hq; a.hk = hk; a.S = S; a.d = d; a.causal = causal; a.vec = vec;
  a.wg = wg; a.slices = slices; a.qc = qc; a.stages = stages; a.chunk = chunk;
  a.n_chunks = n_chunks;
  // rows, strides and starts 16-byte aligned: the copy engine loads the
  // tiles by tensor map; otherwise cp.async does, `vec` bytes a copy
  a.tma = vec == 16;
  if (a.tma && !(kv_tensor_map(&a.kmap, k, kv_int8 ? 1 : 2, k_strides, b, hk, S, d, bkv) &&
                 kv_tensor_map(&a.vmap, v, kv_int8 ? 1 : 2, v_strides, b, hk, S, d, bkv)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kv_int8)
    return bkv == 64 ? launch_wide<int8_t, 64>(a, b, st) : launch_wide<int8_t, 32>(a, b, st);
  return bkv == 64 ? launch_wide<__nv_bfloat16, 64>(a, b, st)
                   : launch_wide<__nv_bfloat16, 32>(a, b, st);
}

// Shared memory (bytes, the 1024 of alignment slack included) of
// attn_wide_mma_kernel at a plan, for the plan's Python mirror
// (kernels/flash_attention.py _wide_smem) to be held to.
extern "C" long long attention_wide_smem(int wg, int bkv, int qc, int stages, int d,
                                         int kv_int8) {
  return static_cast<long long>(wide_smem(wg, bkv, qc, stages, d, kv_int8 ? 1 : 2).total) + 1024;
}
