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
// attention_wide_launch — the same three functions at d > 256, which the
//   JAX functions take (they pad d to a multiple of 128, with no cap) and
//   the kernels above do not.  Speed is no aim: attn_wide_kernel is a
//   plain online-softmax attention on the CUDA cores, right at any d whose
//   tiles fit shared memory (notes at the kernel).  Bound as above.
//
// A row whose softmax denominator is 0 (kv_len == 0, or every key masked)
// outputs 0, never NaN.  K/V are read through (batch, head, seq) strides
// with a contiguous last dim, so the cache's [b, S, hk, d] layout is
// consumed in place (no transpose).  q and out are bf16, f16 or f32
// (dtype codes DT_*); out is written from the f32 sums in its own dtype.
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
// attn_wide_kernel: any head dim above 256, on the CUDA cores
// ---------------------------------------------------------------------------

constexpr int WIDE_THREADS = 128;
constexpr int WIDE_WARPS = WIDE_THREADS / 32;
constexpr size_t WIDE_SMEM_MAX = 232448;   // dynamic shared memory a CTA may have

__device__ __forceinline__ float kv_to_float(int8_t x) { return static_cast<float>(x); }
__device__ __forceinline__ float kv_to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

// Dynamic shared memory of attn_wide_kernel: a tile's K and V rows as they
// lie (each padded to 16 bytes), then f32 q and output rows [rb][d], the
// scores [rb][bkv] and (max, sum, rescale) [3][rb]
__host__ __device__ inline size_t wide_smem(int d, int es, int rb, int bkv) {
  const size_t row = (static_cast<size_t>(d) * es + 15) / 16 * 16;
  return 2 * bkv * row + sizeof(float) * (2 * static_cast<size_t>(rb) * d +
                                          static_cast<size_t>(rb) * bkv + 3 * rb);
}

// One CTA per (rb m rows of a KV head's GQA group, KV head, batch row); m
// row r is (query r / group, head hkid·group + r % group), as in
// attn_fwd_kernel, so the group's heads share every K/V row the CTA reads.
// q is rounded to bf16 as it is staged (f32 in shared memory; the JAX
// kernels' zero padding of d to a multiple of 128 adds nothing and is not
// stored).  Tiles of bkv keys come into shared memory by cp.async of `vec`
// bytes (element loads at vec = 0) through the cache's strides, int8 widened
// exactly where it is read; a warp a (row, key) score, its lanes over d;
// one thread a row's online softmax in f32 (log2 units: exp2), P rounded to
// bf16 before P·V as the JAX bodies round it and l summed from the f32 p;
// one thread a column of O·alpha + P·V.  kv_scale is folded into qk_scale
// and out_scale.  Keys past kv_len (and past a row's position when causal)
// are masked; a row that sees no key outputs 0.  (A two-stage ring, with a
// warp a key for all rows at once, measured slower on the H100.)
template <typename KV>
__global__ void __launch_bounds__(WIDE_THREADS)
attn_wide_kernel(const void* __restrict__ q, int q_dt, long long q_sb, long long q_ss,
                 long long q_sh, const KV* __restrict__ k, long long k_sb, long long k_sh,
                 long long k_ss, const KV* __restrict__ v, long long v_sb, long long v_sh,
                 long long v_ss, const int* __restrict__ q_offset, int off0,
                 const int* __restrict__ kv_len, int len0, void* __restrict__ out, int o_dt,
                 long long o_sb, long long o_ss, long long o_sh, int sq, int hq, int hk, int S,
                 int d, int causal, int vec, int rb, int bkv, float qk_scale, float out_scale) {
  constexpr int ES = static_cast<int>(sizeof(KV));
  extern __shared__ __align__(16) unsigned char wsm[];
  const int row_b = (d * ES + 15) / 16 * 16;            // bytes of a K/V row in shared memory
  unsigned char* kt = wsm;                              // [bkv][row_b]
  unsigned char* vt = wsm + (size_t)bkv * row_b;
  float* qs = reinterpret_cast<float*>(wsm + (size_t)2 * bkv * row_b);   // [rb][d]
  float* os = qs + (size_t)rb * d;                      // [rb][d]
  float* ps = os + (size_t)rb * d;                      // [rb][bkv]: scores, then p
  float* mrow = ps + rb * bkv;                          // [rb] each
  float* lrow = mrow + rb;
  float* alpha = lrow + rb;

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int group = hq / hk, MR = sq * group;
  const int m0 = blockIdx.x * rb, hkid = blockIdx.y, bi = blockIdx.z;
  const int rows = min(rb, MR - m0);
  const int qoff = q_offset ? q_offset[bi] : off0;
  const int L = max(0, min(kv_len ? kv_len[bi] : len0, S));
  const int kend = causal ? max(0, min(L, qoff + (m0 + rows - 1) / group + 1)) : L;
  const KV* kb = k + bi * k_sb + hkid * k_sh;
  const KV* vb = v + bi * v_sb + hkid * v_sh;

  for (int i = tid; i < rows * d; i += WIDE_THREADS) {
    const int r = m0 + i / d, c = i % d;
    qs[i] = __bfloat162float(load_q_bf16(
        q, bi * q_sb + (r / group) * q_ss + (hkid * group + r % group) * q_sh + c, q_dt));
    os[i] = 0.f;
  }
  for (int r = tid; r < rows; r += WIDE_THREADS) {
    mrow[r] = -INFINITY;
    lrow[r] = 0.f;
  }
  const float sl = qk_scale * LOG2E;
  const int pieces = vec ? d * ES / vec : d;            // copies a row

  for (int k0 = 0; k0 < kend; k0 += bkv) {
    const int nk = min(bkv, kend - k0);
    __syncthreads();                                    // the last tile's reads are done
#pragma unroll
    for (int which = 0; which < 2; ++which) {           // K, then V rows k0 .. k0 + nk - 1
      const char* src = reinterpret_cast<const char*>(which ? vb + k0 * v_ss : kb + k0 * k_ss);
      const long long rs = (which ? v_ss : k_ss) * ES;
      unsigned char* dst = which ? vt : kt;
      for (int i = tid; i < nk * pieces; i += WIDE_THREADS) {
        const int j = i / pieces, pc = i % pieces;
        const char* g = src + j * rs;
        unsigned char* sp = dst + (size_t)j * row_b;
        if (vec == 16) cp_async<16>(smem_u32(sp + pc * 16), g + pc * 16, true);
        else if (vec == 8) cp_async<8>(smem_u32(sp + pc * 8), g + pc * 8, true);
        else if (vec == 4) cp_async<4>(smem_u32(sp + pc * 4), g + pc * 4, true);
        else reinterpret_cast<KV*>(sp)[pc] = reinterpret_cast<const KV*>(g)[pc];
      }
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    // the scores: a warp a (row, key), lanes over d
    for (int pr = warp; pr < rows * nk; pr += WIDE_WARPS) {
      const int r = pr / nk, j = pr % nk;
      const float* qr = qs + (size_t)r * d;
      const KV* kr = reinterpret_cast<const KV*>(kt + (size_t)j * row_b);
      float dot = 0.f;
      for (int c = lane; c < d; c += 32) dot = fmaf(qr[c], kv_to_float(kr[c]), dot);
      dot = warp_sum(dot);
      if (lane == 0) {
        const bool seen = !causal || k0 + j <= qoff + (m0 + r) / group;
        ps[r * bkv + j] = seen ? dot * sl : -INFINITY;
      }
    }
    __syncthreads();
    // the online softmax, a thread a row
    for (int r = tid; r < rows; r += WIDE_THREADS) {
      float mx = -INFINITY;
      for (int j = 0; j < nk; ++j) mx = fmaxf(mx, ps[r * bkv + j]);
      const float m_new = fmaxf(mrow[r], mx);
      const float mu = m_new == -INFINITY ? 0.f : m_new;   // no key seen yet: p = 0
      float sum = 0.f;
      for (int j = 0; j < nk; ++j) {
        const float p = exp2f(ps[r * bkv + j] - mu);
        sum += p;
        ps[r * bkv + j] = __bfloat162float(__float2bfloat16_rn(p));
      }
      alpha[r] = exp2f(mrow[r] - mu);
      lrow[r] = lrow[r] * alpha[r] + sum;
      mrow[r] = m_new;
    }
    __syncthreads();
    // O = O·alpha + P·V, a thread a column
    for (int c = tid; c < d; c += WIDE_THREADS)
      for (int r = 0; r < rows; ++r) {
        float o = os[(size_t)r * d + c] * alpha[r];
        for (int j = 0; j < nk; ++j)
          o = fmaf(ps[r * bkv + j],
                   kv_to_float(reinterpret_cast<const KV*>(vt + (size_t)j * row_b)[c]), o);
        os[(size_t)r * d + c] = o;
      }
  }
  __syncthreads();
  for (int i = tid; i < rows * d; i += WIDE_THREADS) {
    const int rr = i / d, c = i % d, r = m0 + rr;
    const float l = lrow[rr];
    store_dt(out, bi * o_sb + (r / group) * o_ss + (hkid * group + r % group) * o_sh + c, o_dt,
             l > 0.f ? os[i] * (out_scale / l) : 0.f);
  }
}

// rb m rows and bkv keys a tile: 8 and 32, fewer keys (down to 8), then fewer
// rows, then fewer keys again where a wide d needs the shared memory
template <typename KV>
int launch_wide(const void* q, int q_dt, const long long* qs, const void* k, const long long* ks,
                const void* v, const long long* vs, const int* q_offset, int off0,
                const int* kv_len, int len0, void* out, int o_dt, const long long* os, int b,
                int sq, int hq, int hk, int S, int d, int causal, int vec, float qk_scale,
                float out_scale, cudaStream_t stream) {
  constexpr int ES = static_cast<int>(sizeof(KV));
  int rb = 8, bkv = 32;
  while (wide_smem(d, ES, rb, bkv) > WIDE_SMEM_MAX && (bkv > 1 || rb > 1)) {
    if (bkv > 8 || rb == 1) bkv /= 2;
    else rb /= 2;
  }
  const size_t smem = wide_smem(d, ES, rb, bkv);
  if (smem > WIDE_SMEM_MAX) return static_cast<int>(cudaErrorInvalidValue);
  auto kern = attn_wide_kernel<KV>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const int MR = sq * (hq / hk);
  kern<<<dim3((MR + rb - 1) / rb, hk, b), WIDE_THREADS, smem, stream>>>(
      q, q_dt, qs[0], qs[1], qs[2], static_cast<const KV*>(k), ks[0], ks[1], ks[2],
      static_cast<const KV*>(v), vs[0], vs[1], vs[2], q_offset, off0, kv_len, len0, out, o_dt,
      os[0], os[1], os[2], sq, hq, hk, S, d, causal, vec, rb, bkv, qk_scale, out_scale);
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

// attn_wide_kernel for any head dim (the wrappers send it d > 256): q and
// out through strides {batch, seq, head}, each bf16, f16 or f32 (q_dt /
// o_dt: 0 / 1 / 2); k/v [b, hk, S, d] through strides {batch, head, seq};
// contiguous d in all; q_offset / kv_len int32 [b], or null for one off0 /
// len0 for every row; causal or not (decode: sq = 1, not causal).  vec:
// bytes per K/V copy (16, 8 or 4; 0: element by element), dividing
// d·sizeof(KV), every row start and stride.  One launch, no scratch.
extern "C" int attention_wide_launch(const void* q, const long long* q_strides, int q_dt,
                                     const void* k, const long long* k_strides, const void* v,
                                     const long long* v_strides, const int* q_offset, int off0,
                                     const int* kv_len, int len0, void* out,
                                     const long long* o_strides, int o_dt, int b, int sq, int hq,
                                     int hk, int S, int d, int kv_int8, int causal, int vec,
                                     float qk_scale, float out_scale, void* stream) {
  const bool ok_vec = vec == 0 || vec == 4 || vec == 8 || vec == 16;
  if (d < 1 || !ok_vec || !valid_dt(q_dt) || !valid_dt(o_dt) || b < 1 || sq < 1 || hk < 1 ||
      hq % hk != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kv_int8)
    return launch_wide<int8_t>(q, q_dt, q_strides, k, k_strides, v, v_strides, q_offset, off0,
                               kv_len, len0, out, o_dt, o_strides, b, sq, hq, hk, S, d, causal,
                               vec, qk_scale, out_scale, st);
  return launch_wide<__nv_bfloat16>(q, q_dt, q_strides, k, k_strides, v, v_strides, q_offset,
                                    off0, kv_len, len0, out, o_dt, o_strides, b, sq, hq, hk, S, d,
                                    causal, vec, qk_scale, out_scale, st);
}
