// Integer GEMM for Hopper (sm_90a): int8 activations × int8 weights, the
// products summed exactly in int32, then the quant_matmul epilogue:
//   y[M,N] = epilogue(Σ_k x[m,k] · q[k,n])
//
// Replaces: csinn2_tpu/kernels/qmatmul.py quant_matmul → _kernel (:116,
// pallas_call :592) on its int_dot path (:212-216, chosen at :484-486: int8 x
// and int8 weights, channel or no scales, not packed [N, K/2]) with
//   * the float epilogue (:261-269): channel scale, epilogue_scale, f32 bias,
//     then f32 / bf16, int8 / uint8 / int16 (clip(round(y) + zp)) or int32
//     (a plain cast) — epilogue.cuh epi_float / store_kind;
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
// K·N/2 packed) plus x and the output; at M = 4 the weight bytes bound it,
// at M = 128 (7B shapes) the operations do, against 1979 TOP/s int8 on the
// tensor cores.  This first version is SIMT: __dp4a (four s8×s8 products
// summed into an s32 per instruction) from shared memory, without tensor
// cores.  A CTA computes a BM × 64 tile (BM = 16 for M <= 16, else 64); per
// 64-deep K step it stages x as words of 4 consecutive k and the weight as
// 64 column rows of 4-k words (the [K, N] layouts are transposed 4 × 4 bytes
// at a time with __byte_perm while staging; [N, K] is already k-contiguous),
// the next step's global loads in flight in registers while this one is
// summed.  Each of the 256 threads owns BM/16 rows × 4 columns (columns tx +
// 16c, so the 16 column lanes read 16 banks apart).  int8 mma.sync
// (m16n8k32, which wants B k-contiguous, as staged here) and TMA are later
// work.
#include "epilogue.cuh"

namespace {

constexpr int W_KN = 0, W_NK = 1, W_PACKED_KN = 2;
constexpr int TBN = 64;           // output columns per CTA
constexpr int TBK = 64;           // k per step
constexpr int KWORDS = TBK / 4;   // 4-k words per row and step
constexpr int SROW = KWORDS + 1;  // padded shared row stride (words)
constexpr int THREADS = 256;

// 4 × 4 byte transpose: r[i] holds bytes (row i, col 0..3) → c[j] holds
// bytes (row 0..3, col j)
__device__ __forceinline__ void transpose4x4(const int r[4], int c[4]) {
  const unsigned t0 = __byte_perm(r[0], r[1], 0x5140), t1 = __byte_perm(r[0], r[1], 0x7362);
  const unsigned t2 = __byte_perm(r[2], r[3], 0x5140), t3 = __byte_perm(r[2], r[3], 0x7362);
  c[0] = __byte_perm(t0, t2, 0x5410);
  c[1] = __byte_perm(t0, t2, 0x7632);
  c[2] = __byte_perm(t1, t3, 0x5410);
  c[3] = __byte_perm(t1, t3, 0x7632);
}

// the four sign-extended low (high) nibbles of a packed word, as int8 bytes
__device__ __forceinline__ int lo_nibbles(int v) {
  return static_cast<int>(__vsub4((static_cast<unsigned>(v) & 0x0F0F0F0Fu) ^ 0x08080808u,
                                  0x08080808u));
}
__device__ __forceinline__ int hi_nibbles(int v) {
  return static_cast<int>(
      __vsub4(((static_cast<unsigned>(v) >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u, 0x08080808u));
}

struct Requant {
  const int* rq;           // [2, N] int32: multiplier, shift; null for the float epilogue
  const int* bias_i32;     // [N] or null (with rq)
  int qmin, qmax;
};

template <int BM, int WL>
__global__ void __launch_bounds__(THREADS)
qmm_i8_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w, void* __restrict__ out,
              int M, int N, int K, Epi ep, Requant rq) {
  constexpr int RM = BM / 16;             // rows per thread
  constexpr int X_WORDS = BM * KWORDS / THREADS > 0 ? BM * KWORDS / THREADS : 1;
  __shared__ int xs[BM * SROW];
  __shared__ int ws[TBN * SROW];

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * TBN;

  // staging roles.  x: thread t loads word t (+ THREADS) of the BM × KWORDS tile
  // (BM = 16: only t < 256 = 16 × 16).  W_NK: row t/4, 16 bytes at (t%4)·16.
  // W_KN: k rows 4·(t/16)..+3, columns 4·(t%16)..+3.  W_PACKED_KN (t < 128):
  // byte rows 4·((t/16)%4)..+3 of block (t/64), columns 4·(t%16)..+3.
  int xr[X_WORDS];
  int wr[4];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int i = 0; i < X_WORDS; ++i) {
      const int idx = tid + i * THREADS;
      const int r = idx / KWORDS, c = idx % KWORDS;
      const int m = m0 + r, k = k0 + c * 4;
      xr[i] = (r < BM && m < M && k < K)
                  ? __ldg(reinterpret_cast<const int*>(x + (size_t)m * K + k)) : 0;
    }
    if constexpr (WL == W_NK) {
      const int n = n0 + tid / 4, k = k0 + (tid % 4) * 16;
      int4 v = make_int4(0, 0, 0, 0);
      if (n < N && k < K) v = __ldg(reinterpret_cast<const int4*>(w + (size_t)n * K + k));
      wr[0] = v.x; wr[1] = v.y; wr[2] = v.z; wr[3] = v.w;
    } else if constexpr (WL == W_KN) {
      const int k = k0 + (tid / 16) * 4, n = n0 + (tid % 16) * 4;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wr[i] = (k + i < K && n < N)
                    ? __ldg(reinterpret_cast<const int*>(w + (size_t)(k + i) * N + n)) : 0;
    } else {
      const int blk = tid / 64, j0 = ((tid / 16) % 4) * 4, n = n0 + (tid % 16) * 4;
      const int kb = k0 / 32 + blk;      // quant block
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wr[i] = (tid < 128 && kb * 32 < K && n < N)
                    ? __ldg(reinterpret_cast<const int*>(w + ((size_t)kb * 16 + j0 + i) * N + n))
                    : 0;
    }
  };
  auto stage = [&]() {
#pragma unroll
    for (int i = 0; i < X_WORDS; ++i) {
      const int idx = tid + i * THREADS;
      const int r = idx / KWORDS, c = idx % KWORDS;
      if (r < BM) xs[r * SROW + c] = xr[i];
    }
    if constexpr (WL == W_NK) {
#pragma unroll
      for (int i = 0; i < 4; ++i) ws[(tid / 4) * SROW + (tid % 4) * 4 + i] = wr[i];
    } else if constexpr (WL == W_KN) {
      int c[4];
      transpose4x4(wr, c);
#pragma unroll
      for (int j = 0; j < 4; ++j) ws[((tid % 16) * 4 + j) * SROW + tid / 16] = c[j];
    } else if (tid < 128) {
      const int blk = tid / 64, j0 = ((tid / 16) % 4) * 4;
      int lo[4], hi[4], c[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        lo[i] = lo_nibbles(wr[i]);
        hi[i] = hi_nibbles(wr[i]);
      }
      transpose4x4(lo, c);     // rows blk·32 + j0 .. +3
#pragma unroll
      for (int j = 0; j < 4; ++j) ws[((tid % 16) * 4 + j) * SROW + (blk * 32 + j0) / 4] = c[j];
      transpose4x4(hi, c);     // rows blk·32 + 16 + j0 .. +3
#pragma unroll
      for (int j = 0; j < 4; ++j)
        ws[((tid % 16) * 4 + j) * SROW + (blk * 32 + 16 + j0) / 4] = c[j];
    }
  };

  int acc[RM][4];
#pragma unroll
  for (int r = 0; r < RM; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0;

  fetch(0);
  for (int k0 = 0; k0 < K; k0 += TBK) {
    stage();
    __syncthreads();
    if (k0 + TBK < K) fetch(k0 + TBK);    // in flight while this step is summed
#pragma unroll
    for (int kw = 0; kw < KWORDS; ++kw) {
      int a[RM], b[4];
#pragma unroll
      for (int r = 0; r < RM; ++r) a[r] = xs[(ty + 16 * r) * SROW + kw];
#pragma unroll
      for (int c = 0; c < 4; ++c) b[c] = ws[(tx + 16 * c) * SROW + kw];
#pragma unroll
      for (int r = 0; r < RM; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = __dp4a(a[r], b[c], acc[r][c]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < RM; ++r) {
    const int m = m0 + ty + 16 * r;
    if (m >= M) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int n = n0 + tx + 16 * c;
      if (n >= N) continue;
      const size_t idx = (size_t)m * N + n;
      if (rq.rq != nullptr) {
        // int32 bias first, wrapping as the TPU's int32 add
        const int a = rq.bias_i32 != nullptr
                          ? static_cast<int>(static_cast<unsigned>(acc[r][c]) +
                                             static_cast<unsigned>(rq.bias_i32[n]))
                          : acc[r][c];
        const int y = requant_fixed(a, rq.rq[n], rq.rq[N + n], static_cast<int>(ep.zp),
                                    rq.qmin, rq.qmax);
        switch (ep.out_kind) {
          case OUT_I8: static_cast<int8_t*>(out)[idx] = static_cast<int8_t>(y); break;
          case OUT_U8: static_cast<uint8_t*>(out)[idx] = static_cast<uint8_t>(y); break;
          default: static_cast<int16_t*>(out)[idx] = static_cast<int16_t>(y); break;
        }
      } else {
        store_kind(out, idx, epi_float(static_cast<float>(acc[r][c]), n, ep), ep);
      }
    }
  }
}

template <int BM>
void launch_i8(int layout, const int8_t* x, const int8_t* w, void* out, int M, int N, int K,
               const Epi& ep, const Requant& rq, cudaStream_t st) {
  dim3 grid((N + TBN - 1) / TBN, (M + BM - 1) / BM);
  if (layout == W_NK)
    qmm_i8_kernel<BM, W_NK><<<grid, THREADS, 0, st>>>(x, w, out, M, N, K, ep, rq);
  else if (layout == W_KN)
    qmm_i8_kernel<BM, W_KN><<<grid, THREADS, 0, st>>>(x, w, out, M, N, K, ep, rq);
  else
    qmm_i8_kernel<BM, W_PACKED_KN><<<grid, THREADS, 0, st>>>(x, w, out, M, N, K, ep, rq);
}

}  // namespace

// x int8 [M,K]; w int8 [K,N] (layout 0), [N,K] (1) or packed [K/2,N] (2);
// ch_scale f32 [N] or null; bias f32 [N] (float epilogue) or int32 [N] (with
// rq), or null; rq int32 [2,N] (multiplier, shift) or null; out [M,N] of
// out_kind (epilogue.cuh OutKind; with rq: int8, uint8 or int16).
// K % 16 == 0 (packed: % 32), N % 16 == 0, all pointers 16-byte aligned.
extern "C" int quant_matmul_int8dot(const void* x, const void* w, int layout,
                                    const void* ch_scale, const void* bias, const void* rq,
                                    void* out, int out_kind, float e, int has_e, float zp,
                                    int M, int N, int K, void* stream) {
  if (rq != nullptr && (out_kind < OUT_I8 || out_kind > OUT_I16))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool with_rq = rq != nullptr;
  Epi ep{static_cast<const float*>(ch_scale), with_rq ? nullptr : static_cast<const float*>(bias),
         e, has_e, zp, out_kind};
  const int qmin = out_kind == OUT_I8 ? -128 : (out_kind == OUT_U8 ? 0 : -32768);
  const int qmax = out_kind == OUT_I8 ? 127 : (out_kind == OUT_U8 ? 255 : 32767);
  Requant r{static_cast<const int*>(rq), with_rq ? static_cast<const int*>(bias) : nullptr,
            qmin, qmax};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* xp = static_cast<const int8_t*>(x);
  const int8_t* wp = static_cast<const int8_t*>(w);
  if (M <= 16) launch_i8<16>(layout, xp, wp, out, M, N, K, ep, r, st);
  else launch_i8<64>(layout, xp, wp, out, M, N, K, ep, r, st);
  return static_cast<int>(cudaGetLastError());
}
