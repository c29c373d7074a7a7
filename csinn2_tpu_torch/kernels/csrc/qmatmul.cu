// Q8_0 block-scaled dequant GEMM for Hopper (sm_90a):
//   y[M,N] = x[M,K] · (w_q[K,N] ⊙ s[K/32,N] repeated over each 32-row K block)
//            (+ bias[N]),  f32 accumulation, bf16 or f32 output.
//
// Replaces: csinn2_tpu/kernels/qmatmul.py quant_matmul → _kernel, scale mode
// "block" (the Q8_0 path of every Llama linear: wqkv, wo, w13, w2, lm_head).
//
// Numerics follow the f32 reference quant_matmul_ref, x · (q · s) with f32
// accumulation: the decode kernel forms q · s in f32 per weight; the prefill
// kernel forms the exact products x · q on the tensor cores and applies each
// 32-row block's f32 scale to that block's f32 partial sum — the same sum up
// to f32 rounding order.  x is bf16, as on the TPU.
//
// Bound: at decode (M <= 16) the int8 weight stream — K·N bytes read once
// against 2·M·K·N flops.  qmm_decode_kernel serves it: one CTA covers all M
// rows of its 128-column strip, so the weight is read exactly once, and K is
// split across CTAs (split-K, sized by plan_split_k below; a second small
// kernel sums the partials) until the grid fills the card.  At prefill
// (M > 16) the 2·M·K·N flops bound it: qmm_mma_kernel stages each 32-row quant block (int8 → bf16, exact) and
// the x tile in shared memory and runs mma.sync bf16 tensor-core tiles with
// the block scales applied in f32 per block.  wgmma/TMA pipelines are later
// work.
#include <algorithm>

#include "common.cuh"

namespace {

constexpr int BK = 32;
constexpr int BN = 128;
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

// d += a · b on the tensor cores: m16n8k16, bf16 inputs, f32 accumulate
__device__ __forceinline__ void mma_bf16(float d[4], const uint32_t a[4], const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

constexpr int MMA_BM = 64;
constexpr int XS_STRIDE = BK + 8;   // bf16 elements per smem row: conflict-free ldmatrix
constexpr int WS_STRIDE = BN + 8;

// Prefill variant (M > 16): 64 × 128 output tile, 8 warps of 32 × 32.  Per
// 32-row quant block the int8 weights are staged in shared memory as bf16
// (exact), x stays bf16, and the tensor cores form the block's partial
// product P = x · q with exact products and f32 accumulation; the block's
// f32 column scales then fold in as acc += s · P.  That equals the
// reference's x · (q · s) up to f32 summation order.
template <typename OutT>
__global__ void __launch_bounds__(THREADS)
qmm_mma_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ w,
               const float* __restrict__ s, const float* __restrict__ bias,
               OutT* __restrict__ out, float* __restrict__ partial,
               int M, int N, int K, int blocks_per_split) {
  __shared__ __align__(16) __nv_bfloat16 xs[MMA_BM * XS_STRIDE];
  __shared__ __align__(16) __nv_bfloat16 ws[BK * WS_STRIDE];
  __shared__ __align__(16) float ss[BN];

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wm = warp / 4, wn = warp % 4;      // warp tile rows wm*32, cols wn*32
  const int g = lane / 4, tig = lane % 4;      // mma fragment coordinates
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * MMA_BM;
  const int kb_begin = blockIdx.z * blocks_per_split;
  const int kb_end = min(K / BK, kb_begin + blocks_per_split);

  // loader roles (N % 16 == 0 and 16-byte aligned rows: checked by the wrapper)
  const int wr = tid / 8, wc = (tid % 8) * 16;           // 16 weights
  const bool w_ok = n0 + wc < N;
  const int xr = tid / 4, xc = (tid % 4) * 8;            // 8 activations
  const bool x_ok = m0 + xr < M;
  const bool s_loader = tid < BN / 4;                    // 4 scales
  const bool s_ok = s_loader && n0 + tid * 4 < N;

  int4 w_reg = make_int4(0, 0, 0, 0);
  uint4 x_reg = make_uint4(0, 0, 0, 0);
  float4 s_reg = make_float4(0.f, 0.f, 0.f, 0.f);
  auto fetch = [&](int kb) {
    const int k0 = kb * BK;
    if (w_ok)
      w_reg = __ldg(reinterpret_cast<const int4*>(w + (size_t)(k0 + wr) * N + n0 + wc));
    if (x_ok)
      x_reg = __ldg(reinterpret_cast<const uint4*>(x + (size_t)(m0 + xr) * K + k0 + xc));
    if (s_ok)
      s_reg = __ldg(reinterpret_cast<const float4*>(s + (size_t)kb * N + n0 + tid * 4));
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
      const int8_t* q = reinterpret_cast<const int8_t*>(&w_reg);
      uint32_t u[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const __nv_bfloat162 h =
            __floats2bfloat162_rn(static_cast<float>(q[2 * i]), static_cast<float>(q[2 * i + 1]));
        u[i] = *reinterpret_cast<const uint32_t*>(&h);
      }
      uint4* dst = reinterpret_cast<uint4*>(&ws[wr * WS_STRIDE + wc]);
      dst[0] = make_uint4(u[0], u[1], u[2], u[3]);
      dst[1] = make_uint4(u[4], u[5], u[6], u[7]);
    }
    if (s_loader) *reinterpret_cast<float4*>(&ss[tid * 4]) = s_reg;
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
        ldmatrix_x4(r, &ws[(kk + lane % 8 + ((lane / 8) % 2) * 8) * WS_STRIDE + wn * 32 +
                           jj * 16 + (lane / 16) * 8],
                    true);
        b[2 * jj][0] = r[0]; b[2 * jj][1] = r[1];
        b[2 * jj + 1][0] = r[2]; b[2 * jj + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_bf16(p[i][j], a[i], b[j]);
    }
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
        const float v0 = acc[i][j][2 * half], v1 = acc[i][j][2 * half + 1];
        if (partial != nullptr) {
          float* dst = partial + ((size_t)blockIdx.z * M + row) * N + col;
          dst[0] = v0;
          dst[1] = v1;
        } else {
          OutT* dst = out + (size_t)row * N + col;
          store_out(dst, v0 + (bias != nullptr ? bias[col] : 0.f));
          store_out(dst + 1, v1 + (bias != nullptr ? bias[col + 1] : 0.f));
        }
      }
    }
}

// Decode variant (M <= 16): no shared-memory staging of the weight, since
// each weight is used by exactly one thread.  Thread (tx, tk) owns columns
// tx*8 .. tx*8+7 and rows 2·tk, 2·tk+1 of every 32-row block, for ALL MT
// activation rows, so every weight is loaded and dequantized once (q · s in
// f32) and feeds MT FMAs.  U blocks are loaded into registers before any is
// used, keeping 64 bytes of weight per thread in flight.  The 16 row lanes
// are summed at the end (a shuffle within each warp, then shared memory).
template <int MT, typename OutT>
__global__ void __launch_bounds__(THREADS)
qmm_decode_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ w,
                  const float* __restrict__ s, const float* __restrict__ bias,
                  OutT* __restrict__ out, float* __restrict__ partial,
                  int M, int N, int K, int blocks_per_split) {
  constexpr int U = MT <= 4 ? 4 : 2;
  __shared__ float red[THREADS / 32][BN];
  const int tid = threadIdx.x;
  const int tx = tid % 16, tk = tid / 16;
  const int lane = tid % 32, warp = tid / 32;
  const int n0 = blockIdx.x * BN;
  const int n = n0 + tx * 8;
  const int kb_begin = blockIdx.z * blocks_per_split;
  const int kb_end = min(K / BK, kb_begin + blocks_per_split);

  float acc[MT][8];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[m][j] = 0.f;

  if (n < N) {
    for (int kb = kb_begin; kb < kb_end; kb += U) {
      int2 wv[U][2];
      float4 sv[U][2];
      __nv_bfloat162 xv[U][MT];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int b = kb + u;
        const int k = b * BK + tk * 2;
        if (b < kb_end) {
          wv[u][0] = __ldg(reinterpret_cast<const int2*>(w + (size_t)k * N + n));
          wv[u][1] = __ldg(reinterpret_cast<const int2*>(w + (size_t)(k + 1) * N + n));
          sv[u][0] = __ldg(reinterpret_cast<const float4*>(s + (size_t)b * N + n));
          sv[u][1] = __ldg(reinterpret_cast<const float4*>(s + (size_t)b * N + n + 4));
#pragma unroll
          for (int m = 0; m < MT; ++m)
            xv[u][m] = m < M ? *reinterpret_cast<const __nv_bfloat162*>(x + (size_t)m * K + k)
                             : __floats2bfloat162_rn(0.f, 0.f);
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (kb + u >= kb_end) break;
        const float sc[8] = {sv[u][0].x, sv[u][0].y, sv[u][0].z, sv[u][0].w,
                             sv[u][1].x, sv[u][1].y, sv[u][1].z, sv[u][1].w};
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int8_t* wb = reinterpret_cast<const int8_t*>(&wv[u][r]);
          float wf[8];
#pragma unroll
          for (int j = 0; j < 8; ++j) wf[j] = static_cast<float>(wb[j]) * sc[j];
#pragma unroll
          for (int m = 0; m < MT; ++m) {
            const float xm = r == 0 ? __low2float(xv[u][m]) : __high2float(xv[u][m]);
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
    if (tid < BN && n0 + tid < N) {
      float v = 0.f;
#pragma unroll
      for (int i = 0; i < THREADS / 32; ++i) v += red[i][tid];
      if (partial != nullptr) {
        partial[((size_t)blockIdx.z * M + m) * N + n0 + tid] = v;
      } else {
        store_out(out + (size_t)m * N + n0 + tid, v + (bias != nullptr ? bias[n0 + tid] : 0.f));
      }
    }
    __syncthreads();
  }
}

// Sum the split-K partials [splits, M, N] (+ bias) into the output.
template <typename OutT>
__global__ void qmm_splitk_reduce(const float* __restrict__ partial,
                                  const float* __restrict__ bias,
                                  OutT* __restrict__ out, int M, int N, int splits) {
  const size_t total = (size_t)M * N;
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  float v = 0.f;
  for (int z = 0; z < splits; ++z) v += partial[z * total + i];
  if (bias != nullptr) v += bias[i % N];
  store_out(out + i, v);
}

template <typename OutT>
void reduce_splits(const void* partial, const void* bias, void* out, int M, int N,
                   int splits, cudaStream_t stream) {
  const size_t total = (size_t)M * N;
  qmm_splitk_reduce<OutT><<<(unsigned)((total + 255) / 256), 256, 0, stream>>>(
      static_cast<const float*>(partial), static_cast<const float*>(bias),
      static_cast<OutT*>(out), M, N, splits);
}

// kernel: qmm_mma_kernel<OutT> (M > 16) or qmm_decode_kernel<MT, OutT> (M <= 16)
template <typename OutT, typename Kernel>
void launch(Kernel kernel, int bm, const void* x, const void* w, const void* s,
            const void* bias, void* out, void* partial, int M, int N, int K, int splits,
            int blocks_per_split, cudaStream_t stream) {
  dim3 grid((N + BN - 1) / BN, (M + bm - 1) / bm, splits);
  const bool split = splits > 1;
  kernel<<<grid, THREADS, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(s), split ? nullptr : static_cast<const float*>(bias),
      static_cast<OutT*>(out), split ? static_cast<float*>(partial) : nullptr,
      M, N, K, blocks_per_split);
  if (split && cudaPeekAtLastError() == cudaSuccess)
    reduce_splits<OutT>(partial, bias, out, M, N, splits, stream);
}

constexpr int DECODE_MAX_M = 16;   // M <= 16: qmm_decode_kernel, one M tile

template <typename OutT>
void dispatch(const void* x, const void* w, const void* s, const void* bias, void* out,
              void* partial, int M, int N, int K, int splits, int bps, cudaStream_t st) {
#define CSINN2_QMM(KERNEL, BM) \
  launch<OutT>(KERNEL, BM, x, w, s, bias, out, partial, M, N, K, splits, bps, st)
  if (M <= 1) CSINN2_QMM((qmm_decode_kernel<1, OutT>), DECODE_MAX_M);
  else if (M <= 2) CSINN2_QMM((qmm_decode_kernel<2, OutT>), DECODE_MAX_M);
  else if (M <= 4) CSINN2_QMM((qmm_decode_kernel<4, OutT>), DECODE_MAX_M);
  else if (M <= 8) CSINN2_QMM((qmm_decode_kernel<8, OutT>), DECODE_MAX_M);
  else if (M <= DECODE_MAX_M) CSINN2_QMM((qmm_decode_kernel<16, OutT>), DECODE_MAX_M);
  else CSINN2_QMM((qmm_mma_kernel<OutT>), MMA_BM);
#undef CSINN2_QMM
}

struct SplitK {
  int splits, blocks_per_split;
};

// Split K across CTAs until the grid holds about 4 CTAs per SM at decode
// (weight-stream bound: more loads in flight) and 2 per SM at prefill.
cudaError_t plan_split_k(int M, int N, int K, int device, SplitK* plan) {
  static int sm_count[64];   // per device, read once
  if (device < 0 || device >= 64) return cudaErrorInvalidDevice;
  if (sm_count[device] == 0) {
    const cudaError_t e =
        cudaDeviceGetAttribute(&sm_count[device], cudaDevAttrMultiProcessorCount, device);
    if (e != cudaSuccess) return e;
  }
  const bool decode = M <= DECODE_MAX_M;
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

}  // namespace

// Floats of f32 workspace that quant_matmul_block needs for [M,K]·[K,N] on
// `device` (the split-K partial sums; 0 when K is not split), or -1 with the
// CUDA error in *err.
extern "C" long long quant_matmul_block_workspace(int M, int N, int K, int device, int* err) {
  SplitK plan;
  *err = static_cast<int>(plan_split_k(M, N, K, device, &plan));
  if (*err != 0) return -1;
  return plan.splits > 1 ? (long long)plan.splits * M * N : 0;
}

// x bf16 [M,K]; w int8 [K,N]; s f32 [K/32,N]; bias f32 [N] or null;
// out [M,N] f32 (out_f32 != 0) or bf16; workspace f32 of workspace_floats
// (at least quant_matmul_block_workspace(M, N, K, device)).  K % 32 == 0,
// N % 16 == 0, all pointers 16-byte aligned.
extern "C" int quant_matmul_block(const void* x, const void* w, const void* s,
                                  const void* bias, void* out, int out_f32, void* workspace,
                                  long long workspace_floats, int M, int N, int K, int device,
                                  void* stream) {
  SplitK plan;
  const cudaError_t e = plan_split_k(M, N, K, device, &plan);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (plan.splits > 1 && (workspace == nullptr ||
                          workspace_floats < (long long)plan.splits * M * N))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (out_f32)
    dispatch<float>(x, w, s, bias, out, workspace, M, N, K, plan.splits,
                    plan.blocks_per_split, st);
  else
    dispatch<__nv_bfloat16>(x, w, s, bias, out, workspace, M, N, K, plan.splits,
                            plan.blocks_per_split, st);
  return static_cast<int>(cudaGetLastError());
}
