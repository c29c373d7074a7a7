// Fused depthwise-separable block: int8 NHWC depthwise k×k → requantize →
// pointwise 1×1 → requantize, in one kernel; the int8 depthwise output never
// leaves shared memory.
//
// Replaces csinn2_tpu/kernels/dsblock.py:164 `fused_dsconv` (Pallas
// `_kernel_s1` :55 and `_kernel_s2` :103).  The TPU kernel splits stride-2
// inputs into even/odd W phases for Mosaic's lane layout; a CUDA thread reads
// strided addresses directly, so one kernel templated on k ∈ {3, 5} and
// stride ∈ {1, 2} covers all four variants, with any pads in 0..k/2 and any
// H, W, C (≤ 1024) and O.
//
// Bound: at MobileNetV1's shapes the pointwise product dominates the work
// (N·Ho·Wo·2·C·O operations against ~N·H·W·C + N·Ho·Wo·O bytes), so the
// block is bound by int8 operations at batch 128 and by bytes only for the
// early, wide-image layers.  This first version is simple and exact, not
// fast: SIMT `__dp4a` (4 int8 MACs per instruction) from shared memory, no
// tensor cores, no TMA (later work, ROADMAP).
//
// Design: one CTA takes TP output pixels of one image and a chunk of the
// output channels.  Phase 1: each thread computes depthwise sums for
// (pixel, channel) pairs in int32 (coalesced over channels), applies the mid
// epilogue and writes int8 into the shared tile mid[TP][C4·4] (channels
// padded to a multiple of 4 with zeros).  Phase 2: for each OT-channel tile
// of the chunk, the CTA packs the pointwise weights [C, O] into shared
// memory as words of 4 channels, w4[C4][OT]; thread (pixel group g, channel
// lane o) accumulates PPT pixels with `__dp4a(mid word, weight word)`: the
// mid word is a warp broadcast, the weight words are consecutive.
//
// Numerics, equal bit for bit to `fused_dsconv_ref` and to the unfused
// torch composition (kernels/qconv.py), which follow the JAX package's
// compiled graph: acc·eff + b is rounded once to f32 (computed in f64: the
// product of an int32 below 2^24 and an f32 is exact there, as in
// `qconv.mul_add`); y/scale is y·(1/scale) with the f32 reciprocal passed
// in; rounding is half to even (rintf); every f32 operation is written
// with an explicit _rn intrinsic, so no flag or contraction changes it.
#include "common.cuh"

namespace {

constexpr int TP = 32;              // output pixels per CTA
constexpr int OT = 64;              // output channels per pointwise tile
constexpr int THREADS = 256;
constexpr int PG = THREADS / OT;    // pixel groups (4)
constexpr int PPT = TP / PG;        // pixels per thread (8)
static_assert(OT % 32 == 0, "a warp must share its pixel group");

struct Args {
  const int8_t* x;      // [N, H, W, C]
  const int8_t* dw;     // [k*k, C]
  const float* effd;    // [C]
  const float* bd;      // [C]
  const int8_t* pw;     // [C, O]
  const float* effp;    // [O]
  const float* bp;      // [O]
  void* out;            // [N, Ho, Wo, O] int8 or f32
  int N, H, W, C, O, Ho, Wo, pt, pl;
  float inv_mid;        // f32 reciprocal of the mid scale
  int mid_act, out_act; // 0 none, 1 relu, 2 relu6
  int out_int8;
  float inv_out, out_zp;
  int o_chunk;          // output channels per CTA (a multiple of OT)
};

__device__ __forceinline__ float act(float y, int a) {
  if (a == 2) return fminf(fmaxf(y, 0.f), 6.f);
  if (a == 1) return fmaxf(y, 0.f);
  return y;
}

// acc·eff + b, rounded once to f32
__device__ __forceinline__ float mul_add(int acc, float eff, float b) {
  return __double2float_rn(__dadd_rn(__dmul_rn(static_cast<double>(acc),
                                               static_cast<double>(eff)),
                                     static_cast<double>(b)));
}

__device__ __forceinline__ float quant(float y, float inv) {
  return rintf(__fmul_rn(y, inv));
}

template <int K, int S>
__global__ void __launch_bounds__(THREADS) dsconv_kernel(const Args a) {
  extern __shared__ int smem[];
  const int C4 = (a.C + 3) >> 2;
  const int CP = C4 * 4;
  int* mid4 = smem;                                  // [TP][C4]
  int* w4 = smem + TP * C4;                          // [C4][OT]
  int8_t* mid = reinterpret_cast<int8_t*>(mid4);
  const int n = blockIdx.y;
  const int p0 = blockIdx.x * TP;
  const int HW = a.Ho * a.Wo;
  const int8_t* xn = a.x + static_cast<size_t>(n) * a.H * a.W * a.C;

  // phase 1: depthwise sums and the mid epilogue, into shared memory
  for (int i = threadIdx.x; i < TP * CP; i += THREADS) {
    const int p = i / CP;
    const int c = i - p * CP;
    const int pix = p0 + p;
    int8_t q = 0;
    if (c < a.C && pix < HW) {
      const int oh = pix / a.Wo;
      const int ih0 = oh * S - a.pt;
      const int iw0 = (pix - oh * a.Wo) * S - a.pl;
      int acc = 0;
#pragma unroll
      for (int dy = 0; dy < K; ++dy) {
        const int ih = ih0 + dy;
        if (ih < 0 || ih >= a.H) continue;
#pragma unroll
        for (int dx = 0; dx < K; ++dx) {
          const int iw = iw0 + dx;
          if (iw < 0 || iw >= a.W) continue;
          acc += static_cast<int>(xn[(static_cast<size_t>(ih) * a.W + iw) * a.C + c]) *
                 static_cast<int>(a.dw[(dy * K + dx) * a.C + c]);
        }
      }
      const float y = act(mul_add(acc, a.effd[c], a.bd[c]), a.mid_act);
      q = static_cast<int8_t>(static_cast<int>(fminf(fmaxf(quant(y, a.inv_mid), -128.f), 127.f)));
    }
    mid[p * CP + c] = q;
  }

  // phase 2: the pointwise product over OT-channel tiles of this CTA's chunk
  const int o_begin = blockIdx.z * a.o_chunk;
  const int o_end = min(a.O, o_begin + a.o_chunk);
  const int ol = threadIdx.x % OT;
  const int pg = threadIdx.x / OT;
  for (int o0 = o_begin; o0 < o_end; o0 += OT) {
    __syncthreads();                   // mid written / previous w4 tile consumed
    for (int i = threadIdx.x; i < C4 * OT; i += THREADS) {
      const int c4 = i / OT;
      const int o = o0 + (i - c4 * OT);
      unsigned v = 0;
      if (o < o_end) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = c4 * 4 + j;
          if (c < a.C)
            v |= static_cast<unsigned>(static_cast<uint8_t>(a.pw[static_cast<size_t>(c) * a.O + o]))
                 << (8 * j);
        }
      }
      w4[i] = static_cast<int>(v);
    }
    __syncthreads();
    int acc[PPT];
#pragma unroll
    for (int j = 0; j < PPT; ++j) acc[j] = 0;
    for (int c4 = 0; c4 < C4; ++c4) {
      const int w = w4[c4 * OT + ol];
#pragma unroll
      for (int j = 0; j < PPT; ++j) acc[j] = __dp4a(mid4[(pg + j * PG) * C4 + c4], w, acc[j]);
    }
    const int o = o0 + ol;
    if (o < o_end) {
      const float e = a.effp[o];
      const float b = a.bp[o];
#pragma unroll
      for (int j = 0; j < PPT; ++j) {
        const int pix = p0 + pg + j * PG;
        if (pix >= HW) continue;
        const size_t idx = (static_cast<size_t>(n) * HW + pix) * a.O + o;
        const float y = act(mul_add(acc[j], e, b), a.out_act);
        if (a.out_int8) {
          const float r = __fadd_rn(quant(y, a.inv_out), a.out_zp);
          static_cast<int8_t*>(a.out)[idx] =
              static_cast<int8_t>(static_cast<int>(fminf(fmaxf(r, -128.f), 127.f)));
        } else {
          static_cast<float*>(a.out)[idx] = y;
        }
      }
    }
  }
}

template <int K, int S>
cudaError_t launch(const Args& a, dim3 grid, size_t smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        dsconv_kernel<K, S>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  dsconv_kernel<K, S><<<grid, THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// Shared memory bytes one CTA needs for C input channels.
extern "C" long long fused_dsconv_smem_bytes(int C) {
  return 4LL * ((C + 3) / 4) * (TP + OT);
}

// x int8 [N,H,W,C]; dw int8 [k*k,C]; effd, bd f32 [C]; pw int8 [C,O];
// effp, bp f32 [O]; out [N,Ho,Wo,O] int8 (out_int8 != 0) or f32.  k ∈ {3,5},
// stride ∈ {1,2}, pt/pl the top/left pads (Ho, Wo carry the bottom/right
// ones); o_chunk a multiple of 64.  Returns cudaGetLastError() after the
// launch (cudaErrorInvalidValue for arguments the kernel does not take).
extern "C" int fused_dsconv_int8(const void* x, const void* dw, const void* effd, const void* bd,
                                 const void* pw, const void* effp, const void* bp, void* out,
                                 int N, int H, int W, int C, int O, int Ho, int Wo, int k,
                                 int stride, int pt, int pl, float inv_mid, int mid_act,
                                 int out_act, int out_int8, float inv_out, float out_zp,
                                 int o_chunk, void* stream) {
  if (N <= 0 || Ho <= 0 || Wo <= 0 || C <= 0 || O <= 0 || o_chunk <= 0 || o_chunk % OT)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{static_cast<const int8_t*>(x), static_cast<const int8_t*>(dw),
         static_cast<const float*>(effd), static_cast<const float*>(bd),
         static_cast<const int8_t*>(pw), static_cast<const float*>(effp),
         static_cast<const float*>(bp), out, N, H, W, C, O, Ho, Wo, pt, pl, inv_mid,
         mid_act, out_act, out_int8, inv_out, out_zp, o_chunk};
  const dim3 grid((Ho * Wo + TP - 1) / TP, N, (O + o_chunk - 1) / o_chunk);
  const size_t smem = static_cast<size_t>(fused_dsconv_smem_bytes(C));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (k == 3 && stride == 1) e = launch<3, 1>(a, grid, smem, st);
  else if (k == 3 && stride == 2) e = launch<3, 2>(a, grid, smem, st);
  else if (k == 5 && stride == 1) e = launch<5, 1>(a, grid, smem, st);
  else if (k == 5 && stride == 2) e = launch<5, 2>(a, grid, smem, st);
  else e = cudaErrorInvalidValue;
  return static_cast<int>(e);
}
