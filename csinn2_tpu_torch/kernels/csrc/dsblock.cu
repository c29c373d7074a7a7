// Fused depthwise-separable block: int8 NHWC depthwise k×k → requantize →
// pointwise 1×1 → requantize, in one kernel; the int8 depthwise output never
// leaves shared memory.
//
// Replaces csinn2_tpu/kernels/dsblock.py:164 `fused_dsconv` (Pallas
// `_kernel_s1` :55 and `_kernel_s2` :103).  The TPU kernel splits stride-2
// inputs into even/odd W phases for Mosaic's lane layout; here the halo tile
// is read at strided addresses, so one kernel templated on k ∈ {3, 5},
// stride ∈ {1, 2} and the pixel tile P ∈ {64, 128} covers all four variants,
// with any pads in 0..k/2, any H, W, C (≤ 1024) and O.
//
// Bound: at MobileNetV1's shapes N·Ho·Wo·(k²·C + 2·C·O) int8 operations
// against ~N·H·W·C + N·Ho·Wo·O bytes; at batch 128 every block is bound by
// its bytes (the input and output activations), by far at the early, wide
// layers.
//
// Design: a CTA takes P consecutive output pixels of the flattened N·Ho·Wo
// (a tile may cross rows and images) and a chunk of the output channels.
//   1. Depthwise.  The global input rows the tile needs (n·H + ih, which lie
//      contiguous in NHWC) come into shared memory by 16-byte cp.async, in
//      chunks of CK channels (a power of two, as wide as shared memory
//      allows; C = 512-1024 takes several); the k² taps are read from there,
//      a thread (pixel, 4 channels) with its taps' weights sign-extended in
//      registers, a shift pair and an IMAD a product.  The mid epilogue writes
//      int8 into the tile mid[P][C], its rows 16 bytes past a multiple of 32
//      so that ldmatrix reads them free of bank conflicts.
//   2. Pointwise.  The weights [O, C] (k-contiguous, the graph weight's own
//      layout) stream through a 3-slot cp.async ring of 64 × KC-byte stages
//      (the first two loaded before phase 1), so each stage serves all P
//      pixels; mma.sync m16n8k32 s8 with mid as A and the weights as B, a
//      warp a 32-pixel × 64/(8·32/P)-channel tile; each 64-channel tile's
//      out epilogue goes through shared memory to 16-byte stores.
//
// Numerics, equal bit for bit to `fused_dsconv_ref` and to the unfused
// torch composition (kernels/qconv.py), which follow the JAX package's
// compiled graph: acc·eff + b is rounded once to f32 (computed in f64: the
// product of an int32 below 2^24 and an f32 is exact there, as in
// `qconv.mul_add`); y/scale is y·(1/scale) with the f32 reciprocal passed
// in; rounding is half to even; every f32 operation is written with an
// explicit _rn intrinsic, so no flag or contraction changes it.  The sums are
// exact int32 (tensor cores included).
#include "common.cuh"
#include "int8_frag.cuh"   // mma_s8

namespace {

constexpr int OT = 64;              // output channels of a pointwise tile
constexpr int THREADS = 256;
constexpr int STAGES = 3;           // weight ring slots, loaded 2 ahead
constexpr int SMEM_LIMIT = 232448;  // dynamic shared memory a CTA may have

struct Args {
  const int8_t* x;      // [N, H, W, C]
  const int8_t* dw;     // [k*k, C]
  const float* effd;    // [C]
  const float* bd;      // [C]
  const int8_t* pw;     // [O, C]
  const float* effp;    // [O]
  const float* bp;      // [O]
  void* out;            // [N, Ho, Wo, O] int8 or f32
  int N, H, W, C, O, Ho, Wo, pt, pl;
  float inv_mid;        // f32 reciprocal of the mid scale
  int mid_act, out_act; // 0 none, 1 relu, 2 relu6
  int out_int8;
  float inv_out, out_zp;
  int o_chunk;          // output channels per CTA (a multiple of OT)
  int ck;               // depthwise channel chunk (a power of two, 4 .. 1024)
  int halo_rows;        // input rows a tile's halo holds (its bound)
  int kc;               // pointwise k chunk (a multiple of 32)
};

// The shared-memory carve of a CTA (bytes, each region 16-byte aligned)
struct Layout {
  int cp, mid_stride, w_stride, out_stride;
  int mid, ring, outs, halo, dwc, pix, total;
};

__host__ __device__ __forceinline__ Layout layout_of(int P, int C, int W, int ck, int halo_rows,
                                                     int kc, int k) {
  Layout l;
  l.cp = (C + 31) / 32 * 32;        // channels padded to whole k32 steps (zeros)
  l.mid_stride = l.cp + 16;         // an odd multiple of 16: conflict-free ldmatrix
  l.w_stride = kc + 16;
  l.out_stride = OT + 16;
  l.mid = 0;
  l.ring = l.mid + P * l.mid_stride;
  l.outs = l.ring + STAGES * OT * l.w_stride;
  l.halo = l.outs + P * l.out_stride;
  l.dwc = l.halo + (halo_rows * W * ck + 15) / 16 * 16;
  l.pix = l.dwc + (k * k * ck + 15) / 16 * 16;
  l.total = l.pix + P * 16;         // a pixel's halo row, ih and iw of tap (0, 0)
  return l;
}

__device__ __forceinline__ float act(float y, int a) {
  if (a == 2) return fminf(fmaxf(y, 0.f), 6.f);
  if (a == 1) return fmaxf(y, 0.f);
  return y;
}

// The conversion pipe (16 results a clock an SM) bounds the epilogues, so
// each element takes one conversion (f64 → f32) where the plain form took
// four: an int32 is exact in f64 as (2^52 + 2^31 + v) − (2^52 + 2^31), built
// from its bits and one DADD; rint(x) for |x| < 2^22 is (x + 1.5·2^23) −
// 1.5·2^23 in f32 (round to nearest even), and that sum's low bits are the
// integer.
constexpr float ROUND_MAGIC = 12582912.f;   // 1.5·2^23
constexpr int ROUND_MAGIC_BITS = 0x4B400000;

__device__ __forceinline__ double int_to_double(int v) {
  return __dsub_rn(__hiloint2double(0x43300000, v ^ 0x80000000), 4503601774854144.0);
}

// acc·eff + b, rounded once to f32 (the f64 path of qconv.mul_add)
__device__ __forceinline__ float mul_add(int acc, double eff, double b) {
  return __double2float_rn(__dadd_rn(__dmul_rn(int_to_double(acc), eff), b));
}

// clip(rint(y · inv), -128, 127) as an int (clipping first gives the same)
__device__ __forceinline__ int quant_i8(float y, float inv) {
  const float c = fminf(fmaxf(__fmul_rn(y, inv), -128.f), 127.f);
  return __float_as_int(__fadd_rn(c, ROUND_MAGIC)) - ROUND_MAGIC_BITS;
}

// clip(rint(y · inv) + zp, -128, 127) cast to int (truncating, as the plain
// version's cast of a float that a fractional zp leaves fractional)
__device__ __forceinline__ int quant_out(float y, float inv, float zp) {
  const float v = fminf(fmaxf(__fmul_rn(y, inv), -4194304.f), 4194304.f);
  const float r = __fadd_rn(__fadd_rn(v, ROUND_MAGIC), -ROUND_MAGIC);   // rint(v)
  return __float2int_rz(fminf(fmaxf(__fadd_rn(r, zp), -128.f), 127.f));
}

// byte j of v, sign-extended
__device__ __forceinline__ int sext_byte(int v, int j) {
  return (v << (24 - 8 * j)) >> 24;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

template <int K, int S, int P>
__global__ void __launch_bounds__(THREADS) dsconv_kernel(const Args a) {
  constexpr int WARPS_M = P / 32, WARPS_N = 8 / WARPS_M;   // warps over pixels × channels
  constexpr int WN = OT / WARPS_N, NT8 = WN / 8;           // a warp's channels, its n8 tiles
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = layout_of(P, a.C, a.W, a.ck, a.halo_rows, a.kc, K);
  int8_t* mid = reinterpret_cast<int8_t*>(smem + L.mid);
  int8_t* halo = reinterpret_cast<int8_t*>(smem + L.halo);
  int8_t* dwc = reinterpret_cast<int8_t*>(smem + L.dwc);
  int8_t* outs = reinterpret_cast<int8_t*>(smem + L.outs);
  int4* pix_info = reinterpret_cast<int4*>(smem + L.pix);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int HW = a.Ho * a.Wo;
  const int NP = a.N * HW;
  const int p0 = blockIdx.x * P;
  const int o_begin = blockIdx.y * a.o_chunk;
  const int o_end = min(a.O, o_begin + a.o_chunk);
  const int n_kc = (L.cp + a.kc - 1) / a.kc;
  const int n_st = (o_end - o_begin + OT - 1) / OT * n_kc;    // pointwise stages

  // pointwise stage s: the weights of channels o_begin + (s / n_kc)·OT ..
  // +63, k chunk s % n_kc, zero past o_end and C
  auto load_w = [&](int s) {
    int8_t* dst = reinterpret_cast<int8_t*>(smem + L.ring) + (s % STAGES) * OT * L.w_stride;
    const int o0 = o_begin + (s / n_kc) * OT, c0 = (s % n_kc) * a.kc;
    if (a.C % 16 == 0) {
      const int ch = a.kc / 16;
      for (int i = tid; i < OT * ch; i += THREADS) {
        const int r = i / ch, c = c0 + (i % ch) * 16;
        const bool ok = o0 + r < o_end && c < a.C;
        cp_async16(dst + r * L.w_stride + (c - c0), ok ? a.pw + (size_t)(o0 + r) * a.C + c : a.pw,
                   ok);
      }
    } else {                 // rows not 16-byte aligned: bytes, published by the ring's barrier
      for (int i = tid; i < OT * a.kc; i += THREADS) {
        const int r = i / a.kc, c = c0 + i % a.kc;
        dst[r * L.w_stride + (c - c0)] =
            o0 + r < o_end && c < a.C ? a.pw[(size_t)(o0 + r) * a.C + c] : 0;
      }
    }
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_st) load_w(s);
    cp_async_commit();
  }

  // phase 1: the halo rows of the tile, then the depthwise sums and the mid
  // epilogue into mid[P][cp]
  const int g0 = p0 / a.Wo, g1 = (min(p0 + P, NP) - 1) / a.Wo;   // global output rows
  const int r_lo = g0 / a.Ho * a.H + max(0, g0 % a.Ho * S - a.pt);
  const int r_hi = g1 / a.Ho * a.H + min(a.H - 1, g1 % a.Ho * S - a.pt + K - 1);
  const int rows = r_hi - r_lo + 1;                               // <= a.halo_rows
  const int cq = a.ck / 4;                                        // channel quads of a chunk
  const int q = tid % cq;                                         // THREADS % cq == 0
  for (int p = tid; p < P; p += THREADS) {
    const int pix = p0 + p, n = pix / HW, rem = pix - n * HW, oh = rem / a.Wo;
    const int ih0 = oh * S - a.pt;
    pix_info[p] = make_int4(n * a.H + ih0 - r_lo, ih0, (rem - oh * a.Wo) * S - a.pl, pix < NP);
  }
  for (int c0 = 0; c0 < L.cp; c0 += a.ck) {
    if (a.C % 16 == 0 && a.ck % 16 == 0) {
      const int ch = a.ck / 16, total = rows * a.W * ch;
      for (int i = tid; i < total; i += THREADS) {
        const int pos = i / ch, c = c0 + (i % ch) * 16;
        const bool ok = c < a.C;
        cp_async16(halo + pos * a.ck + (c - c0),
                   ok ? a.x + ((size_t)r_lo * a.W + pos) * a.C + c : a.x, ok);
      }
    } else {
      const int total = rows * a.W * a.ck;
      for (int i = tid; i < total; i += THREADS) {
        const int pos = i / a.ck, c = c0 + i % a.ck;
        halo[i] = c < a.C ? a.x[((size_t)r_lo * a.W + pos) * a.C + c] : 0;
      }
    }
    cp_async_commit();
    for (int i = tid; i < K * K * a.ck; i += THREADS) {
      const int t = i / a.ck, c = c0 + i % a.ck;
      dwc[i] = c < a.C ? a.dw[t * a.C + c] : 0;
    }
    cp_async_wait<0>();
    __syncthreads();
    const int c = c0 + 4 * q;                  // this thread's 4 channels
    int wv[K * K][4];
#pragma unroll
    for (int t = 0; t < K * K; ++t) {
      const int v = *reinterpret_cast<const int*>(dwc + t * a.ck + 4 * q);
#pragma unroll
      for (int j = 0; j < 4; ++j) wv[t][j] = sext_byte(v, j);
    }
    double ed[4], bdv[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      ed[j] = c + j < a.C ? a.effd[c + j] : 0.f;
      bdv[j] = c + j < a.C ? a.bd[c + j] : 0.f;
    }
    // pixel p's 4 channels as an int8 word (zeros past NP and C)
    auto dw_word = [&](int p) {
      const int4 pi = pix_info[p];            // halo row, ih and iw of tap (0, 0); valid
      unsigned word = 0;
      if (pi.w) {
        const int lr0 = pi.x, ih0 = pi.y, iw0 = pi.z;
        // every tap loads from a valid halo address and outside taps
        // select zero, so the k² loads issue together (no branch)
        int acc[4] = {0, 0, 0, 0};
#pragma unroll
        for (int dy = 0; dy < K; ++dy) {
          const bool row_ok = static_cast<unsigned>(ih0 + dy) < static_cast<unsigned>(a.H);
          const int8_t* hrow = halo + ((row_ok ? lr0 + dy : 0) * a.W) * a.ck + 4 * q;
#pragma unroll
          for (int dx = 0; dx < K; ++dx) {
            const int iw = iw0 + dx;
            const bool ok = row_ok && static_cast<unsigned>(iw) < static_cast<unsigned>(a.W);
            const int v = *reinterpret_cast<const int*>(hrow + (ok ? iw : 0) * a.ck);
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[j] += sext_byte(ok ? v : 0, j) * wv[dy * K + dx][j];
          }
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (c + j >= a.C) continue;
          const float y = act(mul_add(acc[j], ed[j], bdv[j]), a.mid_act);
          word |= static_cast<unsigned>(quant_i8(y, a.inv_mid) & 0xFF) << (8 * j);
        }
      }
      return word;
    };
    const int pstep = THREADS / cq;
    for (int p = tid / cq; p < P; p += 2 * pstep) {  // two pixels in flight a thread
      const unsigned w0 = dw_word(p);
      const unsigned w1 = p + pstep < P ? dw_word(p + pstep) : 0u;
      if (c < L.cp) {
        *reinterpret_cast<unsigned*>(mid + p * L.mid_stride + c) = w0;
        if (p + pstep < P) *reinterpret_cast<unsigned*>(mid + (p + pstep) * L.mid_stride + c) = w1;
      }
    }
    __syncthreads();                           // mid written; the halo free for the next chunk
  }

  // phase 2: the pointwise product, stage after stage of the weight ring
  const int g = lane / 4, tig = lane % 4;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  int acc[2][NT8][4];
  const int8_t* a_row = mid + (wm * 32 + (lane & 15)) * L.mid_stride + 16 * (lane >> 4);
  const int b_off = (wn * WN + 8 * (lane >> 4) + (lane & 7)) * L.w_stride + 16 * ((lane >> 3) & 1);
  for (int t = 0; t < n_st; ++t) {
    cp_async_wait<STAGES - 2>();               // stage t has landed
    __syncthreads();                           // ... for every thread; stage t-1's slot is free
    if (t + STAGES - 1 < n_st) load_w(t + STAGES - 1);
    cp_async_commit();
    const int kt = t % n_kc, c0 = kt * a.kc;
    if (kt == 0) {
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0;
    }
    const int8_t* ws = reinterpret_cast<const int8_t*>(smem + L.ring) + (t % STAGES) * OT * L.w_stride;
    for (int kk = 0; kk < a.kc && c0 + kk < L.cp; kk += 32) {
      uint32_t af[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) ldmatrix_x4(af[mt], a_row + 16 * mt * L.mid_stride + c0 + kk);
#pragma unroll
      for (int pr = 0; pr < NT8 / 2; ++pr) {
        uint32_t b[4];                         // n8 tiles 2pr (b[0], b[1]) and 2pr + 1
        ldmatrix_x4(b, ws + b_off + 16 * pr * L.w_stride + kk);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mma_s8(acc[mt][2 * pr], af[mt], b);
          mma_s8(acc[mt][2 * pr + 1], af[mt], b + 2);
        }
      }
    }
    if (kt != n_kc - 1) continue;
    // the out epilogue of channels o0 .. o0+63: acc[mt][nt][e] is pixel
    // wm·32 + 16mt + g + 8(e >> 1), channel o0 + wn·WN + 8nt + 2tig + (e & 1)
    const int o0 = o_begin + (t / n_kc) * OT;
#pragma unroll
    for (int nt = 0; nt < NT8; ++nt) {
      const int oc = wn * WN + 8 * nt + 2 * tig;
      double e[2], b[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        e[h] = o0 + oc + h < o_end ? a.effp[o0 + oc + h] : 0.f;
        b[h] = o0 + oc + h < o_end ? a.bp[o0 + oc + h] : 0.f;
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int rh = 0; rh < 2; ++rh) {
          const int p = wm * 32 + 16 * mt + g + 8 * rh;
          float y[2];
#pragma unroll
          for (int h = 0; h < 2; ++h) y[h] = act(mul_add(acc[mt][nt][2 * rh + h], e[h], b[h]), a.out_act);
          if (a.out_int8) {
            int v[2];
#pragma unroll
            for (int h = 0; h < 2; ++h) v[h] = quant_out(y[h], a.inv_out, a.out_zp);
            *reinterpret_cast<uint16_t*>(outs + p * L.out_stride + oc) =
                static_cast<uint16_t>((v[0] & 0xFF) | ((v[1] & 0xFF) << 8));
          } else if (p0 + p < NP) {
            float* dst = static_cast<float*>(a.out) + (size_t)(p0 + p) * a.O + o0 + oc;
#pragma unroll
            for (int h = 0; h < 2; ++h)
              if (o0 + oc + h < o_end) dst[h] = y[h];
          }
        }
    }
    if (a.out_int8) {
      __syncthreads();
      const int width = min(OT, o_end - o0);
      if (a.O % 16 == 0) {                     // o0 and width multiples of 16
        for (int i = tid; i < P * (OT / 16); i += THREADS) {
          const int p = i / (OT / 16), c = (i % (OT / 16)) * 16;
          if (p0 + p < NP && c < width)
            *reinterpret_cast<int4*>(static_cast<int8_t*>(a.out) + (size_t)(p0 + p) * a.O + o0 + c) =
                *reinterpret_cast<const int4*>(outs + p * L.out_stride + c);
        }
      } else {
        for (int i = tid; i < P * OT; i += THREADS) {
          const int p = i / OT, c = i % OT;
          if (p0 + p < NP && c < width)
            static_cast<int8_t*>(a.out)[(size_t)(p0 + p) * a.O + o0 + c] = outs[p * L.out_stride + c];
        }
      }
    }
  }
  cp_async_wait<0>();
}

template <int K, int S, int P>
cudaError_t launch(const Args& a, dim3 grid, int smem, cudaStream_t stream) {
  const cudaError_t e = cudaFuncSetAttribute(
      dsconv_kernel<K, S, P>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  dsconv_kernel<K, S, P><<<grid, THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int P>
cudaError_t launch_p(const Args& a, int k, int stride, dim3 grid, int smem, cudaStream_t st) {
  if (k == 3 && stride == 1) return launch<3, 1, P>(a, grid, smem, st);
  if (k == 3 && stride == 2) return launch<3, 2, P>(a, grid, smem, st);
  if (k == 5 && stride == 1) return launch<5, 1, P>(a, grid, smem, st);
  if (k == 5 && stride == 2) return launch<5, 2, P>(a, grid, smem, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// Dynamic shared memory of a CTA of P pixels (kernels/dsblock.py ds_plan
// mirrors it): mid, the weight ring, the out tile, the halo and the
// depthwise weights of a chunk.
extern "C" int fused_dsconv_smem_bytes(int P, int C, int W, int ck, int halo_rows, int kc,
                                       int k) {
  return layout_of(P, C, W, ck, halo_rows, kc, k).total;
}

// x int8 [N,H,W,C]; dw int8 [k*k,C]; effd, bd f32 [C]; pw int8 [O,C]; effp,
// bp f32 [O]; out [N,Ho,Wo,O] int8 (out_int8 != 0) or f32.  k ∈ {3,5},
// stride ∈ {1,2}, pt/pl the top/left pads (Ho, Wo carry the bottom/right
// ones); P ∈ {64, 128} pixels a CTA, o_chunk a multiple of 64, ck a power of
// two in 4..1024 (a multiple of 16 when C is), halo_rows the rows a tile's
// halo may span, kc a multiple of 32.  Returns cudaGetLastError() after the
// launch (cudaErrorInvalidValue for arguments the kernel does not take).
extern "C" int fused_dsconv_int8(const void* x, const void* dw, const void* effd, const void* bd,
                                 const void* pw, const void* effp, const void* bp, void* out,
                                 int N, int H, int W, int C, int O, int Ho, int Wo, int k,
                                 int stride, int pt, int pl, float inv_mid, int mid_act,
                                 int out_act, int out_int8, float inv_out, float out_zp,
                                 int P, int o_chunk, int ck, int halo_rows, int kc,
                                 void* stream) {
  const int smem = layout_of(P, C, W, ck, halo_rows, kc, k).total;
  if (N <= 0 || Ho <= 0 || Wo <= 0 || C <= 0 || C > 1024 || O <= 0 || o_chunk <= 0 ||
      o_chunk % OT || (P != 64 && P != 128) || ck < 4 || ck > 1024 || (ck & (ck - 1)) ||
      (C % 16 == 0 && ck % 16) || halo_rows <= 0 || kc <= 0 || kc % 32 ||
      smem > SMEM_LIMIT || (long long)N * Ho * Wo > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{static_cast<const int8_t*>(x), static_cast<const int8_t*>(dw),
         static_cast<const float*>(effd), static_cast<const float*>(bd),
         static_cast<const int8_t*>(pw), static_cast<const float*>(effp),
         static_cast<const float*>(bp), out, N, H, W, C, O, Ho, Wo, pt, pl, inv_mid,
         mid_act, out_act, out_int8, inv_out, out_zp, o_chunk, ck, halo_rows, kc};
  const long long tiles = ((long long)N * Ho * Wo + P - 1) / P;
  const dim3 grid(static_cast<unsigned>(tiles), (O + o_chunk - 1) / o_chunk);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t e = P == 128 ? launch_p<128>(a, k, stride, grid, smem, st)
                                 : launch_p<64>(a, k, stride, grid, smem, st);
  return static_cast<int>(e);
}
