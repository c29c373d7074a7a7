// Quantized GEMM, int8 weight values [K, N] or [N, K]: Q8_0 (block scales),
// INT8_CHANNEL / unpacked INT4_CHANNEL (channel scales) and scale_mode
// "none".  The kernels, their
// notes (TPU function replaced, bound, design) and the split-K plan are in
// qmatmul.cuh; qmatmul_int4.cu instantiates the packed-int4 half.
#include "qmatmul.cuh"

// Floats of f32 workspace that quant_matmul_int8 / quant_matmul_int4 need for
// [M,K]·[K,N] on `device` (swiglu != 0: with the SwiGLU epilogue;
// reduce_epi != 0: an integer output, an epilogue scale, or channel scales
// with a bias), or -1 with the CUDA error in *err.  The plan depends on
// neither the weight format nor its layout.
extern "C" long long quant_matmul_workspace(int M, int N, int K, int swiglu, int reduce_epi,
                                            int device, int* err) {
  cudaError_t e;
  const long long n = workspace_floats(M, N, K, swiglu != 0, reduce_epi != 0, device, &e);
  *err = static_cast<int>(e);
  return n;
}

// x bf16 [M,K]; w int8 [K,N], or [N,K] with trans != 0; s f32 [K/32,N]
// ([N,K/32] with trans; scale_kind 0), [N] (scale_kind 1) or unused
// (scale_kind 2); bias f32 [N] or null; the epilogue scale e when has_e;
// out [M,N] of out_kind (epilogue.cuh OutKind, zp for the integer kinds), or
// [M,N/2] with swiglu != 0 (N % 256 == 0); workspace f32 of
// ws_floats (at least quant_matmul_workspace(...)); counters int32 of
// counter_slots (at least ceil(N / 256) at M <= 16 with K split), zero
// before the launch and left zero by it, used by one stream at a time.
// K % 32 == 0, N % 16 == 0, all pointers 16-byte aligned.
extern "C" int quant_matmul_int8(const void* x, const void* w, const void* s, const void* bias,
                                 void* out, int out_kind, int scale_kind, int swiglu, int trans,
                                 float e, int has_e, float zp, void* workspace,
                                 long long ws_floats, void* counters, int counter_slots, int M,
                                 int N, int K, int device, void* stream) {
  return run<false>(x, w, s, bias, out, out_kind, scale_kind, swiglu, trans, e, has_e, zp,
                    workspace, ws_floats, counters, counter_slots, M, N, K, device, stream);
}

// The decode ring alone over a Q8_0 [K, N] weight (qmatmul.cuh run_ring):
// x bf16 [M,K] (M <= 8), w int8 [K,N], s f32 [K/32,N]; nothing is written.
extern "C" int quant_matmul_int8_ring(const void* x, const void* w, const void* s, int M, int N,
                                      int K, int device, void* stream) {
  return run_ring<false>(x, w, s, M, N, K, device, stream);
}

// qmm_reduce launches of this library so far (a host count: the decode
// kernel finishes its splits itself and never launches it)
extern "C" long long quant_matmul_int8_reduce_launches() { return reduce_launches; }
