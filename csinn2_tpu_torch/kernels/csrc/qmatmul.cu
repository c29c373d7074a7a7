// Quantized GEMM, int8 weight values [K, N]: Q8_0 (block scales) and
// INT8_CHANNEL / unpacked INT4_CHANNEL (channel scales).  The kernels, their
// notes (TPU function replaced, bound, design) and the split-K plan are in
// qmatmul.cuh; qmatmul_int4.cu instantiates the packed-int4 half.
#include "qmatmul.cuh"

// Floats of f32 workspace that quant_matmul_int8 / quant_matmul_int4 need for
// [M,K]·[K,N] on `device` (swiglu != 0: with the SwiGLU epilogue), or -1 with
// the CUDA error in *err.  The plan does not depend on the weight format.
extern "C" long long quant_matmul_workspace(int M, int N, int K, int swiglu, int device,
                                            int* err) {
  cudaError_t e;
  const long long n = workspace_floats(M, N, K, swiglu != 0, device, &e);
  *err = static_cast<int>(e);
  return n;
}

// x bf16 [M,K]; w int8 [K,N]; s f32 [K/32,N] (channel == 0) or [N]
// (channel != 0); bias f32 [N] or null; out f32 (out_f32 != 0) or bf16,
// [M,N], or [M,N/2] with swiglu != 0 (N % 256 == 0); workspace f32 of
// ws_floats (at least quant_matmul_workspace(...)).  K % 32 == 0,
// N % 16 == 0, all pointers 16-byte aligned.
extern "C" int quant_matmul_int8(const void* x, const void* w, const void* s, const void* bias,
                                 void* out, int out_f32, int channel, int swiglu, void* workspace,
                                 long long ws_floats, int M, int N, int K, int device,
                                 void* stream) {
  return run<false>(x, w, s, bias, out, out_f32, channel, swiglu, workspace, ws_floats,
                    M, N, K, device, stream);
}
