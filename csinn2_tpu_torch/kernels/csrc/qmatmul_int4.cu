// Quantized GEMM, packed int4 weight values [K/2, N] or [N, K/2] (the llama.cpp nibble
// layout of csinn2_tpu/kernels/qmatmul.py pack_int4): Q4_0 (block scales) and
// INT4_CHANNEL (channel scales).  The kernels and their notes are in
// qmatmul.cuh; this library only instantiates them for the packed carrier,
// so it builds in parallel with qmatmul.cu.
#include "qmatmul.cuh"

// As quant_matmul_int8 (qmatmul.cu), with w the packed [K/2, N] bytes, or
// [N, K/2] with trans != 0.
extern "C" int quant_matmul_int4(const void* x, const void* w, const void* s, const void* bias,
                                 void* out, int out_kind, int scale_kind, int swiglu, int trans,
                                 float e, int has_e, float zp, void* workspace,
                                 long long ws_floats, int M, int N, int K, int device,
                                 void* stream) {
  return run<true>(x, w, s, bias, out, out_kind, scale_kind, swiglu, trans, e, has_e, zp,
                   workspace, ws_floats, M, N, K, device, stream);
}
