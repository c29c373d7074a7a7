// Shared helpers for the csinn2_tpu_torch CUDA kernels (plain C interface,
// no PyTorch headers: each .cu builds in seconds into its own .so).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

extern "C" const char* csinn2_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
