"""csinn2_tpu_torch — the PyTorch/CUDA port of csinn2_tpu for one NVIDIA H100.

The JAX package `csinn2_tpu` is the reference; this package keeps its module
and public names so each counterpart is easy to find, and never imports it
(nor JAX).  Plain tensor code is PyTorch; every Pallas kernel on the ported
path is a hand-written CUDA kernel for sm_90a (kernels/csrc/), built with
nvcc at first use and bound through ctypes.

Device rule: entry points take an explicit `device` ("cuda" by default) and
raise when CUDA is absent unless the caller passed device="cpu".  Kernel
wrappers decide by the tensor's device: CUDA tensors launch the kernel, CPU
tensors run the plain PyTorch version beside it.

Layer map (ported so far):
  core/     — dtypes and enums, QuantInfo/quantize/dequantize, Tensor,
              layout axes, BLOCK_SIZE
  ops/      — registry, params, call_op and the ops MobileNetV1 records,
              float reference ops (ref/)
  kernels/  — quant_matmul (Q8_0, Q4_0, INT8/INT4 channel, swiglu epilogue),
              decode/prefill/flash attention, fused_dsconv (the fused
              depthwise→pointwise int8 block), qconv (int8 conv/fc paths)
  graph/    — graph IR, the ds_block fusion pass
  runtime/  — Session (eager replay of the recorded graph)
  models/   — NetBuilder, MobileNetV1
  llm/      — LlamaConfig, model forward, params bridge, sampling, engine
  utils/    — device helper, verify metrics, config, logging, timing
"""

__version__ = "0.1.0"
