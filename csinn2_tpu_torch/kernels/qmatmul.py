"""Fused dequant-GEMM: y = x @ dequant(w_q) [+ bias] (counterpart of
csinn2_tpu/kernels/qmatmul.py).

`quant_matmul` launches the hand-written CUDA kernel (csrc/qmatmul.cu) for a
CUDA tensor and runs `quant_matmul_ref`, its plain PyTorch version, for a CPU
tensor.  Only scale mode "block" (llama.cpp Q8_0: int8 [K, N] values, f32
[K/32, N] scales) is ported; the other modes of the TPU kernel are ROADMAP
queue B items and raise NotImplementedError.

Numerics: the CUDA kernel dequantizes w·s in f32 and accumulates in f32, as
quant_matmul_ref does (the TPU kernel forms w·s in bf16 instead).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from csinn2_tpu_torch.core.quant import BLOCK_SIZE
from csinn2_tpu_torch.kernels import _build

BLOCK = BLOCK_SIZE


def _unported(what: str):
    return NotImplementedError(
        f"quant_matmul {what} is not ported yet (ROADMAP queue B); only "
        "scale_mode='block' with int8 values (Q8_0) runs in this package")


def _check_args(scale_mode, packed_int4, swiglu, w_transposed, epilogue_scale):
    if scale_mode != "block":
        raise _unported(f"scale_mode={scale_mode!r}")
    if packed_int4:
        raise _unported("packed_int4 (Q4_0/INT4)")
    if swiglu:
        raise _unported("swiglu epilogue")
    if w_transposed:
        raise _unported("w_transposed layout")
    if epilogue_scale is not None:
        raise _unported("epilogue_scale")


def quant_matmul_ref(x, w_q, scales=None, bias=None, *, scale_mode="channel",
                     out_dtype=torch.float32, epilogue_scale=None,
                     packed_int4: bool = False, w_transposed: bool = False,
                     swiglu: bool = False):
    """Plain PyTorch version of the same contraction (CPU path and the CUDA
    kernel's yardstick): y = x_f32 @ (w_q_f32 · s repeated over 32-row K
    blocks) + bias, cast to out_dtype."""
    _check_args(scale_mode, packed_int4, swiglu, w_transposed, epilogue_scale)
    K, N = w_q.shape
    w = (w_q.float().reshape(K // BLOCK, BLOCK, N)
         * scales.float()[:, None, :]).reshape(K, N)
    acc = x.float() @ w
    if bias is not None:
        acc = acc + bias.float()
    return acc.to(out_dtype)


@functools.lru_cache(maxsize=None)
def _workspace_floats(M: int, N: int, K: int, device: int) -> int:
    """f32 workspace (split-K partial sums) the kernel asks for at this
    shape; csrc/qmatmul.cu alone knows its tiles and split-K plan."""
    fn = _build.c_function("qmatmul", "quant_matmul_block_workspace",
                           (ctypes.c_int,) * 4 + (ctypes.POINTER(ctypes.c_int),),
                           restype=ctypes.c_longlong)
    err = ctypes.c_int(0)
    n = fn(M, N, K, device, ctypes.byref(err))
    _build.check("qmatmul", err.value, "quant_matmul workspace")
    return n


def quant_matmul(x, w_q, scales=None, bias=None, *, scale_mode: str = "channel",
                 out_dtype=torch.float32, epilogue_scale: Optional[float] = None,
                 packed_int4: bool = False, w_transposed: bool = False,
                 swiglu: bool = False):
    """y[M, N] = x[M, K] @ dequant(w_q[K, N], scales[K/32, N]) + bias[N].

    CUDA tensors: x bf16, w_q int8, scales f32, bias f32 or None, all
    contiguous; K % 32 == 0 and N % 16 == 0; out_dtype bf16 or f32.
    CPU tensors: quant_matmul_ref."""
    _check_args(scale_mode, packed_int4, swiglu, w_transposed, epilogue_scale)
    if x.device.type == "cpu":
        return quant_matmul_ref(x, w_q, scales, bias, scale_mode=scale_mode,
                                out_dtype=out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"quant_matmul: unsupported device {x.device}")
    M, K = x.shape
    Kw, N = w_q.shape
    tensors = [x, w_q, scales] + ([bias] if bias is not None else [])
    if any(t.device != x.device for t in tensors):
        raise ValueError("quant_matmul: all tensors must be on one device")
    if x.dtype != torch.bfloat16 or w_q.dtype != torch.int8 \
            or scales.dtype != torch.float32 \
            or (bias is not None and bias.dtype != torch.float32):
        raise TypeError("quant_matmul: want x bf16, w_q int8, scales/bias f32; "
                        f"got {x.dtype}, {w_q.dtype}, {scales.dtype}")
    if Kw != K or K % BLOCK or N % 16 or tuple(scales.shape) != (K // BLOCK, N) \
            or (bias is not None and tuple(bias.shape) != (N,)):
        raise ValueError(f"quant_matmul: bad shapes x{tuple(x.shape)} "
                         f"w{tuple(w_q.shape)} s{tuple(scales.shape)} "
                         "(need K % 32 == 0, N % 16 == 0)")
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0 for t in tensors):
        raise ValueError("quant_matmul: tensors must be contiguous and "
                         "16-byte aligned")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"quant_matmul: out_dtype {out_dtype} not supported")
    out = torch.empty((M, N), dtype=out_dtype, device=x.device)
    if M == 0:
        return out
    device = x.device.index if x.device.index is not None \
        else torch.cuda.current_device()
    n_ws = _workspace_floats(M, N, K, device)
    workspace = (torch.empty((n_ws,), dtype=torch.float32, device=x.device)
                 if n_ws else None)
    fn = _build.c_function("qmatmul", "quant_matmul_block",
                           (ctypes.c_void_p,) * 5 + (ctypes.c_int, ctypes.c_void_p,
                                                     ctypes.c_longlong)
                           + (ctypes.c_int,) * 4 + (ctypes.c_void_p,))
    err = fn(x.data_ptr(), w_q.data_ptr(), scales.data_ptr(),
             bias.data_ptr() if bias is not None else None, out.data_ptr(),
             int(out_dtype == torch.float32),
             workspace.data_ptr() if workspace is not None else None, n_ws,
             M, N, K, device, torch.cuda.current_stream(x.device).cuda_stream)
    _build.check("qmatmul", err, "quant_matmul")
    _build.launch_counts["quant_matmul"] += 1
    return out
