"""Fused dequant-GEMM: y = x @ dequant(w_q) [+ bias] [→ SwiGLU pairs]
(counterpart of csinn2_tpu/kernels/qmatmul.py).

`quant_matmul` launches the hand-written CUDA kernel (csrc/qmatmul.cuh, built
as csrc/qmatmul.cu for int8 values and csrc/qmatmul_int4.cu for packed int4)
for a CUDA tensor and runs `quant_matmul_ref`, its plain PyTorch version, for
a CPU tensor.  Ported modes: scale_mode "block" (Q8_0, Q4_0: f32 [K/32, N]
scales) and "channel" (INT8_CHANNEL, INT4_CHANNEL: f32 [N] scales), int8
values [K, N] or nibble-packed int4 [K/2, N] (`pack_int4`), an f32 bias, and
the swiglu epilogue over the swiglu128 pair layout.  scale_mode "none",
w_transposed, epilogue_scale and integer outputs are ROADMAP queue B items
and raise NotImplementedError.

Numerics: the CUDA kernel dequantizes in f32 and accumulates in f32, as
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
SWIGLU_HALF = 128     # columns per half of a swiglu128 pair


# -- int4 nibble packing ------------------------------------------------------
# llama.cpp Q4_0 byte layout, byte-identical to the JAX package's: byte row
# b*16+j of the packed [K/2, N] array holds K-rows b*32+j (low nibble) and
# b*32+16+j (high nibble), two's complement.

def _to_byte(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    v = (lo.to(torch.int32) & 0xF) | ((hi.to(torch.int32) & 0xF) << 4)
    return v.to(torch.uint8).view(torch.int8)


def _sign4(n: torch.Tensor) -> torch.Tensor:
    """4-bit two's complement (values 0..15) → int8 in [-8, 7]."""
    return ((n ^ 8) - 8).to(torch.int8)


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """[K, N] int8 values in [-8, 7] → [K/2, N] packed bytes."""
    K = q.shape[0]
    if K % BLOCK:
        raise ValueError(f"pack_int4: K={K} is not a multiple of {BLOCK}")
    q3 = q.reshape(K // BLOCK, BLOCK, -1)
    return _to_byte(q3[:, :16], q3[:, 16:]).reshape(K // 2, -1)


def pack_int4_t(qt: torch.Tensor) -> torch.Tensor:
    """[N, K] int8 values in [-8, 7] → [N, K/2] packed bytes (the transposed
    layout; same per-32-block nibble grouping along K)."""
    N, K = qt.shape
    if K % BLOCK:
        raise ValueError(f"pack_int4_t: K={K} is not a multiple of {BLOCK}")
    q3 = qt.reshape(N, K // BLOCK, BLOCK)
    return _to_byte(q3[:, :, :16], q3[:, :, 16:]).reshape(N, K // 2)


def unpack_int4(packed: torch.Tensor, K: int) -> torch.Tensor:
    """[K/2, N] packed bytes → [K, N] int8 values in [-8, 7]."""
    p3 = packed.view(torch.uint8).to(torch.int32).reshape(K // BLOCK, 16, -1)
    return torch.cat([_sign4(p3 & 0xF), _sign4(p3 >> 4)], dim=1).reshape(K, -1)


def unpack_int4_t(packed: torch.Tensor, K: int) -> torch.Tensor:
    """[N, K/2] packed bytes → [N, K] int8 values in [-8, 7]."""
    N = packed.shape[0]
    p3 = packed.view(torch.uint8).to(torch.int32).reshape(N, K // BLOCK, 16)
    return torch.cat([_sign4(p3 & 0xF), _sign4(p3 >> 4)], dim=2).reshape(N, K)


def swiglu_pairs(h: torch.Tensor) -> torch.Tensor:
    """silu(h1)·h3 over 128-column pair-interleaved columns (swiglu128), in
    f32: [M, N] → [M, N/2]."""
    M, N = h.shape
    a = h.float().reshape(M, N // (2 * SWIGLU_HALF), 2, SWIGLU_HALF)
    return (torch.nn.functional.silu(a[:, :, 0]) * a[:, :, 1]).reshape(M, N // 2)


# -- arguments ------------------------------------------------------------------

def _unported(what: str):
    return NotImplementedError(
        f"quant_matmul {what} is not ported yet (ROADMAP queue B); this "
        "package runs scale_mode 'block'/'channel', int8 or packed int4 "
        "values, bias and the swiglu epilogue, with a float output")


def _check_args(scale_mode, w_transposed, epilogue_scale, out_dtype):
    if scale_mode not in ("block", "channel"):
        raise _unported(f"scale_mode={scale_mode!r}")
    if w_transposed:
        raise _unported("w_transposed layout")
    if epilogue_scale is not None:
        raise _unported("epilogue_scale")
    if not out_dtype.is_floating_point:
        raise _unported(f"integer out_dtype {out_dtype}")


def quant_matmul_ref(x, w_q, scales=None, bias=None, *, scale_mode="channel",
                     out_dtype=torch.float32, epilogue_scale=None,
                     packed_int4: bool = False, w_transposed: bool = False,
                     swiglu: bool = False):
    """Plain PyTorch version of the same contraction (CPU path and the CUDA
    kernel's yardstick), in f32 as the JAX reference: y = x @ (q · s repeated
    over 32-row K blocks) for block scales, (x @ q) · s for channel scales;
    then + bias, then the swiglu pairs; cast to out_dtype."""
    _check_args(scale_mode, w_transposed, epilogue_scale, out_dtype)
    x = x.float()
    K = x.shape[-1]
    w = (unpack_int4(w_q, K) if packed_int4 else w_q).float()
    N = w.shape[1]
    if scale_mode == "block":
        w = (w.reshape(K // BLOCK, BLOCK, N) * scales.float()[:, None, :]).reshape(K, N)
        acc = x @ w
    else:
        acc = (x @ w) * scales.float()
    if bias is not None:
        acc = acc + bias.float()
    if swiglu:
        acc = swiglu_pairs(acc)
    return acc.to(out_dtype)


def launch_key(scale_mode: str, packed_int4: bool, swiglu: bool) -> str:
    """The launch_counts name of a quant_matmul mode (a suffix ".decode" for
    M <= 16 or ".prefill" marks the kernel variant)."""
    if swiglu:
        return "quant_matmul_swiglu"
    if scale_mode == "block":
        return "quant_matmul_q4_0" if packed_int4 else "quant_matmul"
    return "quant_matmul_int4_channel" if packed_int4 else "quant_matmul_channel"


DECODE_MAX_M = 16     # csrc/qmatmul.cuh: M <= 16 takes qmm_decode_kernel


@functools.lru_cache(maxsize=None)
def _workspace_floats(M: int, N: int, K: int, swiglu: bool, device: int) -> int:
    """f32 workspace (split-K partial sums, or the swiglu epilogue's sums)
    the kernel asks for at this shape; csrc/qmatmul.cuh alone knows its tiles
    and split-K plan."""
    fn = _build.c_function("qmatmul", "quant_matmul_workspace",
                           (ctypes.c_int,) * 5 + (ctypes.POINTER(ctypes.c_int),),
                           restype=ctypes.c_longlong)
    err = ctypes.c_int(0)
    n = fn(M, N, K, int(swiglu), device, ctypes.byref(err))
    _build.check("qmatmul", err.value, "quant_matmul workspace")
    return n


def quant_matmul(x, w_q, scales=None, bias=None, *, scale_mode: str = "channel",
                 out_dtype=torch.float32, epilogue_scale: Optional[float] = None,
                 packed_int4: bool = False, w_transposed: bool = False,
                 swiglu: bool = False):
    """y[M, N] = x[M, K] @ dequant(w_q, scales) + bias[N]; with swiglu the
    pairs of the swiglu128 layout give y[M, N/2].

    w_q: int8 [K, N], or packed int4 [K/2, N] with packed_int4.  scales: f32
    [K/32, N] (block) or [N] (channel).
    CUDA tensors: x bf16, w_q int8, scales/bias f32, all contiguous;
    K % 32 == 0, N % 16 == 0 (swiglu: N % 256 == 0); out_dtype bf16 or f32.
    CPU tensors: quant_matmul_ref."""
    _check_args(scale_mode, w_transposed, epilogue_scale, out_dtype)
    if x.device.type == "cpu":
        return quant_matmul_ref(x, w_q, scales, bias, scale_mode=scale_mode,
                                out_dtype=out_dtype, packed_int4=packed_int4,
                                swiglu=swiglu)
    if x.device.type != "cuda":
        raise ValueError(f"quant_matmul: unsupported device {x.device}")
    M, K = x.shape
    N = w_q.shape[1]
    tensors = [x, w_q, scales] + ([bias] if bias is not None else [])
    if any(t.device != x.device for t in tensors):
        raise ValueError("quant_matmul: all tensors must be on one device")
    if x.dtype != torch.bfloat16 or w_q.dtype != torch.int8 \
            or scales.dtype != torch.float32 \
            or (bias is not None and bias.dtype != torch.float32):
        raise TypeError("quant_matmul: want x bf16, w_q int8, scales/bias f32; "
                        f"got {x.dtype}, {w_q.dtype}, {scales.dtype}")
    w_shape = (K // 2, N) if packed_int4 else (K, N)
    s_shape = (K // BLOCK, N) if scale_mode == "block" else (N,)
    if tuple(w_q.shape) != w_shape or K % BLOCK or N % 16 \
            or tuple(scales.shape) != s_shape \
            or (bias is not None and tuple(bias.shape) != (N,)) \
            or (swiglu and N % (2 * SWIGLU_HALF)):
        raise ValueError(f"quant_matmul: bad shapes x{tuple(x.shape)} "
                         f"w{tuple(w_q.shape)} s{tuple(scales.shape)} "
                         f"(packed_int4={packed_int4}, scale_mode={scale_mode!r}, "
                         f"swiglu={swiglu}; need K % 32 == 0, N % 16 == 0, "
                         "swiglu N % 256 == 0)")
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0 for t in tensors):
        raise ValueError("quant_matmul: tensors must be contiguous and "
                         "16-byte aligned")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"quant_matmul: out_dtype {out_dtype} not supported")
    out = torch.empty((M, N // 2 if swiglu else N), dtype=out_dtype, device=x.device)
    if M == 0:
        return out
    device = x.device.index if x.device.index is not None \
        else torch.cuda.current_device()
    n_ws = _workspace_floats(M, N, K, swiglu, device)
    workspace = (torch.empty((n_ws,), dtype=torch.float32, device=x.device)
                 if n_ws else None)
    lib, entry = ("qmatmul_int4", "quant_matmul_int4") if packed_int4 \
        else ("qmatmul", "quant_matmul_int8")
    fn = _build.c_function(lib, entry,
                           (ctypes.c_void_p,) * 5 + (ctypes.c_int,) * 3
                           + (ctypes.c_void_p, ctypes.c_longlong)
                           + (ctypes.c_int,) * 4 + (ctypes.c_void_p,))
    err = fn(x.data_ptr(), w_q.data_ptr(), scales.data_ptr(),
             bias.data_ptr() if bias is not None else None, out.data_ptr(),
             int(out_dtype == torch.float32), int(scale_mode == "channel"),
             int(swiglu), workspace.data_ptr() if workspace is not None else None,
             n_ws, M, N, K, device, torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, err, "quant_matmul")
    variant = "decode" if M <= DECODE_MAX_M else "prefill"
    _build.launch_counts[f"{launch_key(scale_mode, packed_int4, swiglu)}.{variant}"] += 1
    return out
