"""Bit-exact integer requantize of an int32 accumulator (counterpart of
csinn2_tpu/kernels/requant.py).

The gemmlowp/TFLite chain of the reference's integer GEMM epilogue (ref:
requantize_m4_s, source/thead_rvv/int8/gemm_int8_packn.c:26-41):

    h = SRDHM(clip32(acc << left), multiplier)   # (a·b + nudge) / 2^31, C-truncating
    y = clip(RoundingDivideByPOT(h, right) + zp, qmin, qmax)

The JAX function computes the 62-bit product in 12-bit limbs because the
TPU's vector unit has no 64-bit lanes.  PyTorch and CUDA have int64, so this
module computes the chain of `core.quant.requantize_int` directly, in int64,
and csrc/qmatmul_int8dot.cu does the same in its epilogue.  The result
equals the JAX function bit for bit, except at acc = -2^31, where the JAX
function's `jnp.abs` wraps (ROADMAP queue C) and this one equals the oracle.
"""

from __future__ import annotations

import numpy as np
import torch


def _int64(v, device):
    """A multiplier / shift / zero-point as an int64 tensor on `device`, or a
    Python int when it is a scalar (no host-to-device copy per call)."""
    if isinstance(v, torch.Tensor):
        return v.to(device=device, dtype=torch.int64)
    if isinstance(v, (int, np.integer)):
        return int(v)
    return torch.as_tensor(np.asarray(v), device=device).to(torch.int64)


def requant_int(acc, mult, shift, out_zp, qmin: int, qmax: int) -> torch.Tensor:
    """Exact integer requantize: acc int32 tensor; mult (normalized to
    [2^30, 2^31) by core.quant.quantize_multiplier, 0 allowed), shift and
    out_zp scalars or tensors broadcasting against acc (e.g. [N] per
    channel).  Returns int32 in [qmin, qmax] (the caller casts to the storage
    dtype)."""
    dev = acc.device
    x = acc.to(torch.int64)
    m, s = _int64(mult, dev), _int64(shift, dev)
    if isinstance(s, int):
        left, right = max(s, 0), max(-s, 0)
        mask = (1 << right) - 1
    else:
        left, right = torch.clamp(s, min=0), torch.clamp(-s, min=0)
        mask = (torch.ones_like(right) << right) - 1
    x = torch.clamp(x << left, -(2**31), 2**31 - 1)
    prod = x * m
    q = prod + (1 << 30) - (prod < 0).to(torch.int64) * ((1 << 31) - 1)  # the nudge
    x = torch.where(q >= 0, q >> 31, -((-q) >> 31))      # C-truncating / 2^31
    x = torch.clamp(x, -(2**31), 2**31 - 1)
    threshold = (mask >> 1) + (x < 0).to(torch.int64)
    x = (x >> right) + ((x & mask) > threshold).to(torch.int64)
    return torch.clamp(x + _int64(out_zp, dev), qmin, qmax).to(torch.int32)
