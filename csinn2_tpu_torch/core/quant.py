"""Quantization math: per-tensor / per-channel affine quantize and dequantize
(counterpart of csinn2_tpu/core/quant.py; the block-quant helpers, the
fixed-point `requantize_int` oracle and `quantize_multiplier` are not ported
yet, ROADMAP queue A item 10).

(ref: source/nn2/utils.c — csinn_tensor_data_convert :2206.)  `quantize`
rounds half to even (`torch.round`, as `jnp.round`).  It divides by the
scale, as the JAX function does when called eagerly (weights, inputs); with
`by_reciprocal=True` it multiplies by the f32 reciprocal of the scale, which
is what the JAX package's compiled graphs compute (XLA rewrites a division
by a constant into that product), and what the port's in-graph requantize
steps and CUDA kernels compute.  The scale is an f32 tensor on the data's
device in both: PyTorch's CUDA division by a host scalar would take a
reciprocal of its own.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from csinn2_tpu_torch.core.dtypes import Dtype, QuantScheme

ArrayLike = Union[np.ndarray, float, int]

BLOCK_SIZE = 32  # llama.cpp-compatible block quant granularity along K


@dataclasses.dataclass
class QuantInfo:
    """Per-tensor or per-channel affine quantization parameters.

    (ref: struct csinn_quant_info, csinn_data_structure.h:494-503.)
    scale/zero_point are Python scalars (per-tensor) or 1-D numpy arrays of
    length C (per-channel along `axis`), as in the JAX package; `tensors()`
    gives them as f32 tensors on a device, made once per device."""

    scale: ArrayLike = 1.0
    zero_point: ArrayLike = 0
    dtype: Dtype = Dtype.FLOAT32
    axis: Optional[int] = None  # channel axis for per-channel quant; None = per-tensor
    scheme: QuantScheme = QuantScheme.UNSET
    _on: Dict[torch.device, Tuple[torch.Tensor, ...]] = dataclasses.field(
        default_factory=dict, init=False, repr=False, compare=False)

    @property
    def per_channel(self) -> bool:
        return self.axis is not None and np.ndim(self.scale) > 0

    def broadcast_shape(self, rank: int) -> Tuple[int, ...]:
        """Shape to reshape scale/zp to for broadcasting against a rank-`rank` array."""
        if not self.per_channel:
            return ()
        shape = [1] * rank
        shape[self.axis] = -1
        return tuple(shape)

    def inv_scale(self) -> np.ndarray:
        """f32 reciprocal of the scale, computed in f32 (XLA's rewrite of a
        division by a constant)."""
        return np.float32(1.0) / np.asarray(self.scale, np.float32)

    def tensors(self, device) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(scale, zero_point, inv_scale) as f32 tensors on `device` (0-d
        per-tensor, [C] per-channel)."""
        device = torch.device(device)
        if device not in self._on:
            self._on[device] = tuple(
                torch.tensor(np.asarray(v, np.float32), device=device)
                for v in (self.scale, self.zero_point, self.inv_scale()))
        return self._on[device]


def from_minmax(minv: ArrayLike, maxv: ArrayLike, dtype: Dtype,
                symmetric: bool = False, axis: Optional[int] = None) -> QuantInfo:
    """Derive scale/zero-point from observed min/max (numpy, float64 then
    f32, as the JAX package does).

    (ref: quantize-from-range logic used by the test harness,
    tests/validation_layer/testutil.h get_quant_info.)
    """
    if dtype.is_float:  # float "qinfo" is a plain cast: identity scale
        return QuantInfo(scale=1.0, zero_point=0, dtype=dtype, axis=None)
    minv = np.minimum(np.asarray(minv, np.float64), 0.0)
    maxv = np.maximum(np.asarray(maxv, np.float64), 0.0)
    qmin, qmax = dtype.qmin, dtype.qmax
    if symmetric:
        amax = np.maximum(np.abs(minv), np.abs(maxv))
        # int8 → ±127 about zp=0; unsigned dtypes center on the midpoint code
        if qmin == 0:
            mid = (qmax + 1) // 2
            scale = np.where(amax == 0, 1.0, amax / (qmax - mid))
            zp = np.full_like(scale, mid, dtype=np.int32)
        else:
            scale = np.where(amax == 0, 1.0, amax / qmax)
            zp = np.zeros_like(scale, dtype=np.int32)
    else:
        scale = np.where(maxv - minv == 0, 1.0, (maxv - minv) / (qmax - qmin))
        zp = np.clip(np.round(qmin - minv / scale), qmin, qmax).astype(np.int32)
    scale = scale.astype(np.float32)
    if axis is None:
        scale = float(scale)
        zp = int(zp)
    return QuantInfo(scale=scale, zero_point=zp, dtype=dtype, axis=axis)


def observe(x, dtype: Dtype, symmetric: bool = False,
            axis: Optional[int] = None) -> QuantInfo:
    """Calibrate a QuantInfo from data (per-tensor or per-channel along axis)."""
    x = x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    if axis is None:
        return from_minmax(x.min(), x.max(), dtype, symmetric, None)
    reduce_axes = tuple(i for i in range(x.ndim) if i != axis)
    return from_minmax(x.min(axis=reduce_axes), x.max(axis=reduce_axes),
                       dtype, symmetric, axis)


def _as_torch(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.from_numpy(np.array(x))


def quantize(x, qinfo: QuantInfo, *, by_reciprocal: bool = False) -> torch.Tensor:
    """f32 → quantized int carrier: round(x/scale)+zp (round(x·(1/scale))+zp
    with by_reciprocal), clip to dtype range, on x's device.
    (ref: csinn_tensor_data_convert float→int path.)"""
    x = _as_torch(x)
    if qinfo.dtype.is_float:
        return x.to(qinfo.dtype.torch)
    shp = qinfo.broadcast_shape(x.dim())
    scale, zp, inv = qinfo.tensors(x.device)
    y = x.float() * inv.reshape(shp) if by_reciprocal else x.float() / scale.reshape(shp)
    q = torch.clamp(torch.round(y) + zp.reshape(shp), qinfo.dtype.qmin, qinfo.dtype.qmax)
    return q.to(qinfo.dtype.torch)


def dequantize(q, qinfo: QuantInfo) -> torch.Tensor:
    """quantized int carrier → f32: (q - zp) * scale, on q's device."""
    q = _as_torch(q)
    if qinfo.dtype.is_float:
        return q.float()
    shp = qinfo.broadcast_shape(q.dim())
    scale, zp, _ = qinfo.tensors(q.device)
    return (q.float() - zp.reshape(shp)) * scale.reshape(shp)
