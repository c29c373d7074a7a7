"""Quantization math: per-tensor / per-channel affine quantize and dequantize,
multiplier folding, the fixed-point requantize oracle and llama.cpp block
quant (counterpart of csinn2_tpu/core/quant.py).

(ref: source/nn2/utils.c — csinn_tensor_data_convert :2206.)  `quantize`
rounds half to even (`torch.round`, as `jnp.round`).  It divides by the
scale, as the JAX function does when called eagerly (weights, inputs); with
`by_reciprocal=True` it multiplies by the f32 reciprocal of the scale, which
is what the JAX package's compiled graphs compute (XLA rewrites a division
by a constant into that product), and what the port's in-graph requantize
steps and CUDA kernels compute.  The scale is an f32 tensor on the data's
device in both: PyTorch's CUDA division by a host scalar would take a
reciprocal of its own.

`quantize_multiplier`, `requantize_int`, `block_quantize` and
`block_dequantize` take and return numpy arrays, as the JAX functions do, so
the tests carry the same bytes into both packages; `requantize_float` takes
a torch tensor.
"""

from __future__ import annotations

import dataclasses
import math
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

    def multiplier_shift(self, out_scale: ArrayLike, w_scale: ArrayLike = 1.0):
        """Fold (in_scale * w_scale / out_scale) into int multiplier+shift arrays."""
        eff = np.asarray(self.scale, np.float64) * np.asarray(w_scale, np.float64)
        eff = eff / np.asarray(out_scale, np.float64)
        return quantize_multiplier(eff)

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


def quantize_multiplier(double_multiplier) -> Tuple[np.ndarray, np.ndarray]:
    """real multiplier → (int32 fixed-point multiplier, shift), TFLite
    semantics: q = round(m · 2^31) with m normalized to [0.5, 1); the value
    represented is q · 2^(shift - 31).  (ref: shl_quantize_multiplier,
    source/nn2/utils.c:185-210.)"""
    m = np.atleast_1d(np.asarray(double_multiplier, np.float64))
    q_out = np.zeros(m.shape, np.int32)
    s_out = np.zeros(m.shape, np.int32)
    for i, v in np.ndenumerate(m):
        if v == 0.0:
            continue
        frac, exp = math.frexp(v)
        q = round(frac * (1 << 31))
        if q == (1 << 31):
            q //= 2
            exp += 1
        if exp < -31:
            q, exp = 0, 0
        q_out[i], s_out[i] = q, exp
    return q_out, s_out


def _np_dtype(dtype: Dtype):
    return np.dtype(str(dtype.torch).replace("torch.", ""))


def requantize_int(acc_i32, multiplier, shift, out_zp, out_dtype: Dtype) -> np.ndarray:
    """Exact integer requantize of an int32 accumulator, in int64 on the host
    (numpy): the bit-exactness oracle of kernels/requant.py.

    The gemmlowp/TFLite chain (ref: requantize_m4_s,
    source/thead_rvv/int8/gemm_int8_packn.c:26-41): clip(acc << left) to
    int32, saturating rounding doubling high multiply with C-truncating
    division, rounding divide by 2^right, + zp, clip to out_dtype."""
    x = np.asarray(acc_i32, np.int64)
    m = np.asarray(multiplier, np.int64)
    s = np.asarray(shift, np.int64)
    left = np.maximum(s, 0)
    right = np.maximum(-s, 0)
    x = np.clip(x << left, -(2**31), 2**31 - 1)
    prod = x * m
    nudge = np.where(prod >= 0, 1 << 30, 1 - (1 << 30))
    q = prod + nudge
    x = np.where(q >= 0, q >> 31, -((-q) >> 31))
    x = np.clip(x, -(2**31), 2**31 - 1)
    mask = (np.int64(1) << right) - 1
    remainder = x & mask
    threshold = (mask >> 1) + np.where(x < 0, 1, 0)
    x = (x >> right) + np.where(remainder > threshold, 1, 0)
    x = np.clip(x + np.asarray(out_zp, np.int64), out_dtype.qmin, out_dtype.qmax)
    return x.astype(_np_dtype(out_dtype))


def requantize_float(acc_i32: torch.Tensor, eff_scale, out_zp, out_dtype: Dtype) -> torch.Tensor:
    """Float-path requantize: round(acc · eff_scale) + zp, clipped (eff_scale
    scalar or broadcast against acc by the caller), in f32."""
    eff = torch.as_tensor(np.asarray(eff_scale, np.float32), device=acc_i32.device)
    x = torch.round(acc_i32.float() * eff) + float(out_zp)
    return torch.clamp(x, out_dtype.qmin, out_dtype.qmax).to(out_dtype.torch)


# ---------------------------------------------------------------------------
# Block quantization (llama.cpp-compatible Q8_0 / Q4_0)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class BlockQuant:
    """Block-quantized weight: int8 values (Q4_0's in [-8, 7], unpacked in an
    int8 carrier) and one fp16 scale per 32-element block along the last
    axis.  (ref: block_quantize_q4/q8, source/nn2/utils.c:2079-2180.)

    values: int8 array, original shape.  scales: fp16 array, the original
    shape with the last dim / 32.  Numpy arrays or torch tensors."""

    values: object
    scales: object
    scheme: QuantScheme

    @property
    def shape(self):
        return tuple(self.values.shape)


def block_quantize(x: np.ndarray, scheme: QuantScheme) -> BlockQuant:
    """f32 → Q8_0/Q4_0 (numpy): per-32-block absmax scale stored as fp16,
    values rounded against that fp16 scale and clipped."""
    if x.shape[-1] % BLOCK_SIZE:
        raise ValueError(f"last dim {x.shape[-1]} % {BLOCK_SIZE} != 0")
    xb = np.asarray(x, np.float32).reshape(*x.shape[:-1], -1, BLOCK_SIZE)
    amax = np.abs(xb).max(axis=-1, keepdims=True)
    if scheme == QuantScheme.BLOCK_Q8_0:
        d = amax / 127.0
    elif scheme == QuantScheme.BLOCK_Q4_0:
        d = amax / 7.0
    else:
        raise ValueError(f"unsupported block scheme {scheme}")
    d16 = d.astype(np.float16)
    dd = d16.astype(np.float32)
    q = np.where(dd == 0, 0.0, np.round(xb / np.where(dd == 0, 1.0, dd)))
    q = np.clip(q, -127, 127) if scheme == QuantScheme.BLOCK_Q8_0 else np.clip(q, -8, 7)
    return BlockQuant(values=q.astype(np.int8).reshape(x.shape), scales=d16.squeeze(-1),
                      scheme=scheme)


def dequantize_blocks(values, scales) -> torch.Tensor:
    """A (values, scales) block pair → f32 tensor on the values' device."""
    v = _as_torch(values).float()
    s = _as_torch(scales).to(v.device).float()
    return (v.reshape(*v.shape[:-1], -1, BLOCK_SIZE) * s[..., None]).reshape(v.shape)


def block_dequantize(bq: BlockQuant) -> torch.Tensor:
    """Q8_0/Q4_0 → f32 tensor (on the values' device)."""
    return dequantize_blocks(bq.values, bq.scales)
