"""Pooling (counterpart of csinn2_tpu/ops/ref/pool.py, the whole module,
and of `l2pool2d` from its ops/ref/norm.py).

(ref: source/reference/averagepool.c, maxpool.c, global_averagepool.c,
global_maxpool.c.)  Windows take the (top, down, left, right) pads of
csinn_pool_params; max pools pad with -inf, sums with 0.  A mean over a
constant count is the sum times the f32 reciprocal of the count, as XLA
computes it.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from csinn2_tpu_torch.core.dtypes import Api, Layout
from csinn2_tpu_torch.ops.params import PoolParams
from csinn2_tpu_torch.ops.registry import registry


def _nchw(x: torch.Tensor, layout: Layout) -> torch.Tensor:
    return x.permute(0, 3, 1, 2) if layout == Layout.NHWC else x


def _back(y: torch.Tensor, layout: Layout) -> torch.Tensor:
    return (y.permute(0, 2, 3, 1) if layout == Layout.NHWC else y).contiguous()


def _inv(count: float) -> float:
    return float(np.float32(1.0) / np.float32(count))


def _window_sum(x: torch.Tensor, params: PoolParams) -> torch.Tensor:
    """Zero-padded window sums of an NCHW tensor."""
    pt, pd, pl, pr = params.pad
    xp = F.pad(x, (pl, pr, pt, pd))
    return F.avg_pool2d(xp, tuple(params.kernel), tuple(params.stride), 0,
                        divisor_override=1)


@registry.register("maxpool2d", api=Api.TORCH)
def maxpool2d(x, params: PoolParams):
    pt, pd, pl, pr = params.pad
    xp = F.pad(_nchw(x.float(), params.layout), (pl, pr, pt, pd), value=float("-inf"))
    return _back(F.max_pool2d(xp, tuple(params.kernel), tuple(params.stride)), params.layout)


@registry.register("avgpool2d", api=Api.TORCH)
def avgpool2d(x, params: PoolParams):
    """count_include_pad semantics mirror csinn_pool_params.count_include_pad."""
    xn = _nchw(x.float(), params.layout)
    summed = _window_sum(xn, params)
    if params.count_include_pad:
        return _back(summed * _inv(float(np.prod(params.kernel))), params.layout)
    count = _window_sum(torch.ones_like(xn[:1, :1]), params)
    return _back(summed / torch.clamp_min(count, 1.0), params.layout)


@registry.register("global_maxpool2d", api=Api.TORCH)
def global_maxpool2d(x, params: PoolParams):
    axes = (2, 3) if params.layout == Layout.NCHW else (1, 2)
    return torch.amax(x.float(), dim=axes, keepdim=True)


@registry.register("global_avgpool2d", api=Api.TORCH)
def global_avgpool2d(x, params: PoolParams):
    """Mean over H and W, kept as 1×1: the sum times the f32 reciprocal of
    the count, as XLA computes `jnp.mean`.  The sum is taken in f64 and
    rounded once to f32, so it does not depend on the device's reduction
    order (XLA's f32 sum can differ from it where its rounding errors reach
    half an ulp)."""
    axes = (2, 3) if params.layout == Layout.NCHW else (1, 2)
    x = x.float()
    return x.double().sum(dim=axes, keepdim=True).float() * _inv(x.shape[axes[0]] * x.shape[axes[1]])


@registry.register("l2pool2d", api=Api.TORCH)
def l2pool2d(x, params: PoolParams):
    """sqrt of the windowed mean square (ref: CSINN_OP_L2POOL2D)."""
    kh, kw = params.kernel
    summed = _window_sum(torch.square(_nchw(x.float(), params.layout)), params)
    return _back(torch.sqrt(summed * _inv(kh * kw)), params.layout)


def _pool3d_pads(params: PoolParams):
    p = params.pad  # (d0, d1, t, b, l, r)
    return (p[4], p[5], p[2], p[3], p[0], p[1])


@registry.register("maxpool3d", api=Api.TORCH)
def maxpool3d(x, params: PoolParams):
    xp = F.pad(x.float(), _pool3d_pads(params), value=float("-inf"))
    return F.max_pool3d(xp, tuple(params.kernel), tuple(params.stride))


@registry.register("avgpool3d", api=Api.TORCH)
def avgpool3d(x, params: PoolParams):
    x = x.float()
    pads = _pool3d_pads(params)
    k, s = tuple(params.kernel), tuple(params.stride)
    summed = F.avg_pool3d(F.pad(x, pads), k, s, 0, divisor_override=1)
    if params.count_include_pad:
        return summed * _inv(float(np.prod(params.kernel)))
    count = F.avg_pool3d(F.pad(torch.ones_like(x[:1, :1]), pads), k, s, 0, divisor_override=1)
    return summed / torch.clamp_min(count, 1.0)
