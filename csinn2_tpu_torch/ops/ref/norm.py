"""Normalization ops (counterpart of csinn2_tpu/ops/ref/norm.py; l2pool2d
is registered with the pools, ops/ref/pool.py).

(ref: source/reference/{batch_normalization,layer_norm,instance_norm,
l2_normalization,lrn}.c; rms_norm source/thead_rvv/*/rms_norm*.)
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from csinn2_tpu_torch.core.dtypes import Api, Layout
from csinn2_tpu_torch.ops.params import BatchNormParams, LRNParams, NormParams
from csinn2_tpu_torch.ops.registry import registry


def _trailing(x, axis: int):
    axis = axis if axis >= 0 else x.dim() + axis
    return tuple(range(axis, x.dim()))


@registry.register("batch_norm", api=Api.TORCH)
def batch_norm(x, mean, variance, gamma, beta, params: BatchNormParams):
    """Inference BN over the channel axis of params.layout
    (ref: shl_ref_batch_normalization_f32)."""
    caxis = 1 if params.layout in (Layout.NCHW, Layout.NCW) else x.dim() - 1
    shape = [1] * x.dim()
    shape[caxis] = -1
    x = x.float()
    out = (x - mean.float().reshape(shape)) * torch.rsqrt(
        variance.float().reshape(shape) + params.epsilon)
    if gamma is not None:
        out = out * gamma.float().reshape(shape)
    if beta is not None:
        out = out + beta.float().reshape(shape)
    return out


@registry.register("layer_norm", api=Api.TORCH)
def layer_norm(x, gamma, beta, params: NormParams):
    """Normalize over the trailing axes from params.axis
    (ref: shl_ref_layer_norm_f32)."""
    x = x.float()
    axes = _trailing(x, params.axis)
    mean = torch.mean(x, dim=axes, keepdim=True)
    var = torch.mean(torch.square(x - mean), dim=axes, keepdim=True)
    out = (x - mean) * torch.rsqrt(var + params.epsilon)
    if params.scale and gamma is not None:
        out = out * gamma.float()
    if params.center and beta is not None:
        out = out + beta.float()
    return out


@registry.register("rms_norm", api=Api.TORCH)
def rms_norm(x, gamma, params: NormParams):
    """x / rms(x) * gamma over the trailing axes (ref: shl_rvv_rms_norm_fp16)."""
    x = x.float()
    ms = torch.mean(torch.square(x), dim=_trailing(x, params.axis), keepdim=True)
    out = x * torch.rsqrt(ms + params.epsilon)
    if gamma is not None:
        out = out * gamma.float()
    return out


@registry.register("instance_norm", api=Api.TORCH)
def instance_norm(x, gamma, beta, params: NormParams):
    """Per-(N, C) spatial normalization (ref: CSINN_OP_INSTANCE_NORM)."""
    x = x.float()
    if params.layout == Layout.NCHW:
        axes, shape = (2, 3), (1, -1, 1, 1)
    else:
        axes, shape = (1, 2), (1, 1, 1, -1)
    mean = torch.mean(x, dim=axes, keepdim=True)
    var = torch.mean(torch.square(x - mean), dim=axes, keepdim=True)
    out = (x - mean) * torch.rsqrt(var + params.epsilon)
    if gamma is not None:
        out = out * gamma.float().reshape(shape)
    if beta is not None:
        out = out + beta.float().reshape(shape)
    return out


@registry.register("l2_normalization", api=Api.TORCH)
def l2_normalization(x, params: NormParams):
    """(ref: CSINN_OP_L2N, shl_ref_l2_normalization_f32.)"""
    x = x.float()
    denom = torch.sqrt(torch.sum(torch.square(x), dim=params.axis, keepdim=True))
    return x / torch.clamp_min(denom, params.epsilon)


@registry.register("lrn", api=Api.TORCH)
def lrn(x, params: LRNParams):
    """Local response norm across channels, NCHW (ref: shl_ref_lrn_f32):
    a window of `range` channels, range // 2 of them before the centre."""
    x = x.float()
    half = params.range // 2
    sq = F.pad(torch.square(x), (0, 0, 0, 0, half, params.range - 1 - half))
    summed = sq.unfold(1, params.range, 1).sum(-1)
    return x / torch.pow(params.bias + params.alpha * summed, params.beta)
