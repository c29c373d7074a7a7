"""Reductions, arg ops, cumulative ops, segment ops (counterpart of
csinn2_tpu/ops/ref/reduce.py).

(ref: source/reference/{sum,mean,max,min,prod,all,any,argmax,argmin,
reduce_*,cumsum,cumprod,segment_*}.c.)  The JAX functions' rules where
torch's differ: argmax / argmin give the first index among equal values
(int32); a segment with no row holds the reduction's identity (0, 1, -inf,
+inf; the mean 0), and a row whose id is negative or >= num_segments is
dropped; the sorted and unsorted segment ops are one implementation.
"""

from __future__ import annotations

import functools

import torch

from csinn2_tpu_torch.core.dtypes import Api
from csinn2_tpu_torch.ops.params import (ArgParams, CumsumParams, ReduceParams,
                                         SegmentParams, StridedReduceParams)
from csinn2_tpu_torch.ops.registry import registry


def _axes(params: ReduceParams, ndim: int):
    if params.axis is None:
        return tuple(range(ndim))
    return tuple(params.axis) if not isinstance(params.axis, int) else (params.axis,)


def _each_axis(fn, x, dim, keepdim):
    """fn (a one-axis reduction: torch.prod, torch.all, torch.any) over
    several axes."""
    dims = sorted({d % x.dim() for d in dim})
    for d in dims:
        x = fn(x, dim=d, keepdim=True)
    return x if keepdim else x.squeeze(tuple(dims))


_REDUCERS = {"sum": torch.sum, "mean": torch.mean, "max": torch.amax,
             "min": torch.amin, "prod": functools.partial(_each_axis, torch.prod)}


def _reg_reduce(name, fn):
    def impl(x, params: ReduceParams, _fn=fn):
        x = x.float()
        return _fn(x, dim=_axes(params, x.dim()), keepdim=params.keepdims)
    registry.register(name, impl, api=Api.TORCH)


for _nm, _fn in _REDUCERS.items():
    _reg_reduce(f"reduce_{_nm}", _fn)
    _reg_reduce(_nm, _fn)


@registry.register("reduce_logsumexp", api=Api.TORCH)
def reduce_logsumexp(x, params: ReduceParams):
    x = x.float()
    return torch.logsumexp(x, dim=_axes(params, x.dim()), keepdim=params.keepdims)


def _bool_reduce(x, params, fn):
    x = x.bool()
    return _each_axis(fn, x, _axes(params, x.dim()), params.keepdims)


@registry.register("all", api=Api.TORCH)
def all_(x, params: ReduceParams):
    return _bool_reduce(x, params, torch.all)


@registry.register("any", api=Api.TORCH)
def any_(x, params: ReduceParams):
    return _bool_reduce(x, params, torch.any)


@registry.register("argmax", api=Api.TORCH)
def argmax(x, params: ArgParams):
    out = torch.argmax(x.float(), dim=params.axis).int()
    return out[..., None] if params.keepdims else out


@registry.register("argmin", api=Api.TORCH)
def argmin(x, params: ArgParams):
    out = torch.argmin(x.float(), dim=params.axis).int()
    return out[..., None] if params.keepdims else out


@registry.register("cumsum", api=Api.TORCH)
def cumsum(x, params: CumsumParams):
    x = x.float()
    out = torch.cumsum(x, dim=params.axis)
    return out - x if params.exclusive else out


@registry.register("cumprod", api=Api.TORCH)
def cumprod(x, params: CumsumParams):
    x = x.float()
    out = torch.cumprod(x, dim=params.axis)
    if params.exclusive:
        out = out / torch.where(x == 0, torch.ones_like(x), x)
    return out


# segment reduction → (scatter_reduce mode, identity)
_SEGMENT = {"sum": ("sum", 0.0), "max": ("amax", float("-inf")),
            "min": ("amin", float("inf")), "prod": ("prod", 1.0)}


def _segment(x, segment_ids, num_segments: int, kind: str):
    """out[s] = reduce of the rows whose id is s (jax.ops.segment_*): rows
    with an id out of [0, num_segments) fall away, as the identity added
    to segment 0."""
    mode, ident = _SEGMENT[kind]
    x = x.float()
    ids = segment_ids.long()
    valid = (ids >= 0) & (ids < num_segments)
    vshape = (-1,) + (1,) * (x.dim() - 1)
    x = torch.where(valid.reshape(vshape), x, torch.full((), ident, device=x.device))
    idx = torch.where(valid, ids, 0).reshape(vshape).expand(x.shape)
    out = torch.full((num_segments,) + tuple(x.shape[1:]), ident, dtype=torch.float32,
                     device=x.device)
    return out.scatter_reduce_(0, idx, x, mode, include_self=True)


def _reg_segment(kind):
    def impl(x, segment_ids, params: SegmentParams):
        return _segment(x, segment_ids, params.num_segments, kind)
    return impl


for _nm in _SEGMENT:
    registry.register(f"segment_{_nm}", _reg_segment(_nm), api=Api.TORCH)


@registry.register("segment_mean", api=Api.TORCH)
def segment_mean(x, segment_ids, params: SegmentParams):
    s = _segment(x, segment_ids, params.num_segments, "sum")
    n = _segment(torch.ones(segment_ids.shape, device=x.device), segment_ids,
                 params.num_segments, "sum")
    return s / torch.clamp_min(n.reshape((-1,) + (1,) * (s.dim() - 1)), 1.0)


# the unsorted variants: one implementation, as in the JAX package (ref:
# shl_ref_unsorted_segment_*_f32 vs shl_ref_segment_*_f32)
for _nm in ("sum", "max", "min", "prod", "mean"):
    registry.register(f"unsorted_segment_{_nm}",
                      registry.lookup(f"segment_{_nm}", api=Api.TORCH).exec, api=Api.TORCH)


def _stride_reduce(x, params: StridedReduceParams, reducer):
    """Strided reduction over explicit (strides, extents) index spaces
    (ref: shl_ref_mean_stride_f32, source/reference/mean.c:21-54)."""
    xf = x.float().reshape(-1)

    def flat_index(strides, extents):
        if not extents:
            return torch.zeros(1, dtype=torch.long, device=x.device)
        grids = torch.meshgrid(*[torch.arange(e, device=x.device) for e in extents],
                               indexing="ij")
        flat = torch.zeros(grids[0].numel(), dtype=torch.long, device=x.device)
        for g, s in zip(grids, strides):
            flat = flat + g.reshape(-1) * s
        return flat

    out_idx = flat_index(params.out_strides, params.out_extents)
    inner_idx = flat_index(params.inner_strides, params.inner_extents)
    pos = (out_idx[:, None] + inner_idx[None, :]).clamp(0, xf.numel() - 1)
    out = reducer(xf[pos], dim=1)
    return out.reshape(tuple(params.out_extents)) if params.out_extents else out


@registry.register("mean_stride", api=Api.TORCH)
def mean_stride(x, params: StridedReduceParams):
    return _stride_reduce(x, params, torch.mean)


@registry.register("min_stride", api=Api.TORCH)
def min_stride(x, params: StridedReduceParams):
    return _stride_reduce(x, params, torch.amin)
