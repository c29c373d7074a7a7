"""Tensor manipulation ops (counterpart of csinn2_tpu/ops/ref/shape.py; the
same 35 registrations).

(ref: source/reference/{reshape,transpose,concat,split,slice,strided_slice,
pad,gather,gather_nd,scatter_nd,tile,squeeze,expand_dims,reverse,stack,
unstack,flatten,broadcast_to,shape,crop,depth_to_space,space_to_depth,
space_to_batch,batch_to_space,shuffle_channel,im2col,col2im,reorg,
sequence_mask,one_hot,arange,cast}.c.)  Every op also runs on `meta`
tensors, which is how a recording session infers its output shapes.  Index
rules follow the JAX functions, not torch's: `gather` (jnp.take) wraps a
negative index once and fills an index still out of range (NaN, an
integer dtype's lowest value, True);
`gather_nd` (array indexing) wraps once and clamps; `scatter_nd`
(.at[].add) wraps once, drops what is still out of range and adds
duplicates; `topk` puts the lower index first among equal values;
`squeeze` refuses an axis whose size is not 1.
Indices come out int32, as the JAX package (x64 off) gives them.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from csinn2_tpu_torch.core.dtypes import Api, Dtype
from csinn2_tpu_torch.ops.params import (
    ArangeParams, BatchToSpaceParams, BroadcastToParams, ConcatParams, CropParams,
    DepthToSpaceParams, ExpandDimsParams, FlipParams, GatherParams, OneHotParams,
    PadParams, ReshapeParams, ShuffleChannelParams, SliceParams, Space2DepthParams,
    SpaceToBatchNdParams, SpaceToBatchParams, SplitParams, SqueezeParams, StackParams,
    StridedSliceParams, TileParams, TopKParams, TransposeParams,
)
from csinn2_tpu_torch.ops.registry import registry


def _axes(axis):
    return (axis,) if isinstance(axis, int) else tuple(axis)


def _torch_dtype(dtype) -> torch.dtype:
    """A torch dtype from a torch dtype, a port Dtype, or anything numpy
    reads as a dtype (np.int32, "float16", ...)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    if isinstance(dtype, Dtype):
        return dtype.torch
    name = "bfloat16" if "bfloat16" in str(dtype) else np.dtype(dtype).name
    return getattr(torch, name)


def wrap_index(idx: torch.Tensor, n: int) -> torch.Tensor:
    """A negative index wrapped once (idx + n), as JAX indexing does."""
    idx = idx.long()
    return torch.where(idx < 0, idx + n, idx)


@registry.register("reshape", api=Api.TORCH)
def reshape(x, params: ReshapeParams):
    return x.reshape(tuple(params.shape))


@registry.register("flatten", api=Api.TORCH)
def flatten(x, params=None):
    return x.reshape(x.shape[0], -1)


@registry.register("transpose", api=Api.TORCH)
def transpose(x, params: TransposeParams):
    return x.permute(tuple(params.permute))


@registry.register("concat", api=Api.TORCH)
def concat(inputs, params: ConcatParams):
    return torch.cat(list(inputs), dim=params.axis)


@registry.register("split", api=Api.TORCH)
def split(x, params: SplitParams):
    """split_index are boundary offsets like the reference's split points."""
    return list(torch.tensor_split(x, list(params.split_index), dim=params.axis))


@registry.register("slice", api=Api.TORCH)
def slice_(x, params: SliceParams):
    return x[tuple(slice(b, e) for b, e in zip(params.begin, params.end))]


@registry.register("strided_slice", api=Api.TORCH)
def strided_slice(x, params: StridedSliceParams):
    """Python slice semantics per axis; a negative stride (which torch's
    slicing lacks) is an index_select of the same positions."""
    for ax, (b, e, s) in enumerate(zip(params.begin, params.end, params.stride)):
        if s > 0:
            x = x[(slice(None),) * ax + (slice(b, e, s),)]
        else:
            pos = list(range(*slice(b, e, s).indices(x.shape[ax])))
            x = x.index_select(ax, torch.tensor(pos, dtype=torch.long, device=x.device))
    return x


def _pad_index(n: int, before: int, after: int, mode: str, device) -> torch.Tensor:
    """Source positions of an edge / reflect pad along one axis (numpy's
    rules: reflect mirrors about the edge element without repeating it)."""
    i = torch.arange(-before, n + after, device=device)
    if mode == "edge":
        return i.clamp(0, n - 1)
    if mode == "reflect":
        if n == 1:
            return torch.zeros_like(i)
        p = 2 * (n - 1)
        i = torch.remainder(i, p)
        return torch.where(i > n - 1, p - i, i)
    raise ValueError(f"pad mode {mode!r}")


@registry.register("pad", api=Api.TORCH)
def pad(x, params: PadParams):
    x = x.float()
    widths = list(zip(params.pad_before, params.pad_after))
    if params.pad_mode == "constant":
        flat = []
        for b, a in reversed(widths):
            flat += [b, a]
        return F.pad(x, flat, value=params.pad_value)
    for ax, (b, a) in enumerate(widths):
        if b or a:
            x = x.index_select(ax, _pad_index(x.shape[ax], b, a, params.pad_mode, x.device))
    return x


@registry.register("gather", api=Api.TORCH)
def gather(x, indices, params: GatherParams):
    """jnp.take: a negative index wraps once, one still out of range gives
    NaN (floats), the dtype's lowest value (integers) or True (booleans)."""
    ax = params.axis % x.dim()
    n = x.shape[ax]
    idx = wrap_index(indices, n)
    valid = (idx >= 0) & (idx < n)
    flat = idx.clamp(0, max(n - 1, 0)).reshape(-1)
    out = x.index_select(ax, flat).reshape(x.shape[:ax] + indices.shape + x.shape[ax + 1:])
    fill = float("nan") if x.is_floating_point() else (
        True if x.dtype == torch.bool else torch.iinfo(x.dtype).min)
    v = valid.reshape((1,) * ax + tuple(indices.shape) + (1,) * (x.dim() - ax - 1))
    return torch.where(v, out, torch.full((), fill, dtype=x.dtype, device=x.device))


@registry.register("gather_nd", api=Api.TORCH)
def gather_nd(x, indices, params=None):
    """Array indexing by the last axis of `indices`: each coordinate wraps
    once if negative, then clamps into range (XLA's gather)."""
    d = indices.shape[-1]
    flat = indices.reshape(-1, d)
    coords = tuple(wrap_index(flat[:, i], x.shape[i]).clamp(0, x.shape[i] - 1)
                   for i in range(d))
    return x[coords].reshape(tuple(indices.shape[:-1]) + tuple(x.shape[d:]))


@registry.register("scatter_nd", api=Api.TORCH)
def scatter_nd(indices, updates, params=None, shape=None):
    """zeros(shape).at[indices].add(updates): duplicates add; a row whose
    index is out of range (after one wrap) adds nothing."""
    out = torch.zeros(tuple(shape), dtype=torch.float32, device=updates.device)
    d = indices.shape[-1]
    flat = indices.reshape(-1, d)
    upd = updates.float().reshape((-1,) + tuple(updates.shape[indices.dim() - 1:]))
    coords = [wrap_index(flat[:, i], shape[i]) for i in range(d)]
    valid = torch.ones(flat.shape[0], dtype=torch.bool, device=flat.device)
    for i, c in enumerate(coords):
        valid = valid & (c >= 0) & (c < shape[i])
    coords = tuple(torch.where(valid, c, 0) for c in coords)
    v = valid.reshape((-1,) + (1,) * (upd.dim() - 1))
    upd = torch.where(v, upd, torch.zeros((), dtype=upd.dtype, device=upd.device))
    return out.index_put_(coords, upd, accumulate=True)


@registry.register("tile", api=Api.TORCH)
def tile(x, params: TileParams):
    return x.tile(tuple(params.reps))


@registry.register("squeeze", api=Api.TORCH)
def squeeze(x, params: SqueezeParams):
    if params.axis is None:
        return x.squeeze()
    axes = _axes(params.axis)
    if any(x.shape[a] != 1 for a in axes):
        # jnp.squeeze refuses an axis whose size is not 1; torch would skip it
        raise ValueError(f"cannot squeeze axes {axes} of shape {tuple(x.shape)}")
    return x.squeeze(axes)


@registry.register("expand_dims", api=Api.TORCH)
def expand_dims(x, params: ExpandDimsParams):
    axes = _axes(params.axis)
    nd = x.dim() + len(axes)
    for a in sorted(a % nd for a in axes):
        x = x.unsqueeze(a)
    return x


@registry.register("reverse", api=Api.TORCH)
def reverse(x, params: FlipParams):
    return torch.flip(x, _axes(params.axis))


registry.register("flip", lambda x, params: torch.flip(x, _axes(params.axis)), api=Api.TORCH)


@registry.register("stack", api=Api.TORCH)
def stack(inputs, params: StackParams):
    return torch.stack(list(inputs), dim=params.axis)


@registry.register("unstack", api=Api.TORCH)
def unstack(x, params: StackParams):
    return list(torch.unbind(x, dim=params.axis))


@registry.register("broadcast_to", api=Api.TORCH)
def broadcast_to(x, params: BroadcastToParams):
    return x.expand(tuple(params.shape))


@registry.register("shape", api=Api.TORCH)
def shape_op(x, params=None):
    return torch.tensor(tuple(x.shape), dtype=torch.int32, device=x.device)


@registry.register("ndarray_size", api=Api.TORCH)
def ndarray_size(x, params=None):
    return torch.tensor(x.numel(), dtype=torch.int32, device=x.device)


@registry.register("crop", api=Api.TORCH)
def crop(x, params: CropParams = None, ref_shape=None):
    """Caffe-style crop from params.axis with offsets (ref: shl_ref_crop_f32);
    params precedes ref_shape as in the JAX function."""
    idx, off_i = [], 0
    for i in range(x.dim()):
        if i < params.axis:
            idx.append(slice(None))
        else:
            off = params.offset[off_i] if off_i < len(params.offset) else params.offset[0]
            idx.append(slice(off, off + ref_shape[i]))
            off_i += 1
    return x[tuple(idx)]


@registry.register("depth_to_space", api=Api.TORCH)
def depth_to_space(x, params: DepthToSpaceParams):
    """NCHW DCR/CRD (ref: shl_ref_depth_to_space_f32)."""
    n, c, h, w = x.shape
    b = params.block_size
    if params.mode == "DCR":
        x = x.reshape(n, b, b, c // (b * b), h, w).permute(0, 3, 4, 1, 5, 2)
    else:
        x = x.reshape(n, c // (b * b), b, b, h, w).permute(0, 1, 4, 2, 5, 3)
    return x.reshape(n, c // (b * b), h * b, w * b)


@registry.register("space_to_depth", api=Api.TORCH)
def space_to_depth(x, params: Space2DepthParams):
    n, c, h, w = x.shape
    b = params.block_size
    x = x.reshape(n, c, h // b, b, w // b, b).permute(0, 3, 5, 1, 2, 4)
    return x.reshape(n, c * b * b, h // b, w // b)


@registry.register("reorg", api=Api.TORCH)
def reorg(x, params: Space2DepthParams):
    """YOLO reorg (ref: CSINN_OP_REORG), the channel-major space-to-depth."""
    n, c, h, w = x.shape
    s = params.block_size
    x = x.reshape(n, c, h // s, s, w // s, s).permute(0, 1, 3, 5, 2, 4)
    return x.reshape(n, c * s * s, h // s, w // s)


@registry.register("space_to_batch", api=Api.TORCH)
def space_to_batch(x, params: SpaceToBatchParams):
    n, c = x.shape[:2]
    b = params.block_size
    pt, pd, pl, pr = params.pad
    x = F.pad(x.float(), (pl, pr, pt, pd))
    h2, w2 = x.shape[2], x.shape[3]
    x = x.reshape(n, c, h2 // b, b, w2 // b, b).permute(3, 5, 0, 1, 2, 4)
    return x.reshape(n * b * b, c, h2 // b, w2 // b)


@registry.register("batch_to_space", api=Api.TORCH)
def batch_to_space(x, params: BatchToSpaceParams):
    nb, c, h, w = x.shape
    b = params.block_size
    n = nb // (b * b)
    ct, cd, cl, cr = params.crop
    x = x.float().reshape(b, b, n, c, h, w).permute(2, 3, 4, 0, 5, 1)
    x = x.reshape(n, c, h * b, w * b)
    return x[:, :, ct:h * b - cd, cl:w * b - cr]


@registry.register("shuffle_channel", api=Api.TORCH)
def shuffle_channel(x, params: ShuffleChannelParams):
    n, c, h, w = x.shape
    g = params.group
    return x.reshape(n, g, c // g, h, w).transpose(1, 2).reshape(n, c, h, w)


@registry.register("im2col", api=Api.TORCH)
def im2col(x, params=None, kernel=(3, 3), stride=(1, 1), pad=(0, 0, 0, 0)):
    """NCHW im2col to [N, C*kh*kw, oh*ow] (ref: shl_ref_im2col_f32)."""
    pt, pd, pl, pr = pad
    x = F.pad(x.float(), (pl, pr, pt, pd))
    return F.unfold(x, tuple(kernel), stride=tuple(stride))


@registry.register("sequence_mask", api=Api.TORCH)
def sequence_mask(lengths, params=None, maxlen: int = 0):
    ar = torch.arange(maxlen, dtype=torch.int32, device=lengths.device)
    return ar[None, :] < lengths.int()[:, None]


@registry.register("one_hot", api=Api.TORCH)
def one_hot(x, params: OneHotParams):
    oh = torch.eq(x.int().unsqueeze(params.axis if params.axis >= 0 else -1),
                  torch.arange(params.depth, dtype=torch.int32, device=x.device))
    on = torch.tensor(params.on_value, dtype=torch.float32, device=x.device)
    off = torch.tensor(params.off_value, dtype=torch.float32, device=x.device)
    return torch.where(oh, on, off)


@registry.register("arange", api=Api.TORCH)
def arange(params: ArangeParams, device=None):
    """(ref: shl_ref_arange_f32, source/reference/arange.c.)  The op has no
    input to take a device from: ops.arange passes the session's."""
    n = max(0, int(np.ceil((params.stop - params.start) / params.step)))
    return (params.start + params.step * torch.arange(n, dtype=torch.float32,
                                                      device=device or "cpu"))


@registry.register("cast", api=Api.TORCH)
def cast(x, params=None, dtype=np.float32):
    """CSINN_OP_CAST / DATA_CONVERT raw dtype cast."""
    return x.to(_torch_dtype(dtype))


@registry.register("topk", api=Api.TORCH)
def topk(x, params: TopKParams):
    """The k largest along the last axis, the lower index first among equal
    values (lax.top_k's order): a stable descending sort."""
    v, i = torch.sort(x.float(), dim=-1, descending=True, stable=True)
    return v[..., :params.k], i[..., :params.k].int()


@registry.register("space_to_batch_nd", api=Api.TORCH)
def space_to_batch_nd(x, params: SpaceToBatchNdParams):
    """TF-convention ND space→batch: [N, s1..sM, rest] with per-dim padding
    (ref: shl_gref_space_to_batch_nd_infer_shape)."""
    m = len(params.block_shape)
    flat = []
    for b, a in reversed([(0, 0)] + list(params.pads) + [(0, 0)] * (x.dim() - 1 - m)):
        flat += [b, a]
    x = F.pad(x, flat)
    n = x.shape[0]
    rest = list(x.shape[1 + m:])
    shape = [n]
    for i, b in enumerate(params.block_shape):
        shape += [x.shape[1 + i] // b, b]
    x = x.reshape(shape + rest)
    # [N, o1,b1, o2,b2, ...] → [b1..bM, N, o1..oM, rest]
    perm = [2 * i + 2 for i in range(m)] + [0] + [2 * i + 1 for i in range(m)] \
        + list(range(1 + 2 * m, x.dim()))
    x = x.permute(perm)
    out_batch = n * int(np.prod(params.block_shape))
    return x.reshape([out_batch] + shape[1::2] + rest)


@registry.register("batch_to_space_nd", api=Api.TORCH)
def batch_to_space_nd(x, params: SpaceToBatchNdParams):
    """Inverse of space_to_batch_nd; params.pads acts as crops
    (ref: shl_gref_batch_to_space_nd_infer_shape)."""
    m = len(params.block_shape)
    n = x.shape[0] // int(np.prod(params.block_shape))
    spatial = list(x.shape[1:1 + m])
    rest = list(x.shape[1 + m:])
    x = x.reshape(list(params.block_shape) + [n] + spatial + rest)
    # [b1..bM, N, s1..sM, rest] → [N, s1,b1, s2,b2, ..., rest]
    perm = [m]
    for i in range(m):
        perm += [m + 1 + i, i]
    perm += list(range(2 * m + 1, x.dim()))
    shape = [n] + [spatial[i] * params.block_shape[i] for i in range(m)] + rest
    x = x.permute(perm).reshape(shape)
    idx = [slice(None)]
    for i, (c0, c1) in enumerate(params.pads):
        idx.append(slice(c0, shape[1 + i] - c1))
    return x[tuple(idx)]
