"""The rest of the zoo: resize, maxpool2d_locat, unpooling, col2im, roipool,
non_max_suppression, yuv_rgb_scale (counterpart of
csinn2_tpu/ops/ref/misc.py).

(ref: source/reference/{resize,roipool,non_max_suppression,unpooling,
col2im,yuv_rgb_scale,maxpool2d_locat}.c.)  `resize` follows
jax.image.resize, not F.interpolate: "nearest" samples the half-pixel
centres (torch's "nearest-exact"), and "bilinear" is a triangle filter
whose weights are renormalized over the samples inside the image and which
widens by 1/scale when downsampling (an antialiased resize; upsampling
equals F.interpolate's bilinear, align_corners=False).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from csinn2_tpu_torch.core.dtypes import Api, Layout
from csinn2_tpu_torch.ops.params import PoolParams, ResizeParams
from csinn2_tpu_torch.ops.registry import registry

_EPS_F32 = float(np.finfo(np.float32).eps)


def _nearest_index(m: int, n: int, device) -> torch.Tensor:
    """jax.image.resize's nearest source rows: floor((i + 0.5)·m / n) in f32."""
    return torch.floor((torch.arange(n, dtype=torch.float32, device=device) + 0.5) * m / n).long()


def _triangle_weights(m: int, n: int, device) -> torch.Tensor:
    """jax.image's compute_weight_mat for the triangle kernel: [m, n]."""
    scale = n / m
    inv_scale = 1.0 / scale
    kernel_scale = max(inv_scale, 1.0)
    sample_f = (torch.arange(n, dtype=torch.float32, device=device) + 0.5) * inv_scale - 0.5
    x = torch.abs(sample_f[None, :] - torch.arange(m, dtype=torch.float32,
                                                   device=device)[:, None]) / kernel_scale
    w = torch.clamp_min(1.0 - torch.abs(x), 0.0)
    total = torch.sum(w, dim=0, keepdim=True)
    w = torch.where(torch.abs(total) > 1000.0 * _EPS_F32,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample_f >= -0.5) & (sample_f <= m - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def _interp_axis(x, idx, axis):
    lo = torch.floor(idx).long()
    hi = torch.clamp(lo + 1, 0, x.shape[axis] - 1)
    frac = (idx - lo).float()
    xl, xh = x.index_select(axis, lo), x.index_select(axis, hi)
    shape = [1] * x.dim()
    shape[axis] = -1
    return xl + (xh - xl) * frac.reshape(shape)


@registry.register("resize", api=Api.TORCH)
def resize(x, params: ResizeParams):
    """Nearest / bilinear spatial resize, NCHW or NHWC (ref: shl_ref_resize_f32)."""
    x = x.float()
    spatial = (2, 3) if params.layout == Layout.NCHW else (1, 2)
    target = tuple(params.target_size)
    if params.align_corners and params.mode != "nearest":
        # the grid's end points map to the input's end points
        for ax, t in zip(spatial, target):
            idx = torch.linspace(0.0, x.shape[ax] - 1, t, dtype=torch.float32, device=x.device)
            x = _interp_axis(x, idx, ax)
        return x
    for ax, n in zip(spatial, target):
        m = x.shape[ax]
        if m == n:
            continue
        if params.mode == "nearest":
            x = x.index_select(ax, _nearest_index(m, n, x.device))
        else:
            w = _triangle_weights(m, n, x.device)
            x = torch.movedim(torch.movedim(x, ax, -1) @ w, -1, ax)
    return x


@registry.register("maxpool2d_locat", api=Api.TORCH)
def maxpool2d_locat(x, params: PoolParams):
    """Max-pool that also outputs each window's flat argmax index h·W + w
    of the unpadded input, int32 (ref: shl_ref_maxpool2d_locat_f32), NCHW;
    the first maximum in window order wins."""
    x = x.float()
    n, c, h, w = x.shape
    kh, kw = params.kernel
    sh, sw = params.stride
    pt, pd, pl, pr = params.pad
    xp = F.pad(x, (pl, pr, pt, pd), value=float("-inf"))
    hh = torch.arange(xp.shape[2], device=x.device) - pt
    ww = torch.arange(xp.shape[3], device=x.device) - pl
    flat = (hh[:, None] * w + ww[None, :]).float()
    oh = (xp.shape[2] - kh) // sh + 1
    ow = (xp.shape[3] - kw) // sw + 1
    vals = torch.full((n, c, oh, ow), float("-inf"), device=x.device)
    locs = torch.zeros((n, c, oh, ow), device=x.device)
    for di in range(kh):
        for dj in range(kw):
            sub = xp[:, :, di:di + oh * sh:sh, dj:dj + ow * sw:sw]
            loc = flat[di:di + oh * sh:sh, dj:dj + ow * sw:sw]
            take = sub > vals
            vals = torch.where(take, sub, vals)
            locs = torch.where(take, loc[None, None], locs)
    return vals, locs.int()


@registry.register("unpooling", api=Api.TORCH)
def unpooling(x, mask, params=None, out_hw=None):
    """Scatter pooled values back to their argmax locations
    (ref: shl_ref_unpooling_f32), NCHW; mask holds flat h·W + w indices."""
    x = x.float()
    n, c = x.shape[:2]
    oh, ow = out_hw
    flat = torch.zeros((n, c, oh * ow), device=x.device)
    flat.scatter_(2, mask.long().reshape(n, c, -1), x.reshape(n, c, -1))
    return flat.reshape(n, c, oh, ow)


@registry.register("col2im", api=Api.TORCH)
def col2im(x, params=None, out_shape=None, kernel=(3, 3), stride=(1, 1), pad=(0, 0)):
    """Inverse of im2col, overlapping patches summed (ref: shl_ref_col2im_f32).
    x [N, C*kh*kw, L]."""
    n, ckk, _ = x.shape
    kh, kw = kernel
    c = ckk // (kh * kw)
    oh, ow = out_shape
    sh, sw = stride
    ph, pw = pad
    cols_h = (oh + 2 * ph - kh) // sh + 1
    cols_w = (ow + 2 * pw - kw) // sw + 1
    x = x.float().reshape(n, c, kh, kw, cols_h, cols_w)
    out = torch.zeros((n, c, oh + 2 * ph, ow + 2 * pw), device=x.device)
    for di in range(kh):
        for dj in range(kw):
            out[:, :, di:di + cols_h * sh:sh, dj:dj + cols_w * sw:sw] += x[:, :, di, dj]
    return out[:, :, ph:ph + oh, pw:pw + ow]


def bin_mask(start, end, size: int):
    """[R, bins, size]: position p lies in [start, end) of the bin."""
    p = torch.arange(size, device=start.device)
    return (p >= start[..., None]) & (p < end[..., None])


@registry.register("roipool", api=Api.TORCH)
def roipool(x, rois, params=None, pooled_size=(7, 7), spatial_scale=1.0):
    """ROI max pooling (ref: shl_ref_roipool_f32).  rois [R, 5] (batch, x1,
    y1, x2, y2); rounded corners, floor / ceil bin edges, an empty bin 0.
    The masked max over a bin's rows and columns runs as a max over the
    columns, then over the rows (the same maximum)."""
    x = x.float()
    rois = rois.float()
    ph, pw = pooled_size
    h, w = x.shape[2], x.shape[3]
    b = rois[:, 0].int().long()
    x1, y1, x2, y2 = (torch.round(rois[:, i] * spatial_scale).int() for i in range(1, 5))
    rw = torch.clamp_min(x2 - x1 + 1, 1)
    rh = torch.clamp_min(y2 - y1 + 1, 1)
    i = torch.arange(ph, device=x.device, dtype=torch.int32)
    j = torch.arange(pw, device=x.device, dtype=torch.int32)
    fl = lambda a, d: torch.div(a, d, rounding_mode="floor")   # noqa: E731
    hs = y1[:, None] + fl(i[None] * rh[:, None], ph)
    he = y1[:, None] + fl((i[None] + 1) * rh[:, None] + ph - 1, ph)
    ws = x1[:, None] + fl(j[None] * rw[:, None], pw)
    we = x1[:, None] + fl((j[None] + 1) * rw[:, None] + pw - 1, pw)
    mh, mw = bin_mask(hs, he, h), bin_mask(ws, we, w)        # [R, ph, H], [R, pw, W]
    fmap = x[b]                                                 # [R, C, H, W]
    ninf = torch.full((), float("-inf"), device=x.device)
    cols = torch.where(mw[:, None, None], fmap[:, :, :, None, :], ninf).amax(-1)  # [R,C,H,pw]
    out = torch.where(mh[:, None, :, :, None], cols[:, :, None], ninf).amax(3)  # [R,C,ph,pw]
    return torch.where(torch.isfinite(out), out, torch.zeros((), device=x.device))


def nms_keep(boxes, scores, iou_threshold: float, max_out: int) -> torch.Tensor:
    """Greedy NMS: indices of the kept boxes in score order (ties by lower
    index), padded with -1 to max_out, int32.  The IoU matrix is one
    vectorised computation on the boxes' device; the greedy pass then runs
    on the host over one copy of it (one synchronization, not one a box)."""
    if boxes.is_meta:
        return torch.empty((max_out,), dtype=torch.int32, device="meta")
    n = boxes.shape[0]
    order = torch.argsort(-scores, stable=True)
    tl = torch.maximum(boxes[:, None, :2], boxes[None, :, :2])
    br = torch.minimum(boxes[:, None, 2:], boxes[None, :, 2:])
    wh = torch.clamp_min(br - tl, 0.0)
    inter = wh[..., 0] * wh[..., 1]
    area = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
    iou = inter / torch.clamp_min(area[:, None] + area[None, :] - inter, 1e-9)
    over = (iou > iou_threshold).cpu().numpy()
    keep = np.full((max_out,), -1, np.int32)
    suppressed = np.zeros((n,), bool)
    count = 0
    for idx in order.cpu().numpy():
        if suppressed[idx] or count >= max_out:
            continue
        keep[count] = idx
        suppressed |= over[idx]
        count += 1
    return torch.from_numpy(keep).to(boxes.device)


@registry.register("non_max_suppression", api=Api.TORCH)
def non_max_suppression(boxes, scores, params=None, iou_threshold=0.5, max_out=100):
    """Greedy NMS returning selected indices padded with -1
    (ref: shl_ref_non_max_suppression_std)."""
    return nms_keep(boxes.float(), scores.float(), iou_threshold, max_out)


@registry.register("yuv_rgb_scale", api=Api.TORCH)
def yuv_rgb_scale(x, params=None):
    """YUV→RGB (ref: shl_ref_yuv_rgb_scale_f32); x [N, 3, H, W] YUV."""
    x = x.float()
    y, u, v = x[:, 0], x[:, 1], x[:, 2]
    return torch.stack([y + 1.13983 * v, y - 0.39465 * u - 0.58060 * v, y + 2.03211 * u], dim=1)
