"""Float convolution (counterpart of csinn2_tpu/ops/ref/conv.py: conv2d,
depthwise_conv2d and group_conv2d with the fused residual and hardswish
epilogues, conv1d (NCW / NWC, grouped and depthwise), conv3d, and the
transposed deconv2d / deconv3d with their grouped and depthwise names).

(ref: source/reference/convolution.c.)  NHWC activations stay NHWC: the
convolution sees them as a channels_last view (`x.permute(0, 3, 1, 2)`, no
copy), so cuDNN takes its NHWC kernels on the card.  TF32 is off inside
`full_f32()`: cuDNN convolves f32 in TF32 by default, which would move the
card's float graph (and so its calibration ranges) away from the CPU's.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch
import torch.nn.functional as F

from csinn2_tpu_torch.core.dtypes import Api, Layout
from csinn2_tpu_torch.ops.params import Conv1dParams, Conv2dParams, Conv3dParams, Deconv2dParams
from csinn2_tpu_torch.ops.registry import registry


@contextlib.contextmanager
def full_f32():
    """f32 convolutions and matmuls in full f32 (no TF32) on the card."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def to_nchw(x: torch.Tensor, layout: Layout) -> torch.Tensor:
    """NCHW view of an activation (channels_last strides for NHWC data)."""
    return x.permute(0, 3, 1, 2) if layout == Layout.NHWC else x


def from_nchw(y: torch.Tensor, layout: Layout) -> torch.Tensor:
    return y.permute(0, 2, 3, 1) if layout == Layout.NHWC else y


def weight_oihw(w: torch.Tensor, w_layout: Layout) -> torch.Tensor:
    """Weights arrive OIHW (or the depthwise O1HW view) or OHWI."""
    if w_layout in (Layout.OIHW, Layout.O1HW):
        return w
    if w_layout == Layout.OHWI:
        return w.permute(0, 3, 1, 2)
    raise ValueError(f"bad weight layout {w_layout}")


def conv_nchw(x: torch.Tensor, w: torch.Tensor, params: Conv2dParams) -> torch.Tensor:
    """F.conv2d with the (top, down, left, right) pads of csinn_conv2d_params."""
    pt, pd, pl, pr = params.pad
    if pt == pd and pl == pr:
        return F.conv2d(x, w, None, tuple(params.stride), (pt, pl),
                        tuple(params.dilation), params.group)
    return F.conv2d(F.pad(x, (pl, pr, pt, pd)), w, None, tuple(params.stride), 0,
                    tuple(params.dilation), params.group)


_INV6 = 1.0 / 6.0


def hswish(y: torch.Tensor) -> torch.Tensor:
    """x·relu6(x + 3)·(1/6), in the order the JAX package writes it."""
    return y * torch.clamp(y + 3.0, 0.0, 6.0) * _INV6


@registry.register("conv2d", api=Api.TORCH)
def conv2d(x, weight, bias, *rest, w_layout: Layout = Layout.OIHW):
    """Grouped/depthwise 2-D convolution, f32.  x in params.layout; weight
    [O, I/g, kh, kw] (OIHW view); pad = (top, down, left, right).
    rest: (params,) or (residual, params) — a fused residual (params.fuse_add,
    already dequantized by the generic dispatch) adds into the output before
    the fused activation."""
    params: Conv2dParams = rest[-1]
    residual = rest[0] if len(rest) > 1 else None
    w = weight_oihw(weight.float(), w_layout)
    with full_f32():
        out = from_nchw(conv_nchw(to_nchw(x.float(), params.layout), w, params),
                        params.layout)
    if bias is not None and bias.numel() > 0:
        caxis = 1 if params.layout == Layout.NCHW else 3
        out = out + bias.float().reshape([-1 if i == caxis else 1 for i in range(4)])
    if residual is not None:
        out = out + residual.float()
    if params.fuse_relu:
        out = torch.clamp_min(out, 0.0)
    if params.fuse_relu6:
        out = torch.clamp(out, 0.0, 6.0)
    if params.fuse_hswish:
        out = hswish(out)
    return out.contiguous()


@registry.register("depthwise_conv2d", api=Api.TORCH)
def depthwise_conv2d(x, weight, bias, params: Conv2dParams, w_layout: Layout = Layout.OIHW):
    """Depthwise = grouped conv with group == C_in; weight [C,1,kh,kw]."""
    cin = x.shape[1] if params.layout == Layout.NCHW else x.shape[3]
    return conv2d(x, weight, bias, dataclasses.replace(params, group=cin), w_layout=w_layout)


@registry.register("group_conv2d", api=Api.TORCH)
def group_conv2d(x, weight, bias, params: Conv2dParams, w_layout: Layout = Layout.OIHW):
    return conv2d(x, weight, bias, params, w_layout=w_layout)


def _bias(out, bias, caxis: int = 1):
    if bias is None or bias.numel() == 0:
        return out
    return out + bias.float().reshape([-1 if i == caxis else 1 for i in range(out.dim())])


@registry.register("conv1d", api=Api.TORCH)
def conv1d(x, weight, bias, params: Conv1dParams):
    """x [N, C, W] (NCW) with weight [O, I/g, kw], or x [N, W, C] (NWC)
    with weight [O, kw, I/g]; pad = (left, right)."""
    nwc = params.layout not in (Layout.NCW, Layout.NCHW)
    x, w = x.float(), weight.float()
    if nwc:
        x, w = x.permute(0, 2, 1), w.permute(0, 2, 1)
    pl, pr = params.pad
    with full_f32():
        if pl == pr:
            out = F.conv1d(x, w, None, params.stride, pl, params.dilation, params.group)
        else:
            out = F.conv1d(F.pad(x, (pl, pr)), w, None, params.stride, 0, params.dilation,
                           params.group)
    out = _bias(out, bias)
    return out.permute(0, 2, 1).contiguous() if nwc else out


@registry.register("conv3d", api=Api.TORCH)
def conv3d(x, weight, bias, params: Conv3dParams):
    """x [N, C, D, H, W]; weight [O, I/g, kd, kh, kw]; pad = (d0, d1, h0, h1,
    w0, w1) (ref: shl_ref_conv3d_f32)."""
    p = params.pad
    with full_f32():
        out = F.conv3d(F.pad(x.float(), (p[4], p[5], p[2], p[3], p[0], p[1])),
                       weight.float(), None, tuple(params.stride), 0,
                       tuple(params.dilation), params.group)
    return _bias(out, bias)


def _crop_full(out, pads, out_pad):
    """The full transposed convolution (padding 0) cut to the JAX lowering's
    output: `pads` (before, after) come off each spatial axis and out_pad
    zeros go on after (F.pad with negative widths crops)."""
    flat = []
    for (b, a), op in reversed(list(zip(pads, out_pad))):
        flat += [-b, op - a]
    return F.pad(out, flat)


@registry.register("deconv2d", api=Api.TORCH)
def deconv2d(x, weight, bias, params: Deconv2dParams):
    """Transposed conv (ref: shl_ref_deconv2d_f32); weight [I, O/g, kh, kw],
    NCHW.  The JAX function convolves the stride-dilated input with the
    flipped kernel at pads (d·(k−1) − p0, d·(k−1) − p1 + out_pad): the same
    as the full F.conv_transpose2d with p0 taken off the front and
    p1 − out_pad off the back, which also covers p0 != p1."""
    pt, pd, pl, pr = params.pad
    with full_f32():
        out = F.conv_transpose2d(x.float(), weight.float(), None, tuple(params.stride), 0, 0,
                                 params.group, tuple(params.dilation))
    return _bias(_crop_full(out, ((pt, pd), (pl, pr)), params.out_pad), bias)


@registry.register("deconv3d", api=Api.TORCH)
def deconv3d(x, weight, bias, params: Conv3dParams):
    """Transposed 3-D conv (ref: shl_ref_deconv3d_f32); x [N, C, D, H, W],
    weight [I, O/g, kd, kh, kw], as deconv2d."""
    p = params.pad
    with full_f32():
        out = F.conv_transpose3d(x.float(), weight.float(), None, tuple(params.stride), 0, 0,
                                 params.group, tuple(params.dilation))
    return _bias(_crop_full(out, ((p[0], p[1]), (p[2], p[3]), (p[4], p[5])), (0, 0, 0)), bias)


# grouped / depthwise names: the reference registers them as distinct
# CSINN_OP_* entries; the group count in params carries the semantics
registry.register("depthwise_conv1d", conv1d, api=Api.TORCH)
registry.register("group_conv1d", conv1d, api=Api.TORCH)
registry.register("depthwise_deconv2d", deconv2d, api=Api.TORCH)
registry.register("group_deconv2d", deconv2d, api=Api.TORCH)
