"""Logical layout conversion at graph edges (counterpart of
csinn2_tpu/core/layout.py).

(ref: csinn_tensor_layout_convert, source/nn2/utils.c:1855-1867, and the RVV
pack1ton/packnto1 converters.)  Only logical permutes exist here: `convert`
returns a permuted view, and the op that reads it decides whether a copy is
made (cuDNN takes an NHWC view as channels_last without one).
"""

from __future__ import annotations

from csinn2_tpu_torch.core.dtypes import Layout

# axis permutations between logical layouts, keyed by (src, dst)
_PERMS = {
    (Layout.NCHW, Layout.NHWC): (0, 2, 3, 1),
    (Layout.NHWC, Layout.NCHW): (0, 3, 1, 2),
    (Layout.NCW, Layout.NWC): (0, 2, 1),
    (Layout.NWC, Layout.NCW): (0, 2, 1),
    (Layout.NCDHW, Layout.NDHWC): (0, 2, 3, 4, 1),
    (Layout.NDHWC, Layout.NCDHW): (0, 4, 1, 2, 3),
    (Layout.OIHW, Layout.OHWI): (0, 2, 3, 1),
    (Layout.OHWI, Layout.OIHW): (0, 3, 1, 2),
    (Layout.OIHW, Layout.HWO1): (2, 3, 0, 1),   # depthwise O1HW view
    (Layout.OI, Layout.OI): (0, 1),
}


def convert(x, src: Layout, dst: Layout):
    if src == dst:
        return x
    perm = _PERMS.get((src, dst))
    if perm is None:
        raise ValueError(f"no layout conversion {src} -> {dst}")
    return x.permute(perm)


def to_channels_last(x, layout: Layout):
    """The activation in channels-last order, and its new layout."""
    if layout == Layout.NCHW:
        return convert(x, Layout.NCHW, Layout.NHWC), Layout.NHWC
    if layout == Layout.NCW:
        return convert(x, Layout.NCW, Layout.NWC), Layout.NWC
    if layout == Layout.NCDHW:
        return convert(x, Layout.NCDHW, Layout.NDHWC), Layout.NDHWC
    return x, layout


def from_channels_last(x, orig_layout: Layout):
    """Restore the caller's logical layout after a channels-last compute."""
    if orig_layout == Layout.NCHW:
        return convert(x, Layout.NHWC, Layout.NCHW)
    if orig_layout == Layout.NCW:
        return convert(x, Layout.NWC, Layout.NCW)
    if orig_layout == Layout.NCDHW:
        return convert(x, Layout.NDHWC, Layout.NCDHW)
    return x


def channel_axis(layout: Layout) -> int:
    return {
        Layout.NCHW: 1, Layout.NHWC: 3, Layout.NCW: 1, Layout.NWC: 2,
        Layout.NC: 1, Layout.NCDHW: 1, Layout.NDHWC: 4,
        Layout.OIHW: 0, Layout.OHWI: 0, Layout.OI: 0, Layout.O1HW: 0,
    }[layout]


def spatial_axes(layout: Layout):
    return {
        Layout.NCHW: (2, 3), Layout.NHWC: (1, 2),
        Layout.NCW: (2,), Layout.NWC: (1,),
        Layout.NCDHW: (2, 3, 4), Layout.NDHWC: (1, 2, 3),
    }[layout]
