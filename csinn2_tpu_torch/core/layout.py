"""Logical layout axes (counterpart of csinn2_tpu/core/layout.py;
`channel_axis`.  The layout converters and `spatial_axes` are not ported
yet)."""

from __future__ import annotations

from csinn2_tpu_torch.core.dtypes import Layout


def channel_axis(layout: Layout) -> int:
    return {
        Layout.NCHW: 1, Layout.NHWC: 3, Layout.NCW: 1, Layout.NWC: 2,
        Layout.NC: 1, Layout.NCDHW: 1, Layout.NDHWC: 4,
        Layout.OIHW: 0, Layout.OHWI: 0, Layout.OI: 0, Layout.O1HW: 0,
    }[layout]

