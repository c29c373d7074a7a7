"""Operator parameter structs (counterpart of csinn2_tpu/ops/params.py; the
structs of the ops this package runs so far: conv, fc, matmul, pool,
softmax, relu, clip, prelu, sigmoid, scaled-dot-product attention).

Re-expression of the reference's csinn_*_params structs (ref:
include/csinn/csinn_data_structure.h:566-1270); every struct embeds the
common base (name, layout, api routing) like `csinn_params_base`.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

from csinn2_tpu_torch.core.dtypes import Api, Layout


@dataclasses.dataclass
class ParamsBase:
    """(ref: struct csinn_params_base, csinn_data_structure.h:566-575)."""

    name: str = ""
    layout: Layout = Layout.NCHW
    api: Api = Api.AUTO


@dataclasses.dataclass
class Conv2dParams(ParamsBase):
    """(ref: struct csinn_conv2d_params, csinn_data_structure.h:676-700)."""

    group: int = 1
    stride: Tuple[int, int] = (1, 1)
    pad: Tuple[int, int, int, int] = (0, 0, 0, 0)  # top, down, left, right
    dilation: Tuple[int, int] = (1, 1)
    fuse_relu: bool = False     # CONV2D_RELU fused variant
    fuse_relu6: bool = False
    # residual input fused into the conv epilogue (conv + bias + residual →
    # activation → one requantize: the ResNet / MobileNetV2 join)
    fuse_add: bool = False
    fuse_hswish: bool = False   # x·relu6(x+3)/6 in the epilogue (MobileNetV3)


@dataclasses.dataclass
class FCParams(ParamsBase):
    """(ref: struct csinn_fc_params, csinn_data_structure.h)."""

    units: int = 0


@dataclasses.dataclass
class MatmulParams(ParamsBase):
    """(ref: struct csinn_matmul_params)."""

    trans_a: bool = False
    trans_b: bool = False


@dataclasses.dataclass
class PoolParams(ParamsBase):
    """(ref: struct csinn_pool_params)."""

    kernel: Tuple[int, ...] = (2, 2)
    stride: Tuple[int, ...] = (2, 2)
    pad: Tuple[int, ...] = (0, 0, 0, 0)
    count_include_pad: bool = False
    ceil_mode: bool = False


@dataclasses.dataclass
class SoftmaxParams(ParamsBase):
    axis: int = -1


@dataclasses.dataclass
class ReluParams(ParamsBase):
    """n used by leaky_relu slope / relun bound (ref: csinn_relu_params)."""

    n: float = 0.0


@dataclasses.dataclass
class ClipParams(ParamsBase):
    min_value: float = 0.0
    max_value: float = 6.0


@dataclasses.dataclass
class PReluParams(ParamsBase):
    axis: int = 1


@dataclasses.dataclass
class SigmoidParams(ParamsBase):
    pass


@dataclasses.dataclass
class SDPAParams(ParamsBase):
    """(ref: struct csinn_scale_dot_attention_params)."""

    norm_factor: float = 0.0   # 0 → 1/sqrt(head_dim)
    causal: bool = True
    pos_offset: int = 0        # kv positions already in cache (decode)
    kv_len: int = 0            # valid kv entries (0 → all of sk); with
                               # pos_offset this is the graph-mode route to
                               # decode over a static, partially-filled cache
