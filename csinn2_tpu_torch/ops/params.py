"""Operator parameter structs (counterpart of csinn2_tpu/ops/params.py:
every struct of that file, with the same field names and defaults).

Re-expression of the reference's ~150 csinn_*_params structs (ref:
include/csinn/csinn_data_structure.h:566-1270); every struct embeds the
common base (name, layout, api routing) like `csinn_params_base`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

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
class Conv1dParams(ParamsBase):
    group: int = 1
    stride: int = 1
    pad: Tuple[int, int] = (0, 0)  # left, right
    dilation: int = 1


@dataclasses.dataclass
class Conv3dParams(ParamsBase):
    group: int = 1
    stride: Tuple[int, int, int] = (1, 1, 1)
    pad: Tuple[int, int, int, int, int, int] = (0, 0, 0, 0, 0, 0)
    dilation: Tuple[int, int, int] = (1, 1, 1)


@dataclasses.dataclass
class Deconv2dParams(ParamsBase):
    """(ref: csinn_conv2d_params reused for deconv + out_pad)."""

    group: int = 1
    stride: Tuple[int, int] = (1, 1)
    pad: Tuple[int, int, int, int] = (0, 0, 0, 0)
    dilation: Tuple[int, int] = (1, 1)
    out_pad: Tuple[int, int] = (0, 0)


@dataclasses.dataclass
class FCParams(ParamsBase):
    """(ref: struct csinn_fc_params, csinn_data_structure.h)."""

    units: int = 0


@dataclasses.dataclass
class PoolParams(ParamsBase):
    """(ref: struct csinn_pool_params)."""

    kernel: Tuple[int, ...] = (2, 2)
    stride: Tuple[int, ...] = (2, 2)
    pad: Tuple[int, ...] = (0, 0, 0, 0)
    count_include_pad: bool = False
    ceil_mode: bool = False


@dataclasses.dataclass
class MatmulParams(ParamsBase):
    """(ref: struct csinn_matmul_params)."""

    trans_a: bool = False
    trans_b: bool = False


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
class NormParams(ParamsBase):
    """layer_norm / rms_norm / l2norm (ref: csinn_layer_norm_params, csinn_rms_norm_params)."""

    epsilon: float = 1e-5
    axis: int = -1
    center: bool = True
    scale: bool = True


@dataclasses.dataclass
class BatchNormParams(ParamsBase):
    epsilon: float = 1e-5


@dataclasses.dataclass
class LRNParams(ParamsBase):
    """(ref: struct csinn_lrn_params)."""

    range: int = 5
    bias: float = 1.0
    alpha: float = 1e-4
    beta: float = 0.75


@dataclasses.dataclass
class ReduceParams(ParamsBase):
    """(ref: struct csinn_reduce_params)."""

    axis: Optional[Sequence[int]] = None
    keepdims: bool = False


@dataclasses.dataclass
class ReshapeParams(ParamsBase):
    shape: Tuple[int, ...] = ()


@dataclasses.dataclass
class TransposeParams(ParamsBase):
    permute: Tuple[int, ...] = ()


@dataclasses.dataclass
class ConcatParams(ParamsBase):
    axis: int = 0


@dataclasses.dataclass
class SplitParams(ParamsBase):
    axis: int = 0
    split_index: Tuple[int, ...] = ()   # boundary indices, ref semantics


@dataclasses.dataclass
class StridedSliceParams(ParamsBase):
    begin: Tuple[int, ...] = ()
    end: Tuple[int, ...] = ()
    stride: Tuple[int, ...] = ()


@dataclasses.dataclass
class SliceParams(ParamsBase):
    begin: Tuple[int, ...] = ()
    end: Tuple[int, ...] = ()


@dataclasses.dataclass
class PadParams(ParamsBase):
    """(ref: struct csinn_pad_params)."""

    pad_before: Tuple[int, ...] = ()
    pad_after: Tuple[int, ...] = ()
    pad_mode: str = "constant"  # constant | edge | reflect
    pad_value: float = 0.0


@dataclasses.dataclass
class GatherParams(ParamsBase):
    axis: int = 0


@dataclasses.dataclass
class TileParams(ParamsBase):
    reps: Tuple[int, ...] = ()


@dataclasses.dataclass
class SqueezeParams(ParamsBase):
    axis: Optional[Tuple[int, ...]] = None


@dataclasses.dataclass
class ExpandDimsParams(ParamsBase):
    axis: int = 0


@dataclasses.dataclass
class FlipParams(ParamsBase):
    axis: Tuple[int, ...] = (0,)


@dataclasses.dataclass
class ResizeParams(ParamsBase):
    """(ref: struct csinn_resize_params)."""

    mode: str = "bilinear"  # nearest | bilinear
    align_corners: bool = False
    target_size: Tuple[int, int] = (0, 0)


@dataclasses.dataclass
class Space2DepthParams(ParamsBase):
    block_size: int = 2


@dataclasses.dataclass
class ShuffleChannelParams(ParamsBase):
    group: int = 1


@dataclasses.dataclass
class OneHotParams(ParamsBase):
    depth: int = 0
    axis: int = -1
    on_value: float = 1.0
    off_value: float = 0.0


@dataclasses.dataclass
class TopKParams(ParamsBase):
    k: int = 1


@dataclasses.dataclass
class ArgParams(ParamsBase):
    axis: int = 0
    keepdims: bool = False


@dataclasses.dataclass
class StackParams(ParamsBase):
    axis: int = 0


@dataclasses.dataclass
class EmbeddingParams(ParamsBase):
    pass


@dataclasses.dataclass
class RopeParams(ParamsBase):
    """(ref: struct csinn_rope_params — freq_base/freq_scale/pos offsets,
    csinn_data_structure.h:1220-1235)."""

    head_dim: int = 0
    freq_base: float = 10000.0
    freq_scale: float = 1.0
    pos_offset: int = 0
    use_rope_cache: bool = False


@dataclasses.dataclass
class SDPAParams(ParamsBase):
    """(ref: struct csinn_scale_dot_attention_params)."""

    norm_factor: float = 0.0   # 0 → 1/sqrt(head_dim)
    causal: bool = True
    pos_offset: int = 0        # kv positions already in cache (decode)
    kv_len: int = 0            # valid kv entries (0 → all of sk); with
                               # pos_offset this is the graph-mode route to
                               # decode over a static, partially-filled cache


@dataclasses.dataclass
class LlmPosParams(ParamsBase):
    """KV-cache copy-in/copy-out/mask ops
    (ref: struct csinn_llm_pos_params, csinn_data_structure.h:1237-1252)."""

    mode: str = "cache_in"  # cache_in | cache_out | mask
    pos: int = 0
    cache: object = None


@dataclasses.dataclass
class CacheMatmulParams(ParamsBase):
    """Streaming-ASR cache matmul (ref: struct csinn_cache_matmul_params,
    csinn_data_structure.h:1170-1182; kernels source/c906_opt/fp16/cache_matmul.c)."""

    cache_shape: Tuple[int, ...] = ()
    shape: Tuple[int, ...] = ()
    axes: Tuple[int, ...] = ()


@dataclasses.dataclass
class CacheConv1dParams(ParamsBase):
    """(ref: struct csinn_cache_conv1d_params, csinn_data_structure.h:1184-1198)."""

    cache_shape: Tuple[int, ...] = ()
    group: int = 1
    stride: int = 1
    pad: Tuple[int, int] = (0, 0)
    dilation: int = 1


@dataclasses.dataclass
class FSMNParams(ParamsBase):
    """(ref: struct csinn_fsmn_params)."""

    l_order: int = 1
    r_order: int = 1
    l_stride: int = 1
    r_stride: int = 1
    unavailable_frames: int = 0


@dataclasses.dataclass
class DepthToSpaceParams(ParamsBase):
    block_size: int = 2
    mode: str = "DCR"  # DCR | CRD


@dataclasses.dataclass
class CropParams(ParamsBase):
    axis: int = 1
    offset: Tuple[int, ...] = ()


@dataclasses.dataclass
class BroadcastToParams(ParamsBase):
    shape: Tuple[int, ...] = ()


@dataclasses.dataclass
class CumsumParams(ParamsBase):
    axis: int = -1
    exclusive: bool = False


@dataclasses.dataclass
class SegmentParams(ParamsBase):
    num_segments: int = 0
    unsorted: bool = False


@dataclasses.dataclass
class SpaceToBatchParams(ParamsBase):
    block_size: int = 2
    pad: Tuple[int, int, int, int] = (0, 0, 0, 0)


@dataclasses.dataclass
class BatchToSpaceParams(ParamsBase):
    block_size: int = 2
    crop: Tuple[int, int, int, int] = (0, 0, 0, 0)


@dataclasses.dataclass
class SpaceToBatchNdParams(ParamsBase):
    """(ref: struct csinn_space_to_batch_nd_params /
    csinn_batch_to_space_nd_params).  `pads` doubles as crops for the
    batch_to_space_nd direction; one (before, after) pair per spatial dim."""

    block_shape: Tuple[int, ...] = (2, 2)
    pads: Tuple[Tuple[int, int], ...] = ((0, 0), (0, 0))


@dataclasses.dataclass
class ArangeParams(ParamsBase):
    """(ref: struct csinn_arange_params)."""

    start: float = 0.0
    stop: float = 0.0
    step: float = 1.0


@dataclasses.dataclass
class RoiAlignParams(ParamsBase):
    """(ref: struct csinn_roi_align_params)."""

    pooled_size: Tuple[int, int] = (7, 7)
    spatial_scale: float = 1.0
    sample_ratio: int = -1


@dataclasses.dataclass
class PSROIPoolingParams(ParamsBase):
    """(ref: struct csinn_psroipooling_params)."""

    output_dim: int = 1
    group_size: int = 7
    spatial_scale: float = 1.0


@dataclasses.dataclass
class ProposalParams(ParamsBase):
    """RPN proposal (ref: struct csinn_proposal_params, source/reference/proposal.c)."""

    scales: Tuple[float, ...] = (8.0, 16.0, 32.0)
    ratios: Tuple[float, ...] = (0.5, 1.0, 2.0)
    feature_stride: int = 16
    threshold: float = 0.7           # NMS IoU threshold
    rpn_pre_nms_top_n: int = 6000
    rpn_post_nms_top_n: int = 300
    rpn_min_size: int = 16


@dataclasses.dataclass
class StridedReduceParams(ParamsBase):
    """Generalized strided reduction (ref: csinn_reduce_params
    out_strides/out_extents/inner_strides/inner_extents fields, used by
    CSINN_OP_MEAN_STRIDE / MIN_STRIDE, source/reference/mean.c:21-54)."""

    out_strides: Tuple[int, ...] = ()
    out_extents: Tuple[int, ...] = ()
    inner_strides: Tuple[int, ...] = ()
    inner_extents: Tuple[int, ...] = ()
