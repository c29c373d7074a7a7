#!/usr/bin/env python3
"""Every op of the zoo through the op API on a device, held against the
same call on the CPU plain path.

    python3 -m csinn2_tpu_torch.examples.op_zoo [--device cuda]

CASES holds one or more small seeded calls of each op that the op API
registers beyond the CNN models' and the LLM's (shape and index ops,
reductions, segments, norms, the conv1d / conv3d / deconv family,
embedding, resize, detection, the sequence and streaming-ASR cache ops).  A
case is a function of an `ops` namespace — this package's, or the JAX
package's, which the CPU tests hold it to — and returns the op's Tensor or
tuple of Tensors; its tolerance applies to the float arrays of the result
(0: bit for bit), and arrays of integers or booleans always match bit for
bit.  `run(device)` records each case into a GRAPH Session on `device`
(output shapes inferred on meta tensors), runs it, and compares it with the
eager call on the CPU; it raises naming every case that differs.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

_R = np.random.default_rng(7)
X34 = _R.standard_normal((3, 4)).astype(np.float32)
X2345 = _R.standard_normal((2, 3, 4, 5)).astype(np.float32)
B34 = _R.standard_normal((3, 4)).astype(np.float32)
S2D = _R.standard_normal((1, 2, 6, 6)).astype(np.float32)
S2D8 = _R.standard_normal((1, 8, 6, 6)).astype(np.float32)
D2S = _R.standard_normal((1, 8, 3, 3)).astype(np.float32)
B2S = _R.standard_normal((4, 2, 3, 3)).astype(np.float32)
IM = _R.standard_normal((1, 2, 5, 5)).astype(np.float32)
YUV = _R.standard_normal((1, 3, 4, 4)).astype(np.float32)
X1D = _R.standard_normal((2, 6, 12)).astype(np.float32)
W1D = (_R.standard_normal((9, 2, 3)) * 0.3).astype(np.float32)
W1DG = (_R.standard_normal((6, 1, 3)) * 0.3).astype(np.float32)
W1DF = (_R.standard_normal((8, 6, 5)) * 0.3).astype(np.float32)
B9 = _R.standard_normal((9,)).astype(np.float32)
X3D = _R.standard_normal((1, 3, 6, 7, 8)).astype(np.float32)
W3D = (_R.standard_normal((5, 3, 3, 3, 3)) * 0.2).astype(np.float32)
XD3 = _R.standard_normal((1, 3, 4, 5, 6)).astype(np.float32)
WD3 = (_R.standard_normal((3, 4, 2, 3, 3)) * 0.2).astype(np.float32)
XDC = _R.standard_normal((1, 6, 7, 7)).astype(np.float32)
WDC = (_R.standard_normal((6, 2, 3, 3)) * 0.3).astype(np.float32)
WDW = (_R.standard_normal((6, 1, 3, 3)) * 0.3).astype(np.float32)
WDO = (_R.standard_normal((6, 4, 3, 3)) * 0.3).astype(np.float32)
B4 = _R.standard_normal((4,)).astype(np.float32)
SEG = _R.standard_normal((6, 3)).astype(np.float32)
IMG = _R.standard_normal((1, 2, 4, 4)).astype(np.float32)
IMG8 = _R.standard_normal((1, 3, 8, 8)).astype(np.float32)
FMAP = _R.standard_normal((1, 3, 12, 12)).astype(np.float32)
FMAP16 = _R.standard_normal((1, 3, 16, 16)).astype(np.float32)
PSMAP = _R.standard_normal((1, 18, 12, 12)).astype(np.float32)
ROIS = np.array([[0, 1, 1, 8, 8], [0, 0, 0, 11, 11]], np.float32)
ROIS_A = np.array([[0, 1.0, 1.0, 10.0, 12.0], [0, 4.0, 2.0, 14.0, 9.0]], np.float32)
BOXES = np.array([[0, 0, 4, 4], [1, 1, 5, 5], [8, 8, 12, 12], [0, 0, 3.8, 4.2],
                  [8.5, 8.5, 12, 12]], np.float32)
SCORES = np.array([0.9, 0.6, 0.8, 0.7, 0.5], np.float32)
SCORES_TIE = np.array([0.7, 0.7, 0.8, 0.7, 0.8], np.float32)
CLS = _R.random((1, 18, 8, 8)).astype(np.float32)
BBOX = (_R.standard_normal((1, 36, 8, 8)) * 0.1).astype(np.float32)
IMINFO = np.array([[128.0, 128.0, 1.0]], np.float32)
ROPE_X = _R.standard_normal((1, 5, 2, 8)).astype(np.float32)
KV_NEW = _R.standard_normal((1, 3, 2, 4)).astype(np.float32)
KV_CACHE = _R.standard_normal((1, 8, 2, 4)).astype(np.float32)
CM_X = _R.standard_normal((1, 2, 6)).astype(np.float32)
CM_W = _R.standard_normal((5, 6)).astype(np.float32)
CM_B = _R.standard_normal((5,)).astype(np.float32)
CM_CACHE = _R.standard_normal((1, 8, 5)).astype(np.float32)
CC_X = _R.standard_normal((1, 4, 3)).astype(np.float32)
CC_W = (_R.standard_normal((4, 4, 5)) * 0.3).astype(np.float32)
CC_CACHE = _R.standard_normal((1, 4, 12)).astype(np.float32)
FS_LF = (_R.standard_normal((3, 6)) * 0.5).astype(np.float32)
FS_RF = (_R.standard_normal((2, 6)) * 0.5).astype(np.float32)
FS_SEQ = _R.standard_normal((6, 6)).astype(np.float32)
FS_FRAME = _R.standard_normal((1, 6)).astype(np.float32)
COLS = np.random.default_rng(8).standard_normal((1, 18, 25)).astype(np.float32)
TIES = np.array([[1.0, 3.0, 3.0, 0.0, 3.0], [2.0, 2.0, -1.0, 2.0, 5.0]], np.float32)
I32 = lambda *v: np.array(v, np.int32)   # noqa: E731

_REDUCE_OPS = ("reduce_sum", "sum", "reduce_mean", "mean", "reduce_max", "max",
               "reduce_min", "min", "reduce_prod", "prod", "reduce_logsumexp", "all", "any")
_SEGMENT_OPS = ("segment_sum", "segment_mean", "segment_max", "segment_min", "segment_prod")
_SEG_SORTED = I32(0, 0, 1, 1, 3, 3)            # segment 2 is empty
_SEG_UNSORTED = I32(3, 0, 1, 0, 3, 1)
_SEG_OOB = I32(0, 5, 1, -1, 3, 1)              # ids 5 and -1 fall away


def _fn(o, name):
    return getattr(o, name if name not in ("sum", "max", "min", "all", "any") else name + "_")


def _reduce_case(name, **kw):
    def case(o):
        x = X2345 > 0 if name in ("all", "any") else X2345
        return _fn(o, name)(x, o.ReduceParams(**kw))
    return case


def _stride(o, name, over_rows: bool):
    """The reduction over the last axis of a [2, 3, 4] tensor, or over the
    rows of a [4, 3] one, as explicit (strides, extents) index spaces."""
    if over_rows:
        return getattr(o, name)(X34.reshape(4, 3), o.StridedReduceParams(
            out_strides=(1,), out_extents=(3,), inner_strides=(3,), inner_extents=(4,)))
    return getattr(o, name)(X2345.reshape(2, 3, 20)[:, :, :4].copy(), o.StridedReduceParams(
        out_strides=(12, 4), out_extents=(2, 3), inner_strides=(1,), inner_extents=(4,)))


# case name ("op" or "op:variant") → (function of an ops namespace, float tolerance)
CASES = {}
for _op in _REDUCE_OPS:
    CASES[_op] = (_reduce_case(_op, axis=(1, 3)), 1e-4)
CASES["reduce_sum:keepdims"] = (_reduce_case("reduce_sum", axis=(0, 2), keepdims=True), 1e-4)
CASES["sum:all_axes"] = (_reduce_case("sum"), 1e-4)
CASES["reduce_max:axis_int"] = (_reduce_case("reduce_max", axis=2), 1e-4)
for _op in _SEGMENT_OPS:
    CASES[_op] = ((lambda o, _o=_op: getattr(o, _o)(
        SEG, _SEG_SORTED, o.SegmentParams(num_segments=4))), 1e-5)
    CASES["unsorted_" + _op] = ((lambda o, _o=_op: getattr(o, "unsorted_" + _o)(
        SEG, _SEG_UNSORTED, o.SegmentParams(num_segments=4, unsorted=True))), 1e-5)
    CASES[_op + ":ids_out_of_range"] = ((lambda o, _o=_op: getattr(o, _o)(
        SEG, _SEG_OOB, o.SegmentParams(num_segments=4))), 1e-5)

CASES.update({
    "argmax": (lambda o: o.argmax(X2345, o.ArgParams(axis=1)), 0),
    "argmax:ties_keepdims": (lambda o: o.argmax(TIES, o.ArgParams(axis=1, keepdims=True)), 0),
    "argmin": (lambda o: o.argmin(X2345, o.ArgParams(axis=1)), 0),
    "argmin:ties": (lambda o: o.argmin(-TIES, o.ArgParams(axis=1)), 0),
    "cumsum": (lambda o: o.cumsum(X34, o.CumsumParams(axis=1)), 1e-5),
    "cumsum:exclusive": (lambda o: o.cumsum(X34, o.CumsumParams(axis=0, exclusive=True)), 1e-5),
    "cumprod": (lambda o: o.cumprod(X34, o.CumsumParams(axis=1)), 1e-5),
    "cumprod:exclusive": (lambda o: o.cumprod(X34, o.CumsumParams(axis=1, exclusive=True)),
                          1e-5),
    "topk": (lambda o: o.topk(X34, o.TopKParams(k=2)), 1e-6),
    "topk:ties": (lambda o: o.topk(TIES, o.TopKParams(k=3)), 1e-6),
    "mean_stride": (lambda o: _stride(o, "mean_stride", False), 1e-5),
    "mean_stride:axis0": (lambda o: _stride(o, "mean_stride", True), 1e-5),
    "min_stride": (lambda o: _stride(o, "min_stride", False), 1e-5),
    # convolution family
    "conv1d": (lambda o: o.conv1d(X1D, W1DF, None, o.Conv1dParams(pad=(2, 2))), 1e-3),
    "conv1d:strided_dilated_asym": (lambda o: o.conv1d(
        X1D, W1DF, B4.repeat(2), o.Conv1dParams(stride=2, dilation=2, pad=(3, 1))), 1e-3),
    "conv1d:nwc": (lambda o: o.conv1d(
        np.ascontiguousarray(X1D.transpose(0, 2, 1)),
        np.ascontiguousarray(W1DF.transpose(0, 2, 1)), None,
        o.Conv1dParams(pad=(1, 1), layout=o.Layout.NWC)), 1e-3),
    "group_conv1d": (lambda o: o.group_conv1d(
        X1D, W1D, B9, o.Conv1dParams(stride=1, pad=(1, 1), group=3)), 1e-3),
    "depthwise_conv1d": (lambda o: o.depthwise_conv1d(
        X1D, W1DG, None, o.Conv1dParams(pad=(1, 1), group=6)), 1e-3),
    "conv3d": (lambda o: o.conv3d(X3D, W3D, None, o.Conv3dParams(
        pad=(1, 1, 1, 1, 1, 1))), 1e-3),
    "deconv2d": (lambda o: o.deconv2d(XDC[:, :4], WDO[:4], None, o.Deconv2dParams(
        stride=(2, 2), pad=(1, 1, 1, 1), out_pad=(1, 1))), 1e-3),
    "deconv2d:asym_dilated_bias": (lambda o: o.deconv2d(XDC[:, :4], WDO[:4], B4, o.Deconv2dParams(
        stride=(2, 1), pad=(2, 0, 1, 1), dilation=(1, 2))), 1e-3),
    "group_deconv2d": (lambda o: o.group_deconv2d(XDC, WDC, None, o.Deconv2dParams(
        stride=(2, 2), pad=(1, 1, 1, 1), group=2)), 1e-3),
    "depthwise_deconv2d": (lambda o: o.depthwise_deconv2d(XDC, WDW, None, o.Deconv2dParams(
        stride=(2, 2), pad=(1, 1, 1, 1), group=6)), 1e-3),
    "deconv3d": (lambda o: o.deconv3d(XD3, WD3, B4, o.Conv3dParams(
        stride=(2, 1, 2), pad=(0, 0, 1, 1, 1, 1))), 1e-3),
    "embedding": (lambda o: o.embedding(I32(0, 2, 1, 1, -1).reshape(1, 5), X34), 0),
    # pools and norms
    "maxpool2d_locat": (lambda o: o.maxpool2d_locat(X2345, o.PoolParams(
        kernel=(2, 2), stride=(2, 2), pad=(0, 0, 0, 0))), 0),
    "maxpool2d_locat:padded": (lambda o: o.maxpool2d_locat(X2345, o.PoolParams(
        kernel=(3, 3), stride=(2, 2), pad=(1, 1, 1, 1))), 0),
    "unpooling": (lambda o: o.unpooling(*o.maxpool2d_locat(S2D, o.PoolParams(
        kernel=(2, 2), stride=(2, 2), pad=(0, 0, 0, 0))), out_hw=(6, 6)), 0),
    "batch_norm": (lambda o: o.batch_norm(
        X2345, np.full(3, 0.1, np.float32), np.full(3, 2.0, np.float32),
        np.full(3, 1.5, np.float32), np.full(3, 0.5, np.float32),
        o.BatchNormParams(epsilon=1e-5)), 1e-5),
    "layer_norm": (lambda o: o.layer_norm(X34, np.full(4, 1.2, np.float32),
                                          np.full(4, 0.3, np.float32), o.NormParams(axis=-1)),
                   1e-5),
    "rms_norm": (lambda o: o.rms_norm(X34, np.ones(4, np.float32),
                                      o.NormParams(axis=-1, epsilon=1e-6)), 1e-5),
    "instance_norm": (lambda o: o.instance_norm(X2345, np.ones(3, np.float32),
                                                np.zeros(3, np.float32),
                                                o.NormParams(epsilon=1e-5)), 1e-4),
    "l2_normalization": (lambda o: o.l2_normalization(X34, o.NormParams(axis=-1)), 1e-5),
    "lrn": (lambda o: o.lrn(X2345, o.LRNParams(range=3, bias=1.0, alpha=1e-2, beta=0.75)),
            1e-4),
    "lrn:range5": (lambda o: o.lrn(S2D8, o.LRNParams(range=5, alpha=1e-4 / 5, beta=0.75,
                                                     bias=1.0)), 1e-3),
    # shape and index ops
    "reshape": (lambda o: o.reshape(X2345, o.ReshapeParams(shape=(6, 20))), 0),
    "transpose": (lambda o: o.transpose(X2345, o.TransposeParams(permute=(0, 2, 3, 1))), 0),
    "concat": (lambda o: o.concat([X34, B34], o.ConcatParams(axis=1)), 0),
    "split": (lambda o: o.split(X34, o.SplitParams(axis=1, split_index=(1, 3))), 0),
    "slice": (lambda o: o.slice(X2345, o.SliceParams(begin=(0, 1, 0, 2), end=(2, 3, 4, 5))),
              0),
    "slice:negative": (lambda o: o.slice(X2345, o.SliceParams(begin=(0, -2, 1, -4),
                                                               end=(1, 3, -1, 9))), 0),
    "strided_slice": (lambda o: o.strided_slice(X2345, o.StridedSliceParams(
        begin=(0, 0, 1, 0), end=(2, 3, 4, 5), stride=(1, 2, 2, 1))), 0),
    "strided_slice:negative_stride": (lambda o: o.strided_slice(X2345, o.StridedSliceParams(
        begin=(1, 2, 3, 4), end=(-3, -4, 0, 0), stride=(-1, -2, -1, -3))), 0),
    "pad": (lambda o: o.pad(X34, o.PadParams(pad_before=(1, 0), pad_after=(0, 2),
                                             pad_value=0.5)), 0),
    "pad:edge": (lambda o: o.pad(X34, o.PadParams(pad_before=(2, 1), pad_after=(1, 3),
                                                  pad_mode="edge")), 0),
    "pad:reflect": (lambda o: o.pad(X34, o.PadParams(pad_before=(2, 1), pad_after=(1, 3),
                                                     pad_mode="reflect")), 0),
    "gather": (lambda o: o.gather(X34, I32(2, 0), o.GatherParams(axis=0)), 0),
    "gather:negative_and_out_of_range": (lambda o: o.gather(
        X34, I32(-1, 5, 3, -4, 1).reshape(5), o.GatherParams(axis=1)), 0),
    "gather:bool_and_int": (lambda o: (
        o.gather(X34 > 0, I32(0, 7, -2), o.GatherParams(axis=1)),
        o.gather(I32(*range(12)).reshape(3, 4), I32(-5, 2), o.GatherParams(axis=0))), 0),
    "gather_nd": (lambda o: o.gather_nd(X2345, I32(0, 1, 1, 2).reshape(2, 2)), 0),
    "gather_nd:negative_and_out_of_range": (lambda o: o.gather_nd(
        X2345, I32(5, -1, -4, 2, 1, 9).reshape(3, 2)), 0),
    "scatter_nd": (lambda o: o.scatter_nd(I32(1, 3).reshape(2, 1), X34[:2], shape=(5, 4)), 0),
    "scatter_nd:duplicates_and_out_of_range": (lambda o: o.scatter_nd(
        I32(1, 3, 1, 7, -1).reshape(5, 1), np.concatenate([X34, B34[:2]]), shape=(5, 4)),
        1e-6),
    "tile": (lambda o: o.tile(X34, o.TileParams(reps=(2, 3))), 0),
    "squeeze": (lambda o: o.squeeze(X34[None], o.SqueezeParams(axis=(0,))), 0),
    "squeeze:all": (lambda o: o.squeeze(X34[None, :, None], o.SqueezeParams()), 0),
    "expand_dims": (lambda o: o.expand_dims(X34, o.ExpandDimsParams(axis=1)), 0),
    "expand_dims:negative": (lambda o: o.expand_dims(X34, o.ExpandDimsParams(axis=-1)), 0),
    "reverse": (lambda o: o.reverse(X34, o.FlipParams(axis=(1,))), 0),
    "flip": (lambda o: o.flip(X2345, o.FlipParams(axis=(1, 3))), 0),
    "stack": (lambda o: o.stack([X34, B34], o.StackParams(axis=1)), 0),
    "unstack": (lambda o: o.unstack(X2345, o.StackParams(axis=1)), 0),
    "broadcast_to": (lambda o: o.broadcast_to(X34[:, None], o.BroadcastToParams(
        shape=(3, 5, 4))), 0),
    "crop": (lambda o: o.crop(X2345, (2, 2, 2, 2), o.CropParams(axis=1, offset=(1, 1, 2))), 0),
    "depth_to_space": (lambda o: o.depth_to_space(D2S, o.DepthToSpaceParams(block_size=2)), 0),
    "depth_to_space:crd": (lambda o: o.depth_to_space(D2S, o.DepthToSpaceParams(
        block_size=2, mode="CRD")), 0),
    "space_to_depth": (lambda o: o.space_to_depth(S2D, o.Space2DepthParams(block_size=2)), 0),
    "reorg": (lambda o: o.reorg(S2D, o.Space2DepthParams(block_size=2)), 0),
    "space_to_batch": (lambda o: o.space_to_batch(S2D, o.SpaceToBatchParams(
        block_size=2, pad=(1, 1, 0, 2))), 0),
    "batch_to_space": (lambda o: o.batch_to_space(B2S, o.BatchToSpaceParams(
        block_size=2, crop=(1, 0, 0, 1))), 0),
    "space_to_batch_nd": (lambda o: o.space_to_batch_nd(S2D, o.SpaceToBatchNdParams(
        block_shape=(2, 2), pads=((0, 0), (0, 0)))), 0),
    "space_to_batch_nd:1d_padded": (lambda o: o.space_to_batch_nd(
        X2345[0, :, :4], o.SpaceToBatchNdParams(block_shape=(2,), pads=((1, 1),))), 0),
    "batch_to_space_nd": (lambda o: o.batch_to_space_nd(
        np.ascontiguousarray(X2345.reshape(4, 3, 2, 5)),
        o.SpaceToBatchNdParams(block_shape=(2, 2), pads=((0, 1), (1, 0)))), 0),
    "shuffle_channel": (lambda o: o.shuffle_channel(S2D8, o.ShuffleChannelParams(group=2)),
                        0),
    "one_hot": (lambda o: o.one_hot(I32(0, 2, 1, 5), o.OneHotParams(depth=4, axis=-1)), 0),
    "sequence_mask": (lambda o: o.sequence_mask(I32(1, 3, 0), maxlen=4), 0),
    "cast": (lambda o: o.cast(X34 * 5, np.int32), 0),
    "cast:int_to_float16": (lambda o: o.cast(I32(1, -3, 70000), np.float16), 0),
    "arange": (lambda o: o.arange(o.ArangeParams(start=1, stop=8, step=2)), 0),
    "arange:fractional": (lambda o: o.arange(o.ArangeParams(start=2.0, stop=11.0, step=3.0)),
                          1e-6),
    "im2col": (lambda o: o.im2col(IM, (3, 3), (1, 1), (1, 1, 1, 1)), 0),
    "im2col:strided": (lambda o: o.im2col(IM, (2, 3), (2, 1), (0, 1, 1, 0)), 0),
    "col2im": (lambda o: o.col2im(COLS, (5, 5), (3, 3), (1, 1), (1, 1)), 1e-5),
    "shape": (lambda o: o.shape(X2345), 0),
    "ndarray_size": (lambda o: o.ndarray_size(X2345), 0),
    "yuv_rgb_scale": (lambda o: o.yuv_rgb_scale(YUV), 1e-5),
    # resize
    "resize": (lambda o: o.resize(IMG, o.ResizeParams(mode="nearest", target_size=(8, 8))), 0),
    "resize:nearest_down": (lambda o: o.resize(IMG8, o.ResizeParams(
        mode="nearest", target_size=(3, 5))), 0),
    "resize:bilinear_up": (lambda o: o.resize(IMG8, o.ResizeParams(
        mode="bilinear", target_size=(16, 12))), 1e-4),
    "resize:bilinear_down": (lambda o: o.resize(IMG8, o.ResizeParams(
        mode="bilinear", target_size=(3, 5))), 1e-4),
    "resize:align_corners": (lambda o: o.resize(IMG, o.ResizeParams(
        mode="bilinear", align_corners=True, target_size=(7, 9))), 1e-4),
    "resize:nhwc": (lambda o: o.resize(np.ascontiguousarray(IMG8.transpose(0, 2, 3, 1)),
                                       o.ResizeParams(mode="bilinear", target_size=(12, 4),
                                                      layout=o.Layout.NHWC)), 1e-4),
    # detection
    "roipool": (lambda o: o.roipool(FMAP, ROIS, pooled_size=(4, 4), spatial_scale=1.0), 1e-5),
    "non_max_suppression": (lambda o: o.non_max_suppression(BOXES, SCORES, iou_threshold=0.5,
                                                            max_out=4), 0),
    "non_max_suppression:equal_scores": (lambda o: o.non_max_suppression(
        BOXES, SCORES_TIE, iou_threshold=0.3, max_out=6), 0),
    "roialign": (lambda o: o.roialign(FMAP16, ROIS_A, o.RoiAlignParams(
        pooled_size=(4, 4), spatial_scale=1.0, sample_ratio=2)), 1e-3),
    "roialign:default_ratio_scaled": (lambda o: o.roialign(FMAP16, ROIS_A * 2, o.RoiAlignParams(
        pooled_size=(3, 2), spatial_scale=0.5)), 1e-3),
    "psroipooling": (lambda o: o.psroipooling(PSMAP, np.concatenate(
        [ROIS, [[0, 2.0, 3.0, 7.0, 9.0]]]).astype(np.float32), o.PSROIPoolingParams(
        output_dim=2, group_size=3, spatial_scale=1.0)), 1e-5),
    "proposal": (lambda o: o.proposal(CLS, BBOX, IMINFO, o.ProposalParams(
        rpn_post_nms_top_n=50, rpn_pre_nms_top_n=200)), 1e-4),
    # sequence and streaming-ASR cache ops
    "rope": (lambda o: o.rope(ROPE_X, o.RopeParams(head_dim=8, pos_offset=3)), 1e-5),
    "rope:positions": (lambda o: o.rope(ROPE_X, o.RopeParams(head_dim=8, freq_base=500.0,
                                                             freq_scale=0.5),
                                        positions=I32(7, 1, 4, 4, 0)), 1e-5),
    "llm_pos": (lambda o: o.llm_pos(KV_NEW, KV_CACHE, o.LlmPosParams(mode="cache_in", pos=2)),
                0),
    "llm_pos:clamped": (lambda o: o.llm_pos(KV_NEW, KV_CACHE, o.LlmPosParams(
        mode="cache_in", pos=7)), 0),
    "cache_matmul": (lambda o: o.cache_matmul(CM_X, CM_W, CM_B, CM_CACHE,
                                              o.CacheMatmulParams()), 1e-5),
    "cache_conv1d": (lambda o: o.cache_conv1d(CC_X, CC_W, B4, CC_CACHE,
                                              o.CacheConv1dParams()), 1e-4),
    "fsmn": (lambda o: o.fsmn(FS_FRAME, FS_LF, FS_RF, FS_SEQ, np.int32(0), o.FSMNParams(
        l_order=3, r_order=2)), 1e-5),
    "fsmn:strided": (lambda o: o.fsmn(FS_FRAME, FS_LF[:2], FS_RF[:1], FS_SEQ, np.int32(4),
                                      o.FSMNParams(l_order=2, r_order=1, l_stride=2,
                                                   r_stride=2)), 1e-5),
})


def case_op(name: str) -> str:
    return name.split(":")[0]


def arrays(out):
    """A case's result as a list of numpy arrays (a Tensor of either
    package, or a tuple of them)."""
    outs = out if isinstance(out, (tuple, list)) else (out,)
    res = []
    for t in outs:
        d = getattr(t, "data", t)
        if hasattr(d, "detach"):
            import torch
            d = (d.float() if d.dtype == torch.bfloat16 else d).detach().cpu().numpy()
        res.append(np.asarray(d))
    return res


def mismatch(got, want, tol) -> str:
    """'' when `got` matches `want` (lists of arrays): equal shapes and
    dtypes, integer and boolean arrays equal, float arrays within
    rtol = 10·tol, atol = tol (equal where tol is 0, NaNs in the same
    places); else what differs."""
    if len(got) != len(want):
        return f"{len(got)} outputs, want {len(want)}"
    for i, (g, w) in enumerate(zip(got, want)):
        if g.shape != w.shape or g.dtype != w.dtype:
            return f"output {i}: {g.dtype}{list(g.shape)}, want {w.dtype}{list(w.shape)}"
        if not np.issubdtype(w.dtype, np.floating) or tol == 0:
            if not np.array_equal(g, w, equal_nan=np.issubdtype(w.dtype, np.floating)):
                return f"output {i}: {int((g != w).sum())} of {w.size} elements differ"
        elif not np.allclose(g, w, rtol=10 * tol, atol=tol, equal_nan=True):
            return (f"output {i}: max |d| {np.nanmax(np.abs(g.astype(np.float64) - w)):.3e} "
                    f"(tol {tol})")
    return ""


def run_graph(name: str, device):
    """The case recorded into a GRAPH Session on `device`, set up and run:
    its outputs."""
    from csinn2_tpu_torch import ops
    from csinn2_tpu_torch.core.dtypes import RunMode
    from csinn2_tpu_torch.runtime.session import Session
    sess = Session(run_mode=RunMode.GRAPH, device=device, name=f"zoo_{name}")
    with sess.build():
        out = CASES[name][0](ops)
        sess.set_output(*(out if isinstance(out, (tuple, list)) else (out,)))
    sess.setup()
    return sess.run(unwrap=False)


def run(device="cuda", log=print):
    """Every case in a GRAPH session on `device` against the eager call on
    the CPU; raises AssertionError naming each case that differs."""
    from csinn2_tpu_torch import ops
    bad = {}
    for name, (fn, tol) in CASES.items():
        want = arrays(fn(ops))
        got = arrays(run_graph(name, device))
        why = mismatch(got, want, tol)
        if why:
            bad[name] = why
    n_ops = len({case_op(n) for n in CASES})
    log(f"op zoo: {len(CASES)} cases of {n_ops} ops, GRAPH sessions on {device} against "
        f"the CPU plain path: {len(CASES) - len(bad)} match")
    if bad:
        raise AssertionError("op zoo cases differ: " +
                             "; ".join(f"{k}: {v}" for k, v in bad.items()))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
    run(args.device)
    print("PASS")
    return 0


if __name__ == "__main__":
    sys.exit(main())
