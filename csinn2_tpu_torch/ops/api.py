"""Public op API over Tensor handles (counterpart of csinn2_tpu/ops/api.py,
every public function of it): the csinn_* surface of the reference — the
convolution family, fullyconnected, matmul and embedding, the pools,
norms, reductions, shape and index ops, the detection ops, the LLM and
streaming-ASR sequence ops, and the generated unary, binary and reduce
families over what ops/ref registers.  matmul and
scaled_dot_product_attention, with block-quantized (Q8_0 / Q4_0) weights
and long or cached attention, reach the CUDA tier of kernels/autodispatch.py.

(ref: include/csinn/csi_nn.h; impl pattern source/nn2/convolution.c:26-85.)
In GRAPH mode the calls record nodes into the active Session; otherwise
they execute eagerly.  Quantized execution wraps the float op as
dequant→f32→requant like the reference's quant wrappers (ref:
shl_ref_conv_callback_base, source/reference/utils.c:609-650), unless a
callback registered for the scheme consumes the integer carriers directly
(`quant_direct`, kernels/qconv.py).

Shape inference while recording runs the node's own exec function on
tensors of torch's `meta` device (the JAX package uses jax.eval_shape).

The callback is chosen for the device the op runs on: the session's in
GRAPH mode, the first input's in layer mode.  A block-quantized weight is a
(values [N, K] int8, scales [N, K/32]) pair; it moves to the device once
(Session.setup, or the first eager call), its scales as f32.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Sequence, Union

import numpy as np
import torch

from csinn2_tpu_torch.core.dtypes import (Api, DebugLevel, Dtype, Layout, MemType,  # noqa: F401
                                          QuantScheme, dtype_of)
from csinn2_tpu_torch.core.quant import QuantInfo, dequantize, dequantize_blocks, quantize
from csinn2_tpu_torch.core.tensor import Tensor, TensorMeta
from csinn2_tpu_torch.graph.ir import Node
from csinn2_tpu_torch.ops import params as P
from csinn2_tpu_torch.ops.registry import registry
from csinn2_tpu_torch.runtime.session import current_session
from csinn2_tpu_torch.utils import logging as _log

TensorLike = Union[Tensor, torch.Tensor, np.ndarray, None]


def _as_tensor(x: TensorLike) -> Optional[Tensor]:
    if x is None or isinstance(x, Tensor):
        return x
    return Tensor(data=x)


def _dequant_array(arr, t: Tensor, compute_dtype):
    """Integer carrier → float per the tensor's quant metadata
    (ref: shl_ref_tensor_transform_f32, source/reference/utils.c:579)."""
    if t.is_block:
        return dequantize_blocks(*arr).to(compute_dtype)
    q = t.qinfo
    if q is not None and q.dtype.is_quantized_int:
        return dequantize(arr, q).to(compute_dtype)
    if arr.is_floating_point():
        return arr.to(compute_dtype)
    return arr  # integer-semantic input (ids, indices, masks)


def _requant_array(out, out_qinfo: Optional[QuantInfo]):
    """The op's f32 result into its output quantization, by the reciprocal
    of the scale as the JAX package's compiled graph computes it."""
    if out_qinfo is None:
        return out
    if out_qinfo.dtype.is_float:
        return out.to(out_qinfo.dtype.torch)
    return quantize(out, out_qinfo, by_reciprocal=True)


def _on_meta(t: Tensor):
    """A meta tensor of t's shape and carrier (a pair for a block weight)."""
    if t.is_block:
        values, scales = t.data
        return (torch.empty(values.shape, dtype=values.dtype, device="meta"),
                torch.empty(scales.shape, dtype=torch.float32, device="meta"))
    return torch.empty(t.shape, dtype=t.dtype.torch, device="meta")


def _run_device(sess, flat: Sequence[Tensor]) -> torch.device:
    """The device the op runs on: the recording session's (the CPU for a
    node a HYBRID session places on the host), else the first input's
    (constants follow it)."""
    if sess is not None and sess.recording:
        return sess.record_device
    if not flat:
        return torch.device("cpu")
    return flat[0].data[0].device if flat[0].is_block else flat[0].data.device


def call_op(op: str, tensors: Sequence[Any], params=None,
            out_qinfo: Optional[QuantInfo] = None, n_outputs: int = 1,
            out_layout: Optional[Layout] = None, **extra):
    """Dispatch one op: record a graph node (GRAPH mode) or execute eagerly.

    `tensors` may contain Tensor, None, raw tensors, or a list of Tensors
    (variadic ops)."""
    sess = current_session()
    api_pref = sess.api if sess else Api.AUTO
    compute_dtype = sess.compute_dtype if sess else torch.float32

    # normalize structure; remember it to rebuild inside exec
    flat: List[Tensor] = []
    structure: List[Any] = []     # 'T' tensor, 'N' none, ('L', n) list
    for item in tensors:
        if item is None:
            structure.append("N")
        elif isinstance(item, (list, tuple)):
            ts = [_as_tensor(t) for t in item]
            structure.append(("L", len(ts)))
            flat.extend(ts)
        else:
            structure.append("T")
            flat.append(_as_tensor(item))

    metas = [t.meta for t in flat]
    scheme = None
    for t in flat:
        if t.qinfo is not None and t.qinfo.scheme != QuantScheme.UNSET:
            scheme = t.qinfo.scheme
            break
    device = _run_device(sess, flat)
    cb = registry.lookup(op, scheme=scheme, api=api_pref, metas=metas, params=params,
                         device=device)
    # the zp weight-sum vector is an operand of the integer conv path only:
    # a generic (dequant→f32) callback does not know it (always last)
    if not cb.quant_direct and flat and flat[-1].meta.name == "__zp_wsum__":
        flat, structure, metas = flat[:-1], structure[:-1], metas[:-1]

    # per-op-signature debug printer (ref: SHL_DEBUG_CALL, include/shl_debug.h:32-40)
    if _log.get_level() <= DebugLevel.DEBUG:
        _log.debug("%s[%s] %s -> cb=%s",
                   op, getattr(params, "name", "") or "-",
                   ",".join(f"{t.dtype.value}{list(t.shape)}" for t in flat),
                   cb.name)

    def exec_fn(arrays, _flat=tuple(flat), _structure=tuple(structure)):
        # rebuild positional args with dequantized floats
        it = iter(range(len(_flat)))
        args: List[Any] = []
        for s in _structure:
            if s == "N":
                args.append(None)
            elif s == "T":
                i = next(it)
                args.append(_dequant_array(arrays[i], _flat[i], compute_dtype))
            else:
                idxs = [next(it) for _ in range(s[1])]
                args.append([_dequant_array(arrays[i], _flat[i], compute_dtype)
                             for i in idxs])
        out = cb.exec(*args, params, **extra) if params is not None else \
            cb.exec(*args, **extra)
        if isinstance(out, (tuple, list)):
            return tuple(_requant_array(o, out_qinfo) for o in out)
        return _requant_array(out, out_qinfo)

    def direct_exec_fn(arrays, _flat=tuple(flat)):
        # quantized fast path: the callback consumes raw carriers + qinfos
        return cb.exec(arrays, [t.meta for t in _flat], params, out_qinfo, **extra)

    fn = direct_exec_fn if cb.quant_direct else exec_fn

    layout = out_layout or (getattr(params, "layout", Layout.NCHW) if params else Layout.NCHW)

    if sess is not None and sess.recording:
        # symbolic: output shapes from the exec function on meta tensors
        # (replaces the per-op *_infer_shape table, ref:
        # source/graph_ref/*_infer_shape)
        out_shape = fn([_on_meta(t) for t in flat])
        leaves = out_shape if isinstance(out_shape, (tuple, list)) else (out_shape,)
        node = Node(op=op, inputs=list(flat), params=params, exec_fn=fn,
                    name=getattr(params, "name", "") or op, cb_name=cb.name,
                    structure=list(structure), extra=dict(extra),
                    out_qinfo=out_qinfo)
        outs = []
        for i, leaf in enumerate(leaves):
            meta = TensorMeta(shape=tuple(leaf.shape), dtype=dtype_of(leaf.dtype),
                              layout=layout, qinfo=out_qinfo,
                              name=f"{node.name}_out{i}")
            outs.append(Tensor(meta=meta, producer=node, out_index=i))
        node.outputs = outs
        sess.record(node)
        return outs[0] if len(outs) == 1 else tuple(outs)

    # eager (layer mode): constants follow the first input's device
    result = fn([t.on_device(device) for t in flat])
    if isinstance(result, tuple):
        return tuple(Tensor(data=r, qinfo=out_qinfo, layout=layout) for r in result)
    return Tensor(data=result, qinfo=out_qinfo, layout=layout)


# --- generated unary / binary wrappers ------------------------------------------

def _unary(op):
    def fn(x, params=None, out_qinfo=None):
        return call_op(op, [x], params, out_qinfo)
    fn.__name__ = op
    return fn


def _binary(op):
    def fn(a, b, params=None, out_qinfo=None):
        return call_op(op, [a, b], params, out_qinfo)
    fn.__name__ = op
    return fn


_UNARY_OPS = [
    "abs", "acos", "acosh", "asin", "asinh", "atan", "atanh", "ceil", "cos",
    "cosh", "exp", "expm1", "floor", "log", "log1p", "negative", "round",
    "rsqrt", "sign", "sin", "sinh", "sqrt", "square", "tan", "trunc", "isnan",
    "relu", "relu1", "relu6", "sigmoid", "hard_sigmoid", "silu", "erf", "tanh",
    "softplus", "softrelu", "softsign", "gelu", "elu", "logical_not", "not",
    "flatten", "shape", "ndarray_size", "yuv_rgb_scale",
]
_BINARY_OPS = [
    "add", "sub", "mul", "div", "power", "maximum", "minimum", "mod",
    "floor_mod", "floor_divide", "equal", "not_equal", "greater",
    "greater_equal", "less", "less_equal", "logical_and", "logical_or",
    "logical_xor", "and", "or", "xor",
]

for _op in _UNARY_OPS:
    globals()[_op if _op not in ("and", "or", "not") else _op + "_"] = _unary(_op)
for _op in _BINARY_OPS:
    globals()[_op if _op not in ("and", "or") else _op + "_"] = _binary(_op)


# --- structured ops ---------------------------------------------------------

def _w_layout(weight):
    if isinstance(weight, Tensor) and weight.layout in (Layout.OHWI, Layout.OIHW,
                                                        Layout.O1HW, Layout.HWO1):
        return weight.layout
    return Layout.OIHW


def _zp_sumw_tensor(x, weight) -> Optional[Tensor]:
    """The AOT activation-zp correction vector of the integer conv path
    (kernels/qconv.precompute_zp_wsum): made at graph build when the weight
    is a const 8-bit carrier and x has a static nonzero effective
    zero-point (u8 x counts as its s8 carrier, zp − 128).  A const Tensor
    named "__zp_wsum__", or None."""
    from csinn2_tpu_torch.kernels.qconv import precompute_zp_wsum, static_scalar
    if not isinstance(x, Tensor) or not isinstance(weight, Tensor):
        return None
    if weight.data is None or x.qinfo is None or x.qinfo.dtype.is_float:
        return None
    if x.dtype not in (Dtype.INT8, Dtype.UINT8) or weight.dtype not in (Dtype.INT8, Dtype.UINT8):
        return None
    zp = static_scalar(x.qinfo.zero_point)
    if zp is None:
        return None
    if x.dtype == Dtype.UINT8:
        zp -= 128.0
    if int(np.round(zp)) == 0:
        return None
    t = Tensor(precompute_zp_wsum(weight.numpy(), w_layout=_w_layout(weight)))
    t.meta.name = "__zp_wsum__"
    return t


def _conv_inputs(x, weight, bias, residual=None):
    """[x, weight, bias(, residual)(, zp weight-sum)]: the residual rides
    after the bias, where the quant callback finds it, and the zp vector
    last, where call_op strips it for a generic callback."""
    ins = [x, weight, bias]
    if residual is not None:
        ins.append(residual)
    m = _zp_sumw_tensor(x, weight)
    if m is not None:
        ins.append(m)
    return ins


def conv2d(x, weight, bias=None, params: P.Conv2dParams = None, out_qinfo=None,
           residual=None):
    """residual: optional same-shape tensor added to the conv output before
    the fused activation and requantize — the ResNet join in one epilogue
    (the graph optimisation the reference's HHB performs on conv→add)."""
    params = params or P.Conv2dParams()
    if residual is not None:
        params = dataclasses.replace(params, fuse_add=True)
        if bias is None:
            bias = Tensor(np.zeros((weight.shape[0],), np.float32))
    return call_op("conv2d", _conv_inputs(x, weight, bias, residual), params, out_qinfo,
                   w_layout=_w_layout(weight))


def depthwise_conv2d(x, weight, bias=None, params: P.Conv2dParams = None, out_qinfo=None):
    params = params or P.Conv2dParams()
    return call_op("depthwise_conv2d", _conv_inputs(x, weight, bias), params, out_qinfo,
                   w_layout=_w_layout(weight))


def group_conv2d(x, weight, bias=None, params: P.Conv2dParams = None, out_qinfo=None):
    params = params or P.Conv2dParams()
    return call_op("group_conv2d", _conv_inputs(x, weight, bias), params, out_qinfo,
                   w_layout=_w_layout(weight))


def fullyconnected(x, weight, bias=None, params: P.FCParams = None, out_qinfo=None):
    return call_op("fullyconnected", [x, weight, bias], params or P.FCParams(), out_qinfo)


def matmul(a, b, params: P.MatmulParams = None, out_qinfo=None):
    """With a block-quantized b the CUDA tier takes b as [N, K] and ignores
    trans_b, as the JAX package's Pallas tier does; the TORCH tier honours
    it (pass trans_b=True for the [N, K] layout and both agree)."""
    return call_op("matmul", [a, b], params or P.MatmulParams(), out_qinfo)


def scaled_dot_product_attention(q, k, v, params: P.SDPAParams = None, out_qinfo=None):
    """q [b, hq, sq, d]; k/v [b, hk, sk, d] → [b, hq, sq, d] f32."""
    return call_op("scaled_dot_product_attention", [q, k, v],
                   params or P.SDPAParams(), out_qinfo)


def maxpool2d(x, params: P.PoolParams, out_qinfo=None):
    return call_op("maxpool2d", [x], params, out_qinfo)


def avgpool2d(x, params: P.PoolParams, out_qinfo=None):
    return call_op("avgpool2d", [x], params, out_qinfo)


def global_maxpool2d(x, params: P.PoolParams = None, out_qinfo=None):
    return call_op("global_maxpool2d", [x], params or P.PoolParams(), out_qinfo)


def global_avgpool2d(x, params: P.PoolParams = None, out_qinfo=None):
    return call_op("global_avgpool2d", [x], params or P.PoolParams(), out_qinfo)


def maxpool3d(x, params: P.PoolParams, out_qinfo=None):
    return call_op("maxpool3d", [x], params, out_qinfo)


def avgpool3d(x, params: P.PoolParams, out_qinfo=None):
    return call_op("avgpool3d", [x], params, out_qinfo)


def l2pool2d(x, params: P.PoolParams, out_qinfo=None):
    return call_op("l2pool2d", [x], params, out_qinfo)


def softmax(x, params: P.SoftmaxParams = None, out_qinfo=None):
    return call_op("softmax", [x], params or P.SoftmaxParams(), out_qinfo)


def log_softmax(x, params: P.SoftmaxParams = None, out_qinfo=None):
    return call_op("log_softmax", [x], params or P.SoftmaxParams(), out_qinfo)


def leaky_relu(x, params: P.ReluParams, out_qinfo=None):
    return call_op("leaky_relu", [x], params, out_qinfo)


def relun(x, params: P.ReluParams, out_qinfo=None):
    return call_op("relun", [x], params, out_qinfo)


def threshold_relu(x, params: P.ReluParams, out_qinfo=None):
    return call_op("threshold_relu", [x], params, out_qinfo)


def prelu(x, alpha, params: P.PReluParams = None, out_qinfo=None):
    return call_op("prelu", [x, alpha], params or P.PReluParams(), out_qinfo)


def clip(x, params: P.ClipParams, out_qinfo=None):
    return call_op("clip", [x], params, out_qinfo)


def where(cond, a, b, params=None, out_qinfo=None):
    return call_op("where", [cond, a, b], params, out_qinfo)


def select(cond, a, b, params=None, out_qinfo=None):
    return call_op("select", [cond, a, b], params, out_qinfo)


def where_softmax(cond, x, params=None, axis=-1, out_qinfo=None):
    return call_op("where_softmax", [cond, x], params, out_qinfo, axis=axis)


def data_convert(x, params=None, out_qinfo=None):
    """Dtype/quant-scheme conversion as a graph op (ref: CSINN_OP_DATA_CONVERT):
    dequant→requant into out_qinfo."""
    return call_op("data_convert", [x], params, out_qinfo)


def conv1d(x, weight, bias=None, params: P.Conv1dParams = None, out_qinfo=None):
    return call_op("conv1d", [x, weight, bias], params or P.Conv1dParams(), out_qinfo)


def conv3d(x, weight, bias=None, params: P.Conv3dParams = None, out_qinfo=None):
    return call_op("conv3d", [x, weight, bias], params or P.Conv3dParams(), out_qinfo)


def deconv2d(x, weight, bias=None, params: P.Deconv2dParams = None, out_qinfo=None):
    return call_op("deconv2d", [x, weight, bias], params or P.Deconv2dParams(), out_qinfo)


def deconv3d(x, weight, bias=None, params: P.Conv3dParams = None, out_qinfo=None):
    return call_op("deconv3d", [x, weight, bias], params or P.Conv3dParams(), out_qinfo)


def depthwise_conv1d(x, weight, bias=None, params: P.Conv1dParams = None, out_qinfo=None):
    return call_op("depthwise_conv1d", [x, weight, bias], params or P.Conv1dParams(), out_qinfo)


def group_conv1d(x, weight, bias=None, params: P.Conv1dParams = None, out_qinfo=None):
    return call_op("group_conv1d", [x, weight, bias], params or P.Conv1dParams(), out_qinfo)


def depthwise_deconv2d(x, weight, bias=None, params: P.Deconv2dParams = None, out_qinfo=None):
    return call_op("depthwise_deconv2d", [x, weight, bias],
                   params or P.Deconv2dParams(), out_qinfo)


def group_deconv2d(x, weight, bias=None, params: P.Deconv2dParams = None, out_qinfo=None):
    return call_op("group_deconv2d", [x, weight, bias], params or P.Deconv2dParams(), out_qinfo)


def embedding(ids, table, params=None, out_qinfo=None):
    return call_op("embedding", [ids, table], params, out_qinfo)


def maxpool2d_locat(x, params: P.PoolParams, out_qinfo=None):
    return call_op("maxpool2d_locat", [x], params, out_qinfo, n_outputs=2)


def unpooling(x, mask, params=None, out_hw=None, out_qinfo=None):
    return call_op("unpooling", [x, mask], params, out_qinfo, out_hw=out_hw)


def batch_norm(x, mean, variance, gamma=None, beta=None,
               params: P.BatchNormParams = None, out_qinfo=None):
    return call_op("batch_norm", [x, mean, variance, gamma, beta],
                   params or P.BatchNormParams(), out_qinfo)


def layer_norm(x, gamma=None, beta=None, params: P.NormParams = None, out_qinfo=None):
    return call_op("layer_norm", [x, gamma, beta], params or P.NormParams(), out_qinfo)


def rms_norm(x, gamma=None, params: P.NormParams = None, out_qinfo=None):
    return call_op("rms_norm", [x, gamma], params or P.NormParams(), out_qinfo)


def instance_norm(x, gamma=None, beta=None, params: P.NormParams = None, out_qinfo=None):
    return call_op("instance_norm", [x, gamma, beta], params or P.NormParams(), out_qinfo)


def l2_normalization(x, params: P.NormParams = None, out_qinfo=None):
    return call_op("l2_normalization", [x], params or P.NormParams(), out_qinfo)


def lrn(x, params: P.LRNParams, out_qinfo=None):
    return call_op("lrn", [x], params, out_qinfo)


# --- reductions ---------------------------------------------------------------

def _reduce(op):
    def fn(x, params: P.ReduceParams, out_qinfo=None):
        return call_op(op, [x], params, out_qinfo)
    fn.__name__ = op
    return fn


_REDUCE_OPS = ["reduce_sum", "sum", "reduce_mean", "mean", "reduce_max", "max",
               "reduce_min", "min", "reduce_prod", "prod", "reduce_logsumexp", "all", "any"]
for _op in _REDUCE_OPS:
    globals()[_op if _op not in ("sum", "max", "min", "all", "any") else _op + "_"] = \
        _reduce(_op)


def argmax(x, params: P.ArgParams, out_qinfo=None):
    return call_op("argmax", [x], params, out_qinfo)


def argmin(x, params: P.ArgParams, out_qinfo=None):
    return call_op("argmin", [x], params, out_qinfo)


def cumsum(x, params: P.CumsumParams, out_qinfo=None):
    return call_op("cumsum", [x], params, out_qinfo)


def cumprod(x, params: P.CumsumParams, out_qinfo=None):
    return call_op("cumprod", [x], params, out_qinfo)


def topk(x, params: P.TopKParams, out_qinfo=None):
    return call_op("topk", [x], params, out_qinfo, n_outputs=2)


def segment_sum(x, ids, params: P.SegmentParams, out_qinfo=None):
    return call_op("segment_sum", [x, ids], params, out_qinfo)


def segment_mean(x, ids, params: P.SegmentParams, out_qinfo=None):
    return call_op("segment_mean", [x, ids], params, out_qinfo)


def segment_max(x, ids, params: P.SegmentParams, out_qinfo=None):
    return call_op("segment_max", [x, ids], params, out_qinfo)


def segment_min(x, ids, params: P.SegmentParams, out_qinfo=None):
    return call_op("segment_min", [x, ids], params, out_qinfo)


def segment_prod(x, ids, params: P.SegmentParams, out_qinfo=None):
    return call_op("segment_prod", [x, ids], params, out_qinfo)


def _unsorted_segment(op):
    def fn(x, segment_ids, params: P.SegmentParams, out_qinfo=None):
        return call_op(op, [x, segment_ids], params, out_qinfo)
    fn.__name__ = op
    return fn


_UNSORTED_SEGMENT_OPS = ["unsorted_segment_sum", "unsorted_segment_max",
                         "unsorted_segment_min", "unsorted_segment_prod",
                         "unsorted_segment_mean"]
for _op in _UNSORTED_SEGMENT_OPS:
    globals()[_op] = _unsorted_segment(_op)


def mean_stride(x, params: P.StridedReduceParams, out_qinfo=None):
    return call_op("mean_stride", [x], params, out_qinfo)


def min_stride(x, params: P.StridedReduceParams, out_qinfo=None):
    return call_op("min_stride", [x], params, out_qinfo)


# --- shape ops ------------------------------------------------------------------

def reshape(x, params: P.ReshapeParams, out_qinfo=None):
    return call_op("reshape", [x], params, out_qinfo)


def transpose(x, params: P.TransposeParams, out_qinfo=None):
    return call_op("transpose", [x], params, out_qinfo)


def concat(inputs, params: P.ConcatParams, out_qinfo=None):
    return call_op("concat", [list(inputs)], params, out_qinfo)


def split(x, params: P.SplitParams, out_qinfo=None):
    return call_op("split", [x], params, out_qinfo)


def slice(x, params: P.SliceParams, out_qinfo=None):  # noqa: A001
    return call_op("slice", [x], params, out_qinfo)


def strided_slice(x, params: P.StridedSliceParams, out_qinfo=None):
    return call_op("strided_slice", [x], params, out_qinfo)


def pad(x, params: P.PadParams, out_qinfo=None):
    return call_op("pad", [x], params, out_qinfo)


def gather(x, indices, params: P.GatherParams, out_qinfo=None):
    return call_op("gather", [x, indices], params, out_qinfo)


def gather_nd(x, indices, params=None, out_qinfo=None):
    return call_op("gather_nd", [x, indices], params, out_qinfo)


def scatter_nd(indices, updates, shape, params=None, out_qinfo=None):
    return call_op("scatter_nd", [indices, updates], params, out_qinfo, shape=shape)


def tile(x, params: P.TileParams, out_qinfo=None):
    return call_op("tile", [x], params, out_qinfo)


def squeeze(x, params: P.SqueezeParams, out_qinfo=None):
    return call_op("squeeze", [x], params, out_qinfo)


def expand_dims(x, params: P.ExpandDimsParams, out_qinfo=None):
    return call_op("expand_dims", [x], params, out_qinfo)


def reverse(x, params: P.FlipParams, out_qinfo=None):
    return call_op("reverse", [x], params, out_qinfo)


def flip(x, params: P.FlipParams, out_qinfo=None):
    return call_op("flip", [x], params, out_qinfo)


def stack(inputs, params: P.StackParams, out_qinfo=None):
    return call_op("stack", [list(inputs)], params, out_qinfo)


def unstack(x, params: P.StackParams, out_qinfo=None):
    return call_op("unstack", [x], params, out_qinfo)


def broadcast_to(x, params: P.BroadcastToParams, out_qinfo=None):
    return call_op("broadcast_to", [x], params, out_qinfo)


def crop(x, ref_shape, params: P.CropParams, out_qinfo=None):
    return call_op("crop", [x], params, out_qinfo, ref_shape=ref_shape)


def depth_to_space(x, params: P.DepthToSpaceParams, out_qinfo=None):
    return call_op("depth_to_space", [x], params, out_qinfo)


def space_to_depth(x, params: P.Space2DepthParams, out_qinfo=None):
    return call_op("space_to_depth", [x], params, out_qinfo)


def reorg(x, params: P.Space2DepthParams, out_qinfo=None):
    return call_op("reorg", [x], params, out_qinfo)


def space_to_batch(x, params: P.SpaceToBatchParams, out_qinfo=None):
    return call_op("space_to_batch", [x], params, out_qinfo)


def batch_to_space(x, params: P.BatchToSpaceParams, out_qinfo=None):
    return call_op("batch_to_space", [x], params, out_qinfo)


def space_to_batch_nd(x, params: P.SpaceToBatchNdParams, out_qinfo=None):
    return call_op("space_to_batch_nd", [x], params, out_qinfo)


def batch_to_space_nd(x, params: P.SpaceToBatchNdParams, out_qinfo=None):
    return call_op("batch_to_space_nd", [x], params, out_qinfo)


def shuffle_channel(x, params: P.ShuffleChannelParams, out_qinfo=None):
    return call_op("shuffle_channel", [x], params, out_qinfo)


def one_hot(x, params: P.OneHotParams, out_qinfo=None):
    return call_op("one_hot", [x], params, out_qinfo)


def sequence_mask(lengths, maxlen, params=None, out_qinfo=None):
    return call_op("sequence_mask", [lengths], params, out_qinfo, maxlen=maxlen)


def cast(x, dtype, params=None, out_qinfo=None):
    return call_op("cast", [x], params, out_qinfo, dtype=dtype)


def arange(params: P.ArangeParams, out_qinfo=None):
    """No input carries a device: the values are made on the current
    session's device (the CPU outside a session)."""
    sess = current_session()
    return call_op("arange", [], params, out_qinfo,
                   device=sess.record_device if sess is not None else torch.device("cpu"))


def im2col(x, kernel, stride, pad_, params=None, out_qinfo=None):
    return call_op("im2col", [x], params, out_qinfo, kernel=kernel, stride=stride, pad=pad_)


def col2im(x, out_shape, kernel, stride, pad_, params=None, out_qinfo=None):
    return call_op("col2im", [x], params, out_qinfo, out_shape=out_shape,
                   kernel=kernel, stride=stride, pad=pad_)


def resize(x, params: P.ResizeParams, out_qinfo=None):
    return call_op("resize", [x], params, out_qinfo)


# --- detection ------------------------------------------------------------------

def roipool(x, rois, pooled_size, spatial_scale, params=None, out_qinfo=None):
    return call_op("roipool", [x, rois], params, out_qinfo,
                   pooled_size=pooled_size, spatial_scale=spatial_scale)


def non_max_suppression(boxes, scores, iou_threshold=0.5, max_out=100,
                        params=None, out_qinfo=None):
    return call_op("non_max_suppression", [boxes, scores], params, out_qinfo,
                   iou_threshold=iou_threshold, max_out=max_out)


def roialign(x, rois, params: P.RoiAlignParams = None, out_qinfo=None):
    return call_op("roialign", [x, rois], params or P.RoiAlignParams(), out_qinfo)


def psroipooling(x, rois, params: P.PSROIPoolingParams = None, out_qinfo=None):
    return call_op("psroipooling", [x, rois], params or P.PSROIPoolingParams(), out_qinfo)


def proposal(cls_prob, bbox_pred, im_info, params: P.ProposalParams = None, out_qinfo=None):
    return call_op("proposal", [cls_prob, bbox_pred, im_info],
                   params or P.ProposalParams(), out_qinfo)


# --- LLM / streaming-ASR sequence ops ---------------------------------------------

def rope(x, params: P.RopeParams, positions=None, out_qinfo=None):
    return call_op("rope", [x], params, out_qinfo, positions=positions)


def llm_pos(x, cache, params: P.LlmPosParams, out_qinfo=None):
    return call_op("llm_pos", [x, cache], params, out_qinfo)


def cache_matmul(x, weight, bias, cache, params: P.CacheMatmulParams, out_qinfo=None):
    return call_op("cache_matmul", [x, weight, bias, cache], params, out_qinfo)


def cache_conv1d(x, weight, bias, cache, params: P.CacheConv1dParams, out_qinfo=None):
    return call_op("cache_conv1d", [x, weight, bias, cache], params, out_qinfo)


def fsmn(frame, l_filter, r_filter, frame_sequence, frame_counter,
         params: P.FSMNParams, out_qinfo=None):
    return call_op("fsmn", [frame, l_filter, r_filter, frame_sequence, frame_counter],
                   params, out_qinfo)


__all__ = (["call_op", "MemType", "conv2d", "depthwise_conv2d", "group_conv2d", "conv1d",
            "conv3d", "deconv2d", "deconv3d", "depthwise_conv1d", "group_conv1d",
            "depthwise_deconv2d", "group_deconv2d", "fullyconnected", "matmul", "embedding",
            "scaled_dot_product_attention", "maxpool2d", "avgpool2d", "global_maxpool2d",
            "global_avgpool2d", "maxpool3d", "avgpool3d", "l2pool2d", "maxpool2d_locat",
            "unpooling", "softmax", "log_softmax", "leaky_relu", "relun", "threshold_relu",
            "prelu", "clip", "batch_norm", "layer_norm", "rms_norm", "instance_norm",
            "l2_normalization", "lrn", "argmax", "argmin", "cumsum", "cumprod", "topk",
            "segment_sum", "segment_mean", "segment_max", "segment_min", "segment_prod",
            "mean_stride", "min_stride", "reshape", "transpose", "concat", "split", "slice",
            "strided_slice", "pad", "gather", "gather_nd", "scatter_nd", "tile", "squeeze",
            "expand_dims", "reverse", "flip", "stack", "unstack", "broadcast_to", "crop",
            "depth_to_space", "space_to_depth", "reorg", "space_to_batch", "batch_to_space",
            "space_to_batch_nd", "batch_to_space_nd", "shuffle_channel", "one_hot",
            "sequence_mask", "cast", "arange", "im2col", "col2im", "resize", "roipool",
            "non_max_suppression", "roialign", "psroipooling", "proposal", "rope", "llm_pos",
            "cache_matmul", "cache_conv1d", "fsmn", "where", "select", "where_softmax",
            "data_convert"]
           + [o if o not in ("and", "or", "not") else o + "_"
              for o in _UNARY_OPS + _BINARY_OPS]
           + [o if o not in ("sum", "max", "min", "all", "any") else o + "_"
              for o in _REDUCE_OPS]
           + _UNSORTED_SEGMENT_OPS)
