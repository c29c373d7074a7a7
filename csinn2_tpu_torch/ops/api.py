"""Public op API over Tensor handles (counterpart of csinn2_tpu/ops/api.py;
the ops the CNN models' NetBuilder calls — conv2d with the fused residual,
depthwise_conv2d, group_conv2d, fullyconnected, the pools, flatten,
softmax — the generated unary and binary families over what ops/ref
registers (elementwise math, comparison, logic, activations), and matmul
and scaled_dot_product_attention, which with block-quantized (Q8_0 / Q4_0)
weights and long or cached attention reach the CUDA tier of
kernels/autodispatch.py.  The rest of the 346-function csinn_* surface is
ROADMAP queue A item 10.4).

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

from csinn2_tpu_torch.core.dtypes import Api, DebugLevel, Dtype, Layout, QuantScheme, dtype_of
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
    """The device the op runs on: the recording session's, else the first
    input's (constants follow it)."""
    if sess is not None and sess.recording:
        return sess.device
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


# the JAX package's lists, less the shape-family ops not ported yet
# (shape, ndarray_size, yuv_rgb_scale)
_UNARY_OPS = [
    "abs", "acos", "acosh", "asin", "asinh", "atan", "atanh", "ceil", "cos",
    "cosh", "exp", "expm1", "floor", "log", "log1p", "negative", "round",
    "rsqrt", "sign", "sin", "sinh", "sqrt", "square", "tan", "trunc", "isnan",
    "relu", "relu1", "relu6", "sigmoid", "hard_sigmoid", "silu", "erf", "tanh",
    "softplus", "softrelu", "softsign", "gelu", "elu", "logical_not", "not",
    "flatten",
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


__all__ = (["call_op", "conv2d", "depthwise_conv2d", "group_conv2d", "fullyconnected",
            "matmul", "scaled_dot_product_attention", "maxpool2d", "avgpool2d",
            "global_maxpool2d", "global_avgpool2d", "maxpool3d", "avgpool3d", "l2pool2d",
            "softmax", "log_softmax", "leaky_relu", "relun", "threshold_relu", "prelu",
            "clip", "where", "select", "where_softmax", "data_convert"]
           + [o if o not in ("and", "or", "not") else o + "_"
              for o in _UNARY_OPS + _BINARY_OPS])
