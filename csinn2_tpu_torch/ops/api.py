"""Public op API over Tensor handles (counterpart of csinn2_tpu/ops/api.py;
the ops MobileNetV1's NetBuilder calls: conv2d, depthwise_conv2d,
fullyconnected, global_avgpool2d, flatten, relu, relu6, softmax; and matmul
and scaled_dot_product_attention, which with block-quantized (Q8_0 / Q4_0)
weights and long or cached attention reach the CUDA tier of
kernels/autodispatch.py.  The rest of the 346-function csinn_* surface is
ROADMAP queue A item 10).

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

from typing import Any, List, Optional, Sequence, Union

import numpy as np
import torch

from csinn2_tpu_torch.core.dtypes import Api, DebugLevel, Layout, QuantScheme, dtype_of
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


# --- unary wrappers -----------------------------------------------------------

def _unary(op):
    def fn(x, params=None, out_qinfo=None):
        return call_op(op, [x], params, out_qinfo)
    fn.__name__ = op
    return fn


relu = _unary("relu")
relu6 = _unary("relu6")
flatten = _unary("flatten")


# --- structured ops ---------------------------------------------------------

def _w_layout(weight):
    if isinstance(weight, Tensor) and weight.layout in (Layout.OHWI, Layout.OIHW,
                                                        Layout.O1HW, Layout.HWO1):
        return weight.layout
    return Layout.OIHW


def _conv_inputs(x, weight, bias):
    """[x, weight, bias].  The JAX package appends an AOT zp-weight-sum
    vector when x has a static nonzero zero-point (the asymmetric schemes);
    that fold is not ported yet."""
    if isinstance(x, Tensor) and x.qinfo is not None and not x.qinfo.dtype.is_float \
            and np.any(np.asarray(x.qinfo.zero_point) != 0):
        raise NotImplementedError("conv2d on an activation with a nonzero zero-point "
                                  "(the zp-weight-sum fold, MobileNetV2-u8) is not "
                                  "ported yet (ROADMAP queue A item 10)")
    return [x, weight, bias]


def conv2d(x, weight, bias=None, params: P.Conv2dParams = None, out_qinfo=None,
           residual=None):
    """residual (the fused ResNet join) is not ported yet."""
    if residual is not None:
        raise NotImplementedError("conv2d(residual=...) is not ported yet "
                                  "(ROADMAP queue A items 10-11: ResNet-50 fuse_add)")
    params = params or P.Conv2dParams()
    return call_op("conv2d", _conv_inputs(x, weight, bias), params, out_qinfo,
                   w_layout=_w_layout(weight))


def depthwise_conv2d(x, weight, bias=None, params: P.Conv2dParams = None, out_qinfo=None):
    params = params or P.Conv2dParams()
    return call_op("depthwise_conv2d", _conv_inputs(x, weight, bias), params, out_qinfo,
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


def global_avgpool2d(x, params: P.PoolParams = None, out_qinfo=None):
    return call_op("global_avgpool2d", [x], params or P.PoolParams(), out_qinfo)


def softmax(x, params: P.SoftmaxParams = None, out_qinfo=None):
    return call_op("softmax", [x], params or P.SoftmaxParams(), out_qinfo)


__all__ = ["call_op", "conv2d", "depthwise_conv2d", "fullyconnected", "matmul",
           "scaled_dot_product_attention", "global_avgpool2d", "flatten", "relu", "relu6",
           "softmax"]
