"""Graph-level operator fusion run at session setup (counterpart of
csinn2_tpu/graph/fuse.py).

The reference fuses at two levels: fused-activation op variants
(CSINN_OP_CONV2D_RELU etc., ref: csinn_data_structure.h:134-337) and
same-device subgraph fusion in the partitioner (shl_subgraph_fvisit_fuse,
ref: source/graph_ref/subgraph.c:956).  This pass rewrites the MobileNet
separable block, a depthwise conv feeding a pointwise conv, into one
`ds_block` node backed by the CUDA kernel in kernels/dsblock.py (int8 in →
int8 out; the depthwise intermediate never reaches device memory).

Only the pairs the kernel computes are fused: a depthwise conv with a
fused hardswish, and a pointwise conv with a fused residual (fuse_add) or
hardswish, stay unfused, since `ds_block` carries neither the residual
input nor a hardswish epilogue.  The JAX package's pass lacks these two
refusals and rewrites MobileNetV2's residual project convs and
MobileNetV3's hardswish depthwise convs into blocks whose output differs
from the unfused graph's (ROADMAP queue C: a fault of the reference).  So
under INT8_SYM the port fuses MobileNetV2's 7 residual-free pairs (of its
17) and MobileNetV3's one (b1, of the JAX pass's 7); MobileNetV1 keeps its
13.

The pass is off by default, as in the JAX package, and opt-in with
CSINN2_FUSE_DS=1; CSINN2_NO_FUSE_DS=1 or config.disable("ds_block") turns
it back off.  (The JAX package keeps it off for a TPU measurement; nothing
about the H100 is implied by that default.)
"""

from __future__ import annotations

import os
from typing import Dict, List

import numpy as np

from csinn2_tpu_torch.core.dtypes import Dtype, Layout
from csinn2_tpu_torch.core.tensor import Tensor
from csinn2_tpu_torch.graph.ir import Graph, Node


def _static_zero(v) -> bool:
    try:
        return not np.any(np.asarray(v))
    except Exception:
        return False


def _static_scalar(v):
    try:
        return float(np.asarray(v).reshape(()))
    except Exception:
        return None


def _int8_sym_carrier(meta) -> bool:
    qi = meta.qinfo
    return (qi is not None and qi.dtype == Dtype.INT8
            and _static_zero(qi.zero_point))


def _is_depthwise(node: Node) -> bool:
    if node.op == "depthwise_conv2d":
        return True
    if node.op != "conv2d" or node.params is None:
        return False
    cax = 3 if node.params.layout == Layout.NHWC else 1
    return node.params.group == node.inputs[0].meta.shape[cax] > 1


def _dw_eligible(node: Node) -> bool:
    p = node.params
    if p is None or p.layout != Layout.NHWC:
        return False
    if tuple(p.dilation) != (1, 1) or tuple(p.stride) not in ((1, 1), (2, 2)):
        return False
    w = node.inputs[1]
    if len(w.meta.shape) != 4 or w.meta.shape[1] != 1:
        return False
    k = w.meta.shape[2]
    if k != w.meta.shape[3] or k not in (3, 5):
        return False
    if any(pv < 0 or pv > k // 2 for pv in p.pad):
        return False
    if len(node.outputs) != 1 or p.fuse_hswish:
        return False
    oq = node.out_qinfo
    if oq is None or oq.dtype != Dtype.INT8 or not _static_zero(oq.zero_point):
        return False
    if _static_scalar(oq.scale) is None:
        return False
    return (_int8_sym_carrier(node.inputs[0].meta)
            and _int8_sym_carrier(w.meta))


def _pw_eligible(node: Node) -> bool:
    p = node.params
    if node.op != "conv2d" or p is None or p.layout != Layout.NHWC:
        return False
    if p.group != 1 or tuple(p.stride) != (1, 1) or tuple(p.pad) != (0, 0, 0, 0):
        return False
    w = node.inputs[1]
    if len(w.meta.shape) != 4 or w.meta.shape[2:] != (1, 1):
        return False
    if len(node.outputs) != 1 or p.fuse_add or p.fuse_hswish:
        return False
    return _int8_sym_carrier(w.meta)


def _bias_or_zeros(node: Node, channels: int) -> Tensor:
    if len(node.inputs) >= 3 and node.inputs[2] is not None:
        return node.inputs[2]
    return Tensor(np.zeros((channels,), np.float32))


def fuse_ds_blocks(graph: Graph) -> int:
    """Rewrite depthwise→pointwise int8 pairs into fused ds_block nodes.

    Returns the number of pairs fused.  Structural requirements: the dw
    output feeds exactly one node (the 1x1 conv) and is not a graph output;
    all carriers int8 with zero zero-points (symmetric schemes); NHWC."""
    if not os.environ.get("CSINN2_FUSE_DS"):
        return 0
    if os.environ.get("CSINN2_NO_FUSE_DS"):
        return 0
    from csinn2_tpu_torch.utils.config import config
    if config.is_disabled("ds_block"):
        return 0
    from csinn2_tpu_torch.ops.registry import registry

    consumers: Dict[int, List[Node]] = {}
    for n in graph.nodes:
        for t in n.inputs:
            if isinstance(t, Tensor):
                consumers.setdefault(id(t), []).append(n)
    out_ids = {id(t) for t in graph.outputs}

    fused = 0
    new_nodes: List[Node] = []
    skip = set()
    for node in graph.nodes:
        if id(node) in skip:
            continue
        if not (_is_depthwise(node) and _dw_eligible(node)):
            new_nodes.append(node)
            continue
        mid = node.outputs[0]
        users = consumers.get(id(mid), [])
        if len(users) != 1 or id(mid) in out_ids:
            new_nodes.append(node)
            continue
        pw = users[0]
        if not _pw_eligible(pw) or pw.inputs[0] is not mid:
            new_nodes.append(node)
            continue

        x_t, w1_t = node.inputs[0], node.inputs[1]
        w2_t = pw.inputs[1]
        C = x_t.meta.shape[3]
        k = w1_t.meta.shape[2]
        b1_t = _bias_or_zeros(node, C)
        b2_t = _bias_or_zeros(pw, w2_t.meta.shape[0])

        extra = dict(k=int(k),
                     mid_scale=_static_scalar(node.out_qinfo.scale),
                     mid_relu=bool(node.params.fuse_relu),
                     mid_relu6=bool(node.params.fuse_relu6),
                     pw_relu=bool(pw.params.fuse_relu),
                     pw_relu6=bool(pw.params.fuse_relu6))
        cb = registry.lookup("ds_block")
        inputs = [x_t, w1_t, b1_t, w2_t, b2_t]
        metas = tuple(t.meta for t in inputs)
        params = node.params
        out_qinfo = pw.out_qinfo

        def exec_fn(arrays, _metas=metas, _params=params,
                    _oq=out_qinfo, _extra=dict(extra), _cb=cb):
            return _cb.exec(arrays, list(_metas), _params, _oq, **_extra)

        fnode = Node(op="ds_block", inputs=inputs, params=params,
                     exec_fn=exec_fn, outputs=[pw.outputs[0]],
                     name=f"{node.name}+{pw.name}", cb_name=cb.name,
                     structure=["T"] * 5, extra=extra, out_qinfo=out_qinfo)
        pw.outputs[0].producer = fnode
        new_nodes.append(fnode)
        skip.add(id(pw))
        fused += 1

    if fused:
        graph.nodes = new_nodes
    return fused
