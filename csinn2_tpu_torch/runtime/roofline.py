"""Static roofline model over a recorded session graph (counterpart of
csinn2_tpu/runtime/roofline.py).

The reference prints measured ms/layer (SHL_LAYER_BENCHMARK,
source/graph_ref/setup.c:1333-1357) but has no analytic cost model.  Per
node this computes the FLOPs and the HBM bytes — the same counts as the JAX
package's, which do not depend on the chip — takes max(t_flops, t_bytes)
as that node's floor, and sums, here against one H100 SXM's rates.

Two totals, with the JAX package's meaning:
  * fused_sol_s — elementwise nodes (requantize, activation, add, pad,
    reshape, ...) fused into their producer/consumer conv or GEMM, so they
    pay no HBM bytes of their own (save the residual read a fused epilogue
    still needs), and the busiest engine's serial time is the floor;
  * unfused_sol_s — every node pays its own bytes and its own floor.
The port replays the graph eagerly (runtime/session.py): every node reads
its inputs from HBM and writes its outputs back, whatever XLA would have
fused.  So the port's own floor is the UNFUSED total; the fused total is
what a fusing compiler could reach on the same card.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

# H100 SXM (NVIDIA H100 Tensor Core GPU data sheet, SXM5 part, dense rates
# without sparsity, at the 700 W power limit) — the constants chip_smoke.py
# uses for its kernels' bounds.
HBM_GBPS = 3350.0          # HBM3, GB/s
INT8_TOPS = 1979.0         # int8 tensor-core peak
BF16_TFLOPS = 989.0        # bf16 / fp16 tensor-core peak
F32_TFLOPS = 67.0          # FP32 on the CUDA cores: the port's f32 convs and
#                            GEMMs run in full f32 (TF32 off), not on the
#                            tensor cores
SIMT_OPS_S = F32_TFLOPS * 1e12   # depthwise convs: off the tensor cores

# ops whose HBM traffic a fusing compiler folds into an adjacent conv / GEMM
_FUSABLE = {
    "relu", "relu6", "leaky_relu", "prelu", "sigmoid", "silu", "clip",
    "hard_swish", "hard_sigmoid", "erf", "add", "sub", "mul", "div",
    "minimum", "maximum", "requantize", "quantize", "dequantize",
    "data_convert", "pad", "reshape", "squeeze", "expand_dims", "transpose",
    "cast", "bn", "batch_normalization", "bias_add",
    # NOT softmax: a multi-pass reduction, generally its own kernel, so it
    # pays its own HBM bytes (matters for attention graphs)
}

# ops that are pure shape/metadata moves — free
_FREE = {"reshape", "squeeze", "expand_dims", "identity"}


@dataclasses.dataclass
class NodeCost:
    name: str
    op: str
    flops: int          # multiply-add counted as 2
    act_bytes: int      # activation read + write
    w_bytes: int        # parameter read
    fusable: bool
    extra_read: int = 0  # bytes a fused epilogue still MUST read (residual
    #                      second operand) — counted in the fused total
    vpu_ops: int = 0    # ops that run off the matrix units (depthwise convs;
    #                     the JAX package's name): on the H100 the CUDA
    #                     cores, at SIMT_OPS_S.  The node's compute floor is
    #                     the larger of vpu_ops / SIMT_OPS_S and the rest of
    #                     its flops over the matrix units' peak.

    VPU_OPS_S = SIMT_OPS_S

    @property
    def bytes(self) -> int:
        return self.act_bytes + self.w_bytes

    def _times(self, peak_tops: float, hbm_gbps: float):
        """Seconds on (HBM, the matrix units, the CUDA cores)."""
        return (self.bytes / (hbm_gbps * 1e9),
                (self.flops - self.vpu_ops) / (peak_tops * 1e12),
                self.vpu_ops / self.VPU_OPS_S)

    def t_us(self, peak_tops: float, hbm_gbps: float) -> float:
        return max(self._times(peak_tops, hbm_gbps)) * 1e6

    def bound(self, peak_tops: float, hbm_gbps: float) -> str:
        """"hbm", "tensor" (the matrix units at peak_tops) or "simt" (the
        CUDA cores, for vpu_ops): what sets this node's floor."""
        t = self._times(peak_tops, hbm_gbps)
        return ("hbm", "tensor", "simt")[t.index(max(t))]


def _nbytes(meta) -> int:
    return int(meta.byte_size)


def _conv_flops(node) -> int:
    out = node.outputs[0].meta.shape
    w = node.inputs[1].meta.shape          # [O, I/g, kh, kw]
    n = int(np.prod(out))
    per_out = int(np.prod(w[1:]))          # I/g * kh * kw  (depthwise: 1*kh*kw)
    return 2 * n * per_out


def _matmul_flops(node) -> int:
    a = node.inputs[0].meta.shape
    out = node.outputs[0].meta.shape
    k = a[-1]
    return 2 * int(np.prod(out)) * int(k)


def node_cost(node, consts_ids) -> NodeCost:
    act_in = sum(_nbytes(t.meta) for t in node.inputs
                 if t is not None and id(t) not in consts_ids)
    w_in = sum(_nbytes(t.meta) for t in node.inputs
               if t is not None and id(t) in consts_ids)
    out_b = sum(_nbytes(t.meta) for t in node.outputs)

    op = node.op
    extra_read = 0
    vpu_ops = 0
    if op in ("conv2d", "depthwise_conv2d", "group_conv2d", "conv2d_relu",
              "conv2d_relu6", "deconv2d", "ds_block"):
        flops = _conv_flops(node)
        dw_flops = flops
        if op == "ds_block":  # dw (inputs[1]) + pw (inputs[3]) pair
            out = node.outputs[0].meta.shape
            w1 = node.inputs[1].meta.shape
            mid = int(np.prod(out[:-1])) * w1[0]
            dw_flops = 2 * mid * int(np.prod(w1[1:]))
            flops = dw_flops + _matmul_flops(node)
        # depthwise structure (I/g == 1): off the matrix units.  A ds_block
        # counts only its depthwise half there: fused_dsconv runs its
        # pointwise half on the int8 tensor cores (the JAX package counts
        # the whole block at its VPU rate)
        w_shape = node.inputs[1].meta.shape
        grp = int(getattr(node.params, "group", 1) or 1)
        if op == "depthwise_conv2d" or (len(w_shape) == 4 and grp > 1
                                        and w_shape[1] == 1):
            vpu_ops = dw_flops
        fusable = False
    elif op in ("fullyconnected", "matmul", "cache_matmul"):
        flops = _matmul_flops(node)
        fusable = False
    elif op in _FREE:
        flops = 0
        act_in = out_b = 0
        fusable = True
    else:
        flops = int(np.prod(node.outputs[0].meta.shape)) if node.outputs else 0
        fusable = op in _FUSABLE
        if fusable and op in ("add", "sub", "mul", "div", "minimum",
                              "maximum"):
            # Residual-style binary elementwise between two PRODUCED
            # tensors: one operand rides the producer's fused epilogue, but
            # the OTHER is a real extra HBM read the fusion cannot elide
            # (e.g. every ResNet/MNv2 skip connection).  Count that operand
            # as unavoidable traffic even in the fused total.
            produced = [t for t in node.inputs
                        if t is not None and id(t) not in consts_ids]
            if len(produced) >= 2:
                extra_read = min(_nbytes(t.meta) for t in produced)
    cost = NodeCost(name=node.name or op, op=op, flops=flops,
                    act_bytes=act_in + out_b, w_bytes=w_in, fusable=fusable)
    cost.extra_read = extra_read
    cost.vpu_ops = vpu_ops
    return cost


@dataclasses.dataclass
class RooflineReport:
    costs: List[NodeCost]
    peak_tops: float
    hbm_gbps: float

    @property
    def total_flops(self) -> int:
        return sum(c.flops for c in self.costs)

    @property
    def fused_sol_s(self) -> float:
        """Speed-of-light seconds with every elementwise chain fused (plus
        the residual-read traffic fusion cannot elide — extra_read).

        Engine-concurrency bound: HBM traffic, the matrix units and the
        CUDA cores run concurrently across nodes, so the only provable floor
        is the busiest engine's total serial time — max(Σ HBM, Σ matrix,
        Σ SIMT)."""
        mat = [c for c in self.costs if not c.fusable]
        t_hbm = (sum(c.bytes for c in mat)
                 + sum(c.extra_read for c in self.costs if c.fusable)) \
            / (self.hbm_gbps * 1e9)
        t_mat = sum(c.flops - c.vpu_ops for c in mat) / (self.peak_tops * 1e12)
        t_simt = sum(c.vpu_ops for c in mat) / NodeCost.VPU_OPS_S
        return max(t_hbm, t_mat, t_simt)

    @property
    def unfused_sol_s(self) -> float:
        """Every node's own floor, summed: the floor of the port's eager
        replay."""
        return sum(c.t_us(self.peak_tops, self.hbm_gbps)
                   for c in self.costs) * 1e-6

    def table(self, top: Optional[int] = None) -> str:
        rows = sorted((c for c in self.costs if not c.fusable),
                      key=lambda c: -c.t_us(self.peak_tops, self.hbm_gbps))
        if top:
            rows = rows[:top]
        lines = [f"{'node':<28}{'op':<18}{'GFLOP':>8}{'MB':>8}"
                 f"{'floor_us':>10} bound"]
        for c in rows:
            lines.append(
                f"{c.name:<28}{c.op:<18}{c.flops/1e9:>8.3f}"
                f"{c.bytes/1e6:>8.2f}"
                f"{c.t_us(self.peak_tops, self.hbm_gbps):>10.1f} "
                f"{c.bound(self.peak_tops, self.hbm_gbps)}")
        return "\n".join(lines)


def analyze(session, peak_tops: Optional[float] = None,
            hbm_gbps: float = HBM_GBPS) -> RooflineReport:
    """Roofline report for a set-up session's graph on one H100 SXM.

    peak_tops defaults by the DOMINANT matrix-node carrier dtype: 1979 TOP/s
    int8, 989 TFLOP/s bf16/f16, 67 TFLOP/s for f32 carriers — pass it
    explicitly to override."""
    g = session.graph
    if peak_tops is None:
        votes = {"int": 0, "bf16": 0, "f32": 0}
        for n in g.nodes:
            if n.op in ("conv2d", "depthwise_conv2d", "group_conv2d",
                        "conv2d_relu", "conv2d_relu6", "deconv2d", "ds_block",
                        "fullyconnected", "matmul", "cache_matmul"):
                dt = str(getattr(n.inputs[0].meta, "dtype", "")).lower()
                if "int" in dt or "uint" in dt:
                    votes["int"] += 1
                elif "32" in dt:
                    votes["f32"] += 1
                else:
                    votes["bf16"] += 1
        top = max(votes, key=votes.get)
        peak_tops = {"int": INT8_TOPS, "bf16": BF16_TFLOPS, "f32": F32_TFLOPS}[top]
    consts_ids = set()
    # tensors carrying a const_key or payload are weights
    for n in g.nodes:
        for t in n.inputs:
            if t is None:
                continue
            if getattr(t.meta, "const_key", None) or getattr(t, "data", None) is not None:
                consts_ids.add(id(t))
    for t in g.inputs:
        consts_ids.discard(id(t))
    costs = [node_cost(n, consts_ids) for n in g.nodes]
    return RooflineReport(costs=costs, peak_tops=peak_tops, hbm_gbps=hbm_gbps)
