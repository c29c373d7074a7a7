"""CNN model-building infrastructure: one model definition drives float
inference, PTQ calibration and quantized graph construction (counterpart of
csinn2_tpu/models/common.py: NetBuilder's three modes, every QuantScheme the
JAX builder takes, and the layers of MobileNetV1/V2/V3 and ResNet-50).

(ref: example/c906_mobilenetv1_f16.c:21-1958 — a csinn_ call per layer with
explicit qinfo.)  Model code calls builder.conv/fc/... once, and the
builder either
  * executes eagerly in f32 (mode="float") — the golden path,
  * executes f32 while recording per-layer output ranges (mode="observe") —
    post-training calibration, or
  * records a graph into a Session (mode="graph"): float for FLOAT32, a
    cast for FLOAT16/BFLOAT16, and for the integer schemes per-channel
    symmetric weights plus per-layer activation qinfo from the calibrated
    ranges.  The u8 schemes quantize weights and interior activations to
    s8 (the same values about a zero-point shifted by 128): u8 stays the
    graph-edge representation, and the first conv shifts its input once.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from csinn2_tpu_torch import ops
from csinn2_tpu_torch.core.dtypes import Dtype, Layout, QuantScheme
from csinn2_tpu_torch.core.layout import channel_axis
from csinn2_tpu_torch.core.quant import QuantInfo, from_minmax, observe as observe_qi
from csinn2_tpu_torch.core.tensor import Tensor, from_float


# the float schemes: a cast to this dtype, no ranges
FLOAT_SCHEMES = {QuantScheme.FLOAT16: Dtype.FLOAT16, QuantScheme.BFLOAT16: Dtype.BFLOAT16}


@dataclasses.dataclass
class QuantRecorder:
    """Observed activation ranges keyed by layer name (PTQ state)."""

    ranges: Dict[str, tuple] = dataclasses.field(default_factory=dict)

    def update(self, name: str, arr):
        if isinstance(arr, torch.Tensor):
            lo, hi = float(arr.min()), float(arr.max())
        else:
            lo, hi = float(np.min(arr)), float(np.max(arr))
        if name in self.ranges:
            plo, phi = self.ranges[name]
            lo, hi = min(lo, plo), max(hi, phi)
        self.ranges[name] = (lo, hi)

    def qinfo(self, name: str, scheme: QuantScheme) -> Optional[QuantInfo]:
        if scheme == QuantScheme.FLOAT32:
            return None
        if scheme in FLOAT_SCHEMES:
            return QuantInfo(dtype=FLOAT_SCHEMES[scheme], scheme=scheme)
        lo, hi = self.ranges[name]
        qi = from_minmax(lo, hi, scheme.act_dtype, symmetric=not scheme.asym_act)
        qi.scheme = scheme
        return qi


class NetBuilder:
    """Three-mode model builder; see module docstring."""

    def __init__(self, weights: Dict[str, np.ndarray], scheme: QuantScheme,
                 layout: Layout = Layout.NHWC, mode: str = "float",
                 recorder: Optional[QuantRecorder] = None):
        if mode not in ("float", "observe", "graph"):
            raise ValueError(f"NetBuilder mode {mode!r} (want float, observe or graph)")
        self.w = weights
        self.scheme = scheme
        self.layout = layout
        self.mode = mode
        self.rec = recorder or QuantRecorder()
        self._wcache: Dict[str, Tensor] = {}
        # every named layer output in call order — calibration taps these as
        # extra graph outputs
        self.observed: list = []

    # -- weight handling -----------------------------------------------------

    def weight(self, name: str, per_channel_axis: Optional[int] = 0) -> Tensor:
        """Constant weight tensor, quantized per the scheme in graph mode
        (per-channel symmetric for the integer schemes, s8 for the u8 ones:
        no asymmetric-weight window sums, no in-graph carrier shift)."""
        if name in self._wcache:
            return self._wcache[name]
        arr = np.asarray(self.w[name], np.float32)
        if self.mode != "graph" or self.scheme == QuantScheme.FLOAT32:
            t = Tensor(arr)
        elif self.scheme in FLOAT_SCHEMES:
            qi = QuantInfo(dtype=FLOAT_SCHEMES[self.scheme], scheme=self.scheme)
            t = Tensor(arr.astype(np.float16) if qi.dtype == Dtype.FLOAT16 else arr, qinfo=qi)
        else:
            wdt = self.scheme.weight_dtype
            if wdt.qmin == 0:
                wdt = Dtype.INT8
            qi = observe_qi(arr, wdt, symmetric=True, axis=per_channel_axis)
            qi.scheme = self.scheme
            t = from_float(arr, qi)
        self._wcache[name] = t
        return t

    def bias(self, name: str) -> Optional[Tensor]:
        if name not in self.w:
            return None
        return Tensor(np.asarray(self.w[name], np.float32))

    def _out_qinfo(self, name: str):
        if self.mode != "graph":
            return None
        qi = self.rec.qinfo(name, self.scheme)
        if qi is not None and qi.dtype == Dtype.UINT8:
            # interior activations of the u8 schemes ride s8 carriers, the
            # zero-point shifted by -128 (same scale, identical values)
            lo, hi = self.rec.ranges[name]
            qi = from_minmax(lo, hi, Dtype.INT8, symmetric=not self.scheme.asym_act)
            qi.scheme = self.scheme
        return qi

    def _post(self, t: Tensor, name: str) -> Tensor:
        if self.mode == "observe":
            self.rec.update(name, t.data)
        self.observed.append((name, t))
        return t

    # -- layers --------------------------------------------------------------

    def conv(self, x, name: str, stride=1, pad="same", k=None, group: int = 1,
             relu6: bool = False, relu: bool = False, add=None,
             hswish: bool = False, quant: bool = True) -> Tensor:
        """add: optional residual fused into the conv epilogue (conv + bias +
        residual → activation → one requantize); the range recorded under
        `name` is then the post-join activation."""
        wgt = self.weight(name + ".w")
        k = k or self.w[name + ".w"].shape[2]
        if pad == "same":
            # TF-style SAME padding for stride 1/2
            d = _dim(x, self.layout)
            total = max(k - stride, 0) if d % stride == 0 else max(k - d % stride, 0)
            pt = total // 2
            pd = total - pt
            padding = (pt, pd, pt, pd)
        elif pad == "valid":
            padding = (0, 0, 0, 0)
        else:
            padding = pad if len(pad) == 4 else (pad[0], pad[0], pad[1], pad[1])
        params = ops.Conv2dParams(stride=(stride, stride), pad=padding, group=group,
                                  layout=self.layout, name=name,
                                  fuse_relu=relu, fuse_relu6=relu6, fuse_hswish=hswish)
        out = ops.conv2d(x, wgt, self.bias(name + ".b"), params,
                         out_qinfo=self._out_qinfo(name) if quant else None,
                         residual=add)
        return self._post(out, name)

    def dwconv(self, x, name: str, stride=1, pad="same", relu6=False,
               relu=False, hswish=False) -> Tensor:
        cin = x.shape[channel_axis(self.layout)]
        return self.conv(x, name, stride=stride, pad=pad, group=cin,
                         relu6=relu6, relu=relu, hswish=hswish)

    def fc(self, x, name: str) -> Tensor:
        wgt = self.weight(name + ".w")
        out = ops.fullyconnected(x, wgt, self.bias(name + ".b"),
                                 ops.FCParams(units=self.w[name + ".w"].shape[0], name=name),
                                 out_qinfo=self._out_qinfo(name))
        return self._post(out, name)

    def relu(self, x, name: str) -> Tensor:
        return self._post(ops.relu(x, out_qinfo=self._out_qinfo(name)), name)

    def relu6(self, x, name: str) -> Tensor:
        return self._post(ops.relu6(x, out_qinfo=self._out_qinfo(name)), name)

    def hardswish(self, x, name: str) -> Tensor:
        """x * relu6(x+3)/6 (MobileNetV3)."""
        h = ops.relu6(ops.add(x, Tensor(np.float32(3.0))))
        y = ops.mul(x, ops.mul(h, Tensor(np.float32(1.0 / 6.0))),
                    out_qinfo=self._out_qinfo(name))
        return self._post(y, name)

    def hardsigmoid(self, x, name: str, quant: bool = True) -> Tensor:
        qi = self._out_qinfo(name) if quant else None
        return self._post(ops.hard_sigmoid(x, out_qinfo=qi), name)

    def add(self, a, b, name: str) -> Tensor:
        return self._post(ops.add(a, b, out_qinfo=self._out_qinfo(name)), name)

    def mul(self, a, b, name: str) -> Tensor:
        return self._post(ops.mul(a, b, out_qinfo=self._out_qinfo(name)), name)

    def global_pool(self, x, name: str, quant: bool = True) -> Tensor:
        p = ops.PoolParams(layout=self.layout, name=name)
        qi = self._out_qinfo(name) if quant else None
        return self._post(ops.global_avgpool2d(x, p, out_qinfo=qi), name)

    def maxpool(self, x, name: str, k=3, stride=2, pad=(1, 1, 1, 1)) -> Tensor:
        p = ops.PoolParams(kernel=(k, k), stride=(stride, stride), pad=pad,
                           layout=self.layout, name=name)
        return self._post(ops.maxpool2d(x, p, out_qinfo=self._out_qinfo(name)), name)

    def flatten(self, x) -> Tensor:
        return ops.flatten(x)

    def softmax(self, x, name: str = "softmax") -> Tensor:
        return self._post(ops.softmax(x, ops.SoftmaxParams(axis=-1)), name)


def _dim(x, layout: Layout) -> int:
    # spatial H dim for SAME-pad computation
    return x.shape[1 if layout == Layout.NHWC else 2]


def kaiming(rng: np.random.Generator, shape) -> np.ndarray:
    fan_in = int(np.prod(shape[1:])) if len(shape) > 1 else shape[0]
    return (rng.standard_normal(shape) * np.sqrt(2.0 / fan_in)).astype(np.float32)


def model_from_numpy(cls, weights: Dict[str, np.ndarray], ranges: Dict[str, tuple], **kw):
    """A model of class `cls` carrying another model's state: its weights
    (numpy, e.g. the JAX model's `weights`) and its calibration ranges (its
    `recorder.ranges`), so both quantize from the same numbers."""
    model = cls(**kw)
    if set(weights) != set(model.weights):
        raise ValueError(f"{cls.__name__}: weight names differ from the model's "
                         f"({sorted(set(weights) ^ set(model.weights))[:4]} ...)")
    model.weights = {k: np.array(v, np.float32) for k, v in weights.items()}
    model.recorder = QuantRecorder(ranges={k: (float(lo), float(hi))
                                           for k, (lo, hi) in ranges.items()})
    return model
