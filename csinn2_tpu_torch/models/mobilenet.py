"""MobileNetV1 — the reference's flagship CNN config (counterpart of
csinn2_tpu/models/mobilenet.py; MobileNetV2 and V3 are ROADMAP queue A
item 11).

(ref: example/c906_mobilenetv1_f16.c; BASELINE.md config 1.)  `forward(b, x)`
defines the net once over a NetBuilder; `build_session` records a calibrated
quantized Session.  BN is assumed folded into the conv weights (the
inference deployment form, as in the reference example).  Seeded weights
come from numpy exactly as in the JAX package, so both packages build the
same model from the same seed.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from csinn2_tpu_torch.core.dtypes import Dtype, Layout, QuantScheme, RunMode
from csinn2_tpu_torch.core.quant import quantize
from csinn2_tpu_torch.core.tensor import Tensor, TensorMeta
from csinn2_tpu_torch.models.common import NetBuilder, QuantRecorder, check_scheme, kaiming
from csinn2_tpu_torch.runtime.session import Session
from csinn2_tpu_torch.utils.device import resolve_device


class _CnnModel:
    """Shared calibrate/build/run scaffolding.  Every method that runs the
    model takes `device` ("cuda" by default; it raises without a card
    unless the caller passes "cpu")."""

    name = "cnn"

    def __init__(self, num_classes: int = 1000, input_size: int = 224,
                 layout: Layout = Layout.NHWC, seed: int = 0):
        self.num_classes = num_classes
        self.input_size = input_size
        self.layout = layout
        self.weights: Dict[str, np.ndarray] = {}
        self.recorder = QuantRecorder()
        self.init_weights(np.random.default_rng(seed))

    # subclasses: init_weights(rng), forward(b, x)

    def input_shape(self, batch: int = 1):
        s = self.input_size
        return (batch, s, s, 3) if self.layout == Layout.NHWC else (batch, 3, s, s)

    def _graph(self, scheme: QuantScheme, batch: int, device, name: str, observe: bool):
        """Record this model into a set-up Session; with observe, every
        named layer output is a graph output too."""
        check_scheme(scheme)
        sess = Session(run_mode=RunMode.GRAPH, name=name, device=device)
        b = NetBuilder(self.weights, scheme, self.layout, mode="graph",
                       recorder=self.recorder)
        in_qinfo = None
        if scheme != QuantScheme.FLOAT32:
            in_qinfo = self.recorder.qinfo("input", scheme)
        with sess.build():
            x = sess.input(TensorMeta(shape=self.input_shape(batch),
                                      dtype=in_qinfo.dtype if in_qinfo else Dtype.FLOAT32,
                                      layout=self.layout, qinfo=in_qinfo, name="input"))
            y = self.forward(b, x)
            sess.set_output(*([t for _, t in b.observed] if observe else [y]))
        sess.setup()
        sess.input_qinfo = in_qinfo
        return sess, b

    def forward_f32(self, x, device="cuda") -> torch.Tensor:
        """Float golden: the float graph, replayed on `device` (TF32 off)."""
        x = torch.as_tensor(np.asarray(x, np.float32) if not isinstance(x, torch.Tensor) else x)
        sess = self._float_session(x.shape[0], device)
        return sess.run(x.float())

    def _float_session(self, batch: int, device) -> Session:
        key = ("float", batch, resolve_device(device))
        cache = self.__dict__.setdefault("_sess_cache", {})
        if key not in cache:
            cache[key] = self._graph(QuantScheme.FLOAT32, batch, device,
                                     f"{self.name}_f32", observe=False)[0]
        return cache[key]

    def calibrate(self, calib_x, device="cuda") -> QuantRecorder:
        """PTQ range observation: one float-graph run on `device` with every
        named layer output tapped as an extra graph output."""
        x = torch.as_tensor(np.asarray(calib_x, np.float32)
                            if not isinstance(calib_x, torch.Tensor) else calib_x).float()
        sess, b = self._graph(QuantScheme.FLOAT32, x.shape[0], device,
                              f"{self.name}_calib", observe=True)
        outs = sess.run(x, unwrap=False)
        self.recorder.update("input", x)
        for (name, _), arr in zip(b.observed, outs):
            self.recorder.update(name, arr)
        return self.recorder

    def build_session(self, scheme: QuantScheme, batch: int = 1, device="cuda") -> Session:
        """Quantized (or float) graph-mode Session on `device`, calibrated
        ranges applied."""
        if scheme != QuantScheme.FLOAT32 and not self.recorder.ranges:
            raise ValueError("build_session: calibrate() first (no activation ranges)")
        return self._graph(scheme, batch, device, f"{self.name}_{scheme.value}",
                           observe=False)[0]

    def prepare_input(self, x, sess: Session) -> torch.Tensor:
        """Float input → the session's input carrier, on its device."""
        x = torch.as_tensor(np.asarray(x, np.float32)
                            if not isinstance(x, torch.Tensor) else x).float().to(sess.device)
        qi = getattr(sess, "input_qinfo", None)
        if qi is None or qi.dtype.is_float:
            return x
        return quantize(x, qi)


class MobileNetV1(_CnnModel):
    """(ref: example/c906_mobilenetv1_f16.c — conv 3x3 s2 + 13 depthwise-
    separable blocks + global pool + fc1000)."""

    name = "mobilenet_v1"
    # (dw_stride, out_channels) per separable block
    CFG = [(1, 64), (2, 128), (1, 128), (2, 256), (1, 256), (2, 512),
           (1, 512), (1, 512), (1, 512), (1, 512), (1, 512), (2, 1024), (1, 1024)]

    def __init__(self, alpha: float = 1.0, **kw):
        self.alpha = alpha
        super().__init__(**kw)

    def init_weights(self, rng):
        a = self.alpha
        c = int(32 * a)
        w = self.weights
        w["conv0.w"] = kaiming(rng, (c, 3, 3, 3))
        w["conv0.b"] = np.zeros((c,), np.float32)
        cin = c
        for i, (s, cout) in enumerate(self.CFG):
            cout = int(cout * a)
            w[f"dw{i}.w"] = kaiming(rng, (cin, 1, 3, 3))
            w[f"dw{i}.b"] = np.zeros((cin,), np.float32)
            w[f"pw{i}.w"] = kaiming(rng, (cout, cin, 1, 1))
            w[f"pw{i}.b"] = np.zeros((cout,), np.float32)
            cin = cout
        w["fc.w"] = kaiming(rng, (self.num_classes, cin))
        w["fc.b"] = np.zeros((self.num_classes,), np.float32)

    def forward(self, b: NetBuilder, x: Tensor) -> Tensor:
        x = b.conv(x, "conv0", stride=2, relu6=True)
        for i, (s, _) in enumerate(self.CFG):
            x = b.dwconv(x, f"dw{i}", stride=s, relu6=True)
            x = b.conv(x, f"pw{i}", stride=1, relu6=True)
        x = b.global_pool(x, "gap")
        x = b.flatten(x)
        x = b.fc(x, "fc")
        return x
