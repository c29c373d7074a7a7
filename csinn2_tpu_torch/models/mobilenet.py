"""MobileNet V1/V2/V3 — the reference's flagship CNN configs (counterpart of
csinn2_tpu/models/mobilenet.py).

(ref: example/c906_mobilenetv1_f16.c for V1; BASELINE.md configs 1 and 3.)
`forward(b, x)`
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
from csinn2_tpu_torch.models.common import FLOAT_SCHEMES, NetBuilder, QuantRecorder, kaiming
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

    def _graph(self, scheme: QuantScheme, batch: int, device, name: str, observe: bool,
               compute_dtype=torch.float32):
        """Record this model into a set-up Session; with observe, every
        named layer output is a graph output too."""
        sess = Session(run_mode=RunMode.GRAPH, name=name, device=device,
                       compute_dtype=compute_dtype)
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

    def forward_f32_eager(self, x, device="cuda") -> torch.Tensor:
        """Eager layer-mode float forward (op by op; the unit-test parity
        path), on `device`."""
        x = torch.as_tensor(np.asarray(x, np.float32) if not isinstance(x, torch.Tensor) else x)
        b = NetBuilder(self.weights, QuantScheme.FLOAT32, self.layout, mode="float")
        with torch.inference_mode():
            y = self.forward(b, Tensor(x.float().to(resolve_device(device)), layout=self.layout))
        return y.data

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

    def build_session(self, scheme: QuantScheme, batch: int = 1, compute_dtype=None,
                      device="cuda") -> Session:
        """Quantized (or float) graph-mode Session on `device`, calibrated
        ranges applied.  compute_dtype (the generic ops' float type)
        defaults to bf16 for the FLOAT16/BFLOAT16 schemes, f32 otherwise,
        as in the JAX package."""
        if scheme != QuantScheme.FLOAT32 and not self.recorder.ranges:
            raise ValueError("build_session: calibrate() first (no activation ranges)")
        if compute_dtype is None:
            compute_dtype = torch.bfloat16 if scheme in FLOAT_SCHEMES else torch.float32
        return self._graph(scheme, batch, device, f"{self.name}_{scheme.value}",
                           observe=False, compute_dtype=compute_dtype)[0]

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


class MobileNetV2(_CnnModel):
    """Inverted residual blocks with linear bottlenecks; asymmetric-u8 target
    config (BASELINE.md config 3)."""

    name = "mobilenet_v2"
    # (expansion t, out_channels, repeats n, first_stride s)
    CFG = [(1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
           (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1)]

    def init_weights(self, rng):
        w = self.weights
        w["conv0.w"] = kaiming(rng, (32, 3, 3, 3))
        w["conv0.b"] = np.zeros((32,), np.float32)
        cin = 32
        bi = 0
        for t, cout, n, s in self.CFG:
            for r in range(n):
                hidden = cin * t
                if t != 1:
                    w[f"b{bi}.expand.w"] = kaiming(rng, (hidden, cin, 1, 1))
                    w[f"b{bi}.expand.b"] = np.zeros((hidden,), np.float32)
                w[f"b{bi}.dw.w"] = kaiming(rng, (hidden, 1, 3, 3))
                w[f"b{bi}.dw.b"] = np.zeros((hidden,), np.float32)
                w[f"b{bi}.project.w"] = kaiming(rng, (cout, hidden, 1, 1))
                w[f"b{bi}.project.b"] = np.zeros((cout,), np.float32)
                cin = cout
                bi += 1
        w["conv_last.w"] = kaiming(rng, (1280, cin, 1, 1))
        w["conv_last.b"] = np.zeros((1280,), np.float32)
        w["fc.w"] = kaiming(rng, (self.num_classes, 1280))
        w["fc.b"] = np.zeros((self.num_classes,), np.float32)

    def forward(self, b: NetBuilder, x: Tensor) -> Tensor:
        x = b.conv(x, "conv0", stride=2, relu6=True)
        bi = 0
        cin = 32
        for t, cout, n, s in self.CFG:
            for r in range(n):
                stride = s if r == 0 else 1
                inp = x
                h = x
                if t != 1:
                    h = b.conv(h, f"b{bi}.expand", stride=1, relu6=True)
                h = b.dwconv(h, f"b{bi}.dw", stride=stride, relu6=True)
                # residual fused into the project conv epilogue (see resnet)
                shortcut = inp if (stride == 1 and cin == cout) else None
                h = b.conv(h, f"b{bi}.project", stride=1, add=shortcut)
                x = h
                cin = cout
                bi += 1
        x = b.conv(x, "conv_last", stride=1, relu6=True)
        x = b.global_pool(x, "gap")
        x = b.flatten(x)
        x = b.fc(x, "fc")
        return x


class MobileNetV3(_CnnModel):
    """MobileNetV3-Large essentials: SE blocks + hardswish."""

    name = "mobilenet_v3"
    # (kernel, expansion, out, use_se, activation hs/re, stride)
    CFG = [(3, 16, 16, False, "re", 1), (3, 64, 24, False, "re", 2),
           (3, 72, 24, False, "re", 1), (5, 72, 40, True, "re", 2),
           (5, 120, 40, True, "re", 1), (5, 120, 40, True, "re", 1),
           (3, 240, 80, False, "hs", 2), (3, 200, 80, False, "hs", 1),
           (3, 184, 80, False, "hs", 1), (3, 184, 80, False, "hs", 1),
           (3, 480, 112, True, "hs", 1), (3, 672, 112, True, "hs", 1),
           (5, 672, 160, True, "hs", 2), (5, 960, 160, True, "hs", 1),
           (5, 960, 160, True, "hs", 1)]

    def init_weights(self, rng):
        w = self.weights
        w["conv0.w"] = kaiming(rng, (16, 3, 3, 3))
        w["conv0.b"] = np.zeros((16,), np.float32)
        cin = 16
        for i, (k, exp, cout, se, act, s) in enumerate(self.CFG):
            if exp != cin:
                w[f"b{i}.expand.w"] = kaiming(rng, (exp, cin, 1, 1))
                w[f"b{i}.expand.b"] = np.zeros((exp,), np.float32)
            w[f"b{i}.dw.w"] = kaiming(rng, (exp, 1, k, k))
            w[f"b{i}.dw.b"] = np.zeros((exp,), np.float32)
            if se:
                sq = max(exp // 4, 8)
                w[f"b{i}.se1.w"] = kaiming(rng, (sq, exp, 1, 1))
                w[f"b{i}.se1.b"] = np.zeros((sq,), np.float32)
                w[f"b{i}.se2.w"] = kaiming(rng, (exp, sq, 1, 1))
                w[f"b{i}.se2.b"] = np.zeros((exp,), np.float32)
            w[f"b{i}.project.w"] = kaiming(rng, (cout, exp, 1, 1))
            w[f"b{i}.project.b"] = np.zeros((cout,), np.float32)
            cin = cout
        w["conv_last.w"] = kaiming(rng, (960, cin, 1, 1))
        w["conv_last.b"] = np.zeros((960,), np.float32)
        w["fc1.w"] = kaiming(rng, (1280, 960))
        w["fc1.b"] = np.zeros((1280,), np.float32)
        w["fc.w"] = kaiming(rng, (self.num_classes, 1280))
        w["fc.b"] = np.zeros((self.num_classes,), np.float32)

    def forward(self, b: NetBuilder, x: Tensor) -> Tensor:
        # hardswish activations fuse into the producing conv epilogue (one
        # requantize per conv, not 3-4 extra elementwise nodes); residual
        # joins fuse into the project conv; the SE interior stays quantized,
        # as in the JAX package.
        x = b.conv(x, "conv0", stride=2, hswish=True)
        cin = 16
        for i, (k, exp, cout, se, act, s) in enumerate(self.CFG):
            inp = x
            h = x
            hs = act == "hs"
            if exp != cin:
                h = b.conv(h, f"b{i}.expand", stride=1, hswish=hs, relu=not hs)
            h = b.dwconv(h, f"b{i}.dw", stride=s, hswish=hs, relu=not hs)
            if se:
                p = b.global_pool(h, f"b{i}.se.pool")
                p = b.conv(p, f"b{i}.se1", stride=1, relu=True)
                p = b.conv(p, f"b{i}.se2", stride=1)
                p = b.hardsigmoid(p, f"b{i}.se.sig")
                h = b.mul(h, p, f"b{i}.se.scale")
            shortcut = inp if (s == 1 and cin == cout) else None
            h = b.conv(h, f"b{i}.project", stride=1, add=shortcut)
            x = h
            cin = cout
        x = b.conv(x, "conv_last", stride=1, hswish=True)
        x = b.global_pool(x, "gap")
        x = b.flatten(x)
        x = b.fc(x, "fc1")
        x = b.hardswish(x, "fc1.hs")
        x = b.fc(x, "fc")
        return x
