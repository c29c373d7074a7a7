"""The PyTorch port's CNN zoo (MobileNetV2, MobileNetV3, ResNet-50, and
MobileNetV1 under BFLOAT16) against the JAX package, on the CPU.

Each model is built in JAX at input 32, calibrated on a seeded batch of 2
and carried across with `model_from_numpy` (same weights, same ranges);
both packages then run the same quantized session on the same numpy input.
Gates:
  * the port's int8/uint8 logits equal the JAX session's, except at most
    FC_LSB = 1 where an fc's float-carrier sum (f64 rounded once in the
    port, f32 in XLA's order) rounds the other way — the one stated
    tolerance;
  * forward_f32 and forward_f32_eager agree with JAX's forward_f32, and
    calibrate and the "observe" builder mode with JAX's calibrated ranges,
    to rtol 1e-5 (with an absolute floor of 1e-5·max|y| for values that
    cancel to near zero);
  * MobileNetV1 BFLOAT16 and FLOAT16: the logits within BF16_TOL (one
    bf16 ulp) of max|y| of the JAX session's — every layer rounds to
    bf16 / f16, and the f32 conv sums (oneDNN's order against XLA's) can
    land on either side of a rounding (they are equal on an x86 CPU);
  * the fuse pass (CSINN2_FUSE_DS=1) at INT8_SYM: the port fuses 7 pairs
    of MobileNetV2 and 1 of MobileNetV3, with fused logits equal to the
    unfused ones; the JAX pass fuses 17 and 7, and its fused logits differ
    from its unfused ones (ROADMAP queue C, a fault of the reference).
"""

import os

import numpy as np
import pytest
import torch

from csinn2_tpu.core.dtypes import Layout as JLayout
from csinn2_tpu.core.dtypes import QuantScheme as JQS
from csinn2_tpu.models.mobilenet import MobileNetV1 as JMobileNetV1
from csinn2_tpu.models.mobilenet import MobileNetV2 as JMobileNetV2
from csinn2_tpu.models.mobilenet import MobileNetV3 as JMobileNetV3
from csinn2_tpu.models.resnet import ResNet50 as JResNet50
from csinn2_tpu_torch.core.dtypes import Layout, QuantScheme
from csinn2_tpu_torch.core.tensor import Tensor
from csinn2_tpu_torch.models.common import NetBuilder, model_from_numpy
from csinn2_tpu_torch.models.mobilenet import MobileNetV1, MobileNetV2, MobileNetV3
from csinn2_tpu_torch.models.resnet import ResNet50

torch.set_num_threads(2)

FC_LSB = 1         # stated tolerance of the float-carrier fc's int8 output
BF16_TOL = 2 ** -7  # stated tolerance of the bf16 logits: one bf16 ulp of max|y|
SIZE, BATCH = 32, 2

# name → (JAX class, port class, layout, constructor kwargs)
MODELS = {
    "v2": (JMobileNetV2, MobileNetV2, "nhwc", {}),
    "v3": (JMobileNetV3, MobileNetV3, "nhwc", {}),
    "r50_nhwc": (JResNet50, ResNet50, "nhwc", {}),
    "r50_nchw": (JResNet50, ResNet50, "nchw", {}),
    "v1": (JMobileNetV1, MobileNetV1, "nhwc", {"alpha": 0.25}),
}
# the sessions held to JAX bit for bit: (model, scheme)
CASES = [("v2", "UINT8_ASYM"), ("v3", "INT8_ASYM_W_SYM"), ("v3", "INT8_SYM"),
         ("r50_nhwc", "INT8_SYM"), ("r50_nchw", "INT8_SYM")]


def _layouts(lay):
    return ((JLayout.NHWC, Layout.NHWC) if lay == "nhwc" else (JLayout.NCHW, Layout.NCHW))


class _Env:
    """CSINN2_FUSE_DS set or cleared for a block, restored after."""

    def __init__(self, fused: bool):
        self.fused = fused

    def __enter__(self):
        self.old = {k: os.environ.pop(k, None) for k in ("CSINN2_FUSE_DS", "CSINN2_NO_FUSE_DS")}
        if self.fused:
            os.environ["CSINN2_FUSE_DS"] = "1"

    def __exit__(self, *exc):
        os.environ.pop("CSINN2_FUSE_DS", None)
        for k, v in self.old.items():
            if v is not None:
                os.environ[k] = v


@pytest.fixture(scope="module")
def zoo():
    """Every JAX model calibrated once; its sessions' outputs built on
    demand and kept: zoo(name) → (jax model, x), zoo.out(name, scheme,
    fused) → (logits, ds_block count)."""
    models, outs = {}, {}

    class Zoo:
        def __call__(self, name):
            if name not in models:
                jcls, _, lay, kw = MODELS[name]
                m = jcls(input_size=SIZE, layout=_layouts(lay)[0], **kw)
                x = np.random.default_rng(1).random(m.input_shape(BATCH)).astype(np.float32)
                m.calibrate(x)
                models[name] = (m, x)
            return models[name]

        def out(self, name, scheme, fused=False):
            key = (name, scheme, fused)
            if key not in outs:
                m, x = self(name)
                with _Env(fused):
                    s = m.build_session(JQS[scheme], batch=BATCH)
                outs[key] = (np.asarray(s.run(m.prepare_input(x, s))),
                             sum(n.op == "ds_block" for n in s.graph.nodes))
            return outs[key]

    return Zoo()


def _port(zoo, name):
    jm, x = zoo(name)
    _, pcls, lay, kw = MODELS[name]
    return model_from_numpy(pcls, jm.weights, jm.recorder.ranges, input_size=SIZE,
                            layout=_layouts(lay)[1], **kw), x


def _run(m, x, scheme, fused=False, batch=BATCH):
    with _Env(fused):
        s = m.build_session(QuantScheme[scheme], batch=batch, device="cpu")
    return s.run(m.prepare_input(x, s)), sum(n.op == "ds_block" for n in s.graph.nodes)


@pytest.mark.parametrize("name,scheme", CASES, ids=[f"{n}-{s}" for n, s in CASES])
def test_session_matches_jax(zoo, name, scheme):
    want, _ = zoo.out(name, scheme)
    m, x = _port(zoo, name)
    got, _ = _run(m, x, scheme)
    assert got.dtype == torch.int8 and tuple(got.shape) == (BATCH, 1000)
    assert str(want.dtype) == "int8"
    d = np.abs(got.numpy().astype(int) - want.astype(int))
    assert d.max() <= FC_LSB, (d.max(), int((d > 0).sum()))


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("name", ["v2", "v3", "r50_nhwc", "r50_nchw"])
def test_forward_f32_and_eager_match_jax(zoo, name):
    jm, x = zoo(name)
    m, _ = _port(zoo, name)
    want = jm.forward_f32(x)
    _close(m.forward_f32(x, device="cpu").numpy(), want)
    # the JAX eager forward compiles op by op (seconds a model): the port's
    # eager forward is held to the same JAX golden
    _close(m.forward_f32_eager(x, device="cpu").numpy(), want)


@pytest.mark.parametrize("name", ["v2", "v3", "r50_nhwc"])
def test_calibrate_graph_and_observe_match_jax(zoo, name):
    jm, x = zoo(name)
    jcls, pcls, lay, kw = MODELS[name]
    m = pcls(input_size=SIZE, layout=_layouts(lay)[1], **kw)    # same seed → same weights
    assert all(np.array_equal(m.weights[k], jm.weights[k]) for k in jm.weights)
    m.calibrate(x, device="cpu")
    assert set(m.recorder.ranges) == set(jm.recorder.ranges)
    for k, (lo, hi) in jm.recorder.ranges.items():
        np.testing.assert_allclose(m.recorder.ranges[k], (lo, hi), rtol=1e-5,
                                   atol=1e-5 * max(abs(lo), abs(hi)))
    # "observe" mode: the eager float forward recording every named output,
    # held to the JAX ranges (the JAX observe mode compiles op by op)
    b = NetBuilder(m.weights, QuantScheme.FLOAT32, m.layout, mode="observe")
    m.forward(b, Tensor(torch.from_numpy(x), layout=m.layout))
    assert set(b.rec.ranges) == set(jm.recorder.ranges) - {"input"}
    for k, (lo, hi) in b.rec.ranges.items():
        jlo, jhi = jm.recorder.ranges[k]
        np.testing.assert_allclose((lo, hi), (jlo, jhi), rtol=1e-5,
                                   atol=1e-5 * max(abs(jlo), abs(jhi)))


@pytest.mark.parametrize("scheme", ["BFLOAT16", "FLOAT16"])
def test_mobilenet_v1_bfloat16_matches_jax(zoo, scheme):
    jm, x = zoo("v1")
    s = jm.build_session(JQS[scheme], batch=BATCH)
    want = np.asarray(s.run(jm.prepare_input(x, s)), np.float32)
    m, _ = _port(zoo, "v1")
    got, _ = _run(m, x, scheme)
    assert got.dtype == {"BFLOAT16": torch.bfloat16, "FLOAT16": torch.float16}[scheme]
    assert s.compute_dtype.__name__ == "bfloat16"
    d = np.abs(got.float().numpy() - want).max() / np.abs(want).max()
    assert d <= BF16_TOL, d


@pytest.mark.parametrize("name,jax_pairs,port_pairs", [("v2", 17, 7), ("v3", 7, 1)])
def test_fuse_pass_fuses_only_what_it_computes(zoo, name, jax_pairs, port_pairs):
    # the JAX pass fuses residual and hardswish pairs, and changes the logits
    junf, n0 = zoo.out(name, "INT8_SYM", fused=False)
    jfus, n1 = zoo.out(name, "INT8_SYM", fused=True)
    assert (n0, n1) == (0, jax_pairs)
    assert np.any(jfus != junf)
    # the port fuses the rest only, and its fused logits equal its unfused
    m, x = _port(zoo, name)
    unf, k0 = _run(m, x, "INT8_SYM")
    fus, k1 = _run(m, x, "INT8_SYM", fused=True)
    assert (k0, k1) == (0, port_pairs)
    np.testing.assert_array_equal(fus.numpy(), unf.numpy())
    d = np.abs(unf.numpy().astype(int) - junf.astype(int))
    assert d.max() <= FC_LSB


def test_resnet50_layout_parity():
    """NCHW and NHWC agree (BASELINE config 2), float and int8, seed 5."""
    m1 = ResNet50(input_size=SIZE, layout=Layout.NHWC, seed=5)
    m2 = ResNet50(input_size=SIZE, layout=Layout.NCHW, seed=5)
    x = np.random.default_rng(11).random((1, SIZE, SIZE, 3)).astype(np.float32)
    xc = np.transpose(x, (0, 3, 1, 2))
    o1, o2 = m1.forward_f32(x, device="cpu"), m2.forward_f32(xc, device="cpu")
    np.testing.assert_allclose(o1.numpy(), o2.numpy(), rtol=1e-4, atol=1e-4 * float(o1.abs().max()))
    m1.calibrate(x, device="cpu")
    m2.recorder.ranges = dict(m1.recorder.ranges)
    q1, _ = _run(m1, x, "INT8_SYM", batch=1)
    q2, _ = _run(m2, xc, "INT8_SYM", batch=1)
    np.testing.assert_array_equal(q1.numpy(), q2.numpy())


def test_model_from_numpy_carries_every_class(zoo):
    for name in ("v2", "v3", "r50_nchw"):
        jm, _ = zoo(name)
        m, _ = _port(zoo, name)
        assert m.layout == (Layout.NCHW if name == "r50_nchw" else Layout.NHWC)
        assert set(m.weights) == set(jm.weights) and m.recorder.ranges == jm.recorder.ranges
        with pytest.raises(ValueError, match="weight names"):
            model_from_numpy(MobileNetV2 if name != "v2" else MobileNetV3, jm.weights,
                             jm.recorder.ranges, input_size=SIZE)
