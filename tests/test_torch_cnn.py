"""The PyTorch port's CNN path (core quant, op API, graph, Session,
NetBuilder, MobileNetV1) against the JAX package, on the CPU.

A small MobileNetV1 (alpha 0.25, 32×32, batch 2) is calibrated in JAX and
carried across with `model_from_numpy` (same weights, same ranges), then run
as an INT8_SYM session in both packages, fused (CSINN2_FUSE_DS=1, 13
ds_block nodes) and unfused.  Gates: the port's int8 logits equal the JAX
session's, except at most 1 LSB where the fc's float-carrier sum (f64
rounded once in the port, f32 in XLA's order) rounds the other way — the
one stated tolerance;
the port's fused and unfused sessions are equal with no tolerance;
forward_f32 and calibrate agree with JAX's to rtol 1e-5 (with an absolute
floor of 1e-5·max|y| for values that cancel to near zero).
"""

import numpy as np
import pytest
import torch

from csinn2_tpu.core import quant as jq
from csinn2_tpu.core.dtypes import Dtype as JDtype
from csinn2_tpu.core.dtypes import QuantScheme as JQS
from csinn2_tpu.models.mobilenet import MobileNetV1 as JMobileNetV1
from csinn2_tpu_torch import ops
from csinn2_tpu_torch.core import quant as tq
from csinn2_tpu_torch.core.dtypes import Dtype, Layout, ProfilerLevel, QuantScheme, RunMode
from csinn2_tpu_torch.core.tensor import Tensor, TensorMeta
from csinn2_tpu_torch.graph.ir import Graph, Node
from csinn2_tpu_torch.models.common import NetBuilder, model_from_numpy
from csinn2_tpu_torch.models.mobilenet import MobileNetV1
from csinn2_tpu_torch.runtime.session import Session

torch.set_num_threads(2)

FC_LSB = 1      # stated tolerance of the float-carrier fc's int8 output


@pytest.fixture(scope="module")
def jax_model():
    """JAX MobileNetV1 (alpha 0.25, 32×32) calibrated on a seeded batch of 2,
    with its unfused and fused INT8_SYM outputs."""
    import os
    m = JMobileNetV1(alpha=0.25, input_size=32)
    x = np.random.default_rng(1).random(m.input_shape(2)).astype(np.float32)
    m.calibrate(x)
    outs = {}
    old = os.environ.pop("CSINN2_FUSE_DS", None)
    try:
        for fused in (False, True):
            if fused:
                os.environ["CSINN2_FUSE_DS"] = "1"
            s = m.build_session(JQS.INT8_SYM, batch=2)
            assert sum(n.op == "ds_block" for n in s.graph.nodes) == (13 if fused else 0)
            outs[fused] = np.asarray(s.run(m.prepare_input(x, s)))
            os.environ.pop("CSINN2_FUSE_DS", None)
    finally:
        if old is not None:
            os.environ["CSINN2_FUSE_DS"] = old
    return m, x, outs


def _port(jm):
    return model_from_numpy(MobileNetV1, jm.weights, jm.recorder.ranges,
                            alpha=0.25, input_size=32)


@pytest.mark.parametrize("fused", [False, True])
def test_int8_session_matches_jax(jax_model, fused, monkeypatch):
    jm, x, jouts = jax_model
    np.testing.assert_array_equal(jouts[True], jouts[False])     # the JAX package's own gate
    monkeypatch.delenv("CSINN2_NO_FUSE_DS", raising=False)
    if fused:
        monkeypatch.setenv("CSINN2_FUSE_DS", "1")
    else:
        monkeypatch.delenv("CSINN2_FUSE_DS", raising=False)
    m = _port(jm)
    s = m.build_session(QuantScheme.INT8_SYM, batch=2, device="cpu")
    assert sum(n.op == "ds_block" for n in s.graph.nodes) == (13 if fused else 0)
    out = s.run(m.prepare_input(x, s))
    assert out.dtype == torch.int8 and tuple(out.shape) == (2, 1000)
    d = np.abs(out.numpy().astype(int) - jouts[fused].astype(int))
    assert d.max() <= FC_LSB, (d.max(), int((d > 0).sum()))


def test_port_fused_equals_unfused(jax_model, monkeypatch):
    jm, x, _ = jax_model
    monkeypatch.delenv("CSINN2_NO_FUSE_DS", raising=False)
    outs = []
    for fused in (False, True):
        if fused:
            monkeypatch.setenv("CSINN2_FUSE_DS", "1")
        m = _port(jm)
        s = m.build_session(QuantScheme.INT8_SYM, batch=2, device="cpu")
        outs.append(s.run(m.prepare_input(x, s)).numpy())
    np.testing.assert_array_equal(outs[1], outs[0])


def test_forward_f32_and_calibrate_match_jax(jax_model):
    jm, x, _ = jax_model
    want = jm.forward_f32(x)
    m = _port(jm)
    got = m.forward_f32(x, device="cpu").numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
    m2 = MobileNetV1(alpha=0.25, input_size=32)            # same seed → same weights
    assert all(np.array_equal(m2.weights[k], jm.weights[k]) for k in jm.weights)
    m2.calibrate(x, device="cpu")
    assert set(m2.recorder.ranges) == set(jm.recorder.ranges)
    for k, (lo, hi) in jm.recorder.ranges.items():
        np.testing.assert_allclose(m2.recorder.ranges[k], (lo, hi), rtol=1e-5,
                                   atol=1e-5 * max(abs(lo), abs(hi)))


def test_quant_core_matches_jax():
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((4, 64)) * 3).astype(np.float32)
    for sym in (True, False):
        jqi = jq.observe(x, JDtype.INT8, symmetric=sym)
        tqi = tq.observe(x, Dtype.INT8, symmetric=sym)
        assert (jqi.scale, jqi.zero_point) == (tqi.scale, tqi.zero_point)
        np.testing.assert_array_equal(tq.quantize(x, tqi).numpy(), np.asarray(jq.quantize(x, jqi)))
        np.testing.assert_array_equal(
            tq.quantize(x, tqi, by_reciprocal=True).numpy(),
            np.asarray(jax_jit_quantize(x, jqi)))
        q = np.asarray(jq.quantize(x, jqi))
        np.testing.assert_array_equal(tq.dequantize(q, tqi).numpy(),
                                      np.asarray(jq.dequantize(q, jqi)))
    w = rng.standard_normal((16, 3, 3, 3)).astype(np.float32)
    jqi = jq.observe(w, JDtype.INT8, symmetric=True, axis=0)
    tqi = tq.observe(w, Dtype.INT8, symmetric=True, axis=0)
    np.testing.assert_array_equal(tqi.scale, jqi.scale)
    np.testing.assert_array_equal(tq.quantize(w, tqi).numpy(), np.asarray(jq.quantize(w, jqi)))


def jax_jit_quantize(x, qi):
    """JAX quantize inside a compiled graph (a Session's requantize)."""
    import jax
    return jax.jit(lambda a: jq.quantize(a, qi))(x)


def test_entry_points_take_the_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour of a host without a card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Session()
    m = MobileNetV1(alpha=0.25, input_size=32)
    x = np.zeros(m.input_shape(1), np.float32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        m.forward_f32(x)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        m.calibrate(x)
    m.calibrate(x, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        m.build_session(QuantScheme.INT8_SYM)
    s = m.build_session(QuantScheme.INT8_SYM, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        s.run_benchmark_device(m.prepare_input(x, s))
    assert s.run_benchmark(m.prepare_input(x, s), iters=1, warmup=0) > 0


def test_session_records_shapes_and_checks_order():
    rng = np.random.default_rng(0)
    sess = Session(device="cpu")
    with sess.build():
        x = sess.input(TensorMeta((2, 9, 7, 3), Dtype.FLOAT32, Layout.NHWC, name="input"))
        w = Tensor(rng.standard_normal((8, 3, 3, 3)).astype(np.float32))
        y = ops.conv2d(x, w, None, ops.Conv2dParams(stride=(2, 2), pad=(0, 1, 0, 1),
                                                    layout=Layout.NHWC, fuse_relu=True))
        p = ops.global_avgpool2d(y, ops.PoolParams(layout=Layout.NHWC))
        z = ops.softmax(ops.flatten(p))
        sess.set_output(y, z)
    assert y.shape == (2, 4, 3, 8) and p.shape == (2, 1, 1, 8) and z.shape == (2, 8)
    assert [n.op for n in sess.graph.nodes] == ["conv2d", "global_avgpool2d", "flatten",
                                                "softmax"]
    sess.setup()
    xd = rng.standard_normal((2, 9, 7, 3)).astype(np.float32)
    yo, zo = sess.run(xd)
    want = torch.relu(torch.nn.functional.conv2d(
        torch.nn.functional.pad(torch.from_numpy(xd).permute(0, 3, 1, 2), (0, 1, 0, 1)),
        w.data, stride=2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(yo.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(zo.sum(-1).numpy(), 1.0, rtol=1e-6)

    g = Graph()
    a = Tensor(meta=TensorMeta((1,)))
    b = Tensor(meta=TensorMeta((1,)))
    g.nodes = [Node("relu", [b], None, lambda arr: arr[0], outputs=[a]),
               Node("relu", [a], None, lambda arr: arr[0], outputs=[b])]
    with pytest.raises(ValueError, match="topologically"):
        g.topo_check()


def test_layer_mode_and_unported_branches_raise():
    """Layer mode runs the builder eagerly; no branch is left unported:
    HYBRID sessions and the profiler levels construct (TRACE with its
    Tracer), and the u8 schemes, "observe" mode and conv2d(residual=) run."""
    rng = np.random.default_rng(0)
    b = NetBuilder({"c.w": rng.standard_normal((4, 3, 3, 3)).astype(np.float32)},
                   QuantScheme.FLOAT32, Layout.NHWC, mode="float")
    x = Tensor(torch.from_numpy(rng.random((1, 6, 6, 3)).astype(np.float32)),
               layout=Layout.NHWC)
    y = b.conv(x, "c", stride=1, relu6=True)
    assert y.data.shape == (1, 6, 6, 4) and float(y.data.max()) <= 6.0
    assert Session(run_mode=RunMode.HYBRID, device="cpu").recording
    assert Session(profiler_level=ProfilerLevel.TRACE, device="cpu").trace is not None
    assert NetBuilder({}, QuantScheme.UINT8_ASYM).scheme == QuantScheme.UINT8_ASYM
    ob = NetBuilder(b.w, QuantScheme.FLOAT32, Layout.NHWC, mode="observe")
    yo = ob.conv(x, "c", stride=1, relu6=True)
    assert ob.rec.ranges["c"] == (float(yo.data.min()), float(yo.data.max()))
    w = Tensor(torch.from_numpy(rng.standard_normal((4, 4, 1, 1)).astype(np.float32)))
    r = ops.conv2d(y, w, None, ops.Conv2dParams(layout=Layout.NHWC), residual=y)
    plain = ops.conv2d(y, w, None, ops.Conv2dParams(layout=Layout.NHWC))
    torch.testing.assert_close(r.data, plain.data + y.data, rtol=1e-6, atol=1e-6)
