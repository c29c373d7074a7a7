"""The port's static roofline model (runtime/roofline.py) on the CPU: per
node FLOPs and bytes equal to the JAX package's analyze() on the same
graph (they do not depend on the chip), hand-computed conv counts
(tests/test_roofline.py), and the H100 constants' verdicts on MobileNetV1
INT8 at 224, batch 128."""

import numpy as np
import pytest
import torch

from csinn2_tpu.core.dtypes import Dtype as JDtype
from csinn2_tpu.core.dtypes import Layout as JLayout
from csinn2_tpu.core.dtypes import QuantScheme as JQS
from csinn2_tpu.core.dtypes import RunMode as JRunMode
from csinn2_tpu.core.tensor import TensorMeta as JMeta
from csinn2_tpu.models.mobilenet import MobileNetV1 as JMobileNetV1
from csinn2_tpu.ops import api as jops
from csinn2_tpu.ops import params as JP
from csinn2_tpu.runtime.roofline import analyze as janalyze
from csinn2_tpu.runtime.session import Session as JSession
from csinn2_tpu_torch.core.dtypes import Dtype, Layout, QuantScheme, RunMode
from csinn2_tpu_torch.core.tensor import TensorMeta
from csinn2_tpu_torch.models.common import model_from_numpy
from csinn2_tpu_torch.models.mobilenet import MobileNetV1
from csinn2_tpu_torch.ops import api as ops
from csinn2_tpu_torch.ops import params as P
from csinn2_tpu_torch.runtime import roofline as R
from csinn2_tpu_torch.runtime.roofline import analyze
from csinn2_tpu_torch.runtime.session import Session

torch.set_num_threads(2)

FIELDS = ("name", "op", "flops", "act_bytes", "w_bytes", "fusable", "extra_read", "vpu_ops")


def _conv_session(batch=4, cin=16, cout=32, hw=28, k=3, jax=False):
    S, M, D, L, RM, o, Pm = ((JSession, JMeta, JDtype, JLayout, JRunMode, jops, JP) if jax
                             else (Session, TensorMeta, Dtype, Layout, RunMode, ops, P))
    sess = S(run_mode=RM.GRAPH, name="roofline", **({} if jax else {"device": "cpu"}))
    with sess.build():
        x = sess.input(M(shape=(batch, cin, hw, hw), dtype=D.FLOAT32, layout=L.NCHW))
        w = np.zeros((cout, cin, k, k), np.float32)
        y = o.conv2d(x, w, None, Pm.Conv2dParams(pad=(1, 1, 1, 1)))
        sess.set_output(o.softmax(o.relu(y), Pm.SoftmaxParams(axis=1)))
    return sess.setup()


def _counts(report):
    return [tuple(getattr(c, f) for f in FIELDS) for c in report.costs]


def test_conv_flops_and_bytes():
    batch, cin, cout, hw, k = 4, 16, 32, 28, 3
    r = analyze(_conv_session(batch, cin, cout, hw, k))
    c = [c for c in r.costs if c.op == "conv2d"][0]
    assert c.flops == 2 * batch * hw * hw * cout * cin * k * k
    assert c.act_bytes == 4 * (batch * cin * hw * hw + batch * cout * hw * hw)
    assert c.w_bytes == 4 * cout * cin * k * k
    assert c.bytes == c.act_bytes + c.w_bytes
    assert _counts(r) == _counts(janalyze(_conv_session(batch, cin, cout, hw, k, jax=True)))
    assert r.peak_tops == R.F32_TFLOPS and r.hbm_gbps == R.HBM_GBPS == 3350.0


def test_bound_classification():
    # deep channels at high batch → the matrix units; thin channels → HBM
    r_mat = analyze(_conv_session(batch=128, cin=512, cout=512, hw=7, k=3))
    r_hbm = analyze(_conv_session(batch=1, cin=8, cout=8, hw=224, k=3))
    c_mat = [c for c in r_mat.costs if c.op == "conv2d"][0]
    c_hbm = [c for c in r_hbm.costs if c.op == "conv2d"][0]
    assert c_mat.bound(r_mat.peak_tops, r_mat.hbm_gbps) == "tensor"
    assert c_hbm.bound(r_hbm.peak_tops, r_hbm.hbm_gbps) == "hbm"
    assert "conv2d" in r_mat.table(top=2)


@pytest.mark.parametrize("fused", [False, True])
def test_mobilenet_counts_equal_jax(fused, monkeypatch):
    """Per node, the same FLOPs, bytes, fusability, residual read and
    depthwise ops as the JAX package's analyze() (MobileNetV1-32 INT8_SYM)."""
    monkeypatch.delenv("CSINN2_NO_FUSE_DS", raising=False)
    if fused:
        monkeypatch.setenv("CSINN2_FUSE_DS", "1")
    else:
        monkeypatch.delenv("CSINN2_FUSE_DS", raising=False)
    jm = JMobileNetV1(alpha=0.5, input_size=32)
    x = np.random.default_rng(0).random(jm.input_shape(1)).astype(np.float32)
    jm.calibrate(x)
    jr = janalyze(jm.build_session(JQS.INT8_SYM, batch=2))
    m = model_from_numpy(MobileNetV1, jm.weights, jm.recorder.ranges, alpha=0.5,
                         input_size=32)
    sess = m.build_session(QuantScheme.INT8_SYM, batch=2, device="cpu")
    r = analyze(sess)
    assert [c[:-1] for c in _counts(r)] == [c[:-1] for c in _counts(jr)]
    # vpu_ops too, but a ds_block's: the port counts only its depthwise half
    # off the tensor cores (the JAX package, the whole block)
    for node, c, jc in zip(sess.graph.nodes, r.costs, jr.costs):
        if c.op != "ds_block":
            assert c.vpu_ops == jc.vpu_ops
            continue
        n, ho, wo, _ = node.outputs[0].shape
        ch, _, k, _ = node.inputs[1].shape
        assert jc.vpu_ops == c.flops > c.vpu_ops == 2 * n * ho * wo * ch * k * k
    assert sum(c.op == "ds_block" for c in r.costs) == (13 if fused else 0)
    assert r.total_flops == jr.total_flops
    assert r.peak_tops == R.INT8_TOPS == 1979.0


@pytest.mark.parametrize("fused", [False, True])
def test_mobilenet_v1_int8_224_on_the_h100(fused, monkeypatch):
    """At batch 128, against the H100's rates (ridge 590 int8 ops and 20
    f32 CUDA-core ops a byte): every depthwise conv (the fused blocks'
    depthwise halves too) and every pointwise conv but the 1024-channel ones
    at 7×7 (pw11, pw12; fused, only the stride-1 block 12, since block 11
    also reads its 14×14 input) is HBM-bound; the total is the bytes over 3.35 TB/s, and the
    unfused (eager replay) floor is at least the fused one.  The fused
    blocks' graph moves fewer bytes (no depthwise output round trip)."""
    monkeypatch.delenv("CSINN2_NO_FUSE_DS", raising=False)
    monkeypatch.delenv("CSINN2_FUSE_DS", raising=False)
    m = MobileNetV1(input_size=224)
    x = np.random.default_rng(0).random(m.input_shape(1)).astype(np.float32)
    m.calibrate(x, device="cpu")
    r_unfused = analyze(m.build_session(QuantScheme.INT8_SYM, batch=128, device="cpu"))
    if fused:
        monkeypatch.setenv("CSINN2_FUSE_DS", "1")
    r = analyze(m.build_session(QuantScheme.INT8_SYM, batch=128, device="cpu"))
    convs = [c for c in r.costs if c.op in ("conv2d", "ds_block")]
    assert len(convs) == (14 if fused else 27)
    assert sum(bool(c.vpu_ops) for c in convs) == 13
    bounds = {c.name: c.bound(r.peak_tops, r.hbm_gbps) for c in convs}
    assert [n for n, b in bounds.items() if b != "hbm"] == (
        ["dw12+pw12"] if fused else ["pw11", "pw12"])
    mat = [c for c in r.costs if not c.fusable]
    t_hbm = (sum(c.bytes for c in mat) + sum(c.extra_read for c in r.costs if c.fusable)) \
        / (r.hbm_gbps * 1e9)
    assert r.fused_sol_s == pytest.approx(t_hbm, rel=1e-12)
    assert r.unfused_sol_s >= r.fused_sol_s
    assert 1e-4 < r.fused_sol_s < 2e-3
    assert r.total_flops == r_unfused.total_flops
    # at the floor the int8 tensor cores would be 23 % (unfused) / 30 %
    # (fused) busy: the net is bandwidth-bound on the H100
    assert r.total_flops / r.fused_sol_s / (r.peak_tops * 1e12) < 0.35
    if fused:
        assert r.fused_sol_s < r_unfused.fused_sol_s
