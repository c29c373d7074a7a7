"""The port's runtime against the JAX package, on the CPU: HYBRID
partitioning (graph/partition.py), the Session's profiler levels, dump,
layer benchmark, update_const (with the zp weight-sum refresh),
export_json, the Tracer, and the small utils (platform, logging, SaveMode,
the CLI's --backend).

Each case builds the same graph in both packages from the same numpy
inputs.  Tolerances: HYBRID outputs within 1e-6 of the JAX session's (the
JAX test's own); the partition equal subgraph for subgraph; dumps and
integer outputs bit for bit, float ones within 1e-5.
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from csinn2_tpu.core import dtypes as JD
from csinn2_tpu.core.quant import observe as jobserve
from csinn2_tpu.core.tensor import Tensor as JTensor
from csinn2_tpu.core.tensor import TensorMeta as JMeta
from csinn2_tpu.core.tensor import from_float as jfrom_float
from csinn2_tpu.graph.partition import partition as jpartition
from csinn2_tpu.ops import api as jops
from csinn2_tpu.ops import params as JP
from csinn2_tpu.runtime.session import Session as JSession
from csinn2_tpu_torch.core import dtypes as TD
from csinn2_tpu_torch.core.quant import observe as tobserve
from csinn2_tpu_torch.core.tensor import Tensor as TTensor
from csinn2_tpu_torch.core.tensor import TensorMeta as TMeta
from csinn2_tpu_torch.core.tensor import from_float as tfrom_float
from csinn2_tpu_torch.graph.partition import DEFAULT_HOST_OPS, HybridExecutor, partition
from csinn2_tpu_torch.ops import api as tops
from csinn2_tpu_torch.ops import params as TP
from csinn2_tpu_torch.runtime.session import Session as TSession

torch.set_num_threads(2)
REPO = Path(__file__).resolve().parents[1]

# the two packages side by side: (Session, TensorMeta, Dtype, RunMode, ops, params)
JAX = (JSession, JMeta, JD, jops, JP)
PORT = (TSession, TMeta, TD, tops, TP)


def _session(pkg, mode, **kw):
    S, _, D, _, _ = pkg
    if pkg is PORT:
        kw["device"] = "cpu"
    return S(run_mode=getattr(D.RunMode, mode), **kw)


def _host_softmax(pkg, mode):
    """input → mul2 → [host] softmax → add1 → output (tests/test_partition.py)."""
    S, M, D, ops, P = pkg
    sess = _session(pkg, mode, name="hyb")
    with sess.build():
        x = sess.input(M(shape=(1, 8, 16), dtype=D.Dtype.FLOAT32))
        h = ops.mul(x, np.float32(2.0))
        with sess.device_scope("host"):
            h = ops.softmax(h, P.SoftmaxParams(axis=-1))
        y = ops.add(h, np.float32(1.0))
        sess.set_output(y)
    return sess


def _diamond(pkg, mode):
    """x → a(accel) → b(host) ↘ ; a → c(accel) → d(accel, consumes b and c)."""
    S, M, D, ops, P = pkg
    sess = _session(pkg, mode)
    with sess.build():
        x = sess.input(M(shape=(4, 8), dtype=D.Dtype.FLOAT32))
        a = ops.mul(x, np.float32(3.0))
        with sess.device_scope("host"):
            b = ops.sigmoid(a)
        c = ops.relu(a)
        d = ops.add(b, c)
        sess.set_output(d)
    return sess


def _single_device(pkg, mode):
    S, M, D, ops, P = pkg
    sess = _session(pkg, mode)
    with sess.build():
        x = sess.input(M(shape=(4, 4), dtype=D.Dtype.FLOAT32))
        sess.set_output(ops.relu(ops.add(x, np.float32(1.0))))
    return sess


def _default_host_op(pkg, mode):
    """A "shape" node goes to the host without a device_scope."""
    S, M, D, ops, P = pkg
    sess = _session(pkg, mode)
    with sess.build():
        x = sess.input(M(shape=(2, 3), dtype=D.Dtype.FLOAT32))
        y = ops.relu(x)
        sess.set_output(ops.shape(y), ops.sigmoid(y))
    return sess


GRAPHS = {"host_softmax": _host_softmax, "diamond": _diamond,
          "single_device": _single_device, "default_host_op": _default_host_op}


def _summary(subs):
    return [(s.device, [(n.op, n.name) for n in s.nodes], len(s.ext_inputs),
             [tuple(t.shape) for t in s.outputs], len(s.const_keys)) for s in subs]


@pytest.mark.parametrize("name", list(GRAPHS))
def test_partition_equals_jax(name):
    build = GRAPHS[name]
    jsubs = jpartition(build(JAX, "HYBRID").graph)
    tsubs = partition(build(PORT, "HYBRID").graph)
    assert _summary(tsubs) == _summary(jsubs)
    assert [s.device for s in tsubs] == {
        "host_softmax": ["accel", "host", "accel"], "diamond": ["accel", "host", "accel"],
        "single_device": ["accel"], "default_host_op": ["accel", "host"]}[name]
    if name == "host_softmax":
        assert all(len(s.outputs) == 1 for s in tsubs)
    if name == "default_host_op":
        assert "shape" in DEFAULT_HOST_OPS


def test_partition_is_topological():
    subs = partition(_diamond(PORT, "HYBRID").graph)
    sub_of = {id(t): si for si, s in enumerate(subs) for n in s.nodes for t in n.outputs}
    for si, s in enumerate(subs):
        for n in s.nodes:
            assert all(sub_of.get(id(t), -1) <= si for t in n.inputs)


@pytest.mark.parametrize("name", ["host_softmax", "diamond", "default_host_op"])
def test_hybrid_matches_jax_and_graph_mode(name, rng):
    shape = {"host_softmax": (1, 8, 16), "diamond": (4, 8), "default_host_op": (2, 3)}[name]
    x = rng.standard_normal(shape).astype(np.float32)
    jout = GRAPHS[name](JAX, "HYBRID").setup().run(x, unwrap=False)
    hyb = GRAPHS[name](PORT, "HYBRID").setup()
    assert isinstance(hyb._hybrid, HybridExecutor)
    tout = hyb.run(x, unwrap=False)
    gout = GRAPHS[name](PORT, "GRAPH").setup().run(x, unwrap=False)
    for j, t, g in zip(jout, tout, gout):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(t.numpy(), g.numpy(), rtol=1e-6, atol=1e-6)
    if name == "diamond":
        want = 1.0 / (1.0 + np.exp(-3.0 * x)) + np.maximum(3.0 * x, 0.0)
        np.testing.assert_allclose(tout[0].numpy(), want, rtol=1e-5, atol=1e-5)


def test_host_nodes_take_the_cpu_tier_and_place_their_constants():
    """A node under device_scope("host") records the CPU's op tier; each
    subgraph holds its constants on its own device."""
    sess = TSession(run_mode=TD.RunMode.HYBRID, device="cpu")
    w = np.full((4, 4), 2.0, np.float32)
    with sess.build():
        x = sess.input(TMeta(shape=(4, 4), dtype=TD.Dtype.FLOAT32))
        with sess.device_scope("host"):
            assert sess.record_device == torch.device("cpu")
            y = tops.mul(x, TTensor(w))
        sess.set_output(tops.relu(y))
    assert [n.device for n in sess.graph.nodes] == ["host", "accel"]
    sess.setup()
    host = sess._hybrid.subgraphs[0]
    assert host.device == "host" and len(host.consts) == 1
    assert all(v.device.type == "cpu" for v in host.consts.values())


def test_update_const_reaches_hybrid(rng):
    xv = rng.standard_normal((4, 4)).astype(np.float32)
    outs = []
    for pkg in (JAX, PORT):
        S, M, D, ops, P = pkg
        sess = _session(pkg, "HYBRID")
        with sess.build():
            x = sess.input(M(shape=(4, 4), dtype=D.Dtype.FLOAT32))
            with sess.device_scope("host"):
                wt = ops._as_tensor(np.full((4, 4), 2.0, np.float32))
                y = ops.mul(x, wt)
            sess.set_output(ops.relu(y))
        sess.setup()
        first = np.asarray(sess.run(xv))
        sess.update_const(wt, np.full((4, 4), 5.0, np.float32))
        outs.append((first, np.asarray(sess.run(xv))))
    (j1, j2), (t1, t2) = outs
    np.testing.assert_allclose(t1, np.maximum(xv * 2.0, 0), rtol=1e-6)
    np.testing.assert_allclose(t2, np.maximum(xv * 5.0, 0), rtol=1e-6)
    np.testing.assert_allclose(t2, j2, rtol=1e-6, atol=1e-6)


# -- profiler levels (tests/test_profiler_levels.py) ---------------------------

def _prof(pkg, level="UNSET"):
    S, M, D, ops, P = pkg
    sess = _session(pkg, "GRAPH", profiler_level=getattr(D.ProfilerLevel, level), name="prof")
    with sess.build():
        x = sess.input(M(shape=(1, 4, 8, 8), dtype=D.Dtype.FLOAT32, layout=D.Layout.NCHW))
        w = np.random.default_rng(0).standard_normal((8, 4, 3, 3)).astype(np.float32) * 0.2
        y = ops.conv2d(x, w, None, P.Conv2dParams(pad=(1, 1, 1, 1)))
        y = ops.relu(y)
        y = ops.softmax(y, P.SoftmaxParams(axis=1))
        sess.set_output(y)
    return sess.setup()


def test_layer_benchmark_timer(rng):
    sess = _prof(PORT)
    x = rng.standard_normal((1, 4, 8, 8)).astype(np.float32)
    results = sess.run_layer_benchmark(x, iters=2)
    jres = _prof(JAX).run_layer_benchmark(x, iters=2)
    assert list(results) == list(jres) == ["  0 conv2d", "  1 relu", "  2 softmax"]
    assert all(ms >= 0 for ms in results.values())
    assert sess.layer_times == results
    from csinn2_tpu_torch.runtime.profiler import LayerBenchmark
    LayerBenchmark(sess).print_report(results)


@pytest.mark.parametrize("level", ["DUMP", "UNSET"])
def test_dump_outputs_match_jax(tmp_path, rng, level):
    x = rng.standard_normal((1, 4, 8, 8)).astype(np.float32)
    sess = _prof(PORT, level)
    written = sess.dump_outputs(x, out_dir=str(tmp_path / "port"))
    jwritten = _prof(JAX, level).dump_outputs(x, out_dir=str(tmp_path / "jax"))
    assert written == jwritten and len(written) == 3
    for fname, shape in written.items():
        arr = np.load(tmp_path / "port" / fname)
        assert tuple(arr.shape) == shape
        np.testing.assert_allclose(arr, np.load(tmp_path / "jax" / fname), rtol=1e-5, atol=1e-6)
    last = sorted(written)[-1]
    np.testing.assert_allclose(np.load(tmp_path / "port" / last), sess.run(x).numpy(),
                               rtol=0, atol=0)


def test_dump_outputs_writes_bf16_as_f32(tmp_path):
    sess = TSession(device="cpu")
    with sess.build():
        x = sess.input(TMeta(shape=(2, 3), dtype=TD.Dtype.FLOAT32))
        sess.set_output(tops.cast(tops.relu(x), TD.Dtype.BFLOAT16))
    sess.setup()
    xv = np.array([[1.0, -2.0, 3.00390625], [0.1, 0.2, -0.3]], np.float32)
    written = sess.dump_outputs(xv, out_dir=str(tmp_path))
    last = np.load(tmp_path / sorted(written)[-1])
    assert last.dtype == np.float32
    np.testing.assert_array_equal(last, sess.run(xv).float().numpy())


@pytest.mark.parametrize("level", ["TRACE", "ALL"])
def test_trace_level_writes_chrome_json(tmp_path, rng, level):
    sess = _prof(PORT, level)
    assert _prof(JAX, level).trace is not None and sess.trace is not None
    x = rng.standard_normal((1, 4, 8, 8)).astype(np.float32)
    sess.run(x)
    doc = json.load(open(sess.trace.save(str(tmp_path / "trace.json"))))
    assert any(e.get("name") == "session_run" and e["ph"] == "X" for e in doc["traceEvents"])
    assert _prof(PORT, "TIMER").trace is None


def test_tracer_chrome_json(tmp_path):
    from csinn2_tpu_torch.runtime.profiler import Tracer
    tr = Tracer("t")
    with tr.event("session_run", cat="runtime"):
        pass
    tr.instant("marker")
    tr.counter("mem", 123.0)
    doc = json.load(open(tr.save(str(tmp_path / "trace.json"))))
    assert {"X", "i", "C"} <= {e["ph"] for e in doc["traceEvents"]}
    assert doc["otherData"]["session"] == "t"


def test_device_trace_on_the_cpu(tmp_path, rng):
    from csinn2_tpu_torch.runtime.profiler import device_trace, kernel_times
    sess = _prof(PORT)
    with device_trace(str(tmp_path), device="cpu") as path:
        sess.run(rng.standard_normal((1, 4, 8, 8)).astype(np.float32))
    doc = json.load(open(path))
    assert doc["traceEvents"] and kernel_times(path) == {}     # no CUDA activity here
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            with device_trace(str(tmp_path)):
                pass


# -- session (tests/test_session.py) -------------------------------------------

def test_session_update_const(rng):
    x_np = rng.standard_normal((2, 4)).astype(np.float32)
    w = rng.standard_normal((3, 4)).astype(np.float32)
    w2 = rng.standard_normal((3, 4)).astype(np.float32)
    got = []
    for pkg, T in ((JAX, JTensor), (PORT, TTensor)):
        S, M, D, ops, P = pkg
        wt = T(w)
        sess = _session(pkg, "GRAPH")
        with sess.build():
            x = sess.input(M(shape=(2, 4), dtype=D.Dtype.FLOAT32))
            sess.set_output(ops.fullyconnected(x, wt, None, P.FCParams(units=3)))
        sess.setup()
        out1 = np.asarray(sess.run(x_np))
        sess.update_const(wt, w2)
        got.append((out1, np.asarray(sess.run(x_np))))
    (j1, j2), (t1, t2) = got
    np.testing.assert_allclose(t1, x_np @ w.T, atol=1e-5)
    np.testing.assert_allclose(t2, x_np @ w2.T, atol=1e-5)
    np.testing.assert_allclose(t2, j2, rtol=1e-6, atol=1e-6)


def _zp_conv(pkg, x_qi, w_t, out_qi):
    S, M, D, ops, P = pkg
    sess = _session(pkg, "GRAPH")
    bias = np.linspace(-0.5, 0.5, 8).astype(np.float32)
    with sess.build():
        x = sess.input(M(shape=(1, 6, 6, 4), dtype=D.Dtype.INT8, qinfo=x_qi,
                         layout=D.Layout.NHWC))
        sess.set_output(ops.conv2d(x, w_t, bias, P.Conv2dParams(pad=(1, 1, 1, 1),
                                                                layout=D.Layout.NHWC),
                                   out_qinfo=out_qi))
    return sess.setup()


def test_update_const_refreshes_the_zp_weight_sums(rng):
    """An INT8_ASYM conv whose input has a nonzero zero-point carries the
    '__zp_wsum__' const; update_const must refresh it, or the output keeps
    the old weights' sums.  Both packages: updated == built with the new
    weights, bit for bit, and the port equal to the JAX package."""
    from csinn2_tpu.core.quant import quantize as jquantize
    from csinn2_tpu_torch.core.quant import quantize as tquantize
    x_np = (rng.standard_normal((1, 6, 6, 4)) + 1.5).astype(np.float32)
    w_np = rng.standard_normal((8, 4, 3, 3)).astype(np.float32) * 0.2
    w2_np = rng.standard_normal((8, 4, 3, 3)).astype(np.float32) * 0.2 + 0.05
    outs = {}
    for name, pkg, obs, ff in (("jax", JAX, jobserve, jfrom_float),
                               ("port", PORT, tobserve, tfrom_float)):
        D = pkg[2]
        qis = [obs(x_np, D.Dtype.INT8, symmetric=False),
               obs(w_np, D.Dtype.INT8, symmetric=True, axis=0),
               obs(x_np * 4.0, D.Dtype.INT8, symmetric=False)]
        for qi in qis:
            qi.scheme = D.QuantScheme.INT8_ASYM
        x_qi, w_qi, out_qi = qis
        assert int(np.round(float(x_qi.zero_point))) != 0
        w_t, w2_t = ff(w_np, w_qi), ff(w2_np, w_qi)
        sess = _zp_conv(pkg, x_qi, w_t, out_qi)
        assert sess.graph.nodes[0].inputs[-1].meta.name == "__zp_wsum__"
        xq = (np.asarray(jquantize(x_np, x_qi)) if name == "jax"
              else tquantize(x_np, x_qi).numpy())
        before = np.asarray(sess.run(xq))
        sess.update_const(w_t, np.asarray(w2_t.data))
        after = np.asarray(sess.run(xq))
        fresh = np.asarray(_zp_conv(pkg, x_qi, w2_t, out_qi).run(xq))
        np.testing.assert_array_equal(after, fresh)
        assert not np.array_equal(before, after)
        outs[name] = (xq, after)
    np.testing.assert_array_equal(outs["port"][0], outs["jax"][0])
    np.testing.assert_array_equal(outs["port"][1], outs["jax"][1])


def test_session_export_json_matches_jax():
    docs = []
    for pkg in (JAX, PORT):
        S, M, D, ops, P = pkg
        sess = _session(pkg, "GRAPH")
        with sess.build():
            x = sess.input(M(shape=(1, 8), dtype=D.Dtype.FLOAT32))
            h = ops.relu(x)
            sess.set_output(ops.softmax(h, P.SoftmaxParams(axis=-1)))
        sess.setup()
        docs.append(json.loads(sess.export_json()))
    jdoc, tdoc = docs
    assert tdoc["format"] == jdoc["format"] == "csinn2_tpu-graph-v1"
    assert [n["op"] for n in tdoc["nodes"]] == ["relu", "softmax"]
    for jn, tn in zip(jdoc["nodes"], tdoc["nodes"]):
        for k in ("op", "name", "params", "params_type", "structure", "extra", "out_qinfo"):
            assert tn[k] == jn[k], k
    for jk, tk in zip(jdoc["inputs"] + jdoc["outputs"], tdoc["inputs"] + tdoc["outputs"]):
        j, t = dict(jdoc["tensors"][jk]), dict(tdoc["tensors"][tk])
        j.pop("name"), t.pop("name")
        assert t == j


def test_run_benchmark_device_raises_off_the_card(rng):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour of a host without a card")
    for mode in ("GRAPH", "HYBRID"):
        sess = _host_softmax(PORT, mode).setup()
        x = rng.standard_normal((1, 8, 16)).astype(np.float32)
        with pytest.raises(RuntimeError, match="CUDA"):
            sess.run_benchmark_device(x, iters=2, reps=1)
        assert sess.run_benchmark(x, iters=1, warmup=0) > 0


def test_session_has_no_unported_branch():
    src = (REPO / "csinn2_tpu_torch" / "runtime" / "session.py").read_text()
    assert "NotImplementedError" not in src
    for mode in TD.RunMode:
        for level in TD.ProfilerLevel:
            TSession(run_mode=mode, profiler_level=level, device="cpu")


# -- utils, enums and the CLI -------------------------------------------------

def test_save_mode_logging_and_utils_exports(capsys):
    assert [(m.name, m.value) for m in TD.SaveMode] == [(m.name, m.value) for m in JD.SaveMode]
    import csinn2_tpu.utils as ju
    import csinn2_tpu_torch.utils as tu
    names = ("debug", "error", "get_level", "info", "set_level", "warning", "VerifyResult",
             "verify")
    assert all(hasattr(ju, n) and hasattr(tu, n) for n in names)
    old = tu.get_level()
    try:
        tu.set_level(TD.DebugLevel.WARNING)
        tu.info("hidden %d", 1)
        tu.warning("careful %d", 2)
        tu.error("broken %s", "x")
    finally:
        tu.set_level(old)
    err = capsys.readouterr().err
    assert "WARN: careful 2" in err and "ERROR: broken x" in err and "hidden" not in err


def test_backend_summary_and_cli():
    from csinn2_tpu_torch.utils.platform import backend_summary
    assert backend_summary("cpu") == f"cpu (torch {torch.__version__})"
    r = subprocess.run([sys.executable, "-m", "csinn2_tpu_torch", "--backend", "--device", "cpu"],
                       cwd=REPO, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and r.stdout.strip() == backend_summary("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            backend_summary()
