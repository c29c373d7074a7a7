"""The port's model export (runtime/export.py) against the JAX package, on
the CPU: export_json / save_model / load_model, the placed-constants file
of save_model(aot=True), and directories saved by one package loaded by
the other (tests/test_binary_model.py's load_model cases, both ways).

Gates: float graphs within 1e-6 (the JAX test's own); int8 graphs bit for
bit — the reloaded session against the saved one, and a MobileNetV1-32
INT8_SYM directory saved by either package giving the JAX session's int8
logits bit for bit in the other, fused (CSINN2_FUSE_DS=1, 13 ds_block
nodes) and unfused.  Manifests are compared by node order, ops, params and
tensor metadata, never by tensor key (the keys are ids in the saving
process).
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from csinn2_tpu.core.dtypes import QuantScheme as JQS
from csinn2_tpu.models.mobilenet import MobileNetV1 as JMobileNetV1
from csinn2_tpu.runtime import export as jexport
from csinn2_tpu_torch import ops
from csinn2_tpu_torch.core.dtypes import Dtype, QuantScheme, RunMode
from csinn2_tpu_torch.core.quant import observe, quantize
from csinn2_tpu_torch.core.tensor import Tensor, TensorMeta, from_float
from csinn2_tpu_torch.models.common import model_from_numpy
from csinn2_tpu_torch.models.mobilenet import MobileNetV1
from csinn2_tpu_torch.runtime import export as texport
from csinn2_tpu_torch.runtime.session import Session

torch.set_num_threads(2)
REPO = Path(__file__).resolve().parents[1]


def _float_session(rng):
    w1 = rng.standard_normal((8, 4, 3, 3)).astype(np.float32) * 0.3
    w2 = rng.standard_normal((4, 8, 1, 1)).astype(np.float32) * 0.3
    sess = Session(run_mode=RunMode.GRAPH, device="cpu")
    with sess.build():
        x = sess.input(TensorMeta(shape=(1, 4, 8, 8), dtype=Dtype.FLOAT32))
        h = ops.conv2d(x, Tensor(w1), None, ops.Conv2dParams(pad=(1, 1, 1, 1), name="c1"))
        h = ops.relu(h)
        y = ops.conv2d(h, Tensor(w2), None, ops.Conv2dParams(name="c2"))
        sess.set_output(y)
    return sess.setup()


def test_load_model_float_roundtrip(tmp_path, rng):
    sess = _float_session(rng)
    x = rng.standard_normal((1, 4, 8, 8)).astype(np.float32)
    want = sess.run(x).numpy()
    path = texport.save_model(sess, str(tmp_path / "model"))
    sess2 = texport.load_model(path, device="cpu")
    np.testing.assert_allclose(sess2.run(x).numpy(), want, rtol=1e-6, atol=1e-6)
    assert len(sess2.graph.nodes) == len(sess.graph.nodes)
    # the JAX package loads the port's directory too
    np.testing.assert_allclose(np.asarray(jexport.load_model(path).run(x)), want,
                               rtol=1e-6, atol=1e-6)


def test_load_model_placed_constants(tmp_path, rng):
    """aot=True writes placed_consts.pt (not the JAX package's compiled.bin);
    load_model takes the constants from it, not from weights.npz."""
    sess = _float_session(rng)
    x = rng.standard_normal((1, 4, 8, 8)).astype(np.float32)
    want = sess.run(x).numpy()
    path = str(tmp_path / "model_aot")
    texport.save_model(sess, path, aot=True)
    assert os.path.exists(os.path.join(path, texport.PLACED_CONSTS))
    assert not os.path.exists(os.path.join(path, "compiled.bin"))
    consts = texport.load_aot(os.path.join(path, texport.PLACED_CONSTS), device="cpu")
    assert set(consts) == set(sess._consts)
    os.remove(os.path.join(path, "weights.npz"))        # the load must not need it
    got = texport.load_model(path, device="cpu").run(x).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="setup"):
        texport.export_aot(Session(device="cpu"), str(tmp_path / "x.pt"))


def test_load_model_quantized_graph(tmp_path, rng):
    """int8 carriers between nodes, per-channel weight quant: full scale
    arrays, out_qinfo, mem_type survive the manifest."""
    x_np = rng.standard_normal((1, 4, 6, 6)).astype(np.float32)
    w_np = rng.standard_normal((8, 4, 3, 3)).astype(np.float32) * 0.2
    x_qi = observe(x_np, Dtype.INT8, symmetric=True)
    w_t = from_float(w_np, observe(w_np, Dtype.INT8, symmetric=True, axis=0))
    g = ops.conv2d(Tensor(x_np), Tensor(w_np), None, ops.Conv2dParams(pad=(1, 1, 1, 1)))
    out_qi = observe(ops.relu(g).numpy(), Dtype.INT8, symmetric=True)
    sess = Session(run_mode=RunMode.GRAPH, device="cpu")
    with sess.build():
        x = sess.input(TensorMeta(shape=(1, 4, 6, 6), dtype=Dtype.INT8, qinfo=x_qi))
        h = ops.conv2d(x, w_t, None, ops.Conv2dParams(pad=(1, 1, 1, 1)), out_qinfo=out_qi)
        sess.set_output(ops.relu(h, out_qinfo=out_qi))
    sess.setup()
    xq = quantize(x_np, x_qi)
    want = sess.run(xq).numpy()
    path = texport.save_model(sess, str(tmp_path / "qmodel"))
    got = texport.load_model(path, device="cpu").run(xq).numpy()
    assert got.dtype == np.int8
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(np.asarray(jexport.load_model(path).run(xq.numpy())), want)


def test_reloaded_model_saves_again(tmp_path, rng):
    sess = _float_session(rng)
    x = rng.standard_normal((1, 4, 8, 8)).astype(np.float32)
    s2 = texport.load_model(texport.save_model(sess, str(tmp_path / "a")), device="cpu")
    s3 = texport.load_model(texport.save_model(s2, str(tmp_path / "b")), device="cpu")
    np.testing.assert_array_equal(s3.run(x).numpy(), sess.run(x).numpy())


def test_bad_manifest_rejected(tmp_path):
    (tmp_path / "manifest.json").write_text(json.dumps({"format": "other"}))
    with pytest.raises(ValueError, match="csinn2_tpu-graph-v1"):
        texport.load_model(str(tmp_path), device="cpu")


# -- MobileNetV1-32 INT8_SYM across the two packages -------------------------------

@pytest.fixture(scope="module")
def mobilenet():
    """JAX MobileNetV1 (alpha 1.0, 32×32) calibrated on one seeded image;
    for unfused and fused: its session's int8 logits and its saved
    directory.  The port's model carries the same weights and ranges."""
    import tempfile
    m = JMobileNetV1(input_size=32)
    x = np.random.default_rng(0).random(m.input_shape(1)).astype(np.float32)
    m.calibrate(x)
    out, tmp = {}, tempfile.TemporaryDirectory()
    old = os.environ.pop("CSINN2_FUSE_DS", None)
    try:
        for fused in (False, True):
            if fused:
                os.environ["CSINN2_FUSE_DS"] = "1"
            s = m.build_session(JQS.INT8_SYM, batch=1)
            assert sum(n.op == "ds_block" for n in s.graph.nodes) == (13 if fused else 0)
            xq = np.asarray(m.prepare_input(x, s))
            path = os.path.join(tmp.name, f"jax_{fused}")
            jexport.save_model(s, path)
            out[fused] = (xq, np.asarray(s.run(xq)), path, json.loads(s.export_json()))
            os.environ.pop("CSINN2_FUSE_DS", None)
    finally:
        if old is not None:
            os.environ["CSINN2_FUSE_DS"] = old
    yield m, out, tmp.name
    tmp.cleanup()


def _same_manifest(a, b):
    """Two manifests describe one graph: node order, ops, names, params,
    structure, extra and quant info, and every referenced tensor's
    metadata, by position (the keys differ between processes)."""
    assert len(a["nodes"]) == len(b["nodes"])
    assert len(a["inputs"]) == len(b["inputs"]) and len(a["outputs"]) == len(b["outputs"])

    def meta(doc, key):
        d = dict(doc["tensors"][key])
        if d["name"] == key:      # unnamed tensors are named by their key
            d.pop("name")
        return d

    for na, nb in zip(a["nodes"], b["nodes"]):
        for k in ("op", "name", "params", "params_type", "structure", "extra", "out_qinfo"):
            assert na[k] == nb[k], (na["name"], k)
        for ka, kb in zip(na["inputs"] + na["outputs"], nb["inputs"] + nb["outputs"]):
            assert meta(a, ka) == meta(b, kb), (na["name"], ka)


@pytest.mark.parametrize("fused", [False, True])
def test_jax_saved_mobilenet_loads_in_the_port(mobilenet, fused):
    _, out, _ = mobilenet
    xq, want, path, _ = out[fused]
    sess = texport.load_model(path, device="cpu")
    assert sum(n.op == "ds_block" for n in sess.graph.nodes) == (13 if fused else 0)
    got = sess.run(xq).numpy()
    assert got.dtype == np.int8
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("fused", [False, True])
def test_port_saved_mobilenet_loads_in_jax(mobilenet, fused, tmp_path, monkeypatch):
    jm, out, _ = mobilenet
    xq, want, _, jdoc = out[fused]
    monkeypatch.delenv("CSINN2_NO_FUSE_DS", raising=False)
    if fused:
        monkeypatch.setenv("CSINN2_FUSE_DS", "1")
    else:
        monkeypatch.delenv("CSINN2_FUSE_DS", raising=False)
    m = model_from_numpy(MobileNetV1, jm.weights, jm.recorder.ranges, input_size=32)
    sess = m.build_session(QuantScheme.INT8_SYM, batch=1, device="cpu")
    np.testing.assert_array_equal(sess.run(xq).numpy(), want)
    _same_manifest(json.loads(sess.export_json()), jdoc)
    path = texport.save_model(sess, str(tmp_path / "port"))
    monkeypatch.delenv("CSINN2_FUSE_DS", raising=False)   # the load replays ds_block nodes
    js = jexport.load_model(path)
    assert sum(n.op == "ds_block" for n in js.graph.nodes) == (13 if fused else 0)
    np.testing.assert_array_equal(np.asarray(js.run(xq)), want)
    np.testing.assert_array_equal(texport.load_model(path, device="cpu").run(xq).numpy(), want)


def test_examples_on_the_cpu(tmp_path):
    """The two ported user examples, as a user runs them on the CPU."""
    env = {**os.environ, "CSINN2_FUSE_DS": "1", "TMPDIR": str(tmp_path)}
    for args in (("mobilenet_int8", "--size", "32"), ("deploy_save_load", "--aot")):
        r = subprocess.run([sys.executable, "-m", f"csinn2_tpu_torch.examples.{args[0]}",
                            *args[1:], "--device", "cpu"], cwd=REPO, env=env,
                           capture_output=True, text=True, timeout=300)
        assert r.returncode == 0 and r.stdout.strip().splitlines()[-1] == "PASS", \
            (args, r.stdout[-2000:], r.stderr[-2000:])
