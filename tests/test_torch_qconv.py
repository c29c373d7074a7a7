"""The PyTorch port's CNN op layer (kernels/qconv.py and the op API's conv,
fc, pool, activation and elementwise ops) against the JAX package, on the
CPU.

The JAX side runs inside jax.jit with the activations and biases as
arguments, as a Session's compiled graph runs them (weights as constants, as
the op API folds their zero-point sums at build).  Gates:
  * every branch of `_conv2d_quant` / `_fc_quant` taken directly (u8×u8
    with a nonzero weight zero-point, the u8 edge, the zp-padded integer
    path, int16, the float-carrier fallback, the fused residual, hardswish
    and the folded asymmetric-output epilogue) equals JAX's bit for bit;
  * a K = 4608 int8 conv at full-scale values, whose sums pass 2^24 and so
    are not exact in f32, equals JAX's bit for bit;
  * `precompute_zp_wsum` equals JAX's;
  * the dtype matrix of tests/test_dtype_matrix.py (conv2d, depthwise,
    fullyconnected, pooling, activations, eltwise, in every scheme it
    runs) through the op API in layer mode: integer outputs within
    GENERIC_LSB = 1 of JAX's — these ops take the generic dequant→f32→
    requant path, whose f32 sums and transcendentals (oneDNN and libm
    against XLA) can round the other way — and float outputs within one
    unit in the last place of the output dtype of max|y|.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from csinn2_tpu import ops as jops
from csinn2_tpu.core.dtypes import Api as JApi
from csinn2_tpu.core.dtypes import Dtype as JDtype
from csinn2_tpu.core.dtypes import Layout as JLayout
from csinn2_tpu.core.dtypes import QuantScheme as JQS
from csinn2_tpu.core.quant import QuantInfo as JQI
from csinn2_tpu.core.quant import observe as jobserve
from csinn2_tpu.core.tensor import Tensor as JTensor
from csinn2_tpu.core.tensor import TensorMeta as JMeta
from csinn2_tpu.core.tensor import from_float as jfrom_float
from csinn2_tpu.kernels import qconv as jqc
from csinn2_tpu_torch import ops
from csinn2_tpu_torch.core.dtypes import Dtype, Layout, QuantScheme
from csinn2_tpu_torch.core.quant import QuantInfo, observe
from csinn2_tpu_torch.core.tensor import Tensor, TensorMeta, from_float
from csinn2_tpu_torch.kernels import qconv as tqc
from csinn2_tpu_torch.ops.params import Conv2dParams, FCParams
from csinn2_tpu.ops.params import Conv2dParams as JConv
from csinn2_tpu.ops.params import FCParams as JFC

torch.set_num_threads(2)

GENERIC_LSB = 1    # stated tolerance of the generic path's integer outputs
T = torch.from_numpy


def _qi(scale, zp, dt, scheme, axis=None):
    """The same QuantInfo in both packages."""
    return (JQI(scale=scale, zero_point=zp, dtype=JDtype[dt], axis=axis, scheme=JQS[scheme]),
            QuantInfo(scale=scale, zero_point=zp, dtype=Dtype[dt], axis=axis,
                      scheme=QuantScheme[scheme]))


def _metas(arr, qis):
    j, t = (None, None) if qis is None else qis
    dt = str(arr.dtype)
    return (JMeta(shape=arr.shape, dtype=JDtype(dt), qinfo=j),
            TensorMeta(shape=arr.shape, dtype=Dtype(dt), qinfo=t))


def _conv_both(x, xq, w, wq, b, params, out, rq=None, r=None, w_layout="OIHW",
               op="conv"):
    """One `_conv2d_quant` (or `_depthwise_quant`) call in both packages: x,
    the bias and the residual are jit arguments."""
    jp = JConv(**{**params.__dict__, "layout": JLayout[params.layout.name], "api": JApi.AUTO})
    arrays = [x, w, b] + ([r] if r is not None else [])
    metas = [_metas(x, xq), _metas(w, wq), _metas(b, None)] + \
        ([_metas(r, rq)] if r is not None else [])
    jfn = jqc._conv2d_quant if op == "conv" else jqc._depthwise_quant
    tfn = tqc._conv2d_quant if op == "conv" else tqc._depthwise_quant
    jl, tl = JLayout[w_layout], Layout[w_layout]

    def jrun(xa, ba, *ra):
        return jfn([xa, jnp.asarray(w), ba, *ra], [m[0] for m in metas], jp,
                   out[0] if out else None, w_layout=jl)
    want = np.asarray(jax.jit(jrun)(x, b, *([r] if r is not None else [])))
    got = tfn([T(a) for a in arrays], [m[1] for m in metas], params,
              out[1] if out else None, w_layout=tl).numpy()
    return got, want


def _rand_q(rng, shape, dt):
    """Random carriers; int16 within ±4096, so that JAX's int32 sums do not
    wrap and its f32 float-carrier sums stay exact at these K."""
    lo, hi = {"int8": (-128, 128), "uint8": (0, 256), "int16": (-4096, 4096)}[dt]
    return rng.integers(lo, hi, shape).astype(dt)


# -- every branch of _conv2d_quant / _fc_quant, bit for bit ---------------------

BRANCHES = {
    # name: (x dtype, x zp, w dtype, w zp (per channel when a list), out zp, flags)
    "s8_sym": ("int8", 0, "int8", 0, 0, {}),
    "s8_zp_padded": ("int8", -37, "int8", 0, 0, {}),
    "u8_edge": ("uint8", 101, "int8", 0, 0, {}),
    "u8xu8_wzp": ("uint8", 117, "uint8", [120, 131, 128, 97, 140, 128, 110, 150], 0, {}),
    "u8xu8_wzp_folded": ("uint8", 90, "uint8", 133, 19, {"fuse_relu6": True}),
    "s16": ("int16", 0, "int16", 0, 0, {}),
    "float_carrier": ("int8", 5, "int16", 0, 0, {}),
    "residual": ("int8", 0, "int8", 0, 0, {"fuse_add": True, "fuse_relu": True}),
    "residual_folded": ("int8", -20, "int8", 0, 11, {"fuse_add": True, "fuse_relu": True}),
    "hswish": ("int8", 0, "int8", 0, 0, {"fuse_hswish": True}),
    "hswish_asym_out": ("int8", 7, "int8", 0, -9, {"fuse_hswish": True}),
}


# every branch in NHWC (the models' layout), three of them in NCHW too
LAYOUT_CASES = [(n, "NHWC") for n in BRANCHES] + \
    [(n, "NCHW") for n in ("s8_zp_padded", "u8xu8_wzp", "residual_folded")]


@pytest.mark.parametrize("name,layout", LAYOUT_CASES, ids=[f"{n}-{l}" for n, l in LAYOUT_CASES])
def test_conv_branch_matches_jax(name, layout):
    xdt, zx, wdt, zw, zo, flags = BRANCHES[name]
    rng = np.random.default_rng(list(BRANCHES).index(name))
    N, H, W, C, O = 2, 7, 6, 5, 8
    xs = (N, H, W, C) if layout == "NHWC" else (N, C, H, W)
    x = _rand_q(rng, xs, xdt)
    w = _rand_q(rng, (O, C, 3, 3), wdt)
    b = rng.normal(size=(O,)).astype(np.float32)
    scheme = "UINT8_ASYM" if "uint8" in (xdt, wdt) else \
        ("INT16_SYM" if xdt == wdt == "int16" else "INT8_ASYM")
    xq = _qi(0.031, zx, xdt.upper(), scheme)
    per = isinstance(zw, list)
    sw = rng.uniform(0.001, 0.01, O).astype(np.float32) if per or wdt != "uint8" else 0.004
    wq = _qi(sw, np.asarray(zw, np.int32) if per else zw, wdt.upper(), scheme,
             axis=0 if np.ndim(sw) else None)
    out = _qi(0.05, zo, "INT8", scheme)
    params = Conv2dParams(stride=(2, 1), pad=(1, 1, 0, 2), layout=Layout[layout], **flags)
    r = rq = None
    if flags.get("fuse_add"):
        os_ = (N, 4, 6, O) if layout == "NHWC" else (N, O, 4, 6)
        r = _rand_q(rng, os_, "int8")
        rq = _qi(0.04, 3, "INT8", scheme)
    got, want = _conv_both(x, xq, w, wq, b, params, out, rq, r)
    assert got.dtype == want.dtype == np.int8
    np.testing.assert_array_equal(got, want)
    # and the float output (no out qinfo): the f32 epilogue bit for bit
    got, want = _conv_both(x, xq, w, wq, b, params, None, rq, r)
    np.testing.assert_array_equal(got, want)


def test_depthwise_u8_window_sums_and_group_conv_match_jax():
    rng = np.random.default_rng(3)
    x = _rand_q(rng, (2, 9, 9, 6), "uint8")
    w = _rand_q(rng, (6, 1, 3, 3), "uint8")
    b = rng.normal(size=(6,)).astype(np.float32)
    xq = _qi(0.02, 140, "UINT8", "UINT8_ASYM")
    wq = _qi(np.full(6, 0.01, np.float32), np.array([100, 128, 150, 90, 128, 170], np.int32),
             "UINT8", "UINT8_ASYM", axis=0)
    out = _qi(0.03, 21, "INT8", "UINT8_ASYM")
    p = Conv2dParams(stride=(2, 2), pad=(1, 1, 1, 1), layout=Layout.NHWC, fuse_relu=True)
    got, want = _conv_both(x, xq, w, wq, b, p, out, op="dw")
    np.testing.assert_array_equal(got, want)
    # grouped (2 groups), OHWI weights
    w2 = _rand_q(rng, (4, 3, 3, 3), "int8")
    p2 = Conv2dParams(group=2, pad=(1, 1, 1, 1), layout=Layout.NHWC)
    got, want = _conv_both(x, xq, w2, _qi(0.01, 0, "INT8", "UINT8_ASYM"),
                           b[:4], p2, out, w_layout="OHWI")
    np.testing.assert_array_equal(got, want)


def test_k4608_conv_past_2_24_matches_jax():
    """512 channels × 3×3 at full scale: |acc| passes 2^24, so an f32 sum
    would round; the port's f64 route is exact, as JAX's int32 is."""
    rng = np.random.default_rng(4)
    C, O = 512, 8
    x = (-128 + rng.integers(0, 4, (1, 5, 5, C))).astype(np.int8)
    w = (-128 + rng.integers(0, 4, (O, C, 3, 3))).astype(np.int8)
    w[1::2] = -w[1::2] - 1                                   # both signs of acc
    b = rng.normal(size=(O,)).astype(np.float32)
    exact = torch.nn.functional.conv2d(T(x).permute(0, 3, 1, 2).double(), T(w).double(),
                                       padding=1)
    assert float(exact.abs().max()) > 2 ** 24
    assert tqc.exact_dtype(C * 9, 128 * 128) == torch.float64
    f32 = torch.nn.functional.conv2d(T(x).permute(0, 3, 1, 2).float(), T(w).float(), padding=1)
    assert not torch.equal(f32.double(), exact)              # f32 would not do
    xq = _qi(0.02, 0, "INT8", "INT8_SYM")
    wq = _qi(np.full(O, 1e-4, np.float32), 0, "INT8", "INT8_SYM", axis=0)
    p = Conv2dParams(pad=(1, 1, 1, 1), layout=Layout.NHWC)
    for out in (None, _qi(0.3, 0, "INT8", "INT8_SYM")):
        got, want = _conv_both(x, xq, w, wq, b, p, out)
        np.testing.assert_array_equal(got, want)
    # K = 2048 through the 1×1 matmul route (ResNet-50's widest 1×1)
    x1 = (-128 + rng.integers(0, 4, (1, 3, 3, 2048))).astype(np.int8)
    w1 = (-128 + rng.integers(0, 4, (O, 2048, 1, 1))).astype(np.int8)
    got, want = _conv_both(x1, xq, w1, wq, b, Conv2dParams(layout=Layout.NHWC), None)
    np.testing.assert_array_equal(got, want)


FC = {
    "s8": ("int8", 0, "int8", 0), "s8_zp": ("int8", -12, "int8", 0),
    "u8_edge": ("uint8", 140, "int8", 0), "u8xu8_wzp": ("uint8", 99, "uint8", 117),
    "s16": ("int16", 0, "int16", 0), "float_x": ("float32", None, "int8", 0),
    "mixed": ("int16", 3, "int8", 0),
}


@pytest.mark.parametrize("name", list(FC))
def test_fc_branch_matches_jax(name):
    xdt, zx, wdt, zw = FC[name]
    rng = np.random.default_rng(7)
    K, U = 96, 16
    x = rng.random((3, K)).astype(np.float32) * 4 if xdt == "float32" else \
        _rand_q(rng, (3, K), xdt)
    w = _rand_q(rng, (U, K), wdt)
    b = rng.normal(size=(U,)).astype(np.float32)
    scheme = "UINT8_ASYM" if "uint8" in (xdt, wdt) else "INT8_ASYM"
    xq = None if zx is None else _qi(0.03, zx, xdt.upper(), scheme)
    wq = _qi(np.full(U, 0.004, np.float32) if wdt != "uint8" else 0.004, zw, wdt.upper(),
             scheme, axis=0 if wdt != "uint8" else None)
    jm = [_metas(x, xq)[0], _metas(w, wq)[0], JMeta((U,))]
    tm = [_metas(x, xq)[1], _metas(w, wq)[1], TensorMeta((U,))]
    for out in (_qi(0.2, 4, "INT8", scheme), None):
        want = np.asarray(jax.jit(lambda xa, ba: jqc._fc_quant(
            [xa, jnp.asarray(w), ba], jm, JFC(units=U), out[0] if out else None))(x, b))
        got = tqc._fc_quant([T(x), T(w), T(b)], tm, FCParams(units=U),
                            out[1] if out else None).numpy()
        if name == "float_x":
            # the float carrier's f32 sums run in another order than XLA's
            assert np.abs(got.astype(np.float64) - want).max() <= (1 if out else 1e-5 * np.abs(want).max())
        else:
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dt,layout", [("int8", "OIHW"), ("uint8", "OIHW"), ("int8", "OHWI")])
def test_precompute_zp_wsum_matches_jax(dt, layout):
    w = _rand_q(np.random.default_rng(2), (12, 5, 3, 3), dt)
    if layout == "OHWI":
        w = np.ascontiguousarray(np.transpose(w, (0, 2, 3, 1)))
    got = tqc.precompute_zp_wsum(w, Layout[layout])
    want = np.asarray(jqc.precompute_zp_wsum(w, JLayout[layout]))
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_op_api_appends_and_strips_the_zp_weight_sum():
    """conv2d on an asymmetric x appends the `__zp_wsum__` vector; with the
    scheme's integer callback gated off, the generic path strips it."""
    from csinn2_tpu_torch.utils.config import config as tconfig
    from csinn2_tpu.utils.config import config as jconfig
    rng = np.random.default_rng(5)
    xf = rng.normal(size=(1, 6, 6, 4)).astype(np.float32)
    wf = rng.normal(size=(3, 4, 3, 3)).astype(np.float32)
    bf = rng.normal(size=(3,)).astype(np.float32)
    jx = jobserve(xf, JDtype.INT8)
    jx.scheme = JQS.INT8_ASYM
    tx = observe(xf, Dtype.INT8)
    tx.scheme = QuantScheme.INT8_ASYM
    jw = jobserve(wf, JDtype.INT8, symmetric=True, axis=0)
    tw = observe(wf, Dtype.INT8, symmetric=True, axis=0)
    jw.scheme, tw.scheme = JQS.INT8_ASYM, QuantScheme.INT8_ASYM
    jo, to = _qi(0.05, -3, "INT8", "INT8_ASYM")
    jp = jops.Conv2dParams(pad=(1, 1, 1, 1), layout=JLayout.NHWC)
    tp = ops.Conv2dParams(pad=(1, 1, 1, 1), layout=Layout.NHWC)
    tX, tW = from_float(xf, tx, Layout.NHWC), from_float(wf, tw)
    jW = jfrom_float(wf, jw)
    assert ops.api._conv_inputs(tX, tW, None)[-1].meta.name == "__zp_wsum__"
    for key in (None, "conv2d@int8_asym"):
        if key:
            tconfig.disable(key)
            jconfig.disable(key)
        try:
            got = ops.conv2d(tX, tW, Tensor(bf), tp, out_qinfo=to).data.numpy()
            want = np.asarray(jax.jit(lambda xa, ba: jops.conv2d(
                JTensor(xa, qinfo=jx, layout=JLayout.NHWC), jW, JTensor(ba), jp,
                out_qinfo=jo).data)(np.asarray(jfrom_float(xf, jx).data), bf))
        finally:
            if key:
                tconfig.enable(key)
                jconfig.enable(key)
        d = np.abs(got.astype(int) - want.astype(int))
        assert d.max() <= (0 if key is None else GENERIC_LSB), (key, d.max())


def test_conv_residual_input_order_float_and_quant():
    """ops.conv2d(residual=) in FLOAT32 (the float conv's residual slot) and
    INT8_SYM against JAX, bit for bit."""
    rng = np.random.default_rng(6)
    xf = rng.normal(size=(2, 5, 5, 4)).astype(np.float32)
    wf = rng.normal(size=(4, 4, 1, 1)).astype(np.float32)
    rf = rng.normal(size=(2, 5, 5, 4)).astype(np.float32)
    p, jp = ops.Conv2dParams(layout=Layout.NHWC, fuse_relu6=True), \
        jops.Conv2dParams(layout=JLayout.NHWC, fuse_relu6=True)
    # the JAX conv2d(residual=) raises NameError without a bias (its api.py
    # uses np unimported there), so the JAX side gets the zero bias the
    # port makes itself
    zb = np.zeros(4, np.float32)
    got = ops.conv2d(Tensor(xf), Tensor(wf), None, p, residual=Tensor(rf)).data.numpy()
    want = np.asarray(jax.jit(lambda a, r: jops.conv2d(
        JTensor(a), JTensor(jnp.asarray(wf)), JTensor(jnp.asarray(zb)), jp,
        residual=JTensor(r)).data)(xf, rf))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    qs = {}
    for k, arr in (("x", xf), ("r", rf), ("w", wf)):
        qs[k] = (jobserve(arr, JDtype.INT8, symmetric=True, axis=0 if k == "w" else None),
                 observe(arr, Dtype.INT8, symmetric=True, axis=0 if k == "w" else None))
        qs[k][0].scheme, qs[k][1].scheme = JQS.INT8_SYM, QuantScheme.INT8_SYM
    jo, to = _qi(0.04, 0, "INT8", "INT8_SYM")
    got = ops.conv2d(from_float(xf, qs["x"][1], Layout.NHWC), from_float(wf, qs["w"][1]), None,
                     p, out_qinfo=to, residual=from_float(rf, qs["r"][1], Layout.NHWC)).data
    jW = jfrom_float(wf, qs["w"][0])
    want = jax.jit(lambda a, r: jops.conv2d(
        JTensor(a, qinfo=qs["x"][0], layout=JLayout.NHWC), jW, JTensor(jnp.asarray(zb)), jp,
        out_qinfo=jo,
        residual=JTensor(r, qinfo=qs["r"][0], layout=JLayout.NHWC)).data)(
        np.asarray(jfrom_float(xf, qs["x"][0]).data), np.asarray(jfrom_float(rf, qs["r"][0]).data))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# -- the dtype matrix (tests/test_dtype_matrix.py) through the op API --------------

SCHEMES = {
    "f32": (None, None, False), "f16": ("FLOAT16", "FLOAT16", False),
    "bf16": ("BFLOAT16", "BFLOAT16", False), "i8": ("INT8", "INT8", False),
    "i8pc": ("INT8", "INT8", True), "u8": ("UINT8", "INT8", False),
    "i16": ("INT16", "INT16", False),
}


def _as(x, dt, axis=None):
    """(JAX Tensor, port Tensor) of x under dtype name dt."""
    if dt is None:
        return JTensor(jnp.asarray(x)), Tensor(x)
    if dt in ("FLOAT16", "BFLOAT16"):
        return JTensor(jnp.asarray(x, JDtype[dt].jnp)), Tensor(T(x).to(Dtype[dt].torch))
    sym = dt != "UINT8"
    return (jfrom_float(x, jobserve(x, JDtype[dt], symmetric=sym, axis=axis)),
            from_float(x, observe(x, Dtype[dt], symmetric=sym, axis=axis)))


def _out(golden, dt):
    if dt is None:
        return None, None
    if dt in ("FLOAT16", "BFLOAT16"):
        return jobserve(golden, JDtype[dt]), observe(golden, Dtype[dt])
    sym = dt != "UINT8"
    return (jobserve(golden, JDtype[dt], symmetric=sym),
            observe(golden, Dtype[dt], symmetric=sym))


def _jit_layer(fn, tensors, consts=()):
    """Run a JAX layer-mode op under jit, each tensor's data an argument but
    those indexed in `consts` (weights: the op API folds their zp sums)."""
    args = [i for i in range(len(tensors)) if i not in consts]

    def run(*arrs):
        ts = list(tensors)
        for i, a in zip(args, arrs):
            ts[i] = JTensor(a, qinfo=tensors[i].qinfo, layout=tensors[i].layout)
        return fn(*ts).data
    return np.asarray(jax.jit(run)(*[tensors[i].data for i in args]))


def _check(got_t, want, dt):
    got = got_t.data
    if dt is None or dt in ("FLOAT16", "BFLOAT16"):
        got = got.float().numpy()
        want = np.asarray(want, np.float32)
        eps = 1e-6 if dt is None else float(torch.finfo(Dtype[dt].torch).eps)
        np.testing.assert_allclose(got, want, rtol=eps, atol=eps * np.abs(want).max())
    else:
        d = np.abs(got.numpy().astype(int) - np.asarray(want).astype(int))
        assert d.max() <= GENERIC_LSB, d.max()


def _matrix(scheme, golden, build, xs):
    """xs: [(array, dtype slot 'a' | 'w', per-channel axis)]."""
    adt, wdt, perchan = SCHEMES[scheme]
    pairs = [_as(a, adt if slot == "a" else wdt, axis=(0 if (slot == "w" and perchan) else None))
             for a, slot in xs]
    jo, to = _out(golden, adt)
    want = _jit_layer(lambda *ts: build(jops, ts, jo, J=True), [p[0] for p in pairs],
                      consts=[i for i, (_, slot) in enumerate(xs) if slot == "w"])
    got = build(ops, [p[1] for p in pairs], to, J=False)
    _check(got, want, adt)


@pytest.mark.parametrize("scheme", list(SCHEMES))
@pytest.mark.parametrize("op", ["conv2d", "depthwise", "fc"])
def test_matrix_conv_fc(rng, scheme, op):
    if op == "conv2d":
        x = rng.standard_normal((1, 8, 14, 14)).astype(np.float32)
        w = (rng.standard_normal((16, 8, 3, 3)) * 0.3).astype(np.float32)
        golden = torch.nn.functional.conv2d(T(x), T(w), padding=1).numpy()

        def build(o, ts, oq, J):
            return o.conv2d(ts[0], ts[1], None, o.Conv2dParams(pad=(1, 1, 1, 1)), out_qinfo=oq)
    elif op == "depthwise":
        x = rng.standard_normal((1, 16, 10, 10)).astype(np.float32)
        w = (rng.standard_normal((16, 1, 3, 3)) * 0.3).astype(np.float32)
        golden = torch.nn.functional.conv2d(T(x), T(w), padding=1, groups=16).numpy()

        def build(o, ts, oq, J):
            return o.depthwise_conv2d(ts[0], ts[1], None,
                                      o.Conv2dParams(pad=(1, 1, 1, 1), group=16), out_qinfo=oq)
    else:
        x = rng.standard_normal((4, 64)).astype(np.float32)
        w = (rng.standard_normal((32, 64)) * 0.2).astype(np.float32)
        golden = x @ w.T

        def build(o, ts, oq, J):
            return o.fullyconnected(ts[0], ts[1], None, o.FCParams(units=32), out_qinfo=oq)
    _matrix(scheme, golden, build, [(x, "a"), (w, "w")])


@pytest.mark.parametrize("scheme", list(SCHEMES))
@pytest.mark.parametrize("pool", ["max", "avg", "global", "global_max", "l2"])
def test_matrix_pooling(rng, scheme, pool):
    x = rng.standard_normal((1, 4, 11, 11)).astype(np.float32)
    t = T(x)
    F = torch.nn.functional
    golden = {"max": lambda: F.max_pool2d(t, 3, 2, 1),
              "avg": lambda: F.avg_pool2d(t, 2, 2, 0, count_include_pad=True),
              "global": lambda: t.mean(dim=(2, 3), keepdim=True),
              "global_max": lambda: t.amax(dim=(2, 3), keepdim=True),
              "l2": lambda: F.lp_pool2d(t, 2, 2, 2) / 2}[pool]().numpy()

    def build(o, ts, oq, J):
        P = o.PoolParams
        if pool == "max":
            return o.maxpool2d(ts[0], P(kernel=(3, 3), stride=(2, 2), pad=(1, 1, 1, 1)),
                               out_qinfo=oq)
        if pool == "avg":
            return o.avgpool2d(ts[0], P(kernel=(2, 2), stride=(2, 2), count_include_pad=True),
                               out_qinfo=oq)
        if pool == "global":
            return o.global_avgpool2d(ts[0], out_qinfo=oq)
        if pool == "global_max":
            return o.global_maxpool2d(ts[0], out_qinfo=oq)
        return o.l2pool2d(ts[0], P(kernel=(2, 2), stride=(2, 2)), out_qinfo=oq)
    _matrix(scheme, golden, build, [(x, "a")])


@pytest.mark.parametrize("scheme", list(SCHEMES))
@pytest.mark.parametrize("name", ["relu", "sigmoid", "softmax", "hard_sigmoid", "add", "mul"])
def test_matrix_activations_and_eltwise(rng, scheme, name):
    a = rng.standard_normal((3, 16)).astype(np.float32)
    b = rng.standard_normal((3, 16)).astype(np.float32)
    t = T(a)
    golden = {"relu": lambda: torch.relu(t), "sigmoid": lambda: torch.sigmoid(t),
              "softmax": lambda: torch.softmax(t, -1),
              "hard_sigmoid": lambda: torch.clamp(t / 6 + 0.5, 0, 1),
              "add": lambda: t + T(b), "mul": lambda: t * T(b)}[name]().numpy()

    def build(o, ts, oq, J):
        if name == "softmax":
            return o.softmax(ts[0], o.SoftmaxParams(axis=-1), out_qinfo=oq)
        return getattr(o, name)(*ts, out_qinfo=oq)
    _matrix(scheme, golden, build, [(a, "a")] + ([(b, "a")] if name in ("add", "mul") else []))


def test_elementwise_module_matches_jax():
    """The rest of ops/ref/elementwise.py and activation.py in f32, layer
    mode, against the JAX functions (rtol 1e-6)."""
    rng = np.random.default_rng(8)
    a = (rng.random((4, 9)) * 1.8 + 0.1).astype(np.float32)
    b = (rng.random((4, 9)) * 1.8 + 0.1).astype(np.float32)
    for name in ["abs", "acos", "asinh", "atan", "ceil", "cos", "cosh", "exp", "expm1",
                 "floor", "log", "log1p", "negative", "round", "rsqrt", "sign", "sin", "sinh",
                 "sqrt", "square", "tan", "trunc", "relu1", "relu6", "silu", "erf", "tanh",
                 "softplus", "softrelu", "softsign", "gelu", "elu"]:
        x = a - 1.0 if name in ("acos", "abs", "sign", "round", "trunc", "relu1") else a
        got = getattr(ops, name)(Tensor(x)).data.numpy()
        want = np.asarray(_jit_layer(getattr(jops, name), [JTensor(jnp.asarray(x))]))
        np.testing.assert_allclose(got, want, rtol=2e-6, atol=1e-7, err_msg=name)
    for name in ["add", "sub", "mul", "div", "power", "maximum", "minimum", "mod",
                 "floor_mod", "floor_divide", "equal", "greater", "less_equal",
                 "logical_and", "logical_xor"]:
        got = getattr(ops, name)(Tensor(a), Tensor(b)).data.numpy()
        want = _jit_layer(getattr(jops, name), [JTensor(jnp.asarray(a)), JTensor(jnp.asarray(b))])
        if got.dtype == bool:
            np.testing.assert_array_equal(got, want, err_msg=name)
        else:
            np.testing.assert_allclose(got, want, rtol=2e-6, err_msg=name)
    p = ops.ReluParams(n=0.3)
    jp = jops.ReluParams(n=0.3)
    for name in ("leaky_relu", "relun", "threshold_relu"):
        got = getattr(ops, name)(Tensor(a - 1), p).data.numpy()
        want = _jit_layer(lambda t, f=getattr(jops, name): f(t, jp), [JTensor(jnp.asarray(a - 1))])
        np.testing.assert_allclose(got, want, rtol=1e-6, err_msg=name)
    got = ops.clip(Tensor(a), ops.ClipParams(min_value=0.5, max_value=1.0)).data.numpy()
    np.testing.assert_array_equal(got, np.clip(a, 0.5, 1.0))
    got = ops.log_softmax(Tensor(a)).data.numpy()
    np.testing.assert_allclose(got, _jit_layer(jops.log_softmax, [JTensor(jnp.asarray(a))]),
                               rtol=1e-6, atol=1e-6)
    cond = a > 1.0
    got = ops.where(Tensor(cond), Tensor(a), Tensor(b)).data.numpy()
    np.testing.assert_array_equal(got, np.where(cond, a, b))
    alpha = np.linspace(0.1, 0.9, 9).astype(np.float32)
    got = ops.prelu(Tensor(a - 1), Tensor(alpha), ops.PReluParams(axis=1)).data.numpy()
    np.testing.assert_allclose(got, np.where(a - 1 >= 0, a - 1, (a - 1) * alpha), rtol=1e-6)


def test_quant_core_u8_recorder_and_multiplier_shift():
    """QuantRecorder.qinfo for every scheme, the u8 graph-edge quantize /
    dequantize, QuantInfo.multiplier_shift and Tensor.astype_f32 against
    the JAX package."""
    from csinn2_tpu.core.quant import dequantize as jdequantize
    from csinn2_tpu.core.quant import quantize as jquantize
    from csinn2_tpu.models.common import QuantRecorder as JRec
    from csinn2_tpu_torch.core.quant import dequantize, quantize
    from csinn2_tpu_torch.models.common import QuantRecorder
    jr, tr = JRec(ranges={"a": (-0.7, 2.3)}), QuantRecorder(ranges={"a": (-0.7, 2.3)})
    for sch in QuantScheme:
        if sch in (QuantScheme.UNSET,) or sch.is_block:
            continue
        j, t = jr.qinfo("a", JQS[sch.name]), tr.qinfo("a", sch)
        if j is None:
            assert t is None
            continue
        assert (t.dtype.value, t.scale, t.zero_point, t.scheme.value) == \
            (j.dtype.value, j.scale, j.zero_point, j.scheme.value), sch
    x = np.random.default_rng(1).random((2, 5, 5, 3)).astype(np.float32) * 3 - 0.5
    jq, tq = jr.qinfo("a", JQS.UINT8_ASYM), tr.qinfo("a", QuantScheme.UINT8_ASYM)
    q = quantize(x, tq)
    assert q.dtype == torch.uint8
    np.testing.assert_array_equal(q.numpy(), np.asarray(jquantize(x, jq)))
    np.testing.assert_array_equal(dequantize(q, tq).numpy(), np.asarray(jdequantize(q.numpy(), jq)))
    t = Tensor(q, qinfo=tq)
    np.testing.assert_array_equal(t.astype_f32().numpy(),
                                  np.asarray(JTensor(jnp.asarray(q.numpy()), qinfo=jq).astype_f32()))
    np.testing.assert_array_equal(Tensor(T(x)).astype_f32().numpy(), x)
    sw = np.array([0.01, 0.002, 0.03], np.float32)
    for got, want in zip(tq.multiplier_shift(0.05, sw), jq.multiplier_shift(0.05, sw)):
        np.testing.assert_array_equal(got, want)


def test_group_conv2d_through_the_op_api():
    """ops.group_conv2d in FLOAT32 and INT8 (the scheme's integer callback)
    against the JAX op, layer mode."""
    rng = np.random.default_rng(12)
    xf = rng.normal(size=(2, 6, 5, 4)).astype(np.float32)
    wf = rng.normal(size=(6, 2, 3, 3)).astype(np.float32)
    bf = rng.normal(size=(6,)).astype(np.float32)
    p = ops.Conv2dParams(group=2, pad=(1, 0, 1, 1), stride=(1, 2), layout=Layout.NHWC)
    jp = jops.Conv2dParams(group=2, pad=(1, 0, 1, 1), stride=(1, 2), layout=JLayout.NHWC)
    got = ops.group_conv2d(Tensor(xf), Tensor(wf), Tensor(bf), p).data.numpy()
    want = _jit_layer(lambda x, w, b: jops.group_conv2d(x, w, b, jp),
                      [JTensor(jnp.asarray(xf)), JTensor(jnp.asarray(wf)), JTensor(jnp.asarray(bf))])
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    qx = (jobserve(xf, JDtype.INT8, symmetric=False), observe(xf, Dtype.INT8, symmetric=False))
    qw = (jobserve(wf, JDtype.INT8, symmetric=True, axis=0),
          observe(wf, Dtype.INT8, symmetric=True, axis=0))
    for a, b in (qx, qw):
        a.scheme, b.scheme = JQS.INT8_ASYM, QuantScheme.INT8_ASYM
    jo, to = _qi(0.07, 5, "INT8", "INT8_ASYM")
    tX, tW = from_float(xf, qx[1], Layout.NHWC), from_float(wf, qw[1])
    jX, jW = jfrom_float(xf, qx[0], JLayout.NHWC), jfrom_float(wf, qw[0])
    got = ops.group_conv2d(tX, tW, Tensor(bf), p, out_qinfo=to)
    assert got.data.dtype == torch.int8
    want = _jit_layer(lambda x, b: jops.group_conv2d(x, jW, b, jp, out_qinfo=jo),
                      [jX, JTensor(jnp.asarray(bf))])
    np.testing.assert_array_equal(got.data.numpy(), want)
