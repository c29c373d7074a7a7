"""The PyTorch port's fused depthwise-separable block and int8 conv/fc paths
against the JAX package, on the CPU.

Gates (assert_array_equal unless stated):
  * `fused_dsconv_ref` (the CUDA kernel's plain version), `fused_dsconv` on
    CPU tensors and the port's `ds_block_xla` (the unfused composition)
    equal the JAX `fused_dsconv(..., interpret=True)` and the JAX
    `ds_block_xla`: the seven cases of tests/test_dsblock.py and more
    (asymmetric pads, odd sizes, C not a multiple of 4, relu vs relu6 vs
    none, per-tensor dw scale, f32 output);
  * `_conv2d_quant`, `_depthwise_quant` and `_fc_quant`'s integer branch
    equal the JAX functions; `_fc_quant`'s float-carrier branch (x rounded
    to bf16, the sum in f64 rounded once) is within 1 LSB of the int8
    output: XLA sums in f32 in its own order, the one stated tolerance of
    the slice;
  * `fuse_ds_blocks` fuses the 13 pairs of MobileNetV1 and skips float
    graphs, multi-use depthwise outputs and its off switches;
  * the CUDA kernel's launch plan (`ds_plan`: pixel tile, halo rows, channel
    chunk, shared memory) holds at every tile of MobileNetV1's 13 blocks and
    ragged shapes, and a numpy emulation of its tiling (flattened pixel
    tiles across rows and images, the halo rows staged in chunks of CK
    channels, the depthwise sums read from them) gives the exact depthwise
    sums; both accepted pointwise weight forms give the same output.

The JAX functions run under jax.jit, as a JAX Session runs them: XLA then
computes acc·eff + bias as one fused multiply-add and a division by a
constant scale as a multiplication by its f32 reciprocal, which is what
the port computes (kernels/qconv.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from csinn2_tpu.core.dtypes import Dtype as JDtype
from csinn2_tpu.core.dtypes import Layout as JLayout
from csinn2_tpu.core.dtypes import QuantScheme as JQS
from csinn2_tpu.core.quant import QuantInfo as JQI
from csinn2_tpu.core.tensor import TensorMeta as JMeta
from csinn2_tpu.kernels import dsblock as jds
from csinn2_tpu.kernels import qconv as jqc
from csinn2_tpu.ops.params import Conv2dParams as JConv
from csinn2_tpu.ops.params import FCParams as JFC
from csinn2_tpu_torch import ops as tops
from csinn2_tpu_torch.core.dtypes import Dtype, Layout, QuantScheme
from csinn2_tpu_torch.core.quant import QuantInfo
from csinn2_tpu_torch.core.tensor import Tensor, TensorMeta
from csinn2_tpu_torch.graph.fuse import fuse_ds_blocks
from csinn2_tpu_torch.kernels import dsblock as tds
from csinn2_tpu_torch.kernels import launch_counts
from csinn2_tpu_torch.kernels import qconv as tqc
from csinn2_tpu_torch.ops.params import Conv2dParams, FCParams
from csinn2_tpu_torch.runtime.session import Session
from csinn2_tpu_torch.utils.config import config

torch.set_num_threads(2)


def _same_pads(H, k, stride):
    """TF SAME pads as models/common.py computes them."""
    total = max(k - stride, 0) if H % stride == 0 else max(k - H % stride, 0)
    return (total // 2, total - total // 2) * 2


def _qis(per_channel_dw, C, O, sx, sw1, sw2):
    j = (JQI(scale=sx, zero_point=0, dtype=JDtype.INT8, scheme=JQS.INT8_SYM),
         JQI(scale=sw1, zero_point=0, dtype=JDtype.INT8, axis=0 if per_channel_dw else None,
             scheme=JQS.INT8_SYM),
         JQI(scale=sw2, zero_point=0, dtype=JDtype.INT8, axis=0, scheme=JQS.INT8_SYM))
    t = (QuantInfo(scale=sx, zero_point=0, dtype=Dtype.INT8, scheme=QuantScheme.INT8_SYM),
         QuantInfo(scale=sw1, zero_point=0, dtype=Dtype.INT8,
                   axis=0 if per_channel_dw else None, scheme=QuantScheme.INT8_SYM),
         QuantInfo(scale=sw2, zero_point=0, dtype=Dtype.INT8, axis=0,
                   scheme=QuantScheme.INT8_SYM))
    return j, t


# (N, H, W, C, O, stride, k, pads or None for SAME, mid act, out act, out)
CASES = [
    (2, 16, 16, 8, 16, 1, 3, None, "relu6", "relu6", "int8"),   # tests/test_dsblock.py
    (2, 14, 14, 16, 8, 1, 3, None, "relu6", "relu6", "int8"),
    (2, 7, 7, 16, 16, 1, 3, None, "relu6", "relu6", "int8"),
    (2, 16, 16, 8, 16, 2, 3, None, "relu6", "relu6", "int8"),   # pads (0, 1, 0, 1)
    (2, 14, 14, 8, 8, 2, 3, None, "relu6", "relu6", "int8"),
    (2, 12, 12, 8, 8, 1, 5, None, "relu6", "relu6", "int8"),
    (2, 12, 12, 8, 8, 2, 5, None, "relu6", "relu6", "int8"),
    (1, 15, 11, 17, 13, 2, 3, None, "relu", "relu", "int8"),    # odd H/W, C % 4, (1,1,1,1)
    (3, 9, 10, 3, 70, 1, 3, (0, 1, 0, 1), "none", "relu6", "int8"),
    (1, 13, 8, 24, 40, 2, 5, (2, 1, 0, 2), "relu6", "none", "int8"),
    (2, 10, 10, 12, 20, 1, 5, (0, 0, 0, 0), "relu", "none", "f32"),
    (2, 11, 9, 20, 24, 2, 3, None, "relu6", "relu6", "f32"),
]


def _case(rng, N, H, W, C, O, stride, k, pads, per_channel_dw=True):
    x = rng.integers(-128, 128, (N, H, W, C), np.int8)
    w1 = rng.integers(-127, 128, (C, 1, k, k), np.int8)
    w2 = rng.integers(-127, 128, (O, C, 1, 1), np.int8)
    b1 = rng.normal(size=(C,)).astype(np.float32)
    b2 = rng.normal(size=(O,)).astype(np.float32)
    sx = 0.021
    sw1 = (rng.uniform(0.001, 0.01, (C,)).astype(np.float32) if per_channel_dw
           else np.float32(0.004))
    sw2 = rng.uniform(0.001, 0.01, (O,)).astype(np.float32)
    return x, w1, b1, w2, b2, sx, sw1, sw2


@pytest.mark.parametrize("N,H,W,C,O,stride,k,pads,mid_act,out_act,out", CASES)
def test_fused_dsconv_matches_jax(N, H, W, C, O, stride, k, pads, mid_act, out_act, out):
    rng = np.random.default_rng(C * 100 + O)
    per_channel_dw = (C != 20)                   # one case with a per-tensor dw scale
    x, w1, b1, w2, b2, sx, sw1, sw2 = _case(rng, N, H, W, C, O, stride, k, pads,
                                            per_channel_dw)
    pads = tuple(pads or _same_pads(H, k, stride))
    mid_scale = 6.0 / 255.0
    out_scale = None if out == "f32" else 0.04
    acts = dict(mid_relu=mid_act == "relu", mid_relu6=mid_act == "relu6",
                out_relu=out_act == "relu", out_relu6=out_act == "relu6")
    effd = np.broadcast_to(np.float32(sx) * sw1, (C,)).astype(np.float32)
    effp = (np.float32(mid_scale) * sw2).astype(np.float32)
    dw_kc = np.ascontiguousarray(np.transpose(w1.reshape(C, k * k)))
    pw_co = np.ascontiguousarray(np.transpose(w2.reshape(O, C)))

    want = np.asarray(jds.fused_dsconv(
        x, dw_kc, effd, b1, pw_co, effp, b2, k=k, stride=stride, pads=pads,
        mid_scale=mid_scale, out_scale=out_scale, out_zp=0.0,
        out_dtype=jnp.float32 if out == "f32" else jnp.int8, interpret=True, **acts))

    T = torch.from_numpy
    kw = dict(k=k, stride=stride, pads=pads, mid_scale=mid_scale, out_scale=out_scale,
              out_zp=0.0, out_dtype=torch.float32 if out == "f32" else torch.int8, **acts)
    targs = (T(x), T(dw_kc), T(effd), T(b1), T(pw_co), T(effp), T(b2))
    before = dict(launch_counts)
    got_ref = tds.fused_dsconv_ref(*targs, **kw).numpy()
    got = tds.fused_dsconv(*targs, **kw).numpy()
    assert dict(launch_counts) == before          # CPU tensors launch nothing
    assert got.shape == want.shape == (N, *tds.out_hw(H, W, k, stride, pads), O)
    np.testing.assert_array_equal(got_ref, want)
    np.testing.assert_array_equal(got, want)

    # the unfused compositions, both packages, through their op callbacks
    (jqx, jq1, jq2), (tqx, tq1, tq2) = _qis(per_channel_dw, C, O, sx, sw1, sw2)
    jout = None if out == "f32" else JQI(scale=out_scale, zero_point=0, dtype=JDtype.INT8,
                                         scheme=JQS.INT8_SYM)
    tout = None if out == "f32" else QuantInfo(scale=out_scale, zero_point=0,
                                               dtype=Dtype.INT8, scheme=QuantScheme.INT8_SYM)
    jmetas = [JMeta(shape=x.shape, dtype=JDtype.INT8, layout=JLayout.NHWC, qinfo=jqx),
              JMeta(shape=w1.shape, dtype=JDtype.INT8, layout=JLayout.OIHW, qinfo=jq1),
              JMeta(shape=b1.shape), JMeta(shape=w2.shape, dtype=JDtype.INT8, qinfo=jq2),
              JMeta(shape=b2.shape)]
    tmetas = [TensorMeta(shape=x.shape, dtype=Dtype.INT8, layout=Layout.NHWC, qinfo=tqx),
              TensorMeta(shape=w1.shape, dtype=Dtype.INT8, layout=Layout.OIHW, qinfo=tq1),
              TensorMeta(shape=b1.shape), TensorMeta(shape=w2.shape, dtype=Dtype.INT8,
                                                     qinfo=tq2),
              TensorMeta(shape=b2.shape)]
    ex = dict(k=k, mid_scale=mid_scale, mid_relu=acts["mid_relu"],
              mid_relu6=acts["mid_relu6"], pw_relu=acts["out_relu"],
              pw_relu6=acts["out_relu6"])
    jparams = JConv(stride=(stride, stride), pad=pads, group=C, layout=JLayout.NHWC)
    tparams = Conv2dParams(stride=(stride, stride), pad=pads, group=C, layout=Layout.NHWC)
    jxla = np.asarray(jax.jit(lambda *a: jds.ds_block_xla(list(a), jmetas, jparams, jout,
                                                          **ex))(x, w1, b1, w2, b2))
    tarr = [T(x), T(w1), T(b1), T(w2), T(b2)]
    txla = tds.ds_block_xla(tarr, tmetas, tparams, tout, **ex).numpy()
    tcb = tds.ds_block_cb(tarr, tmetas, tparams, tout, **ex).numpy()
    np.testing.assert_array_equal(jxla, want)
    np.testing.assert_array_equal(txla, want)
    np.testing.assert_array_equal(tcb, want)


def test_jax_compiled_arithmetic_is_fma_and_reciprocal():
    """Why the port rounds acc·eff + b once and requantizes by the f32
    reciprocal: that is what the JAX package's compiled graph computes."""
    rng = np.random.default_rng(5)
    y = (rng.standard_normal(1 << 16) * 3).astype(np.float32)
    s = np.float32(6.0 / 255.0)
    jitted = np.asarray(jax.jit(lambda v: v / float(s))(y))
    np.testing.assert_array_equal(jitted, y * (np.float32(1.0) / s))
    assert (jitted != y / s).any()
    N, H, C, O, k = 2, 16, 32, 64, 3
    x, w1, b1, w2, b2, sx, sw1, sw2 = _case(rng, N, H, H, C, O, 1, k, None)
    dw = np.ascontiguousarray(w1.reshape(C, k * k).T)
    pw = np.ascontiguousarray(w2.reshape(O, C).T)
    effd = (np.float32(sx) * sw1).astype(np.float32)
    effp = (np.float32(6 / 255) * sw2).astype(np.float32)
    kw = dict(k=k, stride=1, pads=(1, 1, 1, 1), mid_scale=6 / 255, mid_relu=False,
              mid_relu6=True, out_relu=False, out_relu6=False, out_scale=None, out_zp=0.0)
    want = np.asarray(jds.fused_dsconv(x, dw, effd, b1, pw, effp, b2, out_dtype=jnp.float32,
                                       interpret=True, **kw))
    T = torch.from_numpy
    args = [T(a) for a in (x, dw, effd, b1, pw, effp, b2)]
    np.testing.assert_array_equal(
        tds.fused_dsconv_ref(*args, out_dtype=torch.float32, **kw).numpy(), want)
    # the last epilogue with two roundings (f32 product, then f32 sum)
    one = tds.fused_dsconv_ref(*args[:5], torch.ones(O), torch.zeros(O),
                               out_dtype=torch.float32, **kw).numpy()
    two = one * effp + b2                 # acc·1 + 0 is exact: `one` is the pointwise sum
    assert (two != want).sum() > want.size // 10


def test_fused_dsconv_rejects_what_the_kernel_does_not_take():
    rng = np.random.default_rng(0)
    x, w1, b1, w2, b2, sx, sw1, sw2 = _case(rng, 1, 8, 8, 8, 16, 1, 3, None)
    T = torch.from_numpy
    args = [T(x), T(np.ascontiguousarray(w1.reshape(8, 9).T)), T(sw1), T(b1),
            T(np.ascontiguousarray(w2.reshape(16, 8).T)), T(sw2), T(b2)]
    kw = dict(k=3, stride=1, pads=(1, 1, 1, 1), mid_scale=0.02, mid_relu=False,
              mid_relu6=True, out_relu=False, out_relu6=True, out_scale=0.04)
    tds.fused_dsconv(*args, **kw)
    for bad, exc in [(dict(k=7), ValueError), (dict(stride=3), ValueError),
                     (dict(pads=(2, 0, 0, 0)), ValueError),
                     (dict(out_dtype=torch.uint8), TypeError),
                     (dict(out_scale=None, out_dtype=torch.int8), TypeError)]:
        with pytest.raises(exc):
            tds.fused_dsconv(*args, **{**kw, **bad})
    with pytest.raises(TypeError):
        tds.fused_dsconv(args[0].float(), *args[1:], **kw)
    big = torch.zeros((1, 4, 4, 1032), dtype=torch.int8)
    with pytest.raises(ValueError, match="2\\^24"):
        tds.fused_dsconv(big, torch.zeros((9, 1032), dtype=torch.int8), torch.ones(1032),
                         torch.zeros(1032), torch.zeros((1032, 8), dtype=torch.int8),
                         torch.ones(8), torch.zeros(8), **kw)


# -- the CUDA kernel's geometry (csrc/dsblock.cu), checked on the CPU ----------

MOBILENET_BLOCKS = [(112, 32, 64, 1), (112, 64, 128, 2), (56, 128, 128, 1),
                    (56, 128, 256, 2), (28, 256, 256, 1), (28, 256, 512, 2),
                    (14, 512, 512, 1), (14, 512, 1024, 2), (7, 1024, 1024, 1)]
PLAN_CASES = [(N, H, H, C, O, 3, s, _same_pads(H, 3, s)) for N in (128, 1, 2)
              for H, C, O, s in MOBILENET_BLOCKS] \
    + [(3, 13, 11, 40, 72, 3, 2, (1, 1, 0, 1)), (1, 9, 7, 1024, 130, 5, 1, (2, 2, 1, 2)),
       (130, 7, 7, 520, 70, 3, 1, (1, 1, 0, 1)), (5, 15, 15, 96, 200, 5, 2, (2, 2, 1, 2)),
       (2, 1, 300, 17, 9, 3, 1, (1, 1, 1, 1))]


def _tile_rows(p0, P, NP, H, Ho, Wo, k, stride, pt):
    """csrc/dsblock.cu: the global input rows [r_lo, r_hi] of the P-pixel tile at p0."""
    g0, g1 = p0 // Wo, (min(p0 + P, NP) - 1) // Wo
    r_lo = g0 // Ho * H + max(0, g0 % Ho * stride - pt)
    r_hi = g1 // Ho * H + min(H - 1, g1 % Ho * stride - pt + k - 1)
    return r_lo, r_hi


@pytest.mark.parametrize("N,H,W,C,O,k,stride,pads", PLAN_CASES)
def test_ds_plan_holds_at_every_tile(N, H, W, C, O, k, stride, pads):
    """Every tile's halo fits halo_rows, the shared memory fits a CTA (two
    an SM where the plan says so), CK is a power of two (of 16 bytes when C
    is), the O chunks are whole 64-channel tiles covering O."""
    plan = tds.ds_plan(N, H, W, C, O, k, stride, pads, 132)
    P, ck = plan["P"], plan["ck"]
    Ho, Wo = tds.out_hw(H, W, k, stride, pads)
    NP = N * Ho * Wo
    for p0 in range(0, NP, P):
        r_lo, r_hi = _tile_rows(p0, P, NP, H, Ho, Wo, k, stride, pads[0])
        assert 0 <= r_lo <= r_hi < N * H and r_hi - r_lo + 1 <= plan["halo_rows"]
    assert plan["smem"] == tds.smem_bytes(P, C, W, ck, plan["halo_rows"], plan["kc"], k)
    assert plan["smem"] <= tds.SMEM_LIMIT and ck & (ck - 1) == 0 and 4 <= ck <= 1024
    assert C % 16 or ck % 16 == 0
    assert plan["kc"] % 32 == 0 and plan["o_chunk"] % tds.OT == 0
    assert plan["grid"] == (-(-NP // P), -(-O // plan["o_chunk"]))
    if N == 128 and (H, C) in [(h, c) for h, c, _, _ in MOBILENET_BLOCKS]:
        assert 2 * (plan["smem"] + tds.CTA_RESERVED) <= tds.SM_SMEM      # two CTAs an SM


@pytest.mark.parametrize("N,H,W,C,k,stride,pads", [
    (3, 7, 7, 24, 3, 1, (1, 1, 1, 1)), (2, 9, 5, 20, 5, 2, (2, 2, 1, 2)),
    (4, 6, 6, 8, 3, 2, (0, 1, 0, 1)), (1, 12, 3, 36, 5, 1, (2, 1, 2, 2))])
def test_kernel_tiling_gives_the_depthwise_sums(N, H, W, C, k, stride, pads):
    """A numpy emulation of csrc/dsblock.cu phase 1 with small tiles (P = 16,
    CK = 8): per tile the halo rows [r_lo, r_hi] of the flattened NHWC input
    in CK-channel chunks, each pixel's taps read from them at its halo row
    n·H + ih - r_lo, skipped outside the image — the exact int32 depthwise
    sums of fused_dsconv_ref's loop."""
    rng = np.random.default_rng(3)
    x = rng.integers(-128, 128, (N, H, W, C)).astype(np.int64)
    dw = rng.integers(-128, 128, (k * k, C)).astype(np.int64)
    Ho, Wo = tds.out_hw(H, W, k, stride, pads)
    pt, pd, pl, pr = pads
    xp = np.pad(x, ((0, 0), (pt, pd), (pl, pr), (0, 0)))
    want = np.zeros((N, Ho, Wo, C), np.int64)
    for dy in range(k):
        for dx in range(k):
            want += xp[:, dy:dy + (Ho - 1) * stride + 1:stride,
                       dx:dx + (Wo - 1) * stride + 1:stride] * dw[dy * k + dx]
    rows = x.reshape(N * H, W, C)
    P, CK, NP = 16, 8, N * Ho * Wo
    got = np.zeros((NP, C), np.int64)
    for p0 in range(0, NP, P):
        r_lo, r_hi = _tile_rows(p0, P, NP, H, Ho, Wo, k, stride, pt)
        for c0 in range(0, C, CK):
            halo = rows[r_lo:r_hi + 1, :, c0:c0 + CK]
            for pix in range(p0, min(p0 + P, NP)):
                n, rem = divmod(pix, Ho * Wo)
                oh, ow = divmod(rem, Wo)
                ih0, iw0 = oh * stride - pt, ow * stride - pl
                for dy in range(k):
                    if not 0 <= ih0 + dy < H:
                        continue
                    for dx in range(k):
                        if 0 <= iw0 + dx < W:
                            got[pix, c0:c0 + CK] += (halo[n * H + ih0 + dy - r_lo, iw0 + dx]
                                                     * dw[dy * k + dx, c0:c0 + CK])
    np.testing.assert_array_equal(got.reshape(N, Ho, Wo, C), want)


def test_fused_dsconv_takes_both_weight_forms():
    """pw_w as a contiguous [C, O] and as the transposed view of a
    contiguous [O, C] (what fused_args passes: the graph weight's own
    layout, no copy) give the same output; kernels that take [O, C] read
    that view's storage as it is."""
    rng = np.random.default_rng(2)
    x, w1, b1, w2, b2, sx, sw1, sw2 = _case(rng, 2, 9, 7, 24, 40, 1, 3, None)
    T = torch.from_numpy
    dw = T(np.ascontiguousarray(w1.reshape(24, 9).T))
    pw_oc = T(np.ascontiguousarray(w2.reshape(40, 24)))
    kw = dict(k=3, stride=1, pads=(1, 1, 1, 1), mid_scale=0.02, mid_relu=False,
              mid_relu6=True, out_relu=False, out_relu6=True, out_scale=0.04)
    args = (T(x), dw, T(sw1 * np.float32(sx)), T(b1))
    tail = (T(sw2 * np.float32(0.02)), T(b2))
    view = pw_oc.t()
    a = tds.fused_dsconv(*args, pw_oc.t().contiguous(), *tail, **kw)
    b = tds.fused_dsconv(*args, view, *tail, **kw)
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert tds._weight_oc(view).data_ptr() == pw_oc.data_ptr()


# -- qconv ---------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["conv0", "pointwise", "depthwise_s2", "depthwise_op"])
def test_conv_quant_matches_jax(kind):
    rng = np.random.default_rng(7)
    N, H, W = 2, 11, 12
    C, O, k, stride, pads = {"conv0": (3, 8, 3, 2, (0, 1, 0, 1)),
                             "pointwise": (24, 40, 1, 1, (0, 0, 0, 0)),
                             "depthwise_s2": (16, 16, 3, 2, (1, 1, 1, 1)),
                             "depthwise_op": (16, 16, 3, 1, (1, 1, 1, 1))}[kind]
    dw = kind.startswith("depthwise")
    x = rng.integers(-128, 128, (N, H, W, C), np.int8)
    w = rng.integers(-127, 128, (O, 1 if dw else C, k, k), np.int8)
    b = rng.normal(size=(O,)).astype(np.float32)
    sw = rng.uniform(0.001, 0.01, (O,)).astype(np.float32)
    group = C if kind == "depthwise_s2" else 1
    jp = JConv(stride=(stride, stride), pad=pads, group=group, layout=JLayout.NHWC,
               fuse_relu6=True)
    tp = Conv2dParams(stride=(stride, stride), pad=pads, group=group, layout=Layout.NHWC,
                      fuse_relu6=True)
    jmetas = [JMeta(shape=x.shape, dtype=JDtype.INT8, layout=JLayout.NHWC,
                    qinfo=JQI(scale=0.03, dtype=JDtype.INT8, scheme=JQS.INT8_SYM)),
              JMeta(shape=w.shape, dtype=JDtype.INT8,
                    qinfo=JQI(scale=sw, dtype=JDtype.INT8, axis=0, scheme=JQS.INT8_SYM)),
              JMeta(shape=b.shape)]
    tmetas = [TensorMeta(shape=x.shape, dtype=Dtype.INT8, layout=Layout.NHWC,
                         qinfo=QuantInfo(scale=0.03, dtype=Dtype.INT8,
                                         scheme=QuantScheme.INT8_SYM)),
              TensorMeta(shape=w.shape, dtype=Dtype.INT8,
                         qinfo=QuantInfo(scale=sw, dtype=Dtype.INT8, axis=0,
                                         scheme=QuantScheme.INT8_SYM)),
              TensorMeta(shape=b.shape)]
    jf, tf = ((jqc._depthwise_quant, tqc._depthwise_quant) if kind == "depthwise_op"
              else (jqc._conv2d_quant, tqc._conv2d_quant))
    T = torch.from_numpy
    for oq in ("int8", None):
        jo = JQI(scale=0.05, dtype=JDtype.INT8, scheme=JQS.INT8_SYM) if oq else None
        to = QuantInfo(scale=0.05, dtype=Dtype.INT8, scheme=QuantScheme.INT8_SYM) if oq \
            else None
        want = np.asarray(jax.jit(lambda *a: jf(list(a), jmetas, jp, jo))(x, w, b))
        got = tf([T(x), T(w), T(b)], tmetas, tp, to).numpy()
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_fc_quant_matches_jax():
    rng = np.random.default_rng(3)
    K, U = 256, 100
    w = rng.integers(-127, 128, (U, K), np.int8)
    b = rng.normal(size=(U,)).astype(np.float32) * 0.1
    sw = rng.uniform(0.001, 0.01, (U,)).astype(np.float32)
    jw = JMeta(shape=w.shape, dtype=JDtype.INT8,
               qinfo=JQI(scale=sw, dtype=JDtype.INT8, axis=0, scheme=JQS.INT8_SYM))
    tw = TensorMeta(shape=w.shape, dtype=Dtype.INT8,
                    qinfo=QuantInfo(scale=sw, dtype=Dtype.INT8, axis=0,
                                    scheme=QuantScheme.INT8_SYM))
    jo = JQI(scale=0.02, dtype=JDtype.INT8, scheme=JQS.INT8_SYM)
    to = QuantInfo(scale=0.02, dtype=Dtype.INT8, scheme=QuantScheme.INT8_SYM)
    T = torch.from_numpy
    # integer branch: int8 x with its own scale — exact
    xi = rng.integers(-128, 128, (4, K), np.int8)
    jx = JMeta(shape=xi.shape, dtype=JDtype.INT8,
               qinfo=JQI(scale=0.05, dtype=JDtype.INT8, scheme=JQS.INT8_SYM))
    tx = TensorMeta(shape=xi.shape, dtype=Dtype.INT8,
                    qinfo=QuantInfo(scale=0.05, dtype=Dtype.INT8, scheme=QuantScheme.INT8_SYM))
    for jq, tq in ((jo, to), (None, None)):
        want = np.asarray(jax.jit(lambda *a: jqc._fc_quant(list(a), [jx, jw, JMeta((U,))],
                                                           JFC(units=U), jq))(xi, w, b))
        got = tqc._fc_quant([T(xi), T(w), T(b)], [tx, tw, TensorMeta((U,))], FCParams(units=U),
                            tq).numpy()
        np.testing.assert_array_equal(got, want)
    # float-carrier branch (MobileNetV1's fc: a float x from flatten): within
    # 1 LSB of the int8 output — the port sums in f64, XLA in f32 in its order
    xf = (rng.random((4, K)) * 3).astype(np.float32)
    want = np.asarray(jax.jit(lambda *a: jqc._fc_quant(list(a), [JMeta(xf.shape), jw,
                                                                 JMeta((U,))],
                                                       JFC(units=U), jo))(xf, w, b))
    got = tqc._fc_quant([T(xf), T(w), T(b)], [TensorMeta(xf.shape), tw, TensorMeta((U,))],
                        FCParams(units=U), to).numpy()
    assert got.dtype == want.dtype == np.int8
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_unported_qconv_branches_raise():
    """The branches that raised before they were ported (a u8 input into s8
    weights, a fused hardswish) now run, equal to the JAX kernel bit for
    bit; no qconv branch raises NotImplementedError any more."""
    rng = np.random.default_rng(9)
    x = rng.integers(0, 256, (1, 4, 4, 8)).astype(np.uint8)
    w = rng.integers(-128, 128, (8, 8, 1, 1)).astype(np.int8)
    sw = np.full(8, 0.01, np.float32)
    cases = [
        (x, JQI(scale=0.1, zero_point=128, dtype=JDtype.UINT8, scheme=JQS.UINT8_ASYM),
         QuantInfo(scale=0.1, zero_point=128, dtype=Dtype.UINT8, scheme=QuantScheme.UINT8_ASYM),
         dict()),
        (x.view(np.int8), JQI(scale=0.1, dtype=JDtype.INT8, scheme=JQS.INT8_SYM),
         QuantInfo(scale=0.1, dtype=Dtype.INT8, scheme=QuantScheme.INT8_SYM),
         dict(fuse_hswish=True)),
    ]
    for xa, jq, tq, flags in cases:
        jw = JMeta(w.shape, JDtype.INT8, qinfo=JQI(scale=sw, dtype=JDtype.INT8, axis=0,
                                                   scheme=jq.scheme))
        tw = TensorMeta(w.shape, Dtype.INT8, qinfo=QuantInfo(scale=sw, dtype=Dtype.INT8, axis=0,
                                                             scheme=tq.scheme))
        jo = JQI(scale=0.05, dtype=JDtype.INT8, scheme=jq.scheme)
        to = QuantInfo(scale=0.05, dtype=Dtype.INT8, scheme=tq.scheme)
        jdt = JDtype(str(xa.dtype))
        want = np.asarray(jax.jit(lambda a: jqc._conv2d_quant(
            [a, jnp.asarray(w)], [JMeta(xa.shape, jdt, qinfo=jq), jw],
            JConv(layout=JLayout.NHWC, **flags), jo))(xa))
        got = tqc._conv2d_quant([torch.from_numpy(xa), torch.from_numpy(w)],
                                [TensorMeta(xa.shape, Dtype(str(xa.dtype)), qinfo=tq), tw],
                                Conv2dParams(layout=Layout.NHWC, **flags), to).numpy()
        np.testing.assert_array_equal(got, want)


# -- the fusion pass -------------------------------------------------------------

def _q(scale):
    return QuantInfo(scale=scale, zero_point=0, dtype=Dtype.INT8, scheme=QuantScheme.INT8_SYM)


def _separable_graph(extra_use: bool, quantized: bool = True):
    """x → dw 3×3 → pw 1×1 (→ a second consumer of the dw output)."""
    rng = np.random.default_rng(0)
    C, O = 8, 16
    sess = Session(device="cpu")
    wq = lambda n: QuantInfo(scale=np.full(n, 0.01, np.float32), dtype=Dtype.INT8, axis=0,
                             scheme=QuantScheme.INT8_SYM)
    with sess.build():
        x = sess.input(TensorMeta((1, 8, 8, C), Dtype.INT8 if quantized else Dtype.FLOAT32,
                                  Layout.NHWC, qinfo=_q(0.02) if quantized else None))
        w1 = rng.integers(-127, 128, (C, 1, 3, 3)).astype(np.int8 if quantized else np.float32)
        w2 = rng.integers(-127, 128, (O, C, 1, 1)).astype(np.int8 if quantized else np.float32)
        w1t = Tensor(w1, qinfo=wq(C) if quantized else None)
        w2t = Tensor(w2, qinfo=wq(O) if quantized else None)
        mid = tops.conv2d(x, w1t, None, Conv2dParams(pad=(1, 1, 1, 1), group=C,
                                                     layout=Layout.NHWC, fuse_relu6=True),
                          out_qinfo=_q(0.05) if quantized else None)
        y = tops.conv2d(mid, w2t, None, Conv2dParams(layout=Layout.NHWC),
                        out_qinfo=_q(0.05) if quantized else None)
        sess.set_output(y)
        if extra_use:
            sess.set_output(tops.relu(mid, out_qinfo=_q(0.05) if quantized else None))
    return sess


def test_fuse_ds_blocks_gates_and_skips(monkeypatch):
    monkeypatch.delenv("CSINN2_NO_FUSE_DS", raising=False)
    monkeypatch.delenv("CSINN2_FUSE_DS", raising=False)
    assert fuse_ds_blocks(_separable_graph(False).graph) == 0        # off by default
    monkeypatch.setenv("CSINN2_FUSE_DS", "1")
    assert fuse_ds_blocks(_separable_graph(True).graph) == 0         # multi-use dw output
    assert fuse_ds_blocks(_separable_graph(False, quantized=False).graph) == 0   # float
    config.disable("ds_block")
    try:
        assert fuse_ds_blocks(_separable_graph(False).graph) == 0
    finally:
        config.enable("ds_block")
    monkeypatch.setenv("CSINN2_NO_FUSE_DS", "1")
    assert fuse_ds_blocks(_separable_graph(False).graph) == 0
    monkeypatch.delenv("CSINN2_NO_FUSE_DS")
    sess = _separable_graph(False)
    x = np.random.default_rng(1).integers(-128, 128, (1, 8, 8, 8), np.int8)
    monkeypatch.delenv("CSINN2_FUSE_DS")
    want = sess.setup().run(x)
    sess2 = _separable_graph(False)
    monkeypatch.setenv("CSINN2_FUSE_DS", "1")
    sess2.setup()
    assert [n.op for n in sess2.graph.nodes] == ["ds_block"]
    np.testing.assert_array_equal(sess2.run(x).numpy(), want.numpy())


def test_fuse_ds_blocks_fuses_mobilenet_v1(monkeypatch):
    from csinn2_tpu_torch.models.mobilenet import MobileNetV1
    monkeypatch.setenv("CSINN2_FUSE_DS", "1")
    monkeypatch.delenv("CSINN2_NO_FUSE_DS", raising=False)
    m = MobileNetV1(alpha=0.25, input_size=32)
    x = np.random.default_rng(1).random(m.input_shape(1)).astype(np.float32)
    m.calibrate(x, device="cpu")
    assert not any(n.op == "ds_block" for n in m._float_session(1, "cpu").graph.nodes)
    s = m.build_session(QuantScheme.INT8_SYM, batch=1, device="cpu")
    ops_ = [n.op for n in s.graph.nodes]
    assert ops_.count("ds_block") == 13
    assert ops_ == ["conv2d"] + ["ds_block"] * 13 + ["global_avgpool2d", "flatten",
                                                      "fullyconnected"]
