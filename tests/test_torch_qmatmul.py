"""quant_matmul of the PyTorch port against the JAX package: the int4
nibble packing byte for byte, and the plain version, in every mode (block,
channel and no scales, int8 and packed int4 values in the [K, N] and the
transposed [N, K] layouts, bias, epilogue_scale, the swiglu epilogue, the
int8-x integer path with float, integer and fixed-point requantized
outputs), against JAX's quant_matmul_ref and against the Pallas kernel in
interpret mode.  On the CPU the port's quant_matmul runs its plain version;
its CUDA kernel is held against the same plain version by chip_smoke.py and
tests/test_torch_cuda.py on the card.

Tolerances: against JAX's f32 reference, max|Δ| <= 1e-4·max|y| for the
Q8_0 cases and rtol 1e-5 (atol 1e-5·max|y|) for the other modes (both
f32; only the summation order differs), plus one bf16 rounding step of |y|
when the output is bf16.  Against the Pallas kernel, which dequantizes w·s
in bf16 where the references use f32: cosine >= 0.999 for Q8_0 (the gate of
tests/test_kernels.py:39), and for the other modes the gates of
tests/test_kernels.py:117-238, verify(tol=5e-2) with cosine >= 0.9999
(swiglu: 0.999).  The int8-x modes: f32 outputs at rtol 1e-6 (the sums are
exact in both), integer outputs of an exact sum equal, the requantize bit
for bit; a float x with an integer output within 1 LSB."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from csinn2_tpu.kernels import qmatmul as jq
from csinn2_tpu.kernels.qmatmul import quant_matmul as jax_qmm
from csinn2_tpu.kernels.qmatmul import quant_matmul_ref as jax_qmm_ref
from csinn2_tpu.llm.model import Q8_0, quantize_weight
from csinn2_tpu.utils.verify import verify
from csinn2_tpu_torch.kernels import qmatmul as tq
from csinn2_tpu_torch.kernels.qmatmul import quant_matmul, quant_matmul_ref

torch.set_num_threads(2)

DTYPES = {"bf16": (jnp.bfloat16, torch.bfloat16), "f32": (jnp.float32, torch.float32)}


def _case(rng, M, K, N, with_bias=False):
    """bf16-exact activations, Q8_0 weights from the JAX quantizer."""
    x = np.array(jnp.asarray(rng.standard_normal((M, K)), jnp.bfloat16), np.float32)
    qw = quantize_weight((rng.standard_normal((K, N)) * 0.05).astype(np.float32), Q8_0)
    w, s = np.array(qw.values), np.array(qw.scales)
    bias = rng.standard_normal(N).astype(np.float32) if with_bias else None
    return x, w, s, bias


def _port(x, w, s, bias, odt):
    out = quant_matmul(torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(w),
                       torch.from_numpy(s),
                       None if bias is None else torch.from_numpy(bias),
                       scale_mode="block", out_dtype=odt)
    assert out.dtype == odt and out.device.type == "cpu"
    return out.float().numpy()


@pytest.mark.parametrize("M", [1, 4, 40])
@pytest.mark.parametrize("K,N", [(256, 384), (96, 160)])   # K=96: not a multiple of 128
@pytest.mark.parametrize("odt", ["bf16", "f32"])
def test_ref_matches_jax_ref(rng, M, K, N, odt):
    jdt, tdt = DTYPES[odt]
    x, w, s, _ = _case(rng, M, K, N)
    want = np.asarray(jax_qmm_ref(x, w, s, scale_mode="block", out_dtype=jdt), np.float32)
    got = _port(x, w, s, None, tdt)
    err = np.abs(got - want)
    slack = 2.0 ** -8 * np.abs(want) if odt == "bf16" else 0.0
    assert np.all(err <= 1e-4 * np.abs(want).max() + slack), err.max()


def test_ref_bias_matches_jax_ref(rng):
    x, w, s, bias = _case(rng, 8, 128, 64, with_bias=True)
    want = np.asarray(jax_qmm_ref(x, w, s, bias, scale_mode="block"))
    got = _port(x, w, s, bias, torch.float32)
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


@pytest.mark.parametrize("M,K,N,odt", [(1, 256, 384, "bf16"), (4, 96, 160, "f32"),
                                       (40, 256, 128, "bf16")])
def test_ref_matches_jax_interpret_kernel(rng, M, K, N, odt):
    jdt, tdt = DTYPES[odt]
    x, w, s, _ = _case(rng, M, K, N)
    want = np.asarray(jax_qmm(jnp.asarray(x, jnp.bfloat16), w, s, scale_mode="block",
                              out_dtype=jdt, interpret=True), np.float32)
    got = _port(x, w, s, None, tdt)
    r = verify(got, want, tol=5e-2, min_cosine=0.999)
    assert r.cosine_sim > 0.999, r


def test_ref_is_plain_f32_dequant(rng):
    """The plain version is x_f32 @ (q · s repeated over 32-row blocks)."""
    x, w, s, _ = _case(rng, 3, 64, 32)
    deq = w.astype(np.float32) * np.repeat(s, 32, axis=0)
    got = quant_matmul_ref(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(s),
                           scale_mode="block").numpy()
    np.testing.assert_allclose(got, x @ deq, rtol=1e-5, atol=1e-5)


def _any_case(rng, M, K, N, *, scale_mode="block", packed_int4=False, w_transposed=False,
              int_x=False, with_bias=False, bias_i32=False):
    """Inputs of any quant_matmul mode as numpy: x (int8, or bf16-exact f32),
    the weight in its layout ([K, N], [K/2, N], [N, K] or [N, K/2], packed
    with JAX's pack_int4 / pack_int4_t), scales ([K/32, N], [N, K/32] when
    transposed, [N], or None) and an f32 or int32 bias."""
    if int_x:
        x = rng.integers(-128, 128, (M, K)).astype(np.int8)
    else:
        x = np.array(jnp.asarray(rng.standard_normal((M, K)), jnp.bfloat16), np.float32)
    lo, hi = (-8, 8) if packed_int4 else (-128, 128)
    q = rng.integers(lo, hi, (K, N)).astype(np.int8)
    if w_transposed:
        qt = np.ascontiguousarray(q.T)
        w = np.array(jq.pack_int4_t(qt)) if packed_int4 else qt
    else:
        w = np.array(jq.pack_int4(q)) if packed_int4 else q
    if scale_mode == "block":
        s = (rng.random((N, K // 32) if w_transposed else (K // 32, N)) * 0.02 + 0.005) \
            .astype(np.float32)
    elif scale_mode == "channel":
        s = (rng.random(N) * 0.02 + 0.005).astype(np.float32)
    else:
        s = None
    bias = None
    if bias_i32:
        bias = rng.integers(-2**18, 2**18, N).astype(np.int32)
    elif with_bias:
        bias = rng.standard_normal(N).astype(np.float32)
    return x, w, s, bias


def _t(a):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a))


def _port_any(x, w, s, bias, **kw):
    xt = _t(x) if x.dtype == np.int8 else _t(x).to(torch.bfloat16)
    return quant_matmul(xt, _t(w), _t(s), _t(bias), **kw)


def _jax_any(x, w, s, bias, *, bm=8, bn=128, bk=128, **kw):
    """The Pallas kernel in interpret mode, as the JAX package's tests run it."""
    xj = jnp.asarray(x) if x.dtype == np.int8 else jnp.asarray(x, jnp.bfloat16)
    return np.asarray(jax_qmm(xj, jnp.asarray(w), None if s is None else jnp.asarray(s),
                              None if bias is None else jnp.asarray(bias), bm=bm, bn=bn,
                              bk=bk, interpret=True, **kw))


@pytest.mark.parametrize("kw", [dict(scale_mode="none"), dict(w_transposed=True),
                                dict(w_transposed=True, packed_int4=True),
                                dict(epilogue_scale=0.5), dict(out_dtype=torch.int8)])
def test_unported_options_raise(rng, kw):
    """The modes the second slice left unported (rows 1b', 1d, 1e' of
    PERF.md) now run: each against the JAX kernel in interpret mode, float
    outputs at cosine > 0.9999 (verify(tol=5e-2)), the int8 output within
    1 LSB of it and within 1 LSB of JAX's f32 reference on under 1 % of the
    outputs."""
    args = dict(scale_mode="block")
    args.update(kw)
    M, K, N = 8, 128, 256
    x, w, s, _ = _any_case(rng, M, K, N, scale_mode=args["scale_mode"],
                           packed_int4=args.get("packed_int4", False),
                           w_transposed=args.get("w_transposed", False))
    jkw = {k: v for k, v in args.items() if k != "out_dtype"}
    odt = args.get("out_dtype", torch.float32)
    got = _port_any(x, w, s, None, **args)
    assert got.dtype == odt and tuple(got.shape) == (M, N)
    want = _jax_any(x, w, s, None, bk=128 if args.get("w_transposed") else 64,
                    out_dtype=jnp.int8 if odt == torch.int8 else jnp.float32, **jkw)
    if odt == torch.int8:
        # the JAX kernel forms w·s in bf16: within 1 LSB of it
        # (tests/test_kernels.py:341); JAX's f32 reference: 1 LSB on < 1 %
        assert np.abs(got.numpy().astype(int) - want.astype(int)).max() <= 1
        ref = np.asarray(jax_qmm_ref(x, w, s, out_dtype=jnp.int8, **jkw))
        d = np.abs(got.numpy().astype(int) - ref.astype(int))
        assert d.max() <= 1 and np.mean(d > 0) < 0.01, (d.max(), np.mean(d > 0))
    else:
        r = verify(got.numpy(), want, tol=5e-2, min_cosine=0.9999)
        assert r.cosine_sim > 0.9999, r


# -- the modes of the fourth slice against the JAX tests' shapes ---------------------

@pytest.mark.parametrize("case", ["block_q8", "packed_int4", "channel"])
def test_transposed_matches_jax(rng, case):
    """tests/test_kernels.py:243-289: the [N, K] / [N, K/2] layouts against
    the JAX kernel (interpret) and JAX's plain reference."""
    if case == "channel":
        M, K, N, kw, tiles = 8, 96, 48, dict(scale_mode="channel"), dict(bn=48, bk=96)
    else:
        M, K, N, tiles = 4, 128, 64, dict(bn=64, bk=64)
        kw = dict(scale_mode="block", packed_int4=case == "packed_int4")
    x, w, s, _ = _any_case(rng, M, K, N, w_transposed=True, **kw)
    got = _port_any(x, w, s, None, w_transposed=True, **kw).numpy()
    want = _jax_any(x, w, s, None, w_transposed=True, **tiles, **kw)
    r = verify(got, want, tol=5e-2, min_cosine=0.9999)
    assert r.cosine_sim > 0.9999, r             # the JAX tests' gate (bf16 w·s there)
    ref = np.asarray(jax_qmm_ref(x, w, s, w_transposed=True, **kw))
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())


# int_dot cases: (scale_mode, packed_int4, w_transposed)
INT_DOT = [("channel", False, False), ("none", False, False), ("channel", True, False),
           ("channel", False, True), ("none", True, False)]


@pytest.mark.parametrize("scale_mode,packed,trans", INT_DOT)
def test_int_dot_matches_jax(rng, scale_mode, packed, trans):
    """tests/test_kernels.py:294-305: int8 x, s8×s8 → s32 summed exactly,
    f32 out; the JAX kernel at rtol 1e-6, and the exact int64 sum."""
    M, K, N = 16, 128, 64
    x, w, s, _ = _any_case(rng, M, K, N, scale_mode=scale_mode, packed_int4=packed,
                           w_transposed=trans, int_x=True)
    kw = dict(scale_mode=scale_mode, packed_int4=packed, w_transposed=trans)
    got = _port_any(x, w, s, None, **kw).numpy()
    want = _jax_any(x, w, s, None, bn=64, **kw)
    np.testing.assert_allclose(got, want, rtol=1e-6)
    q = tq._weight_kn(_t(w), K, packed, trans).numpy().astype(np.int64)
    exact = (x.astype(np.int64) @ q).astype(np.float32)
    np.testing.assert_array_equal(got, exact * s if s is not None else exact)


@pytest.mark.parametrize("odt,jdt,zp", [(torch.int8, jnp.int8, 3.0), (torch.uint8, jnp.uint8, 128.0),
                                        (torch.int16, jnp.int16, -7.0), (torch.int32, jnp.int32, 0.0)])
@pytest.mark.parametrize("with_bias", [True, False])
def test_int_dot_integer_outputs_match_jax(rng, odt, jdt, zp, with_bias):
    """tests/test_kernels.py:308-326: the float epilogue of an exact int32 sum
    to an integer output, clip(round(acc·s·e + b) + zp) (int32: a plain
    cast), equal to the JAX kernel's: the port rounds the epilogue as XLA's
    compiled code does (fma), and the sum is exact."""
    M, K, N = 8, 64, 32
    x, w, s, b = _any_case(rng, M, K, N, scale_mode="channel", int_x=True,
                           with_bias=with_bias)
    s = s * 0.05
    kw = dict(scale_mode="channel", epilogue_scale=0.37, out_zp=zp)
    got = _port_any(x, w, s, b, out_dtype=odt, **kw)
    want = _jax_any(x, w, s, b, bn=32, bk=64, out_dtype=jdt, **kw)
    assert got.dtype == odt
    np.testing.assert_array_equal(got.numpy(), want)


def test_float_x_uint8_output_matches_jax(rng):
    """tests/test_kernels.py:329-342: a float x with a uint8 output (the
    float sums differ in order from the kernel's: within 1 LSB)."""
    M, K, N = 8, 64, 32
    x, w, s, _ = _any_case(rng, M, K, N, scale_mode="channel")
    s = s * 0.05
    kw = dict(scale_mode="channel", epilogue_scale=2.0, out_zp=128.0)
    got = _port_any(x, w, s, None, out_dtype=torch.uint8, **kw).numpy()
    want = _jax_any(x, w, s, None, bn=32, bk=64, out_dtype=jnp.uint8, **kw)
    assert got.dtype == np.uint8
    np.testing.assert_allclose(got.astype(int), want.astype(int), atol=1)
    ref = np.asarray(jax_qmm_ref(x, w, s, out_dtype=jnp.uint8, **kw))
    np.testing.assert_allclose(got.astype(int), ref.astype(int), atol=1)


@pytest.mark.parametrize("dt", ["INT8", "UINT8", "INT16"])
@pytest.mark.parametrize("layout", ["kn", "nk"])
def test_requant_epilogue_bit_exact(rng, dt, layout):
    """tests/test_requant.py:46-69: int8 x · int8 w, int32 bias, rq_mult /
    rq_shift: bit for bit the JAX kernel (interpret) and the oracle."""
    from csinn2_tpu.core.dtypes import Dtype as JDtype
    from csinn2_tpu.core.quant import quantize_multiplier, requantize_int
    jd = getattr(JDtype, dt)
    M, K, N = 16, 256, 128
    x, w, _, bias = _any_case(rng, M, K, N, scale_mode="none", int_x=True,
                              w_transposed=layout == "nk", bias_i32=True)
    eff = np.exp(rng.uniform(np.log(1e-5), np.log(0.5), N))
    mult, shift = quantize_multiplier(eff)
    zp = 10 if dt != "UINT8" else 140
    kw = dict(scale_mode="none", out_zp=float(zp), w_transposed=layout == "nk")
    got = _port_any(x, w, None, bias, out_dtype=getattr(torch, jd.value),
                    rq_mult=_t(mult), rq_shift=_t(shift), **kw).numpy()
    want = _jax_any(x, w, None, bias, out_dtype=jd.jnp, rq_mult=jnp.asarray(mult),
                    rq_shift=jnp.asarray(shift), **kw)
    q = w.T if layout == "nk" else w
    acc = x.astype(np.int64) @ q.astype(np.int64) + bias[None, :]
    gold = requantize_int(acc.astype(np.int32), mult[None, :], shift[None, :], zp, jd)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, gold)


@pytest.mark.parametrize("bad", ["packed_t_bias", "rq_float_x", "rq_block", "rq_float_out",
                                 "swiglu_int_out"])
def test_jax_asserts_raise_value_error(rng, bad):
    """Where the JAX wrapper asserts, the port raises ValueError, in the
    wrapper and in the plain version."""
    xi, wi, _, bi = _any_case(rng, 4, 64, 256, scale_mode="none", int_x=True, bias_i32=True)
    xf, wp, sp, bf = _any_case(rng, 4, 64, 256, packed_int4=True, w_transposed=True,
                               with_bias=True)
    rq = dict(rq_mult=np.full(256, 2**30, np.int32), rq_shift=np.zeros(256, np.int32))
    case = {"packed_t_bias": (xf, wp, sp, bf, dict(packed_int4=True, w_transposed=True,
                                                   scale_mode="block")),
            "rq_float_x": (xf, wi, None, bi, dict(scale_mode="none", out_dtype=torch.int8, **rq)),
            "rq_block": (xi, wi, np.ones((2, 256), np.float32), bi,
                         dict(scale_mode="block", out_dtype=torch.int8, **rq)),
            "rq_float_out": (xi, wi, None, bi, dict(scale_mode="none", **rq)),
            "swiglu_int_out": (xf, wi, None, None, dict(scale_mode="none", swiglu=True,
                                                        out_dtype=torch.int8))}[bad]
    x, w, s, b, kw = case
    xt = _t(x) if x.dtype == np.int8 else _t(x).to(torch.bfloat16)
    for fn in (quant_matmul, quant_matmul_ref):
        with pytest.raises(ValueError):
            fn(xt, _t(w), _t(s), _t(b), **kw)


def test_unreached_combination_raises_not_implemented(rng):
    """swiglu on the int8-x (int_dot) path: accepted by the JAX wrapper,
    reached by no caller or test of the JAX package; it names its ROADMAP
    item."""
    x, w, s, _ = _any_case(rng, 4, 64, 256, scale_mode="channel", int_x=True)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        quant_matmul(_t(x), _t(w), _t(s), scale_mode="channel", swiglu=True)


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("scale_mode", ["block", "channel"])
def test_swiglu_with_w_transposed_matches_jax(rng, packed, scale_mode):
    """swiglu with the [N, K] / [N, K/2] layouts (ROADMAP B.9b, now routed
    like row 1e): the port's plain version against the JAX kernel in
    interpret mode (its gate, cosine 0.999) and JAX's f32 reference."""
    M, K, N = 8, 128, 512
    x, w, s, _ = _any_case(rng, M, K, N, scale_mode=scale_mode, packed_int4=packed,
                           w_transposed=True)
    kw = dict(scale_mode=scale_mode, packed_int4=packed, w_transposed=True, swiglu=True)
    got = _port_any(x, w, s, None, **kw).numpy()
    assert got.shape == (M, N // 2)
    want = _jax_any(x, w, s, None, bn=256, bk=128, **kw)
    r = verify(got, want, tol=5e-2, min_cosine=0.999)
    assert r.cosine_sim > 0.999, r
    ref = np.asarray(jax_qmm_ref(x, w, s, **kw))
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())


# -- the prefill kernel's numerics and launch plan (csrc/qmatmul.cuh) ----------------

def _bf16(a):
    return np.asarray(jnp.asarray(np.asarray(a, np.float32), jnp.bfloat16), np.float32)


def _bf16_ws_gemm(x, q_kn, s_blocks):
    """What the card's prefill kernel computes for block scales, in numpy:
    each weight bf16(bf16(q) · bf16(s)) (one rounding of the exact f32
    product), x in bf16, the products summed in f64 (the kernel: f32)."""
    K, N = q_kn.shape
    s_rows = np.repeat(_bf16(s_blocks), 32, axis=0)               # [K, N]
    w = _bf16(q_kn.astype(np.float32) * s_rows)
    return (_bf16(x).astype(np.float64) @ w.astype(np.float64)).astype(np.float32)


@pytest.mark.parametrize("layout", ["kn", "packed_kn", "nk", "packed_nk"])
def test_prefill_bf16_ws_numerics_match_jax_kernel(rng, layout):
    """The numpy emulation of the prefill kernel's bf16 w·s against the JAX
    kernel (interpret) in each block layout: within 2e-6·max|y| (f32 sums in
    another order), where JAX's f32 reference (the port's plain version)
    differs from the same kernel by more than 50 times that."""
    M, K, N = 24, 256, 128
    packed, trans = layout.startswith("packed"), layout.endswith("nk")
    x, w, s, _ = _any_case(rng, M, K, N, packed_int4=packed, w_transposed=trans)
    kw = dict(scale_mode="block", packed_int4=packed, w_transposed=trans)
    want = _jax_any(x, w, s, None, bm=8, bn=128, bk=128, **kw)
    q = tq._weight_kn(_t(w), K, packed, trans).numpy()
    got = _bf16_ws_gemm(x, q, s.T if trans else s)
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= 2e-6 * scale
    f32 = np.asarray(jax_qmm_ref(x, w, s, **kw))
    assert np.abs(f32 - want).max() > 50 * 2e-6 * scale


LLAMA_PROJ = {  # (K, N) of each projection: Llama-2-7B and 13B
    "7b.wqkv": (4096, 12288), "7b.wo": (4096, 4096), "7b.w13": (4096, 22016),
    "7b.w13sw": (4096, 22528), "7b.w2": (11008, 4096), "7b.lm_head": (4096, 32000),
    "13b.wqkv": (5120, 15360), "13b.wo": (5120, 5120), "13b.w13": (5120, 27648),
    "13b.w2": (13824, 5120), "13b.lm_head": (5120, 32000)}


def _plan_invariants(M, N, K, trans, n_sm=132):
    p = tq.gemm_plan(M, N, K, trans, n_sm)
    nb = K // 32
    sp, bps = p["splits"], p["blocks_per_split"]
    assert sp >= 1 and sp * bps >= nb > (sp - 1) * bps       # every block once, none empty
    if p["kernel"] == "prefill":
        assert M > tq.DECODE_MAX_M and sp <= tq.PF_MAX_SPLITS
        assert bps >= min(2, nb)                              # a whole 64-k stage a split
        for packed in (False, True):
            assert tq.prefill_smem(packed) <= tq.SMEM_LIMIT
        assert p["grid"] == (-(-M // tq.PF_BM), -(-N // tq.PF_BN), sp) and p["grid"][1] <= 65535
    else:
        assert M <= tq.DECODE_MAX_M
        strips = -(-N // tq.DC_BN)
        for packed in (False, True):                          # two CTAs an SM
            smem = tq.decode_smem(packed, trans)
            assert tq.DC_CTAS_PER_SM * (smem + 1024) <= tq.SM_SMEM and smem <= tq.SMEM_LIMIT
            assert smem >= tq.DC_MT * tq.DC_BN * 4                # the finish tile fits
        assert p["counter_slots"] == strips <= tq.COUNTER_SLOTS
        assert p["grid"] == (strips, sp) and sp <= 65535
        assert bps % tq.DC_SPLIT_ALIGN == 0                   # whole stages, aligned scales
        # one wave: the CTAs fit the card's slots, unless the strips alone do not
        assert strips * sp <= tq.DC_CTAS_PER_SM * n_sm or sp == 1
    for swiglu, reduce_epi in ((False, False), (True, False), (False, True)):
        ws = tq.workspace_floats(M, N, K, swiglu, reduce_epi, n_sm)
        through_ws = sp > 1 or swiglu or (reduce_epi and p["kernel"] == "prefill")
        assert ws == (sp * M * N if through_ws else 0)
        if through_ws:                                        # every split's partial tile
            assert ws >= sp * M * N
    return p


@pytest.mark.parametrize("proj", list(LLAMA_PROJ))
@pytest.mark.parametrize("M", [1, 4, 16, 17, 128, 512, 2048])
@pytest.mark.parametrize("trans", [False, True])
def test_gemm_plan_llama_projections(proj, M, trans):
    """The Python mirror of csrc/qmatmul.cuh's launch plan at every Llama-2-7B
    and 13B projection: the decode kernels at M <= 16, the prefill kernel
    above, each K block in exactly one split, shared memory within the
    227 KB a CTA may have, the workspace the kernels ask for (the card
    holds the mirror to the library's own number)."""
    K, N = LLAMA_PROJ[proj]
    p = _plan_invariants(M, N, K, trans)
    want = "prefill" if M > 16 else ("t_decode" if trans else "decode")
    assert p["kernel"] == want


@pytest.mark.parametrize("M,N,K", [(17, 16, 32), (129, 400, 1056), (333, 2064, 96),
                                   (2047, 48, 64), (40, 160, 11008), (300, 30000, 4096)])
def test_gemm_plan_ragged(M, N, K):
    _plan_invariants(M, N, K, False)
    _plan_invariants(M, N, K, True, n_sm=114)                 # another card's SM count


def test_gemm_plan_7b_choices():
    """The plan's choices at the 7B shapes on a 132-SM H100: w13 at M = 128
    (86 tiles of 128 × 256) splits K in 3, w2 (16 tiles) in 8; at M = 2048
    (1376 tiles) nothing is split.  Decode (M = 4): w13's 86 strips of 256
    columns take 3 splits of 44 blocks (258 CTAs in the 264 slots of two
    an SM; splits end on 4-block boundaries), wo's 16 strips 16 splits, w2's
    16 strips 15, wqkv's 48 strips 5."""
    plan = lambda M, K, N: tq.gemm_plan(M, N, K, False, 132)
    assert (plan(128, 4096, 22016)["splits"], plan(128, 11008, 4096)["splits"]) == (3, 8)
    assert plan(2048, 4096, 22016)["splits"] == 1 and plan(2048, 11008, 4096)["splits"] == 1
    assert plan(4, 4096, 22016) == dict(kernel="decode", splits=3, blocks_per_split=44,
                                        strip=256, stages=3, grid=(86, 3), counter_slots=86)
    assert [plan(4, K, N)["splits"] for K, N in ((4096, 4096), (11008, 4096), (4096, 12288))] \
        == [16, 15, 5]


@pytest.mark.parametrize("proj", list(LLAMA_PROJ))
@pytest.mark.parametrize("M", [1, 2, 3, 4, 8, 9, 16])
@pytest.mark.parametrize("trans", [False, True])
def test_decode_plan_llama_projections(proj, M, trans):
    """The decode kernel's plan at every Llama-2-7B and 13B projection and
    every decode batch: shared memory within a CTA's 227 KB and two CTAs an
    SM, every split non-empty, one counter slot a strip, a workspace that
    holds every split's partial tile; the plan is the same for both
    layouts and every M <= 16."""
    K, N = LLAMA_PROJ[proj]
    p = _plan_invariants(M, N, K, trans)
    assert p["kernel"] == ("t_decode" if trans else "decode")
    q = tq.gemm_plan(1, N, K, not trans, 132)
    assert (p["splits"], p["blocks_per_split"]) == (q["splits"], q["blocks_per_split"])


@pytest.mark.parametrize("M,N,K", [(1, 16, 32), (3, 48, 96), (5, 400, 352), (9, 2064, 1056),
                                   (16, 30000, 4096), (2, 4112, 11008), (13, 272, 32 * 257)])
def test_decode_plan_ragged(M, N, K):
    """Ragged M, N (a multiple of 16, not of the 256-column strip) and K (32
    × odd, not a multiple of a ring stage), on two SM counts."""
    _plan_invariants(M, N, K, False)
    _plan_invariants(M, N, K, True, n_sm=114)


def _decode_emulation(x, q_kn, s_blocks, scale_mode, *, bias=None, epilogue_scale=None,
                      swiglu=False, n_sm=132):
    """What the card's decode kernel (csrc/qmatmul.cuh qmm_decode_kernel)
    computes, in numpy: x in bf16; block-scaled weights bf16(bf16(q) ·
    bf16(s)), channel / none weights exact; per K split of gemm_plan, an f32
    sum over k16 steps in k order (each step's 16 products summed exactly,
    as one mma, then rounded into the f32 sum); the split partials summed in
    split order in f32; then the plain version's epilogue and swiglu pairs."""
    M, K = x.shape
    N = q_kn.shape[1]
    plan = tq.gemm_plan(M, N, K, False, n_sm)
    xb = _bf16(x).astype(np.float64)
    if scale_mode == "block":
        w = _bf16(q_kn.astype(np.float32) * np.repeat(_bf16(s_blocks), 32, axis=0))
    else:
        w = q_kn.astype(np.float32)
    w = w.astype(np.float64)
    kb = plan["blocks_per_split"] * 32
    total = np.zeros((M, N), np.float32)
    for z in range(plan["splits"]):
        acc = np.zeros((M, N), np.float32)
        for k0 in range(z * kb, min(K, (z + 1) * kb), 16):
            acc = (acc + xb[:, k0:k0 + 16] @ w[k0:k0 + 16]).astype(np.float32)
        total = (total + acc).astype(np.float32)
    s_t = None if scale_mode != "channel" else torch.from_numpy(s_blocks)
    y = tq._fma_epilogue(torch.from_numpy(total), s_t, scale_mode, epilogue_scale,
                         None if bias is None else torch.from_numpy(bias))
    return (tq.swiglu_pairs(y) if swiglu else y).numpy()


DECODE_NUMERICS = {  # label → (scale_mode, packed_int4, w_transposed, swiglu)
    "block": ("block", False, False, False), "channel": ("channel", False, False, False),
    "none": ("none", False, False, False), "packed": ("block", True, False, False),
    "nk_int8": ("block", False, True, False), "nk_packed": ("block", True, True, False),
    "swiglu": ("block", True, False, True)}


@pytest.mark.parametrize("mode", list(DECODE_NUMERICS))
@pytest.mark.parametrize("M", [1, 3, 4, 8, 16])
def test_decode_numerics_match_jax_kernel(rng, mode, M):
    """The numpy emulation of the decode kernel's numerics against the JAX
    kernel in interpret mode (both bf16(q)·bf16(s), f32 sums in another
    order): within 2e-6·max|y| in every mode and layout.  For the block
    modes JAX's f32 reference (the port's plain version) misses the kernel
    by more than 50 times that; for channel and none, whose products are
    exact in both, only the summation order differs."""
    scale_mode, packed, trans, swiglu = DECODE_NUMERICS[mode]
    K, N = 1056, 512                             # 33 blocks: a ragged last split
    x, w, s, _ = _any_case(rng, M, K, N, scale_mode=scale_mode, packed_int4=packed,
                           w_transposed=trans)
    kw = dict(scale_mode=scale_mode, packed_int4=packed, w_transposed=trans, swiglu=swiglu)
    want = _jax_any(x, w, s, None, bm=-(-M // 8) * 8, bn=N if swiglu else 128, bk=96, **kw)
    q = tq._weight_kn(_t(w), K, packed, trans).numpy()
    got = _decode_emulation(x, q, s.T if (trans and s is not None) else s, scale_mode,
                            swiglu=swiglu)
    assert got.shape == want.shape
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= 2e-6 * scale
    if scale_mode == "block":
        f32 = np.asarray(jax_qmm_ref(x, w, s, **kw))
        assert np.abs(f32 - want).max() > 50 * 2e-6 * scale


def test_launch_keys_name_each_new_family():
    assert {tq.launch_key("block", False, False, w_transposed=True),
            tq.launch_key("channel", True, False, w_transposed=True),
            tq.launch_key("channel", False, False, int_dot=True),
            tq.launch_key("none", False, False, int_dot=True, requant=True),
            tq.launch_key("none", False, False)} == {
        "quant_matmul_t", "quant_matmul_int8dot", "quant_matmul_requant", "quant_matmul_none"}


# -- int4 packing and the other weight modes -------------------------------------

@pytest.mark.parametrize("K,N", [(32, 7), (128, 24), (96, 160)])
def test_pack_int4_bytes_match_jax(rng, K, N):
    """Both layouts, byte-identical to JAX's, with -8 and 7 in every block;
    unpacking gives the values back."""
    q = rng.integers(-8, 8, size=(K, N)).astype(np.int8)
    q[::16, 0], q[1::16, 0] = -8, 7
    got = tq.pack_int4(torch.from_numpy(q))
    assert got.dtype == torch.int8 and tuple(got.shape) == (K // 2, N)
    assert np.array_equal(got.numpy(), np.asarray(jq.pack_int4(q)))
    assert np.array_equal(tq.unpack_int4(got, K).numpy(), q)
    assert np.array_equal(np.asarray(jq.unpack_int4(got.numpy(), K)), q)
    qt = np.ascontiguousarray(q.T)
    got_t = tq.pack_int4_t(torch.from_numpy(qt))
    assert np.array_equal(got_t.numpy(), np.asarray(jq.pack_int4_t(qt)))
    assert np.array_equal(tq.unpack_int4_t(got_t, K).numpy(), qt)


# (scale_mode, packed_int4, swiglu): the modes of the Llama linears
MODES = [("block", True, False), ("channel", True, False), ("channel", False, False),
         ("block", False, True), ("block", True, True),
         ("channel", False, True), ("channel", True, True)]


def _mode_case(rng, M, K, N, scale_mode, packed, with_bias=False):
    """bf16-exact activations; carriers over the full range (int8 channel
    down to -128, int4 -8..7); packed weights through JAX's pack_int4."""
    x = np.array(jnp.asarray(rng.standard_normal((M, K)), jnp.bfloat16), np.float32)
    lo, hi = (-8, 8) if packed else ((-128, 128) if scale_mode == "channel" else (-127, 128))
    q = rng.integers(lo, hi, size=(K, N)).astype(np.int8)
    q[0, :] = lo
    w = np.array(jq.pack_int4(q)) if packed else q
    s_shape = (K // 32, N) if scale_mode == "block" else (N,)
    s = (rng.random(s_shape) * 0.02 + 0.005).astype(np.float32)
    bias = rng.standard_normal(N).astype(np.float32) if with_bias else None
    return x, w, s, bias


def _tq(x, w, s, bias, **kw):
    return quant_matmul(torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(w),
                        torch.from_numpy(s), None if bias is None else torch.from_numpy(bias),
                        **kw).float().numpy()


@pytest.mark.parametrize("scale_mode,packed,swiglu", MODES)
@pytest.mark.parametrize("M", [1, 4, 40])
@pytest.mark.parametrize("odt", ["bf16", "f32"])
def test_modes_ref_matches_jax_ref(rng, scale_mode, packed, swiglu, M, odt):
    jdt, tdt = DTYPES[odt]
    x, w, s, bias = _mode_case(rng, M, 96, 512, scale_mode, packed, with_bias=M == 4)
    kw = dict(scale_mode=scale_mode, packed_int4=packed, swiglu=swiglu)
    want = np.asarray(jax_qmm_ref(x, w, s, bias, out_dtype=jdt, **kw), np.float32)
    got = _tq(x, w, s, bias, out_dtype=tdt, **kw)
    assert got.shape == (M, 256 if swiglu else 512)
    slack = 2.0 ** -8 * np.abs(want) if odt == "bf16" else 0.0
    err = np.abs(got - want)
    assert np.all(err <= 1e-5 * (np.abs(want) + np.abs(want).max()) + slack), err.max()


@pytest.mark.parametrize("scale_mode,packed,swiglu", MODES)
def test_modes_ref_matches_jax_interpret_kernel(rng, scale_mode, packed, swiglu):
    M, K, N = 8, 128, 512
    x, w, s, _ = _mode_case(rng, M, K, N, scale_mode, packed)
    kw = dict(scale_mode=scale_mode, packed_int4=packed, swiglu=swiglu)
    want = np.asarray(jax_qmm(jnp.asarray(x), w, s, bm=8, bn=N if swiglu else 128, bk=64,
                              interpret=True, **kw), np.float32)
    got = _tq(x, w, s, None, out_dtype=torch.float32, **kw)
    gate = 0.999 if swiglu else 0.9999
    r = verify(got, want, tol=5e-2, min_cosine=gate)
    assert r.cosine_sim > gate, r


def test_swiglu_pairs_take_columns_128_apart(rng):
    """swiglu: output column g·128+l pairs columns g·256+l and g·256+128+l."""
    h = rng.standard_normal((3, 768)).astype(np.float32)
    got = tq.swiglu_pairs(torch.from_numpy(h)).numpy()
    for c in (0, 127, 128, 300, 383):
        g, l = divmod(c, 128)
        h1, h3 = h[:, g * 256 + l], h[:, g * 256 + 128 + l]
        np.testing.assert_allclose(got[:, c], h1 / (1 + np.exp(-h1)) * h3, rtol=1e-6,
                                   atol=1e-6)


def test_launch_keys_name_each_mode():
    assert {tq.launch_key(*m) for m in MODES} | {tq.launch_key("block", False, False)} == {
        "quant_matmul", "quant_matmul_q4_0", "quant_matmul_channel",
        "quant_matmul_int4_channel", "quant_matmul_swiglu"}
