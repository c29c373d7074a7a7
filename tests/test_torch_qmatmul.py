"""quant_matmul of the PyTorch port against the JAX package: the int4
nibble packing byte for byte, and the plain version, in every ported mode
(block and channel scales, int8 and packed int4 values, bias, the swiglu
epilogue), against JAX's quant_matmul_ref and against the Pallas kernel in
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
(swiglu: 0.999)."""

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


@pytest.mark.parametrize("kw", [dict(scale_mode="none"), dict(w_transposed=True),
                                dict(w_transposed=True, packed_int4=True),
                                dict(epilogue_scale=0.5), dict(out_dtype=torch.int8)])
def test_unported_options_raise(rng, kw):
    """The modes of the TPU kernel that stay to port (ROADMAP queue B: 1b',
    1d, 1e') raise, in the wrapper and in the plain version."""
    x, w, s, _ = _case(rng, 2, 64, 32)
    args = dict(scale_mode="block")
    args.update(kw)
    for fn in (quant_matmul, quant_matmul_ref):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            fn(torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(w),
               torch.from_numpy(s), **args)


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
