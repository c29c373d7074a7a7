"""quant_matmul of the PyTorch port (block mode, Q8_0) against the JAX
package: the plain version against JAX's quant_matmul_ref and against the
Pallas kernel in interpret mode.  On the CPU the port's quant_matmul runs
its plain version; its CUDA kernel is held against the same plain version by
chip_smoke.py and tests/test_torch_cuda.py on the card.

Tolerances: against JAX's f32 reference, max|Δ| <= 1e-4·max|y| (both f32;
only the summation order differs), plus one bf16 rounding step of |y| when
the output is bf16.  Against the Pallas kernel, which dequantizes w·s in
bf16 where the references use f32: cosine >= 0.999, the gate of
tests/test_kernels.py:39."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from csinn2_tpu.kernels.qmatmul import quant_matmul as jax_qmm
from csinn2_tpu.kernels.qmatmul import quant_matmul_ref as jax_qmm_ref
from csinn2_tpu.llm.model import Q8_0, quantize_weight
from csinn2_tpu.utils.verify import verify
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


@pytest.mark.parametrize("kw", [dict(scale_mode="channel"), dict(scale_mode="none"),
                                dict(scale_mode="block", packed_int4=True),
                                dict(scale_mode="block", swiglu=True),
                                dict(scale_mode="block", w_transposed=True)])
def test_unported_options_raise(rng, kw):
    x, w, s, _ = _case(rng, 2, 64, 32)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        quant_matmul(torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(w),
                     torch.from_numpy(s), **kw)
