"""The fixed-point requantize and the block quantizer of the PyTorch port
against the JAX package: `kernels/requant.py` requant_int and
`core/quant.py` requantize_int / quantize_multiplier / requantize_float /
block_quantize / block_dequantize, on the same numpy inputs.

Gates: bit for bit, over the int8 / uint8 / int16 matrix and the rails of
tests/test_requant.py:27-43, except at acc = -2^31, where the JAX
requant_int is known to be wrong (its jnp.abs wraps; ROADMAP queue C) and
the port equals the oracle core.quant.requantize_int."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from csinn2_tpu.core import quant as jquant
from csinn2_tpu.core.dtypes import Dtype as JDtype
from csinn2_tpu.core.dtypes import QuantScheme as JScheme
from csinn2_tpu.kernels.requant import requant_int as jax_requant_int
from csinn2_tpu_torch.core import quant as tquant
from csinn2_tpu_torch.core.dtypes import Dtype, QuantScheme
from csinn2_tpu_torch.kernels.requant import requant_int

DTYPES = ["INT8", "UINT8", "INT16"]


def _jax_requant(acc, mult, shift, zp, dt):
    jd = getattr(JDtype, dt)
    return np.asarray(jax.jit(
        lambda a: jax_requant_int(a, jnp.asarray(mult)[None, :], jnp.asarray(shift)[None, :],
                                  zp, jd.qmin, jd.qmax).astype(jd.jnp))(acc))


@pytest.mark.parametrize("dt", DTYPES)
def test_requant_int_matches_jax_and_oracle(rng, dt):
    """tests/test_requant.py:27-43's matrix: random int32 accumulators ×
    multipliers over eff in [1e-6, 4] (left and right shifts, 0 and 1) ×
    zero-points, with the rails -2^31+1, 2^31-1, 0, -1."""
    n = 384
    acc = rng.integers(-2**30, 2**30, (96, n)).astype(np.int32)
    acc[0, :4] = [-2**31 + 1, 2**31 - 1, 0, -1]
    eff = np.exp(rng.uniform(np.log(1e-6), np.log(4.0), n))
    eff[:2] = [0.0, 1.0]
    mult, shift = tquant.quantize_multiplier(eff)
    zp = int(rng.integers(-64, 64)) if dt != "UINT8" else 128
    td = getattr(Dtype, dt)
    got = requant_int(torch.from_numpy(acc), torch.from_numpy(mult)[None, :],
                      torch.from_numpy(shift)[None, :], zp, td.qmin, td.qmax).to(td.torch)
    want = _jax_requant(acc, mult, shift, zp, dt)
    np.testing.assert_array_equal(got.numpy(), want)
    oracle = tquant.requantize_int(acc, mult[None, :], shift[None, :], zp, td)
    np.testing.assert_array_equal(oracle, jquant.requantize_int(
        acc, mult[None, :], shift[None, :], zp, getattr(JDtype, dt)))
    np.testing.assert_array_equal(got.numpy(), oracle)


@pytest.mark.parametrize("dt", DTYPES)
def test_requant_int_at_int32_min_follows_the_oracle(dt):
    """acc = -2^31: the port equals core.quant.requantize_int; the JAX
    function's value is recorded beside it (it differs: jnp.abs(-2^31)
    wraps to -2^31, ADVICE.md:3)."""
    eff = np.array([1e-4, 0.3, 0.9999, 3.7])
    mult, shift = tquant.quantize_multiplier(eff)
    acc = np.full((1, eff.size), -2**31, np.int32)
    td = getattr(Dtype, dt)
    got = requant_int(torch.from_numpy(acc), torch.from_numpy(mult)[None, :],
                      torch.from_numpy(shift)[None, :], 0, td.qmin, td.qmax).to(td.torch)
    oracle = tquant.requantize_int(acc, mult[None, :], shift[None, :], 0, td)
    np.testing.assert_array_equal(got.numpy(), oracle)
    jax_value = _jax_requant(acc, mult, shift, 0, dt)
    assert not np.array_equal(jax_value, oracle), (jax_value, oracle)


def test_quantize_multiplier_matches_jax(rng):
    eff = np.concatenate([np.exp(rng.uniform(np.log(1e-12), np.log(1e3), 500)),
                          [0.0, 0.5, 1.0, 1 - 2**-40, 2.0**-32]])
    for a, b in zip(tquant.quantize_multiplier(eff), jquant.quantize_multiplier(eff)):
        assert a.dtype == b.dtype == np.int32
        np.testing.assert_array_equal(a, b)


def test_requant_oracle_gemmlowp_unit_vectors():
    """tests/test_requant.py:72-81 on the port's oracle: C-truncating SRDHM."""
    mult, shift = tquant.quantize_multiplier(0.5)
    for acc, want in [(-2, -1), (-1, 0), (-3, -1), (2, 1), (3, 2), (-4, -2)]:
        assert int(tquant.requantize_int(np.int32(acc), mult[0], shift[0], 0,
                                         Dtype.INT8)) == want


def test_requantize_float_matches_jax(rng):
    acc = rng.integers(-2**20, 2**20, (16, 64)).astype(np.int32)
    eff = (rng.random(64) * 1e-4).astype(np.float32)
    got = tquant.requantize_float(torch.from_numpy(acc), eff, 5, Dtype.INT8)
    want = np.asarray(jquant.requantize_float(jnp.asarray(acc), eff, 5, JDtype.INT8))
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("scheme", ["BLOCK_Q8_0", "BLOCK_Q4_0"])
def test_block_quantize_matches_jax(rng, scheme):
    """Values, fp16 scales and the dequantized weight, byte for byte; an
    all-zero block keeps scale 0."""
    x = (rng.standard_normal((48, 256)) * 0.1).astype(np.float32)
    x[3, 32:64] = 0.0
    got = tquant.block_quantize(x, getattr(QuantScheme, scheme))
    want = jquant.block_quantize(x, getattr(JScheme, scheme))
    assert got.values.dtype == np.int8 and got.scales.dtype == np.float16
    assert got.shape == (48, 256) and got.scales.shape == (48, 8)
    np.testing.assert_array_equal(got.values, want.values)
    np.testing.assert_array_equal(got.scales, want.scales)
    np.testing.assert_array_equal(tquant.block_dequantize(got).numpy(),
                                  np.asarray(jquant.block_dequantize(want)))
    with pytest.raises(ValueError):
        tquant.block_quantize(x[:, :40], getattr(QuantScheme, scheme))
