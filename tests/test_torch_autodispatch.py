"""The op API's hand-kernel tier in the PyTorch port (kernels/autodispatch.py)
against the JAX package: the registry's choices (the analogs of
tests/test_autodispatch.py, with "on a TPU" read as "on a CUDA device"),
block-quantized fullyconnected / matmul and scaled_dot_product_attention in
layer and GRAPH mode against the JAX op on the CPU, and the CUDA-tier
callbacks, called on CPU tensors (their kernels' plain versions), against
the arithmetic of the JAX package's Pallas-tier callbacks (their kernels in
interpret mode).

Gates: GEMM outputs cosine >= 0.9999; attention verify(tol=2e-2,
min_cosine=0.9999); an int8 out_qinfo within 1 LSB."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import csinn2_tpu.kernels.autodispatch as jad
import csinn2_tpu.ops as jops
from csinn2_tpu.core import quant as jquant
from csinn2_tpu.core.dtypes import QuantScheme as JScheme
from csinn2_tpu.core.tensor import Tensor as JTensor
from csinn2_tpu.kernels.flash_attention import flash_attention as jax_flash
from csinn2_tpu.kernels.qmatmul import quant_matmul as jax_qmm
from csinn2_tpu.utils.verify import cosine_similarity, verify
import csinn2_tpu_torch.kernels.autodispatch as tad
import csinn2_tpu_torch.ops as tops
from csinn2_tpu_torch.core import quant as tquant
from csinn2_tpu_torch.core.dtypes import Api, Dtype, Layout, MemType, QuantScheme, RunMode
from csinn2_tpu_torch.core.quant import QuantInfo
from csinn2_tpu_torch.core.tensor import Tensor, TensorMeta
from csinn2_tpu_torch.ops.registry import registry
from csinn2_tpu_torch.runtime.session import Session

torch.set_num_threads(2)

CUDA = torch.device("cuda")      # a device name only: no card is touched
CPU = torch.device("cpu")


def _meta(shape, mem_type=MemType.DEFAULT):
    return TensorMeta(shape=shape, dtype=Dtype.FLOAT32, mem_type=mem_type)


# -- the registry's choices ---------------------------------------------------------

@pytest.mark.parametrize("shape,params,device,want", [
    ((1, 8, 1024, 128), None, CUDA, Api.CUDA),                 # long: the kernel
    ((1, 8, 32, 64), None, CUDA, Api.TORCH),                   # tiny: plain ops
    ((1, 8, 4096, 128), None, CPU, Api.TORCH),                 # long, on the CPU
    ((4, 32, 1, 128), dict(pos_offset=100, kv_len=101), CUDA, Api.CUDA),   # decode
    ((1, 8, 1024, 256), None, CUDA, Api.CUDA),                 # d = 256: as the JAX caps
    ((1, 8, 1024, 96), None, CUDA, Api.CUDA),                  # d = 96: as the JAX caps
    ((1, 8, 1024, 320), None, CUDA, Api.TORCH),                # d > 256: not the kernel's
    ((2, 4, 1, 16), dict(pos_offset=20, kv_len=21), CUDA, Api.CUDA),   # tiny decode, d = 16
])
def test_sdpa_lookup(shape, params, device, want):
    metas = [_meta(shape), _meta(shape[:2] + (max(shape[2], 512),) + shape[3:]), _meta(shape)]
    p = tops.SDPAParams(**params) if params else None
    cb = registry.lookup("scaled_dot_product_attention", api=Api.AUTO, metas=metas, params=p,
                         device=device)
    assert cb.api == want


@pytest.mark.parametrize("op", ["matmul", "fullyconnected"])
def test_block_quant_routes_cuda_on_a_cuda_device(op):
    metas = [_meta((4, 256)), _meta((512, 256), MemType.BLOCK_Q8_0)]
    cb = registry.lookup(op, api=Api.AUTO, metas=metas, device=CUDA)
    assert cb.api == Api.CUDA and cb.quant_direct
    assert registry.lookup(op, api=Api.AUTO, metas=metas, device=CPU).api == Api.TORCH
    plain = [_meta((4, 256)), _meta((512, 256))]
    assert registry.lookup(op, api=Api.AUTO, metas=plain, device=CUDA).api == Api.TORCH


def test_explicit_api_request_bypasses_cost_model():
    assert registry.lookup("scaled_dot_product_attention", api=Api.TORCH,
                           metas=None).api == Api.TORCH
    assert registry.lookup("fullyconnected", api=Api.CUDA, metas=None).api == Api.CUDA


# -- block-quantized GEMMs ----------------------------------------------------------

def _block_weight(rng, scheme, N=128, K=256):
    wf = (rng.standard_normal((N, K)) * 0.1).astype(np.float32)
    jb = jquant.block_quantize(wf, getattr(JScheme, scheme))
    tb = tquant.block_quantize(wf, getattr(QuantScheme, scheme))
    return JTensor(block=jb), Tensor(block=tb)


def _graph_run(api, op, x, w, b, trans_b=True):
    sess = Session(run_mode=RunMode.GRAPH, api=api, device="cpu")
    with sess.build():
        xi = sess.input(TensorMeta(shape=x.shape, dtype=Dtype.FLOAT32))
        y = tops.fullyconnected(xi, w, b) if op == "fullyconnected" else \
            tops.matmul(xi, w, tops.MatmulParams(trans_b=trans_b))
        sess.set_output(y)
    sess.setup()
    return sess, sess.run(x)


@pytest.mark.parametrize("scheme", ["BLOCK_Q8_0", "BLOCK_Q4_0"])
@pytest.mark.parametrize("op", ["fullyconnected", "matmul"])
@pytest.mark.parametrize("mode", ["layer", "graph"])
def test_block_ops_match_jax(rng, scheme, op, mode):
    """The JAX op on the CPU (its XLA tier: dequantize, f32 matmul) against
    the port in layer mode and in a GRAPH session, each on the CPU (TORCH
    tier) and forced onto the CUDA tier's callback (the transposed
    quant_matmul's plain version)."""
    jw, tw = _block_weight(rng, scheme)
    x = rng.standard_normal((8, 256)).astype(np.float32)
    bias = rng.standard_normal(128).astype(np.float32) if op == "fullyconnected" else None
    if op == "fullyconnected":
        want = jops.fullyconnected(JTensor(x), jw, None if bias is None else JTensor(bias))
    else:
        want = jops.matmul(JTensor(x), jw, jops.MatmulParams(trans_b=True))
    want = np.asarray(want.data)
    tb = None if bias is None else Tensor(bias)
    for api in (Api.AUTO, Api.CUDA):
        if mode == "layer":
            sess = Session(run_mode=RunMode.LAYER, api=api, device="cpu")
            with sess.build():
                y = tops.fullyconnected(Tensor(x), tw, tb) if op == "fullyconnected" else \
                    tops.matmul(Tensor(x), tw, tops.MatmulParams(trans_b=True))
            got = y.data
        else:
            sess, got = _graph_run(api, op, x, tw, tb)
            want_cb = f"{op}:{'cuda' if api == Api.CUDA else 'torch'}"
            assert [n.cb_name for n in sess.graph.nodes] == [want_cb]
            # the pair moved once, its scales widened to f32
            (values, scales), = [v for v in sess._consts.values() if isinstance(v, tuple)]
            assert values.dtype == torch.int8 and scales.dtype == torch.float32
        assert tuple(got.shape) == (8, 128)
        cs = cosine_similarity(got.float().numpy(), want)
        assert cs >= 0.9999, (api, cs)


@pytest.mark.parametrize("scheme", ["BLOCK_Q8_0", "BLOCK_Q4_0"])
@pytest.mark.parametrize("int8_out", [False, True])
def test_block_callback_matches_jax_pallas_callback(rng, monkeypatch, scheme, int8_out):
    """The port's CUDA-tier _block_matmul on CPU tensors against the JAX
    _block_matmul with its kernel in interpret mode: f32 at cosine >= 0.9999,
    an int8 out_qinfo within 1 LSB (JAX divides by the scale eagerly here;
    the port multiplies by its f32 reciprocal, as a compiled graph does)."""
    monkeypatch.setattr(jad, "quant_matmul", functools.partial(jax_qmm, interpret=True))
    jw, tw = _block_weight(rng, scheme)
    x = rng.standard_normal((8, 256)).astype(np.float32)
    bias = rng.standard_normal(128).astype(np.float32)
    jq = tq = None
    if int8_out:
        from csinn2_tpu.core.dtypes import Dtype as JDtype
        from csinn2_tpu.core.quant import QuantInfo as JQuantInfo
        jq = JQuantInfo(scale=0.05, zero_point=0, dtype=JDtype.INT8)
        tq = QuantInfo(scale=0.05, zero_point=0, dtype=Dtype.INT8)
    want = np.asarray(jad._block_matmul([jnp.asarray(x), tuple(jnp.asarray(a) for a in jw.data),
                                         jnp.asarray(bias)], None, None, jq))
    pair = tw.on_device("cpu")
    got = tad._block_matmul([torch.from_numpy(x), pair, torch.from_numpy(bias)], None, None,
                            tq).numpy()
    if int8_out:
        assert got.dtype == np.int8
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    else:
        assert cosine_similarity(got, want) >= 0.9999


def test_block_tensor_meta_matches_jax(rng):
    for scheme in ("BLOCK_Q8_0", "BLOCK_Q4_0"):
        jw, tw = _block_weight(rng, scheme)
        assert tw.meta.mem_type.value == jw.meta.mem_type.value
        assert tw.dtype.value == jw.dtype.value and tw.shape == jw.shape
        assert tw.meta.byte_size == jw.meta.byte_size
        assert tw.on_device("cpu") is tw.on_device("cpu")      # placed once


# -- scaled-dot-product attention ----------------------------------------------------

def _qkv(rng, b, hq, hk, sq, sk, d):
    bf = lambda a: np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))
    return (bf(rng.standard_normal((b, hq, sq, d))), bf(rng.standard_normal((b, hk, sk, d))),
            bf(rng.standard_normal((b, hk, sk, d))))


def _close(got, want):
    r = verify(np.asarray(got, np.float32), np.asarray(want, np.float32), tol=2e-2,
               min_cosine=0.9999)
    assert r.passed and r.cosine_sim >= 0.9999, r


@pytest.mark.parametrize("case", ["prefill", "decode"])
@pytest.mark.parametrize("mode", ["layer", "graph"])
def test_sdpa_op_matches_jax(rng, case, mode):
    """The op on both packages' plain tiers, and the port's CUDA-tier
    callback (forced) on the CPU: prefill causal at sq = sk, and decode over a
    cache with pos_offset / kv_len, GQA."""
    if case == "prefill":
        q, k, v = _qkv(rng, 1, 4, 2, 64, 64, 64)
        pj, pt = jops.SDPAParams(causal=True), tops.SDPAParams(causal=True)
    else:
        q, k, v = _qkv(rng, 2, 4, 2, 1, 96, 64)
        pj = jops.SDPAParams(causal=True, pos_offset=40, kv_len=41)
        pt = tops.SDPAParams(causal=True, pos_offset=40, kv_len=41)
    want = np.asarray(jops.scaled_dot_product_attention(
        JTensor(q), JTensor(k), JTensor(v), pj).data)
    for api in (Api.AUTO, Api.CUDA):
        if mode == "layer":
            sess = Session(run_mode=RunMode.LAYER, api=api, device="cpu")
            with sess.build():
                got = tops.scaled_dot_product_attention(Tensor(q), Tensor(k), Tensor(v), pt).data
        else:
            sess = Session(run_mode=RunMode.GRAPH, api=api, device="cpu")
            with sess.build():
                ins = [sess.input(TensorMeta(shape=a.shape, dtype=Dtype.FLOAT32))
                       for a in (q, k, v)]
                sess.set_output(tops.scaled_dot_product_attention(*ins, pt))
            sess.setup()
            assert sess.graph.nodes[0].cb_name.endswith("cuda" if api == Api.CUDA else "torch")
            got = sess.run(q, k, v)
        assert got.dtype == torch.float32 and tuple(got.shape) == q.shape
        _close(got.numpy(), want)


def test_sdpa_callback_matches_jax_pallas_callback(rng, monkeypatch):
    """The CUDA-tier callback on CPU tensors against the JAX Pallas tier's
    callback (flash_attention in interpret mode): bf16 q/k/v, f32 out."""
    monkeypatch.setattr(jad, "flash_attention", functools.partial(jax_flash, interpret=True))
    q, k, v = _qkv(rng, 2, 4, 2, 16, 128, 64)
    for p in (dict(causal=True, pos_offset=5, kv_len=21), dict(causal=False)):
        want = np.asarray(jad._sdpa_pallas(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                           jops.SDPAParams(**p)))
        got = tad._sdpa_cuda(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                             tops.SDPAParams(**p))
        assert got.dtype == torch.float32
        _close(got.numpy(), want)


def test_sdpa_tiers_differ_in_the_jax_package(rng, monkeypatch):
    """A causal call with sq < sk and neither pos_offset nor kv_len: the XLA
    tier offsets the queries by sk - sq, the Pallas tier passes q_offset 0
    (query i sees keys <= i).  The JAX package's own two tiers disagree; the
    port keeps each tier's semantics (ROADMAP queue C)."""
    monkeypatch.setattr(jad, "flash_attention", functools.partial(jax_flash, interpret=True))
    q, k, v = _qkv(rng, 1, 4, 4, 4, 64, 64)
    xla = np.asarray(jops.scaled_dot_product_attention(
        JTensor(q), JTensor(k), JTensor(v), jops.SDPAParams(causal=True)).data)
    pallas = np.asarray(jad._sdpa_pallas(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                         jops.SDPAParams(causal=True)))
    assert cosine_similarity(xla, pallas) < 0.9
    torch_tier = tops.scaled_dot_product_attention(Tensor(q), Tensor(k), Tensor(v),
                                                   tops.SDPAParams(causal=True)).data
    cuda_tier = tad._sdpa_cuda(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                               tops.SDPAParams(causal=True))
    _close(torch_tier.numpy(), xla)
    _close(cuda_tier.numpy(), pallas)
