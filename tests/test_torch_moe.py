"""The PyTorch port's mixture of experts against the JAX package, on the CPU
(plain versions of the kernels) at tiny sizes with the same weights.

Gates: stacked [E, K, N] expert weights and MoE init_params byte-identical
in every weight mode; moe_ffn_block and moe_ffn_block_routed within the JAX
package's own MoE tolerance (rtol 2e-2, atol 2e-3; tests/test_moe_pp.py),
dropped tokens included; llama_forward logits cosine >= 0.999 under the
three dispatch settings; the engine's batched decode refusing an MoE model
where the JAX engine's fails."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from csinn2_tpu.llm import model as jm
from csinn2_tpu.llm.config import LlamaConfig as JConfig
from csinn2_tpu.llm.engine import InferenceEngine as JEngine
from csinn2_tpu.utils.verify import cosine_similarity
from csinn2_tpu_torch.llm import model as tm
from csinn2_tpu_torch.llm.config import LlamaConfig as TConfig
from csinn2_tpu_torch.llm.engine import InferenceEngine
from csinn2_tpu_torch.llm.params import params_from_numpy

torch.set_num_threads(2)

ALL_MODES = [jm.FLOAT, jm.INT8_CHANNEL, jm.INT4_CHANNEL, jm.Q8_0, jm.Q4_0]
TOL = dict(rtol=2e-2, atol=2e-3)


def _cfgs(n_experts=4, **kw):
    return (dataclasses.replace(JConfig.tiny_moe(n_experts=n_experts), **kw),
            dataclasses.replace(TConfig.tiny_moe(n_experts=n_experts), **kw))


def _np(a):
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _tnp(t):
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _same_qweight(jq, tq):
    assert (tq.mode, tq.packed, tq.layout) == (jq.mode, jq.packed, jq.layout)
    assert tuple(tq.shape) == tuple(jq.shape)
    assert np.array_equal(_tnp(tq.values), _np(jq.values))
    assert (tq.scales is None) == (jq.scales is None)
    if jq.scales is not None:
        assert np.array_equal(_tnp(tq.scales), _np(jq.scales))


def _port(jp):
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), device="cpu")


def _layer(jp):
    """(JAX layer params, the port's copy) of layer 0."""
    jl = jp["layers"][0]
    return jl, _port(jl)


def _x(shape, seed=0):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).to(torch.bfloat16)


@pytest.mark.parametrize("mode", ALL_MODES)
def test_stacked_quantize_weight_bytes_match_jax(mode):
    w = (np.random.default_rng(5).standard_normal((3, 64, 48)) * 0.1).astype(np.float32)
    jq = jm.quantize_weight(w, mode)
    tq = tm.quantize_weight(w, mode, device="cpu")
    _same_qweight(jq, tq)
    if mode in tm.INT4_MODES:
        assert tuple(tq.values.shape) == (3, 32, 48)          # packed [E, K/2, N]
    # the device quantizer takes leading dims: each expert as on its own
    dq = tm.quantize_weight_device(torch.from_numpy(w), mode)
    _same_qweight(jq, dq)
    for e in range(3):
        one = tm.quantize_weight_device(torch.from_numpy(w[e]), mode)
        assert torch.equal(one.values, dq.values[e])


@pytest.mark.parametrize("mode", ALL_MODES)
def test_moe_init_params_bytes_match_jax(mode):
    jcfg, tcfg = _cfgs()
    jp = jm.init_params(jcfg, mode, seed=7)
    tp = tm.init_params(tcfg, mode, seed=7, device="cpu")
    assert np.array_equal(_tnp(tp["tok_embedding"]), _np(jp["tok_embedding"]))
    _same_qweight(jp["output"], tp["output"])
    for jl, tl in zip(jp["layers"], tp["layers"]):
        assert list(tl) == list(jl)                  # same keys, same order
        assert tl["gate"].dtype == torch.float32
        assert np.array_equal(_tnp(tl["gate"]), _np(jl["gate"]))
        for k in ("wq", "wk", "wv", "wo", "w1", "w2", "w3"):
            _same_qweight(jl[k], tl[k])
        assert tuple(tl["w1"].shape) == (4, tcfg.dim, tcfg.ffn_dim)


@pytest.mark.parametrize("mode", [jm.Q8_0, jm.Q4_0])
def test_moe_quantize_params_and_numpy_carry_match_jax(mode):
    jcfg, tcfg = _cfgs()
    jp = jm.quantize_params(jm.init_params(jcfg, jm.FLOAT, seed=2), mode)
    tp = tm.quantize_params(tm.init_params(tcfg, jm.FLOAT, seed=2, device="cpu"), mode)
    carried = _port(jp)
    for jl, tl, cl in zip(jp["layers"], tp["layers"], carried["layers"]):
        assert np.array_equal(_tnp(tl["gate"]), _np(jl["gate"]))
        assert np.array_equal(_tnp(cl["gate"]), _np(jl["gate"]))
        for k in ("w1", "w2", "w3"):
            _same_qweight(jl[k], tl[k])
            _same_qweight(jl[k], cl[k])


def test_fused_moe_layer_keeps_experts_unfused():
    _, tcfg = _cfgs()
    lp = tm.fuse_layer_weights(tm.init_params(tcfg, jm.Q8_0, seed=0, device="cpu")["layers"][0])
    assert "wqkv" in lp and "w13" not in lp
    assert {"gate", "w1", "w2", "w3"} <= set(lp)


@pytest.mark.parametrize("mode", [jm.Q8_0, jm.Q4_0, jm.INT8_CHANNEL])
def test_expert_slice_is_a_view(mode):
    _, tcfg = _cfgs()
    qw = tm.init_params(tcfg, mode, seed=0, device="cpu")["layers"][0]["w2"]
    for e in range(4):
        sl = tm._expert_slice(qw, e)
        assert sl.values.is_contiguous() and sl.scales.is_contiguous()
        assert sl.values.data_ptr() == qw.values.data_ptr() + e * qw.values[0].nbytes
        assert sl.scales.data_ptr() == qw.scales.data_ptr() + e * qw.scales[0].nbytes


@pytest.mark.parametrize("mode", [jm.FLOAT, jm.Q8_0, jm.Q4_0])
def test_moe_ffn_block_matches_jax(mode):
    jcfg, tcfg = _cfgs()
    jl, tl = _layer(jm.init_params(jcfg, mode, seed=3))
    jx, tx = _x((2, 5, jcfg.dim))
    want = np.asarray(jm.moe_ffn_block(jx, jl, jcfg, use_pallas=False), np.float32)
    got = tm.moe_ffn_block(tx, tl, tcfg)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("mode", [jm.FLOAT, jm.Q8_0, jm.Q4_0])
@pytest.mark.parametrize("factor", ["E/k", 2.0, 0.25])
def test_moe_ffn_block_routed_matches_jax(mode, factor):
    """cap = T at E/k (nothing dropped), the production 2.0, and 0.25, where
    pairs are dropped and the kept weights renormalized."""
    jcfg, tcfg = _cfgs()
    cf = jcfg.n_experts / jcfg.moe_top_k if factor == "E/k" else factor
    jl, tl = _layer(jm.init_params(jcfg, mode, seed=3))
    jx, tx = _x((2, 24, jcfg.dim), seed=1)
    want = np.asarray(jm.moe_ffn_block_routed(jx, jl, jcfg, use_pallas=False,
                                              capacity_factor=cf), np.float32)
    got = tm.moe_ffn_block_routed(tx, tl, tcfg, capacity_factor=cf)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    dense = tm.moe_ffn_block(tx, tl, tcfg).numpy()
    if factor == "E/k":                          # cap = T: the dense result
        np.testing.assert_allclose(got.numpy(), dense, **TOL)
    if factor == 0.25:                           # 6 slots for 24 picks an expert
        assert tm.moe_capacity(48, tcfg, cf) == 6
        assert not np.allclose(got.numpy(), dense, **TOL)


def test_moe_routed_skewed_router_matches_jax():
    """tests/test_moe_pp.py's skewed router: experts 0 and 1 overloaded past
    cap = T/2 at factor 2.0, so real drops occur."""
    jcfg, tcfg = _cfgs(n_experts=8)
    jl, _ = _layer(jm.init_params(jcfg, jm.FLOAT, seed=3))
    jl = dict(jl)
    gate = np.array(jl["gate"], np.float32, copy=True)
    gate[:, 0] += 4.0
    gate[:, 1] += 3.0
    jl["gate"] = jnp.asarray(gate)
    tl = _port(jl)
    jx, tx = _x((1, 256, jcfg.dim))
    want = np.asarray(jm.moe_ffn_block_routed(jx, jl, jcfg, use_pallas=False,
                                              capacity_factor=2.0), np.float32)
    got = tm.moe_ffn_block_routed(tx, tl, tcfg, capacity_factor=2.0).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    dense = tm.moe_ffn_block(tx, tl, tcfg).numpy()
    assert cosine_similarity(got.ravel(), dense.ravel()) >= 0.99


@pytest.mark.parametrize("block", ["dense", "routed"])
def test_moe_all_tied_gate_matches_jax(block):
    """A zero gate ties every expert: jax.lax.top_k takes the lowest indices
    (0 and 1) and so must the port; routed at factor 1.0 then fills both
    experts' buffers (cap = T/2) and drops the rest."""
    jcfg, tcfg = _cfgs()
    jl, _ = _layer(jm.init_params(jcfg, jm.Q8_0, seed=4))
    jl = dict(jl, gate=jnp.zeros_like(jl["gate"]))
    tl = _port(jl)
    jx, tx = _x((1, 16, jcfg.dim), seed=2)
    _, ji = jax.lax.top_k(jnp.zeros((3, 4)), 2)
    ti, tw = tm._gate_top_k(torch.zeros(3, 16), torch.zeros(16, 4), 2)
    assert np.array_equal(ti.numpy(), np.asarray(ji)) and np.all(ti.numpy() == [0, 1])
    assert torch.all(tw == 0.5)
    if block == "dense":
        want = jm.moe_ffn_block(jx, jl, jcfg, use_pallas=False)
        got = tm.moe_ffn_block(tx, tl, tcfg)
    else:
        want = jm.moe_ffn_block_routed(jx, jl, jcfg, use_pallas=False, capacity_factor=1.0)
        got = tm.moe_ffn_block_routed(tx, tl, tcfg, capacity_factor=1.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32), **TOL)


def test_moe_routed_drops_vanish_as_in_jax():
    """The pairs past a buffer's capacity contribute nothing: a token whose
    two picks are both dropped comes out 0, exactly, in both packages."""
    jcfg, tcfg = _cfgs()
    jl, _ = _layer(jm.init_params(jcfg, jm.FLOAT, seed=4))
    jl = dict(jl, gate=jnp.zeros_like(jl["gate"]))   # every token picks 0 and 1
    tl = _port(jl)
    jx, tx = _x((1, 16, jcfg.dim), seed=3)
    want = np.asarray(jm.moe_ffn_block_routed(jx, jl, jcfg, use_pallas=False,
                                              capacity_factor=0.25), np.float32)
    got = tm.moe_ffn_block_routed(tx, tl, tcfg, capacity_factor=0.25).numpy()
    cap = tm.moe_capacity(16, tcfg, 0.25)
    assert cap == 2
    assert np.all(got[0, cap:] == 0) and np.all(want[0, cap:] == 0)
    assert np.all(np.abs(got[0, :cap]).max(axis=-1) > 0)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("mode", [jm.Q8_0, jm.Q4_0])
@pytest.mark.parametrize("dispatch", ["auto", "dense", "routed"])
@pytest.mark.parametrize("T", [8, 256])
def test_moe_llama_forward_matches_jax(mode, dispatch, T):
    jcfg, tcfg = _cfgs(max_seq_len=512, moe_dispatch=dispatch)
    jp = jm.init_params(jcfg, mode, seed=1)
    tp = _port(jp)
    toks = np.random.default_rng(T).integers(0, jcfg.vocab_size, (1, T)).astype(np.int32)
    jc = jm.KVCache.create(jcfg, 1, quantized=True)
    want, _ = jm.llama_forward(jp, jnp.asarray(toks), jc, 0, jcfg, use_pallas=False)
    tc = tm.KVCache.create(tcfg, 1, quantized=True, device="cpu")
    got, _ = tm.llama_forward(tp, torch.from_numpy(toks), tc, 0, tcfg)
    assert got.shape == (1, T, tcfg.vocab_size)
    cs = cosine_similarity(got.numpy(), np.asarray(want))
    assert cs >= 0.999, cs
    assert tm.moe_routed(tcfg, T) == (dispatch == "routed" or (dispatch == "auto" and T >= 256))


def test_moe_engine_prefills_and_refuses_the_batched_decode():
    """The JAX engine's batched decode has no MoE branch and fails on the
    stacked experts; the port's raises a ValueError there.  Prefill, through
    llama_forward, serves MoE in both, with the same logits."""
    jcfg, tcfg = _cfgs()
    jp = jm.init_params(jcfg, jm.Q8_0, seed=5)
    je = JEngine(jcfg, jp, batch=1, use_pallas=False)
    te = InferenceEngine(tcfg, _port(jp), batch=1, device="cpu")
    prompt = [3, 9, 27, 4, 1]
    cs = cosine_similarity(te.prefill(0, prompt), np.asarray(je.prefill(0, prompt)))
    assert cs >= 0.999, cs
    with pytest.raises(Exception):
        je.decode_step({0: 7})
    with pytest.raises(ValueError, match="MoE"):
        te.decode_step({0: 7})
    with pytest.raises(ValueError, match="MoE"):
        te.generate_fused(prompt, max_new_tokens=2)


@pytest.mark.parametrize("mode", ["float", "q4_0"])
def test_moe_dispatch_probe_on_the_cpu(mode):
    """The probe's function at a small width on the CPU: a record a token
    count, each with the routed buffers' capacity and a winner."""
    from csinn2_tpu_torch.examples.moe_dispatch_probe import probe
    lines = []
    recs = probe(device="cpu", mode=mode, tokens=(8, 256), dim=64, ffn=128, log=lines.append)
    assert [(r["T"], r["cap"]) for r in recs] == [(8, 4), (256, 128)]
    assert all(r["dense_ms"] > 0 and r["routed_ms"] > 0 and r["winner"] in ("dense", "routed")
               for r in recs)
    assert lines[-1].startswith("crossover: ")
