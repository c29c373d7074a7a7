"""Weights of the PyTorch port against the JAX package: quantize_weight,
init_params, quantize_params and fuse_params give byte-identical values and
scales; params_from_numpy carries a JAX params tree across bit for bit
(bfloat16 included)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from csinn2_tpu.llm import model as jm
from csinn2_tpu.llm.config import LlamaConfig as JConfig
from csinn2_tpu_torch.llm import model as tm
from csinn2_tpu_torch.llm.config import LlamaConfig as TConfig
from csinn2_tpu_torch.llm.params import params_from_numpy, tensor_from_numpy
from csinn2_tpu_torch.utils.device import resolve_device

torch.set_num_threads(2)

MHA = dict(dim=64, n_layers=2, n_heads=4, n_kv_heads=4, ffn_dim=128,
           vocab_size=256, max_seq_len=128)


def _cfgs(name):
    if name == "gqa":
        return JConfig.tiny(), TConfig.tiny()
    return JConfig(**MHA), TConfig(**MHA)


def _jbytes(a):
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _tbytes(t):
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _leaves_jax(p):
    yield "tok_embedding", p["tok_embedding"]
    yield "norm", p["norm"]
    for i, lp in enumerate([{"output": p["output"]}] + list(p["layers"])):
        for k in sorted(lp):
            v = lp[k]
            if isinstance(v, jm.QWeight):
                yield f"{i}.{k}.values", v.values
                if v.scales is not None:
                    yield f"{i}.{k}.scales", v.scales
            else:
                yield f"{i}.{k}", v


def _leaves_torch(p):
    yield "tok_embedding", p["tok_embedding"]
    yield "norm", p["norm"]
    for i, lp in enumerate([{"output": p["output"]}] + list(p["layers"])):
        for k in sorted(lp):
            v = lp[k]
            if isinstance(v, tm.QWeight):
                yield f"{i}.{k}.values", v.values
                if v.scales is not None:
                    yield f"{i}.{k}.scales", v.scales
            else:
                yield f"{i}.{k}", v


def _assert_same_params(jp, tp):
    jl = list(_leaves_jax(jp))
    tl = list(_leaves_torch(tp))
    assert [n for n, _ in jl] == [n for n, _ in tl]
    for (name, a), (_, t) in zip(jl, tl):
        a, b = _jbytes(a), _tbytes(t)
        assert a.shape == b.shape and a.dtype == b.dtype, (name, a.shape, b.shape,
                                                          a.dtype, b.dtype)
        assert np.array_equal(a, b), name


@pytest.mark.parametrize("mode", [jm.FLOAT, jm.Q8_0])
@pytest.mark.parametrize("shape", [(64, 48), (96, 160), (320, 32)])
def test_quantize_weight_bytes(rng, mode, shape):
    w = (rng.standard_normal(shape) * 0.02).astype(np.float32)
    w[:32, :5] = 0.0                       # all-zero blocks: scale 0 branch
    jq = jm.quantize_weight(w, mode)
    tq = tm.quantize_weight(w, mode, device="cpu")
    assert tq.mode == jq.mode
    assert np.array_equal(_jbytes(jq.values), _tbytes(tq.values))
    if mode == jm.Q8_0:
        assert tq.values.dtype == torch.int8 and tq.scales.dtype == torch.float32
        assert np.array_equal(_jbytes(jq.scales), _tbytes(tq.scales))
    else:
        assert tq.scales is None and tq.values.dtype == torch.bfloat16


@pytest.mark.parametrize("mode", [jm.FLOAT, jm.Q8_0])
def test_quantize_weight_device_matches_host(rng, mode):
    """The on-device quantizer (init_params_device's) rounds as the host
    one does."""
    w = (rng.standard_normal((128, 96)) * 0.02).astype(np.float32)
    w[32:64, 7] = 0.0
    host = tm.quantize_weight(w, mode, device="cpu")
    dev = tm.quantize_weight_device(torch.from_numpy(w), mode)
    assert np.array_equal(_tbytes(host.values), _tbytes(dev.values))
    if mode == jm.Q8_0:
        assert np.array_equal(_tbytes(host.scales), _tbytes(dev.scales))


@pytest.mark.parametrize("mode", [jm.FLOAT, jm.Q8_0])
@pytest.mark.parametrize("cfg_name", ["gqa", "mha"])
def test_init_params_bytes(mode, cfg_name):
    jcfg, tcfg = _cfgs(cfg_name)
    _assert_same_params(jm.init_params(jcfg, mode, seed=5),
                        tm.init_params(tcfg, mode, seed=5, device="cpu"))


def test_quantize_params_bytes():
    jcfg, tcfg = _cfgs("gqa")
    jq = jm.quantize_params(jm.init_params(jcfg, jm.FLOAT, seed=2), jm.Q8_0)
    tq = tm.quantize_params(tm.init_params(tcfg, tm.FLOAT, seed=2, device="cpu"),
                            tm.Q8_0)
    _assert_same_params(jq, tq)


@pytest.mark.parametrize("mode", [jm.FLOAT, jm.Q8_0])
def test_fuse_params_bytes(monkeypatch, mode):
    monkeypatch.delenv("CSINN2_SWIGLU_FUSE", raising=False)
    jcfg, tcfg = _cfgs("gqa")
    jf = jm.fuse_params(jm.init_params(jcfg, mode, seed=3))
    tf = tm.fuse_params(tm.init_params(tcfg, mode, seed=3, device="cpu"))
    assert sorted(tf["layers"][0]) == sorted(jf["layers"][0])
    _assert_same_params(jf, tf)


@pytest.mark.parametrize("mode", [jm.FLOAT, jm.Q8_0])
def test_params_from_numpy_roundtrip(mode):
    jcfg, _ = _cfgs("gqa")
    jp = jm.init_params(jcfg, mode, seed=4)
    tree = jax.tree_util.tree_map(np.asarray, jp)
    assert tree["tok_embedding"].dtype.name == "bfloat16"
    tp = params_from_numpy(tree, device="cpu")
    assert tp["tok_embedding"].dtype == torch.bfloat16
    _assert_same_params(jp, tp)


def test_tensor_from_numpy_bfloat16_bits():
    a = np.asarray(jnp.asarray([1.0, -2.5, 3.140625, 1e-3, 65504.0], jnp.bfloat16))
    t = tensor_from_numpy(a, "cpu")
    assert t.dtype == torch.bfloat16
    assert np.array_equal(_tbytes(t), a.view(np.uint16))
    assert np.array_equal(t.float().numpy(), a.astype(np.float32))


@pytest.mark.parametrize("mode", [jm.INT8_CHANNEL, jm.Q4_0])
def test_unported_modes_raise(rng, mode):
    w = rng.standard_normal((64, 32)).astype(np.float32)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tm.quantize_weight(w, mode, device="cpu")


def test_device_default_needs_cuda(monkeypatch):
    """Entry points default to the card and refuse to fall back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tcfg = _cfgs("gqa")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tm.init_params(tcfg, tm.Q8_0, seed=0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tm.init_params_device(tcfg, tm.Q8_0, seed=0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tm.KVCache.create(tcfg, 1, quantized=True)
    assert resolve_device("cpu").type == "cpu"
