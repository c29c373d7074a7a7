"""Weights of the PyTorch port against the JAX package, in all five weight
modes: quantize_weight, init_params, quantize_params and fuse_params
(swiglu128 fusion included) give byte-identical values, scales, packing and
layouts; params_from_numpy carries a JAX params tree across bit for bit
(bfloat16 and packed int4 included)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from csinn2_tpu.llm import model as jm
from csinn2_tpu.llm.config import LlamaConfig as JConfig
from csinn2_tpu_torch.kernels.qmatmul import unpack_int4
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


ALL_MODES = [jm.FLOAT, jm.INT8_CHANNEL, jm.INT4_CHANNEL, jm.Q8_0, jm.Q4_0]
NEW_MODES = [jm.INT8_CHANNEL, jm.INT4_CHANNEL, jm.Q4_0]


def _leaves_jax(p):
    yield "tok_embedding", p["tok_embedding"]
    yield "norm", p["norm"]
    for i, lp in enumerate([{"output": p["output"]}] + list(p["layers"])):
        for k in sorted(lp):
            v = lp[k]
            if isinstance(v, jm.QWeight):
                yield f"{i}.{k}.kind", (v.mode, v.packed, v.layout, tuple(v.shape))
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
                yield f"{i}.{k}.kind", (v.mode, v.packed, v.layout, tuple(v.shape))
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
        if name.endswith(".kind"):
            assert a == t, (name, a, t)
            continue
        a, b = _jbytes(a), _tbytes(t)
        assert a.shape == b.shape and a.dtype == b.dtype, (name, a.shape, b.shape,
                                                          a.dtype, b.dtype)
        assert np.array_equal(a, b), name


@pytest.mark.parametrize("mode", ALL_MODES)
@pytest.mark.parametrize("shape", [(64, 48), (96, 160), (320, 32)])
def test_quantize_weight_bytes(rng, mode, shape):
    w = (rng.standard_normal(shape) * 0.02).astype(np.float32)
    w[:32, :5] = 0.0                       # all-zero blocks: scale 0 branch
    jq = jm.quantize_weight(w, mode)
    tq = tm.quantize_weight(w, mode, device="cpu")
    assert (tq.mode, tq.packed, tq.shape) == (jq.mode, jq.packed, tuple(jq.shape))
    assert tq.packed == (mode in (jm.INT4_CHANNEL, jm.Q4_0))
    assert np.array_equal(_jbytes(jq.values), _tbytes(tq.values))
    if mode != jm.FLOAT:
        assert tq.values.dtype == torch.int8 and tq.scales.dtype == torch.float32
        assert np.array_equal(_jbytes(jq.scales), _tbytes(tq.scales))
    else:
        assert tq.scales is None and tq.values.dtype == torch.bfloat16


@pytest.mark.parametrize("mode", [jm.INT8_CHANNEL, jm.INT4_CHANNEL])
def test_quantize_weight_channel_odd_k(rng, mode):
    """K % 32 != 0: the channel modes keep the unpacked int8 carrier, as
    JAX does, and the carrier stays within [-bound-1, bound]."""
    w = (rng.standard_normal((40, 24)) * 0.02).astype(np.float32)
    jq = jm.quantize_weight(w, mode)
    tq = tm.quantize_weight(w, mode, device="cpu")
    assert not tq.packed and not jq.packed and tq.shape == (40, 24)
    assert np.array_equal(_jbytes(jq.values), _tbytes(tq.values))
    assert np.array_equal(_jbytes(jq.scales), _tbytes(tq.scales))
    bound = 127 if mode == jm.INT8_CHANNEL else 7
    assert -bound - 1 <= int(tq.values.min()) and int(tq.values.max()) <= bound


@pytest.mark.parametrize("mode", ALL_MODES)
def test_quantize_weight_device_matches_host(rng, mode):
    """The on-device quantizer (init_params_device's) rounds as the host
    one does, at the JAX test's tolerance (tests/test_llm.py:167-188: the
    carriers within 1, the scales within rtol 3e-7); packing included."""
    w = (rng.standard_normal((128, 96)) * 0.02).astype(np.float32)
    w[32:64, 7] = 0.0
    host = tm.quantize_weight(w, mode, device="cpu")
    dev = tm.quantize_weight_device(torch.from_numpy(w), mode)
    assert (dev.mode, dev.packed, dev.shape) == (host.mode, host.packed, host.shape)
    if mode == jm.FLOAT:
        assert np.array_equal(_tbytes(host.values), _tbytes(dev.values))
        return
    unpack = (lambda v: unpack_int4(v, 128)) if host.packed else (lambda v: v)
    np.testing.assert_allclose(unpack(host.values).numpy().astype(np.int32),
                               unpack(dev.values).numpy().astype(np.int32), atol=1)
    np.testing.assert_allclose(host.scales.numpy(), dev.scales.numpy(), rtol=3e-7)


@pytest.mark.parametrize("mode", ALL_MODES)
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


@pytest.mark.parametrize("mode", ALL_MODES)
def test_fuse_params_bytes(monkeypatch, mode):
    monkeypatch.delenv("CSINN2_SWIGLU_FUSE", raising=False)
    jcfg, tcfg = _cfgs("gqa")
    jf = jm.fuse_params(jm.init_params(jcfg, mode, seed=3))
    tf = tm.fuse_params(tm.init_params(tcfg, mode, seed=3, device="cpu"))
    assert sorted(tf["layers"][0]) == sorted(jf["layers"][0])
    _assert_same_params(jf, tf)


@pytest.mark.parametrize("mode", ALL_MODES)
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
    """Stacked MoE weights [E, K, N], once refused, now quantize per expert
    and stack on axis 0 with the JAX package's bytes (packed int4 as
    [E, K/2, N]); tests/test_torch_moe.py holds every mode."""
    w = rng.standard_normal((2, 64, 32)).astype(np.float32)
    jq = jm.quantize_weight(w, mode)
    tq = tm.quantize_weight(w, mode, device="cpu")
    assert (tq.mode, tq.packed, tuple(tq.shape)) == (jq.mode, jq.packed, (2, 64, 32))
    assert np.array_equal(_tbytes(tq.values), _jbytes(jq.values))
    assert np.array_equal(_tbytes(tq.scales), _jbytes(jq.scales))


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


@pytest.mark.parametrize("mode", NEW_MODES)
def test_quantize_params_bytes_modes(mode):
    jcfg, tcfg = _cfgs("mha")
    jq = jm.quantize_params(jm.init_params(jcfg, jm.FLOAT, seed=2), mode)
    tq = tm.quantize_params(tm.init_params(tcfg, tm.FLOAT, seed=2, device="cpu"), mode)
    _assert_same_params(jq, tq)


@pytest.mark.parametrize("mode", ALL_MODES)
def test_fuse_params_swiglu_bytes(monkeypatch, mode):
    """CSINN2_SWIGLU_FUSE=1: w13 in the swiglu128 pair layout (F 128 padded
    to 512) and w2 K-padded to match, with JAX's keys and bytes."""
    monkeypatch.setenv("CSINN2_SWIGLU_FUSE", "1")
    jcfg, tcfg = _cfgs("gqa")
    jf = jm.fuse_params(jm.init_params(jcfg, mode, seed=3))
    tf = tm.fuse_params(tm.init_params(tcfg, mode, seed=3, device="cpu"))
    lp = tf["layers"][0]
    assert sorted(lp) == sorted(jf["layers"][0])
    assert lp["w13"].layout == "swiglu128" and lp["w13"].shape == (64, 1024)
    assert lp["w2"].shape == (512, 64)
    _assert_same_params(jf, tf)


@pytest.mark.parametrize("mode", [jm.Q8_0, jm.Q4_0, jm.INT4_CHANNEL])
@pytest.mark.parametrize("F,pad_to", [(384, 512), (256, 128)])
def test_qweight_concat_swiglu_and_pad_rows_bytes(rng, mode, F, pad_to):
    K = 64
    ws = [(rng.standard_normal((K, F)) * 0.05).astype(np.float32) for _ in range(2)]
    w2 = (rng.standard_normal((F, 32)) * 0.05).astype(np.float32)
    j13 = jm.qweight_concat_swiglu(*[jm.quantize_weight(w, mode) for w in ws], pad_to=pad_to)
    t13 = tm.qweight_concat_swiglu(*[tm.quantize_weight(w, mode, device="cpu") for w in ws],
                                   pad_to=pad_to)
    assert (t13.layout, t13.packed, t13.shape) == (j13.layout, j13.packed, tuple(j13.shape))
    assert np.array_equal(_jbytes(j13.values), _tbytes(t13.values))
    assert np.array_equal(_jbytes(j13.scales), _tbytes(t13.scales))
    Fp = t13.shape[-1] // 2
    j2 = jm._pad_rows_qw(jm.quantize_weight(w2, mode), Fp)
    t2 = tm._pad_rows_qw(tm.quantize_weight(w2, mode, device="cpu"), Fp)
    assert t2.shape == tuple(j2.shape) == (Fp, 32)
    assert np.array_equal(_jbytes(j2.values), _tbytes(t2.values))
    assert np.array_equal(_jbytes(j2.scales), _tbytes(t2.scales))


@pytest.mark.parametrize("mode", [jm.Q8_0, jm.Q4_0, jm.INT4_CHANNEL])
def test_params_from_numpy_carries_swiglu128(monkeypatch, mode):
    """JAX params fused with CSINN2_SWIGLU_FUSE=1 cross bit for bit, packed
    bytes and the swiglu128 layout included."""
    monkeypatch.setenv("CSINN2_SWIGLU_FUSE", "1")
    jcfg, _ = _cfgs("gqa")
    jf = jm.fuse_params(jm.init_params(jcfg, mode, seed=6))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jf), device="cpu")
    assert tp["layers"][0]["w13"].layout == "swiglu128"
    _assert_same_params(jf, tp)
