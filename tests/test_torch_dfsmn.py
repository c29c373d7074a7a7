"""The PyTorch port's DFSMN streaming-ASR model (models/dfsmn_asr.py), its
cache ops and utils/memstats.py against the JAX package, on the CPU.

At tests/test_dfsmn_asr.py's small configs, seeded the same way:
  * the weight dicts equal, array for array;
  * offline logits, port against JAX, at rtol = atol = 2e-4;
  * streamed logits chunk by chunk (with lookahead, and causal with
    l_stride 2), port against JAX, at 2e-4; the port's stream equals its own
    offline run on the interior frames; the streaming state is pure;
  * the assembled FIR kernel against the port's fsmn op (1e-5);
  * the cache_matmul, cache_conv1d and fsmn goldens of
    tests/test_asr_memstats.py, each step's outputs against the JAX op's
    (1e-5, cache_conv1d 1e-4), and the memstats watermark.
"""

import numpy as np
import pytest
import torch

from csinn2_tpu.models.dfsmn_asr import DFSMNASR as JDFSMN
from csinn2_tpu.models.dfsmn_asr import DFSMNConfig as JConfig
from csinn2_tpu.ops import api as jops
from csinn2_tpu.ops import params as JP
from csinn2_tpu_torch.models.dfsmn_asr import DFSMNASR, DFSMNConfig
from csinn2_tpu_torch.ops import api as ops
from csinn2_tpu_torch.ops import params as P

torch.set_num_threads(2)
TOL = 2e-4
SMALL = dict(feat_dim=12, hidden=24, proj=16, blocks=3, l_order=4, r_order=2, l_stride=1,
             r_stride=1, classes=10)
CAUSAL = dict(feat_dim=8, hidden=16, proj=12, blocks=2, l_order=5, r_order=0, l_stride=2,
              classes=6)


def _np(x):
    d = getattr(x, "data", x)
    return d.detach().cpu().numpy() if isinstance(d, torch.Tensor) else np.asarray(d)


def _models(kw, seed):
    return (JDFSMN(JConfig(**kw), seed=seed),
            DFSMNASR(DFSMNConfig(**kw), seed=seed, device="cpu"))


@pytest.fixture(scope="module")
def small():
    return _models(SMALL, 3)


@pytest.mark.parametrize("kw,seed", [(SMALL, 3), (CAUSAL, 1)], ids=["lookahead", "causal"])
def test_weights_equal_jax(kw, seed):
    jm, tm = _models(kw, seed)
    assert list(tm.weights) == list(jm.weights)
    for k, v in jm.weights.items():
        assert tm.weights[k].dtype == v.dtype
        np.testing.assert_array_equal(tm.weights[k], v, err_msg=k)
    for i in range(tm.cfg.blocks):
        np.testing.assert_array_equal(tm._fir_kernel(i), jm._fir_kernel(i))


def test_offline_matches_jax(small, rng):
    jm, tm = small
    x = rng.standard_normal((2, 20, SMALL["feat_dim"])).astype(np.float32)
    want = np.asarray(jm.offline_session(2, 20).run(x))
    got = tm.offline_session(2, 20).run(x)
    assert tuple(got.shape) == (2, 20, SMALL["classes"]) and got.device.type == "cpu"
    np.testing.assert_allclose(_np(got), want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("kw,seed,b,T,C", [(SMALL, 3, 1, 48, 8), (CAUSAL, 1, 2, 24, 6)],
                         ids=["lookahead", "causal_l_stride2"])
def test_stream_matches_jax_chunk_by_chunk(kw, seed, b, T, C, rng):
    jm, tm = _models(kw, seed)
    x = rng.standard_normal((b, T, kw["feat_dim"])).astype(np.float32)
    js, ts = jm.stream(batch=b, chunk=C), tm.stream(batch=b, chunk=C)
    assert ts.delay == js.delay
    for i in range(0, T, C):
        np.testing.assert_allclose(_np(ts.step(x[:, i:i + C])), js.step(x[:, i:i + C]),
                                   rtol=TOL, atol=TOL, err_msg=f"chunk at frame {i}")
    for a, s in zip(ts.state, js.state):
        np.testing.assert_allclose(_np(a), np.asarray(s), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(_np(ts.flush()), js.flush(), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("kw,seed,b,T,C", [(SMALL, 3, 1, 48, 8), (CAUSAL, 1, 2, 24, 6)],
                         ids=["lookahead", "causal_l_stride2"])
def test_stream_matches_own_offline(kw, seed, b, T, C, rng):
    """Streamed logits == offline logits delayed by cfg.total_delay on every
    frame whose receptive field lies inside the utterance (all frames when
    the model is causal)."""
    _, tm = _models(kw, seed)
    cfg = tm.cfg
    x = rng.standard_normal((b, T, cfg.feat_dim)).astype(np.float32)
    offline = _np(tm.offline_session(b, T).run(x))
    st = tm.stream(batch=b, chunk=C)
    streamed = _np(torch.cat([st.step(x[:, i:i + C]) for i in range(0, T, C)]
                             + [st.flush()], dim=1))
    lo = cfg.blocks * cfg.l_span if cfg.r_span else 0
    hi = T - cfg.blocks * cfg.r_span
    assert hi - lo >= 16
    np.testing.assert_allclose(streamed[:, st.delay + lo:st.delay + hi], offline[:, lo:hi],
                               rtol=TOL, atol=TOL)


def test_stream_state_is_pure(small, rng):
    _, tm = small
    x = rng.standard_normal((1, 4, SMALL["feat_dim"])).astype(np.float32)
    st1, st2 = tm.stream(batch=1, chunk=4), tm.stream(batch=1, chunk=4)
    assert all(s.device.type == "cpu" for s in st1.state)
    torch.testing.assert_close(st1.step(x), st2.step(x), rtol=0, atol=0)
    for a, b in zip(st1.state, st2.state):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_fir_kernel_matches_fsmn_op(small, rng):
    """The assembled depthwise FIR kernel reproduces the port's per-frame
    fsmn op (the chunk path ≡ the reference's ring-buffer semantics)."""
    _, tm = small
    cfg = tm.cfg
    seq = rng.standard_normal((cfg.fir_len, cfg.proj)).astype(np.float32)
    out, _, _ = ops.fsmn(seq[-1:], tm.weights["b0.lf"], tm.weights["b0.rf"],
                         np.concatenate([np.zeros((1, cfg.proj), np.float32), seq[:-1]]),
                         np.int32(0),
                         P.FSMNParams(l_order=cfg.l_order, r_order=cfg.r_order,
                                      l_stride=cfg.l_stride, r_stride=cfg.r_stride))
    got = ops.conv1d(seq.T[None].copy(), tm._fir_kernel(0), None,
                     P.Conv1dParams(group=cfg.proj, pad=(0, 0)))
    np.testing.assert_allclose(_np(got)[0, :, 0], _np(out)[0], rtol=1e-5, atol=1e-5)


def test_device_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DFSMNASR(DFSMNConfig(**SMALL))


# -- the streaming-ASR op goldens of tests/test_asr_memstats.py, port vs JAX ------------

def test_cache_matmul_streaming_matches_jax(rng):
    b, t_ctx, t_new, din, units = 1, 8, 2, 6, 5
    w = rng.standard_normal((units, din)).astype(np.float32)
    bias = rng.standard_normal(units).astype(np.float32)
    cache = jcache = np.zeros((b, t_ctx, units), np.float32)
    for _ in range(5):
        x = rng.standard_normal((b, t_new, din)).astype(np.float32)
        out, cache_t = ops.cache_matmul(x, w, bias, cache, P.CacheMatmulParams())
        jout, jcache_t = jops.cache_matmul(x, w, bias, jcache, JP.CacheMatmulParams())
        np.testing.assert_allclose(_np(out), _np(jout), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(_np(cache_t), _np(jcache_t), rtol=1e-5, atol=1e-5)
        cache, jcache = _np(cache_t), _np(jcache_t)


def test_cache_conv1d_streaming_matches_jax(rng):
    b, c, t_ctx, t_new, k = 1, 4, 12, 3, 5
    w = (rng.standard_normal((c, c, k)) * 0.3).astype(np.float32)
    bias = rng.standard_normal(c).astype(np.float32)
    cache = jcache = np.zeros((b, c, t_ctx), np.float32)
    for _ in range(6):
        x = rng.standard_normal((b, c, t_new)).astype(np.float32)
        out, cache_t = ops.cache_conv1d(x, w, bias, cache, P.CacheConv1dParams())
        jout, jcache_t = jops.cache_conv1d(x, w, bias, jcache, JP.CacheConv1dParams())
        np.testing.assert_allclose(_np(out), _np(jout), rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(_np(cache_t), _np(jcache_t), rtol=1e-6, atol=0)
        cache, jcache = _np(cache_t), _np(jcache_t)


def test_fsmn_step_matches_jax(rng):
    d, l_order, r_order = 6, 3, 2
    T = l_order + r_order + 1
    lf = (rng.standard_normal((l_order, d)) * 0.5).astype(np.float32)
    rf = (rng.standard_normal((r_order, d)) * 0.5).astype(np.float32)
    seq = rng.standard_normal((T, d)).astype(np.float32)
    frame = rng.standard_normal((1, d)).astype(np.float32)
    got = ops.fsmn(frame, lf, rf, seq, np.int32(0), P.FSMNParams(l_order=l_order,
                                                                 r_order=r_order))
    want = jops.fsmn(frame, lf, rf, seq, np.int32(0), JP.FSMNParams(l_order=l_order,
                                                                    r_order=r_order))
    np.testing.assert_allclose(_np(got[0]), _np(want[0]), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(_np(got[1]), _np(want[1]))
    assert int(_np(got[2])) == int(_np(want[2])) == 1


def test_memstats_report_and_watermark():
    from csinn2_tpu_torch.utils.memstats import (MemoryWatermark, device_memory_stats,
                                                 live_buffer_report, total_live_bytes)
    assert device_memory_stats("cpu") is None
    base = total_live_bytes()
    keep = torch.ones((256, 256), dtype=torch.float32)  # 256 KiB
    assert total_live_bytes() >= base + 256 * 1024
    rep = live_buffer_report()
    assert rep["cpu"]["count"] > 0
    del keep

    with MemoryWatermark(tolerance_bytes=1 << 20):
        tmp = torch.zeros((64, 64))
        del tmp

    try:
        with MemoryWatermark(tolerance_bytes=1024):
            global _leak
            _leak = torch.ones((512, 512), dtype=torch.float32)
        leaked_detected = False
    except AssertionError:
        leaked_detected = True
    finally:
        _leak = None
    assert leaked_detected
