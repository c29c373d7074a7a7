"""CUDA kernels of the PyTorch port against their plain versions, on the
card, at the ragged shapes the 7B and MobileNetV1 checks in chip_smoke.py do
not reach: M, N and K tails of quant_matmul in every weight mode (Q8_0, Q4_0,
INT8_CHANNEL, INT4_CHANNEL, carriers at -128 and -8, the swiglu epilogue
with one and several pairs), odd KV lengths, GQA, bf16 KV, head dim 64, a
fully masked lane, strided K/V views; fused_dsconv (bit for bit) at odd H and
W, C in {3, 8, 17, 1024}, O not a multiple of 8, k 3 and 5, stride 1 and 2,
pads (0,1,0,1) and (1,1,1,1), batch 1 and 3, int8 and f32 output, and a small
MobileNetV1 session fused against unfused; and the wrappers' argument
checks.

Every test needs a CUDA device and skips without one.  This file imports
neither JAX nor the JAX package, so on a machine with a card and no JAX it
runs without the repository's conftest:

    python3 -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from csinn2_tpu_torch.kernels import dsblock as ds  # noqa: E402
from csinn2_tpu_torch.kernels import flash_attention as fa  # noqa: E402
from csinn2_tpu_torch.kernels import launch_counts  # noqa: E402
from csinn2_tpu_torch.kernels.qmatmul import (launch_key, pack_int4, quant_matmul,  # noqa: E402
                                              quant_matmul_ref)
from csinn2_tpu_torch.utils.verify import cosine_similarity, verify  # noqa: E402


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.fixture
def gen(dev):
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    return g


def _qmm_case(gen, dev, M, K, N):
    x = torch.randn((M, K), generator=gen, device=dev).to(torch.bfloat16)
    w = torch.randint(-127, 128, (K, N), generator=gen, device=dev, dtype=torch.int8)
    s = (torch.rand((K // 32, N), generator=gen, device=dev) * 1e-3 + 1e-5) \
        .to(torch.float16).float()
    return x, w, s


@pytest.mark.parametrize("M", [1, 2, 3, 5, 8, 9, 16, 17, 40, 100])
@pytest.mark.parametrize("K,N", [(96, 48), (352, 400), (1024, 2064)])
@pytest.mark.parametrize("odt", [torch.bfloat16, torch.float32])
def test_quant_matmul_tails(gen, dev, M, K, N, odt):
    x, w, s = _qmm_case(gen, dev, M, K, N)
    key = "quant_matmul." + ("decode" if M <= 16 else "prefill")
    before = launch_counts[key]
    y = quant_matmul(x, w, s, scale_mode="block", out_dtype=odt)
    torch.cuda.synchronize()
    assert launch_counts[key] == before + 1
    ref = quant_matmul_ref(x, w, s, scale_mode="block", out_dtype=odt)
    assert y.dtype == odt and y.shape == (M, N)
    yf, rf = y.float().cpu().numpy(), ref.float().cpu().numpy()
    assert cosine_similarity(yf, rf) >= 0.9999
    assert np.abs(yf - rf).max() <= 1e-2 * np.abs(rf).max()


def test_quant_matmul_bias(gen, dev):
    x, w, s = _qmm_case(gen, dev, 4, 256, 160)
    bias = torch.randn(160, generator=gen, device=dev)
    for M in (4, 64):
        xm = x.repeat(M // 4, 1)
        y = quant_matmul(xm, w, s, bias, scale_mode="block").cpu().numpy()
        ref = quant_matmul_ref(xm, w, s, bias, scale_mode="block").cpu().numpy()
        assert np.abs(y - ref).max() <= 1e-4 * np.abs(ref).max()


def test_quant_matmul_rejects_bad_args(gen, dev):
    x, w, s = _qmm_case(gen, dev, 4, 64, 40)          # N % 16 != 0
    with pytest.raises(ValueError):
        quant_matmul(x, w, s, scale_mode="block")
    x, w, s = _qmm_case(gen, dev, 4, 64, 32)
    with pytest.raises(TypeError):
        quant_matmul(x.float(), w, s, scale_mode="block")
    with pytest.raises(ValueError):
        quant_matmul(x, w.t().contiguous().t(), s, scale_mode="block")


# weight modes of the Llama linears: (scale_mode, packed_int4)
MODES = {"q8_0": ("block", False), "q4_0": ("block", True),
         "int8_channel": ("channel", False), "int4_channel": ("channel", True)}


def _mode_case(gen, dev, mode, M, K, N):
    """x bf16 [M, K] and the weights of `mode`, with every value of column
    0..7 at the carrier's minimum (-128 for int8 channel, -8 for int4)."""
    scale_mode, packed = MODES[mode]
    x = torch.randn((M, K), generator=gen, device=dev).to(torch.bfloat16)
    lo = -8 if packed else (-128 if scale_mode == "channel" else -127)
    hi = 8 if packed else 128
    q = torch.randint(lo, hi, (K, N), generator=gen, device=dev, dtype=torch.int8)
    q[:, :8] = lo
    w = pack_int4(q) if packed else q
    s_shape = (K // 32, N) if scale_mode == "block" else (N,)
    s = (torch.rand(s_shape, generator=gen, device=dev) * 1e-3 + 1e-5) \
        .to(torch.float16).float()
    return x, w, s, dict(scale_mode=scale_mode, packed_int4=packed)


def _agree(y, ref):
    yf, rf = y.float().cpu().numpy(), ref.float().cpu().numpy()
    assert cosine_similarity(yf, rf) >= 0.9999
    assert np.abs(yf - rf).max() <= 1e-2 * np.abs(rf).max()


@pytest.mark.parametrize("mode", ["q4_0", "int8_channel", "int4_channel"])
@pytest.mark.parametrize("M", list(range(1, 18)) + [33])
@pytest.mark.parametrize("K,N", [(96, 48), (352, 400), (1056, 2064)])   # K = 32 x odd
@pytest.mark.parametrize("odt", [torch.bfloat16, torch.float32])
def test_quant_matmul_modes_tails(gen, dev, mode, M, K, N, odt):
    x, w, s, kw = _mode_case(gen, dev, mode, M, K, N)
    key = f"{launch_key(kw['scale_mode'], kw['packed_int4'], False)}." \
          + ("decode" if M <= 16 else "prefill")
    before = launch_counts[key]
    y = quant_matmul(x, w, s, out_dtype=odt, **kw)
    torch.cuda.synchronize()
    assert launch_counts[key] == before + 1
    assert y.dtype == odt and y.shape == (M, N)
    _agree(y, quant_matmul_ref(x, w, s, out_dtype=odt, **kw))


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("M", [1, 4, 17, 40])
@pytest.mark.parametrize("K,N", [(96, 256), (352, 768), (4096, 1536)])   # 1, 3, 6 pairs
def test_quant_matmul_swiglu(gen, dev, mode, M, K, N):
    x, w, s, kw = _mode_case(gen, dev, mode, M, K, N)
    bias = torch.randn(N, generator=gen, device=dev) * 0.1 if M == 4 else None
    key = "quant_matmul_swiglu." + ("decode" if M <= 16 else "prefill")
    before = launch_counts[key]
    y = quant_matmul(x, w, s, bias, out_dtype=torch.bfloat16, swiglu=True, **kw)
    torch.cuda.synchronize()
    assert launch_counts[key] == before + 1
    assert y.shape == (M, N // 2) and y.dtype == torch.bfloat16
    _agree(y, quant_matmul_ref(x, w, s, bias, out_dtype=torch.bfloat16, swiglu=True, **kw))


@pytest.mark.parametrize("mode", ["q4_0", "int8_channel", "int4_channel"])
def test_quant_matmul_modes_bias(gen, dev, mode):
    for M in (4, 64):
        x, w, s, kw = _mode_case(gen, dev, mode, M, 256, 160)
        bias = torch.randn(160, generator=gen, device=dev)
        y = quant_matmul(x, w, s, bias, **kw).cpu().numpy()
        ref = quant_matmul_ref(x, w, s, bias, **kw).cpu().numpy()
        assert np.abs(y - ref).max() <= 1e-4 * np.abs(ref).max()


@pytest.mark.parametrize("kw", [dict(scale_mode="none"), dict(w_transposed=True),
                                dict(epilogue_scale=0.5), dict(out_dtype=torch.int8)])
def test_quant_matmul_unported_modes_raise_on_the_card(gen, dev, kw):
    x, w, s = _qmm_case(gen, dev, 4, 64, 32)
    args = dict(scale_mode="block")
    args.update(kw)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        quant_matmul(x, w, s, **args)


def test_quant_matmul_modes_reject_bad_args(gen, dev):
    x, w, s, kw = _mode_case(gen, dev, "q4_0", 4, 64, 32)
    with pytest.raises(ValueError):
        quant_matmul(x, w, s, scale_mode="block")          # packed bytes as int8 [K, N]
    with pytest.raises(ValueError):
        quant_matmul(x, w, s, swiglu=True, **kw)           # N % 256 != 0
    x, w, s, kw = _mode_case(gen, dev, "int8_channel", 4, 64, 32)
    with pytest.raises(ValueError):
        quant_matmul(x, w, s[None], **kw)                  # channel scales are [N]


def _kv(gen, dev, b, hk, S, d, int8):
    if int8:
        k = torch.randint(-127, 128, (b, S, hk, d), generator=gen, device=dev,
                          dtype=torch.int8)
        v = torch.randint(-127, 128, (b, S, hk, d), generator=gen, device=dev,
                          dtype=torch.int8)
    else:
        k = torch.randn((b, S, hk, d), generator=gen, device=dev).to(torch.bfloat16)
        v = torch.randn((b, S, hk, d), generator=gen, device=dev).to(torch.bfloat16)
    return k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3)


def _close(out, ref):
    r = verify(out.float().cpu().numpy(), ref.float().cpu().numpy(), tol=2e-2,
               min_cosine=0.9999)
    assert r.passed and r.cosine_sim >= 0.9999, r


@pytest.mark.parametrize("int8", [True, False])
@pytest.mark.parametrize("hq,hk,d,S", [(8, 2, 128, 300), (4, 4, 64, 77), (6, 3, 32, 1000)])
def test_decode_attention(gen, dev, int8, hq, hk, d, S):
    b = 3
    k, v = _kv(gen, dev, b, hk, S, d, int8)
    # q as the engine passes it: the q heads of a [b, 1, hq + hk, d] q|k tensor
    qk = torch.randn((b, 1, hq + hk, d), generator=gen, device=dev).to(torch.bfloat16)
    q = qk[:, :, :hq].permute(0, 2, 1, 3)
    kv_len = torch.tensor([S, 0, 5], dtype=torch.int32, device=dev)
    scale = 0.05 if int8 else None
    out = fa.decode_attention(q, k, v, q_offset=kv_len - 1, kv_len=kv_len, kv_scale=scale)
    torch.cuda.synchronize()
    ref = fa._attention_ref(q, k, v, causal=False, q_offset=kv_len - 1, kv_len=kv_len,
                            scale=1 / d ** 0.5, kv_scale=scale)
    _close(out, ref)
    assert float(out[1].abs().max()) == 0.0


@pytest.mark.parametrize("name", ["prefill_attention", "flash_attention"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("int8,d", [(True, 128), (False, 64)])
def test_prefill_and_flash_attention(gen, dev, name, causal, int8, d):
    b, sq, hq, hk, S = 2, 45, 8, 4, 160
    k, v = _kv(gen, dev, b, hk, S, d, int8)
    q = torch.randn((b, sq, hq, d), generator=gen, device=dev).to(torch.bfloat16)
    off = torch.tensor([0, 70], dtype=torch.int32, device=dev)
    kvl = torch.tensor([sq, 200], dtype=torch.int32, device=dev)  # 200 > S: clamped
    scale = 0.05 if int8 else None
    kw = dict(causal=causal, q_offset=off, kv_len=kvl, kv_scale=scale)
    if name == "flash_attention":
        out = fa.flash_attention(q, k, v, qo_layout="bshd", **kw)
    else:
        out = fa.prefill_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    ref = fa._attention_ref(q.permute(0, 2, 1, 3), k, v, scale=1 / d ** 0.5, **kw) \
        .permute(0, 2, 1, 3)
    _close(out, ref)


def test_fully_masked_prefill_row_outputs_zero(gen, dev):
    k, v = _kv(gen, dev, 1, 2, 64, 128, True)
    q = torch.randn((1, 8, 2, 128), generator=gen, device=dev).to(torch.bfloat16)
    out = fa.prefill_attention(q, k, v, causal=True, q_offset=0, kv_len=0, kv_scale=0.05)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all() and float(out.abs().max()) == 0.0


def test_attention_rejects_bad_args(gen, dev):
    k, v = _kv(gen, dev, 1, 2, 64, 96, True)
    q = torch.randn((1, 8, 2, 96), generator=gen, device=dev).to(torch.bfloat16)
    with pytest.raises(NotImplementedError):
        fa.prefill_attention(q, k, v)                    # head dim 96
    q = torch.randn((1, 8, 2, 128), generator=gen, device=dev)
    k, v = _kv(gen, dev, 1, 2, 64, 128, True)
    with pytest.raises(TypeError):
        fa.prefill_attention(q, k, v)                    # f32 q


def _ds_case(gen, dev, N, H, W, C, O, k):
    """int8 carriers over their full range (-128 included), f32 scales that
    keep the sums inside the requantize range, random biases."""
    ri = lambda shape: torch.randint(-128, 128, shape, generator=gen, device=dev,
                                     dtype=torch.int8)
    rf = lambda n: torch.rand(n, generator=gen, device=dev)
    x, dw, pw = ri((N, H, W, C)), ri((k * k, C)), ri((C, O))
    effd = (rf(C) + 0.1) * (1.5e-4 * 3 / k)
    effp = (rf(O) + 0.1) * (4e-4 / C ** 0.5)
    bd = torch.randn(C, generator=gen, device=dev)
    bp = torch.randn(O, generator=gen, device=dev) * 0.5
    return x, dw, effd, bd, pw, effp, bp


@pytest.mark.parametrize("C", [3, 8, 17, 1024])
@pytest.mark.parametrize("k,stride", [(3, 1), (3, 2), (5, 1), (5, 2)])
@pytest.mark.parametrize("pads", [(0, 1, 0, 1), (1, 1, 1, 1)])
@pytest.mark.parametrize("out", ["int8", "f32"])
def test_fused_dsconv(gen, dev, C, k, stride, pads, out):
    N, (H, W), O = (1, (7, 9), 257) if C == 1024 else (3 if C != 3 else 1, (13, 11), 70 - C % 2)
    args = _ds_case(gen, dev, N, H, W, C, O, k)
    kw = dict(k=k, stride=stride, pads=pads, mid_scale=6.0 / 255.0,
              mid_relu=out == "f32", mid_relu6=out == "int8", out_relu=False,
              out_relu6=out == "int8", out_scale=0.05 if out == "int8" else None,
              out_dtype=torch.int8 if out == "int8" else torch.float32)
    before = launch_counts["fused_dsconv"]
    y = ds.fused_dsconv(*args, **kw)
    torch.cuda.synchronize()
    assert launch_counts["fused_dsconv"] == before + 1
    ref = ds.fused_dsconv_ref(*args, **kw)
    assert y.shape == ref.shape == (N, *ds.out_hw(H, W, k, stride, pads), O)
    assert y.dtype == ref.dtype
    np.testing.assert_array_equal(y.cpu().numpy(), ref.cpu().numpy())


def test_fused_dsconv_rejects_bad_args_on_the_card(gen, dev):
    args = list(_ds_case(gen, dev, 1, 8, 8, 16, 32, 3))
    kw = dict(k=3, stride=1, pads=(1, 1, 1, 1), mid_scale=0.02, mid_relu=False,
              mid_relu6=True, out_relu=False, out_relu6=True, out_scale=0.05)
    ds.fused_dsconv(*args, **kw)
    with pytest.raises(ValueError, match="contiguous"):
        ds.fused_dsconv(args[0].permute(0, 2, 1, 3), *args[1:], **kw)
    with pytest.raises(ValueError, match="one device"):
        ds.fused_dsconv(args[0], args[1].cpu(), *args[2:], **kw)


def test_mobilenet_session_fused_equals_unfused_on_the_card(dev, monkeypatch):
    from csinn2_tpu_torch.core.dtypes import QuantScheme
    from csinn2_tpu_torch.models.mobilenet import MobileNetV1
    m = MobileNetV1(alpha=0.25, input_size=32)
    x = np.random.default_rng(1).random(m.input_shape(3)).astype(np.float32)
    m.calibrate(x[:1], device="cpu")
    monkeypatch.delenv("CSINN2_NO_FUSE_DS", raising=False)
    outs = {}
    for fused in (False, True):
        if fused:
            monkeypatch.setenv("CSINN2_FUSE_DS", "1")
        s = m.build_session(QuantScheme.INT8_SYM, batch=3, device=dev)
        before = launch_counts["fused_dsconv"]
        outs[fused] = s.run(m.prepare_input(x, s)).cpu().numpy()
        assert launch_counts["fused_dsconv"] - before == (13 if fused else 0)
    np.testing.assert_array_equal(outs[True], outs[False])
    s = m.build_session(QuantScheme.INT8_SYM, batch=3, device="cpu")
    cpu = s.run(m.prepare_input(x, s)).numpy()
    # the fc's float-carrier sums run in another order on the card: 1 LSB
    assert np.abs(cpu.astype(int) - outs[True].astype(int)).max() <= 1
