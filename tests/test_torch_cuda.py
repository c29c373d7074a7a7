"""CUDA kernels of the PyTorch port against their plain versions, on the
card, at the ragged shapes the 7B and MobileNetV1 checks in chip_smoke.py do
not reach: M, N and K tails of quant_matmul in every weight mode (Q8_0, Q4_0,
INT8_CHANNEL, INT4_CHANNEL, carriers at -128 and -8, the swiglu epilogue
with one and several pairs), and in the modes of the fourth slice (the
transposed [N, K] / [N, K/2] layouts, scale_mode "none", int8 x with every
output type, the fixed-point requantize bit for bit, epilogue_scale and
integer outputs of a float x); attention at every head dim class up to
256 (16, 17, 20, 32, 36, 80, 96, 256: 16-, 8-, 4-byte and element loads)
and above it (264 to 2112, and 4096 to 23243 with streamed dims: the wide
tensor-core kernel, its split-KV decode and merge, absorbed MLA's decode
of 128 heads on one latent head, its shared-memory mirror) with an f32
or bf16 q in all four entry points, odd KV lengths, GQA, bf16 KV, a fully masked lane, strided K/V views, bhsd flash_attention with a
strided q, the split-KV flash decode at kv_len 0 to 2048 with sq 1 and 3,
ragged query rows, and LlamaConfig.tiny() served on the card against the
CPU path, with and without CSINN2_DECODE_ATTN=flash; the MoE blocks (dense
and routed, dropping tokens too) over stacked expert weights; the engine's captured
decode-step graph against its eager loop (tiny() with and without flash
decode, a 2-layer 7B-width Q4_0 model: greedy, seeded and top-k / top-p
chunks, an admission between chunks, a kv_bound change, launch counts,
captures, strip counters) and its benchmark methods; the kernels at a rank's
shapes under tensor parallelism (the tp = 2 GEMMs of Llama-2-7B and of a
Mixtral expert, 16 attention heads) and the engine at tp = 2 over gloo on one
card and over NCCL where there are two (it skips below two cards); ring
attention at cp = 2 over gloo and PipelinedLlama with both stages on the card
(bit for bit against llama_forward microbatch by microbatch);
the op API's CUDA tier in a GRAPH session; the eleven Q4_0 dequant-probe
kernels (kernels/int4_probe.py, every one on the decode GEMM's ring) at M 1,
5, 8 and 16, N not a multiple of the strip, K a multiple of 32 but not of
the split, and at the ring's tails (N off the 256-column strip and off 16 /
32 bytes a row, splits that end mid-stage, an odd number of blocks, the 7B
w2 depth), bit-identical repeated calls, their dynamic shared memory and
two CTAs an SM, and every split the tile tuner sweeps; fused_dsconv (bit for bit) at odd H and
W, C in {3, 8, 17, 1024}, O not a multiple of 8, k 3 and 5, stride 1 and 2,
pads (0,1,0,1) and (1,1,1,1), batch 1 and 3, int8 and f32 output, a small
MobileNetV1 session fused against unfused, MobileNetV1's 13 block shapes at
batch 2 and ragged shapes (Ho·Wo off the pixel tile, C off 32 and 16, O off
the 64-channel tile, C = 1024 with k = 5, tiles across images), each with the
pointwise weight as a contiguous [C, O] and as the view of an [O, C]; the
int8-x GEMM at K, N and M off its blocks, strips, splits and tiles in both
epilogues, bit for bit and across two calls, its swiglu pairs, and its
plan's mirror; the prefill GEMM kernels in
every float-x mode at M 17-2048 with ragged N and K (integer outputs and
1e-4 bias checks against the function the kernel computes, its bf16 w·s),
swiglu on the [N, K] layouts, the GEMM plan's Python mirror against the
library, the split-KV decode_attention across its chunk edges; the decode
GEMM (M <= 16) in every float-x mode, layout and output type at M 1-16,
ragged N and K, swiglu at the 7B width, bit-identical repeated calls, its
strip counters left at zero after refused and ragged launches, and its ring
alone; and the wrappers' argument checks.

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
from csinn2_tpu_torch.kernels import int4_probe as ip  # noqa: E402
from csinn2_tpu_torch.kernels import launch_counts  # noqa: E402
from csinn2_tpu_torch.kernels.qmatmul import (launch_key, pack_int4, quant_matmul,  # noqa: E402
                                              quant_matmul_ref)
from csinn2_tpu_torch.utils.verify import check_bf16_output, cosine_similarity, verify  # noqa: E402


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


def _kernel_numerics_ref(x, w, s, bias, **kw):
    """The function the kernels compute: quant_matmul_ref, except that they
    (decode and prefill) form block-scaled weights as bf16(bf16(q) ·
    bf16(s)), as the JAX body does (csrc/qmatmul.cuh, Numerics); the
    epilogue and the output cast are the plain version's."""
    if kw.get("scale_mode") != "block":
        return quant_matmul_ref(x, w, s, bias, **kw)
    from csinn2_tpu_torch.kernels import qmatmul as tq
    K = x.shape[1]
    trans = kw.get("w_transposed", False)
    q = tq._weight_kn(w, K, kw.get("packed_int4", False), trans)
    sb = (s.t() if trans else s).to(torch.bfloat16).float()
    wq = (q.float() * sb.repeat_interleave(32, dim=0)).to(torch.bfloat16).float()
    acc = tq._fma_epilogue(x.float() @ wq, s, "block", kw.get("epilogue_scale"), bias)
    if kw.get("swiglu"):
        acc = tq.swiglu_pairs(acc)
    odt = kw.get("out_dtype", torch.float32)
    clip = tq.OUT_KINDS[odt][1]
    if clip is not None:
        acc = torch.clamp(torch.round(acc) + float(kw.get("out_zp", 0.0)), clip[0], clip[1])
    return acc.to(odt)


def test_quant_matmul_bias(gen, dev):
    """A bias on the decode kernel (M = 4) and the prefill kernel (M = 64),
    each against the function it computes (their bf16 w·s)."""
    x, w, s = _qmm_case(gen, dev, 4, 256, 160)
    bias = torch.randn(160, generator=gen, device=dev)
    for M in (4, 64):
        xm = x.repeat(M // 4, 1)
        y = quant_matmul(xm, w, s, bias, scale_mode="block").cpu().numpy()
        ref = _kernel_numerics_ref(xm, w, s, bias, scale_mode="block").cpu().numpy()
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
        ref = _kernel_numerics_ref(x, w, s, bias, **kw).cpu().numpy()
        assert np.abs(y - ref).max() <= 1e-4 * np.abs(ref).max()


@pytest.mark.parametrize("kw", [dict(scale_mode="none"), dict(w_transposed=True),
                                dict(epilogue_scale=0.5), dict(out_dtype=torch.int8)])
def test_quant_matmul_unported_modes_raise_on_the_card(gen, dev, kw):
    """The modes the second slice left unported run on the card now: each
    against the plain version (the int8 output within 1 LSB of the function
    the kernel computes: f32 sums in another order)."""
    x, w, s = _qmm_case(gen, dev, 4, 64, 32)
    args = dict(scale_mode="block")
    args.update(kw)
    if args["scale_mode"] == "none":
        s = None
    if args.get("w_transposed"):
        w, s = w.t().contiguous(), s.t().contiguous()
    if args.get("out_dtype") == torch.int8:
        s = s * 100
    for M in (4, 40):
        xm = x.repeat(M // 4, 1)
        y = quant_matmul(xm, w, s, **args)
        torch.cuda.synchronize()
        if y.dtype == torch.int8:
            ref = _kernel_numerics_ref(xm, w, s, None, **args)
            assert (y.int() - ref.int()).abs().max() <= 1
            continue
        _agree(y, quant_matmul_ref(xm, w, s, **args))


def test_quant_matmul_modes_reject_bad_args(gen, dev):
    x, w, s, kw = _mode_case(gen, dev, "q4_0", 4, 64, 32)
    with pytest.raises(ValueError):
        quant_matmul(x, w, s, scale_mode="block")          # packed bytes as int8 [K, N]
    with pytest.raises(ValueError):
        quant_matmul(x, w, s, swiglu=True, **kw)           # N % 256 != 0
    x, w, s, kw = _mode_case(gen, dev, "int8_channel", 4, 64, 32)
    with pytest.raises(ValueError):
        quant_matmul(x, w, s[None], **kw)                  # channel scales are [N]


# -- the fourth slice: transposed weights, int8 x, integer epilogues -----------------

T_MODES = {"q8_0": ("block", False), "q4_0_carrier": ("block", False),
           "int8_channel": ("channel", False), "q4_0_packed": ("block", True),
           "int4_channel_packed": ("channel", True)}
TAIL_M = [1, 5, 17, 130]
TAIL_KN = [(96, 48), (352, 400), (1056, 2064)]


def _t_case(gen, dev, mode, M, K, N):
    """x bf16 and a transposed weight of `mode`: int8 [N, K] (Q4_0's unpacked
    carrier in [-8, 7]) or packed [N, K/2], block scales [N, K/32] or [N];
    rows 0..7 at the carrier's minimum."""
    from csinn2_tpu_torch.kernels.qmatmul import pack_int4_t
    scale_mode, packed = T_MODES[mode]
    x = torch.randn((M, K), generator=gen, device=dev).to(torch.bfloat16)
    lo, hi = (-8, 8) if packed or mode == "q4_0_carrier" else (-128, 128)
    q = torch.randint(lo, hi, (N, K), generator=gen, device=dev, dtype=torch.int8)
    q[:8] = lo
    w = pack_int4_t(q) if packed else q
    s_shape = (N, K // 32) if scale_mode == "block" else (N,)
    s = (torch.rand(s_shape, generator=gen, device=dev) * 1e-3 + 1e-5).to(torch.float16).float()
    return x, w, s, dict(scale_mode=scale_mode, packed_int4=packed, w_transposed=True)


@pytest.mark.parametrize("mode", list(T_MODES))
@pytest.mark.parametrize("M", TAIL_M)
@pytest.mark.parametrize("K,N", TAIL_KN)
def test_quant_matmul_transposed_tails(gen, dev, mode, M, K, N):
    x, w, s, kw = _t_case(gen, dev, mode, M, K, N)
    key = "quant_matmul_t." + ("decode" if M <= 16 else "prefill")
    before = launch_counts[key]
    odt = torch.float32 if M == 5 else torch.bfloat16
    y = quant_matmul(x, w, s, out_dtype=odt, **kw)
    torch.cuda.synchronize()
    assert launch_counts[key] == before + 1
    assert y.shape == (M, N) and y.dtype == odt
    _agree(y, quant_matmul_ref(x, w, s, out_dtype=odt, **kw))


@pytest.mark.parametrize("M", TAIL_M)
def test_quant_matmul_transposed_epilogues(gen, dev, M):
    """bias, epilogue_scale and a uint8 output on the transposed layouts
    (the decode kernel's direct epilogue, and the reduce)."""
    for mode in ("q8_0", "int4_channel_packed"):
        x, w, s, kw = _t_case(gen, dev, mode, M, 352, 400)
        bias = None if kw["packed_int4"] else torch.randn(400, generator=gen, device=dev)
        y = quant_matmul(x, w, s, bias, epilogue_scale=0.5, **kw)
        _agree(y, quant_matmul_ref(x, w, s, bias, epilogue_scale=0.5, **kw))
        y8 = quant_matmul(x, w, s * 300, bias, out_dtype=torch.uint8, out_zp=128.0, **kw)
        r8 = _kernel_numerics_ref(x, w, s * 300, bias, out_dtype=torch.uint8, out_zp=128.0,
                                  **kw)
        torch.cuda.synchronize()
        assert (y8.int() - r8.int()).abs().max() <= 1


@pytest.mark.parametrize("M", TAIL_M)
@pytest.mark.parametrize("K,N", TAIL_KN)
def test_quant_matmul_scale_none_tails(gen, dev, M, K, N):
    x, w, _ = _qmm_case(gen, dev, M, K, N)
    key = "quant_matmul_none." + ("decode" if M <= 16 else "prefill")
    before = launch_counts[key]
    y = quant_matmul(x, w, None, scale_mode="none")
    torch.cuda.synchronize()
    assert launch_counts[key] == before + 1
    _agree(y, quant_matmul_ref(x, w, None, scale_mode="none"))


I8_LAYOUTS = ["kn", "nk", "packed"]
I8_KN = [(80, 48), (352, 400), (1056, 2064)]       # K % 16 (packed: K = 352, 1056 only)


def _i8_case(gen, dev, layout, M, K, N, scale_mode="channel"):
    x = torch.randint(-128, 128, (M, K), generator=gen, device=dev, dtype=torch.int8)
    lo, hi = (-8, 8) if layout == "packed" else (-128, 128)
    q = torch.randint(lo, hi, (K, N), generator=gen, device=dev, dtype=torch.int8)
    q[:, :8] = lo
    w = q if layout == "kn" else (q.t().contiguous() if layout == "nk" else pack_int4(q))
    s = (torch.rand((N,), generator=gen, device=dev) * 1e-3 + 1e-5) \
        if scale_mode == "channel" else None
    return x, w, s, dict(scale_mode=scale_mode, packed_int4=layout == "packed",
                         w_transposed=layout == "nk")


@pytest.mark.parametrize("layout,K,N", [(lay, K, N) for lay in I8_LAYOUTS for K, N in I8_KN
                                         if not (lay == "packed" and K % 32)])
@pytest.mark.parametrize("M", TAIL_M)
@pytest.mark.parametrize("scale_mode", ["channel", "none"])
def test_quant_matmul_int8dot_tails(gen, dev, layout, M, K, N, scale_mode):
    """int8 x: the exact int32 sum, then · s in f32: equal to the plain
    version's exact sum bit for bit (packed int4 needs K % 32 == 0)."""
    x, w, s, kw = _i8_case(gen, dev, layout, M, K, N, scale_mode)
    key = "quant_matmul_int8dot." + ("decode" if M <= 16 else "prefill")
    before = launch_counts[key]
    y = quant_matmul(x, w, s, **kw)
    torch.cuda.synchronize()
    assert launch_counts[key] == before + 1
    assert torch.equal(y, quant_matmul_ref(x, w, s, **kw))


@pytest.mark.parametrize("odt,zp", [(torch.int8, 3.0), (torch.uint8, 128.0),
                                    (torch.int16, -7.0), (torch.int32, 0.0),
                                    (torch.bfloat16, 0.0)])
@pytest.mark.parametrize("M", TAIL_M)
def test_quant_matmul_int8dot_epilogues(gen, dev, odt, zp, M):
    """channel scale, epilogue_scale and an f32 bias (one fmaf, as the JAX
    kernel's compiled epilogue) into each output type: equal to the plain
    version (which emulates the fmaf in f64), at most 1 LSB on a rare
    double-rounding tie."""
    for layout in I8_LAYOUTS:
        x, w, s, kw = _i8_case(gen, dev, layout, M, 352, 400)
        bias = torch.randn(400, generator=gen, device=dev) * 4
        args = dict(epilogue_scale=0.37, out_zp=zp, out_dtype=odt, **kw)
        y = quant_matmul(x, w, s * 20, bias, **args)
        torch.cuda.synchronize()
        ref = quant_matmul_ref(x, w, s * 20, bias, **args)
        assert y.dtype == odt
        d = (y.double() - ref.double()).abs()
        if odt.is_floating_point:
            assert float(d.max()) <= 1e-2 * float(ref.double().abs().max())
        else:
            assert float(d.max()) <= 1 and float((d > 0).double().mean()) < 1e-3


@pytest.mark.parametrize("odt", [torch.int8, torch.uint8, torch.int16])
@pytest.mark.parametrize("layout", ["kn", "nk"])
@pytest.mark.parametrize("M", TAIL_M)
def test_quant_matmul_requant_bit_exact(gen, dev, odt, layout, M):
    """rq_mult / rq_shift with an int32 bias: bit for bit the plain version
    (kernels/requant.py, in int64) and the numpy oracle."""
    from csinn2_tpu_torch.core.dtypes import dtype_of
    from csinn2_tpu_torch.core.quant import quantize_multiplier, requantize_int
    K, N = 1056, 400
    x, w, _, kw = _i8_case(gen, dev, layout, M, K, N, "none")
    bias = torch.randint(-2**18, 2**18, (N,), generator=gen, device=dev, dtype=torch.int32)
    eff = np.exp(np.random.default_rng(M).uniform(np.log(1e-5), np.log(0.5), N))
    mult, shift = quantize_multiplier(eff)
    zp = 140.0 if odt == torch.uint8 else 10.0
    args = dict(out_dtype=odt, out_zp=zp, rq_mult=torch.from_numpy(mult).to(dev),
                rq_shift=torch.from_numpy(shift).to(dev), **kw)
    key = "quant_matmul_requant." + ("decode" if M <= 16 else "prefill")
    before = launch_counts[key]
    y = quant_matmul(x, w, None, bias, **args)
    torch.cuda.synchronize()
    assert launch_counts[key] == before + 1
    assert torch.equal(y, quant_matmul_ref(x, w, None, bias, **args))
    q = (w.t() if layout == "nk" else w).cpu().numpy().astype(np.int64)
    acc = x.cpu().numpy().astype(np.int64) @ q + bias.cpu().numpy()[None, :]
    gold = requantize_int(acc.astype(np.int32), mult[None, :], shift[None, :], int(zp),
                          dtype_of(odt))
    np.testing.assert_array_equal(y.cpu().numpy(), gold)


def test_quant_matmul_int8dot_rejects_bad_args(gen, dev):
    x, w, s, kw = _i8_case(gen, dev, "kn", 4, 72, 48)            # K % 16 != 0
    with pytest.raises(ValueError):
        quant_matmul(x, w, s, **kw)
    x, w, s, kw = _i8_case(gen, dev, "kn", 4, 80, 48)
    with pytest.raises(TypeError):
        quant_matmul(x, w, s.double(), **kw)                    # f64 scales
    with pytest.raises(ValueError):
        quant_matmul(x, w, s, out_dtype=torch.int8, rq_mult=1, rq_shift=0, **kw)   # scales


# -- the tenth slice: the int8-x GEMM on int8 tensor cores ---------------------------
# (layout, K, N): K off the 32-k block (K % 32 = 16), the split edges of a
# long K on few strips, N off the 256-column strip, packed K % 64 = 32
I8_RAGGED = [("kn", 1040, 272), ("nk", 1040, 272), ("packed", 1056, 272),
             ("kn", 12304, 528), ("nk", 12304, 528), ("packed", 12320, 528),
             ("kn", 4096, 1552), ("nk", 4096, 1552), ("packed", 4096, 1552)]


def _i8_requant_args(dev, N, odt=torch.int8):
    from csinn2_tpu_torch.core.quant import quantize_multiplier
    eff = np.exp(np.random.default_rng(N).uniform(np.log(1e-6), np.log(1e-3), N))
    mult, shift = quantize_multiplier(eff)
    return dict(out_dtype=odt, out_zp=3.0, rq_mult=torch.from_numpy(mult).to(dev),
                rq_shift=torch.from_numpy(shift).to(dev))


@pytest.mark.parametrize("layout,K,N", I8_RAGGED, ids=lambda v: str(v))
@pytest.mark.parametrize("M", [1, 15, 16, 17, 129])
def test_int8dot_ragged_both_epilogues(gen, dev, layout, K, N, M):
    """The int8-x GEMM at K, N and M off its blocks, strips, splits and
    tiles, in the float epilogue (channel scale, f32 out) and the
    requantize (int32 bias, rq_mult → int8): bit for bit the plain version,
    and bit for bit across two calls."""
    x, w, s, kw = _i8_case(gen, dev, layout, M, K, N, "channel")
    y = quant_matmul(x, w, s, **kw)
    assert torch.equal(y, quant_matmul(x, w, s, **kw))
    assert torch.equal(y, quant_matmul_ref(x, w, s, **kw))
    kw["scale_mode"] = "none"
    bias = torch.randint(-2**18, 2**18, (N,), generator=gen, device=dev, dtype=torch.int32)
    args = dict(kw, **_i8_requant_args(dev, N))
    key = "quant_matmul_requant." + ("decode" if M <= 16 else "prefill")
    before = launch_counts[key]
    y = quant_matmul(x, w, None, bias, **args)
    assert launch_counts[key] == before + 1
    assert torch.equal(y, quant_matmul(x, w, None, bias, **args))
    assert torch.equal(y, quant_matmul_ref(x, w, None, bias, **args))


@pytest.mark.parametrize("layout", I8_LAYOUTS)
@pytest.mark.parametrize("M", [4, 16, 17, 200])
@pytest.mark.parametrize("scale_mode", ["channel", "none"])
def test_int8dot_swiglu(gen, dev, layout, M, scale_mode):
    """swiglu on the int8-x path (ROADMAP B.9b): the exact sum, the float
    epilogue (· s · e, no bias: the plain version rounds as the kernel),
    then silu(h1)·h3 over the swiglu128 pairs, bit for bit the plain
    version (the same f32 operations: h1 / (1 + exp(-h1)) · h3)."""
    K, N = 1056, 1536
    x, w, s, kw = _i8_case(gen, dev, layout, M, K, N, scale_mode)
    kw.update(swiglu=True, epilogue_scale=None if scale_mode == "channel" else 1e-4)
    key = "quant_matmul_int8dot." + ("decode" if M <= 16 else "prefill")
    before = launch_counts[key]
    y = quant_matmul(x, w, s, **kw)
    torch.cuda.synchronize()
    assert launch_counts[key] == before + 1
    assert y.shape == (M, N // 2)
    assert torch.equal(y, quant_matmul_ref(x, w, s, **kw))


def test_int8dot_plan_mirror_matches_the_library(dev):
    """kernels/qmatmul.py int8dot_plan (the Python mirror) equals the CUDA
    library's quant_matmul_int8dot_plan at the 7B and 13B projections and
    ragged shapes, M 1-2048."""
    from csinn2_tpu_torch.kernels import qmatmul as tq
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    shapes = [(4096, 12288), (4096, 4096), (4096, 22016), (11008, 4096), (5120, 27648),
              (13824, 5120), (1040, 272), (12304, 528), (80, 48)]
    for K, N in shapes:
        for M in (1, 4, 8, 9, 16, 17, 128, 129, 512, 2048):
            want = tq.kernel_int8dot_plan(M, N, K, 0)
            got = tq.int8dot_plan(M, N, K, n_sm)
            assert {k: got[k] for k in want} == want, (M, N, K)


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


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("int8,d", [(True, 128), (False, 64)])
@pytest.mark.parametrize("sq", [1, 45])
def test_flash_attention_bhsd(gen, dev, causal, int8, d, sq):
    """bhsd q/out with q a strided view (the q heads of a [b, hq + hk, sq, d]
    buffer); per-row q_offset / kv_len, a kv_len past S clamped, one row
    with kv_len 0 (outputs 0)."""
    b, hq, hk, S = 3, 8, 4, 160
    k, v = _kv(gen, dev, b, hk, S, d, int8)
    buf = torch.randn((b, hq + hk, sq, d), generator=gen, device=dev).to(torch.bfloat16)
    q = buf[:, :hq]
    off = torch.tensor([0, 70, 3], dtype=torch.int32, device=dev)
    kvl = torch.tensor([sq, 200, 0], dtype=torch.int32, device=dev)
    scale = 0.05 if int8 else None
    kw = dict(causal=causal, q_offset=off, kv_len=kvl, kv_scale=scale)
    before = launch_counts["flash_attention_bhsd"]
    out = fa.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert launch_counts["flash_attention_bhsd"] == before + 1
    assert out.shape == (b, hq, sq, d) and out.dtype == torch.bfloat16
    _close(out, fa._attention_ref(q, k, v, scale=1 / d ** 0.5, **kw))
    assert float(out[2].abs().max()) == 0.0


def test_fully_masked_prefill_row_outputs_zero(gen, dev):
    k, v = _kv(gen, dev, 1, 2, 64, 128, True)
    q = torch.randn((1, 8, 2, 128), generator=gen, device=dev).to(torch.bfloat16)
    out = fa.prefill_attention(q, k, v, causal=True, q_offset=0, kv_len=0, kv_scale=0.05)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all() and float(out.abs().max()) == 0.0


ENTRIES = ["prefill_attention", "flash_attention", "flash_attention_bhsd", "decode_attention"]


def _attend(name, q, k, v, **kw):
    """One entry point on q in its layout ([b, sq, hq, d] for prefill and
    bshd flash, [b, hq, sq, d] for bhsd and decode); the output and its plain
    version (on q rounded to bf16, as the kernels and the JAX bodies round
    it) in the same layout."""
    if name == "decode_attention":
        out = fa.decode_attention(q, k, v, q_offset=kw["q_offset"], kv_len=kw["kv_len"],
                                  kv_scale=kw["kv_scale"])
        kw = dict(kw, causal=False)
    elif name == "flash_attention_bhsd":
        out = fa.flash_attention(q, k, v, **kw)
    elif name == "flash_attention":
        out = fa.flash_attention(q, k, v, qo_layout="bshd", **kw)
    else:
        out = fa.prefill_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    bhsd = name in ("flash_attention_bhsd", "decode_attention")
    qh = q if bhsd else q.permute(0, 2, 1, 3)
    ref = fa._attention_ref(qh.to(torch.bfloat16), k, v, scale=1 / q.shape[-1] ** 0.5, **kw)
    return out, ref if bhsd else ref.permute(0, 2, 1, 3)


@pytest.mark.parametrize("name", ENTRIES)
@pytest.mark.parametrize("d", [16, 17, 20, 32, 36, 80, 96, 256, 264, 300, 320, 384, 448, 576,
                               1000, 2112])
@pytest.mark.parametrize("int8", [True, False])
@pytest.mark.parametrize("qdt", [torch.float32, torch.float16, torch.bfloat16])
def test_attention_head_dims_and_q_dtypes(gen, dev, name, d, int8, qdt):
    """Head dims up to 256 and above (264 to 2112: the wide tensor-core
    kernel; 300 rows are 8-byte aligned in bf16 and 4-byte in int8, whose
    tiles cp.async loads; 1000 and 2112 take several CTA slices of O's
    columns, 2112 streamed blocks of dims) and
    an f32, f16 or bf16 q, as the JAX kernels take them (they pad d to a
    multiple of 128 and round q to bf16): GQA 8/2, per-row
    q_offset / kv_len, K/V as permuted views of the cache layout.  d = 17 and
    20 rows are not 16-byte aligned (4-byte and element-wise loads).  The
    plain version gets q rounded to bf16, the kernels' (and the JAX bodies')
    rounding; the output comes back in q's dtype."""
    b, hq, hk, S = 2, 8, 2, 150
    sq = 1 if name == "decode_attention" else 37
    k, v = _kv(gen, dev, b, hk, S, d, int8)
    shape = (b, hq, sq, d) if name in ("flash_attention_bhsd", "decode_attention") \
        else (b, sq, hq, d)
    q = torch.randn(shape, generator=gen, device=dev).to(qdt)
    off = torch.tensor([0, 100], dtype=torch.int32, device=dev)
    kvl = torch.tensor([sq, 100 + sq], dtype=torch.int32, device=dev)
    kw = dict(causal=True, q_offset=off, kv_len=kvl, kv_scale=0.05 if int8 else None)
    out, ref = _attend(name, q, k, v, **kw)
    assert out.dtype == qdt and out.shape == q.shape
    _close(out, ref)


@pytest.mark.parametrize("name", ENTRIES)
def test_attention_wide_rows_and_empty_row(gen, dev, name):
    """d > 256 (the JAX functions pad d to a multiple of 128 with no cap) in
    every entry point: d = 320 through attn_wide_mma_kernel (launch count
    attention_wide.<entry>, and attention_wide.<entry>.combine where the
    plan splits the KV window, always the decode's) against the plain
    version, int8 and bf16 KV, GQA 8/2, per-row q_offset / kv_len with a row that sees no
    key (it outputs 0)."""
    b, hq, hk, S, d = 3, 8, 2, 150, 320
    sq = 1 if name == "decode_attention" else 37
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    for int8 in (True, False):
        k, v = _kv(gen, dev, b, hk, S, d, int8)
        shape = (b, hq, sq, d) if name in ("flash_attention_bhsd", "decode_attention") \
            else (b, sq, hq, d)
        q = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
        off = torch.tensor([0, 100, 3], dtype=torch.int32, device=dev)
        kvl = torch.tensor([sq, 100 + sq, 0], dtype=torch.int32, device=dev)
        causal = name != "decode_attention"
        split = fa._wide_plan(b, sq, hq, hk, S, d, k.element_size(), n_sm).n_chunks > 1
        assert split or causal          # the decode splits its window
        before = dict(launch_counts)
        out, ref = _attend(name, q, k, v, causal=True, q_offset=off, kv_len=kvl,
                           kv_scale=0.05 if int8 else None)
        key = f"attention_wide.{name}"
        assert launch_counts[key] == before.get(key, 0) + 1
        assert launch_counts[f"{key}.combine"] == before.get(f"{key}.combine", 0) + int(split)
        assert launch_counts[name] == before.get(name, 0)
        assert out.dtype == q.dtype and out.shape == q.shape
        _close(out, ref)
        assert float(out[2].abs().max()) == 0.0


@pytest.mark.parametrize("int8", [True, False])
@pytest.mark.parametrize("name", ["decode_attention", "flash_attention_bhsd"])
def test_attention_wide_mla_decode(gen, dev, int8, name):
    """Absorbed MLA's decode shape: 128 query heads on one latent KV head at
    d = 576, 128 m rows (two CTA blocks of 64) a batch row, so the unsplit
    grid is 4 CTAs a batch row and the plan splits the KV window; the merge
    takes both blocks' rows.  kv_len 0, 1, chunk ± 1 and S in one batch; the
    empty row outputs 0; one kernel launch and one merge a call."""
    b, hq, hk, S, d = 5, 128, 1, 1100, 576
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    p = fa._wide_plan(b, 1, hq, hk, S, d, 1 if int8 else 2, n_sm)
    assert p.n_chunks > 1
    k, v = _kv(gen, dev, b, hk, S, d, int8)
    q = torch.randn((b, hq, 1, d), generator=gen, device=dev).to(torch.bfloat16)
    kvl = torch.tensor([0, 1, p.chunk - 1, p.chunk + 1, S], dtype=torch.int32, device=dev)
    key = f"attention_wide.{name}"
    before = dict(launch_counts)
    out, ref = _attend(name, q, k, v, causal=name != "decode_attention", q_offset=kvl - 1,
                       kv_len=kvl, kv_scale=0.05 if int8 else None)
    assert launch_counts[key] == before.get(key, 0) + 1
    assert launch_counts[f"{key}.combine"] == before.get(f"{key}.combine", 0) + 1
    _close(out, ref)
    assert torch.isfinite(out).all() and float(out[0].abs().max()) == 0.0


@pytest.mark.parametrize("d,int8", [(4096, False), (5000, True), (19369, False), (23243, True)])
@pytest.mark.parametrize("name", ["flash_attention", "decode_attention"])
def test_attention_wide_streamed_dims(gen, dev, d, int8, name):
    """Head dims whose Q and K rows outgrow shared memory: Q·Kᵀ streams
    blocks of dims through the ring, and O takes several column slices of
    CTAs; up to 19369 (bf16) and 23243 (int8), the widest the CUDA-core
    kernel this one replaced could tile.  d = 5000 rows are 8-byte aligned."""
    b, hq, hk, S = 2, 4, 2, 70
    sq = 1 if name == "decode_attention" else 5
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    plan = fa._wide_plan(b, sq, hq, hk, S, d, 1 if int8 else 2, n_sm)
    assert plan.qc < d and plan.slices > 1
    k, v = _kv(gen, dev, b, hk, S, d, int8)
    shape = (b, hq, sq, d) if name == "decode_attention" else (b, sq, hq, d)
    q = (torch.randn(shape, generator=gen, device=dev) * 0.05).to(torch.bfloat16)
    off = torch.tensor([0, 60], dtype=torch.int32, device=dev)
    kvl = torch.tensor([sq, 60 + sq], dtype=torch.int32, device=dev)
    out, ref = _attend(name, q, k, v, causal=True, q_offset=off, kv_len=kvl,
                       kv_scale=0.05 if int8 else None)
    _close(out, ref)


def test_wide_smem_mirror_matches_the_library(dev):
    """kernels/flash_attention.py _wide_smem against the library's own
    attention_wide_smem (csrc/attention.cu wide_smem) over the plans of many
    shapes and the tile choices around them."""
    import ctypes
    from csinn2_tpu_torch.kernels import _build
    i32 = ctypes.c_int
    lib = _build.c_function("attention", "attention_wide_smem", (i32,) * 6, ctypes.c_longlong)
    n = 0
    for d in (257, 300, 320, 448, 576, 1000, 2112, 4096, 19369):
        for kvb in (1, 2):
            for b, sq, hq, hk, S in ((1, 512, 32, 8, 512), (4, 1, 32, 8, 2048), (2, 37, 8, 2, 150)):
                p = fa._wide_plan(b, sq, hq, hk, S, d, kvb, 132)
                for bkv, st in fa.WIDE_TILES:
                    for qc in {p.qc, 64}:
                        args = (p.wg, bkv, qc, st, d)
                        assert lib(*args, int(kvb == 1)) == fa._wide_smem(*args, kvb), args
                        n += 1
    assert n > 200


def test_attention_rejects_bad_kv(gen, dev):
    k, v = _kv(gen, dev, 1, 2, 64, 64, True)
    q = torch.randn((1, 8, 2, 64), generator=gen, device=dev)
    with pytest.raises(TypeError):
        fa.prefill_attention(q, k.float(), v.float())    # f32 K/V
    with pytest.raises(ValueError):
        fa.prefill_attention(q, k[..., :32], v[..., :32])  # q and K/V head dims differ


@pytest.mark.parametrize("hq,hk", [(4, 2), (32, 8), (64, 8)])
@pytest.mark.parametrize("sq", [1, 3])
@pytest.mark.parametrize("int8", [True, False])
@pytest.mark.parametrize("d", [128, 64, 320])
def test_attention_split_kv_decode(gen, dev, hq, hk, sq, int8, d):
    """The split-KV flash decode (sq·group <= 64; 64/8 at sq = 3 is 24 rows,
    two warps): bhsd q, S = 2048 in 8 chunks (d = 320: the wide kernel's
    chunks), kv_len 0, 1, 17, 1027 and 2048 in one batch, causal with
    q_offset = kv_len - sq; a row that sees no key outputs 0; one merge
    launch (`.combine`) per call."""
    lens = [0, 1, 17, 1027, 2048]
    b, S = len(lens), 2048
    k, v = _kv(gen, dev, b, hk, S, d, int8)
    q = torch.randn((b, hq, sq, d), generator=gen, device=dev).to(torch.bfloat16)
    kvl = torch.tensor(lens, dtype=torch.int32, device=dev)
    off = (kvl - sq).clamp(min=0)
    kw = dict(causal=True, q_offset=off, kv_len=kvl, kv_scale=0.05 if int8 else None)
    before = dict(launch_counts)
    out, ref = _attend("flash_attention_bhsd", q, k, v, **kw)
    name = "flash_attention_bhsd" if d <= fa.MAX_D else "attention_wide.flash_attention_bhsd"
    for key in (name, f"{name}.combine"):
        assert launch_counts[key] == before.get(key, 0) + 1
    _close(out, ref)
    assert torch.isfinite(out).all() and float(out[0].abs().max()) == 0.0


@pytest.mark.parametrize("layout", ["flash_attention", "flash_attention_bhsd"])
@pytest.mark.parametrize("sq", [2, 17, 30, 200, 333, 900])
@pytest.mark.parametrize("causal", [True, False])
def test_attention_ragged_rows(gen, dev, layout, sq, causal):
    """sq (and sq·group) not a multiple of a CTA's 16, 32 or 64 rows, S not
    a multiple of the 64-key tile, GQA 12/4, kv_len past S clamped: on the
    132-SM H100 the plan takes the split path (two chunks) at sq = 2 (one
    row group, four key slices) and 17 (51 rows: four row groups), and 1, 2
    and 4 row groups a CTA over the query rows (with 4, 2 and 1 key slices)
    at sq = 30, 200 and 333, and 8 row groups at 900."""
    b, hq, hk, d, S = 2, 12, 4, 128, 413
    k, v = _kv(gen, dev, b, hk, S, d, True)
    shape = (b, hq, sq, d) if layout == "flash_attention_bhsd" else (b, sq, hq, d)
    q = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
    off = torch.tensor([0, 60], dtype=torch.int32, device=dev)
    kvl = torch.tensor([sq, 500], dtype=torch.int32, device=dev)
    out, ref = _attend(layout, q, k, v, causal=causal, q_offset=off, kv_len=kvl, kv_scale=0.05)
    _close(out, ref)


@pytest.mark.parametrize("d", [64, 96, 128])
@pytest.mark.parametrize("int8", [True, False])
@pytest.mark.parametrize("causal", [True, False])
def test_attention_long_prefill(gen, dev, d, int8, causal):
    """Long prefill (8 row groups a CTA, many K/V tiles through the ring):
    bshd sq = 1024 over S = 1100, GQA 16/8, q_offset 70 / 0 and kv_len past
    S / 700."""
    b, sq, hq, hk, S = 2, 1024, 16, 8, 1100
    k, v = _kv(gen, dev, b, hk, S, d, int8)
    q = torch.randn((b, sq, hq, d), generator=gen, device=dev).to(torch.bfloat16)
    off = torch.tensor([70, 0], dtype=torch.int32, device=dev)
    kvl = torch.tensor([2000, 700], dtype=torch.int32, device=dev)
    out, ref = _attend("flash_attention", q, k, v, causal=causal, q_offset=off, kv_len=kvl,
                       kv_scale=0.05 if int8 else None)
    _close(out, ref)


@pytest.mark.parametrize("flash", [False, True])
@pytest.mark.parametrize("mode,quantized_kv", [("q8_0", True), ("float", False)])
def test_engine_tiny_attention_on_the_card(dev, monkeypatch, flash, mode, quantized_kv):
    """LlamaConfig.tiny() (head dim 16, GQA 4/2) on the card: prefill and
    greedy decode steps with CSINN2_DECODE_ATTN unset and =flash, logits
    against the same engine on the CPU (the plain path), the card fed the
    CPU's tokens."""
    from csinn2_tpu_torch.llm.config import LlamaConfig
    from csinn2_tpu_torch.llm.engine import InferenceEngine
    from csinn2_tpu_torch.llm.model import init_params
    if flash:
        monkeypatch.setenv("CSINN2_DECODE_ATTN", "flash")
    else:
        monkeypatch.delenv("CSINN2_DECODE_ATTN", raising=False)
    cfg = LlamaConfig.tiny()
    engines = [InferenceEngine(cfg, init_params(cfg, mode, seed=5, device=dv), batch=2,
                               quantized_kv=quantized_kv, device=dv) for dv in ("cpu", "cuda")]
    prompts = ([3, 7, 11, 19, 4], list(range(1, 40)))
    nxt = {}
    for sid, prompt in enumerate(prompts):
        cpu, gpu = (e.prefill(sid, prompt) for e in engines)
        assert np.isfinite(gpu).all() and cosine_similarity(gpu, cpu) >= 0.999
        nxt[sid] = int(np.argmax(cpu))
    for _ in range(4):
        cpu, gpu = (e.decode_step(nxt) for e in engines)
        for sid in nxt:
            assert np.isfinite(gpu[sid]).all()
            assert cosine_similarity(gpu[sid], cpu[sid]) >= 0.999
        nxt = {sid: int(np.argmax(cpu[sid])) for sid in nxt}


@pytest.mark.parametrize("mode", ["q8_0", "q4_0", "int8"])
@pytest.mark.parametrize("block,factor", [("dense", None), ("routed", 2.0), ("routed", 0.25)])
def test_moe_blocks_on_the_card(dev, mode, block, factor):
    """The MoE blocks on the card against the CPU path on the same input
    (LlamaConfig.tiny_moe(8), 96 tokens; the routed one also dropping
    tokens at factor 0.25): each expert's three projections launch
    quant_matmul on views of the stacked weights, 3 E launches a call."""
    from csinn2_tpu_torch.llm.config import LlamaConfig
    from csinn2_tpu_torch.llm.model import (init_params, moe_ffn_block,
                                            moe_ffn_block_routed)
    cfg = LlamaConfig.tiny_moe(n_experts=8)
    lps = [init_params(cfg, mode, seed=6, device=dv)["layers"][0] for dv in ("cpu", "cuda")]
    x = torch.randn((2, 48, cfg.dim), generator=torch.Generator().manual_seed(6)) \
        .to(torch.bfloat16)

    def run(lp, xx):
        if block == "dense":
            return moe_ffn_block(xx, lp, cfg)
        return moe_ffn_block_routed(xx, lp, cfg, capacity_factor=factor)

    before = sum(n for k, n in launch_counts.items() if k.startswith("quant_matmul"))
    gpu = run(lps[1], x.to(dev))
    torch.cuda.synchronize()
    after = sum(n for k, n in launch_counts.items() if k.startswith("quant_matmul"))
    assert after - before == 3 * cfg.n_experts
    gpu, cpu = gpu.cpu().numpy(), run(lps[0], x).numpy()
    assert np.isfinite(gpu).all() and cosine_similarity(gpu, cpu) >= 0.9999
    assert np.abs(gpu - cpu).max() <= 1e-2 * np.abs(cpu).max()


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


# MobileNetV1's 13 depthwise-separable blocks (alpha 1.0, 224): (H, C, O, stride)
MOBILENET_BLOCKS = [(112, 32, 64, 1), (112, 64, 128, 2), (56, 128, 128, 1),
                    (56, 128, 256, 2), (28, 256, 256, 1), (28, 256, 512, 2)] \
    + [(14, 512, 512, 1)] * 5 + [(14, 512, 1024, 2), (7, 1024, 1024, 1)]


def _ds_kw(k, stride, pads):
    return dict(k=k, stride=stride, pads=pads, mid_scale=6.0 / 255.0, mid_relu=False,
                mid_relu6=True, out_relu=False, out_relu6=True, out_scale=0.05,
                out_dtype=torch.int8)


def _ds_both_forms(args, kw):
    """fused_dsconv with the pointwise weight as a contiguous [C, O] and as
    the transposed view of a contiguous [O, C], each bit for bit the plain
    version; returns the output."""
    x, dw, effd, bd, pw, effp, bp = args
    ref = ds.fused_dsconv_ref(*args, **kw)
    for pw_form in (pw, pw.t().contiguous().t()):
        before = launch_counts["fused_dsconv"]
        y = ds.fused_dsconv(x, dw, effd, bd, pw_form, effp, bp, **kw)
        torch.cuda.synchronize()
        assert launch_counts["fused_dsconv"] == before + 1
        np.testing.assert_array_equal(y.cpu().numpy(), ref.cpu().numpy())
    return y


@pytest.mark.parametrize("block", range(len(MOBILENET_BLOCKS)))
def test_fused_dsconv_mobilenet_blocks(gen, dev, block):
    """Each of MobileNetV1's 13 block shapes at batch 2 (the pads of the
    model's graph: 1 all round at stride 1, bottom/right at stride 2), both
    weight forms, bit for bit."""
    H, C, O, stride = MOBILENET_BLOCKS[block]
    args = _ds_case(gen, dev, 2, H, H, C, O, 3)
    _ds_both_forms(args, _ds_kw(3, stride, (1, 1, 1, 1) if stride == 1 else (0, 1, 0, 1)))


@pytest.mark.parametrize("N,H,W,C,O,k,stride", [
    (2, 13, 13, 48, 100, 3, 1),       # Ho·Wo = 169 off the pixel tile; C % 32 = 16
    (3, 13, 11, 40, 72, 3, 2),        # C % 16 = 8: byte copies
    (1, 9, 7, 1024, 130, 5, 1),       # C = 1024 with k = 5; O off the 64-channel tile
    (2, 10, 10, 1024, 64, 5, 2),
    (5, 15, 15, 96, 200, 5, 2),
    (130, 7, 7, 520, 70, 3, 1)])      # tiles across images, C % 32 = 8, several chunks
def test_fused_dsconv_ragged(gen, dev, N, H, W, C, O, k, stride):
    args = _ds_case(gen, dev, N, H, W, C, O, k)
    _ds_both_forms(args, _ds_kw(k, stride, (k // 2, k // 2, k // 2 - 1, k // 2)))


def test_dsconv_smem_mirror_matches_the_library(dev):
    """kernels/dsblock.py smem_bytes (the mirror ds_plan sizes CK with)
    equals csrc/dsblock.cu's layout at every MobileNetV1 block's plan and at
    ragged ones."""
    import ctypes
    from csinn2_tpu_torch.kernels import _build
    fn = _build.c_function("dsblock", "fused_dsconv_smem_bytes", (ctypes.c_int,) * 7)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    shapes = [(b, H, H, C, O, 3, s) for b in (128, 1) for H, C, O, s in MOBILENET_BLOCKS] \
        + [(3, 13, 11, 40, 72, 5, 2), (1, 9, 7, 1024, 130, 5, 1), (2, 1, 300, 17, 9, 3, 1)]
    for N, H, W, C, O, k, s in shapes:
        p = ds.ds_plan(N, H, W, C, O, k, s, (k // 2,) * 4, n_sm)
        assert fn(p["P"], C, W, p["ck"], p["halo_rows"], p["kc"], k) == p["smem"]


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


def test_op_api_cuda_tier_on_the_card(dev):
    """A block-quantized fullyconnected and an SDPA recorded into a GRAPH
    session on the card resolve to the CUDA tier (quant_matmul_t,
    flash_attention_bhsd) and match the same graph in an Api.TORCH session."""
    from csinn2_tpu_torch import ops
    from csinn2_tpu_torch.core.dtypes import Api, Dtype, QuantScheme, RunMode
    from csinn2_tpu_torch.core.quant import block_quantize
    from csinn2_tpu_torch.core.tensor import Tensor, TensorMeta
    from csinn2_tpu_torch.runtime.session import Session
    rng = np.random.default_rng(0)
    w = Tensor(block=block_quantize((rng.standard_normal((384, 256)) * 0.1).astype(np.float32),
                                    QuantScheme.BLOCK_Q4_0))
    x = rng.standard_normal((130, 256)).astype(np.float32)
    q = rng.standard_normal((1, 4, 256, 64)).astype(np.float32)
    outs = {}
    for api in (Api.AUTO, Api.TORCH):
        sess = Session(run_mode=RunMode.GRAPH, api=api, device=dev)
        with sess.build():
            xi = sess.input(TensorMeta(shape=x.shape, dtype=Dtype.FLOAT32))
            qi = sess.input(TensorMeta(shape=q.shape, dtype=Dtype.FLOAT32))
            sess.set_output(ops.fullyconnected(xi, w),
                            ops.scaled_dot_product_attention(qi, qi, qi))
        sess.setup()
        want = ["fullyconnected:cuda", "scaled_dot_product_attention:cuda"] \
            if api == Api.AUTO else ["fullyconnected:torch", "scaled_dot_product_attention:torch"]
        assert [n.cb_name for n in sess.graph.nodes] == want
        before = dict(launch_counts)
        outs[api] = [o.cpu().numpy() for o in sess.run(x, q)]
        torch.cuda.synchronize()
        launched = {k: launch_counts[k] - before.get(k, 0) for k in launch_counts}
        if api == Api.AUTO:
            assert launched.get("quant_matmul_t.prefill") == 1
            assert launched.get("flash_attention_bhsd") == 1
    assert cosine_similarity(outs[Api.AUTO][0], outs[Api.TORCH][0]) >= 0.9999
    r = verify(outs[Api.AUTO][1], outs[Api.TORCH][1], tol=2e-2, min_cosine=0.9999)
    assert r.passed, r


# -- the Q4_0 dequant probes (kernels/int4_probe.py) ---------------------------------

# (K, N, bn, bk): every kind takes 256-column strips and the decode plan
# (4-block splits, the last one short) whatever the tile, K = 11, 33 and 10
# blocks; N not a multiple of the strip, nor of 16 (8-byte weight copies);
# bk is stream's sampled tile (every bk/16-th byte row of each whole tile)
PROBE_SHAPES = [(352, 200, 4096, 128), (1056, 264, 2048, 512), (320, 520, 8192, 64)]
PROBE_CARRIER = {"split_i32": "q4_0", "split_i8": "q4_0", "stream": "q4_0",
                 "i4native": "native", "bitcast": "biased"}


def _probe_case(gen, dev, kind, M, K, N, bn, bk, ksplit=None):
    x = torch.randn((M, K), generator=gen, device=dev).to(torch.bfloat16)
    q = torch.randint(-8, 8, (K, N), generator=gen, device=dev, dtype=torch.int8)
    q[:, :8] = -8
    s = torch.rand((K // 32, N), generator=gen, device=dev) * 0.01 + 0.005
    pack = {"q4_0": pack_int4, "native": ip.pack_int4_native,
            "biased": ip.pack_int4_biased}.get(PROBE_CARRIER.get(kind), ip.pack_int4_mixed)
    if kind in ("andmask_bf16s", "noscale", "halfq8"):
        s = s.to(torch.bfloat16)
    return ip.prepare(kind, x, pack(q), s, M, bn, bk, ksplit=ksplit)


def _probe_agrees(call):
    """One launch of the call's kernel (counted), against its plain version
    within 1e-5·max|y| (the same bf16 plane values; f32 sums in another
    order); returns the kernel's output."""
    key = f"int4_probe_{call.kind}"
    before = launch_counts[key]
    y = call.kernel()
    torch.cuda.synchronize()
    assert launch_counts[key] == before + 1
    ref = ip.kernel_ref(call.kind, call.tensors, call.M, call.N, call.K, call.bn, call.bk)
    assert y.shape == (call.M, call.N) and y.dtype == torch.float32
    assert (y - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()
    return y


@pytest.mark.parametrize("shape", PROBE_SHAPES, ids=lambda s: "K{}_N{}_bn{}_bk{}".format(*s))
@pytest.mark.parametrize("M", [1, 5, 8, 16])
@pytest.mark.parametrize("kind", list(ip.KINDS))
def test_int4_probe_kernels(gen, dev, kind, M, shape):
    """Each probe kernel against its plain version on the card: stream bit
    for bit (integer sums plus one f32 add in both), the others within
    1e-5·max|y| (the same bf16 plane values or int32 partials; f32 sums in
    another order)."""
    call = _probe_case(gen, dev, kind, M, *shape)
    if kind == "stream":
        before = launch_counts["int4_probe_stream"]
        y = call.kernel()
        torch.cuda.synchronize()
        assert launch_counts["int4_probe_stream"] == before + 1
        assert y.shape == (M, shape[1]) and y.dtype == torch.float32
        assert torch.equal(y, ip.kernel_ref(kind, call.tensors, M, call.N, call.K, call.bn,
                                            call.bk))
    else:
        _probe_agrees(call)
    full = call()
    assert torch.isfinite(full).all()


def test_int4_probe_rejects_bad_args(gen, dev):
    call = _probe_case(gen, dev, "andmask", 4, 256, 64, 4096, 128)
    x = call.tensors["xa"]
    with pytest.raises(ValueError):                     # M > 16 on the card
        ip.run_andmask(torch.zeros((17, 256), device=dev, dtype=torch.bfloat16),
                       call.tensors["w"], call.tensors["s"], 17, 4096, 128)
    with pytest.raises(ValueError):                     # N % 8
        ip.run_andmask(torch.zeros((4, 256), device=dev, dtype=torch.bfloat16),
                       torch.zeros((128, 60), device=dev, dtype=torch.int8),
                       torch.zeros((8, 60), device=dev), 4, 4096, 128)
    bad = ip.ProbeCall("andmask", dict(call.tensors, s=call.tensors["s"].half()), 4, 64, 256,
                       4096, 128, lambda y: y)
    with pytest.raises(ValueError):                     # scale dtype
        bad.kernel()
    assert x.is_cuda


def test_int4_probe_attrs_and_cold_timing(gen, dev):
    """The tuner's fit check: every kind reports its ring as dynamic shared
    memory, 3 stages of 16 KB weights and what else a stage holds (plane
    kinds: 4 blocks of scales and 16 bf16 x rows; intdot / w4a8: 16 int8 x
    rows, the f32 scales and a [16][4] sx tile; stream: nothing else), and
    keeps two CTAs an SM with it."""
    from csinn2_tpu_torch.utils.timing import gpu_ms, gpu_ms_cold
    for kind in ip.KINDS:
        for M in (1, 8, 16):
            attrs = ip.kernel_attrs(kind, M)
            if kind in ip.PLANE_KINDS:
                s_bytes = 2 if kind in ("andmask_bf16s", "noscale", "halfq8") else 4
                stage = 16384 + 4 * 256 * s_bytes + 16 * 256
            else:
                stage = 16384 + {"stream": 0}.get(kind, 16 * 128 + 4 * 256 * 4 + 16 * 4 * 4)
            assert attrs["dyn_smem"] == 3 * stage, (kind, M, attrs)
            assert attrs["ctas_per_sm"] >= 2 and 0 < attrs["regs"] <= 128, (kind, M, attrs)
    calls = [_probe_case(gen, dev, "andmask", 8, 1024, 512, 4096, 512) for _ in range(3)]
    assert gpu_ms_cold([c.kernel for c in calls], reps=6) > 0
    assert gpu_ms(calls[0].kernel, reps=4) > 0


# (K, N, ksplit): 11 blocks in 3-block splits (every split ends mid-stage) at
# N % 16 = 8 (8-byte weight copies; i4native 4-byte); 33 blocks, the plan, N
# = 288 (a 32-column second strip, 16-byte copies); 13 blocks in 5-block
# splits at N % 32 = 16 (i4native 4-byte copies, the others 16-byte); the 7B
# w2 depth with 17 strips, the plan
PLANE_TAILS = [(352, 200, 96), (1056, 288, None), (416, 272, 160), (11008, 4112, None)]


@pytest.mark.parametrize("shape", PLANE_TAILS, ids=lambda s: "K{}_N{}_ks{}".format(*s))
@pytest.mark.parametrize("M", [2, 9, 16])
@pytest.mark.parametrize("kind", list(ip.KINDS))
def test_int4_probe_plane_tails(gen, dev, kind, M, shape):
    """Every kind's kernel at the ring's tails against its plain version
    (stream's bk = 32·(K // 64) tiles: 160, 512, 192, 5504); the strip
    counters are zero after each launch."""
    from csinn2_tpu_torch.kernels import qmatmul as tq
    K, N, ksplit = shape
    call = _probe_case(gen, dev, kind, M, K, N, 2048, 32 * (K // 64), ksplit=ksplit)
    _probe_agrees(call)
    counters = tq.strip_counters(dev, torch.cuda.current_stream(dev))
    assert int(torch.count_nonzero(counters)) == 0
    assert torch.isfinite(call()).all()


@pytest.mark.parametrize("kind", list(ip.KINDS))
def test_int4_probe_plane_is_deterministic(gen, dev, kind):
    """The 7B wo (16 splits) and w13 (3 splits) at M = 8: two calls give the
    same bits, since the strip's last CTA sums the partials in split order."""
    for K, N in ((4096, 4096), (4096, 22016)):
        call = _probe_case(gen, dev, kind, 8, K, N, N, 512)
        a = _probe_agrees(call)
        b = call.kernel()
        torch.cuda.synchronize()
        assert torch.equal(a, b)


def test_int4_tile_tuner_splits_launch(gen, dev):
    """Every split length the tile tuner sweeps launches and agrees with the
    plain version (andmask, M = 8)."""
    from csinn2_tpu_torch.examples import int4_tile_tune as tuner
    n_sm = torch.cuda.get_device_properties(dev.index or 0).multi_processor_count
    for K, N in ((2048, 4096), (4096, 1024)):
        cands = tuner.splits(8, N, K, n_sm)
        assert cands[0] == ip.plane_geometry(8, N, K, n_sm)[1] and len(cands) >= 4
        for ksplit in cands:
            _probe_agrees(_probe_case(gen, dev, "andmask", 8, K, N, N, 512, ksplit=ksplit))


def test_int4_probe_plan_matches_the_library(dev):
    """The plane kinds' default split (kernels/qmatmul.py gemm_plan) is the
    decode GEMM library's: the workspaces match at the probe's 7B shapes."""
    from csinn2_tpu_torch.kernels import qmatmul as tq
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    for K, N in ((4096, 12288), (4096, 22016), (11008, 4096), (4096, 4096)):
        for M in (1, 8, 16):
            cols, ksplit = ip.plane_geometry(M, N, K, n_sm)
            splits = -(-K // ksplit)
            assert cols == 256 and splits * M * N == tq.kernel_workspace_floats(
                M, N, K, False, False, 0)


# -- the seventh slice: the redesigned prefill GEMM and split-KV decode ---------------

# every float-x mode of the prefill kernel: (scale_mode, packed_int4, w_transposed,
# carrier range)
PF_MODES = {"q8_0": ("block", False, False, 127), "q4_0": ("block", True, False, 8),
            "int8_channel": ("channel", False, False, 128),
            "int4_channel": ("channel", True, False, 8),
            "none": ("none", False, False, 128), "t_q8_0": ("block", False, True, 127),
            "t_int8_channel": ("channel", False, True, 128),
            "t_q4_0_packed": ("block", True, True, 8),
            "t_int4_channel_packed": ("channel", True, True, 8)}


def _pf_case(gen, dev, mode, M, K, N):
    """x bf16 [M, K] and a weight of `mode` with its scales; every value of
    the first 8 columns at the carrier's minimum."""
    from csinn2_tpu_torch.kernels.qmatmul import pack_int4_t
    scale_mode, packed, trans, lim = PF_MODES[mode]
    x = torch.randn((M, K), generator=gen, device=dev).to(torch.bfloat16)
    lo = -lim
    q = torch.randint(lo, lim if lim != 127 else 128, (K, N), generator=gen, device=dev,
                      dtype=torch.int8)
    q[:, :8] = lo
    if trans:
        w = pack_int4_t(q.t().contiguous()) if packed else q.t().contiguous()
    else:
        w = pack_int4(q) if packed else q
    s_shape = {"block": (N, K // 32) if trans else (K // 32, N), "channel": (N,),
               "none": None}[scale_mode]
    s = None if s_shape is None else \
        (torch.rand(s_shape, generator=gen, device=dev) * 1e-3 + 1e-5).to(torch.float16).float()
    return x, w, s, dict(scale_mode=scale_mode, packed_int4=packed, w_transposed=trans)


@pytest.mark.parametrize("mode", list(PF_MODES))
@pytest.mark.parametrize("M", [17, 127, 129, 640, 2048])
@pytest.mark.parametrize("odt", [torch.bfloat16, torch.float32, torch.int8])
def test_prefill_gemm_every_mode(gen, dev, mode, M, odt):
    """The cp.async tensor-core prefill kernel in every float-x mode at M
    across its 128-row tiles, N = 400 (not a multiple of the 128-column tile),
    K = 1056 = 32 · 33 (not a multiple of the 64-k stage), each output type
    that reaches it (bf16 and f32 written by the kernel, int8 through the
    reduce), against the plain version."""
    K, N = 1056, 400
    x, w, s, kw = _pf_case(gen, dev, mode, M, K, N)
    extra = {}
    if odt == torch.int8:          # outputs of ~10 LSB: most inside the int8 range
        s = None if s is None else s * (8 if PF_MODES[mode][3] > 8 else 130)
        extra = dict(out_zp=3.0, epilogue_scale=None if s is not None else 0.004)
    key = launch_key(kw["scale_mode"], kw["packed_int4"], False,
                     w_transposed=kw["w_transposed"]) + ".prefill"
    before = launch_counts[key]
    y = quant_matmul(x, w, s, out_dtype=odt, **kw, **extra)
    torch.cuda.synchronize()
    assert launch_counts[key] == before + 1
    assert y.dtype == odt and y.shape == (M, N)
    if odt == torch.int8:          # against the function the kernel computes
        ref = _kernel_numerics_ref(x, w, s, None, out_dtype=odt, **kw, **extra)
        d = (y.int() - ref.int()).abs()
        assert int(d.max()) <= 1 and float((d > 0).float().mean()) < 0.05
    else:
        _agree(y, quant_matmul_ref(x, w, s, out_dtype=odt, **kw, **extra))


@pytest.mark.parametrize("mode", ["q8_0", "q4_0", "t_q8_0", "t_q4_0_packed"])
@pytest.mark.parametrize("M", [4, 17, 200])
def test_swiglu_on_every_layout(gen, dev, mode, M):
    """swiglu with the [N, K] and [N, K/2] layouts (and the [K, N] ones)
    through qmm_reduce<SWIGLU>, against the plain version."""
    x, w, s, kw = _pf_case(gen, dev, mode, M, 352, 768)
    y = quant_matmul(x, w, s, out_dtype=torch.bfloat16, swiglu=True, **kw)
    torch.cuda.synchronize()
    assert y.shape == (M, 384)
    ref = quant_matmul_ref(x, w, s, out_dtype=torch.bfloat16, swiglu=True, **kw)
    _agree(y, ref)


def test_gemm_plan_mirror_matches_the_library(dev):
    """kernels/qmatmul.py workspace_floats (the Python mirror of the plan)
    equals the CUDA library's quant_matmul_workspace for every projection of
    Llama-2-7B and 13B at M 1-2048, with and without the swiglu pairs and
    the reduce."""
    from csinn2_tpu_torch.kernels import qmatmul as tq
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    shapes = [(4096, 12288), (4096, 4096), (4096, 22016), (11008, 4096), (4096, 32000),
              (5120, 15360), (5120, 5120), (5120, 27648), (13824, 5120), (352, 400)]
    for K, N in shapes:
        for M in (1, 2, 3, 4, 8, 9, 16, 17, 32, 128, 512, 2048):
            for swiglu, reduce_epi in ((False, False), (False, True), (True, False)):
                want = tq.kernel_workspace_floats(M, N, K, swiglu, reduce_epi, 0)
                assert tq.workspace_floats(M, N, K, swiglu, reduce_epi, n_sm) == want


# -- the eighth slice: the decode GEMM (M <= 16) on the cp.async ring and mma.sync -----

# output dtype → (out_zp, scale factor that puts the outputs at ~10 LSB)
DC_OUTS = {torch.bfloat16: None, torch.float32: None, torch.int8: (3.0, 1),
           torch.uint8: (128.0, 1), torch.int16: (-5.0, 30), torch.int32: (0.0, 1)}


def _decode_args(mode, odt, s):
    """The scales and epilogue arguments of an output type: integer outputs
    take scales (or, with none, an epilogue_scale) that put them at ~10
    LSB, the float ones a bias (where the layout takes one) and an
    epilogue_scale."""
    if DC_OUTS[odt] is None:
        return s, dict(epilogue_scale=0.5)
    zp, f = DC_OUTS[odt]
    lim = PF_MODES[mode][3]
    if s is None:
        return s, dict(out_zp=zp, epilogue_scale=0.004 * f)
    return s * ((8 if lim > 8 else 130) * f), dict(out_zp=zp)


def _check_decode(y, x, w, s, bias, odt, kw):
    ref = _kernel_numerics_ref(x, w, s, bias, out_dtype=odt, **kw)
    if DC_OUTS[odt] is not None:               # 1 LSB: the f32 sums in another order
        d = (y.long() - ref.long()).abs()
        assert int(d.max()) <= 1 and float((d > 0).float().mean()) < 0.05
        return
    _agree(y, quant_matmul_ref(x, w, s, bias, out_dtype=odt, **kw))
    yf, rf = y.float().cpu().numpy(), ref.float().cpu().numpy()
    if odt != torch.bfloat16:
        assert np.all(np.abs(yf - rf) <= 1e-4 * np.abs(rf).max())
        return
    y32 = quant_matmul(x, w, s, bias, out_dtype=torch.float32, **kw).cpu().numpy()
    r32 = _kernel_numerics_ref(x, w, s, bias, out_dtype=torch.float32, **kw).cpu().numpy()
    check_bf16_output(yf, y32, rf, r32, 1e-4 * np.abs(r32).max())


@pytest.mark.parametrize("mode", list(PF_MODES))
@pytest.mark.parametrize("M", [1, 2, 3, 4, 5, 8, 9, 16])
@pytest.mark.parametrize("odt", list(DC_OUTS))
def test_decode_gemm_every_mode(gen, dev, mode, M, odt):
    """The decode kernel in every float-x mode and layout, at every decode
    batch class, with every output type: N = 400 (a multiple of 16, not of
    the 256-column strip), K = 1056 = 32 · 33 (not a multiple of a ring
    stage; split in 33), against the function it computes (integer outputs
    within 1 LSB) and the plain version's gates."""
    K, N = 1056, 400
    x, w, s, kw = _pf_case(gen, dev, mode, M, K, N)
    s, extra = _decode_args(mode, odt, s)
    bias = None
    if DC_OUTS[odt] is None and not (kw["packed_int4"] and kw["w_transposed"]):
        bias = torch.randn(N, generator=gen, device=dev)
    key = launch_key(kw["scale_mode"], kw["packed_int4"], False,
                     w_transposed=kw["w_transposed"]) + ".decode"
    before = launch_counts[key]
    y = quant_matmul(x, w, s, bias, out_dtype=odt, **kw, **extra)
    torch.cuda.synchronize()
    assert launch_counts[key] == before + 1
    assert y.dtype == odt and y.shape == (M, N)
    _check_decode(y, x, w, s, bias, odt, dict(kw, **extra))


@pytest.mark.parametrize("mode", ["q8_0", "q4_0", "int4_channel", "t_q8_0", "t_q4_0_packed"])
@pytest.mark.parametrize("K,N", [(32, 16), (96, 48), (32 * 7, 272), (32 * 257, 48),
                                 (11008, 4112)])
@pytest.mark.parametrize("M", [2, 16])
def test_decode_gemm_ragged(gen, dev, mode, K, N, M):
    """One block (no split), a strip of 16 columns, a last strip of 16 of
    256, K = 32 · 257 split into blocks of a stage's tail, the 7B w2 K with
    17 strips: every split non-empty, the ragged edges zero-filled."""
    x, w, s, kw = _pf_case(gen, dev, mode, M, K, N)
    y = quant_matmul(x, w, s, out_dtype=torch.float32, **kw)
    torch.cuda.synchronize()
    _check_decode(y, x, w, s, None, torch.float32, kw)


@pytest.mark.parametrize("mode", ["q8_0", "q4_0", "int8_channel", "int4_channel", "t_q8_0",
                                  "t_q4_0_packed"])
@pytest.mark.parametrize("M", [1, 4, 16])
def test_decode_swiglu_7b_width(gen, dev, mode, M):
    """swiglu at the 7B w13 of the swiglu128 layout (K 4096, N 22528: 88
    strips, each a whole pair group, split in 3): the pair formed in the
    strip's last CTA."""
    x, w, s, kw = _pf_case(gen, dev, mode, M, 4096, 22528)
    before = launch_counts["quant_matmul_swiglu.decode"] if not kw["w_transposed"] else None
    y = quant_matmul(x, w, s, out_dtype=torch.bfloat16, swiglu=True, **kw)
    torch.cuda.synchronize()
    if before is not None:
        assert launch_counts["quant_matmul_swiglu.decode"] == before + 1
    assert y.shape == (M, 11264)
    _agree(y, quant_matmul_ref(x, w, s, out_dtype=torch.bfloat16, swiglu=True, **kw))
    ref = _kernel_numerics_ref(x, w, s, None, out_dtype=torch.float32, swiglu=True, **kw)
    assert np.abs(y.float().cpu().numpy() - ref.cpu().numpy()).max() \
        <= 2.0 ** -7 * float(ref.abs().max())


@pytest.mark.parametrize("mode", ["q8_0", "q4_0", "int8_channel", "t_q8_0", "t_q4_0_packed"])
@pytest.mark.parametrize("K,N,M", [(4096, 4096, 4), (11008, 4096, 9), (4096, 22016, 1)])
def test_decode_gemm_is_deterministic(gen, dev, mode, K, N, M):
    """The 7B wo, w2 and w13 (16, 16 and 3 splits): two calls give the same
    bits, since the strip's last CTA sums the partials in split order."""
    x, w, s, kw = _pf_case(gen, dev, mode, M, K, N)
    a = quant_matmul(x, w, s, out_dtype=torch.float32, **kw)
    b = quant_matmul(x, w, s, out_dtype=torch.float32, **kw)
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    _agree(a, quant_matmul_ref(x, w, s, out_dtype=torch.float32, **kw))


def test_decode_counters_stay_zero(gen, dev):
    """The strip counters are zero after every launch: after a launch the
    library refuses (a workspace too small: nothing runs), after ragged and
    swiglu launches, and a call after each is correct."""
    import ctypes
    from csinn2_tpu_torch.kernels import _build
    from csinn2_tpu_torch.kernels import qmatmul as tq
    stream = torch.cuda.current_stream(dev)
    counters = tq.strip_counters(dev, stream)
    x, w, s, kw = _pf_case(gen, dev, "q8_0", 4, 4096, 4096)
    out = torch.empty((4, 4096), device=dev)
    ws = torch.empty((16,), device=dev)
    fn = _build.c_function("qmatmul", "quant_matmul_int8", tq._FLOAT_ARGTYPES)
    err = fn(x.data_ptr(), w.data_ptr(), s.data_ptr(), None, out.data_ptr(), 0, 0, 0, 0,
             1.0, 0, 0.0, ws.data_ptr(), ctypes.c_longlong(16), counters.data_ptr(),
             tq.COUNTER_SLOTS, 4, 4096, 4096, dev.index or 0, stream.cuda_stream)
    assert err != 0                            # refused before any launch
    cases = [("q8_0", 4, 4096, 4096, False), ("t_q4_0_packed", 16, 32 * 257, 48, False),
             ("q4_0", 3, 352, 768, True), ("int8_channel", 9, 1056, 4112, False)]
    for mode, M, K, N, swiglu in cases:
        x, w, s, kw = _pf_case(gen, dev, mode, M, K, N)
        y = quant_matmul(x, w, s, out_dtype=torch.float32, swiglu=swiglu, **kw)
        torch.cuda.synchronize()
        assert int(torch.count_nonzero(counters)) == 0
        _agree(y, quant_matmul_ref(x, w, s, out_dtype=torch.float32, swiglu=swiglu, **kw))


def test_decode_ring_stream(gen, dev):
    """The ring alone (timing aid) runs at a 7B shape and writes nothing."""
    from csinn2_tpu_torch.kernels import qmatmul as tq
    for mode in ("q8_0", "q4_0"):
        x, w, s, kw = _pf_case(gen, dev, mode, 8, 4096, 22016)
        tq.decode_ring_stream(x, w, s, kw["packed_int4"])
    torch.cuda.synchronize()
    with pytest.raises(ValueError):
        tq.decode_ring_stream(x.repeat(2, 1), w, s, True)     # M = 16


@pytest.mark.parametrize("int8", [True, False])
@pytest.mark.parametrize("d", [16, 17, 80, 128, 256, 576])
@pytest.mark.parametrize("hq,hk", [(32, 32), (8, 2), (32, 8)])
def test_decode_attention_split_kv(gen, dev, int8, d, hq, hk):
    """The split-KV decode_attention: kv_len 0, 1, chunk ± 1 and the whole
    window S across its chunks, GQA, int8 and bf16 KV as strided views of the
    cache layout, an f32 q (rounded to bf16) at d = 80; a row with kv_len 0
    outputs 0; the merge launches once per call when the window is split
    (d = 576: the wide kernel's split-KV decode and its merge)."""
    S = 1100
    b = 7
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    kvb = 1 if int8 else 2
    if d > fa.MAX_D:
        p = fa._wide_plan(b, 1, hq, hk, S, d, kvb, n_sm)
        chunk, n_chunks, name = p.chunk, p.n_chunks, "attention_wide.decode_attention"
    else:
        chunk, n_chunks = fa._decode_plan(b, hq, hk, S, d, kvb, n_sm)
        name = "decode_attention"
    lens = [0, 1, chunk - 1, chunk, chunk + 1, S - 1, S]
    k, v = _kv(gen, dev, b, hk, S, d, int8)
    qdt = torch.float32 if d == 80 else torch.bfloat16
    q = torch.randn((b, hq, 1, d), generator=gen, device=dev).to(qdt)
    kvl = torch.tensor(lens, dtype=torch.int32, device=dev)
    before = dict(launch_counts)
    out, ref = _attend("decode_attention", q, k, v, causal=False, q_offset=kvl - 1,
                       kv_len=kvl, kv_scale=0.05 if int8 else None)
    assert launch_counts[name] == before.get(name, 0) + 1
    assert launch_counts[f"{name}.combine"] == \
        before.get(f"{name}.combine", 0) + (1 if n_chunks > 1 else 0)
    assert out.dtype == qdt and out.shape == q.shape
    _close(out, ref)
    assert torch.isfinite(out).all() and float(out[0].abs().max()) == 0.0


@pytest.mark.parametrize("kv_len", [0, 1, 63, 64, 65, 127, 128, 129, 255, 256, 257, 2047, 2048])
def test_decode_attention_every_chunk_edge(gen, dev, kv_len):
    """The 7B decode shape (hq = hk = 32, d = 128, S = 2048, int8 KV) at
    kv_len on each side of the chunk boundaries, with a second row at the
    whole window."""
    k, v = _kv(gen, dev, 2, 32, 2048, 128, True)
    q = torch.randn((2, 32, 1, 128), generator=gen, device=dev).to(torch.bfloat16)
    kvl = torch.tensor([kv_len, 2048], dtype=torch.int32, device=dev)
    out, ref = _attend("decode_attention", q, k, v, causal=False, q_offset=kvl - 1,
                       kv_len=kvl, kv_scale=0.05)
    _close(out, ref)
    if kv_len == 0:
        assert float(out[0].abs().max()) == 0.0


def _kernel_counts():
    """The kernels' launch counts (the graphs' own counts left out)."""
    return {k: n for k, n in launch_counts.items() if not k.startswith("decode_graph.")}


def _count_diff(before, after):
    return {k: n - before.get(k, 0) for k, n in after.items() if n != before.get(k, 0)}


@pytest.mark.parametrize("model,flash", [("tiny", False), ("tiny", True), ("7b_2layer", False)])
def test_decode_graph_matches_the_eager_loop(dev, monkeypatch, model, flash):
    """decode_steps on the card (the captured step graph) against
    _decode_steps_eager on a second engine over the same weights, chunk by
    chunk: greedy, seeded with a per-row temperature, with top-k / top-p, a
    prompt admitted into the third lane between chunks, the kv_bound moving
    from 256 to 512, and a chunk whose key was seen (no capture).  Tokens
    and positions equal, the kernels' launch counts of each chunk equal to
    the eager loop's (one graph replay a step), one capture per new key, and
    the decode GEMM's strip counters at zero after the replays."""
    import dataclasses
    from csinn2_tpu_torch.kernels import qmatmul as tq
    from csinn2_tpu_torch.llm.config import LlamaConfig
    from csinn2_tpu_torch.llm.engine import InferenceEngine
    from csinn2_tpu_torch.llm.model import init_params, init_params_device
    if flash:
        monkeypatch.setenv("CSINN2_DECODE_ATTN", "flash")
    else:
        monkeypatch.delenv("CSINN2_DECODE_ATTN", raising=False)
    if model == "tiny":
        cfg = LlamaConfig.tiny(max_seq=640)
        params = init_params(cfg, "q8_0", seed=5, device=dev)
    else:
        cfg = dataclasses.replace(LlamaConfig.llama2_7b(), n_layers=2, max_seq_len=640)
        params = init_params_device(cfg, "q4_0", seed=3, device=dev)
    graph = InferenceEngine(cfg, params, batch=3, quantized_kv=True, device=dev)
    eager = InferenceEngine(cfg, graph.params, batch=3, quantized_kv=True, device=dev)
    rng = np.random.default_rng(0)
    prompts = [[int(t) for t in rng.integers(1, cfg.vocab_size, n)] for n in (240, 5, 37)]
    nxt = {}
    for sid in (0, 1):
        nxt[sid] = graph.prefill_sample(sid, prompts[sid])
        assert eager.prefill_sample(sid, prompts[sid]) == nxt[sid]
    chunks = [(5, {}, 1),
              (4, dict(temperature=np.array([0.7, 1.3, 0.0], np.float32), seed=3), 1),
              (3, dict(temperature=0.9, seed=4, top_k=20, top_p=0.9), 1),
              "admit",
              (6, {}, 1),           # max pos 252 + 6 + 1 > 256: kv_bound 512
              (6, {}, 0)]           # the same key: replayed, not captured
    for chunk in chunks:
        if chunk == "admit":
            nxt[2] = graph.prefill_sample(2, prompts[2])
            assert eager.prefill_sample(2, prompts[2]) == nxt[2]
            continue
        n, kw, captures = chunk
        c0, g0 = _kernel_counts(), dict(launch_counts)
        got = graph.decode_steps(dict(nxt), n, **kw)
        c1, g1 = _kernel_counts(), dict(launch_counts)
        want = eager._decode_steps_eager(dict(nxt), n, **kw)
        torch.cuda.synchronize()
        assert got == want, (chunk, got, want)
        assert [s.pos for s in graph.slots] == [s.pos for s in eager.slots]
        assert _count_diff(c0, c1) == _count_diff(c1, _kernel_counts())
        assert g1.get("decode_graph.replay", 0) - g0.get("decode_graph.replay", 0) == n
        assert g1.get("decode_graph.capture", 0) - g0.get("decode_graph.capture", 0) == captures
        assert all(int(torch.count_nonzero(c)) == 0 for c in tq._counters.values())
        nxt = {sid: seq[-1] for sid, seq in got.items()}
    assert len(graph._graphs) == 4 and eager._graphs == {}
    assert sorted({k[0] for k in graph._graphs}) == [256, 512]


def test_engine_benchmarks_on_the_card(dev):
    """The three benchmark methods at LlamaConfig.tiny() on the card: finite
    positive numbers; benchmark_prefill_device and a batch-1
    benchmark_decode_device leave the engine's cache, slots and graphs as
    they were; batch 2 decodes through the step graph."""
    from csinn2_tpu_torch.llm.config import LlamaConfig
    from csinn2_tpu_torch.llm.engine import InferenceEngine
    from csinn2_tpu_torch.llm.model import init_params
    cfg = LlamaConfig.tiny(max_seq=640)
    eng = InferenceEngine(cfg, init_params(cfg, "q8_0", seed=5, device=dev), batch=2,
                          quantized_kv=True, device=dev)
    eng.prefill(0, list(range(1, 30)))
    k0, v0 = eng.cache.k.clone(), eng.cache.v.clone()
    t = eng.benchmark_prefill_device(n_prompt=40, iters=2, reps=1)
    assert np.isfinite(t) and t > 0
    one = InferenceEngine(cfg, eng.params, batch=1, quantized_kv=True, device=dev)
    one.prefill(0, [5, 6, 7])
    k1 = one.cache.k.clone()
    tps = one.benchmark_decode_device(iters=16, reps=1)
    assert np.isfinite(tps) and tps > 0
    assert torch.equal(one.cache.k, k1) and one._graphs == {} and one.slots[0].pos == 3
    assert torch.equal(eng.cache.k, k0) and torch.equal(eng.cache.v, v0)
    replays = launch_counts.get("decode_graph.replay", 0)
    tps = eng.benchmark_decode_device(iters=16, reps=1)
    assert np.isfinite(tps) and tps > 0
    assert launch_counts["decode_graph.replay"] - replays == 2 * (2 + 18)
    assert [s.pos for s in eng.slots] == [29, 0]
    tps = eng.benchmark_decode(iters=3, warmup=1)
    assert np.isfinite(tps) and tps > 0


# -- tensor parallelism: the kernels at a rank's shapes, the engine over ranks ----------

# a rank's GEMMs under tp = 2 at Llama-2-7B width (wqkv, wo, w13, w2 with K
# 5504 = 172 blocks, lm_head) and a Mixtral-8x7B expert's under tp = 2 x ep = 2
TP_SHARDS = [(4096, 6144), (2048, 4096), (4096, 11008), (5504, 4096), (4096, 16000),
             (4096, 7168), (7168, 4096)]


@pytest.mark.parametrize("mode", ["q8_0", "q4_0"])
@pytest.mark.parametrize("K,N", TP_SHARDS)
@pytest.mark.parametrize("M", [1, 3, 16, 17, 100])
def test_quant_matmul_tp_shard_shapes(gen, dev, mode, K, N, M):
    x, w, s, kw = _mode_case(gen, dev, mode, M, K, N)
    y = quant_matmul(x, w, s, out_dtype=torch.bfloat16, **kw)
    torch.cuda.synchronize()
    assert y.shape == (M, N)
    _agree(y, quant_matmul_ref(x, w, s, out_dtype=torch.bfloat16, **kw))


@pytest.mark.parametrize("name", ["decode_attention", "prefill_attention", "flash_attention"])
@pytest.mark.parametrize("int8", [True, False])
def test_attention_tp_shard_heads(gen, dev, name, int8):
    """16 query and KV heads at head dim 128 (a rank's of Llama-2-7B at tp =
    2), ragged KV lengths."""
    b, hq, d, S = (3, 16, 128, 1000) if name == "decode_attention" else (1, 16, 128, 700)
    k, v = _kv(gen, dev, b, hq, S, d, int8)
    scale = 0.05 if int8 else None
    if name == "decode_attention":
        q = torch.randn((b, hq, 1, d), generator=gen, device=dev).to(torch.bfloat16)
        kv_len = torch.tensor([S, 0, 333], dtype=torch.int32, device=dev)
        out = fa.decode_attention(q, k, v, q_offset=kv_len - 1, kv_len=kv_len, kv_scale=scale)
        ref = fa._attention_ref(q, k, v, causal=False, q_offset=kv_len - 1, kv_len=kv_len,
                                scale=1 / d ** 0.5, kv_scale=scale)
    else:
        sq = 301
        q = torch.randn((1, sq, hq, d), generator=gen, device=dev).to(torch.bfloat16)
        fn = getattr(fa, name)
        extra = {} if name == "prefill_attention" else dict(qo_layout="bshd")
        out = fn(q, k, v, causal=True, q_offset=0, kv_len=sq, kv_scale=scale, **extra)
        ref = fa._attention_ref(q.permute(0, 2, 1, 3), k, v, causal=True, q_offset=0,
                                kv_len=sq, scale=1 / d ** 0.5,
                                kv_scale=scale).permute(0, 2, 1, 3)
    torch.cuda.synchronize()
    _close(out, ref)


def _mesh_engine_rank(backend_note: str):
    """One rank of the tp = 2 engine at LlamaConfig.tiny() Q8_0: run_queue's
    greedy tokens, the step-graph choice and the graphs captured."""
    from csinn2_tpu_torch.llm.config import LlamaConfig
    from csinn2_tpu_torch.llm.engine import InferenceEngine, Request
    from csinn2_tpu_torch.llm.model import init_params
    from csinn2_tpu_torch.parallel.mesh import make_mesh
    mesh = make_mesh(tp=2, device="cuda")
    cfg = LlamaConfig.tiny()
    eng = InferenceEngine(cfg, init_params(cfg, "q8_0", seed=5, device=mesh.device), batch=2,
                          quantized_kv=True, mesh=mesh)
    reqs = eng.run_queue([Request(prompt=p, max_new_tokens=6) for p in ([3, 7, 11], [5, 2])],
                         chunk=3)
    return dict(outs=[r.out for r in reqs], graph=eng._graph, graphs=len(eng._graphs),
                note=backend_note)


@pytest.mark.parametrize("backend", ["gloo", "nccl"])
def test_engine_tp2_on_the_card(dev, backend):
    """tp = 2 over gloo (two ranks sharing card 0, the eager loop) and over
    NCCL (one card a rank, collectives captured in the step graph): every
    rank's greedy tokens equal to the one-device engine's on the card."""
    from csinn2_tpu_torch.llm.config import LlamaConfig
    from csinn2_tpu_torch.llm.engine import InferenceEngine, Request
    from csinn2_tpu_torch.llm.model import init_params
    from csinn2_tpu_torch.parallel.launch import spawn
    if backend == "nccl" and torch.cuda.device_count() < 2:
        pytest.skip(f"NCCL needs a card a rank: {torch.cuda.device_count()} card here")
    cfg = LlamaConfig.tiny()
    one = InferenceEngine(cfg, init_params(cfg, "q8_0", seed=5, device=dev), batch=2,
                          quantized_kv=True, device=dev)
    want = [r.out for r in one.run_queue(
        [Request(prompt=p, max_new_tokens=6) for p in ([3, 7, 11], [5, 2])], chunk=3)]
    ranks = spawn(_mesh_engine_rank, 2, backend=backend, device="cuda", timeout_s=300,
                  args=(backend,))
    for r in ranks:
        assert r["outs"] == want
        assert r["graph"] == (backend == "nccl")
        assert (r["graphs"] > 0) == (backend == "nccl")


def _ring_rank(S: int):
    """One rank of the cp = 2 ring on the card: the gathered output."""
    from csinn2_tpu_torch.parallel.cp import gather_sequence, ring_attention, shard_sequence
    from csinn2_tpu_torch.parallel.mesh import Mesh
    mesh = Mesh({"cp": 2}, device="cuda")
    qkv = _ring_qkv(mesh.device, S)
    out = ring_attention(*(shard_sequence(t, mesh) for t in qkv), mesh, causal=True)
    return gather_sequence(out, mesh).cpu().numpy()


def _ring_qkv(device, S):
    g = torch.Generator(device=device)
    g.manual_seed(16)
    return [torch.randn((1, 4, S, 64), generator=g, device=device) for _ in range(3)]


def test_ring_attention_cp2_on_the_card(dev):
    """Ring attention over two ranks sharing the card on gloo (K/V hops
    staged through the host) against the one-process reference, f32 at the
    JAX test's 2e-5."""
    from csinn2_tpu_torch.parallel.cp import ring_attention_reference
    from csinn2_tpu_torch.parallel.launch import spawn
    ranks = spawn(_ring_rank, 2, backend="gloo", device="cuda", timeout_s=300, args=(512,))
    want = ring_attention_reference(*_ring_qkv(dev, 512), causal=True).cpu().numpy()
    for got in ranks:
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("micro", [1, 2])
def test_pipelined_llama_on_the_card(dev, micro):
    """PipelinedLlama with both stages on the card: the prefill's and a
    decode step's logits and every cache row bit for bit against
    llama_forward run microbatch by microbatch (Q8_0, int8 KV)."""
    from csinn2_tpu_torch.llm.config import LlamaConfig
    from csinn2_tpu_torch.llm.model import KVCache, init_params, llama_forward
    from csinn2_tpu_torch.parallel.pp import PipelinedLlama
    cfg = LlamaConfig.tiny()
    params = init_params(cfg, "q8_0", seed=5, device=dev)
    toks = torch.tensor([[3, 7, 11, 19], [5, 2, 9, 4]])
    ref = KVCache.create(cfg, 2, quantized=True, device=dev)
    mb = 2 // micro

    def per_mb(t, pos):
        return torch.cat([llama_forward(params, t[m * mb:(m + 1) * mb],
                                        KVCache(k=ref.k[:, m * mb:(m + 1) * mb],
                                                v=ref.v[:, m * mb:(m + 1) * mb],
                                                scale=ref.scale), pos, cfg)[0]
                          for m in range(micro)])
    pipe = PipelinedLlama(params, cfg, [dev, dev])
    caches = pipe.init_caches(2, quantized=True)
    for t, pos in ((toks, 0), (toks[:, :1], 4)):
        got, caches = pipe(t, caches, pos, microbatches=micro)
        assert torch.equal(got, per_mb(t, pos))
        assert torch.equal(torch.cat([c.k for c in caches]), ref.k)
        assert torch.equal(torch.cat([c.v for c in caches]), ref.v)


def _fc_chain(mode, dev, ws, host_middle):
    """x → fc(w0) → [host if host_middle] fc(w1) → fc(w2), the block weights
    on the op API (quant_matmul_t on the card's tier)."""
    from csinn2_tpu_torch import ops
    from csinn2_tpu_torch.core.dtypes import Dtype, RunMode
    from csinn2_tpu_torch.core.tensor import TensorMeta
    from csinn2_tpu_torch.runtime.session import Session
    sess = Session(run_mode=getattr(RunMode, mode), device=dev)
    with sess.build():
        x = sess.input(TensorMeta(shape=(24, 256), dtype=Dtype.FLOAT32))
        h = ops.fullyconnected(x, ws[0])
        if host_middle:
            with sess.device_scope("host"):
                h = ops.fullyconnected(h, ws[1])
        else:
            h = ops.fullyconnected(h, ws[1])
        sess.set_output(ops.fullyconnected(h, ws[2]))
    return sess.setup()


def test_hybrid_session_on_the_card(dev):
    """A HYBRID session on the card with its middle node on the host: three
    subgraphs (accel → host → accel), quant_matmul_t launched by the accel
    subgraphs only, each block weight placed once a subgraph, the output
    against the GRAPH session on the card (cosine >= 0.9999) and timed by
    run_benchmark_device."""
    from csinn2_tpu_torch.core.dtypes import QuantScheme
    from csinn2_tpu_torch.core.quant import block_quantize
    from csinn2_tpu_torch.core.tensor import Tensor
    from csinn2_tpu_torch.kernels import reset_launch_counts
    rng = np.random.default_rng(3)
    ws = [Tensor(block=block_quantize((rng.standard_normal((256, 256)) * 0.1)
                                      .astype(np.float32), QuantScheme.BLOCK_Q8_0))
          for _ in range(3)]
    x = rng.standard_normal((24, 256)).astype(np.float32)
    hyb = _fc_chain("HYBRID", dev, ws, True)
    ref = _fc_chain("GRAPH", dev, ws, False)
    subs = hyb._hybrid.subgraphs
    assert [s.device for s in subs] == ["accel", "host", "accel"]
    assert not hyb.graph.nodes[1].cb_name.endswith(":cuda")
    assert all(n.cb_name.endswith(":cuda") for i, n in enumerate(hyb.graph.nodes) if i != 1)
    assert all(v.device.type == "cpu" for pair in subs[1].consts.values() for v in pair)
    env = {id(hyb.graph.inputs[0]): torch.from_numpy(x).to(dev)}
    for sg in subs:
        reset_launch_counts()
        hyb._hybrid.run_subgraph(sg, env)
        torch.cuda.synchronize()
        n = sum(v for k, v in launch_counts.items() if k.startswith("quant_matmul_t"))
        assert n == (0 if sg.device == "host" else len(sg.nodes)), (sg, dict(launch_counts))
    got = hyb.run(x)
    assert got.device.type == "cuda"
    assert cosine_similarity(got.cpu().numpy(), ref.run(x).cpu().numpy()) >= 0.9999
    assert 0 < hyb.run_benchmark_device(x, iters=4, reps=2) < 1.0


def test_load_model_of_a_fused_mobilenet_on_the_card(dev, tmp_path, monkeypatch):
    """A fused MobileNetV1-32 saved on the card and load_model()ed there
    (from weights.npz and from placed_consts.pt): the logits bit for bit,
    13 fused_dsconv launches a forward."""
    from csinn2_tpu_torch.core.dtypes import QuantScheme
    from csinn2_tpu_torch.models.mobilenet import MobileNetV1
    from csinn2_tpu_torch.runtime.export import load_model, save_model
    monkeypatch.delenv("CSINN2_NO_FUSE_DS", raising=False)
    monkeypatch.setenv("CSINN2_FUSE_DS", "1")
    m = MobileNetV1(input_size=32)
    x = np.random.default_rng(0).random(m.input_shape(2)).astype(np.float32)
    m.calibrate(x[:1], device=dev)
    s = m.build_session(QuantScheme.INT8_SYM, batch=2, device=dev)
    xin = m.prepare_input(x, s)
    want = s.run(xin)
    for aot in (False, True):
        path = save_model(s, str(tmp_path / f"m{aot}"), aot=aot)
        monkeypatch.delenv("CSINN2_FUSE_DS")
        s2 = load_model(path, device=dev)
        monkeypatch.setenv("CSINN2_FUSE_DS", "1")
        before = launch_counts["fused_dsconv"]
        got = s2.run(xin)
        torch.cuda.synchronize()
        assert launch_counts["fused_dsconv"] - before == 13
        assert torch.equal(got, want)


def test_layer_benchmark_on_the_card(dev, monkeypatch):
    """run_layer_benchmark on a fused MobileNetV1-32 session on the card:
    one positive time a node (CUDA events, long minus short)."""
    from csinn2_tpu_torch.core.dtypes import QuantScheme
    from csinn2_tpu_torch.models.mobilenet import MobileNetV1
    monkeypatch.delenv("CSINN2_NO_FUSE_DS", raising=False)
    monkeypatch.setenv("CSINN2_FUSE_DS", "1")
    m = MobileNetV1(alpha=0.25, input_size=32)
    x = np.random.default_rng(1).random(m.input_shape(4)).astype(np.float32)
    m.calibrate(x[:1], device=dev)
    s = m.build_session(QuantScheme.INT8_SYM, batch=4, device=dev)
    res = s.run_layer_benchmark(m.prepare_input(x, s), iters=8)
    assert len(res) == len(s.graph.nodes) == 17
    assert all(ms > 0 for ms in res.values())
    assert sum("+" in k for k in res) == 13   # the fused blocks, "dw<i>+pw<i>"
