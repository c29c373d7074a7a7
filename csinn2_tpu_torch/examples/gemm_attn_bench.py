"""Times of quant_matmul (the decode GEMM at M <= 16, the prefill GEMM
above) and of decode attention on the card, warm and cold, beside one
library call each; optionally for several trees of this repository in turns,
so two versions compare inside one call on one card.

    python3 csinn2_tpu_torch/examples/gemm_attn_bench.py
    python3 csinn2_tpu_torch/examples/gemm_attn_bench.py --trees OLD . . OLD
    python3 csinn2_tpu_torch/examples/gemm_attn_bench.py --only decode
    python3 csinn2_tpu_torch/examples/gemm_attn_bench.py --only probe,decode --trees OLD . . OLD
    python3 csinn2_tpu_torch/examples/gemm_attn_bench.py --only int8,dsconv --trees OLD . . OLD
    python3 csinn2_tpu_torch/examples/gemm_attn_bench.py --only wide --trees OLD . . OLD

With --trees, each tree (a directory holding csinn2_tpu_torch/) runs this
file in a process of its own that imports the package from that tree;
the rows of all runs are printed as one table, then the decode GEMMs' sum
per batch-4 decode step (32 layers × wqkv + wo + w13 + w2, cold) of each
run, the probe rows' factors over cur and the 13 fused_dsconv blocks' sum,
then one JSON list on the last line.  --only picks groups of cases,
comma-separated (decode, prefill, attention, probe, int8, dsconv, wide;
default: attention, decode, prefill).  Cases:

  * decode: quant_matmul at M = 1, 4, 8 and 16 on the Llama-2-7B w13 (K
    4096, N 22016; swiglu N 22528, out [M, 11264]) in the seven float-x
    modes (Q8_0, INT8_CHANNEL, scale_mode "none", Q4_0, INT4_CHANNEL, Q4_0
    + swiglu, Q8_0 [N, K]) and the packed Q4_0 [N, K/2], and on wqkv (4096 ×
    12288), wo (4096 × 4096) and w2 (11008 × 4096) in Q8_0 and Q4_0; then,
    where the tree has it, the decode kernel's cp.async ring alone over the
    Q8_0 and Q4_0 w13 bytes at M = 8 (no math: its copy rate);
  * prefill: the seven w13 modes at M = 128, Q8_0 and Q4_0 at M = 512 and
    2048; the library call is torch.matmul on the dequantized bf16 weight;
  * probe: cur(quant_matmul) and the Q4_0 dequant probe's kernels
    (examples/int4_dequant_probe.py: the eight plane kinds split_i32,
    split_i8, i4native, bitcast, andmask, andmask_bf16s, noscale, halfq8;
    stream; the W4A8 pipelines intdot and w4a8, and w4a8 at main's bn 2048
    and 1024) at its four Llama-2-7B decode shapes (wqkv, w13, w2, wo) and
    inputs, M = 8, and at w13 also M = 1 and 16; the kernel alone, cold,
    beside torch.matmul on the dequantized bf16 weight (cold), each row's
    own bound (kernels/int4_probe.py kernel_bytes; intdot and w4a8 against
    the int8 peak) and its cosine against the probe's golden, then each
    row's factor over cur and over torch.matmul; then the decode ring
    alone;
  * int8: the int8-x GEMM (int8 x, INT8_CHANNEL weights) on the w13 in its
    three layouts ([K, N], [N, K], packed [K/2, N]) at M = 1, 4, 8, 16 and
    128, in the float epilogue (channel scale, f32 out) and the requantize
    (int32 bias, rq_mult → int8), cold, each bit for bit its plain version;
    the library call is torch._int_mm on the faster of its two operand
    layouts (w [K, N], and the [N, K] copy's .t() view, which cuBLASLt
    takes column-major), x zero-padded to 32 rows at M <= 16 (it refuses
    fewer), cold;
  * dsconv: fused_dsconv at MobileNetV1's 13 block shapes (alpha 1.0, 224)
    at batch 128 and 1, warm, each bit for bit fused_dsconv_ref; bound =
    max(the bytes of x, the weights, the output / 3.35 TB/s, N·Ho·Wo·(k²·C
    + 2·C·O) / 1979 TOP/s int8); no library call computes the block;
  * wide: attention at head dims above 256 (PERF.md row 2''), kv_scale 0.05
    on int8 KV: causal bhsd flash_attention at b 1, sq = S = 512, and
    decode_attention at b 4, S 2048, kv_len 2048 / 1027 / 0 / 17, GQA 32/8
    at d = 320 and 576 (int8), d = 300 (int8 rows 4-byte aligned: the
    cp.async loader) and d = 320 with bf16 KV (no widening); absorbed MLA's
    decode (hq 128 on one KV head, d 576) with int8 and bf16 KV; warm, each
    against its plain version at the attention gate (verify(2e-2), cosine >=
    0.9999), beside the plain version's time; the library call is SDPA on
    the dequantized K/V (GQA-expanded; MLA's one head broadcast), the decode
    with the kv_len mask.  Then, in a tree with _wide_plan, the chunk sweep:
    the d = 320 and 576 decodes, both MLA decodes and the d = 320 prefill at
    every chunk of WIDE_CHUNKS and at the whole window (the plan's own
    marked *);
  * attention: decode attention at row 2's shape (b 4, hq = hk = 32, d 128,
    S 2048, int8 KV, kv_len 2048 / 1027 / 0 / 17) through decode_attention,
    and row 4''s (kv_len 2048 / 1027 / 1 / 17, causal) through bhsd
    flash_attention; the library call is SDPA on the dequantized bf16 K/V
    with the mask.

"warm": utils.timing.gpu_ms (back-to-back calls, operands that fit stay in
the 50 MB L2); "cold": gpu_ms_cold over copies of the operands whose total
exceeds twice the L2.  Bound = max(bytes once / 3.35 TB/s, flops / 989
TFLOP/s).  Every row carries the card's nvidia-smi name and power limit.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
from pathlib import Path

HBM = 3.35e12
BF16 = 989e12
INT8 = 1979e12
K7, N13, NSW = 4096, 22016, 22528
# label → (scale_mode, packed_int4, w_transposed, swiglu)
GEMM_MODES = {"1a q8_0": ("block", False, False, False),
              "1b int8_channel": ("channel", False, False, False),
              "1b' none": ("none", False, False, False),
              "1c q4_0": ("block", True, False, False),
              "1b+1c int4_channel": ("channel", True, False, False),
              "1e q4_0 swiglu": ("block", True, False, True),
              "1e' q8_0 [N,K]": ("block", False, True, False),
              "1e' q4_0 [N,K/2]": ("block", True, True, False)}
# (projection, K, N) of one Llama-2-7B layer; w13 in the swiglu128 layout is N13 → NSW
PROJ = {"wqkv": (4096, 12288), "wo": (4096, 4096), "w13": (K7, N13), "w2": (11008, 4096)}
DECODE_MS = (1, 4, 8, 16)
# (label, projection, Ms) of each group
GROUPS = {
    "decode": [(label, "w13", DECODE_MS) for label in GEMM_MODES]
    + [(label, p, DECODE_MS) for p in ("wqkv", "wo", "w2") for label in ("1a q8_0", "1c q4_0")],
    "prefill": [(label, "w13", (128,)) for label in GEMM_MODES if label != "1e' q4_0 [N,K/2]"]
    + [(label, "w13", (512, 2048)) for label in ("1a q8_0", "1c q4_0")],
}
N_LAYERS = 32   # Llama-2-7B: the per-step sum of the decode GEMMs
BENCH_GROUPS = ("attention", "decode", "prefill", "probe", "int8", "dsconv", "wide")
I8_MS = (1, 4, 8, 16, 128)
# MobileNetV1's 13 depthwise-separable blocks (alpha 1.0, 224): (H, C, O, stride)
MOBILENET_BLOCKS = ((112, 32, 64, 1), (112, 64, 128, 2), (56, 128, 128, 1),
                    (56, 128, 256, 2), (28, 256, 256, 1), (28, 256, 512, 2)) \
    + ((14, 512, 512, 1),) * 5 + ((14, 512, 1024, 2), (7, 1024, 1024, 1))


def gpu_line() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], check=True, capture_output=True,
                          text=True, timeout=60).stdout.strip().splitlines()[0]


def _bound(nbytes: float, flops: float, peak: float = BF16):
    tb, tf = nbytes / HBM, flops / peak
    return max(tb, tf) * 1e3, "bytes" if tb >= tf else "operations"


def _gemm_operands(g, label: str, proj: str):
    """(weight, scales, dequantized bf16 [K, N] weight, kwargs, K, N) of a mode."""
    import torch
    from csinn2_tpu_torch.kernels.qmatmul import pack_int4, pack_int4_t
    scale_mode, packed, trans, swiglu = GEMM_MODES[label]
    K, N = PROJ[proj]
    N = NSW if swiglu else N
    lo, hi = (-8, 8) if packed else (-128, 128)
    q = torch.randint(lo, hi, (K, N), generator=g, device="cuda", dtype=torch.int8)
    if scale_mode == "block":
        s = (torch.rand((K // 32, N), generator=g, device="cuda") * 2e-4 + 1e-5) \
            .to(torch.float16).float()
        deq = (q.float().reshape(K // 32, 32, N) * s[:, None]).reshape(K, N)
    elif scale_mode == "channel":
        s = torch.rand((N,), generator=g, device="cuda") * 2e-4 + 1e-5
        deq = q.float() * s
    else:
        s, deq = None, q.float()
    if trans:
        w = pack_int4_t(q.t().contiguous()) if packed else q.t().contiguous()
        s = s.t().contiguous() if scale_mode == "block" else s
    else:
        w = pack_int4(q) if packed else q
    kw = dict(scale_mode=scale_mode, packed_int4=packed, w_transposed=trans, swiglu=swiglu,
              out_dtype=torch.bfloat16)
    return w, s, deq.to(torch.bfloat16), kw, K, N


def bench_gemm(g, line: str, cases):
    import torch
    from csinn2_tpu_torch.kernels.qmatmul import quant_matmul, quant_matmul_ref
    from csinn2_tpu_torch.utils.timing import cold_copies, gpu_ms, gpu_ms_cold, l2_bytes
    from csinn2_tpu_torch.utils.verify import cosine_similarity
    rows = []
    for label, proj, Ms in cases:
        w, s, deq, kw, K, N = _gemm_operands(g, label, proj)
        wbytes = w.numel() + (0 if s is None else s.numel() * 4)
        copies = [(w, s)] + [(w.clone(), None if s is None else s.clone())
                             for _ in range(cold_copies(wbytes, l2_bytes()) - 1)]
        dcopies = [deq] + [deq.clone() for _ in range(cold_copies(deq.numel() * 2, l2_bytes()) - 1)]
        for M in Ms:
            x = torch.randn((M, K), generator=g, device="cuda").to(torch.bfloat16)
            y = quant_matmul(x, w, s, **kw)
            torch.cuda.synchronize()
            ref = quant_matmul_ref(x, w, s, **kw)
            yf, rf = y.float().cpu().numpy(), ref.float().cpu().numpy()
            cos = cosine_similarity(yf, rf)
            rel = float(abs(yf - rf).max()) / float(abs(rf).max())
            if not (cos >= 0.9999 and rel <= 1e-2):
                raise AssertionError(f"{label} {proj} M={M}: cos={cos} max|d|/max|y|={rel}")
            n_out = N // 2 if kw["swiglu"] else N
            b_ms, b_by = _bound(M * K * 2 + wbytes + M * n_out * 2, 2.0 * M * N * K)
            warm = gpu_ms(lambda: quant_matmul(x, w, s, **kw))
            cold = gpu_ms_cold([lambda c=c: quant_matmul(x, c[0], c[1], **kw) for c in copies])
            lib_warm = gpu_ms(lambda: torch.matmul(x, deq))
            lib_cold = gpu_ms_cold([lambda d=d: torch.matmul(x, d) for d in dcopies])
            rows.append(dict(kind="gemm", case=label, proj=proj, M=M, K=K, N=N, ms=warm,
                             ms_cold=cold, library_ms=lib_warm, library_ms_cold=lib_cold,
                             bound_ms=b_ms, bound_by=b_by, cos=cos, card=line))
            print(json.dumps(rows[-1]), flush=True)
            del x, y, ref
        del w, s, deq, copies, dcopies
        torch.cuda.empty_cache()
    return rows


def bench_ring(g, line: str):
    """The decode kernel's ring alone over the Q8_0 and Q4_0 w13 bytes at M =
    8, cold, where the tree has it (qmatmul.decode_ring_stream)."""
    import torch
    from csinn2_tpu_torch.kernels import qmatmul as tq
    from csinn2_tpu_torch.utils.timing import cold_copies, gpu_ms_cold, l2_bytes
    if not hasattr(tq, "decode_ring_stream"):
        return []
    rows = []
    for label in ("1a q8_0", "1c q4_0"):
        w, s, _, kw, K, N = _gemm_operands(g, label, "w13")
        x = torch.randn((8, K), generator=g, device="cuda").to(torch.bfloat16)
        wbytes = w.numel() + s.numel() * 4
        copies = [(w, s)] + [(w.clone(), s.clone())
                             for _ in range(cold_copies(wbytes, l2_bytes()) - 1)]
        run = lambda c: tq.decode_ring_stream(x, c[0], c[1], kw["packed_int4"])
        cold = gpu_ms_cold([lambda c=c: run(c) for c in copies])
        b_ms, b_by = _bound(8 * K * 2 + wbytes, 0.0)
        rows.append(dict(kind="ring", case=label + " ring alone", proj="w13", M=8, K=K, N=N,
                         ms=cold, ms_cold=cold, library_ms=0.0, library_ms_cold=0.0,
                         bound_ms=b_ms, bound_by=b_by, cos=1.0, card=line))
        print(json.dumps(rows[-1]), flush=True)
        del w, s, copies
        torch.cuda.empty_cache()
    return rows


PROBE_VARIANTS = ("split_i32", "split_i8", "i4native", "bitcast", "andmask", "andmask_bf16s",
                  "noscale(timing)", "halfq8(timing)", "stream", "intdot", "w4a8", "w4a8_n2048",
                  "w4a8_n1024")
PROBE_EXTRA_MS = (1, 16)      # at w13, besides M = 8 at all four shapes


def bench_probe(line: str):
    """cur(quant_matmul) and the probe's kernels at its four shapes and
    inputs (M = 8; w13 also at PROBE_EXTRA_MS), cold, beside torch.matmul
    cold."""
    import numpy as np
    import torch
    from csinn2_tpu_torch.examples import int4_dequant_probe as probe
    from csinn2_tpu_torch.kernels.qmatmul import unpack_int4
    from csinn2_tpu_torch.utils.timing import cold_copies, gpu_ms_cold, l2_bytes
    from csinn2_tpu_torch.utils.verify import cosine_similarity
    rng = np.random.default_rng(0)
    rows = []
    cases = [(label, shape, 8) for label, shape in zip(probe.SHAPE_NAMES, probe.ALL_SHAPES)]
    cases += [("w13", probe.ALL_SHAPES[1], M) for M in PROBE_EXTRA_MS]
    for label, (K, N, bn, bk), M in cases:
        case = probe.make_case(rng, M, K, N, "cuda")
        x, w = case["x"], case["weights"]
        n = cold_copies(K * N // 2 + (K // 32) * N * 4, l2_bytes())
        copies = [w] + [{k: t.clone() for k, t in w.items()} for _ in range(n - 1)]
        deq = (unpack_int4(w["wp"], K).float().reshape(K // 32, 32, N)
               * w["s"][:, None]).reshape(K, N).to(torch.bfloat16)
        dcopies = [deq] + [deq.clone() for _ in range(cold_copies(deq.numel() * 2, l2_bytes()) - 1)]
        lib = gpu_ms_cold([lambda d=d: torch.matmul(x, d) for d in dcopies])
        del dcopies, deq
        table = probe.variant_table(M, K, N, bn, bk)
        for name in (probe.CUR,) + PROBE_VARIANTS:
            spec = table[name]
            fn, _ = probe.calls(spec, x, copies[0], M)
            cos = cosine_similarity(fn().float().cpu().numpy(), case["gold"])
            if "timing" not in name and name not in ("bitcast", "stream") and cos < 0.99:
                raise AssertionError(f"probe {name} {label}: cos {cos}")
            ms = gpu_ms_cold([probe.calls(spec, x, c, M)[1] for c in copies])
            b_ms, b_by = _bound(probe.kernel_bytes(spec[0], M, N, K), 2.0 * M * N * K,
                                INT8 if spec[0] in ("intdot", "w4a8") else BF16)
            rows.append(dict(kind="probe", case=name, proj=label, M=M, K=K, N=N, ms=ms,
                             ms_cold=ms, library_ms=lib, library_ms_cold=lib, bound_ms=b_ms,
                             bound_by=b_by, cos=cos, card=line))
            print(json.dumps(rows[-1]), flush=True)
        del copies, case, x, w
        torch.cuda.empty_cache()
    return rows


def bench_int8(g, line: str):
    """The int8-x GEMM on the w13 in its three layouts and two epilogues,
    cold, beside torch._int_mm's faster operand layout (cold)."""
    import numpy as np
    import torch
    from csinn2_tpu_torch.core.quant import quantize_multiplier
    from csinn2_tpu_torch.kernels.qmatmul import pack_int4, quant_matmul, quant_matmul_ref
    from csinn2_tpu_torch.utils.timing import cold_copies, gpu_ms_cold, l2_bytes
    K, N = K7, N13
    s = torch.rand((N,), generator=g, device="cuda") * 1e-3 + 1e-5
    bias = torch.randint(-2**18, 2**18, (N,), generator=g, device="cuda", dtype=torch.int32)
    mult, shift = quantize_multiplier(np.random.default_rng(0).uniform(1e-6, 1e-4, N))
    epilogues = {"float": (s, None, dict(scale_mode="channel")),
                 "requant": (None, bias, dict(scale_mode="none", out_dtype=torch.int8,
                                              out_zp=3.0, rq_mult=torch.from_numpy(mult).cuda(),
                                              rq_shift=torch.from_numpy(shift).cuda()))}
    q = torch.randint(-128, 128, (K, N), generator=g, device="cuda", dtype=torch.int8)
    q4 = torch.randint(-8, 8, (K, N), generator=g, device="cuda", dtype=torch.int8)
    layouts = {"[K,N]": (q, dict()), "[N,K]": (q.t().contiguous(), dict(w_transposed=True)),
               "packed [K/2,N]": (pack_int4(q4), dict(packed_int4=True))}
    n_lib = cold_copies(K * N, l2_bytes())
    lib_w = {"[K,N]": [q] + [q.clone() for _ in range(n_lib - 1)]}
    lib_w["[N,K].t()"] = [c.t().contiguous().t() for c in lib_w["[K,N]"]]
    rows = []
    for M in I8_MS:
        x = torch.randint(-128, 128, (M, K), generator=g, device="cuda", dtype=torch.int8)
        xp = x if M > 16 else torch.cat([x, x.new_zeros((32 - M, K))])
        lib = min(gpu_ms_cold([lambda c=c: torch._int_mm(xp, c) for c in cs])
                  for cs in lib_w.values())
        for lname, (w, lkw) in layouts.items():
            copies = [w] + [w.clone() for _ in range(cold_copies(w.numel(), l2_bytes()) - 1)]
            for ename, (sc, b, ekw) in epilogues.items():
                kw = dict(ekw, **lkw)
                y = quant_matmul(x, w, sc, b, **kw)
                torch.cuda.synchronize()
                if not torch.equal(y, quant_matmul_ref(x, w, sc, b, **kw)):
                    raise AssertionError(f"int8 {lname} {ename} M={M}: differs from the plain "
                                         "version")
                cold = gpu_ms_cold([lambda c=c: quant_matmul(x, c, sc, b, **kw) for c in copies])
                nbytes = M * K + w.numel() + 8 * N + M * N * y.element_size()
                b_ms, b_by = _bound(nbytes, 2.0 * M * N * K, INT8)
                rows.append(dict(kind="int8", case=f"{lname} {ename}", proj="w13", M=M, K=K,
                                 N=N, ms=cold, ms_cold=cold, library_ms=lib,
                                 library_ms_cold=lib, bound_ms=b_ms, bound_by=b_by, cos=1.0,
                                 card=line))
                print(json.dumps(rows[-1]), flush=True)
            del copies
        torch.cuda.empty_cache()
    return rows


def bench_dsconv(g, line: str):
    """fused_dsconv at MobileNetV1's 13 block shapes, batch 128 and 1, warm."""
    import torch
    from csinn2_tpu_torch.kernels import dsblock as ds
    from csinn2_tpu_torch.utils.timing import gpu_ms
    oc_view = hasattr(ds, "ds_plan")       # trees that read the [O, C] weight uncopied
    rows = []
    for batch in (128, 1):
        for i, (H, C, O, stride) in enumerate(MOBILENET_BLOCKS):
            ri = lambda shape: torch.randint(-128, 128, shape, generator=g, device="cuda",
                                             dtype=torch.int8)
            rf = lambda n, a: (torch.rand(n, generator=g, device="cuda") + 0.1) * a
            x, dw, pw_oc = ri((batch, H, H, C)), ri((9, C)), ri((O, C))
            args = (x, dw, rf(C, 1.5e-4), torch.randn(C, generator=g, device="cuda"),
                    pw_oc.t() if oc_view else pw_oc.t().contiguous(), rf(O, 4e-4 / C ** 0.5),
                    torch.randn(O, generator=g, device="cuda") * 0.5)
            kw = dict(k=3, stride=stride, pads=(1, 1, 1, 1) if stride == 1 else (0, 1, 0, 1),
                      mid_scale=6.0 / 255.0, mid_relu=False, mid_relu6=True, out_relu=False,
                      out_relu6=True, out_scale=0.05, out_dtype=torch.int8)
            y = ds.fused_dsconv(*args, **kw)
            torch.cuda.synchronize()
            if not torch.equal(y, ds.fused_dsconv_ref(*args, **kw)):
                raise AssertionError(f"dsconv block {i} batch {batch}: differs from the plain "
                                     "version")
            ms = gpu_ms(lambda: ds.fused_dsconv(*args, **kw))
            _, Ho, Wo, _ = y.shape
            nbytes = x.numel() + dw.numel() + pw_oc.numel() + 8 * (C + O) + y.numel()
            b_ms, b_by = _bound(nbytes, batch * Ho * Wo * (9 * C + 2 * C * O), INT8)
            rows.append(dict(kind="dsconv", case=f"block {i} C={C} O={O} s{stride}",
                             proj=f"{H}x{H}", M=batch, K=C, N=O, ms=ms, ms_cold=ms,
                             library_ms=0.0, library_ms_cold=0.0, bound_ms=b_ms,
                             bound_by=b_by, cos=1.0, card=line))
            print(json.dumps(rows[-1]), flush=True)
            del x, dw, pw_oc, args, y
        torch.cuda.empty_cache()
    return rows


def bench_decode_attention(g, line: str):
    import torch
    import torch.nn.functional as F
    from csinn2_tpu_torch.kernels import flash_attention as fa
    from csinn2_tpu_torch.utils.timing import cold_copies, gpu_ms, gpu_ms_cold, l2_bytes
    from csinn2_tpu_torch.utils.verify import verify
    b, h, d, S, kv_scale = 4, 32, 128, 2048, 0.05
    rows = []
    for case, lens in (("2 decode_attention", [2048, 1027, 0, 17]),
                       ("4' flash_attention_bhsd", [2048, 1027, 1, 17])):
        kvl = torch.tensor(lens, dtype=torch.int32, device="cuda")
        q = torch.randn((b, h, 1, d), generator=g, device="cuda").to(torch.bfloat16)

        def kv():
            t = torch.randint(-127, 128, (b, S, h, d), generator=g, device="cuda",
                              dtype=torch.int8)
            return t.permute(0, 2, 1, 3)
        n = cold_copies(2 * b * S * h * d, l2_bytes())
        caches = [(kv(), kv()) for _ in range(n)]
        if case.startswith("2"):
            run = lambda k, v: fa.decode_attention(q, k, v, q_offset=kvl - 1, kv_len=kvl,
                                                   kv_scale=kv_scale)
            causal = False
        else:
            run = lambda k, v: fa.flash_attention(q, k, v, causal=True, q_offset=kvl - 1,
                                                  kv_len=kvl, kv_scale=kv_scale)
            causal = True
        k0, v0 = caches[0]
        out = run(k0, v0)
        torch.cuda.synchronize()
        ref = fa._attention_ref(q, k0, v0, causal=causal, q_offset=kvl - 1, kv_len=kvl,
                                scale=1 / math.sqrt(d), kv_scale=kv_scale)
        r = verify(out.float().cpu().numpy(), ref.float().cpu().numpy(), tol=2e-2,
                   min_cosine=0.9999)
        if not r.passed:
            raise AssertionError(f"{case}: {r}")
        warm = gpu_ms(lambda: run(k0, v0))
        cold = gpu_ms_cold([lambda c=c: run(*c) for c in caches])
        mask = (torch.arange(S, device="cuda")[None, :] < kvl[:, None])[:, None, None, :]
        deqs = [((k.float() * kv_scale).to(torch.bfloat16),
                 (v.float() * kv_scale).to(torch.bfloat16)) for k, v in caches[:2]]
        n2 = cold_copies(2 * 2 * b * S * h * d, l2_bytes())
        deqs += [(deqs[0][0].clone(), deqs[0][1].clone()) for _ in range(max(0, n2 - 2))]
        sdpa = lambda kd, vd: F.scaled_dot_product_attention(q, kd, vd, attn_mask=mask)
        lib_warm = gpu_ms(lambda: sdpa(*deqs[0]))
        lib_cold = gpu_ms_cold([lambda c=c: sdpa(*c) for c in deqs])
        n_kv = int(kvl.sum())
        b_ms, b_by = _bound(b * h * d * 2 * 2 + 2 * n_kv * h * d, 4.0 * n_kv * h * d)
        rows.append(dict(kind="attention", case=case, kv_len=lens, ms=warm, ms_cold=cold,
                         library_ms=lib_warm, library_ms_cold=lib_cold, bound_ms=b_ms,
                         bound_by=b_by, cos=r.cosine_sim, card=line))
        print(json.dumps(rows[-1]), flush=True)
        del caches, deqs
        torch.cuda.empty_cache()
    return rows


WIDE_CASES = (   # (case, hq, hk, d, int8 KV, label)
    ("flash", 32, 8, 320, True, "2'' flash d=320"),
    ("decode", 32, 8, 320, True, "2'' decode d=320"),
    ("flash", 32, 8, 576, True, "2'' flash d=576"),
    ("decode", 32, 8, 576, True, "2'' decode d=576"),
    ("decode", 128, 1, 576, True, "2'' decode mla"),
    ("decode", 128, 1, 576, False, "2'' dec mla bf16"),
    ("flash", 32, 8, 300, True, "2'' flash d=300"),
    ("decode", 32, 8, 300, True, "2'' decode d=300"),
    ("flash", 32, 8, 320, False, "2'' flash bf16"),
    ("decode", 32, 8, 320, False, "2'' decode bf16"))
WIDE_SWEEP = (0, 1, 3, 4, 5)   # WIDE_CASES whose chunk the sweep varies (0: a prefill)


def bench_wide(g, line: str):
    """Row 2'': flash bhsd and decode at d = 320, 576 and 300, absorbed MLA's
    decode, int8 and bf16 KV, warm; then the chunk sweep."""
    import torch
    import torch.nn.functional as F
    from csinn2_tpu_torch.kernels import flash_attention as fa
    from csinn2_tpu_torch.utils.timing import gpu_ms
    from csinn2_tpu_torch.utils.verify import verify
    kv_scale = 0.05
    rows = []

    def inputs(case, hq, hk, d, int8):
        b, S, sq = (1, 512, 512) if case == "flash" else (4, 2048, 1)
        if int8:
            kv = [torch.randint(-127, 128, (b, S, hk, d), generator=g, device="cuda",
                                dtype=torch.int8).permute(0, 2, 1, 3) for _ in range(2)]
        else:
            kv = [torch.randn((b, S, hk, d), generator=g, device="cuda").to(torch.bfloat16)
                  .permute(0, 2, 1, 3) for _ in range(2)]
        q = torch.randn((b, hq, sq, d), generator=g, device="cuda").to(torch.bfloat16)
        kvl = torch.tensor([S] if case == "flash" else [2048, 1027, 0, 17], dtype=torch.int32,
                           device="cuda")
        scale = kv_scale if int8 else None
        if case == "flash":
            kw = dict(causal=True, q_offset=0, kv_len=kvl, kv_scale=scale)
            run = lambda: fa.flash_attention(q, *kv, **kw)
        else:
            kw = dict(causal=False, q_offset=kvl - 1, kv_len=kvl, kv_scale=scale)
            run = lambda: fa.decode_attention(q, *kv, q_offset=kvl - 1, kv_len=kvl,
                                              kv_scale=scale)
        plain_fn = lambda: fa._attention_ref(q, *kv, scale=1 / math.sqrt(d), **kw)
        return b, S, sq, q, kv, kvl, run, plain_fn

    def check(label, run, plain_fn):
        out = run()
        torch.cuda.synchronize()
        r = verify(out.float().cpu().numpy(), plain_fn().float().cpu().numpy(), tol=2e-2,
                   min_cosine=0.9999)
        if not (r.passed and r.cosine_sim >= 0.9999):
            raise AssertionError(f"wide {label}: {r}")
        return r.cosine_sim

    for case, hq, hk, d, int8, label in WIDE_CASES:
        b, S, sq, q, kv, kvl, run, plain_fn = inputs(case, hq, hk, d, int8)
        cos = check(label, run, plain_fn)
        ms = gpu_ms(run)
        plain = gpu_ms(plain_fn, reps=3)
        kd, vd = ((x.float() * kv_scale).to(torch.bfloat16) if int8 else x for x in kv)
        kd, vd = ((x.expand(-1, hq, -1, -1) if hk == 1 else x.repeat_interleave(hq // hk, dim=1))
                  for x in (kd, vd))
        kvb = 1 if int8 else 2
        if case == "flash":
            lib = gpu_ms(lambda: F.scaled_dot_product_attention(q, kd, vd, is_causal=True))
            b_ms, b_by = _bound(2 * b * sq * hq * d * 2 + 2 * S * hk * d * kvb,
                                4.0 * sq * (sq + 1) // 2 * hq * d)
        else:
            mask = (torch.arange(S, device="cuda")[None, :] < kvl[:, None])[:, None, None, :]
            lib = gpu_ms(lambda: F.scaled_dot_product_attention(q, kd, vd, attn_mask=mask))
            n_kv = int(kvl.sum())
            b_ms, b_by = _bound(2 * b * hq * d * 2 + 2 * n_kv * hk * d * kvb, 4.0 * n_kv * hq * d)
        rows.append(dict(kind="wide", case=label, proj=f"b={b} S={S} hq={hq}", M=sq, ms=ms,
                         ms_cold=ms, plain_ms=plain, library_ms=lib, library_ms_cold=lib,
                         bound_ms=b_ms, bound_by=b_by, cos=cos, card=line))
        print(json.dumps(rows[-1]), flush=True)
        del kv, kd, vd
        torch.cuda.empty_cache()
    if not hasattr(fa, "_wide_plan"):      # a tree from before the plan
        return rows
    # the chunk sweep: each chunk of WIDE_CHUNKS and the unsplit window
    # in place of the plan's own choice (bound as in the row above)
    plan_fn = fa._wide_plan
    for i in WIDE_SWEEP:
        case, hq, hk, d, int8, label = WIDE_CASES[i]
        b, S, sq, q, kv, kvl, run, plain_fn = inputs(case, hq, hk, d, int8)
        n_sm = torch.cuda.get_device_properties(0).multi_processor_count
        own = plan_fn(b, sq, hq, hk, S, d, 1 if int8 else 2, n_sm)
        for chunk in fa.WIDE_CHUNKS + (S,):
            fa._wide_plan = lambda *a, c=chunk: plan_fn(*a)._replace(chunk=c,
                                                                     n_chunks=-(-S // c))
            try:
                cos = check(f"{label} chunk={chunk}", run, plain_fn)
                ms = gpu_ms(run)
            finally:
                fa._wide_plan = plan_fn
            mark = "*" if chunk == own.chunk else ""
            rows.append(dict(kind="wide", case=f"{label} c{chunk}{mark}",
                             proj=f"b={b} S={S} hq={hq}", M=sq, ms=ms, ms_cold=ms,
                             library_ms=0.0, library_ms_cold=0.0,
                             bound_ms=rows[i]["bound_ms"], bound_by=rows[i]["bound_by"],
                             cos=cos, card=line))
            print(json.dumps(rows[-1]), flush=True)
        del kv
    return rows


def worker(only) -> int:
    import torch
    if not torch.cuda.is_available():
        print("gemm_attn_bench: no CUDA device", file=sys.stderr)
        return 1
    line = gpu_line()
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    if "attention" in only:
        bench_decode_attention(g, line)
    if "probe" in only:
        bench_probe(line)
    if "decode" in only:
        bench_gemm(g, line, GROUPS["decode"])
    if "decode" in only or "probe" in only:
        bench_ring(g, line)
    if "prefill" in only:
        bench_gemm(g, line, GROUPS["prefill"])
    if "int8" in only:
        bench_int8(g, line)
    if "dsconv" in only:
        bench_dsconv(g, line)
    if "wide" in only:
        bench_wide(g, line)
    return 0


def step_sums(results):
    """Per run and weight mode: N_LAYERS × (wqkv + wo + w13 + w2) at M = 4, cold."""
    sums = {}
    for r in results:
        if r["kind"] == "gemm" and r["M"] == 4 and r["case"] in ("1a q8_0", "1c q4_0"):
            sums.setdefault((r["run"], r["case"]), {})[r["proj"]] = r["ms_cold"]
    return {k: N_LAYERS * sum(v.values()) for k, v in sums.items() if len(v) == len(PROJ)}


def probe_factors(results):
    """Per run, probe shape, M and variant: (ms, ms / cur's ms, ms / torch.matmul's ms)."""
    cur = {(r["run"], r["proj"], r["M"]): r["ms"] for r in results
           if r["kind"] == "probe" and r["case"].startswith("cur")}
    return {(r["run"], r["proj"], r["M"], r["case"]):
            (r["ms"], r["ms"] / cur[r["run"], r["proj"], r["M"]], r["ms"] / r["library_ms"])
            for r in results if r["kind"] == "probe" and (r["run"], r["proj"], r["M"]) in cur}


def dsconv_sums(results):
    """Per run and batch: the 13 fused_dsconv blocks' ms and bounds, summed."""
    sums = {}
    for r in results:
        if r["kind"] == "dsconv":
            t = sums.setdefault((r["run"], r["M"]), [0.0, 0.0])
            t[0] += r["ms"]
            t[1] += r["bound_ms"]
    return sums


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trees", nargs="*", default=None,
                    help="repository trees to time in turns (default: this one)")
    ap.add_argument("--only", default="attention,decode,prefill",
                    help="groups of cases, comma-separated: " + ", ".join(BENCH_GROUPS)
                    + " (default: all but probe)")
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    only = set(args.only.split(","))
    if not only <= set(BENCH_GROUPS):
        ap.error(f"--only: unknown groups {sorted(only - set(BENCH_GROUPS))}")
    if args.worker:
        return worker(only)
    here = Path(__file__).resolve().parents[2]
    trees = [Path(t).resolve() for t in (args.trees or [str(here)])]
    results = []
    for i, tree in enumerate(trees):
        if not (tree / "csinn2_tpu_torch").is_dir():
            raise SystemExit(f"gemm_attn_bench: no csinn2_tpu_torch/ under {tree}")
        env = dict(os.environ, PYTHONPATH=str(tree))
        cmd = [sys.executable, str(Path(__file__).resolve()), "--worker", "--only", args.only]
        proc = subprocess.run(cmd, cwd=str(tree), env=env, capture_output=True, text=True)
        sys.stderr.write(proc.stderr[-4000:])
        if proc.returncode != 0:
            print(proc.stdout[-4000:])
            raise SystemExit(f"gemm_attn_bench: run {i} ({tree}) exited {proc.returncode}")
        for ln in proc.stdout.splitlines():
            if ln.startswith("{"):
                results.append(dict(json.loads(ln), run=i, tree=str(tree)))
    for r in results:
        where = f"{r.get('proj', '-')} M={r.get('M', '-')!s:5s}"
        print(f"run {r['run']} {r['kind']:9s} {r['case']:24s} {where:16s} "
              f"ms {r['ms']:.4f} cold {r['ms_cold']:.4f} lib {r['library_ms']:.4f} "
              f"lib_cold {r['library_ms_cold']:.4f} bound {r['bound_ms']:.4f} "
              f"({r['bound_by']}) cos {r['cos']:.6f} [{r['card']}]")
    for (run, case), ms in sorted(step_sums(results).items()):
        print(f"run {run} decode step sum, batch 4, {case}: {N_LAYERS} x (wqkv + wo + w13 + w2) "
              f"= {ms:.4f} ms cold")
    for (run, proj, M, case), (ms, x_cur, x_lib) in probe_factors(results).items():
        print(f"run {run} probe {proj} M={M:<2d} {case:24s} {ms:.4f} ms cold: {x_cur:.2f} x cur, "
              f"{x_lib:.2f} x torch.matmul")
    for (run, batch), (ms, b_ms) in sorted(dsconv_sums(results).items()):
        print(f"run {run} dsconv 13 blocks, batch {batch}: {ms:.4f} ms, bound {b_ms:.4f} ms")
    print(json.dumps(results))
    return 0


if __name__ == "__main__":
    sys.exit(main())
