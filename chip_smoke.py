#!/usr/bin/env python3
"""Smoke run of csinn2_tpu_torch, the PyTorch/CUDA port, on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and continued):
  1. the card (nvidia-smi name and power limit), torch/CUDA versions, and the
     build of every CUDA kernel from csinn2_tpu_torch/kernels/csrc/;
  2. each kernel held against its plain PyTorch version on the card at
     Llama-2-7B shapes, timed (median GPU time of back-to-back calls queued
     behind a sleep kernel, CUDA events) beside the plain version and one
     library call (a yardstick only): the GEMM launch plan's Python mirror
     against the library's workspace size at every 7B projection; then
     quant_matmul in every weight mode (Q8_0, Q4_0, INT8_CHANNEL,
     INT4_CHANNEL, and the swiglu epilogue on a Q8_0 and a Q4_0 w13 in the
     swiglu128 layout) at M = 1, 4, 8, 16 and 128 on wqkv, wo, w13, w2 and
     lm_head, the decode rows (M <= 16) also cold (utils/timing.gpu_ms_cold
     over weight copies beyond twice the L2, beside torch.matmul cold), and
     the Q8_0 and Q4_0 w13 also at the long prompts' prefill buckets M = 512
     and 2048; the attention
     kernels (the split-KV decode_attention, also timed cold over KV copies
     beyond twice the L2 beside SDPA cold; the tensor-core attn_fwd_kernel
     at prefill and, split over the KV window, at flash decode, its decode
     also cold), then every attention entry point at head
     dims 16, 32, 80, 96 and 256 with an f32 and a bf16 q, int8 and bf16 KV;
     then the head dims above 256 (attn_wide_mma_kernel, on wgmma): the
     four entry points at d = 320 and 576, int8 and bf16 KV, driven once
     each with the launch counts zeroed before and read after (their path:
     a launch a call, a merge for each split-KV decode), each held against
     its plain version, the kv_len = 0 row 0, and flash bhsd and decode at
     both d timed beside SDPA on the dequantized K/V;
  3. model parity: a 2-layer model at full 7B width (int8 KV) over a
     128-token prompt, logits on the card against the same model through the
     port's plain path on the CPU (cosine >= 0.999), for Q8_0, Q4_0,
     INT8_CHANNEL, INT4_CHANNEL and Q4_0 with CSINN2_SWIGLU_FUSE=1;
  4. the first slice's main path: Llama-2-7B geometry (32 layers), Q8_0
     weights made on the card from a seed, int8 KV,
     InferenceEngine(batch=4).run_queue over six greedy requests (prompts
     5..1100 tokens, 16 new tokens each), with the kernel launch counts of
     that run; then TTFT at prompts 128 and 1100 and decode tokens/s at
     batch 4 (CUDA events), with the qmm_reduce launches per decode step (the
     libraries' own count; the decode GEMM finishes its splits in one
     launch); then the engine at LlamaConfig.tiny() (head dim 16, GQA 4/2)
     on the card, with and without CSINN2_DECODE_ATTN=flash, logits against
     the same engine on the CPU (cosine >= 0.999);
  5. this slice's main path: the same with Q4_0 weights;
  6. the paths of the other weight modes, each the same run at full width
     and depth: INT8_CHANNEL, INT4_CHANNEL, and Q4_0 with the swiglu128
     fusion (CSINN2_SWIGLU_FUSE=1);
  7. the CNN path: MobileNetV1 (alpha 1.0, 224x224, 1000 classes, seed 0)
     calibrated on the card on one seeded image, INT8_SYM graph sessions at
     batch 128 and 1 with CSINN2_FUSE_DS=1 (13 ds_block nodes, the
     fused_dsconv CUDA kernel) and without; the fused session's forward at
     batch 128 is the main path whose launches are counted (13 expected);
     fused logits equal to unfused ones bit for bit (batch 128 and 1), to
     the port's CPU plain path within the fc's 1 LSB (batch 1), cosine
     >= 0.99 against forward_f32 (bench.py's gate); img/s at batch 128 and
     batch-1 latency, fused and unfused (CUDA events), and the fused_dsconv
     launches over those runs; each of the 13 block shapes of fused_dsconv
     against fused_dsconv_ref (bit for bit), timed beside its bound, the
     plain version and the unfused pair, and their sum against the summed
     bound.
  8. the op API's CUDA tier (kernels/autodispatch.py) at Llama-2-7B width:
     ops.fullyconnected on Q8_0 and Q4_0 block tensors of one layer's four
     projections (wqkv, wo, w13, w2; made on the card from a seed) at M = 128
     and 4, and ops.scaled_dot_product_attention at prefill [1, 32, 2048, 128]
     and decode [4, 32, 1, 128] over S = 2048, recorded into a GRAPH
     Session(device="cuda") with Api.AUTO and run in layer mode; every node
     on the CUDA tier (quant_matmul_t, flash_attention_bhsd), outputs against
     an Api.TORCH session on the card (fc cosine >= 0.9999, SDPA
     verify(tol=2e-2, min_cosine=0.9999)), an int8 out_qinfo within 1 LSB;
  9. phase 4's run under CSINN2_DECODE_ATTN=flash: the batched decode takes
     bhsd flash_attention (32 launches per decode step, decode_attention
     none; the split-KV launches and their merges counted), tokens set
     beside phase 4's, one step's logits against the
     default decode's (cosine >= 0.999), decode tokens/s beside phase 4's;
 10. the probe path: the port's Q4_0 dequant-strategy probe
     (csinn2_tpu_torch.examples.int4_dequant_probe, the eleven kernels of
     kernels/int4_probe.py beside cur(quant_matmul), every one on the decode
     GEMM's tensor-core skeleton: the eight bf16 plane kinds, intdot and
     w4a8 on int8 tensor cores, stream the ring's copies alone) at the four Llama-2-7B
     decode shapes (wqkv, w13, w2, wo; M = 8), every variant timed cold
     (rotating over weight copies that exceed twice the L2) and no row
     above 105 % of its own bytes bound; then each kernel held against its
     plain version on the card at every shape (stream bit for bit, the
     others within 1e-5·max|y|), timed beside the plain version and
     torch.matmul on the dequantized bf16 weight (cold), with its factor
     over cur and over torch.matmul; then the tile tuner's split-length
     sweep of the andmask kernel at the four shapes.
Phase 2 also holds the fourth slice's kernel modes (int8 x with float and
integer epilogues, the fixed-point requantize bit for bit, scale_mode
"none", the transposed weights, bhsd flash_attention) against their plain
versions at 7B shapes, then times the int8-x GEMM (row 1d) cold at w13, M
= 1-2048, in the float and requantize epilogues beside its bound and
torch._int_mm's faster operand layout; the modes without a package caller
(rows 1b' and 1d, the int8-x swiglu) are then driven once each through
quant_matmul, which is their path.
Each path's run zeroes the launch counts just before it and reads them just
after.  No phase uses torch.profiler: once it has traced,
host-side launches stay slower for the rest of the process, which would skew
the serving phases.  The last two lines are the kernels' JSON record and the
run's JSON result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
BF16_FLOPS = 989e12            # H100 SXM dense bf16 tensor-core peak
INT8_OPS = 1979e12             # H100 SXM dense int8 tensor-core peak

QMM_SOURCE = "csinn2_tpu_torch/kernels/csrc/qmatmul.cuh"
QMM_REPLACES = "csinn2_tpu/kernels/qmatmul.py:287"
ATTN_SOURCE = "csinn2_tpu_torch/kernels/csrc/attention.cu"
I8_SOURCE = "csinn2_tpu_torch/kernels/csrc/qmatmul_int8dot.cu"
# kernel name (launch_counts key without its .decode/.prefill suffix) →
# (source, TPU function replaced)
KERNELS = {
    "quant_matmul": (QMM_SOURCE, QMM_REPLACES),
    "quant_matmul_q4_0": (QMM_SOURCE, QMM_REPLACES),
    "quant_matmul_channel": (QMM_SOURCE, QMM_REPLACES),
    "quant_matmul_int4_channel": (QMM_SOURCE, QMM_REPLACES),
    "quant_matmul_swiglu": (QMM_SOURCE, QMM_REPLACES),
    "decode_attention": (ATTN_SOURCE, "csinn2_tpu/kernels/flash_attention.py:142"),
    "prefill_attention": (ATTN_SOURCE, "csinn2_tpu/kernels/flash_attention.py:248"),
    "flash_attention": (ATTN_SOURCE, "csinn2_tpu/kernels/flash_attention.py:312"),
    "fused_dsconv": ("csinn2_tpu_torch/kernels/csrc/dsblock.cu",
                     "csinn2_tpu/kernels/dsblock.py:164"),
    "quant_matmul_none": (QMM_SOURCE, QMM_REPLACES),
    "quant_matmul_int8dot": (I8_SOURCE, QMM_REPLACES),
    "quant_matmul_requant": (I8_SOURCE, "csinn2_tpu/kernels/requant.py:40"),
    "quant_matmul_t": (QMM_SOURCE, QMM_REPLACES),
    "flash_attention_bhsd": (ATTN_SOURCE, "csinn2_tpu/kernels/flash_attention.py:312"),
    # attn_wide_mma_kernel: d > 256 in all three functions (also :142
    # decode_attention, :248 prefill_attention)
    "attention_wide": (ATTN_SOURCE, "csinn2_tpu/kernels/flash_attention.py:312"),
}
# the probe kernels: kind → (line of the JAX body or pallas_call function in
# examples/int4_dequant_probe.py, the probe's variant name)
PROBE_KERNELS = {"split_i32": (91, "split_i32"), "split_i8": (91, "split_i8"),
                 "i4native": (141, "i4native"), "bitcast": (173, "bitcast"),
                 "andmask": (234, "andmask"), "andmask_bf16s": (395, "andmask_bf16s"),
                 "stream": (294, "stream"), "intdot": (327, "intdot"), "w4a8": (530, "w4a8"),
                 "noscale": (440, "noscale(timing)"), "halfq8": (460, "halfq8(timing)")}
for _kind, (_line, _) in PROBE_KERNELS.items():
    KERNELS[f"int4_probe_{_kind}"] = ("csinn2_tpu_torch/kernels/csrc/int4_probe.cu",
                                      f"examples/int4_dequant_probe.py:{_line}")
ATTENTION = ("decode_attention", "prefill_attention", "flash_attention")
# weight mode → (scale_mode, packed_int4) of its quant_matmul calls
QMM_MODES = {"q8_0": ("block", False), "q4_0": ("block", True),
             "int8": ("channel", False), "int4": ("channel", True)}
PROMPTS = (5, 37, 128, 300, 700, 1100)
CNN_BATCH = 128                # bench.py:51


def log(msg: str) -> None:
    print(msg, flush=True)


def bound(nbytes: float, flops: float, peak: float = BF16_FLOPS):
    t_b, t_f = nbytes / HBM_BYTES_PER_S, flops / peak
    return max(t_b, t_f) * 1e3, ("bytes" if t_b >= t_f else "operations")


def launches(counts, name: str) -> int:
    """Launches of kernel `name` in a launch_counts snapshot (all variants)."""
    return sum(n for k, n in counts.items() if k.split(".")[0] == name)


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def _qmm_weights(g, mode: str, K: int, N: int):
    """Random carriers over the mode's full range (-128 / -8 included), f16-
    rounded scales, and a bf16 dequantized copy for the library yardstick."""
    import torch
    from csinn2_tpu_torch.kernels.qmatmul import pack_int4
    scale_mode, packed = QMM_MODES[mode]
    lo, hi = (-8, 8) if packed else ((-128, 128) if scale_mode == "channel" else (-127, 128))
    q = torch.randint(lo, hi, (K, N), generator=g, device="cuda", dtype=torch.int8)
    if scale_mode == "block":
        s = (torch.rand((K // 32, N), generator=g, device="cuda") * 2e-4 + 1e-5) \
            .to(torch.float16).float()
        w_deq = (q.float().reshape(K // 32, 32, N) * s[:, None]).reshape(K, N)
    else:
        s = torch.rand((N,), generator=g, device="cuda") * 2e-4 + 1e-5
        w_deq = q.float() * s
    return (pack_int4(q) if packed else q), s, w_deq.to(torch.bfloat16)


def _gemm_cold(x, w, s, w_deq, run):
    """Cold times (utils/timing.gpu_ms_cold) of a GEMM call run(w, s) and of
    torch.matmul(x, w_deq), each over copies of its weight whose total
    exceeds twice the L2."""
    import torch
    from csinn2_tpu_torch.utils.timing import cold_copies, gpu_ms_cold, l2_bytes
    n = cold_copies(w.numel() + (0 if s is None else s.numel() * 4), l2_bytes())
    copies = [(w, s)] + [(w.clone(), None if s is None else s.clone()) for _ in range(n - 1)]
    ms = gpu_ms_cold([lambda c=c: run(*c) for c in copies])
    del copies
    deqs = [w_deq] + [w_deq.clone()
                      for _ in range(cold_copies(w_deq.numel() * 2, l2_bytes()) - 1)]
    lib = gpu_ms_cold([lambda d=d: torch.matmul(x, d) for d in deqs])
    return ms, lib


DECODE_MS = (1, 4, 8, 16)


def _check_qmm_case(records, key, label, g, mode, K, N, odt, swiglu=False, record_m=4,
                    ms_list=DECODE_MS + (128,)):
    import torch
    from csinn2_tpu_torch.kernels.qmatmul import quant_matmul, quant_matmul_ref
    from csinn2_tpu_torch.utils.timing import gpu_ms
    from csinn2_tpu_torch.utils.verify import cosine_similarity
    scale_mode, packed = QMM_MODES[mode]
    kw = dict(scale_mode=scale_mode, packed_int4=packed, swiglu=swiglu, out_dtype=odt)
    w, s, w_deq = _qmm_weights(g, mode, K, N)
    worst = records.get(key, {}).get("max_abs_err", 0.0)
    for M in ms_list:
        x = torch.randn((M, K), generator=g, device="cuda").to(torch.bfloat16)
        y = quant_matmul(x, w, s, **kw)
        torch.cuda.synchronize()
        ref = quant_matmul_ref(x, w, s, **kw)
        yf, rf = y.float().cpu().numpy(), ref.float().cpu().numpy()
        err = float(abs(yf - rf).max())
        cos = cosine_similarity(yf, rf)
        rel = err / float(abs(rf).max())
        if not (cos >= 0.9999 and rel <= 1e-2):
            raise AssertionError(f"{key} {label} M={M}: cos={cos} max|d|/max|y|={rel}")
        worst = max(worst, err)
        ms = gpu_ms(lambda: quant_matmul(x, w, s, **kw))
        plain = gpu_ms(lambda: quant_matmul_ref(x, w, s, **kw), reps=3)
        lib = gpu_ms(lambda: torch.matmul(x, w_deq))
        osz = torch.empty((), dtype=odt).element_size()
        n_out = N // 2 if swiglu else N
        b_ms, b_by = bound(M * K * 2 + w.numel() + s.numel() * 4 + M * n_out * osz,
                           2.0 * M * N * K)
        cold = ""
        if M <= 16:                            # the decode kernel, cold
            ms_cold, lib_cold = _gemm_cold(x, w, s, w_deq,
                                           lambda wc, sc: quant_matmul(x, wc, sc, **kw))
            cold = (f" cold: ms={ms_cold:.4f} lib_ms={lib_cold:.4f} "
                    f"roofline={b_ms / ms_cold:.3f}")
        log(f"  {key} {label:7s} M={M:4d} K={K:5d} N={N:5d} ms={ms:.4f} plain_ms={plain:.4f} "
            f"lib_ms={lib:.4f} bound_ms={b_ms:.4f} ({b_by}) roofline={b_ms / ms:.3f} "
            f"cos={cos:.6f} max_abs_err={err:.3e}{cold}")
        if record_m is not None and M <= 16:  # the decode kernel at the recorded shape
            records.setdefault(key, {}).setdefault("decode_cold", {})[f"M={M}"] = dict(
                ms=ms_cold, library_ms=lib_cold, bound_ms=b_ms)
        if M == record_m:
            records.setdefault(key, {}).update(
                ms=ms, plain_ms=plain, library_ms=lib, bound_ms=b_ms, bound_by=b_by,
                ms_cold=ms_cold, library_ms_cold=lib_cold,
                shape=f"{label} M={M} K={K} N={N} {'bf16' if osz == 2 else 'f32'} out")
        if record_m is not None and M > 16:   # the prefill kernel at the recorded shape
            records.setdefault(key, {}).setdefault("prefill", {})[f"M={M}"] = dict(
                ms=ms, library_ms=lib, bound_ms=b_ms, bound_by=b_by)
    records.setdefault(key, {})["max_abs_err"] = worst
    del w, s, w_deq


def check_quant_matmul(records):
    """Every weight mode at the 7B shapes (M = 1, 4, 8, 16, 128); the record
    of each mode is the batch-4 decode FFN GEMM, w13 at M = 4, with the
    decode rows cold at M <= 16."""
    import torch
    from csinn2_tpu_torch.kernels.qmatmul import launch_key
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    shapes = [("wqkv", 4096, 12288, torch.bfloat16), ("wo", 4096, 4096, torch.bfloat16),
              ("w13", 4096, 22016, torch.bfloat16), ("w2", 11008, 4096, torch.bfloat16),
              ("lm_head", 4096, 32000, torch.float32)]
    for mode, (scale_mode, packed) in QMM_MODES.items():
        key = launch_key(scale_mode, packed, swiglu=False)
        for label, K, N, odt in shapes:
            # the prefill buckets of a long prompt (512, 2048 rows) on the Q8_0 and Q4_0 w13
            long = label == "w13" and scale_mode == "block"
            _check_qmm_case(records, key, label, g, mode, K, N, odt,
                            record_m=4 if label == "w13" else None,
                            ms_list=DECODE_MS + ((128, 512, 2048) if long else (128,)))
    # the swiglu epilogue on a w13 in the swiglu128 layout (F 11008 padded to
    # 11264): N = 22528 → out [M, 11264]; recorded for Q4_0
    for mode in ("q8_0", "q4_0"):
        _check_qmm_case(records, "quant_matmul_swiglu", f"w13sw-{mode}", g, mode, 4096, 22528,
                        torch.bfloat16, swiglu=True, record_m=4 if mode == "q4_0" else None)


def check_gemm_plan():
    """kernels/qmatmul.py's mirror of the GEMM launch plan (workspace floats)
    against the CUDA library's own number at every Llama-2-7B projection,
    M 1-2048, with and without the reduce (the plan is the same for both
    weight layouts)."""
    import torch
    from csinn2_tpu_torch.kernels import qmatmul as tq
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    n = 0
    for K, N in ((4096, 12288), (4096, 4096), (4096, 22016), (4096, 22528), (11008, 4096),
                 (4096, 32000)):
        for M in (1, 2, 4, 8, 16, 17, 32, 64, 128, 512, 1024, 2048):
            for swiglu, reduce_epi in ((False, False), (True, False), (False, True)):
                want = tq.kernel_workspace_floats(M, N, K, swiglu, reduce_epi, 0)
                got = tq.workspace_floats(M, N, K, swiglu, reduce_epi, n_sm)
                if got != want:
                    raise AssertionError(f"GEMM plan mirror M={M} K={K} N={N}: {got} floats, "
                                         f"the library {want}")
                n += 1
    log(f"  GEMM plan mirror = library workspace at {n} 7B cases; w13 M=128: "
        f"{tq.gemm_plan(128, 22016, 4096, False, n_sm)}")
    n = 0
    for K, N in ((4096, 12288), (4096, 4096), (4096, 22016), (11008, 4096), (4096, 32000)):
        for M in (1, 4, 8, 16, 17, 128, 512, 2048):
            want = tq.kernel_int8dot_plan(M, N, K, 0)
            got = tq.int8dot_plan(M, N, K, n_sm)
            if {k: got[k] for k in want} != want:
                raise AssertionError(f"int8-x GEMM plan mirror M={M} K={K} N={N}: {got}, "
                                     f"the library {want}")
            n += 1
    log(f"  int8-x GEMM plan mirror = library at {n} 7B cases; w13 M=128: "
        f"{tq.int8dot_plan(128, 22016, 4096, n_sm)}")


def _kv_case(g, b, hk, S, d, scale):
    """int8 K/V in the cache's [b, S, hk, d] layout, seen as [b, hk, S, d]."""
    import torch
    k = torch.randint(-127, 128, (b, S, hk, d), generator=g, device="cuda", dtype=torch.int8)
    v = torch.randint(-127, 128, (b, S, hk, d), generator=g, device="cuda", dtype=torch.int8)
    return k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3)


def _verify_attn(name, out, ref):
    from csinn2_tpu_torch.utils.verify import verify
    r = verify(out.float().cpu().numpy(), ref.float().cpu().numpy(), tol=2e-2,
               min_cosine=0.9999)
    if not (r.passed and r.cosine_sim >= 0.9999):
        raise AssertionError(f"{name}: {r}")
    return r


def _decode_cold(g, b, hk, S, d, kv_scale, run, lib):
    """Cold times (utils/timing.gpu_ms_cold) of a decode attention call
    `run(k, v)` and of its library call `lib(kd, vd)` on dequantized bf16
    K/V, each over copies of the cache whose total exceeds twice the L2."""
    import torch
    from csinn2_tpu_torch.utils.timing import cold_copies, gpu_ms_cold, l2_bytes
    caches = [_kv_case(g, b, hk, S, d, kv_scale)
              for _ in range(cold_copies(2 * b * S * hk * d, l2_bytes()))]
    ms = gpu_ms_cold([lambda c=c: run(*c) for c in caches])
    deq = [tuple((t.float() * kv_scale).to(torch.bfloat16) for t in c)
           for c in caches[:cold_copies(4 * b * S * hk * d, l2_bytes())]]
    lib_ms = gpu_ms_cold([lambda c=c: lib(*c) for c in deq])
    return ms, lib_ms


def check_attention(records):
    import torch
    import torch.nn.functional as F
    from csinn2_tpu_torch.kernels import flash_attention as fa
    from csinn2_tpu_torch.utils.timing import gpu_ms
    g = torch.Generator(device="cuda")
    g.manual_seed(1)
    hq = hk = 32
    d, kv_scale = 128, 0.05          # the engine's default int8 KV scale
    sm = 1.0 / math.sqrt(d)

    # decode: b=4, one lane with kv_len = 0 (an inactive continuous-batching slot)
    worst = 0.0
    for S in (256, 2048):
        b = 4
        k, v = _kv_case(g, b, hk, S, d, kv_scale)
        q = torch.randn((b, hq, 1, d), generator=g, device="cuda").to(torch.bfloat16)
        kv_len = torch.tensor([S, S // 2 + 3, 0, 17], dtype=torch.int32, device="cuda")
        pos = kv_len - 1
        run = lambda: fa.decode_attention(q, k, v, q_offset=pos, kv_len=kv_len,
                                          kv_scale=kv_scale)
        out = run()
        torch.cuda.synchronize()
        ref = fa._attention_ref(q, k, v, causal=False, q_offset=pos, kv_len=kv_len,
                                scale=sm, kv_scale=kv_scale).to(torch.bfloat16)
        r = _verify_attn(f"decode_attention S={S}", out, ref)
        if not bool(torch.isfinite(out).all()) or float(out[2].abs().max()) != 0.0:
            raise AssertionError("decode_attention: kv_len=0 lane must output 0")
        worst = max(worst, r.max_abs_err)
        ms = gpu_ms(run)
        plain = gpu_ms(lambda: fa._attention_ref(q, k, v, causal=False, q_offset=pos,
                                                    kv_len=kv_len, scale=sm,
                                                    kv_scale=kv_scale), reps=5)
        kd = (k.float() * kv_scale).to(torch.bfloat16)
        vd = (v.float() * kv_scale).to(torch.bfloat16)
        mask = (torch.arange(S, device="cuda")[None, :] < kv_len[:, None])[:, None, None, :]
        lib = gpu_ms(lambda: F.scaled_dot_product_attention(q, kd, vd, attn_mask=mask))
        n_kv = int(kv_len.clamp(max=S).sum())
        b_ms, b_by = bound(b * hq * d * 2 * 2 + 2 * n_kv * hk * d, 4.0 * n_kv * hq * d)
        log(f"  decode_attention b={b} S={S:4d} kv_len={kv_len.tolist()} ms={ms:.4f} "
            f"plain_ms={plain:.4f} lib_ms={lib:.4f} bound_ms={b_ms:.4f} ({b_by}) "
            f"roofline={b_ms / ms:.3f} {r}")
        if S == 2048:
            cold, lib_cold = _decode_cold(
                g, b, hk, S, d, kv_scale,
                lambda k, v: fa.decode_attention(q, k, v, q_offset=pos, kv_len=kv_len,
                                                 kv_scale=kv_scale),
                lambda kd, vd: F.scaled_dot_product_attention(q, kd, vd, attn_mask=mask))
            log(f"  decode_attention cold (KV copies beyond twice the L2): ms={cold:.4f} "
                f"lib_ms={lib_cold:.4f} bound_ms={b_ms:.4f} roofline={b_ms / cold:.3f}")
            records["decode_attention"] = dict(ms=ms, plain_ms=plain, library_ms=lib,
                                               bound_ms=b_ms, bound_by=b_by, ms_cold=cold,
                                               library_ms_cold=lib_cold,
                                               shape=f"b=4 hq=hk=32 d=128 S={S}")
    records["decode_attention"]["max_abs_err"] = worst

    # prefill (whole KV fits 8 MiB) and flash (bshd, longer prompts).  The
    # engine pads a prompt to its bucket, so run_queue gives the 128-token
    # prompt sq=128 over S=256, and the 1100-token one sq=kv_len=2048 over
    # S=2048 (recorded); sq=kv_len=1100 checks a ragged tail.
    for name, sq, S, kvl, record in (("prefill_attention", 128, 256, 128, True),
                                     ("flash_attention", 1100, 2048, 1100, False),
                                     ("flash_attention", 2048, 2048, 2048, True)):
        k, v = _kv_case(g, 1, hk, S, d, kv_scale)
        q = torch.randn((1, sq, hq, d), generator=g, device="cuda").to(torch.bfloat16)
        if name == "prefill_attention":
            run = lambda: fa.prefill_attention(q, k, v, causal=True, q_offset=0,
                                               kv_len=kvl, kv_scale=kv_scale)
        else:
            run = lambda: fa.flash_attention(q, k, v, causal=True, q_offset=0, kv_len=kvl,
                                             kv_scale=kv_scale, qo_layout="bshd")
        out = run()
        torch.cuda.synchronize()
        plain_fn = lambda: fa._attention_ref(q.permute(0, 2, 1, 3), k, v, causal=True,
                                             q_offset=0, kv_len=kvl, scale=sm,
                                             kv_scale=kv_scale)
        ref = plain_fn().permute(0, 2, 1, 3).to(torch.bfloat16)
        r = _verify_attn(name, out, ref)
        ms = gpu_ms(run)
        plain = gpu_ms(plain_fn, reps=5)
        qh = q.permute(0, 2, 1, 3)
        kd = (k[:, :, :kvl].float() * kv_scale).to(torch.bfloat16)
        vd = (v[:, :, :kvl].float() * kv_scale).to(torch.bfloat16)
        lib = gpu_ms(lambda: F.scaled_dot_product_attention(qh, kd, vd, is_causal=True))
        pairs = sq * (sq + 1) // 2               # causal (query, key) pairs, q_offset 0
        b_ms, b_by = bound(sq * hq * d * 2 * 2 + 2 * kvl * hk * d, 4.0 * pairs * hq * d)
        log(f"  {name} sq={sq} S={S} kv_len={kvl} ms={ms:.4f} plain_ms={plain:.4f} "
            f"lib_ms={lib:.4f} bound_ms={b_ms:.4f} ({b_by}) roofline={b_ms / ms:.3f} {r}")
        worst = max(records.get(name, {}).get("max_abs_err", 0.0), r.max_abs_err)
        if record:
            records[name] = dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=b_ms,
                                 bound_by=b_by, shape=f"b=1 sq={sq} S={S} kv_len={kvl} "
                                                      "hq=hk=32 d=128")
        records.setdefault(name, {})["max_abs_err"] = worst
        del k, v


# ---------------------------------------------------------------------------
# phase 2, the fourth slice's kernel modes: int8 x, requantize, scale_mode
# "none", the transposed layouts, bhsd flash_attention
# ---------------------------------------------------------------------------

# (label, K, N, Ms) of the 7B GEMMs the new modes are held at
NEW_SHAPES = (("w13", 4096, 22016, (4, 128)), ("wqkv", 4096, 12288, (128,)),
              ("w2", 11008, 4096, (128,)))


def _new_qmm_case(g, kind: str, K: int, N: int):
    """(weight, scales, bias, quant_matmul kwargs, bf16 dequantized [K, N]
    weight for the library yardstick or None) of one new mode; random
    carriers over the full range, f16-rounded scales."""
    import torch
    from csinn2_tpu_torch.core.quant import quantize_multiplier
    from csinn2_tpu_torch.kernels.qmatmul import pack_int4_t
    ri = lambda lo, hi, shape: torch.randint(lo, hi, shape, generator=g, device="cuda",
                                             dtype=torch.int8)
    rs = lambda shape, a=2e-4: (torch.rand(shape, generator=g, device="cuda") * a + 1e-5) \
        .to(torch.float16).float()
    if kind in ("int8dot", "int8dot_q", "requant", "none"):
        w = ri(-128, 128, (K, N))
        if kind == "none":
            return w, None, None, dict(scale_mode="none"), w.to(torch.bfloat16)
        if kind == "requant":
            bias = torch.randint(-2**18, 2**18, (N,), generator=g, device="cuda",
                                 dtype=torch.int32)
            eff = torch.rand((N,), generator=g, device="cuda").double().cpu().numpy() * 1e-4 + 1e-6
            mult, shift = quantize_multiplier(eff)
            kw = dict(scale_mode="none", out_dtype=torch.int8, out_zp=3.0,
                      rq_mult=torch.from_numpy(mult).cuda(), rq_shift=torch.from_numpy(shift).cuda())
            return w, None, bias, kw, None
        s = rs((N,), 1e-3)
        if kind == "int8dot":
            return w, s, None, dict(scale_mode="channel"), None
        bias = torch.randn((N,), generator=g, device="cuda") * 4
        return w, s * 0.05, bias, dict(scale_mode="channel", out_dtype=torch.int8,
                                       epilogue_scale=0.37, out_zp=3.0), None
    # transposed weights of the op API's block tensors, and the rest of 1e'
    packed = kind == "t_packed"
    lo = -8 if kind in ("t_q4_0", "t_packed") else -128
    q = ri(lo, 8 if lo == -8 else 128, (N, K))
    if kind == "t_int8_channel":
        s = rs((N,))
        deq = q.float() * s[:, None]
        kw = dict(scale_mode="channel", w_transposed=True)
    else:
        s = rs((N, K // 32))
        deq = (q.float().reshape(N, K // 32, 32) * s[:, :, None]).reshape(N, K)
        kw = dict(scale_mode="block", w_transposed=True, packed_int4=packed)
    return (pack_int4_t(q) if packed else q), s, None, kw, deq.t().to(torch.bfloat16)


NEW_QMM = {  # kind → (launch_counts name, label)
    "int8dot": ("quant_matmul_int8dot", "int8 x, channel, f32 out"),
    "int8dot_q": ("quant_matmul_int8dot", "int8 x, channel·e + b → int8 (zp 3)"),
    "requant": ("quant_matmul_requant", "int8 x, int32 bias, rq_mult → int8"),
    "none": ("quant_matmul_none", "bf16 x, scale_mode none, f32 out"),
    "t_q8_0": ("quant_matmul_t", "Q8_0 [N,K] + [N,K/32]"),
    "t_q4_0": ("quant_matmul_t", "Q4_0 carrier [N,K] + [N,K/32]"),
    "t_int8_channel": ("quant_matmul_t", "INT8_CHANNEL [N,K]"),
    "t_packed": ("quant_matmul_t", "Q4_0 packed [N,K/2] + [N,K/32]"),
}
# the case each new kernel's record shows (w13; decode M = 4); the int8-x
# kernels' records come from check_int8dot_cold
NEW_RECORD = {"quant_matmul_none": "none", "quant_matmul_t": "t_q8_0"}


def _x_for(g, kind, M, K):
    import torch
    if kind in ("int8dot", "int8dot_q", "requant"):
        return torch.randint(-128, 128, (M, K), generator=g, device="cuda", dtype=torch.int8)
    return torch.randn((M, K), generator=g, device="cuda").to(torch.bfloat16)


def _int_mm_x(x):
    """x as torch._int_mm takes it: it refuses M <= 16, so x zero-padded to 32
    rows there."""
    import torch
    if x.shape[0] > 16:
        return x
    return torch.cat([x, x.new_zeros((32 - x.shape[0], x.shape[1]))])


def int_mm_ms(x, w):
    """torch._int_mm's time on the same int8 operands (int32 sums only), warm."""
    import torch
    from csinn2_tpu_torch.utils.timing import gpu_ms
    xp = _int_mm_x(x)
    return gpu_ms(lambda: torch._int_mm(xp, w))


def check_int8dot_cold(records):
    """Row 1d on its redesigned kernels: the int8-x GEMM at w13 (INT8_CHANNEL
    [K, N] weight) at M = 1, 4, 8, 16, 128, 512 and 2048 in the float
    epilogue (channel scale, f32 out) and the requantize (int32 bias,
    rq_mult → int8), bit for bit the plain version, timed cold (weight
    copies beyond twice the L2) beside its bound and torch._int_mm's faster
    operand layout, cold: w [K, N], or the [N, K] copy's .t() view, which
    cuBLASLt takes column-major (x zero-padded to 32 rows at M <= 16).  The
    records of quant_matmul_int8dot and quant_matmul_requant: M = 4, with
    the prefill rows under "prefill"."""
    import numpy as np
    import torch
    from csinn2_tpu_torch.core.quant import quantize_multiplier
    from csinn2_tpu_torch.kernels.qmatmul import quant_matmul, quant_matmul_ref
    from csinn2_tpu_torch.utils.timing import cold_copies, gpu_ms, gpu_ms_cold, l2_bytes
    g = torch.Generator(device="cuda")
    g.manual_seed(4)
    K, N = 4096, 22016
    w = torch.randint(-128, 128, (K, N), generator=g, device="cuda", dtype=torch.int8)
    s = torch.rand((N,), generator=g, device="cuda") * 1e-3 + 1e-5
    bias = torch.randint(-2**18, 2**18, (N,), generator=g, device="cuda", dtype=torch.int32)
    mult, shift = quantize_multiplier(np.random.default_rng(4).uniform(1e-6, 1e-4, N))
    epilogues = {
        "quant_matmul_int8dot": ("float: channel, f32 out", s, None, dict(scale_mode="channel")),
        "quant_matmul_requant": ("requant: int32 bias, rq_mult -> int8", None, bias,
                                 dict(scale_mode="none", out_dtype=torch.int8, out_zp=3.0,
                                      rq_mult=torch.from_numpy(mult).cuda(),
                                      rq_shift=torch.from_numpy(shift).cuda()))}
    copies = [w] + [w.clone() for _ in range(cold_copies(w.numel(), l2_bytes()) - 1)]
    lib_layouts = {"w [K,N]": copies, "[N,K].t()": [c.t().contiguous().t() for c in copies]}
    for M in (1, 4, 8, 16, 128, 512, 2048):
        x = torch.randint(-128, 128, (M, K), generator=g, device="cuda", dtype=torch.int8)
        xp = _int_mm_x(x)
        libs = {name: gpu_ms_cold([lambda c=c: torch._int_mm(xp, c) for c in cs])
                for name, cs in lib_layouts.items()}
        lib_name = min(libs, key=libs.get)
        for key, (label, sc, b, kw) in epilogues.items():
            y = quant_matmul(x, w, sc, b, **kw)
            torch.cuda.synchronize()
            if not torch.equal(y, quant_matmul_ref(x, w, sc, b, **kw)):
                raise AssertionError(f"{key} w13 M={M}: {int((y != quant_matmul_ref(x, w, sc, b, **kw)).sum())} outputs differ")
            ms = gpu_ms_cold([lambda c=c: quant_matmul(x, c, sc, b, **kw) for c in copies])
            plain = gpu_ms(lambda: quant_matmul_ref(x, w, sc, b, **kw), reps=3)
            nbytes = M * K + K * N + 8 * N + M * N * y.element_size()
            b_ms, b_by = bound(nbytes, 2.0 * M * N * K, INT8_OPS)
            log(f"  {key} {label} w13 M={M:4d} cold: ms={ms:.4f} plain_ms={plain:.4f} "
                f"bound_ms={b_ms:.4f} ({b_by}) roofline={b_ms / ms:.3f} torch._int_mm "
                f"{libs['w [K,N]']:.4f} (w [K,N]) / {libs['[N,K].t()']:.4f} ([N,K].t()): "
                f"x{ms / libs[lib_name]:.2f} of the faster; bit for bit")
            rec = records.setdefault(key, {"max_abs_err": 0.0})
            row = dict(ms=ms, plain_ms=plain, library_ms=libs[lib_name], bound_ms=b_ms,
                       bound_by=b_by, library_layout=lib_name)
            if M == 4:
                rec.update(row, shape=f"{label} w13 M=4 K={K} N={N} [K,N], cold (library: "
                                      f"torch._int_mm, x zero-padded to 32 rows, {lib_name})")
            elif M > 16:
                rec.setdefault("prefill", {})[f"M={M}"] = row
    del copies, lib_layouts


def kernel_api_path():
    """The path of the modes no package caller reaches (rows 1b' and 1d,
    the int8-x swiglu too): the public kernel API, quant_matmul, once per
    mode at each 7B shape.  Returns the launch counts of exactly these
    calls."""
    import torch
    from csinn2_tpu_torch.kernels import launch_counts, reset_launch_counts
    from csinn2_tpu_torch.kernels.qmatmul import quant_matmul
    g = torch.Generator(device="cuda")
    g.manual_seed(2)
    calls = []
    for kind in ("int8dot", "int8dot_q", "requant", "none"):
        for _, K, N, Ms in NEW_SHAPES:
            w, s, b, kw, _ = _new_qmm_case(g, kind, K, N)
            calls += [(_x_for(g, kind, M, K), w, s, b, kw) for M in Ms]
            if kind == "int8dot" and N % 256 == 0:     # the swiglu pairs (w13)
                calls += [(_x_for(g, kind, M, K), w, s, b, dict(kw, swiglu=True)) for M in Ms]
    torch.cuda.synchronize()
    reset_launch_counts()
    for x, w, s, b, kw in calls:
        quant_matmul(x, w, s, b, **kw)
    torch.cuda.synchronize()
    counts = dict(launch_counts)
    log(f"  kernel API path: {len(calls)} quant_matmul calls; launches {counts}")
    return counts


def check_new_quant_matmul(records):
    """Every new mode against its plain version at the 7B shapes, timed
    beside its bound, the plain version and a library call: torch._int_mm
    (int32 sums only; at M <= 16, which it refuses, on x zero-padded to 32
    rows) for the int8 x rows, torch.matmul on the dequantized bf16 weight
    for the float rows.  int8 x with f32 out and the requantize: bit for bit; the
    float epilogue to int8: 1 LSB on under 0.1 % (a double-rounding tie of
    the plain version's f64 fma)."""
    import torch
    from csinn2_tpu_torch.kernels.qmatmul import quant_matmul, quant_matmul_ref
    from csinn2_tpu_torch.utils.timing import gpu_ms
    from csinn2_tpu_torch.utils.verify import cosine_similarity
    g = torch.Generator(device="cuda")
    g.manual_seed(3)
    for kind, (key, label) in NEW_QMM.items():
        for name, K, N, Ms in NEW_SHAPES:
            w, s, b, kw, deq = _new_qmm_case(g, kind, K, N)
            for M in Ms:
                x = _x_for(g, kind, M, K)
                run = lambda: quant_matmul(x, w, s, b, **kw)
                y = run()
                torch.cuda.synchronize()
                ref = quant_matmul_ref(x, w, s, b, **kw)
                if kind in ("int8dot", "requant"):
                    if not torch.equal(y, ref):
                        raise AssertionError(f"{key} {kind} {name} M={M}: "
                                             f"{int((y != ref).sum())} outputs differ")
                    err, note = 0.0, "bit for bit"
                elif kind == "int8dot_q":
                    d = (y.int() - ref.int()).abs()
                    frac = float((d > 0).float().mean())
                    if int(d.max()) > 1 or frac >= 1e-3:
                        raise AssertionError(f"{key} int8 epilogue {name} M={M}: "
                                             f"max {int(d.max())} LSB on {frac:.2e}")
                    err, note = float(d.max()), f"{frac:.2e} of outputs 1 LSB off"
                else:
                    yf, rf = y.float().cpu().numpy(), ref.float().cpu().numpy()
                    err = float(abs(yf - rf).max())
                    cos = cosine_similarity(yf, rf)
                    if not (cos >= 0.9999 and err <= 1e-2 * float(abs(rf).max())):
                        raise AssertionError(f"{key} {kind} {name} M={M}: cos={cos} err={err}")
                    note = f"cos={cos:.6f}"
                ms = gpu_ms(run)
                plain = gpu_ms(lambda: quant_matmul_ref(x, w, s, b, **kw), reps=3)
                cold = {}
                if deq is not None:
                    xb = x.to(torch.bfloat16)
                    lib = gpu_ms(lambda: torch.matmul(xb, deq))
                    if M <= 16:                # the decode kernel, cold
                        cold = dict(zip(("ms_cold", "library_ms_cold"), _gemm_cold(
                            xb, w, s, deq, lambda wc, sc: quant_matmul(x, wc, sc, b, **kw))))
                        note += (f" cold: ms={cold['ms_cold']:.4f} "
                                 f"lib_ms={cold['library_ms_cold']:.4f}")
                else:
                    lib = int_mm_ms(x, w)
                osz = y.element_size()
                int_x = x.dtype == torch.int8
                nbytes = (x.numel() * x.element_size() + w.numel()
                          + (0 if s is None else s.numel() * 4)
                          + (0 if b is None else N * 4) + (8 * N if kind == "requant" else 0)
                          + M * N * osz)
                b_ms, b_by = bound(nbytes, 2.0 * M * N * K, INT8_OPS if int_x else BF16_FLOPS)
                log(f"  {key} {label} {name} M={M:4d} K={K:5d} N={N:5d} ms={ms:.4f} "
                    f"plain_ms={plain:.4f} lib_ms={lib:.4f} bound_ms={b_ms:.4f} ({b_by}) "
                    f"roofline={b_ms / ms:.3f} {note}")
                rec = records.setdefault(key, {"max_abs_err": 0.0})
                rec["max_abs_err"] = max(rec["max_abs_err"], err)
                if NEW_RECORD.get(key) == kind and name == "w13" and M == 4:
                    padded = " (library: x zero-padded to 32 rows)" if deq is None else ""
                    rec.update(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=b_ms,
                               bound_by=b_by, shape=f"{label} w13 M=4 K={K} N={N}{padded}",
                               **cold)
            del w, s, b, deq


def check_flash_bhsd(records):
    """bhsd flash_attention at the decode shape of row 2 (b = 4, hq = hk = 32,
    d = 128, S = 2048, kv_len 2048/1027/1/17, causal, q_offset = kv_len - 1:
    what the engine's CSINN2_DECODE_ATTN=flash decode calls) and at
    sq = S = 2048 (the op API's prefill SDPA), against the plain version."""
    import torch
    import torch.nn.functional as F
    from csinn2_tpu_torch.kernels import flash_attention as fa
    from csinn2_tpu_torch.utils.timing import gpu_ms
    g = torch.Generator(device="cuda")
    g.manual_seed(4)
    hq = hk = 32
    d, kv_scale, S = 128, 0.05, 2048
    sm = 1.0 / math.sqrt(d)
    worst = 0.0
    for case in ("decode", "prefill"):
        b, sq = (4, 1) if case == "decode" else (1, S)
        k, v = _kv_case(g, b, hk, S, d, kv_scale)
        q = torch.randn((b, hq, sq, d), generator=g, device="cuda").to(torch.bfloat16)
        kvl = torch.tensor([2048, 1027, 1, 17] if case == "decode" else [S],
                           dtype=torch.int32, device="cuda")
        off = kvl - 1 if case == "decode" else torch.zeros_like(kvl)
        kw = dict(causal=True, q_offset=off, kv_len=kvl, kv_scale=kv_scale)
        run = lambda: fa.flash_attention(q, k, v, **kw)
        out = run()
        torch.cuda.synchronize()
        plain_fn = lambda: fa._attention_ref(q, k, v, scale=sm, **kw)
        r = _verify_attn(f"flash_attention_bhsd {case}", out, plain_fn().to(torch.bfloat16))
        worst = max(worst, r.max_abs_err)
        ms = gpu_ms(run)
        plain = gpu_ms(plain_fn, reps=5)
        kd = (k.float() * kv_scale).to(torch.bfloat16)
        vd = (v.float() * kv_scale).to(torch.bfloat16)
        if case == "decode":
            mask = (torch.arange(S, device="cuda")[None, :] < kvl[:, None])[:, None, None, :]
            lib = gpu_ms(lambda: F.scaled_dot_product_attention(q, kd, vd, attn_mask=mask))
            n_kv = int(kvl.sum())
            b_ms, b_by = bound(b * hq * d * 2 * 2 + 2 * n_kv * hk * d, 4.0 * n_kv * hq * d)
        else:
            lib = gpu_ms(lambda: F.scaled_dot_product_attention(q, kd, vd, is_causal=True))
            pairs = sq * (sq + 1) // 2
            b_ms, b_by = bound(sq * hq * d * 2 * 2 + 2 * S * hk * d, 4.0 * pairs * hq * d)
        shape = (f"b={b} hq=hk=32 sq={sq} d=128 S={S} kv_len={kvl.tolist()} causal, "
                 f"q_offset {'kv_len - 1' if case == 'decode' else '0'}")
        log(f"  flash_attention_bhsd {shape} ms={ms:.4f} plain_ms={plain:.4f} lib_ms={lib:.4f} "
            f"bound_ms={b_ms:.4f} ({b_by}) roofline={b_ms / ms:.3f} {r}")
        if case == "decode":
            cold, lib_cold = _decode_cold(
                g, b, hk, S, d, kv_scale, lambda k_, v_: fa.flash_attention(q, k_, v_, **kw),
                lambda kd_, vd_: F.scaled_dot_product_attention(q, kd_, vd_, attn_mask=mask))
            log(f"  flash_attention_bhsd decode cold: ms={cold:.4f} lib_ms={lib_cold:.4f} "
                f"roofline={b_ms / cold:.3f}")
            records["flash_attention_bhsd"] = dict(ms=ms, plain_ms=plain, library_ms=lib,
                                                   bound_ms=b_ms, bound_by=b_by, ms_cold=cold,
                                                   library_ms_cold=lib_cold, shape=shape)
        del k, v
    records["flash_attention_bhsd"]["max_abs_err"] = worst


ATTN_DIMS = (16, 32, 80, 96, 256)
ATTN_ENTRIES = ("prefill_attention", "flash_attention", "flash_attention_bhsd",
                "decode_attention")


def _attend(name, q, k, v, kw):
    """(output, its plain version on q rounded to bf16) of one attention entry
    point; q is [b, sq, hq, d] for prefill and bshd flash, [b, hq, sq, d]
    for bhsd flash and decode."""
    import torch
    from csinn2_tpu_torch.kernels import flash_attention as fa
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
    qb = q.to(torch.bfloat16)
    ref = fa._attention_ref(qb if bhsd else qb.permute(0, 2, 1, 3), k, v,
                            scale=1.0 / math.sqrt(q.shape[-1]), **kw)
    return out, ref if bhsd else ref.permute(0, 2, 1, 3)


def check_attention_dims(records):
    """The head dims the JAX kernels take besides 64 and 128 (they pad d to
    a multiple of 128) and an f32 q (rounded to bf16 in the kernel, as the
    JAX bodies round it), through the four attention entry points with int8
    (kv_scale 0.05) and bf16 KV, GQA 32/8, per-row q_offset / kv_len: b = 2,
    sq = 128 over S = 512 (kv_len 128 / 461, q_offset 0 / 333) and decode at
    kv_len 1 / 334; each output in q's dtype, against its plain version on
    q rounded to bf16 at the attention gate.  Then the split-KV flash decode
    at kv_len 0, 1, 17 and 2048 (sq 1 and 3)."""
    import torch
    g = torch.Generator(device="cuda")
    g.manual_seed(5)
    b, hq, hk, S = 2, 32, 8, 512
    n = 0
    for d in ATTN_DIMS:
        for int8 in (True, False):
            if int8:
                k, v = _kv_case(g, b, hk, S, d, 0.05)
            else:
                k, v = (torch.randn((b, S, hk, d), generator=g, device="cuda")
                        .to(torch.bfloat16).permute(0, 2, 1, 3) for _ in range(2))
            for qdt in (torch.float32, torch.bfloat16):
                for name in ATTN_ENTRIES:
                    sq = 1 if name == "decode_attention" else 128
                    bhsd = name in ("flash_attention_bhsd", "decode_attention")
                    q = torch.randn((b, hq, sq, d) if bhsd else (b, sq, hq, d), generator=g,
                                    device="cuda").to(qdt)
                    off = torch.tensor([0, 333], dtype=torch.int32, device="cuda")
                    kw = dict(causal=True, q_offset=off, kv_len=off + sq,
                              kv_scale=0.05 if int8 else None)
                    out, ref = _attend(name, q, k, v, kw)
                    if out.dtype != qdt or out.shape != q.shape:
                        raise AssertionError(f"{name} d={d}: out {out.dtype} {tuple(out.shape)}")
                    r = _verify_attn(f"{name} d={d} int8={int8} q {qdt}", out, ref)
                    rec = records.setdefault(name, {})
                    rec["max_abs_err"] = max(rec.get("max_abs_err", 0.0), r.max_abs_err)
                    n += 1
            del k, v
    log(f"  head dims {ATTN_DIMS} x int8/bf16 KV x f32/bf16 q x {len(ATTN_ENTRIES)} entry "
        f"points: {n} cases against the plain version, verify(2e-2), cos >= 0.9999")
    # the split-KV flash decode at the window's edges: kv_len 0 (outputs 0), 1, 17, 2048
    k, v = _kv_case(g, 4, hk, 2048, 128, 0.05)
    kvl = torch.tensor([0, 1, 17, 2048], dtype=torch.int32, device="cuda")
    for sq in (1, 3):
        q = torch.randn((4, hq, sq, 128), generator=g, device="cuda").to(torch.bfloat16)
        kw = dict(causal=True, q_offset=(kvl - sq).clamp(min=0), kv_len=kvl, kv_scale=0.05)
        out, ref = _attend("flash_attention_bhsd", q, k, v, kw)
        r = _verify_attn(f"split-KV decode sq={sq} kv_len {kvl.tolist()}", out, ref)
        if float(out[0].abs().max()) != 0.0:
            raise AssertionError("split-KV decode: the kv_len = 0 row must output 0")
        rec = records["flash_attention_bhsd"]
        rec["max_abs_err"] = max(rec["max_abs_err"], r.max_abs_err)
    log(f"  split-KV flash decode, GQA {hq}/{hk}, sq 1 and 3, kv_len {kvl.tolist()}: "
        f"against the plain version, the kv_len = 0 row 0")


WIDE_DS = (320, 576)   # 576: two CTA slices of O's columns
MLA = (128, 1, 576)    # DeepSeek-V2/V3's absorbed latent attention at decode: hq, hk, d


def check_attention_wide(records):
    """Head dims above 256 (attn_wide_mma_kernel, on wgmma): GQA 32/8 at d =
    320 and 576, int8 (kv_scale 0.05) and bf16 KV, per-row q_offset /
    kv_len: the four entry points at b = 2, sq = 128 over S = 512 (kv_len
    128 / 461, q_offset 0 / 333) and decode b = 4 over S = 2048 (kv_len 2048
    / 1027 / 0 / 17); and absorbed MLA's decode (hq 128 on one KV head, d =
    576, the port's one d for K and V where the model's V has 512) at the
    same decode rows.  The calls run once with the launch counts zeroed just
    before and read just after (their path: no package caller reaches d >
    256): one kernel launch a call, and a merge (`.combine`) for each call
    whose plan splits the KV window (the decodes', and at d = 320 the bf16
    prefills'); then each output against
    its plain version at the attention gate, the kv_len = 0 row 0; then
    flash_attention bhsd at sq = S = 512 (causal) and decode_attention at
    both d, and the MLA decode, timed beside the plain version and SDPA on
    the dequantized K/V (GQA-expanded; MLA's one head broadcast).  Returns
    the path's launch counts."""
    import torch
    import torch.nn.functional as F
    from csinn2_tpu_torch.kernels import flash_attention as fa
    from csinn2_tpu_torch.kernels import launch_counts, reset_launch_counts
    from csinn2_tpu_torch.utils.timing import gpu_ms
    g = torch.Generator(device="cuda")
    g.manual_seed(6)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    cases, merges = [], 0
    gqa = [(32, 8, d, name) for d in WIDE_DS for name in ATTN_ENTRIES]
    for hq, hk, d, name in gqa + [MLA + ("decode_attention",)]:
        for int8 in (True, False):
            dec = name == "decode_attention"
            b, S, sq = (4, 2048, 1) if dec else (2, 512, 128)
            if int8:
                k, v = _kv_case(g, b, hk, S, d, 0.05)
            else:
                k, v = (torch.randn((b, S, hk, d), generator=g, device="cuda")
                        .to(torch.bfloat16).permute(0, 2, 1, 3) for _ in range(2))
            bhsd = name in ("flash_attention_bhsd", "decode_attention")
            q = torch.randn((b, hq, sq, d) if bhsd else (b, sq, hq, d), generator=g,
                            device="cuda").to(torch.bfloat16)
            kvl = torch.tensor([2048, 1027, 0, 17] if dec else [128, 461],
                               dtype=torch.int32, device="cuda")
            off = kvl - 1 if dec else torch.tensor([0, 333], dtype=torch.int32, device="cuda")
            cases.append((name, hq, hk, d, int8, q, k, v,
                          dict(causal=True, q_offset=off, kv_len=kvl,
                               kv_scale=0.05 if int8 else None)))
            merges += fa._wide_plan(b, sq, hq, hk, S, d, k.element_size(), n_sm).n_chunks > 1
    torch.cuda.synchronize()
    reset_launch_counts()
    outs = [_attend(name, q, k, v, kw) for name, _, _, _, _, q, k, v, kw in cases]   # synchronizes
    counts = dict(launch_counts)
    log(f"  head dims {WIDE_DS} and MLA {MLA}: the four entry points (MLA: decode), int8 and "
        f"bf16 KV; launches {counts}")
    n_merge = sum(n for key, n in counts.items()
                  if key.startswith("attention_wide.") and key.endswith(".combine"))
    n_kernel = launches(counts, "attention_wide") - n_merge
    if n_kernel != len(cases) or n_merge != merges or launches(counts, "attention_wide") != \
            sum(counts.values()):
        raise AssertionError(f"attention_wide: {n_kernel} launches and {n_merge} merges for "
                             f"{len(cases)} calls and {merges} split plans: {counts}")
    worst = 0.0
    for (name, hq, hk, d, int8, *_), (out, ref) in zip(cases, outs):
        r = _verify_attn(f"attention_wide {name} hq={hq} hk={hk} d={d} int8={int8}", out, ref)
        worst = max(worst, r.max_abs_err)
        if name == "decode_attention" and float(out[2].abs().max()) != 0.0:
            raise AssertionError("attention_wide: the kv_len = 0 row must output 0")
    log(f"  head dims {WIDE_DS} and MLA: {len(cases)} calls against the plain version, "
        f"verify(2e-2), cos >= 0.9999, max_abs_err {worst:.3e}; the kv_len = 0 row 0")
    rec = {"max_abs_err": worst, "launches_combine": n_merge}
    # timing: bhsd flash at sq = S = 512 (causal), and decode at the case above
    kv_scale = 0.05
    timed = [(32, 8, d, case) for d in WIDE_DS for case in ("flash", "decode")]
    for hq, hk, d, case in timed + [MLA + ("decode",)]:
        b, S, sq = (1, 512, 512) if case == "flash" else (4, 2048, 1)
        k, v = _kv_case(g, b, hk, S, d, kv_scale)
        q = torch.randn((b, hq, sq, d), generator=g, device="cuda").to(torch.bfloat16)
        kvl = torch.tensor([S] if case == "flash" else [2048, 1027, 0, 17],
                           dtype=torch.int32, device="cuda")
        if case == "flash":
            kw = dict(causal=True, q_offset=0, kv_len=kvl, kv_scale=kv_scale)
            run = lambda: fa.flash_attention(q, k, v, **kw)
            plain_fn = lambda: fa._attention_ref(q, k, v, scale=1.0 / math.sqrt(d), **kw)
        else:
            kw = dict(q_offset=kvl - 1, kv_len=kvl, kv_scale=kv_scale)
            run = lambda: fa.decode_attention(q, k, v, **kw)
            plain_fn = lambda: fa._attention_ref(q, k, v, causal=False,
                                                 scale=1.0 / math.sqrt(d), **kw)
        ms = gpu_ms(run)
        plain = gpu_ms(plain_fn, reps=3)
        kd, vd = ((x.float() * kv_scale).to(torch.bfloat16) for x in (k, v))
        kd, vd = ((x.expand(-1, hq, -1, -1) if hk == 1 else x.repeat_interleave(hq // hk, dim=1))
                  for x in (kd, vd))
        if case == "flash":
            lib = gpu_ms(lambda: F.scaled_dot_product_attention(q, kd, vd, is_causal=True))
            pairs = sq * (sq + 1) // 2
            b_ms, b_by = bound(2 * b * sq * hq * d * 2 + 2 * S * hk * d,
                               4.0 * pairs * hq * d)
        else:
            mask = (torch.arange(S, device="cuda")[None, :] < kvl[:, None])[:, None, None, :]
            lib = gpu_ms(lambda: F.scaled_dot_product_attention(q, kd, vd, attn_mask=mask))
            n_kv = int(kvl.sum())
            b_ms, b_by = bound(2 * b * hq * d * 2 + 2 * n_kv * hk * d, 4.0 * n_kv * hq * d)
        shape = (f"{'flash_attention bhsd' if case == 'flash' else 'decode_attention'} "
                 f"b={b} hq={hq} hk={hk} sq={sq} d={d} S={S} kv_len={kvl.tolist()}, int8 KV")
        log(f"  attention_wide {shape} ms={ms:.4f} plain_ms={plain:.4f} lib_ms={lib:.4f} "
            f"bound_ms={b_ms:.4f} ({b_by}) roofline={b_ms / ms:.3f}")
        times = dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=b_ms, bound_by=b_by,
                     shape=shape)
        if case == "flash" and d == WIDE_DS[0]:
            rec.update(times)
        elif hk == 1:
            rec["decode_mla"] = times
        else:
            rec[case if d == WIDE_DS[0] else f"{case}_d{d}"] = times
        del k, v, kd, vd
    records["attention_wide"] = rec
    return counts


# ---------------------------------------------------------------------------
# phase 8: the op API's CUDA tier at Llama-2-7B width
# ---------------------------------------------------------------------------

# (name, N, K) of the four projections of one Llama-2-7B layer, [N, K] weights
LAYER_FCS = (("wqkv", 12288, 4096), ("wo", 4096, 4096), ("w13", 22016, 4096),
             ("w2", 4096, 11008))


def _block_tensor(g, scheme, N, K):
    """A Q8_0 / Q4_0 block tensor made on the card from the generator: int8
    values [N, K] (Q4_0 in [-8, 7], the unpacked carrier) and fp16 scales
    [N, K/32]."""
    import torch
    from csinn2_tpu_torch.core.dtypes import QuantScheme
    from csinn2_tpu_torch.core.quant import BlockQuant
    from csinn2_tpu_torch.core.tensor import Tensor
    lim = 8 if scheme == "q4_0" else 128
    values = torch.randint(-lim + (scheme == "q8_0"), lim, (N, K), generator=g, device="cuda",
                           dtype=torch.int8)
    scales = (torch.rand((N, K // 32), generator=g, device="cuda") * 2e-3 + 1e-4).half()
    sch = QuantScheme.BLOCK_Q4_0 if scheme == "q4_0" else QuantScheme.BLOCK_Q8_0
    return Tensor(block=BlockQuant(values=values, scales=scales, scheme=sch))


def _op_graph(api, weights, M, out_qinfo=None, layer_mode=False, xs=None):
    """The four projections (and with M = None the two SDPA calls) through
    the op API: a GRAPH Session on the card, or in layer mode the eager
    calls.  Returns (session or None, outputs)."""
    from csinn2_tpu_torch import ops
    from csinn2_tpu_torch.core.dtypes import Dtype, RunMode
    from csinn2_tpu_torch.core.tensor import Tensor, TensorMeta
    from csinn2_tpu_torch.runtime.session import Session

    def body(inputs):
        if M is None:
            (pq, pk), (dq, dk) = (inputs[0], inputs[1]), (inputs[2], inputs[3])
            return [ops.scaled_dot_product_attention(pq, pk, pk, ops.SDPAParams(causal=True)),
                    ops.scaled_dot_product_attention(
                        dq, dk, dk, ops.SDPAParams(causal=True, pos_offset=1500, kv_len=1501))]
        x4096, x11008 = inputs
        return [ops.fullyconnected(x11008 if name == "w2" else x4096, weights[name],
                                   out_qinfo=out_qinfo if name == "wo" else None)
                for name, _, _ in LAYER_FCS]

    if layer_mode:
        sess = Session(run_mode=RunMode.LAYER, api=api, device="cuda")
        with sess.build():
            return None, [o.data for o in body([Tensor(x) for x in xs])]
    sess = Session(run_mode=RunMode.GRAPH, api=api, device="cuda")
    with sess.build():
        ins = [sess.input(TensorMeta(shape=tuple(x.shape), dtype=Dtype.FLOAT32)) for x in xs]
        sess.set_output(*body(ins))
    sess.setup()
    return sess, None


def op_api_path(records, gpu_line):
    """Phase 8: `ops.fullyconnected` on Q8_0 and Q4_0 block tensors of one
    Llama-2-7B layer's four projections at M = 128 and 4, and
    `ops.scaled_dot_product_attention` at prefill ([1, 32, 2048, 128],
    causal) and decode ([4, 32, 1, 128] over S = 2048, pos_offset 1500,
    kv_len 1501), recorded into a GRAPH Session(device="cuda") with Api.AUTO
    and run in layer mode; held against the same graph in an Api.TORCH
    session.  Returns the launch counts of the AUTO GRAPH runs."""
    import numpy as np
    import torch
    from csinn2_tpu_torch.core.dtypes import Api, Dtype
    from csinn2_tpu_torch.core.quant import QuantInfo
    from csinn2_tpu_torch.kernels import launch_counts, reset_launch_counts
    from csinn2_tpu_torch.utils.verify import cosine_similarity, verify
    g = torch.Generator(device="cuda")
    g.manual_seed(5)
    cases = []
    for scheme in ("q8_0", "q4_0"):
        weights = {name: _block_tensor(g, scheme, N, K) for name, N, K in LAYER_FCS}
        for M in (128, 4):
            xs = [torch.randn((M, K), generator=g, device="cuda") for K in (4096, 11008)]
            cases.append((f"{scheme} fc M={M}", weights, M, xs))
    sdpa_xs = [torch.randn(sh, generator=g, device="cuda").to(torch.bfloat16).float()
               for sh in ((1, 32, 2048, 128), (1, 32, 2048, 128), (4, 32, 1, 128),
                          (4, 32, 2048, 128))]
    cases.append(("sdpa prefill+decode", None, None, sdpa_xs))
    torch.cuda.synchronize()

    counts = {}
    for label, weights, M, xs in cases:
        auto, _ = _op_graph(Api.AUTO, weights, M, xs=xs)
        ref, _ = _op_graph(Api.TORCH, weights, M, xs=xs)
        names = [n.cb_name for n in auto.graph.nodes]
        if not all(n.endswith(":cuda") for n in names):
            raise AssertionError(f"phase 8 {label}: nodes not on the CUDA tier: {names}")
        reset_launch_counts()
        torch.cuda.synchronize()
        outs = auto.run(*xs, unwrap=False)
        torch.cuda.synchronize()
        run_counts = dict(launch_counts)
        for k, n in run_counts.items():
            counts[k] = counts.get(k, 0) + n
        want = ref.run(*xs, unwrap=False)
        _, eager = _op_graph(Api.AUTO, weights, M, layer_mode=True, xs=xs)
        gates = []
        for i, (o, e, w_) in enumerate(zip(outs, eager, want)):
            o, e, w_ = (t.float().cpu().numpy() for t in (o, e, w_))
            if M is None:
                r = verify(o, w_, tol=2e-2, min_cosine=0.9999)
                if not (r.passed and verify(e, w_, tol=2e-2, min_cosine=0.9999).passed):
                    raise AssertionError(f"phase 8 {label} output {i}: {r}")
                gates.append(f"{r.cosine_sim:.6f}")
            else:
                c, ce = cosine_similarity(o, w_), cosine_similarity(e, w_)
                if not (c >= 0.9999 and ce >= 0.9999):
                    raise AssertionError(f"phase 8 {label} {LAYER_FCS[i][0]}: cos {c} / {ce}")
                gates.append(f"{c:.6f}")
        t_auto = auto.run_benchmark_device(*xs, iters=10, reps=3)
        t_ref = ref.run_benchmark_device(*xs, iters=3, reps=3)
        log(f"  {label}: nodes {names}; launches {run_counts}; cos vs Api.TORCH {gates} "
            f"(graph and layer mode); graph run {t_auto * 1e3:.3f} ms vs Api.TORCH "
            f"{t_ref * 1e3:.3f} ms (CUDA events) [{gpu_line}]")
        if label == "q8_0 fc M=4":
            # an int8 out_qinfo on wo: the CUDA tier's requantize vs the TORCH tier's
            y = want[1].float()
            qi = QuantInfo(scale=float(y.abs().max()) / 127.0, zero_point=0, dtype=Dtype.INT8)
            qa, _ = _op_graph(Api.AUTO, weights, M, out_qinfo=qi, xs=xs)
            qr, _ = _op_graph(Api.TORCH, weights, M, out_qinfo=qi, xs=xs)
            a, b = qa.run(*xs, unwrap=False)[1], qr.run(*xs, unwrap=False)[1]
            d = (a.int() - b.int()).abs()
            log(f"  wo with an int8 out_qinfo (scale {qi.scale:.4g}): {a.dtype}, max |d| "
                f"{int(d.max())} LSB, {int((d > 0).sum())} of {d.numel()} off")
            if a.dtype != torch.int8 or int(d.max()) > 1:
                raise AssertionError("phase 8: int8 out_qinfo off by more than 1 LSB")
        del auto, ref, outs, want, eager
    for k in ("quant_matmul_t.prefill", "quant_matmul_t.decode", "flash_attention_bhsd"):
        if counts.get(k, 0) == 0:
            raise AssertionError(f"phase 8 never launched {k}: {counts}")
    log(f"  phase 8 launches (AUTO graph runs): {counts}")
    torch.cuda.empty_cache()
    return counts


# ---------------------------------------------------------------------------
# phase 3: a 2-layer 7B-width model, card against the CPU plain path
# ---------------------------------------------------------------------------

def _to(tree, device):
    import torch
    from csinn2_tpu_torch.llm.model import QWeight
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    if isinstance(tree, QWeight):
        return dataclasses.replace(tree, values=tree.values.to(device),
                                   scales=None if tree.scales is None
                                   else tree.scales.to(device))
    return tree.to(device) if isinstance(tree, torch.Tensor) else tree


@contextlib.contextmanager
def env_flag(name: str, on: bool, value: str = "1"):
    """Environment variable `name` set to `value` (or unset) inside the block."""
    old = os.environ.pop(name, None)
    if on:
        os.environ[name] = value
    try:
        yield
    finally:
        os.environ.pop(name, None)
        if old is not None:
            os.environ[name] = old


def swiglu_fusion(on: bool):
    """CSINN2_SWIGLU_FUSE=1 (or unset) while the params are fused."""
    return env_flag("CSINN2_SWIGLU_FUSE", on)


def model_parity(mode: str, swiglu: bool):
    import numpy as np
    import torch
    from csinn2_tpu_torch.llm.config import LlamaConfig
    from csinn2_tpu_torch.llm.model import KVCache, fuse_params, init_params_device, llama_forward
    from csinn2_tpu_torch.utils.verify import cosine_similarity
    cfg = dataclasses.replace(LlamaConfig.llama2_7b(), n_layers=2, max_seq_len=256)
    with swiglu_fusion(swiglu):
        params = fuse_params(init_params_device(cfg, mode, seed=3, device="cuda"))
    if (params["layers"][0]["w13"].layout == "swiglu128") != swiglu:
        raise AssertionError("swiglu128 fusion not as asked")
    toks = torch.from_numpy(np.random.default_rng(3).integers(1, cfg.vocab_size, (1, 128)))
    cache = KVCache.create(cfg, 1, quantized=True, device="cuda")
    gpu, _ = llama_forward(params, toks, cache, 0, cfg)
    gpu = gpu.float().cpu().numpy()
    cpu_params = _to(params, "cpu")
    del params
    cache = KVCache.create(cfg, 1, quantized=True, device="cpu")
    cpu, _ = llama_forward(cpu_params, toks, cache, 0, cfg)
    cos = cosine_similarity(gpu, cpu.numpy())
    log(f"  2-layer 7B-width {mode}{' +swiglu128' if swiglu else ''} int8-KV prefill s=128: "
        f"logits {gpu.shape} finite={bool(np.isfinite(gpu).all())} "
        f"cosine(card, cpu plain)={cos:.6f}")
    if not (np.isfinite(gpu).all() and cos >= 0.999):
        raise AssertionError(f"model parity {mode} swiglu={swiglu}: cosine {cos}")


# ---------------------------------------------------------------------------
# phases 4-6: serving paths at full width
# ---------------------------------------------------------------------------

def serve(gpu_line: str, mode: str, swiglu: bool = False, flash_decode: bool = False,
          base=None):
    """Llama-2-7B (32 layers), `mode` weights made on the card, int8 KV:
    run_queue over the six prompts, then TTFT at prompt 128 and decode
    tokens/s at batch 4.  flash_decode: all of it under
    CSINN2_DECODE_ATTN=flash, with the tokens and decode rate set beside
    `base` (the default decode's serve result) and one decode step's logits
    against the default decode's.  Returns dict(counts of the run_queue,
    outs, tps, steps = decode steps of the run_queue)."""
    with env_flag("CSINN2_DECODE_ATTN", flash_decode, "flash"):
        return _serve(gpu_line, mode, swiglu, flash_decode, base)


def _serve(gpu_line, mode, swiglu, flash_decode, base):
    import numpy as np
    import torch
    from csinn2_tpu_torch.kernels import launch_counts, reset_launch_counts
    from csinn2_tpu_torch.kernels.qmatmul import launch_key, reduce_launches
    from csinn2_tpu_torch.llm.config import LlamaConfig
    from csinn2_tpu_torch.llm.engine import InferenceEngine, Request
    from csinn2_tpu_torch.llm.model import init_params_device
    cfg = LlamaConfig.llama2_7b()
    name = f"{mode}{' +swiglu128' if swiglu else ''}"
    t0 = time.perf_counter()
    with swiglu_fusion(swiglu):
        eng = InferenceEngine(cfg, init_params_device(cfg, mode, seed=0, device="cuda"),
                              batch=4, quantized_kv=True, device="cuda")
    torch.cuda.synchronize()
    log(f"  Llama-2-7B {name} weights made and quantized on the card: "
        f"{time.perf_counter() - t0:.2f} s, {torch.cuda.memory_allocated() / 2**30:.2f} GiB "
        f"(weights + int8 KV cache)")
    rng = np.random.default_rng(0)
    reqs = [Request(prompt=[int(t) for t in rng.integers(1, cfg.vocab_size, n)],
                    max_new_tokens=16) for n in PROMPTS]

    steps = [0]
    decode_steps = eng.decode_steps

    def counted(next_tokens, n_steps, **kw):
        steps[0] += n_steps
        return decode_steps(next_tokens, n_steps, **kw)

    eng.decode_steps = counted
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = eng.run_queue(reqs, chunk=16)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(launch_counts)
    eng.decode_steps = decode_steps
    log(f"  run_queue: {len(done)} requests, {sum(len(r.out) for r in done)} tokens "
        f"in {wall:.3f} s (host clock, first call); launches {counts}")
    for n, r in zip(PROMPTS, done):
        if not r.done or len(r.out) != 16 or not all(0 <= t < cfg.vocab_size for t in r.out):
            raise AssertionError(f"{name} request of prompt {n}: done={r.done} out={r.out}")
    qmm = launch_key(*QMM_MODES[mode], swiglu=False)
    attn = ("prefill_attention", "flash_attention", "flash_attention_bhsd") if flash_decode \
        else ATTENTION
    want = [f"{k}.{v}" for k in ((qmm, "quant_matmul_swiglu") if swiglu else (qmm,))
            for v in ("decode", "prefill")] + list(attn)
    missing = [k for k in want if counts.get(k, 0) == 0]
    if missing:
        raise AssertionError(f"{name} path never launched {missing}")
    outs = [list(r.out) for r in done]
    if flash_decode:
        n_layers = cfg.n_layers
        log(f"  decode steps {steps[0]}: flash_attention_bhsd "
            f"{counts.get('flash_attention_bhsd', 0)} launches (want {n_layers} x {steps[0]}), "
            f"of them split-KV with a merge (flash_attention_bhsd.combine) "
            f"{counts.get('flash_attention_bhsd.combine', 0)}, decode_attention "
            f"{counts.get('decode_attention', 0)}")
        if counts.get("decode_attention", 0) != 0 or \
                counts.get("flash_attention_bhsd", 0) != n_layers * steps[0]:
            raise AssertionError("flash decode launch counts")
        same = sum(a == b for ra, rb in zip(outs, base["outs"]) for a, b in zip(ra, rb))
        log(f"  generated tokens equal to the default decode's: {same} of "
            f"{sum(len(r) for r in outs)} (greedy; argmax ties of near-equal logits may split)")

    # TTFT at prompt 128: prefill + first-token sampling, CUDA events
    prompt = reqs[2].prompt
    ttfts = []
    for _ in range(5):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        tok = eng.prefill_sample(0, prompt)
        b.record()
        b.synchronize()
        ttfts.append(a.elapsed_time(b))
    logits = eng.prefill(0, prompt)
    if not (np.isfinite(logits).all() and 0 <= tok < cfg.vocab_size):
        raise AssertionError("prefill logits not finite")
    # TTFT at prompt 1100 (bucket 2048: every projection at M = 2048)
    ttfts_long = []
    for _ in range(3):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        eng.prefill_sample(0, reqs[5].prompt)
        b.record()
        b.synchronize()
        ttfts_long.append(a.elapsed_time(b))
    # decode tokens/s at batch 4: all lanes active at position ~128
    first = {}
    for sid in range(4):
        first[sid] = eng.prefill_sample(sid, prompt)
    step_logits = eng.decode_step(first)
    if not all(np.isfinite(v).all() for v in step_logits.values()):
        raise AssertionError("decode logits not finite")
    if flash_decode:
        # the same step through the default decode_attention: the step's KV
        # rows are rewritten with the same values
        from csinn2_tpu_torch.utils.verify import cosine_similarity
        for sid in range(4):
            eng.slots[sid].pos -= 1
        with env_flag("CSINN2_DECODE_ATTN", False):
            default_logits = eng.decode_step(first)
        cos = min(cosine_similarity(step_logits[sid], default_logits[sid]) for sid in range(4))
        log(f"  one decode step at pos 128, batch 4: logits cosine (flash vs default decode) "
            f"min over lanes {cos:.6f} (gate 0.999)")
        if cos < 0.999:
            raise AssertionError(f"flash decode logits cosine {cos}")
    nxt = {sid: int(np.argmax(v)) for sid, v in step_logits.items()}
    n_steps, rates = 32, []
    reduces = reduce_launches()
    for _ in range(3):
        for sid in range(4):
            eng.slots[sid].pos = 129
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        eng.decode_steps(nxt, n_steps)
        b.record()
        b.synchronize()
        rates.append(4 * n_steps / (a.elapsed_time(b) / 1e3))
    reduce_per_step = (reduce_launches() - reduces) / (3 * n_steps)
    ttft = statistics.median(ttfts)
    tps = statistics.median(rates)
    log(f"  {name} TTFT prompt 128 (bucket 128): {ttft:.3f} ms (median of 5, CUDA events) "
        f"[{gpu_line}]")
    log(f"  {name} TTFT prompt {PROMPTS[5]} (bucket 2048): {statistics.median(ttfts_long):.3f} ms "
        f"(median of 3, CUDA events) [{gpu_line}]")
    log(f"  {name}{' flash decode' if flash_decode else ''} decode batch 4 at pos ~130: "
        f"{tps:.2f} tok/s, {4e3 / tps:.3f} ms/step (median of 3 x {n_steps} steps, CUDA "
        f"events, incl. host launch gaps) [{gpu_line}]"
        + (f"; default decode (phase 4) {base['tps']:.2f} tok/s" if flash_decode else ""))
    log(f"  {name} qmm_reduce launches per decode step: {reduce_per_step:g} (the libraries' "
        f"count over the 3 x {n_steps} steps)")
    del eng
    torch.cuda.empty_cache()
    return dict(counts=counts, outs=outs, tps=tps, steps=steps[0],
                reduce_per_step=reduce_per_step)


def serve_tiny():
    """LlamaConfig.tiny() (head dim 16, GQA 4/2; Q8_0, int8 KV) through the
    engine on the card, with CSINN2_DECODE_ATTN unset and =flash: two
    prompts prefilled and four greedy decode steps at batch 2, logits of
    each against the same engine on the CPU (cosine >= 0.999; the card fed
    the CPU's tokens).  Returns the launch counts of the card's runs."""
    import numpy as np
    import torch
    from csinn2_tpu_torch.kernels import launch_counts, reset_launch_counts
    from csinn2_tpu_torch.llm.config import LlamaConfig
    from csinn2_tpu_torch.llm.engine import InferenceEngine
    from csinn2_tpu_torch.llm.model import init_params
    from csinn2_tpu_torch.utils.verify import cosine_similarity
    cfg = LlamaConfig.tiny()
    counts = {}
    for flash in (False, True):
        with env_flag("CSINN2_DECODE_ATTN", flash, "flash"):
            cpu, gpu = (InferenceEngine(cfg, init_params(cfg, "q8_0", seed=5, device=dv),
                                        batch=2, quantized_kv=True, device=dv)
                        for dv in ("cpu", "cuda"))
            reset_launch_counts()
            cos, nxt = [], {}
            for sid, prompt in enumerate(([3, 7, 11, 19, 4], list(range(1, 40)))):
                want, got = cpu.prefill(sid, prompt), gpu.prefill(sid, prompt)
                cos.append(cosine_similarity(got, want) if np.isfinite(got).all() else 0.0)
                nxt[sid] = int(np.argmax(want))
            for _ in range(4):
                want, got = cpu.decode_step(nxt), gpu.decode_step(nxt)
                cos += [cosine_similarity(got[i], want[i]) if np.isfinite(got[i]).all()
                        else 0.0 for i in nxt]
                nxt = {i: int(np.argmax(want[i])) for i in nxt}
            torch.cuda.synchronize()
            run = dict(launch_counts)
        attn = "flash_attention_bhsd" if flash else "decode_attention"
        log(f"  LlamaConfig.tiny() (d=16, GQA 4/2) on the card{' flash decode' if flash else ''}: "
            f"2 prefills + 4 decode steps, min logit cosine vs the CPU engine {min(cos):.6f} "
            f"(gate 0.999); launches {run}")
        if min(cos) < 0.999 or run.get("prefill_attention", 0) == 0 or run.get(attn, 0) == 0:
            raise AssertionError(f"tiny engine on the card: cosine {min(cos)}, launches {run}")
        for k, n in run.items():
            counts[k] = counts.get(k, 0) + n
        del cpu, gpu
    return counts


# ---------------------------------------------------------------------------
# phase 7: the CNN path, MobileNetV1 INT8_SYM through the graph session
# ---------------------------------------------------------------------------

def _block_calls(sess, xin):
    """(node, op arguments, graph output) of each ds_block node of `sess` in
    one run on xin (that run's launches are not the main path's)."""
    import torch
    from csinn2_tpu_torch.graph.ir import _const_key
    acts = {}
    with torch.inference_mode():
        sess.graph.execute([xin], sess._consts,
                           trace_hook=lambda node, r: acts.__setitem__(id(node.outputs[0]), r))
    value = lambda t: acts[id(t)] if id(t) in acts else (
        xin if t is sess.graph.inputs[0] else sess._consts[_const_key(t)])
    return [(n, [value(t) for t in n.inputs], acts[id(n.outputs[0])])
            for n in sess.graph.nodes if n.op == "ds_block"]


def check_dsconv_blocks(records, sess, xin, fwd_ms, gpu_line):
    """Each of the 13 blocks at batch 128: the kernel against its plain
    version and the unfused pair (bit for bit), timed beside its bound."""
    import torch
    from csinn2_tpu_torch.kernels import dsblock as ds
    from csinn2_tpu_torch.utils.timing import gpu_ms
    worst, total, total_bound = None, 0.0, 0.0
    for i, (node, arrays, graph_out) in enumerate(_block_calls(sess, xin)):
        metas = [t.meta for t in node.inputs]
        args, kw = ds.fused_args(arrays, metas, node.params, node.out_qinfo, **node.extra)
        run = lambda: ds.fused_dsconv(*args, **kw)
        plain_fn = lambda: ds.fused_dsconv_ref(*args, **kw)
        pair_fn = lambda: ds.ds_block_xla(arrays, metas, node.params, node.out_qinfo,
                                          **node.extra)
        y = run()
        torch.cuda.synchronize()
        for name, other in (("graph output", graph_out), ("fused_dsconv_ref", plain_fn()),
                            ("unfused pair", pair_fn())):
            if not torch.equal(y, other):
                n_bad = int((y.int() - other.int()).ne(0).sum())
                raise AssertionError(f"fused_dsconv block {i}: {n_bad} of {y.numel()} "
                                     f"outputs differ from the {name}")
        ms = gpu_ms(run)
        plain = gpu_ms(plain_fn, reps=3)
        lib = gpu_ms(pair_fn, reps=5)
        x, dw_w, effd, bd, pw_w, effp, bp = args
        N, H, W, C = x.shape
        _, Ho, Wo, O = y.shape
        k = kw["k"]
        nbytes = x.numel() + dw_w.numel() + pw_w.numel() + 4 * (2 * C + 2 * O) + y.numel()
        b_ms, b_by = bound(nbytes, N * Ho * Wo * (k * k * C + 2 * C * O), INT8_OPS)
        shape = (f"block {i} N={N} H={H} W={W} C={C} O={O} k={k} s={kw['stride']} "
                 f"pads={kw['pads']} int8 out")
        log(f"  fused_dsconv {shape}: ms={ms:.4f} plain_ms={plain:.4f} "
            f"unfused_pair_ms={lib:.4f} bound_ms={b_ms:.4f} ({b_by}) roofline={b_ms / ms:.3f}")
        total += ms
        total_bound += b_ms
        if worst is None or ms > worst["ms"]:
            # no single PyTorch call computes the block: library_ms is null,
            # and the unfused pair stands beside it
            worst = dict(ms=ms, plain_ms=plain, library_ms=None, unfused_pair_ms=lib,
                         bound_ms=b_ms, bound_by=b_by, shape=shape, max_abs_err=0.0)
    records["fused_dsconv"] = dict(worst, blocks_ms=total, blocks_bound_ms=total_bound)
    log(f"  13 fused_dsconv launches: {total:.4f} ms against a summed bound of "
        f"{total_bound:.4f} ms ({total_bound / total:.3f}), of the {fwd_ms:.4f} ms fused "
        f"forward at batch {CNN_BATCH} ({100 * total / fwd_ms:.1f} %) [{gpu_line}]")


def cnn_path(records, gpu_line: str):
    """MobileNetV1 INT8_SYM at 224 through the graph session, fused and
    unfused.  Returns the launch counts of the fused batch-128 forward."""
    import numpy as np
    import torch
    from csinn2_tpu_torch.core.dtypes import QuantScheme
    from csinn2_tpu_torch.core.quant import dequantize
    from csinn2_tpu_torch.kernels import launch_counts, reset_launch_counts
    from csinn2_tpu_torch.models.mobilenet import MobileNetV1
    from csinn2_tpu_torch.utils.verify import cosine_similarity
    t0 = time.perf_counter()
    model = MobileNetV1(alpha=1.0, input_size=224, seed=0)
    rng = np.random.default_rng(0)                       # as bench.py:174-176
    x1 = rng.random(model.input_shape(1)).astype(np.float32)
    xb = rng.random(model.input_shape(CNN_BATCH)).astype(np.float32)
    model.calibrate(x1, device="cuda")
    sess = {}
    for fused in (True, False):
        with env_flag("CSINN2_FUSE_DS", fused), env_flag("CSINN2_NO_FUSE_DS", False):
            for batch in (CNN_BATCH, 1):
                s = model.build_session(QuantScheme.INT8_SYM, batch=batch, device="cuda")
                n_ds = sum(n.op == "ds_block" for n in s.graph.nodes)
                if n_ds != (13 if fused else 0):
                    raise AssertionError(f"fused={fused} batch {batch}: {n_ds} ds_block nodes")
                sess[fused, batch] = s
    xin = {b: model.prepare_input(x, sess[True, b]) for b, x in ((CNN_BATCH, xb), (1, x1))}
    torch.cuda.synchronize()
    log(f"  MobileNetV1 224 calibrated on the card and 4 INT8_SYM sessions built: "
        f"{time.perf_counter() - t0:.2f} s")

    reset_launch_counts()
    torch.cuda.synchronize()
    out = {(True, CNN_BATCH): sess[True, CNN_BATCH].run(xin[CNN_BATCH])}
    torch.cuda.synchronize()
    counts = dict(launch_counts)
    log(f"  fused forward, batch {CNN_BATCH}: launches {counts}")
    if counts.get("fused_dsconv", 0) != 13:
        raise AssertionError(f"fused forward launched fused_dsconv "
                             f"{counts.get('fused_dsconv', 0)} times, want 13")
    for key in ((False, CNN_BATCH), (True, 1), (False, 1)):
        before = launch_counts["fused_dsconv"]
        out[key] = sess[key].run(xin[key[1]])
        torch.cuda.synchronize()
        if launch_counts["fused_dsconv"] - before != (13 if key[0] else 0):
            raise AssertionError(f"session {key}: fused_dsconv launches")
    for b in (CNN_BATCH, 1):
        f, u = out[True, b], out[False, b]
        if f.dtype != torch.int8 or tuple(f.shape) != (b, 1000) or not torch.equal(f, u):
            raise AssertionError(f"batch {b}: fused logits differ from unfused in "
                                 f"{int(f.int().ne(u.int()).sum())} of {u.numel()}")
    log(f"  fused int8 logits == unfused, bit for bit, at batch {CNN_BATCH} and 1")

    with env_flag("CSINN2_FUSE_DS", True):
        s_cpu = model.build_session(QuantScheme.INT8_SYM, batch=1, device="cpu")
    cpu = s_cpu.run(model.prepare_input(x1, s_cpu)).numpy().astype(int)
    d = np.abs(cpu - out[True, 1].cpu().numpy().astype(int))
    log(f"  batch 1, card vs the port's CPU plain path (same recorder): max|d|={d.max()} "
        f"LSB, {int((d > 0).sum())} of {d.size} logits differ (fc float-carrier sums)")
    if d.max() > 1:
        raise AssertionError(f"card vs CPU plain path: {d.max()} LSB")
    golden = model.forward_f32(x1, device="cuda").cpu().numpy()
    qi = sess[True, 1].graph.outputs[0].meta.qinfo
    deq = dequantize(out[True, 1].cpu(), qi).numpy()
    cos = cosine_similarity(deq, golden)
    log(f"  cosine(int8 fused batch 1 dequantized, forward_f32) = {cos:.6f} (gate 0.99)")
    if not (np.isfinite(golden).all() and cos >= 0.99):
        raise AssertionError(f"accuracy gate: cosine {cos}")

    times = {}
    for fused in (True, False, False, True):
        for b, iters in ((CNN_BATCH, 10), (1, 50)):
            t = sess[fused, b].run_benchmark_device(xin[b], iters=iters, reps=3)
            times.setdefault((fused, b), []).append(t)
    for fused in (True, False):
        t128 = statistics.median(times[fused, CNN_BATCH])
        t1 = statistics.median(times[fused, 1])
        log(f"  {'fused  ' if fused else 'unfused'}: batch {CNN_BATCH} {CNN_BATCH / t128:.1f} "
            f"img/s ({t128 * 1e3:.3f} ms/forward), batch 1 latency {t1 * 1e3:.3f} ms "
            f"(CUDA events, median of 2x3 x {{10, 50}} runs, host gaps included) [{gpu_line}]")
    # the phase's launches since the main path's reset, before the per-block
    # comparisons (13 a fused forward)
    phase = launch_counts["fused_dsconv"]
    log(f"  fused_dsconv launches over the phase's sessions and timings: {phase} "
        f"({phase // 13} fused forwards of 13)")
    check_dsconv_blocks(records, sess[True, CNN_BATCH], xin[CNN_BATCH],
                        statistics.median(times[True, CNN_BATCH]) * 1e3, gpu_line)
    records["fused_dsconv"]["launches_phase"] = phase
    del sess, out
    torch.cuda.empty_cache()
    return counts


# ---------------------------------------------------------------------------
# phase 10: the probe path, the Q4_0 dequant-strategy probes
# ---------------------------------------------------------------------------

def check_probe_kernels(records, results, gpu_line):
    """Each probe kernel against its plain version on the card at the four
    shapes (the probe's inputs), timed beside the plain version (warm) and
    torch.matmul on the dequantized bf16 [K, N] weight (cold), with its
    factor over cur(quant_matmul) and over torch.matmul (the probe's cold
    times); the record of each is the w13 shape, with the probe's cold
    kernel time."""
    import numpy as np
    import torch
    from csinn2_tpu_torch.examples import int4_dequant_probe as probe
    from csinn2_tpu_torch.kernels import int4_probe as ip
    from csinn2_tpu_torch.kernels.qmatmul import unpack_int4
    from csinn2_tpu_torch.utils.timing import cold_copies, gpu_ms, gpu_ms_cold, l2_bytes
    M = 8
    rng = np.random.default_rng(0)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    us = {(r["name"], r["K"], r["N"]): r["us"] for r in results}
    for label, (K, N, bn, bk) in zip(probe.SHAPE_NAMES, probe.ALL_SHAPES):
        case = probe.make_case(rng, M, K, N, "cuda")
        x, w = case["x"], case["weights"]
        deq = (unpack_int4(w["wp"], K).float().reshape(K // 32, 32, N)
               * w["s"][:, None]).reshape(K, N).to(torch.bfloat16)
        libs = [deq] + [deq.clone() for _ in range(cold_copies(deq.numel() * 2, l2_bytes()) - 1)]
        lib = gpu_ms_cold([lambda d=d: torch.matmul(x, d) for d in libs])
        del libs, deq
        for kind, (_, variant) in PROBE_KERNELS.items():
            spec = probe.variant_table(M, K, N, bn, bk)[variant]
            call = ip.prepare(kind, x, w[spec[1]], w[spec[2]], M, bn, bk)
            y = call.kernel()
            torch.cuda.synchronize()
            ref = ip.kernel_ref(kind, call.tensors, M, N, K, bn, bk)
            err = float((y - ref).abs().max())
            if kind == "stream" and not torch.equal(y, ref):
                raise AssertionError(f"int4_probe stream {label}: not bit for bit ({err})")
            if err > 1e-5 * float(ref.abs().max()):
                raise AssertionError(f"int4_probe {kind} {label}: max|d| {err} against "
                                     f"max|y| {float(ref.abs().max())}")
            plain = gpu_ms(lambda: ip.kernel_ref(kind, call.tensors, M, N, K, bn, bk), reps=3)
            ms, cur = us[variant, K, N] * 1e-3, us[probe.CUR, K, N] * 1e-3
            b_ms, b_by = bound(ip.kernel_bytes(kind, M, N, K), 2.0 * M * N * K,
                               INT8_OPS if kind in ("intdot", "w4a8") else BF16_FLOPS)
            cols, ksplit = ip.plane_geometry(M, N, K, n_sm)
            shape = (f"{label} M={M} K={K} N={N} (bn {bn} bk {bk}: {cols} columns per CTA, "
                     f"{ksplit}-row splits), cold L2")
            log(f"  int4_probe_{kind} {shape}: ms={ms:.4f} plain_ms={plain:.4f} lib_ms={lib:.4f} "
                f"bound_ms={b_ms:.4f} ({b_by}) roofline={b_ms / ms:.3f} max_abs_err={err:.3e} "
                f"cur_ms={cur:.4f} x_cur={ms / cur:.2f} x_lib={ms / lib:.2f}")
            rec = records.setdefault(f"int4_probe_{kind}", {"max_abs_err": 0.0})
            rec["max_abs_err"] = max(rec["max_abs_err"], err)
            if label == "w13":
                rec.update(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=b_ms, bound_by=b_by,
                           shape=shape, cur_ms=cur)
            del call, y, ref
        del case, x, w
        torch.cuda.empty_cache()
    log(f"  every probe kernel agrees with its plain version at the four shapes [{gpu_line}]")


def probe_path(records, gpu_line):
    """Phase 10: the port's probe at the four 7B decode shapes (its launch
    counts are this path's), then each kernel against its plain version,
    then the tile tuner's sweep.  Returns the probe run's launch counts."""
    import torch
    from csinn2_tpu_torch.examples import int4_dequant_probe as probe
    from csinn2_tpu_torch.examples import int4_tile_tune as tuner
    from csinn2_tpu_torch.kernels import launch_counts, reset_launch_counts
    torch.cuda.synchronize()
    reset_launch_counts()
    results = probe.probe(device="cuda", M=8, log=log)
    torch.cuda.synchronize()
    counts = dict(launch_counts)
    log(f"  probe launches: {counts}")
    missing = [k for k in PROBE_KERNELS if counts.get(f"int4_probe_{k}", 0) == 0]
    if missing or counts.get("quant_matmul_q4_0.decode", 0) == 0:
        raise AssertionError(f"phase 10 never launched {missing} (or quant_matmul_q4_0)")
    over = [(r["name"], r["K"], r["N"], r["bound_us"] / r["us"]) for r in results
            if r["bound_us"] / r["us"] > 1.05]
    if over:
        raise AssertionError(f"phase 10 rows above 105 % of their bytes bound: {over}")
    low = [(r["name"], r["K"], r["N"], r["cos"]) for r in results
           if r["kind"] not in ("stream", "noscale", "halfq8") and r["cos"] < 0.99]
    if low:
        raise AssertionError(f"phase 10 variants off the golden: {low}")
    check_probe_kernels(records, results, gpu_line)
    tuner.tune(device="cuda", log=log)
    torch.cuda.empty_cache()
    return counts


def main() -> int:
    here = Path(__file__).resolve().parent
    if not (here / "csinn2_tpu_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke: the csinn2_tpu_torch package is not beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(here))
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    from csinn2_tpu_torch.kernels import _build

    t_start = time.perf_counter()
    gpu_line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]
    log(f"phase 1: card [{gpu_line}] torch {torch.__version__} CUDA {torch.version.cuda} "
        f"devices {torch.cuda.device_count()}")
    _build.libs()
    log(f"  kernels built and loaded in {_build.build_seconds:.2f} s")
    for name, text in _build.build_logs().items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")

    records = {}
    log("phase 2: kernels against their plain versions at 7B shapes")
    check_gemm_plan()
    check_quant_matmul(records)
    check_attention(records)
    check_new_quant_matmul(records)
    check_int8dot_cold(records)
    check_flash_bhsd(records)
    check_attention_dims(records)
    # kernel name → (launch counts of the run whose path it is on, the run)
    path_counts = {"attention_wide": (check_attention_wide(records),
                                      f"phase 2 (the four entry points at d = {WIDE_DS}, "
                                      "MLA's decode)")}
    torch.cuda.empty_cache()
    api_counts = kernel_api_path()
    for k in ("quant_matmul_none", "quant_matmul_int8dot", "quant_matmul_requant"):
        path_counts[k] = (api_counts, "phase 2 (kernel API: no package caller)")
    log("phase 3: model parity (card vs cpu plain path)")
    for mode, swiglu in (("q8_0", False), ("q4_0", False), ("int8", False), ("int4", False),
                         ("q4_0", True)):
        model_parity(mode, swiglu)
        torch.cuda.empty_cache()
    # kernel name → qmm_reduce launches per decode step of its serving run
    reduce_per_step = {}
    log("phase 4: the first slice's main path, Llama-2-7B Q8_0 int8 KV, run_queue batch 4")
    q8_0 = serve(gpu_line, "q8_0")
    for k in ("quant_matmul",) + ATTENTION:
        path_counts[k] = (q8_0["counts"], "phase 4 (Q8_0)")
    reduce_per_step["quant_matmul"] = q8_0["reduce_per_step"]
    serve_tiny()
    log("phase 5: this slice's main path, Llama-2-7B Q4_0 int8 KV, run_queue batch 4")
    for key, mode, swiglu, path in (
            ("quant_matmul_q4_0", "q4_0", False, "phase 5 (Q4_0)"),
            ("quant_matmul_channel", "int8", False, "phase 6 (INT8_CHANNEL)"),
            ("quant_matmul_int4_channel", "int4", False, "phase 6 (INT4_CHANNEL)"),
            ("quant_matmul_swiglu", "q4_0", True, "phase 6 (Q4_0, CSINN2_SWIGLU_FUSE=1)")):
        if key == "quant_matmul_channel":
            log("phase 6: the other weight modes' paths, Llama-2-7B int8 KV, run_queue batch 4")
        run = serve(gpu_line, mode, swiglu=swiglu)
        path_counts[key] = (run["counts"], path)
        reduce_per_step[key] = run["reduce_per_step"]
    log("phase 7: the CNN path, MobileNetV1 INT8_SYM 224, graph session, CSINN2_FUSE_DS=1")
    path_counts["fused_dsconv"] = (cnn_path(records, gpu_line),
                                   f"phase 7 (MobileNetV1 INT8_SYM, fused, batch {CNN_BATCH})")
    log("phase 8: the op API's CUDA tier at Llama-2-7B width (block fc, SDPA), "
        "GRAPH session and layer mode")
    path_counts["quant_matmul_t"] = (op_api_path(records, gpu_line),
                                     "phase 8 (op API, Q8_0/Q4_0 block fullyconnected)")
    log("phase 9: flash decode, Llama-2-7B Q8_0 int8 KV, run_queue batch 4, "
        "CSINN2_DECODE_ATTN=flash")
    flash = serve(gpu_line, "q8_0", flash_decode=True, base=q8_0)
    path_counts["flash_attention_bhsd"] = (flash["counts"],
                                           "phase 9 (Q8_0 run_queue, CSINN2_DECODE_ATTN=flash)")
    log("phase 10: the probe path, the Q4_0 dequant-strategy probes at the 7B decode shapes")
    probe_counts = probe_path(records, gpu_line)
    for kind in PROBE_KERNELS:
        path_counts[f"int4_probe_{kind}"] = (probe_counts, "phase 10 (int4_dequant_probe, M=8)")
    log(f"total {time.perf_counter() - t_start:.1f} s")

    kernels = []
    for name, (source, replaces) in KERNELS.items():
        counts, path = path_counts[name]
        r = records[name]
        entry = {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                 "launches": launches(counts, name), "path": path,
                 "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
                 "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                 "library_ms": r["library_ms"], "shape": r["shape"]}
        for extra in ("unfused_pair_ms", "ms_cold", "library_ms_cold", "prefill",
                      "decode_cold", "cur_ms", "library_layout", "blocks_ms",
                      "blocks_bound_ms", "launches_phase", "decode", "flash_d576",
                      "decode_d576", "launches_combine"):
            if extra in r:
                entry[extra] = r[extra]
        if name in reduce_per_step:
            entry["qmm_reduce_per_decode_step"] = reduce_per_step[name]
        if name.startswith("quant_matmul"):
            entry.update(launches_decode=int(counts.get(f"{name}.decode", 0)),
                         launches_prefill=int(counts.get(f"{name}.prefill", 0)))
        if name in ATTENTION + ("flash_attention_bhsd",):
            # the split-KV merges of the same source, within `launches`
            entry["launches_combine"] = int(counts.get(f"{name}.combine", 0))
        kernels.append(entry)
    print(gpu_line)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
