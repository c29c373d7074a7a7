#!/usr/bin/env python3
"""Smoke run of csinn2_tpu_torch, the PyTorch/CUDA port, on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and continued):
  1. the card (nvidia-smi name and power limit), torch/CUDA versions, and the
     build of every CUDA kernel from csinn2_tpu_torch/kernels/csrc/;
  2. each kernel held against its plain PyTorch version on the card at
     Llama-2-7B shapes, timed (median GPU time of back-to-back calls queued
     behind a sleep kernel, CUDA events) beside the plain version and one
     library call (a yardstick only): quant_matmul in every weight mode
     (Q8_0, Q4_0, INT8_CHANNEL, INT4_CHANNEL, and the swiglu epilogue on a
     Q8_0 and a Q4_0 w13 in the swiglu128 layout), and the attention kernels;
  3. model parity: a 2-layer model at full 7B width (int8 KV) over a
     128-token prompt, logits on the card against the same model through the
     port's plain path on the CPU (cosine >= 0.999), for Q8_0, Q4_0,
     INT8_CHANNEL, INT4_CHANNEL and Q4_0 with CSINN2_SWIGLU_FUSE=1;
  4. the first slice's main path: Llama-2-7B geometry (32 layers), Q8_0
     weights made on the card from a seed, int8 KV,
     InferenceEngine(batch=4).run_queue over six greedy requests (prompts
     5..1100 tokens, 16 new tokens each), with the kernel launch counts of
     that run; then TTFT at prompt 128 and decode tokens/s at batch 4 (CUDA
     events);
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
     batch-1 latency, fused and unfused (CUDA events); each of the 13 block
     shapes of fused_dsconv against fused_dsconv_ref (bit for bit), timed
     beside its bound, the plain version and the unfused pair.
Each serving run zeroes the launch counts just before run_queue and reads
them just after.  No phase uses torch.profiler: once it has traced,
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
}
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


def _check_qmm_case(records, key, label, g, mode, K, N, odt, swiglu=False, record_m=4):
    import torch
    from csinn2_tpu_torch.kernels.qmatmul import quant_matmul, quant_matmul_ref
    from csinn2_tpu_torch.utils.timing import gpu_ms
    from csinn2_tpu_torch.utils.verify import cosine_similarity
    scale_mode, packed = QMM_MODES[mode]
    kw = dict(scale_mode=scale_mode, packed_int4=packed, swiglu=swiglu, out_dtype=odt)
    w, s, w_deq = _qmm_weights(g, mode, K, N)
    worst = records.get(key, {}).get("max_abs_err", 0.0)
    for M in (1, 4, 128):
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
        log(f"  {key} {label:7s} M={M:4d} K={K:5d} N={N:5d} ms={ms:.4f} plain_ms={plain:.4f} "
            f"lib_ms={lib:.4f} bound_ms={b_ms:.4f} ({b_by}) roofline={b_ms / ms:.3f} "
            f"cos={cos:.6f} max_abs_err={err:.3e}")
        if M == record_m:
            records.setdefault(key, {}).update(
                ms=ms, plain_ms=plain, library_ms=lib, bound_ms=b_ms, bound_by=b_by,
                shape=f"{label} M={M} K={K} N={N} {'bf16' if osz == 2 else 'f32'} out")
    records.setdefault(key, {})["max_abs_err"] = worst
    del w, s, w_deq


def check_quant_matmul(records):
    """Every weight mode at the 7B shapes (M = 1, 4, 128); the record of each
    mode is the batch-4 decode FFN GEMM, w13 at M = 4."""
    import torch
    from csinn2_tpu_torch.kernels.qmatmul import launch_key
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    shapes = [("wqkv", 4096, 12288, torch.bfloat16), ("w13", 4096, 22016, torch.bfloat16),
              ("w2", 11008, 4096, torch.bfloat16), ("lm_head", 4096, 32000, torch.float32)]
    for mode, (scale_mode, packed) in QMM_MODES.items():
        key = launch_key(scale_mode, packed, swiglu=False)
        for label, K, N, odt in shapes:
            _check_qmm_case(records, key, label, g, mode, K, N, odt,
                            record_m=4 if label == "w13" else None)
    # the swiglu epilogue on a w13 in the swiglu128 layout (F 11008 padded to
    # 11264): N = 22528 → out [M, 11264]; recorded for Q4_0
    for mode in ("q8_0", "q4_0"):
        _check_qmm_case(records, "quant_matmul_swiglu", f"w13sw-{mode}", g, mode, 4096, 22528,
                        torch.bfloat16, swiglu=True, record_m=4 if mode == "q4_0" else None)


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
            records["decode_attention"] = dict(ms=ms, plain_ms=plain, library_ms=lib,
                                               bound_ms=b_ms, bound_by=b_by,
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
def env_flag(name: str, on: bool):
    """Environment variable `name` set to 1 (or unset) inside the block."""
    old = os.environ.pop(name, None)
    if on:
        os.environ[name] = "1"
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

def serve(gpu_line: str, mode: str, swiglu: bool = False):
    """Llama-2-7B (32 layers), `mode` weights made on the card, int8 KV:
    run_queue over the six prompts, then TTFT at prompt 128 and decode
    tokens/s at batch 4.  Returns the launch counts of the run_queue."""
    import numpy as np
    import torch
    from csinn2_tpu_torch.kernels import launch_counts, reset_launch_counts
    from csinn2_tpu_torch.kernels.qmatmul import launch_key
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

    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = eng.run_queue(reqs, chunk=16)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(launch_counts)
    log(f"  run_queue: {len(done)} requests, {sum(len(r.out) for r in done)} tokens "
        f"in {wall:.3f} s (host clock, first call); launches {counts}")
    for n, r in zip(PROMPTS, done):
        if not r.done or len(r.out) != 16 or not all(0 <= t < cfg.vocab_size for t in r.out):
            raise AssertionError(f"{name} request of prompt {n}: done={r.done} out={r.out}")
    qmm = launch_key(*QMM_MODES[mode], swiglu=False)
    want = [f"{k}.{v}" for k in ((qmm, "quant_matmul_swiglu") if swiglu else (qmm,))
            for v in ("decode", "prefill")] + list(ATTENTION)
    missing = [k for k in want if counts.get(k, 0) == 0]
    if missing:
        raise AssertionError(f"{name} path never launched {missing}")

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
    # decode tokens/s at batch 4: all lanes active at position ~128
    first = {}
    for sid in range(4):
        first[sid] = eng.prefill_sample(sid, prompt)
    step_logits = eng.decode_step(first)
    if not all(np.isfinite(v).all() for v in step_logits.values()):
        raise AssertionError("decode logits not finite")
    nxt = {sid: int(np.argmax(v)) for sid, v in step_logits.items()}
    n_steps, rates = 32, []
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
    ttft = statistics.median(ttfts)
    tps = statistics.median(rates)
    log(f"  {name} TTFT prompt 128 (bucket 128): {ttft:.3f} ms (median of 5, CUDA events) "
        f"[{gpu_line}]")
    log(f"  {name} decode batch 4 at pos ~130: {tps:.2f} tok/s, {4e3 / tps:.3f} ms/step "
        f"(median of 3 x {n_steps} steps, CUDA events, incl. host launch gaps) [{gpu_line}]")
    del eng
    torch.cuda.empty_cache()
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
    worst, total = None, 0.0
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
        if worst is None or ms > worst["ms"]:
            # no single PyTorch call computes the block: library_ms is null,
            # and the unfused pair stands beside it
            worst = dict(ms=ms, plain_ms=plain, library_ms=None, unfused_pair_ms=lib,
                         bound_ms=b_ms, bound_by=b_by, shape=shape, max_abs_err=0.0)
    records["fused_dsconv"] = worst
    log(f"  13 fused_dsconv launches: {total:.4f} ms of the {fwd_ms:.4f} ms fused "
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
    check_dsconv_blocks(records, sess[True, CNN_BATCH], xin[CNN_BATCH],
                        statistics.median(times[True, CNN_BATCH]) * 1e3, gpu_line)
    del sess, out
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
    check_quant_matmul(records)
    check_attention(records)
    torch.cuda.empty_cache()
    log("phase 3: model parity (card vs cpu plain path)")
    for mode, swiglu in (("q8_0", False), ("q4_0", False), ("int8", False), ("int4", False),
                         ("q4_0", True)):
        model_parity(mode, swiglu)
        torch.cuda.empty_cache()
    # kernel name → (launch counts of the serving run whose path it is on, the run)
    path_counts = {}
    log("phase 4: the first slice's main path, Llama-2-7B Q8_0 int8 KV, run_queue batch 4")
    counts = serve(gpu_line, "q8_0")
    for k in ("quant_matmul",) + ATTENTION:
        path_counts[k] = (counts, "phase 4 (Q8_0)")
    log("phase 5: this slice's main path, Llama-2-7B Q4_0 int8 KV, run_queue batch 4")
    path_counts["quant_matmul_q4_0"] = (serve(gpu_line, "q4_0"), "phase 5 (Q4_0)")
    log("phase 6: the other weight modes' paths, Llama-2-7B int8 KV, run_queue batch 4")
    path_counts["quant_matmul_channel"] = (serve(gpu_line, "int8"), "phase 6 (INT8_CHANNEL)")
    path_counts["quant_matmul_int4_channel"] = (serve(gpu_line, "int4"),
                                                "phase 6 (INT4_CHANNEL)")
    path_counts["quant_matmul_swiglu"] = (serve(gpu_line, "q4_0", swiglu=True),
                                          "phase 6 (Q4_0, CSINN2_SWIGLU_FUSE=1)")
    log("phase 7: the CNN path, MobileNetV1 INT8_SYM 224, graph session, CSINN2_FUSE_DS=1")
    path_counts["fused_dsconv"] = (cnn_path(records, gpu_line),
                                   f"phase 7 (MobileNetV1 INT8_SYM, fused, batch {CNN_BATCH})")
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
        if "unfused_pair_ms" in r:
            entry["unfused_pair_ms"] = r["unfused_pair_ms"]
        if name.startswith("quant_matmul"):
            entry.update(launches_decode=int(counts.get(f"{name}.decode", 0)),
                         launches_prefill=int(counts.get(f"{name}.prefill", 0)))
        kernels.append(entry)
    print(gpu_line)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
