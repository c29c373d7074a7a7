#!/usr/bin/env python3
"""Llama-2-7B weight-only-quantized inference benchmark on one card —
counterpart of examples/llama7b_bench.py (BASELINE.md config 4: Llama-2-7B
weight-only INT8/INT4 with a quantized KV cache, one host).

    python3 csinn2_tpu_torch/examples/llama7b_bench.py [--mode q8_0] [--layers 32]

Random weights are made and quantized on the device from seed 0
(init_params_device), so the 7B init takes seconds; the quantized pipeline's
correctness is gated at small widths elsewhere (tests/test_torch_llm.py,
llama_generate.py).

Reports: the TTFT of a --prompt-token prompt (host clock around a prefill and
its first token, best of 3), decode tokens/s at batch 1 through the engine's
decode loop (benchmark_decode_device: the captured step graph on the card,
long-minus-short of CUDA events), the weight footprint, and the share of the
weight-read bound: decode is bound by memory bandwidth, each token reads
every weight byte once (of the embedding table its own row only), so
tok/s <= bandwidth / those bytes.  --hbm-gbps is
that bandwidth in 1e9 bytes/s, by default the H100 SXM's 3350 (NVIDIA's data
sheet; the same constant as chip_smoke.py).  Every time carries the card's
nvidia-smi name and power limit.  Runs on the card (--device cuda, the
default) or, when asked, on the CPU with the kernels' plain versions.
"""

import argparse
import dataclasses
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import torch  # noqa: E402

from csinn2_tpu_torch.llm.config import LlamaConfig  # noqa: E402
from csinn2_tpu_torch.llm.engine import InferenceEngine  # noqa: E402
from csinn2_tpu_torch.llm.model import _qweights, init_params_device  # noqa: E402
from csinn2_tpu_torch.utils.device import gpu_line, resolve_device  # noqa: E402


def _tensors(params):
    """Every tensor of a params dict, the QWeights' values and scales too."""
    for qw in _qweights(params):
        yield qw.values
        if qw.scales is not None:
            yield qw.scales
    yield params["tok_embedding"]
    yield params["norm"]
    for lp in params["layers"]:
        yield lp["attn_norm"]
        yield lp["ffn_norm"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", default="q8_0", choices=["int8", "int4", "q8_0", "q4_0"])
    ap.add_argument("--layers", type=int, default=32)
    ap.add_argument("--prompt", type=int, default=128)
    ap.add_argument("--tokens", type=int, default=128)
    ap.add_argument("--hbm-gbps", type=float, default=3350.0,
                    help="memory bandwidth for the roofline, 1e9 bytes/s (H100 SXM: 3350)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    where = f"[{gpu_line()}]" if dev.type == "cuda" else "[cpu, plain versions]"

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    cfg = dataclasses.replace(LlamaConfig.llama2_7b(), n_layers=args.layers)
    print(f"== Llama2-7B (L={cfg.n_layers}) mode={args.mode} quant-KV on {dev.type} "
          f"{where} ==", flush=True)

    t0 = time.perf_counter()
    params = init_params_device(cfg, mode=args.mode, seed=0, device=dev)
    sync()
    print(f"device init+quant: {time.perf_counter() - t0:.1f}s {where}", flush=True)

    tensors = list(_tensors(params))
    wbytes = sum(t.numel() for t in tensors if t.dtype == torch.int8)
    sbytes = sum(t.numel() * t.element_size() for t in tensors) - wbytes
    print(f"weights: {wbytes / 2**30:.2f} GiB int8 carriers "
          f"+ {sbytes / 2**30:.2f} GiB scales/embeddings", flush=True)

    eng = InferenceEngine(cfg, params, batch=1, quantized_kv=True, device=dev)
    prompt = [int(t) for t in np.random.default_rng(0).integers(1, cfg.vocab_size,
                                                                  args.prompt)]

    # prefill TTFT
    t0 = time.perf_counter()
    eng.generate(prompt, max_new_tokens=1)
    print(f"prefill+1 (incl first calls): {time.perf_counter() - t0:.1f}s {where}",
          flush=True)
    ttfts = []
    for _ in range(3):
        t0 = time.perf_counter()
        eng.generate(prompt, max_new_tokens=1)
        ttfts.append(time.perf_counter() - t0)
    ttft = min(ttfts)
    print(f"p50 TTFT (prompt {args.prompt}): {ttft * 1e3:.1f} ms {where}", flush=True)

    # the decode loop, device-marginal timing (the step graph on the card;
    # long-minus-short cancels the capture, set-up and the tokens' fetch)
    t0 = time.perf_counter()
    tps = eng.benchmark_decode_device(iters=args.tokens)
    print(f"fused decode bench (incl capture): {time.perf_counter() - t0:.1f}s {where}",
          flush=True)
    emb = params["tok_embedding"]
    read = wbytes + sbytes - emb.numel() * emb.element_size() \
        + emb.shape[-1] * emb.element_size()      # bytes a token reads: one embedding row
    sol = args.hbm_gbps * 1e9 / read                # tok/s if pure weight-read
    print(f"decode: {tps:.1f} tokens/s  (roofline ≈{sol:.0f} tok/s → "
          f"{100 * tps / sol:.0f}% of weight-read speed-of-light) {where}", flush=True)
    ok = bool(np.isfinite(tps) and tps > 0)
    print("PASS" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
