#!/usr/bin/env python3
"""LLM engine demo — counterpart of examples/llama_generate.py: build a
random-weight Llama, quantize its weights, generate tokens, report decode
tokens/s and the quantized-vs-float logit cosine.

    python3 csinn2_tpu_torch/examples/llama_generate.py [--mode q8_0] [--layers 2] [--dim 256]
    python3 csinn2_tpu_torch/examples/llama_generate.py --device cpu
    python3 csinn2_tpu_torch/examples/llama_generate.py --ckpt MODEL_DIR [--quant-kv]

Runs on the card (--device cuda, the default; it raises without one) or,
when asked, on the CPU with the kernels' plain versions.  The weights are
made and quantized on the device from seed 0 (init_params_device), the same
draws for the float and the quantized model.  Decode tokens/s come twice:
host-stepped (benchmark_decode, one eager step a token) and through the
engine's decode loop (benchmark_decode_device: the captured step graph on
the card, long-minus-short of CUDA events).  On the card every time carries
the card's nvidia-smi name and power limit.  The gate: logit cosine >= 0.95
against the float model (PASS / FAIL, exit code 1 on FAIL).

--ckpt MODEL_DIR serves a converted model directory (python -m
csinn2_tpu_torch convert, or the JAX package's converter): load_llm onto the
device, its tokenizer, generate_fused from --prompt, the decoded text, and
benchmark_decode_device; PASS when the tokens lie in the vocabulary and
the prompt's logits are finite.
"""

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from csinn2_tpu_torch.llm.config import LlamaConfig  # noqa: E402
from csinn2_tpu_torch.llm.engine import InferenceEngine  # noqa: E402
from csinn2_tpu_torch.llm.model import FLOAT, init_params_device  # noqa: E402
from csinn2_tpu_torch.utils.device import gpu_line, resolve_device  # noqa: E402
from csinn2_tpu_torch.utils.verify import cosine_similarity  # noqa: E402


def run_checkpoint(args, dev, where: str) -> int:
    """Real-weights generation: CTBM model dir + its tokenizer."""
    import numpy as np
    from csinn2_tpu_torch.llm.json_io import load_llm
    from csinn2_tpu_torch.llm.tokenizer import load_tokenizer

    t0 = time.perf_counter()
    cfg, params = load_llm(args.ckpt, device=dev)
    tok = load_tokenizer(args.ckpt)
    print(f"== {args.ckpt}: dim={cfg.dim} L={cfg.n_layers} V={cfg.vocab_size} "
          f"on {dev.type} {where} (load {time.perf_counter() - t0:.2f}s, host clock) ==")
    eng = InferenceEngine(cfg, params, batch=1, quantized_kv=args.quant_kv, device=dev)
    ids = tok.encode(args.prompt, bos=True)
    print(f"prompt -> {len(ids)} tokens")
    logits = eng.prefill(0, ids)
    t0 = time.perf_counter()
    out = eng.generate_fused(ids, max_new_tokens=args.tokens,
                             temperature=args.temperature)
    dt = time.perf_counter() - t0
    print(tok.decode(list(ids) + [int(t) for t in out]))
    print(f"[{args.tokens} tokens in {dt:.2f}s incl. first calls] {where}")
    tps = eng.benchmark_decode_device(iters=64)
    print(f"decode throughput (device loop): {tps:.1f} tokens/s {where}")
    ok = (len(out) == args.tokens and all(0 <= int(t) < cfg.vocab_size for t in out)
          and bool(np.isfinite(logits).all()))
    print("PASS" if ok else "FAIL")
    return 0 if ok else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", default="q8_0",
                    choices=["float", "int8", "int4", "q8_0", "q4_0"])
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--dim", type=int, default=256)
    ap.add_argument("--heads", type=int, default=4)
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--quant-kv", action="store_true")
    ap.add_argument("--ckpt", default=None,
                    help="converted model dir (python -m csinn2_tpu_torch convert)")
    ap.add_argument("--prompt", default="Once upon a time")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    where = f"[{gpu_line()}]" if dev.type == "cuda" else "[cpu, plain versions]"
    if args.ckpt:
        return run_checkpoint(args, dev, where)
    cfg = LlamaConfig(dim=args.dim, n_layers=args.layers, n_heads=args.heads,
                      n_kv_heads=args.heads, ffn_dim=args.dim * 4,
                      vocab_size=1024, max_seq_len=256)
    print(f"== Llama dim={cfg.dim} L={cfg.n_layers} mode={args.mode} on {dev.type} {where} ==")

    t0 = time.perf_counter()
    params = init_params_device(cfg, mode=args.mode, seed=0, device=dev)
    print(f"params init+quant (on device): {time.perf_counter() - t0:.2f}s")

    eng = InferenceEngine(cfg, params, batch=1, quantized_kv=args.quant_kv, device=dev)
    prompt = [1, 5, 9, 13, 21]

    t0 = time.perf_counter()
    out = eng.generate_fused(prompt, max_new_tokens=args.tokens,
                             temperature=args.temperature)
    print(f"generate {args.tokens} tokens (incl. first calls): "
          f"{time.perf_counter() - t0:.2f}s {where}")
    print(f"tokens: {out}")

    tps = eng.benchmark_decode(iters=10, warmup=2)
    print(f"decode throughput (per-step dispatch): {tps:.1f} tokens/s {where}")

    # the decode loop (the step graph on the card), long-minus-short marginal
    tps = eng.benchmark_decode_device(iters=64)
    loop = "step graph" if dev.type == "cuda" else "eager loop"
    print(f"decode throughput ({loop}, device loop): {tps:.1f} tokens/s {where}")

    if args.mode != FLOAT:
        feng = InferenceEngine(cfg, init_params_device(cfg, mode=FLOAT, seed=0, device=dev),
                               batch=1, device=dev)
        cs = cosine_similarity(eng.prefill(0, prompt), feng.prefill(0, prompt))
        print(f"logit cosine ({args.mode} vs float): {cs:.5f}")
        ok = cs >= 0.95
        print("PASS" if ok else "FAIL")
        return 0 if ok else 1
    print("PASS")
    return 0


if __name__ == "__main__":
    sys.exit(main())
