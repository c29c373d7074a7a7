#!/usr/bin/env python3
"""Dense no-drop against capacity-routed MoE dispatch at inference token
counts — counterpart of examples/moe_dispatch_probe.py.

    python3 csinn2_tpu_torch/examples/moe_dispatch_probe.py [--mode float] [--tokens 8,32,128,512]

The dense formulation (llm/model.py moe_ffn_block) runs every expert on
every token (E/k times the routed FLOPs); the routed one
(moe_ffn_block_routed, capacity factor 2.0) gathers each expert's buffer of
cap = T·k/E·2 rows and runs the experts on those only.  The probe times both
at E = 8, top-2, dim 4096, ffn 2752 (the JAX probe's 7B-class experts), bf16
experts by default (--mode q8_0 / q4_0 runs the experts through
quant_matmul), and prints which wins at each token count T.  It reports the
crossover; it does not move llama_forward's "auto" threshold (routed from
256 tokens), which would change results, because the routed path drops
tokens past capacity.

Times on the card: the device's time of one block (utils/timing.gpu_ms,
median of 5 calls queued behind a sleep kernel, CUDA events) and the host-inclusive time
of one call (CUDA events around it, median of 5), beside the card's
nvidia-smi name and power limit.  --device cpu runs the plain versions and
prints host-clock times only.  Weights are made on the device from seed 0.
"""

import argparse
import statistics
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import torch  # noqa: E402

from csinn2_tpu_torch.llm.config import LlamaConfig  # noqa: E402
from csinn2_tpu_torch.llm.model import (init_params_device, moe_capacity,  # noqa: E402
                                        moe_ffn_block, moe_ffn_block_routed)
from csinn2_tpu_torch.utils.device import gpu_line, resolve_device  # noqa: E402

FACTOR = 2.0


def probe(device="cuda", mode: str = "float", tokens=(8, 32, 128, 512), dim: int = 4096,
          ffn: int = 11008 // 4, log=print):
    """→ [dict(T, cap, dense_ms, routed_ms, dense_host_ms, routed_host_ms,
    winner)]; on the CPU the *_ms are host-clock times."""
    dev = resolve_device(device)
    cfg = LlamaConfig(dim=dim, n_layers=1, n_heads=32, n_kv_heads=32, ffn_dim=ffn,
                      vocab_size=256, max_seq_len=64, n_experts=8, moe_top_k=2)
    lp = init_params_device(cfg, mode, seed=0, device=dev)["layers"][0]
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    where = f"[{gpu_line()}]" if dev.type == "cuda" else "[cpu, plain versions, host clock]"
    log(f"E={cfg.n_experts} top-{cfg.moe_top_k}, dim={cfg.dim}, ffn={cfg.ffn_dim}, "
        f"{mode} experts, capacity factor {FACTOR} {where}")
    recs = []
    for T in tokens:
        x = torch.randn((1, T, cfg.dim), generator=gen, device=dev).to(torch.bfloat16)

        def dense():
            return moe_ffn_block(x, lp, cfg)

        def routed():
            return moe_ffn_block_routed(x, lp, cfg, capacity_factor=FACTOR)

        rec = dict(T=T, cap=moe_capacity(T, cfg, FACTOR))
        for name, fn in (("dense", dense), ("routed", routed)):
            fn()
            if dev.type == "cuda":
                from csinn2_tpu_torch.utils.timing import event_ms, gpu_ms
                # 5 calls of ~100 launches each stay inside the card's
                # launch queue while the sleep kernel holds it
                rec[f"{name}_ms"] = gpu_ms(fn, reps=5)
                rec[f"{name}_host_ms"] = statistics.median(event_ms(fn) for _ in range(5))
            else:
                t0 = time.perf_counter()
                fn()
                rec[f"{name}_ms"] = rec[f"{name}_host_ms"] = (time.perf_counter() - t0) * 1e3
        rec["winner"] = "routed" if rec["routed_ms"] < rec["dense_ms"] else "dense"
        log(f"T={T:4d} cap={rec['cap']:4d}: dense {rec['dense_ms']:.4f} ms  routed "
            f"{rec['routed_ms']:.4f} ms  routed/dense = {rec['routed_ms'] / rec['dense_ms']:.3f}"
            f"  -> {rec['winner']}  (host-inclusive: dense {rec['dense_host_ms']:.4f}, routed "
            f"{rec['routed_host_ms']:.4f} ms) {where}")
        recs.append(rec)
    flips = [r["T"] for r in recs if r["winner"] == "routed"]
    log(f"crossover: routed wins from T = {flips[0]} of {list(tokens)} (device time)"
        if flips else f"crossover: dense wins at every T of {list(tokens)} (device time)")
    return recs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", default="float", choices=["float", "q8_0", "q4_0"])
    ap.add_argument("--tokens", default="8,32,128,512")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    probe(args.device, args.mode, tuple(int(t) for t in args.tokens.split(",")))
    return 0


if __name__ == "__main__":
    sys.exit(main())
