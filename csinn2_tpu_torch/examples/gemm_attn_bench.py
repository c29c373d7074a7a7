"""Times of the prefill GEMM (quant_matmul at M > 16) and of decode attention
on the card, warm and cold, beside one library call each; optionally for
several trees of this repository in turns, so two versions compare inside
one call on one card.

    python3 csinn2_tpu_torch/examples/gemm_attn_bench.py
    python3 csinn2_tpu_torch/examples/gemm_attn_bench.py --trees OLD . . OLD

With --trees, each tree (a directory holding csinn2_tpu_torch/) runs this
file in a process of its own that imports the package from that tree;
the rows of all runs are printed as one table, then as one JSON list on
the last line.  Cases:

  * quant_matmul on the Llama-2-7B w13 (K 4096, N 22016; swiglu N 22528,
    out [M, 11264]) at M = 128 in the seven float-x modes (Q8_0, INT8_CHANNEL,
    scale_mode "none", Q4_0, INT4_CHANNEL, Q4_0 + swiglu, Q8_0 [N, K]) and at
    M = 512 and 2048 in Q8_0 and Q4_0; the library call is torch.matmul on the
    dequantized bf16 weight;
  * decode attention at row 2's shape (b 4, hq = hk = 32, d 128, S 2048,
    int8 KV, kv_len 2048 / 1027 / 0 / 17) through decode_attention, and row
    4''s (kv_len 2048 / 1027 / 1 / 17, causal) through bhsd flash_attention;
    the library call is SDPA on the dequantized bf16 K/V with the mask.

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
K7, N13, NSW = 4096, 22016, 22528
# label → (scale_mode, packed_int4, w_transposed, swiglu)
GEMM_MODES = {"1a q8_0": ("block", False, False, False),
              "1b int8_channel": ("channel", False, False, False),
              "1b' none": ("none", False, False, False),
              "1c q4_0": ("block", True, False, False),
              "1b+1c int4_channel": ("channel", True, False, False),
              "1e q4_0 swiglu": ("block", True, False, True),
              "1e' q8_0 [N,K]": ("block", False, True, False)}
GEMM_CASES = [(label, 128) for label in GEMM_MODES] + \
    [(label, M) for M in (512, 2048) for label in ("1a q8_0", "1c q4_0")]


def gpu_line() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], check=True, capture_output=True,
                          text=True, timeout=60).stdout.strip().splitlines()[0]


def _bound(nbytes: float, flops: float):
    tb, tf = nbytes / HBM, flops / BF16
    return max(tb, tf) * 1e3, "bytes" if tb >= tf else "operations"


def _gemm_operands(g, label: str):
    """(weight, scales, dequantized bf16 [K, N] weight, kwargs, N) of a mode."""
    import torch
    from csinn2_tpu_torch.kernels.qmatmul import pack_int4, pack_int4_t
    scale_mode, packed, trans, swiglu = GEMM_MODES[label]
    N = NSW if swiglu else N13
    lo, hi = (-8, 8) if packed else (-128, 128)
    q = torch.randint(lo, hi, (K7, N), generator=g, device="cuda", dtype=torch.int8)
    if scale_mode == "block":
        s = (torch.rand((K7 // 32, N), generator=g, device="cuda") * 2e-4 + 1e-5) \
            .to(torch.float16).float()
        deq = (q.float().reshape(K7 // 32, 32, N) * s[:, None]).reshape(K7, N)
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
    return w, s, deq.to(torch.bfloat16), kw, N


def bench_gemm(g, line: str):
    import torch
    from csinn2_tpu_torch.kernels.qmatmul import quant_matmul, quant_matmul_ref
    from csinn2_tpu_torch.utils.timing import cold_copies, gpu_ms, gpu_ms_cold, l2_bytes
    from csinn2_tpu_torch.utils.verify import cosine_similarity
    rows = []
    for label, M in GEMM_CASES:
        w, s, deq, kw, N = _gemm_operands(g, label)
        x = torch.randn((M, K7), generator=g, device="cuda").to(torch.bfloat16)
        y = quant_matmul(x, w, s, **kw)
        torch.cuda.synchronize()
        ref = quant_matmul_ref(x, w, s, **kw)
        yf, rf = y.float().cpu().numpy(), ref.float().cpu().numpy()
        cos = cosine_similarity(yf, rf)
        rel = float(abs(yf - rf).max()) / float(abs(rf).max())
        if not (cos >= 0.9999 and rel <= 1e-2):
            raise AssertionError(f"{label} M={M}: cos={cos} max|d|/max|y|={rel}")
        wbytes = w.numel() + (0 if s is None else s.numel() * 4)
        n_out = N // 2 if kw["swiglu"] else N
        b_ms, b_by = _bound(M * K7 * 2 + wbytes + M * n_out * 2, 2.0 * M * N * K7)
        warm = gpu_ms(lambda: quant_matmul(x, w, s, **kw))
        lib_warm = gpu_ms(lambda: torch.matmul(x, deq))
        n = cold_copies(wbytes, l2_bytes())
        copies = [(w.clone(), None if s is None else s.clone()) for _ in range(n)]
        cold = gpu_ms_cold([lambda c=c: quant_matmul(x, c[0], c[1], **kw) for c in copies])
        del copies
        n = cold_copies(deq.numel() * 2, l2_bytes())
        dcopies = [deq.clone() for _ in range(n)]
        lib_cold = gpu_ms_cold([lambda d=d: torch.matmul(x, d) for d in dcopies])
        del dcopies
        rows.append(dict(kind="gemm", case=label, M=M, K=K7, N=N, ms=warm, ms_cold=cold,
                         library_ms=lib_warm, library_ms_cold=lib_cold, bound_ms=b_ms,
                         bound_by=b_by, cos=cos, card=line))
        print(json.dumps(rows[-1]), flush=True)
        del w, s, deq, x, y
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


def worker() -> int:
    import torch
    if not torch.cuda.is_available():
        print("gemm_attn_bench: no CUDA device", file=sys.stderr)
        return 1
    line = gpu_line()
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    bench_decode_attention(g, line)
    bench_gemm(g, line)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trees", nargs="*", default=None,
                    help="repository trees to time in turns (default: this one)")
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        return worker()
    here = Path(__file__).resolve().parents[2]
    trees = [Path(t).resolve() for t in (args.trees or [str(here)])]
    results = []
    for i, tree in enumerate(trees):
        if not (tree / "csinn2_tpu_torch").is_dir():
            raise SystemExit(f"gemm_attn_bench: no csinn2_tpu_torch/ under {tree}")
        env = dict(os.environ, PYTHONPATH=str(tree))
        proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--worker"],
                              cwd=str(tree), env=env, capture_output=True, text=True)
        sys.stderr.write(proc.stderr[-4000:])
        if proc.returncode != 0:
            print(proc.stdout[-4000:])
            raise SystemExit(f"gemm_attn_bench: run {i} ({tree}) exited {proc.returncode}")
        for ln in proc.stdout.splitlines():
            if ln.startswith("{"):
                results.append(dict(json.loads(ln), run=i, tree=str(tree)))
    for r in results:
        print(f"run {r['run']} {r['kind']:9s} {r['case']:24s} M={r.get('M', '-')!s:5s} "
              f"ms {r['ms']:.4f} cold {r['ms_cold']:.4f} lib {r['library_ms']:.4f} "
              f"lib_cold {r['library_ms_cold']:.4f} bound {r['bound_ms']:.4f} "
              f"({r['bound_by']}) cos {r['cos']:.6f} [{r['card']}]")
    print(json.dumps(results))
    return 0


if __name__ == "__main__":
    sys.exit(main())
