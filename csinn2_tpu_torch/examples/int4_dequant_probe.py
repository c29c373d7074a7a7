"""Q4_0 decode-GEMM dequant-strategy probe at the Llama-2-7B decode shapes,
on the card (the counterpart of examples/int4_dequant_probe.py `main`).

    python3 -m csinn2_tpu_torch.examples.int4_dequant_probe
    SHAPES=0,2 VARIANTS=andmask,w4a8 python3 -m csinn2_tpu_torch.examples.int4_dequant_probe

For each shape of main's list (K, N, bn, bk) at M = 8 it draws x, the Q4_0
values q and the f32 block scales from numpy's default_rng(0) as main does,
makes the four packs (Q4_0, re-biased, mixed, the i4native carrier) and the
golden x @ (q·s) in f32, and runs main's variants: `cur(quant_matmul)` (the
port's packed decode GEMM), the ten pipelines of kernels/int4_probe.py,
w4a8 at bn 2048 and 1024, and the andmask_bn*_bk* sweep (every kind takes
the decode GEMM's geometry whatever the tile, so these rows repeat w4a8's
and andmask's launches; kernels/int4_probe.py notes).  Each variant prints
one line: the kernel's time (its one CUDA launch alone; cold L2:
utils/timing.gpu_ms_cold over copies of the weights), GB/s and % of the bytes bound of main's formula — K·N/2 +
K/32·N·4 + M·K·2 bytes at the H100's 3.35 TB/s — its factor over
cur(quant_matmul)'s time, then the whole function's time (the outside ops
too) and the cosine against the golden.  The card's nvidia-smi name and
power limit come first.  SHAPES picks shapes by index, VARIANTS keeps the
variants whose name contains one of its comma-separated words.

With device="cpu" (the tests) the plain versions run and nothing is timed.
"""

from __future__ import annotations

import os
import subprocess
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from csinn2_tpu_torch.kernels import int4_probe as P
from csinn2_tpu_torch.kernels.qmatmul import pack_int4, quant_matmul
from csinn2_tpu_torch.utils.device import resolve_device
from csinn2_tpu_torch.utils.timing import cold_copies, gpu_ms_cold, l2_bytes
from csinn2_tpu_torch.utils.verify import cosine_similarity

HBM = 3.35e12                 # H100 SXM HBM3 bytes/s (NVIDIA data sheet)
BLOCK = P.BLOCK
# (K, N, bn, bk) of main's list (:589-595): wqkv, w13, w2, wo
ALL_SHAPES = [(4096, 12288, 6144, 512), (4096, 22016, 5504, 512),
              (11008, 4096, 4096, 512), (4096, 4096, 4096, 512)]
SHAPE_NAMES = ("wqkv", "w13", "w2", "wo")
CUR = "cur(quant_matmul)"


def gpu_line() -> str:
    """The card's `nvidia-smi --query-gpu=name,power.limit` line."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], check=True, capture_output=True,
                          text=True, timeout=60).stdout.strip().splitlines()[0]


def make_case(rng: np.random.Generator, M: int, K: int, N: int, device) -> Dict:
    """x, the weights in every carrier, the scales and the golden, drawn
    from `rng` in main's order (:602-625)."""
    x = torch.from_numpy(rng.standard_normal((M, K))).to(torch.bfloat16)
    q = rng.integers(-8, 8, (K, N)).astype(np.int8)
    s_np = (rng.random((K // BLOCK, N)) * 0.01 + 0.005).astype(np.float32)
    wf = q.astype(np.float32).reshape(K // BLOCK, BLOCK, N) * s_np[:, None, :]
    gold = x.float().numpy() @ wf.reshape(K, N)
    del wf
    qt = torch.from_numpy(q).to(device)
    s = torch.from_numpy(s_np).to(device)
    weights = {"wp": pack_int4(qt), "wp_b": P.pack_int4_biased(qt),
               "wp_m": P.pack_int4_mixed(qt), "w4": P.pack_int4_native(qt),
               "s": s, "s16": s.to(torch.bfloat16)}
    return {"x": x.to(device), "weights": weights, "gold": gold}


def variant_table(M: int, K: int, N: int, bn: int, bk: int) -> Dict[str, tuple]:
    """main's variants dict (:632-657): name → (kind, weight, scales, bn, bk);
    kind "cur" is quant_matmul."""
    v = {CUR: ("cur", "wp", "s", bn, bk),
         "split_i32": ("split_i32", "wp", "s", bn, bk),
         "split_i8": ("split_i8", "wp", "s", bn, bk),
         "i4native": ("i4native", "w4", "s", bn, bk),
         "bitcast": ("bitcast", "wp_b", "s", bn, bk),
         "andmask": ("andmask", "wp_m", "s", bn, bk),
         "andmask_bf16s": ("andmask_bf16s", "wp_m", "s16", bn, bk),
         "stream": ("stream", "wp", "s", bn, bk),
         "intdot": ("intdot", "wp_m", "s", bn, bk),
         "w4a8": ("w4a8", "wp_m", "s", bn, bk),
         "w4a8_n2048": ("w4a8", "wp_m", "s", 2048, 512),
         "w4a8_n1024": ("w4a8", "wp_m", "s", 1024, 512),
         "noscale(timing)": ("noscale", "wp_m", "s16", bn, bk),
         "halfq8(timing)": ("halfq8", "wp_m", "s16", bn, bk)}
    for bn2, bk2 in [(N, 256), (N // 2, 256), (N, 512), (N // 4, 256)]:
        if bn2 > N or K % bk2 or N % bn2:
            continue
        v[f"andmask_bn{bn2}_bk{bk2}"] = ("andmask", "wp_m", "s", bn2, bk2)
    return v


def calls(spec: tuple, x: torch.Tensor, weights: Dict, M: int):
    """(the whole function, its kernel alone) of one variant as zero-argument
    callables on these weights."""
    kind, wkey, skey, bn, bk = spec
    w, s = weights[wkey], weights[skey]
    if kind == "cur":
        fn = lambda: quant_matmul(x, w, s, scale_mode="block", packed_int4=True)
        return fn, fn
    kernel = P.prepare(kind, x, w, s, M, bn, bk).kernel
    return (lambda: P.prepare(kind, x, w, s, M, bn, bk)()), kernel


def kernel_bytes(kind: str, M: int, N: int, K: int) -> int:
    """The variant's own bytes bound (quant_matmul: x, weight, f32 scales
    and the f32 output)."""
    if kind == "cur":
        return M * K * 2 + K * N // 2 + (K // BLOCK) * N * 4 + M * N * 4
    return P.kernel_bytes(kind, M, N, K)


def probe(device="cuda", shapes: Optional[Sequence[tuple]] = None,
          only: Optional[str] = None, M: int = 8, reps: int = 20,
          log: Callable[[str], None] = print) -> List[Dict]:
    """Run main's variants at `shapes` ((K, N, bn, bk); main's list by
    default) and return one record per (shape, variant): name, kind, K, N,
    cos (against the golden), and on the card us / fn_us (cold medians of
    `reps` calls), gbs and pct_sol (main's bytes formula), bound_us (the
    variant's own bytes over 3.35 TB/s)."""
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    log(f"# card: {gpu_line()}" if on_card else "# device: cpu (plain versions, not timed)")
    rng = np.random.default_rng(0)
    out = []
    for K, N, bn, bk in (ALL_SHAPES if shapes is None else shapes):
        case = make_case(rng, M, K, N, dev)
        x, gold = case["x"], case["gold"]
        nbytes = K * N // 2 + (K // BLOCK) * N * 4 + M * K * 2
        sol = nbytes / HBM
        log(f"-- M{M} K{K} N{N} bn{bn} bk{bk}: int4 SOL {sol * 1e6:7.1f} us")
        copies = [case["weights"]]
        if on_card:
            n = cold_copies(K * N // 2 + (K // BLOCK) * N * 4, l2_bytes())
            copies += [{k: t.clone() for k, t in case["weights"].items()} for _ in range(n - 1)]
        cur = None
        for name, spec in variant_table(M, K, N, bn, bk).items():
            if only and not any(v in name for v in only.split(",")):
                continue
            fn, _ = calls(spec, x, copies[0], M)
            y = fn()
            cos = cosine_similarity(y.float().cpu().numpy(), gold)
            rec = dict(name=name, kind=spec[0], K=K, N=N, M=M, cos=cos,
                       bound_us=kernel_bytes(spec[0], M, N, K) / HBM * 1e6)
            if on_card:
                pairs = [calls(spec, x, c, M) for c in copies]
                t = gpu_ms_cold([k for _, k in pairs], reps) * 1e-3
                t_fn = gpu_ms_cold([f for f, _ in pairs], reps) * 1e-3
                cur = t if spec[0] == "cur" else cur
                rec.update(us=t * 1e6, fn_us=t_fn * 1e6, gbs=nbytes / t / 1e9,
                           pct_sol=100 * sol / t)
                vs = f"{t / cur:5.2f}x cur" if cur else ""
                log(f"   {name:24s}: {t * 1e6:8.1f} us {nbytes / t / 1e9:6.0f} GB/s "
                    f"{100 * sol / t:5.1f}% SOL {vs}  fn {t_fn * 1e6:8.1f} us  cos={cos:.6f}")
            else:
                log(f"   {name:24s}: time not measured (cpu)  cos={cos:.6f}")
            out.append(rec)
        del copies, case
    return out


def main() -> None:
    pick = os.environ.get("SHAPES")
    shapes = [ALL_SHAPES[int(i)] for i in pick.split(",")] if pick else None
    probe(shapes=shapes, only=os.environ.get("VARIANTS"))


if __name__ == "__main__":
    main()
