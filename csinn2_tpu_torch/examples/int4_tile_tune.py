"""Min-of-REPS split-length sweep of the andmask Q4_0 decode kernel (the
counterpart of examples/int4_tile_tune.py).

    python3 -m csinn2_tpu_torch.examples.int4_tile_tune      [REPS=3]

The TPU tuner sweeps the VMEM tile (bn, bk).  On the card the andmask
kernel is the plane kinds' tensor-core kernel (kernels/int4_probe.py
`plane_geometry`): a fixed 256-column strip per CTA of 256 threads, and
the K rows per split, which the decode GEMM's plan chooses by default.
That split length is the knob left, so at each Llama-2-7B decode shape (M =
8) the plan's split and every ksplit ∈ {256, 512, 1024, 2048} (ksplit <=
K) are timed REPS times (each a cold-L2 median, utils/timing.gpu_ms_cold;
the split finish is in the launch) and the minimum is kept; the best split
per shape is printed beside the plan's.  The TPU tuner's VMEM guard becomes
the kernel's fit check: its registers per thread, its static and dynamic
(the ring's) shared memory and the CTAs per SM the occupancy API allows
with them (kernel_attrs); the sweep raises if the kernel cannot keep one
CTA on an SM.  The split length is a runtime argument of one kernel
instantiation per M class, so one check covers every split.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from csinn2_tpu_torch.examples.int4_dequant_probe import BLOCK, HBM, gpu_line, make_case
from csinn2_tpu_torch.kernels import int4_probe as P
from csinn2_tpu_torch.utils.device import resolve_device
from csinn2_tpu_torch.utils.timing import cold_copies, gpu_ms_cold, l2_bytes

SHAPES = ((4096, 12288), (4096, 22016), (11008, 4096), (4096, 4096))
KSPLITS = (256, 512, 1024, 2048)


def splits(M: int, N: int, K: int, n_sm: int):
    """K rows per split to time at (M, N, K): the plan's first, then
    KSPLITS (at most K)."""
    plan = P.plane_geometry(M, N, K, n_sm)[1]
    return [plan] + [k for k in KSPLITS if k <= K and k != plan]


def tune(device="cuda", shapes: Sequence[Tuple[int, int]] = SHAPES, reps: Optional[int] = None,
         M: int = 8, log: Callable[[str], None] = print) -> Dict[Tuple[int, int], Dict]:
    """Sweep the split lengths at `shapes`; returns (K, N) → the best
    {ksplit, plan_ksplit, us, plan_us, pct_sol}."""
    reps = int(os.environ.get("REPS", "3")) if reps is None else reps
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError("int4_tile_tune times the card; it has no CPU mode")
    log(f"# card: {gpu_line()}")
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    n_sm = torch.cuda.get_device_properties(index).multi_processor_count
    attrs = P.kernel_attrs("andmask", M, index)
    log(f"# andmask kernel at M={M}: {attrs['regs']} registers/thread, {attrs['smem']} B "
        f"static and {attrs['dyn_smem']} B dynamic shared memory, {attrs['ctas_per_sm']} "
        f"CTAs/SM (256 threads)")
    if attrs["ctas_per_sm"] < 1:
        raise RuntimeError(f"the andmask kernel does not fit an SM: {attrs}")
    rng = np.random.default_rng(0)
    best = {}
    for K, N in shapes:
        case = make_case(rng, M, K, N, dev)
        x, w = case["x"], case["weights"]
        nbytes = K * N // 2 + (K // BLOCK) * N * 4 + M * K * 2
        sol = nbytes / HBM
        log(f"-- M{M} K{K} N{N}: int4 SOL {sol * 1e6:7.1f} us")
        n = cold_copies(K * N // 2 + (K // BLOCK) * N * 4, l2_bytes())
        copies = [(w["wp_m"], w["s"])] + [(w["wp_m"].clone(), w["s"].clone())
                                          for _ in range(n - 1)]
        results = {}
        cands = splits(M, N, K, n_sm)
        for ksplit in cands:
            fns = [P.prepare("andmask", x, wq, s, M, N, 512, ksplit=ksplit).kernel
                   for wq, s in copies]
            ts = [gpu_ms_cold(fns) * 1e-3 for _ in range(reps)]
            t = min(ts)
            results[ksplit] = t
            tag = " (plan)" if ksplit == cands[0] else ""
            log(f"   ksplit {ksplit:5d} ({-(-K // ksplit):2d} splits){tag:7s}: {t * 1e6:7.1f} us "
                f"{100 * sol / t:5.1f}% SOL  (spread +{(max(ts) - t) / t * 100:.0f}%)")
        ksplit, t = min(results.items(), key=lambda kv: kv[1])
        best[K, N] = dict(ksplit=ksplit, plan_ksplit=cands[0], us=t * 1e6,
                          plan_us=results[cands[0]] * 1e6, pct_sol=100 * sol / t)
        log(f"   BEST: ksplit {ksplit} {t * 1e6:.1f} us {100 * sol / t:.1f}% SOL "
            f"(plan: {cands[0]}, {results[cands[0]] * 1e6:.1f} us)")
        del copies, case
    return best


if __name__ == "__main__":
    tune()
