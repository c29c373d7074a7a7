"""Min-of-REPS launch-geometry sweep of the andmask Q4_0 decode kernel (the
counterpart of examples/int4_tile_tune.py).

    python3 -m csinn2_tpu_torch.examples.int4_tile_tune      [REPS=3]

The TPU tuner sweeps the VMEM tile (bn, bk); on the card the tile becomes a
launch geometry (kernels/int4_probe.py `launch_geometry`): `cols` output
columns per CTA of 256 threads and `ksplit` K rows per split.  At each
Llama-2-7B decode shape (M = 8) every geometry cols ∈ {32, 64, 128, 256} ×
ksplit ∈ {256, 512, 1024, 2048} (ksplit <= K) is timed REPS times (each a
cold-L2 median, utils/timing.gpu_ms_cold, of the kernel and its split-K
reduce) and the minimum is kept; the best geometry per shape is printed.
The TPU tuner's VMEM guard becomes the kernel's fit check: its registers
per thread, its static shared memory and the CTAs per SM the occupancy API
allows (kernel_attrs); the sweep raises if the kernel cannot keep one CTA
on an SM.  cols and the split length are runtime arguments of one kernel
instantiation per M, so one check covers every geometry.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np

from csinn2_tpu_torch.examples.int4_dequant_probe import BLOCK, HBM, gpu_line, make_case
from csinn2_tpu_torch.kernels import int4_probe as P
from csinn2_tpu_torch.utils.device import resolve_device
from csinn2_tpu_torch.utils.timing import cold_copies, gpu_ms_cold, l2_bytes

SHAPES = ((4096, 12288), (4096, 22016), (11008, 4096), (4096, 4096))
COLS = (32, 64, 128, 256)
KSPLITS = (256, 512, 1024, 2048)


def geometries(K: int):
    """(cols, ksplit) candidates at depth K."""
    return [(c, k) for c in COLS for k in KSPLITS if k <= K]


def tune(device="cuda", shapes: Sequence[Tuple[int, int]] = SHAPES, reps: Optional[int] = None,
         M: int = 8, log: Callable[[str], None] = print) -> Dict[Tuple[int, int], Dict]:
    """Sweep the geometries at `shapes`; returns (K, N) → the best
    {cols, ksplit, us, pct_sol}."""
    reps = int(os.environ.get("REPS", "3")) if reps is None else reps
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError("int4_tile_tune times the card; it has no CPU mode")
    log(f"# card: {gpu_line()}")
    attrs = P.kernel_attrs("andmask", M, dev.index or 0)
    log(f"# andmask kernel at M={M}: {attrs['regs']} registers/thread, {attrs['smem']} B "
        f"static shared memory, {attrs['ctas_per_sm']} CTAs/SM (256 threads)")
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
        for cols, ksplit in geometries(K):
            # bn = 32·cols selects `cols` columns (launch_geometry)
            fns = [P.prepare("andmask", x, wq, s, M, 32 * cols, ksplit).kernel
                   for wq, s in copies]
            ts = [gpu_ms_cold(fns) * 1e-3 for _ in range(reps)]
            t = min(ts)
            results[cols, ksplit] = t
            log(f"   cols {cols:4d} ksplit {ksplit:5d}: {t * 1e6:7.1f} us "
                f"{100 * sol / t:5.1f}% SOL  (spread +{(max(ts) - t) / t * 100:.0f}%)")
        (cols, ksplit), t = min(results.items(), key=lambda kv: kv[1])
        best[K, N] = dict(cols=cols, ksplit=ksplit, us=t * 1e6, pct_sol=100 * sol / t)
        log(f"   BEST: cols {cols} ksplit {ksplit} {t * 1e6:.1f} us {100 * sol / t:.1f}% SOL")
        del copies, case
    return best


if __name__ == "__main__":
    tune()
