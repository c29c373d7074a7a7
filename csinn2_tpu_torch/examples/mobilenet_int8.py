#!/usr/bin/env python3
"""MobileNetV1 INT8 end to end on the port (counterpart of
examples/mobilenet_int8.py, the analog of the reference's
example/c906_mobilenetv1_f16.c): build, calibrate, quantize, run, top-5.

    python3 -m csinn2_tpu_torch.examples.mobilenet_int8 [--size 224]
        [--scheme int8_sym] [--iters 5] [--device cuda|cpu]

Weights come from seed 0 and the image from numpy seed 0.  The quantized
logits (dequantized by the output's quant info) are held to the float
forward: cosine >= 0.99, then PASS or FAIL.  On the card the steady-state
ms/img and img/s are Session.run_benchmark_device's (CUDA events around
back-to-back runs, median of 3 reps), printed beside the card's nvidia-smi
name and power limit; with --device cpu they are Session.run_benchmark's
(host clock).  CSINN2_FUSE_DS=1 in the environment fuses the 13
depthwise→pointwise pairs into fused_dsconv blocks.
"""

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from csinn2_tpu_torch.core.dtypes import QuantScheme  # noqa: E402
from csinn2_tpu_torch.core.quant import dequantize  # noqa: E402
from csinn2_tpu_torch.models.mobilenet import MobileNetV1  # noqa: E402
from csinn2_tpu_torch.utils.device import gpu_line, resolve_device  # noqa: E402
from csinn2_tpu_torch.utils.platform import backend_summary  # noqa: E402
from csinn2_tpu_torch.utils.verify import cosine_similarity  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=224)
    ap.add_argument("--scheme", default="int8_sym",
                    choices=[s.value for s in QuantScheme])
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    dev = resolve_device(args.device)
    where = f"[{gpu_line()}]" if dev.type == "cuda" else "[cpu, plain path]"
    scheme = QuantScheme(args.scheme)
    print(f"== MobileNetV1 {scheme.value} @ {args.size}x{args.size} "
          f"on {backend_summary(dev)} ==", flush=True)

    model = MobileNetV1(input_size=args.size)
    x = np.random.default_rng(0).random(model.input_shape(1)).astype(np.float32)

    t0 = time.perf_counter()
    golden = model.forward_f32(x, device=dev).cpu().numpy()
    print(f"float forward: {time.perf_counter() - t0:.2f}s (host clock, incl. session build)")

    t0 = time.perf_counter()
    model.calibrate(x, device=dev)
    print(f"calibration:   {time.perf_counter() - t0:.2f}s "
          f"({len(model.recorder.ranges)} layers observed)")

    t0 = time.perf_counter()
    sess = model.build_session(scheme, device=dev)
    print(f"session setup: {time.perf_counter() - t0:.2f}s ({len(sess.graph.nodes)} graph nodes, "
          f"{sum(n.op == 'ds_block' for n in sess.graph.nodes)} ds_block)")

    xin = model.prepare_input(x, sess)
    t0 = time.perf_counter()
    out = sess.run(xin)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    print(f"first run: {time.perf_counter() - t0:.3f}s (host clock)")

    if dev.type == "cuda":
        dt = sess.run_benchmark_device(xin, iters=max(args.iters, 16))
        how = "run_benchmark_device: CUDA events, median of 3 reps"
    else:
        dt = sess.run_benchmark(xin, iters=args.iters, warmup=1)
        how = "run_benchmark: host clock"
    print(f"steady state: {dt * 1e3:.3f} ms/img ({1.0 / dt:.1f} img/s) ({how}) {where}")

    raw = out.cpu()
    print(f"raw output: dtype={raw.dtype} min={raw.min().item()} max={raw.max().item()}")
    out_np = raw.float().numpy()
    if not scheme.act_dtype.is_float:
        out_np = dequantize(raw, model.recorder.qinfo("fc", scheme)).numpy()
    cs = cosine_similarity(out_np, golden)
    top5_q = np.argsort(out_np[0])[::-1][:5]
    top5_f = np.argsort(golden[0])[::-1][:5]
    print(f"cosine vs float: {cs:.5f}")
    print(f"top5 quant: {top5_q.tolist()}")
    print(f"top5 float: {top5_f.tolist()}")
    ok = bool(np.isfinite(out_np).all()) and cs >= 0.99
    print("PASS" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
