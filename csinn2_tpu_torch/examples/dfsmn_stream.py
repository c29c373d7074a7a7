#!/usr/bin/env python3
"""Streaming ASR demo on the port (counterpart of examples/dfsmn_stream.py):
a DFSMN acoustic model runs chunked functional streaming, one GRAPH session
step carrying the FIR and skip caches as explicit tensors on the device.

    python3 -m csinn2_tpu_torch.examples.dfsmn_stream [--device cuda|cpu]
        [--chunk 8] [--frames 256] [--blocks 6] [--hidden 512] [--proj 256]

Checks that the streamed logits equal the offline (whole-utterance) forward
on every interior frame (cosine > 0.9999 and max |d| < 1e-3, then PASS or
FAIL), and reports the steady-state chunk latency and frames/s: on the card
by Session.run_benchmark_device (CUDA events around back-to-back steps,
median of 3 reps), beside its nvidia-smi name and power limit; with
--device cpu by Session.run_benchmark (host clock).  Weights come from
seed 0, the utterance from numpy seed 0.
"""

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from csinn2_tpu_torch.models.dfsmn_asr import DFSMNASR, DFSMNConfig  # noqa: E402
from csinn2_tpu_torch.utils.device import gpu_line, resolve_device  # noqa: E402
from csinn2_tpu_torch.utils.verify import cosine_similarity  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--chunk", type=int, default=8)
    ap.add_argument("--frames", type=int, default=256)
    ap.add_argument("--blocks", type=int, default=6)
    ap.add_argument("--hidden", type=int, default=512)
    ap.add_argument("--proj", type=int, default=256)
    args = ap.parse_args()
    dev = resolve_device(args.device)
    where = f"[{gpu_line()}]" if dev.type == "cuda" else "[cpu, plain path]"

    cfg = DFSMNConfig(feat_dim=80, hidden=args.hidden, proj=args.proj,
                      blocks=args.blocks, l_order=10, r_order=2, classes=218)
    model = DFSMNASR(cfg, seed=0, device=dev)
    print(f"== DFSMN blocks={cfg.blocks} hidden={cfg.hidden} proj={cfg.proj} "
          f"delay={cfg.total_delay}f chunk={args.chunk} on {dev} {where} ==")

    T, C = args.frames, args.chunk
    x = np.random.default_rng(0).standard_normal((1, T, cfg.feat_dim)).astype(np.float32)

    t0 = time.perf_counter()
    offline = model.offline_session(1, T).run(x).cpu().numpy()
    print(f"offline [1,{T},80] (incl session build): {time.perf_counter() - t0:.2f}s")

    t0 = time.perf_counter()
    st = model.stream(batch=1, chunk=C)
    outs = [st.step(x[:, i:i + C]) for i in range(0, T, C)]
    streamed = torch.cat(outs + [st.flush()], dim=1).cpu().numpy()
    print(f"streamed {T} frames (incl session build): {time.perf_counter() - t0:.2f}s")

    # interior equality (the boundaries differ by the padding convention;
    # docstring of models/dfsmn_asr.py)
    lo, hi = cfg.blocks * cfg.l_span, T - cfg.blocks * cfg.r_span
    got = streamed[:, st.delay + lo:st.delay + hi]
    want = offline[:, lo:hi]
    cs = cosine_similarity(got, want)
    err = float(np.max(np.abs(got - want)))
    print(f"stream vs offline: cosine={cs:.6f} max_abs_err={err:.2e}")

    st2 = model.stream(batch=1, chunk=C)
    if dev.type == "cuda":
        dt = st2.sess.run_benchmark_device(x[:, :C], *st2.state, iters=32)
        how = "run_benchmark_device: CUDA events, median of 3 reps"
    else:
        dt = st2.sess.run_benchmark(x[:, :C], *st2.state, iters=32)
        how = "run_benchmark: host clock"
    print(f"steady-state: {dt * 1e3:.3f} ms/chunk ({C / dt:,.0f} frames/s, "
          f"{C / dt / 100:,.0f}x realtime @10ms frames) ({how}) {where}")

    ok = cs > 0.9999 and err < 1e-3
    print("PASS" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
