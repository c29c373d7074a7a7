#!/usr/bin/env python3
"""Where a decode step's time goes, on the card: Llama-2-7B (32 layers,
seeded random weights made on the card), int8 KV, every lane of a batch at
position 128 (phase 4's decode rate).

    python3 csinn2_tpu_torch/examples/decode_step_profile.py [--mode q8_0] [--batch 4]

Prints, beside the card's nvidia-smi name and power limit:
  * the step's time through the engine's step graph (decode_steps) and
    through the eager loop (_decode_steps_eager), in turns: the median of
    --reps calls of --steps steps each, CUDA events around the call;
  * a torch.profiler trace of --steps steps through each loop: the device
    time a step of every kernel (by name, summed over its launches), the
    kernels grouped as the decode GEMM (`qmm_`), attention (`attn`) and
    the rest (PyTorch's own kernels: norms, RoPE, the KV store, sampling),
    and the device's busy share of the traced step (kernel time over the
    step's time under the trace).
The trace runs after the timed calls, since a process that has traced
launches more slowly afterwards.
"""

import argparse
import collections
import statistics
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from csinn2_tpu_torch.llm.config import LlamaConfig  # noqa: E402
from csinn2_tpu_torch.llm.engine import InferenceEngine  # noqa: E402
from csinn2_tpu_torch.llm.model import init_params_device  # noqa: E402
from csinn2_tpu_torch.utils.device import gpu_line  # noqa: E402
from csinn2_tpu_torch.utils.timing import event_ms  # noqa: E402

POS = 128                      # every lane's position
TOP = 12                       # kernels listed by name
GROUPS = (("decode GEMM (qmm_*)", "qmm_"), ("attention (attn_*)", "attn"))


def _group(name: str) -> str:
    for label, key in GROUPS:
        if key in name:
            return label
    return "other (PyTorch's kernels)"


def _kernel_times(prof):
    """{kernel name: (device µs summed, launches)} of a trace's CUDA kernels."""
    out = {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        out[e.key] = (float(us), int(e.count))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", default="q8_0", choices=["int8", "int4", "q8_0", "q4_0"])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)

    card = gpu_line()
    cfg = LlamaConfig.llama2_7b()
    eng = InferenceEngine(cfg, init_params_device(cfg, args.mode, seed=0, device="cuda"),
                          batch=args.batch, quantized_kv=True, device="cuda")
    prompt = [int(t) for t in np.random.default_rng(0).integers(1, cfg.vocab_size, POS)]
    first = {sid: eng.prefill_sample(sid, prompt) for sid in range(args.batch)}
    loops = {"step graph": eng.decode_steps, "eager loop": eng._decode_steps_eager}

    def run(loop):
        for s in eng.slots:
            s.pos = POS
        loops[loop](first, args.steps)

    for loop in loops:
        run(loop)                               # captures, first calls
    times = {loop: [] for loop in loops}
    for r in range(args.reps):                  # in turns: graph, eager, eager, graph, ...
        for loop in list(loops)[::1 if r % 2 == 0 else -1]:
            times[loop].append(event_ms(lambda: run(loop)) / args.steps)
    print(f"== Llama-2-7B L={cfg.n_layers} {args.mode} int8 KV, batch {args.batch} at pos "
          f"{POS} [{card}] ==")
    for loop, ms in times.items():
        print(f"{loop}: {statistics.median(ms):.3f} ms a step (median of {len(ms)} x "
              f"{args.steps} steps, CUDA events around the call; all {[round(m, 3) for m in ms]}) "
              f"[{card}]")

    act = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for loop in loops:
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=act) as prof:
            step_ms = event_ms(lambda: run(loop)) / args.steps
        kernels = _kernel_times(prof)
        if not kernels:
            print(f"{loop} trace: no device time in the trace (not measured)")
            continue
        busy_ms = sum(us for us, _ in kernels.values()) / 1e3 / args.steps
        print(f"{loop} trace: {step_ms:.3f} ms a step under the trace, kernels {busy_ms:.3f} ms "
              f"a step ({100 * busy_ms / step_ms:.1f} % busy), "
              f"{sum(n for _, n in kernels.values()) / args.steps:g} launches a step [{card}]")
        groups = collections.defaultdict(lambda: [0.0, 0])
        for name, (us, n) in kernels.items():
            g = groups[_group(name)]
            g[0] += us
            g[1] += n
        for label, (us, n) in sorted(groups.items(), key=lambda kv: -kv[1][0]):
            print(f"  {label}: {us / 1e3 / args.steps:.3f} ms a step, "
                  f"{n / args.steps:g} launches a step")
        for name, (us, n) in sorted(kernels.items(), key=lambda kv: -kv[1][0])[:TOP]:
            print(f"    {us / args.steps:9.1f} us  {n / args.steps:6g}x  {name[:110]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
