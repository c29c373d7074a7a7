"""Device timing on a CUDA card.

`gpu_ms` times the GPU work of a call without the host time between its
launches: a long sleep kernel goes into the stream first, the host enqueues
`reps` calls with a CUDA event before and after each while the GPU still
sleeps, so consecutive events bracket back-to-back device work only.  It
checks that the sleep outlasted the enqueueing and raises if not."""

from __future__ import annotations

import statistics
from typing import Callable


def gpu_ms(fn: Callable[[], object], reps: int = 10,
           sleep_cycles: int = 200_000_000) -> float:
    """Median GPU time (ms) of one call of fn() over `reps` calls, after one
    warm-up call."""
    import torch
    fn()
    torch.cuda.synchronize()
    events = [torch.cuda.Event(enable_timing=True) for _ in range(reps + 1)]
    torch.cuda._sleep(sleep_cycles)
    events[0].record()
    for ev in events[1:]:
        fn()
        ev.record()
    queued_ahead = not events[0].query()   # the GPU had not reached it yet
    events[-1].synchronize()
    if not queued_ahead:
        raise RuntimeError("gpu_ms: the host enqueue outlasted the sleep "
                           "kernel; raise sleep_cycles or lower reps")
    return statistics.median(a.elapsed_time(b) for a, b in zip(events, events[1:]))
