"""Device timing on a CUDA card.

`gpu_ms` times the GPU work of a call without the host time between its
launches: a long sleep kernel goes into the stream first, the host enqueues
`reps` calls with a CUDA event before and after each while the GPU still
sleeps, so consecutive events bracket back-to-back device work only.  It
checks that the sleep outlasted the enqueueing and raises if not.

Back-to-back calls find their inputs in the card's L2 (50 MB on an H100)
when those fit, and a short kernel over such a weight then reads faster than
device memory allows.  `gpu_ms_cold` times a call the way a caller that
streams other data in between finds it: the calls rotate over `fns`, each on
its own copy of the inputs, made once before timing, whose total exceeds
twice the L2 (`cold_copies` says how many copies that takes)."""

from __future__ import annotations

import math
import statistics
from typing import Callable, Sequence


def l2_bytes() -> int:
    """The L2 size of the current CUDA device."""
    import torch
    return int(torch.cuda.get_device_properties(torch.cuda.current_device()).L2_cache_size)


def cold_copies(nbytes: int, l2: int) -> int:
    """Copies of `nbytes` of inputs whose total exceeds 2 × l2 (at least 2)."""
    return max(2, math.ceil(2 * l2 / max(1, nbytes)) + 1)


def gpu_ms_cold(fns: Sequence[Callable[[], object]], reps: int = 20,
                sleep_cycles: int = 200_000_000) -> float:
    """Median GPU time (ms) of one call over `reps` calls that rotate over
    fns (each on its own copy of the inputs), after one warm-up call of
    each."""
    import torch
    for fn in fns:
        fn()
    torch.cuda.synchronize()
    events = [torch.cuda.Event(enable_timing=True) for _ in range(reps + 1)]
    torch.cuda._sleep(sleep_cycles)
    events[0].record()
    for i, ev in enumerate(events[1:]):
        fns[i % len(fns)]()
        ev.record()
    queued_ahead = not events[0].query()   # the GPU had not reached it yet
    events[-1].synchronize()
    if not queued_ahead:
        raise RuntimeError("gpu_ms: the host enqueue outlasted the sleep "
                           "kernel; raise sleep_cycles or lower reps")
    return statistics.median(a.elapsed_time(b) for a, b in zip(events, events[1:]))


def gpu_ms(fn: Callable[[], object], reps: int = 10,
           sleep_cycles: int = 200_000_000) -> float:
    """Median GPU time (ms) of one call of fn() over `reps` back-to-back
    calls, after one warm-up call (inputs that fit stay in L2)."""
    return gpu_ms_cold([fn], reps, sleep_cycles)
