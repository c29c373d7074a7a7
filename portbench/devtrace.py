"""The benchmark's own reading of a torch.profiler trace (CUDA activity
only, so the host's launches are not slowed by CPU-op tracing).

Host and device clocks are tied by marker kernels (torch.cuda._sleep,
`spin_kernel` in the trace), each launched on an idle card right after a
host clock reading: three short ones at the start of the traced segment
and three long ones at its end, told apart by their length.  The profiler
has been seen to drop markers, once a whole end's: with one end left the
tie takes the clocks' rates as equal (they drift by microseconds over a
segment of seconds).
Every device operation (kernel, copy, set) is then placed on the host
clock and given to the benchmark's span that was open when it started:
each span ends in a host sync, so the operations a span launched run
inside it.

The profiler runs only after the measured window: a process that has been
traced launches more slowly afterwards.
"""

from __future__ import annotations

import bisect
import re
import time
from typing import Dict, List, Optional, Sequence, Tuple

MARK_CYCLES = {"start": 4_000, "end": 400_000}    # ~2 µs and ~200 µs at 1.98 GHz
MARK_SPLIT_NS = 50_000                              # shorter: a start marker
MARKS_EACH = 3
MARK_NAME = "spin_kernel"
TOP = 10


class DeviceTrace:
    def __init__(self):
        self.prof = None
        self.marks: List[float] = []             # host times: start markers, then end ones
        self.events: List[Tuple[str, int, int]] = []

    def _mark(self, which: str) -> None:
        import torch
        for _ in range(MARKS_EACH):
            torch.cuda.synchronize()
            self.marks.append(time.perf_counter())
            torch.cuda._sleep(MARK_CYCLES[which])
        torch.cuda.synchronize()

    def start(self) -> None:
        import torch
        self.prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
        self.prof.start()
        torch.cuda.synchronize()
        time.sleep(0.05)
        self._mark("start")

    def stop(self) -> None:
        import torch
        self._mark("end")
        time.sleep(0.05)
        self.prof.stop()
        cuda = torch.autograd.DeviceType.CUDA
        for e in self.prof.profiler.kineto_results.events():
            if e.device_type() != cuda:
                continue
            t0 = e.start_ns() if hasattr(e, "start_ns") else int(e.start_us() * 1000)
            dur = e.duration_ns() if hasattr(e, "duration_ns") else int(e.duration_us() * 1000)
            self.events.append((e.name(), t0, t0 + dur))
        self.prof = None


def short_name(name: str) -> str:
    """A kernel's name without `void `, `(anonymous namespace)::`, its
    parameter list (the last top-level parenthesis) and long template
    arguments."""
    n = re.sub(r"^void ", "", name).replace("(anonymous namespace)::", "")
    if n.endswith(")"):
        depth = 0
        for i in range(len(n) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(n[i], 0)
            if depth == 0:
                n = n[:i]
                break
    return n if len(n) <= 64 else n[:61] + "..."


def _tie(dev: List[int], host: Sequence[float]):
    """(host time, device time) of one end's markers: their means where all
    came through, else the first of each (off by at most the markers'
    spacing, tens of µs)."""
    if len(dev) == len(host):
        return sum(host) / len(host), sum(dev) / len(dev)
    return host[0], dev[0]


def summarize(events: Sequence[Tuple[str, int, int]], marks: Sequence[float],
              spans: Sequence) -> Optional[dict]:
    """events: (name, start ns, end ns) on the device clock; marks: the host
    times of the start markers, then of the end markers; spans: the traced
    segment's spans (t0, t1, kind on the host clock).  → busy_s, window_s,
    each operation placed on the host clock with the kind of span it ran
    in (None: none), the idle gaps likewise; None where no marker came
    through."""
    ms = sorted((e for e in events if MARK_NAME in e[0]), key=lambda e: e[1])
    starts_d = [e[1] for e in ms if e[2] - e[1] < MARK_SPLIT_NS]
    ends_d = [e[1] for e in ms if e[2] - e[1] >= MARK_SPLIT_NS]
    half = len(marks) // 2
    if not (starts_d or ends_d) or half == 0:
        return None
    ties = ([_tie(starts_d, marks[:half])] if starts_d else []) + \
        ([_tie(ends_d, marks[half:])] if ends_d else [])
    (ha, da), (hb, db) = ties[0], ties[-1]
    rate = (hb - ha) / (db - da) if db > da else 1e-9       # host s a device ns

    def host(t_ns: int) -> float:
        return ha + (t_ns - da) * rate

    # the segment: first marker to last (a lost end: its host mark's time)
    d0 = starts_d[0] if starts_d else da + (marks[0] - ha) / rate
    d1 = ends_d[-1] if ends_d else da + (marks[-1] - ha) / rate
    h0, h1 = host(d0), host(d1)

    order = sorted(spans, key=lambda s: s.t0)
    starts = [s.t0 for s in order]

    def span_of(t: float):
        i = bisect.bisect_right(starts, t) - 1
        return order[i] if i >= 0 and t <= order[i].t1 else None

    ops = []
    for name, a, b in events:
        if MARK_NAME in name:
            continue
        a, b = max(a, d0), min(b, d1)
        if b <= a:
            continue
        s = span_of(host(a))
        ops.append((name, host(a), (b - a) * rate, s.kind if s is not None else None))
    ivs = sorted((o[1], o[1] + o[2]) for o in ops)
    busy, gaps, cur_a, cur_b = 0.0, [], h0, h0
    for a, b in ivs:
        if a > cur_b:
            busy += cur_b - cur_a
            if a - cur_b > 0:
                gaps.append((cur_b, a))
            cur_a, cur_b = a, b
        else:
            cur_b = max(cur_b, b)
    busy += cur_b - cur_a
    if h1 > cur_b:
        gaps.append((cur_b, h1))
    named_gaps = []                  # each gap split over the host spans it overlaps
    for a, b in gaps:
        inside = 0.0
        for s in order[max(0, bisect.bisect_right(starts, a) - 1):]:
            if s.t0 >= b:
                break
            part = min(b, s.t1) - max(a, s.t0)
            if part > 0:
                named_gaps.append((s.kind + " (inside the call)", part))
                inside += part
        if b - a - inside > 0:
            named_gaps.append(("scheduler (host between calls)", b - a - inside))
    return {"busy_s": busy, "window_s": h1 - h0, "ops": ops, "gaps": named_gaps}


def breakdown(summary: dict) -> dict:
    by_op: Dict[str, float] = {}
    for name, _, dur, _ in summary["ops"]:
        k = short_name(name)
        by_op[k] = by_op.get(k, 0.0) + dur
    by_gap: Dict[str, float] = {}
    for name, dur in summary["gaps"]:
        by_gap[name] = by_gap.get(name, 0.0) + dur
    top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]  # noqa: E731
    return {"device_ops": top(by_op), "idle_gaps": top(by_gap)}
