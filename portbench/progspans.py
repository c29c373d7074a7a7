"""The program's own spans and counters in the traced segment: the
serving engine's `tracer` (csinn2_tpu_torch.runtime.profiler.Tracer; see
InferenceEngine's docstring for its spans and counters), laid over the
segment's device operations, which devtrace.summarize has placed on the
host clock.  Both are on time.perf_counter's clock, so an engine span needs
no tie of its own.

Idle time inside a span is its length minus the union of the device
operations clipped to it.

hook() gives the engine a Tracer for the traced segment alone: the
DeviceTrace instance's start and stop are wrapped so that the engine's
tracer is set after the start markers and cleared before the end markers.
The window itself (and every --trace 0 run) runs with no tracer.  The
readers that use this module call hook() when run.py loads them, which is
before it serves.  An engine without a `tracer` attribute gets none, and
the readers then read nothing.
"""

from __future__ import annotations

import bisect
import sys
import weakref
from typing import Dict, List, Optional, Sequence, Tuple


def hook() -> None:
    """Wrap Recorder.install so that a traced run's engine gets a Tracer,
    kept on the Recorder as `program_tracer` (idempotent)."""
    from portbench import record
    install = record.Recorder.install
    if getattr(install, "progspans", False):
        return

    def install_traced(self, eng):
        install(self, eng)
        if self.tracer is None or not hasattr(eng, "tracer"):
            return
        from csinn2_tpu_torch.runtime.profiler import Tracer
        prog = self.program_tracer = Tracer("serve")
        dev, ref = self.tracer, weakref.ref(eng)      # the engine is not kept alive
        start, stop = dev.start, dev.stop

        def start_traced():
            start()
            if ref() is not None:
                ref().tracer = prog

        def stop_traced():
            if ref() is not None:
                ref().tracer = None
            stop()

        dev.start, dev.stop = start_traced, stop_traced

    install_traced.progspans = True
    record.Recorder.install = install_traced


def busy_union(ops: Sequence[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """Disjoint sorted (start, end) intervals covering the (start, duration)
    operations."""
    out: List[List[float]] = []
    for a, d in sorted(ops):
        b = a + d
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def idle_in(busy: List[Tuple[float, float]], starts: List[float], t0: float, t1: float) -> float:
    """The part of [t0, t1] that no interval of `busy` (whose starts are
    `starts`) covers."""
    covered = 0.0
    for a, b in busy[max(0, bisect.bisect_right(starts, t0) - 1):]:
        if a >= t1:
            break
        covered += max(0.0, min(b, t1) - max(a, t0))
    return (t1 - t0) - covered


def span_idle(ops: Sequence[Tuple[float, float]],
              spans: Sequence[Tuple[str, float, float]]) -> Dict[str, Tuple[float, float, int]]:
    """{name: (seconds inside the spans so named, idle seconds there, count)}
    over (name, t0, t1) spans and (start, duration) operations, all in
    seconds on one clock."""
    busy = busy_union(ops)
    starts = [a for a, _ in busy]
    out: Dict[str, Tuple[float, float, int]] = {}
    for name, t0, t1 in spans:
        took, idle, n = out.get(name, (0.0, 0.0, 0))
        out[name] = (took + (t1 - t0), idle + idle_in(busy, starts, t0, t1), n + 1)
    return out


def _spans(tracer) -> List[Tuple[str, float, float]]:
    return [(e.name, e.ts / 1e9, (e.ts + e.dur) / 1e9) for e in tracer.spans()]


def summary(run) -> Optional[dict]:
    """The traced segment's engine spans by name (seconds, idle seconds,
    count) and the engine's counters; None without both a device trace and
    an engine tracer.  Computed once a run; the first call prints it on
    stderr, with the checks against the benchmark's own spans."""
    prog = getattr(run.rec, "program_tracer", None)
    if run.trace is None or prog is None:
        return None
    cached = getattr(run.rec, "progspans_summary", None)
    if cached is not None:
        return cached
    spans = _spans(prog)
    by_name = span_idle([(a, d) for _, a, d, _ in run.trace["ops"]], spans)
    res = {"spans": by_name, "totals": dict(prog.totals)}
    run.rec.progspans_summary = res
    _print(run, res, spans)
    return res


def _print(run, res: dict, spans) -> None:
    """One stderr line: idle seconds inside each engine span by name, the
    counters, and the two checks on the shared clock."""
    idle = " ".join(f"{k} {v[1]:.6f}/{v[0]:.6f}s x{v[2]}"
                    for k, v in sorted(res["spans"].items()))
    totals = " ".join(f"{k}={v}" for k, v in sorted(res["totals"].items()))
    ours = sorted((t0, t1) for name, t0, t1 in spans if name == "prefill")
    theirs = sorted((s.t0, s.t1) for s in run.rec.trace_spans("prefill"))
    inside = sum(any(b0 <= t0 and t1 <= b1 for b0, b1 in theirs) for t0, t1 in ours)
    outside_idle = sum(d for name, d in run.trace["gaps"] if name == "prefill (inside the call)")
    print(f"program spans (idle/total): {idle}; counters: {totals}; engine prefills "
          f"{len(ours)} ({inside} inside a benchmark prefill span), benchmark prefills "
          f"{len(theirs)}; idle in engine prefills "
          f"{res['spans'].get('prefill', (0, 0, 0))[1]:.6f} s, in benchmark prefills "
          f"{outside_idle:.6f} s", file=sys.stderr)


def idle_share(run, name: str) -> Optional[float]:
    """100 × idle seconds inside the engine's spans called `name` over their
    seconds, or None."""
    s = summary(run)
    if s is None or name not in s["spans"] or s["spans"][name][0] <= 0:
        return None
    took, idle, _ = s["spans"][name]
    return 100.0 * idle / took


def total(run, name: str) -> Optional[float]:
    """The engine's counter `name` over the traced segment, or None."""
    s = summary(run)
    return None if s is None else s["totals"].get(name)
