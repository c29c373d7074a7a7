"""Chrome trace-event profiler, device traces and the per-layer benchmark
(counterpart of csinn2_tpu/runtime/profiler.py).

Re-expression of the reference's trace subsystem (ref:
include/shl_profiler.h:42-70 — event phases B/E/X/i/C, categories
runtime/op/memory/kernel; writer source/utils/shl_profiler.c:283,374
emitting `model_csinn.trace.<ts>.json`; per-layer timing
source/graph_ref/setup.c:1333 with printer source/utils/debug.c:1037-1052).

Three parts:
  * Tracer — host-side chrome://tracing JSON events around session verbs
    and layers (the JAX package's pure-Python class), extended with nested
    spans on time.perf_counter_ns()'s clock and running totals, which the
    serving engine records (llm/engine.py InferenceEngine.tracer);
  * device_trace — a torch.profiler trace (CPU and CUDA activities)
    exported as a Chrome trace in which each CUDA kernel appears under its
    own name (`qmm_*`, `dsconv_kernel<…>`, `attn_*`): the counterpart of
    the JAX package's XPlane trace;
  * LayerBenchmark — each node timed standalone on inputs captured from one
    replay.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import tempfile
import threading
import time
from typing import Any, Dict, List, Optional

import torch


class TraceEvent:
    """One event; `ts` and `dur` in ns, `ts` on time.perf_counter_ns()'s
    clock.  A span ("X") has an `id` and its `parent`'s (None at the top)."""

    __slots__ = ("name", "cat", "ph", "ts", "dur", "args", "id", "parent")

    def __init__(self, name, cat, ph, ts, dur=None, args=None, id=None, parent=None):
        self.name, self.cat, self.ph, self.ts, self.dur, self.args = \
            name, cat, ph, ts, dur, args
        self.id, self.parent = id, parent

    def to_dict(self, pid, tid, origin_ns: int = 0):
        """The Chrome event, `ts` and `dur` in µs, `ts` from origin_ns."""
        d = {"name": self.name, "cat": self.cat, "ph": self.ph,
             "ts": (self.ts - origin_ns) / 1e3, "pid": pid, "tid": tid}
        if self.dur is not None:
            d["dur"] = self.dur / 1e3
        args = dict(self.args or {})
        if self.id is not None:
            args.update(id=self.id, parent=self.parent)
        if args:
            d["args"] = args
        return d


class Tracer:
    """Collects chrome trace events (phases: X complete, i instant, C
    counter — ref: shl_profiler.h:54-70) and running totals.

    Every event is stamped with time.perf_counter_ns(), the clock
    time.perf_counter() reads, so a span can be laid over anything timed on
    it; save() writes `ts` from `origin_ns` and puts origin_ns in otherData.
    A span records its parent: the span open on the same thread when it
    began.  begin / phase / end are the explicit form, for call sites that
    must cost nothing when no Tracer is given; event() is the `with` form.
    add() keeps a total per name (`totals`), written once by save().
    Events stay in memory until saved."""

    def __init__(self, session_name: str = "model"):
        self.session_name = session_name
        self.events: List[TraceEvent] = []
        self.totals: Dict[str, float] = {}
        self.origin_ns = time.perf_counter_ns()
        self._ids = itertools.count()
        self._local = threading.local()     # .open: this thread's open spans, innermost last
        self._lock = threading.Lock()

    def _open(self) -> List[TraceEvent]:
        try:
            return self._local.open
        except AttributeError:
            self._local.open = []
            return self._local.open

    def _push(self, stack: List[TraceEvent], name, cat, args, t: int) -> None:
        stack.append(TraceEvent(name, cat, "X", t, None, args, next(self._ids),
                                stack[-1].id if stack else None))

    def _close(self, ev: TraceEvent, t: int) -> TraceEvent:
        ev.dur = t - ev.ts
        with self._lock:
            self.events.append(ev)
        return ev

    def begin(self, name: str, cat: str = "op", args: Optional[Dict[str, Any]] = None) -> None:
        """Open a span inside the innermost open one."""
        self._push(self._open(), name, cat, args, time.perf_counter_ns())

    def end(self, args: Optional[Dict[str, Any]] = None) -> TraceEvent:
        """Close the innermost open span, adding `args` to its own."""
        ev = self._open().pop()
        if args:
            ev.args = {**(ev.args or {}), **args}
        return self._close(ev, time.perf_counter_ns())

    def phase(self, name: str, cat: str = "op", args: Optional[Dict[str, Any]] = None) -> None:
        """Close the innermost open span and open `name` in its place, at
        the same instant: consecutive phases of one parent."""
        stack = self._open()
        t = time.perf_counter_ns()
        self._close(stack.pop(), t)
        self._push(stack, name, cat, args, t)

    @contextlib.contextmanager
    def event(self, name: str, cat: str = "op", args: Optional[Dict[str, Any]] = None):
        self.begin(name, cat, args)
        try:
            yield
        finally:
            self.end()

    def spans(self, name: Optional[str] = None) -> List[TraceEvent]:
        """The closed spans (all, or those called `name`), in closing order."""
        return [e for e in self.events if e.ph == "X" and (name is None or e.name == name)]

    def add(self, name: str, n: float = 1) -> None:
        with self._lock:
            self.totals[name] = self.totals.get(name, 0) + n

    def instant(self, name: str, cat: str = "runtime", args=None):
        with self._lock:
            self.events.append(TraceEvent(name, cat, "i", time.perf_counter_ns(), None, args))

    def counter(self, name: str, value: float, cat: str = "memory"):
        with self._lock:
            self.events.append(TraceEvent(name, cat, "C", time.perf_counter_ns(), None,
                                          {"value": value}))

    def save(self, path: Optional[str] = None) -> str:
        """Write `model_csinn.trace.<ts>.json` (ref: shl_profiler.c:283)."""
        if path is None:
            path = f"model_csinn.trace.{int(time.time())}.json"
        with self._lock:
            events = [e.to_dict(pid=os.getpid(), tid=0, origin_ns=self.origin_ns)
                      for e in self.events]
            totals = dict(self.totals)
        doc = {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "otherData": {"session": self.session_name, "framework": "csinn2_tpu_torch",
                          "origin_ns": self.origin_ns, "clock": "time.perf_counter_ns",
                          "totals": totals},
        }
        with open(path, "w") as f:
            json.dump(doc, f)
        return path


@contextlib.contextmanager
def device_trace(logdir: Optional[str] = None, device="cuda"):
    """Trace the block with torch.profiler — CPU activity, and CUDA activity
    on the card — and export it as a Chrome trace, `<logdir>/trace.json`
    (default logdir: csinn2_tpu_torch_trace under the temp directory).
    Yields that path; `kernel_times` sums its kernels' device time by name.
    Raises without a card unless device="cpu".

    Once torch.profiler has traced a process, host-side launches in it stay
    slower: time end to end in a process that has not been traced."""
    from csinn2_tpu_torch.utils.device import resolve_device
    dev = resolve_device(device)
    logdir = logdir or os.path.join(tempfile.gettempdir(), "csinn2_tpu_torch_trace")
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, "trace.json")
    activities = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield path
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    prof.export_chrome_trace(path)


def kernel_times(trace_path: str) -> Dict[str, float]:
    """Device milliseconds by kernel name in a Chrome trace that
    device_trace exported (its "kernel" category events), largest first."""
    with open(trace_path) as f:
        doc = json.load(f)
    events = doc["traceEvents"] if isinstance(doc, dict) else doc
    totals: Dict[str, float] = {}
    for e in events:
        if e.get("cat") == "kernel" and e.get("ph") == "X":
            totals[e["name"]] = totals.get(e["name"], 0.0) + float(e.get("dur", 0.0)) / 1e3
    return dict(sorted(totals.items(), key=lambda kv: -kv[1]))


class LayerBenchmark:
    """Per-layer timing — the analog of the reference's per-node timer loop
    (SHL_LAYER_BENCHMARK, setup.c:1333-1357).

    Each node is timed STANDALONE: its concrete inputs are captured from
    one eager replay of the graph, then the node's exec function runs n
    times back to back.  The time is the long-minus-short marginal
    (utils/timing.long_minus_short): on the card by CUDA events on the
    current stream, so per-call set-up cancels; on the CPU by the host
    clock.  A node alone pays its own launches, and the sum over nodes can
    differ from the whole forward's time (which run_benchmark_device
    gives): the split says where a forward's time goes, not its total.
    """

    def __init__(self, session):
        self.session = session

    def run(self, *input_arrays, iters: int = 48, reps: int = 3,
            min_us: float = 0.0) -> Dict[str, float]:
        """Returns {"<idx> <name>": milliseconds} per node.  min_us skips
        reporting nodes cheaper than the threshold (still measured)."""
        from csinn2_tpu_torch.graph.ir import _const_key
        from csinn2_tpu_torch.utils.timing import long_minus_short
        sess = self.session
        graph = sess.graph
        captured: List[list] = []
        # one eager replay collects every node's concrete inputs
        env: Dict[int, Any] = {id(t): a for t, a in zip(graph.inputs,
                                                         sess._inputs(input_arrays))}
        with torch.inference_mode():
            for node in graph.nodes:
                args = [env[id(t)] if id(t) in env else sess._consts.get(_const_key(t), t.data)
                        for t in node.inputs]
                captured.append(args)
                res = node.exec_fn(args)
                if not isinstance(res, (tuple, list)):
                    res = (res,)
                for t, r in zip(node.outputs, res):
                    env[id(t)] = r

            results: Dict[str, float] = {}
            for k, (node, args) in enumerate(zip(graph.nodes, captured)):
                def fn(n, _node=node, _args=args):
                    for _ in range(n):
                        _node.exec_fn(list(_args))
                dt = long_minus_short(fn, short=3, iters=iters, reps=reps,
                                      device=sess.device)
                if dt * 1e6 >= min_us:
                    results[f"{k:3d} {node.name}"] = dt * 1e3
        return results

    def print_report(self, results: Dict[str, float]):
        """(ref: shl_benchmark_layer printer, source/utils/debug.c:1037-1052)."""
        total = sum(results.values())
        print(f"{'layer':<40} {'ms':>10} {'%':>6}")
        for name, ms in sorted(results.items(), key=lambda kv: -kv[1]):
            pct = 100.0 * ms / total if total else 0.0
            print(f"{name:<40} {ms:>10.4f} {pct:>5.1f}%")
        print(f"{'TOTAL (standalone sum)':<40} {total:>10.4f}")
