"""What the harness sees of a served window: spans it sets around the
engine's own calls, each request's token arrivals, and the end of the
window — without a line of the program changed.

`Recorder.install(engine)` replaces the engine INSTANCE's prefill_sample
and decode_steps, the two calls run_queue makes, with wrappers that keep a
span (host clock; both calls end in a host sync, `int(tok)` and `.cpu()`,
so a span's end is when its tokens reached the host).  The k-th prefill is
the k-th request (run_queue admits in queue order); a slot keeps its
request until the request has all of its max_new_tokens.

The closed loop starts with every client sending at once; that burst is
not the steady state, so the window opens at the first wrapper return
after `warm_in` requests have completed (0: at once).  It closes at the
first wrapper return past its deadline, by raising WindowClosed out of
run_queue; requests in flight then count as attempted.  With a
DeviceTrace, the run goes on past the deadline for a traced segment
instead: the profiler starts at the first call after the deadline and
stops at the first return that has seen `trace_seconds`, a decode chunk
and a prefill (or, failing one, six times `trace_seconds`).  The window's
metrics read only spans that lie inside [start, deadline].
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

now = time.perf_counter


class WindowClosed(Exception):
    """Raised out of run_queue when the window (and any traced segment)
    is over."""


@dataclasses.dataclass
class Span:
    kind: str                      # "prefill" | "decode"
    t0: float
    t1: float
    phase: str                     # "warmin" | "window" | "trace" | "after"
    n_prompt: int = 0              # prefill: its real tokens
    n_steps: int = 0               # decode: steps run
    lanes: Optional[list] = None   # decode: [(p0, useful steps)] of active lanes


@dataclasses.dataclass
class ReqRec:
    n_prompt: int
    max_new: int
    greedy: bool
    t_first: Optional[float] = None
    t_done: Optional[float] = None
    delivered: int = 0


class Recorder:
    def __init__(self, specs, batch: int, seconds: float, tracer=None,
                 trace_seconds: float = 2.0, warm_in: int = 0):
        self.reqs = [ReqRec(len(s.prompt), s.max_new_tokens, s.temperature <= 0) for s in specs]
        self.batch = batch
        self.seconds = seconds
        self.tracer = tracer
        self.trace_seconds = trace_seconds
        self.warm_in = warm_in
        self.spans: List[Span] = []
        self.arrivals: List[tuple] = []          # (host time, tokens)
        self.completions: List[float] = []
        self.slot_req: Dict[int, int] = {}
        self.next_req = 0
        self.phase = "warmin"
        self.t_run = self.start = self.deadline = None
        self.seg = None                          # (start, end) of the traced segment

    # -- the window -----------------------------------------------------------

    def begin(self) -> None:
        self.t_run = now()
        if self.warm_in <= 0:
            self._open(self.t_run)

    def _open(self, t: float) -> None:
        self.start, self.deadline, self.phase = t, t + self.seconds, "window"

    def _enter(self) -> str:
        if self.phase == "window" and now() >= self.deadline:
            if self.tracer is None:
                raise WindowClosed()
            self.tracer.start()
            self.phase = "trace"
            self.seg = [self.tracer.marks[0], None]
        return self.phase

    def _leave(self, t1: float) -> None:
        if self.phase == "warmin":
            if len(self.completions) >= self.warm_in:
                self._open(t1)
            return
        if self.phase == "window" and t1 > self.deadline and self.tracer is None:
            raise WindowClosed()
        if self.phase != "trace":
            return
        seg = [s for s in self.spans if s.phase == "trace"]
        long_enough = t1 - self.seg[0] >= self.trace_seconds
        has_decode = any(s.kind == "decode" for s in seg)
        has_prefill = (any(s.kind == "prefill" for s in seg)
                       or t1 - self.seg[0] >= 6 * self.trace_seconds)
        if long_enough and has_decode and has_prefill:
            self.tracer.stop()
            self.seg[1] = self.tracer.marks[-1]
            self.phase = "after"
            raise WindowClosed()

    # -- the wrappers ---------------------------------------------------------

    def install(self, eng) -> None:
        prefill_sample, decode_steps = eng.prefill_sample, eng.decode_steps

        def prefill_wrapped(slot_id, prompt, *args, **kw):
            phase = self._enter()
            t0 = now()
            tok = prefill_sample(slot_id, prompt, *args, **kw)
            t1 = now()
            k = self.next_req
            self.next_req += 1
            r = self.reqs[k]
            if r.n_prompt != len(prompt):
                raise RuntimeError(f"prefill {k} took {len(prompt)} tokens, request {k} has "
                                   f"{r.n_prompt}: the scheduler did not admit in queue order")
            r.t_first, r.delivered = t1, 1
            self.slot_req[slot_id] = k
            self.arrivals.append((t1, 1))
            self.spans.append(Span("prefill", t0, t1, phase, n_prompt=len(prompt)))
            if r.delivered >= r.max_new:
                self._done(slot_id, t1)
            self._leave(t1)
            return tok

        def decode_wrapped(next_tokens, n_steps, *args, **kw):
            phase = self._enter()
            lanes = []
            for sid in next_tokens:
                r = self.reqs[self.slot_req[sid]]
                lanes.append((r.n_prompt + r.delivered - 1, min(n_steps, r.max_new - r.delivered)))
            t0 = now()
            out = decode_steps(next_tokens, n_steps, *args, **kw)
            t1 = now()
            got = 0
            for sid, (_, useful) in zip(next_tokens, lanes):
                r = self.reqs[self.slot_req[sid]]
                r.delivered += useful
                got += useful
                if r.delivered >= r.max_new:
                    self._done(sid, t1)
            self.arrivals.append((t1, got))
            self.spans.append(Span("decode", t0, t1, phase, n_steps=n_steps, lanes=lanes))
            self._leave(t1)
            return out

        eng.prefill_sample = prefill_wrapped
        eng.decode_steps = decode_wrapped

    def _done(self, sid: int, t: float) -> None:
        self.reqs[self.slot_req.pop(sid)].t_done = t
        self.completions.append(t)

    # -- what the readers take ------------------------------------------------

    def window_spans(self, kind: Optional[str] = None) -> List[Span]:
        return [s for s in self.spans if s.t0 >= self.start and s.t1 <= self.deadline
                and (kind is None or s.kind == kind)]

    def trace_spans(self, kind: Optional[str] = None) -> List[Span]:
        return [s for s in self.spans if s.phase == "trace" and (kind is None or s.kind == kind)]

    def send_time(self, k: int) -> Optional[float]:
        """Closed loop: the first `batch` requests go at the start, request
        k >= batch when the (k - batch)-th completion frees its client."""
        if k < self.batch:
            return self.t_run
        j = k - self.batch
        return self.completions[j] if j < len(self.completions) else None

    def attempted(self) -> int:
        """Requests sent by the deadline that had not finished before the
        window opened."""
        return sum(1 for k, r in enumerate(self.reqs)
                   if self.send_time(k) is not None and self.send_time(k) <= self.deadline
                   and (r.t_done is None or r.t_done >= self.start))
