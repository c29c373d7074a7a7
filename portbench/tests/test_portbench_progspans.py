"""The engine's spans laid over the device trace (progspans.py): idle time
inside spans on hand-made operations (clipped at the span's edges, nested
children, a span with no operation), the five readers on a hand-made run,
and the hook on the CPU: the tiny cell served with a stand-in DeviceTrace,
the engine traced inside the segment only, its prefills inside the
benchmark's."""

import time

import pytest
import torch

from portbench import devtrace, progspans, traffic, weights
from portbench.record import Recorder, Span
from portbench.run import RunView, load_reader
from portbench.tests.helpers import DATA
from portbench.traffic import Spec

NEW = ("prefill.idle_share", "decode.idle_share", "prefill.pad_share",
       "sched.chunk_tail_share", "sched.lane_wait_ms")


def test_busy_union_merges_overlaps_and_touches():
    ops = [(5.0, 1.0), (1.0, 2.0), (2.5, 1.0), (3.5, 0.5), (8.0, 0.0)]
    assert progspans.busy_union(ops) == [(1.0, 4.0), (5.0, 6.0), (8.0, 8.0)]


def test_idle_by_span_by_hand():
    """Operations 1-3, 2.5-3.5 (overlapping), 5-6, 9-12.  A parent 0-10 and
    its children 0-2 and 2-7 (phases), a span 6.5-8.5 with no operation,
    a span 10-11 inside one operation."""
    ops = [(1.0, 2.0), (2.5, 1.0), (5.0, 1.0), (9.0, 3.0)]
    spans = [("p", 0.0, 10.0), ("p.a", 0.0, 2.0), ("p.b", 2.0, 7.0),
             ("empty", 6.5, 8.5), ("inside", 10.0, 11.0), ("p.a", 2.75, 3.25)]
    got = progspans.span_idle(ops, spans)
    # p: busy 1-3.5, 5-6, 9-10 (the last op clipped at the span's end)
    assert got["p"] == pytest.approx((10.0, 10.0 - 2.5 - 1.0 - 1.0, 1))
    # p.a: 0-2 busy 1-2 → idle 1; 2.75-3.25 all busy → idle 0
    assert got["p.a"] == pytest.approx((2.5, 1.0, 2))
    # p.b: 2-7, busy 2-3.5 (clipped at its start) and 5-6 → idle 2.5
    assert got["p.b"] == pytest.approx((5.0, 2.5, 1))
    assert got["empty"] == pytest.approx((2.0, 2.0, 1))
    assert got["inside"] == pytest.approx((1.0, 0.0, 1))
    # the children's idle adds up to the parent's over the part they cover
    assert got["p.a"][1] - 0.0 + got["p.b"][1] == pytest.approx(1.0 + 2.5)


def test_no_operation_at_all():
    assert progspans.span_idle([], [("s", 1.0, 3.0)]) == {"s": (2.0, 2.0, 1)}
    assert progspans.span_idle([(0.0, 1.0)], []) == {}


class _Ev:
    def __init__(self, name, t0, t1, args=None):
        self.name, self.ts, self.dur, self.args = name, int(t0 * 1e9), int((t1 - t0) * 1e9), args


class _Prog:
    """A stand-in for the engine's Tracer: closed spans and totals."""

    def __init__(self, events, totals):
        self.events, self.totals = events, totals

    def spans(self):
        return self.events


class _View:
    def __init__(self, trace, rec):
        self.trace, self.rec, self.dims, self.setup_s = trace, rec, None, 1.0


def _run(with_prog=True, with_trace=True):
    rec = Recorder([Spec([1], 2, 0.0)], batch=4, seconds=1.0)
    rec.spans = [Span("prefill", 9.9, 11.1, "trace", n_prompt=20)]
    if with_prog:
        rec.program_tracer = _Prog(
            [_Ev("prefill.forward", 10.0, 10.5), _Ev("prefill", 10.0, 11.0),
             _Ev("decode.launch", 12.0, 12.9), _Ev("decode.chunk", 12.0, 13.0)],
            {"prefill.tokens": 20, "prefill.pad_tokens": 12, "decode.lane_steps": 64,
             "decode.lane_steps_idle": 8, "decode.lane_steps_past_end": 6,
             "sched.lane_wait_ns": 3_000_000, "sched.lane_waits": 2})
    trace = {"busy_s": 1.0, "window_s": 4.0,
             "ops": [("gemm", 10.2, 0.4, "prefill"), ("step", 12.1, 0.8, "decode")],
             "gaps": [("prefill (inside the call)", 0.8)]}
    return _View(trace if with_trace else None, rec)


def test_the_readers_by_hand(capsys):
    view = _run()
    got = {name: load_reader("metrics", name).read(view) for name in NEW}
    assert got["prefill.idle_share"] == pytest.approx(100 * 0.6 / 1.0)
    assert got["decode.idle_share"] == pytest.approx(100 * 0.2 / 1.0)
    assert got["prefill.pad_share"] == pytest.approx(100 * 12 / 32)
    assert got["sched.chunk_tail_share"] == pytest.approx(100 * 6 / 64)
    assert got["sched.lane_wait_ms"] == pytest.approx(1.5)
    err = capsys.readouterr().err
    assert err.count("program spans") == 1                 # printed once a run
    assert "prefill.forward 0.200000/0.500000s x1" in err
    assert "engine prefills 1 (1 inside a benchmark prefill span), benchmark prefills 1" in err


@pytest.mark.parametrize("prog,trace", [(False, True), (True, False)])
def test_the_readers_read_nothing_without_the_engine_tracer_or_a_trace(prog, trace):
    view = _run(prog, trace)
    assert all(load_reader("metrics", name).read(view) is None for name in NEW)


class _FakeDeviceTrace:
    """The DeviceTrace's interface without a profiler: host marks at start
    and stop, and marker kernels on a device clock equal to the host's."""

    def __init__(self):
        self.marks, self.events = [], []

    def _mark(self, cycles_ns):
        for _ in range(3):
            t = time.perf_counter()
            self.marks.append(t)
            self.events.append((devtrace.MARK_NAME, int(t * 1e9), int(t * 1e9) + cycles_ns))

    def start(self):
        self._mark(2_000)

    def stop(self):
        self._mark(200_000)


def test_the_hook_traces_the_segment_alone_on_the_cpu():
    from portbench.drivers import llm_serve
    import json
    progspans.hook()
    progspans.hook()                                   # idempotent
    with open(DATA / "configs" / "tiny-q4_0.json") as f:
        d = weights.dims(json.load(f))
    mix = traffic.load_mix("tiny", root=DATA)
    fake = _FakeDeviceTrace()
    served = llm_serve.serve(d, mix, 5, 0.3, torch.device("cpu"), tracer=fake,
                             trace_seconds=0.05)
    rec = served.rec
    prog = rec.program_tracer
    seg0, seg1 = fake.marks[2], fake.marks[3]
    assert prog.spans("prefill") and prog.spans("decode.chunk")
    for e in prog.spans():
        assert seg0 * 1e9 <= e.ts and e.ts + e.dur <= seg1 * 1e9
    ours = sorted((e.ts / 1e9, (e.ts + e.dur) / 1e9) for e in prog.spans("prefill"))
    theirs = sorted((s.t0, s.t1) for s in rec.trace_spans("prefill"))
    assert len(ours) == len(theirs)
    assert all(b0 <= a0 and a1 <= b1 for (a0, a1), (b0, b1) in zip(ours, theirs))
    summary = devtrace.summarize(fake.events, fake.marks, rec.trace_spans())
    view = RunView(served, 1.0, summary)
    # no device operation: every engine span is idle throughout
    assert load_reader("metrics", "prefill.idle_share").read(view) == pytest.approx(100.0)
    pre = prog.spans("prefill")
    pad = sum(e.args["bucket"] - e.args["n_prompt"] for e in pre)
    assert load_reader("metrics", "prefill.pad_share").read(view) == pytest.approx(
        100 * pad / sum(e.args["bucket"] for e in pre))
    assert prog.totals["decode.lane_steps"] == d["batch"] * sum(
        s.n_steps for s in rec.trace_spans("decode")[:len(prog.spans("decode.chunk"))])


def test_an_engine_without_a_tracer_attribute_gets_none():
    """The parent's engine has no `tracer`: the hook leaves it alone."""
    progspans.hook()

    class Old:
        def prefill_sample(self, *a, **k):
            return 0

        def decode_steps(self, *a, **k):
            return {}

    rec = Recorder([Spec([1], 2, 0.0)], batch=1, seconds=1.0, tracer=_FakeDeviceTrace())
    eng = Old()
    rec.install(eng)
    assert not hasattr(rec, "program_tracer") and not hasattr(eng, "tracer")
