"""prefill.graph_share (metrics/prefill.graph_share.py): the engine's
prefill.graph_replays over its "prefill" spans in the traced segment, on
hand-made runs, and nothing where the engine counts no replay (an eager
prefill, as on the CPU, or an engine without prefill graphs)."""

import json

import pytest
import torch

from portbench import devtrace, progspans, traffic, weights
from portbench.record import Recorder
from portbench.run import RunView, load_reader
from portbench.tests.helpers import DATA
from portbench.tests.test_portbench_progspans import _Ev, _FakeDeviceTrace, _Prog, _View
from portbench.traffic import Spec

TRACE = {"busy_s": 1.0, "window_s": 4.0, "ops": [("gemm", 10.2, 0.4, "prefill")],
         "gaps": [("prefill (inside the call)", 0.6)]}


def _view(totals, n_prefills=2, trace=TRACE):
    rec = Recorder([Spec([1], 2, 0.0)], batch=4, seconds=1.0)
    rec.program_tracer = _Prog(
        [_Ev("prefill", 10.0 + i, 10.5 + i) for i in range(n_prefills)], totals)
    return _View(trace, rec)


@pytest.mark.parametrize("replays,share", [(2, 100.0), (1, 50.0), (0, 0.0)])
def test_graph_share_by_hand(replays, share):
    view = _view({"prefill.tokens": 40, "prefill.graph_replays": replays})
    assert load_reader("metrics", "prefill.graph_share").read(view) == pytest.approx(share)


@pytest.mark.parametrize("totals,n_prefills,trace", [
    ({"prefill.tokens": 40}, 2, TRACE),                # no counter: the eager prefill
    ({"prefill.graph_replays": 2}, 0, TRACE),          # no prefill span in the segment
    ({"prefill.graph_replays": 2}, 2, None),           # no device trace
])
def test_graph_share_reads_nothing(totals, n_prefills, trace):
    view = _view(totals, n_prefills, trace)
    assert load_reader("metrics", "prefill.graph_share").read(view) is None


def test_graph_share_reads_nothing_for_the_eager_prefill_on_the_cpu():
    """The tiny cell served on the CPU: the engine's prefills are traced and
    eager, so the reader reads nothing while prefill.pad_share reads."""
    from portbench.drivers import llm_serve
    progspans.hook()
    with open(DATA / "configs" / "tiny-q4_0.json") as f:
        d = weights.dims(json.load(f))
    mix = traffic.load_mix("tiny", root=DATA)
    fake = _FakeDeviceTrace()
    served = llm_serve.serve(d, mix, 5, 0.3, torch.device("cpu"), tracer=fake,
                             trace_seconds=0.05)
    prog = served.rec.program_tracer
    assert prog.spans("prefill")
    assert not any(k.startswith("prefill.graph_") for k in prog.totals)
    summary = devtrace.summarize(fake.events, fake.marks, served.rec.trace_spans())
    view = RunView(served, 1.0, summary)
    assert load_reader("metrics", "prefill.graph_share").read(view) is None
    assert load_reader("metrics", "prefill.pad_share").read(view) is not None
