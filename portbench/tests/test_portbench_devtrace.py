"""The trace reading on a hand-made segment: host/device clock tie by the
marker kernels, busy time as the union of intervals, each operation and
idle gap given to the span that was open, and the readers on top."""

import pytest

from portbench import devtrace
from portbench.record import Recorder, Span
from portbench.run import load_reader
from portbench.traffic import Spec

MS = 1_000_000          # ns


US = 1_000


def _segment():
    """Device clock 1000 ms ahead of the host's; three start markers from
    host 10.000 s, 50 µs apart, three long end markers from 10.100 s, 300 µs
    apart.  A decode span 10.010-10.060 s, a prefill 10.065-10.095 s."""
    marks = [10.0, 10.00005, 10.0001, 10.1, 10.1003, 10.1006]
    ev = [("spin_kernel", 11_000 * MS + i * 50 * US, 11_000 * MS + i * 50 * US + 2 * US)
          for i in range(3)]
    ev += [("void qmm_decode_kernel<1, true>(int, float*)", 11_012 * MS, 11_022 * MS),
           ("decode_attn_kernel(int)", 11_020 * MS, 11_030 * MS),     # overlaps the GEMM
           ("attn_combine_kernel", 11_040 * MS, 11_045 * MS),
           ("elementwise", 11_070 * MS, 11_090 * MS)]
    ev += [("spin_kernel", 11_100 * MS + i * 300 * US, 11_100 * MS + i * 300 * US + 200 * US)
           for i in range(3)]
    spans = [Span("decode", 10.010, 10.060, "trace", n_steps=2, lanes=[(100, 2), (50, 1)]),
             Span("prefill", 10.065, 10.095, "trace", n_prompt=20)]
    return ev, marks, spans


def test_summary_ties_the_clocks_and_unions_the_busy_time():
    ev, marks, spans = _segment()
    s = devtrace.summarize(ev, marks, spans)
    assert s["window_s"] == pytest.approx(0.1006)
    assert s["busy_s"] == pytest.approx(0.018 + 0.005 + 0.020)
    kinds = {name: kind for name, _, _, kind in s["ops"]}
    assert kinds["decode_attn_kernel(int)"] == "decode" and kinds["elementwise"] == "prefill"
    gaps = dict(devtrace.breakdown(s)["idle_gaps"])
    # gaps 10.000-10.012, 10.030-10.040, 10.045-10.070, 10.090-10.100, split over the spans
    assert gaps["decode (inside the call)"] == pytest.approx(0.002 + 0.010 + 0.015)
    assert gaps["scheduler (host between calls)"] == pytest.approx(0.010 + 0.005 + 0.0056)
    assert gaps["prefill (inside the call)"] == pytest.approx(0.005 + 0.005)
    ops = dict(devtrace.breakdown(s)["device_ops"])
    assert ops["qmm_decode_kernel<1, true>"] == pytest.approx(0.010)


def test_no_markers_no_summary():
    ev, marks, spans = _segment()
    assert devtrace.summarize(ev[3:-3], marks, spans) is None


@pytest.mark.parametrize("keep", ["start", "end"])
def test_one_end_of_markers_is_enough(keep):
    """A whole end's markers lost: the clocks tie at the other end, the
    segment ends at the lost end's host mark."""
    ev, marks, spans = _segment()
    s = devtrace.summarize(ev[:-3] if keep == "start" else ev[3:], marks, spans)
    assert s["busy_s"] == pytest.approx(0.043, abs=1e-4)
    assert s["window_s"] == pytest.approx(0.1006, abs=2e-4)
    kinds = {name: kind for name, _, _, kind in s["ops"]}
    assert kinds["elementwise"] == "prefill" and kinds["attn_combine_kernel"] == "decode"


def test_a_lost_marker_leaves_the_tie():
    ev, marks, spans = _segment()
    s = devtrace.summarize(ev[1:-1], marks, spans)
    assert s["busy_s"] == pytest.approx(0.043, abs=1e-4)
    kinds = {name: kind for name, _, _, kind in s["ops"]}
    assert kinds["elementwise"] == "prefill"


def test_short_name_drops_params_and_void():
    assert devtrace.short_name("void k<a(b), 2>(float*, int)") == "k<a(b), 2>"
    assert devtrace.short_name("void (anonymous namespace)::qmm<(M)1>(Args)") == "qmm<(M)1>"
    assert devtrace.short_name("elementwise") == "elementwise"
    assert len(devtrace.short_name("x" * 200)) == 64


class View:
    def __init__(self, trace, rec, dims):
        self.trace, self.rec, self.dims = trace, rec, dims


def test_trace_readers():
    from portbench.tests.test_portbench_counts import MISTRAL
    from portbench import counts
    ev, marks, spans = _segment()
    rec = Recorder([Spec([1], 2, 0.0)], batch=16, seconds=1.0)
    rec.spans = spans
    s = devtrace.summarize(ev, marks, spans)
    view = View(s, rec, MISTRAL)
    idle = load_reader("metrics", "device.idle_share").read(view)
    assert idle == pytest.approx(100 * (1 - 0.043 / 0.1006))
    gemm = load_reader("metrics", "kern.decode_gemm_roofline").read(view)
    need = sum(counts.least_seconds(counts.decode_step(MISTRAL, p)["gemm"])
               for p in ([100, 50], [101]))
    assert gemm == pytest.approx(100 * need / 0.010)
    attn = load_reader("metrics", "kern.decode_attn_roofline").read(view)
    need = sum(counts.least_seconds(counts.decode_step(MISTRAL, p)["attn"])
               for p in ([100, 50], [101]))
    assert attn == pytest.approx(100 * need / 0.015)
    assert load_reader("metrics", "kern.decode_gemm_roofline").read(View(None, rec, MISTRAL)) is None
