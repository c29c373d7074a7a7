"""The rate and tail arithmetic, over a hand-made window: every request and
every token of the window counts, none after it."""

import statistics

import pytest

from portbench import stats
from portbench.record import Recorder, Span
from portbench.run import load_reader
from portbench.traffic import Spec


class View:
    def __init__(self, rec, dims=None):
        self.rec, self.dims, self.trace, self.setup_s = rec, dims, None, 1.0


def _rec():
    """batch 2, window [100, 110]: requests 0, 1 at the start; 2 is sent
    at the first completion (t 104), 3 at the second (t 106)."""
    specs = [Spec([1] * 10, 5, 0.0), Spec([1] * 20, 3, 0.0), Spec([1] * 8, 4, 0.0),
             Spec([1] * 8, 9, 0.0)]
    rec = Recorder(specs, batch=2, seconds=10.0)
    rec.t_run, rec.start, rec.deadline = 100.0, 100.0, 110.0
    r = rec.reqs
    r[0].t_first, r[0].t_done = 101.0, 104.0
    r[1].t_first, r[1].t_done = 102.0, 106.0
    r[2].t_first, r[2].t_done = 105.0, 111.0      # finishes after the window
    r[3].t_first = 108.0
    rec.completions = [104.0, 106.0, 111.0]
    rec.arrivals = [(101.0, 1), (102.0, 1), (104.0, 6), (105.0, 1), (106.0, 4), (108.0, 1),
                    (111.0, 9)]
    return rec


def test_send_times_follow_completions():
    rec = _rec()
    assert [rec.send_time(k) for k in range(4)] == [100.0, 100.0, 104.0, 106.0]


def test_ttft_over_every_request_of_the_window():
    assert stats.ttfts_ms(_rec()) == pytest.approx([1000.0, 2000.0, 1000.0, 2000.0])


def test_tpot_over_the_requests_finished_in_the_window():
    assert stats.tpots_ms(_rec()) == pytest.approx([3000.0 / 4, 4000.0 / 2])


def test_tails_leave_out_what_came_before_a_warm_in():
    """The window opens at t 104.5, after the first completion (a warm-in
    of one): requests 0 and 1 had their first tokens before it, and 0 also
    finished before it; neither tail counts what came before the window."""
    rec = _rec()
    rec.start = 104.5
    assert stats.ttfts_ms(rec) == pytest.approx([1000.0, 2000.0])
    assert stats.tpots_ms(rec) == pytest.approx([4000.0 / 2])
    assert load_reader("e2e", "ttft_p95_ms").read(View(rec)) == pytest.approx(1950.0)
    assert load_reader("metrics", "sched.ttft_short_p95_ms").read(View(rec)) == \
        pytest.approx(1950.0)


def test_p95_is_linear_between_order_statistics():
    v = list(range(1, 101))
    assert stats.percentile(v, 95) == pytest.approx(95.05)
    assert stats.percentile(v, 95) == statistics.quantiles(v, n=100, method="inclusive")[94]
    assert stats.percentile([3.0], 95) is None


def test_output_rate_counts_tokens_inside_the_window_only():
    """Up to the last arrival inside the window (t 108); the lump at 111
    is past it."""
    v = load_reader("e2e", "output_tok_s").read(View(_rec()))
    assert v == pytest.approx((1 + 1 + 6 + 1 + 4 + 1) / 8.0)


def test_lane_occupancy_and_step_time():
    rec = _rec()
    rec.spans = [Span("decode", 103.0, 104.0, "window", n_steps=4, lanes=[(10, 4), (20, 2)]),
                 Span("decode", 105.0, 105.5, "window", n_steps=2, lanes=[(8, 2), (22, 1)]),
                 Span("decode", 109.5, 110.5, "window", n_steps=4, lanes=[(9, 4), (23, 4)])]
    view = View(rec)
    occ = load_reader("metrics", "sched.lane_occupancy").read(view)
    assert occ == pytest.approx(100.0 * (4 + 2 + 2 + 1) / (2 * (4 + 2)))
    step = load_reader("metrics", "decode.step_ms").read(view)
    assert step == pytest.approx(1500.0 / 6)


def test_step_positions_leave_out_lanes_past_their_last_token():
    span = Span("decode", 0, 1, "window", n_steps=3, lanes=[(10, 3), (20, 1)])
    assert list(stats.step_positions(span)) == [[10, 20], [11], [12]]
