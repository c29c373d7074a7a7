"""The serving engine's own spans and counters (InferenceEngine.tracer, a
runtime/profiler.Tracer) on a tiny engine running run_queue on the CPU.

Gates: the same tokens with the tracer on and off, and no clock read
with it off (run_queue and every prefill entry point); every child span inside its parent and every prefill inside
an admission wave; one prefill a request with its index, prompt length and
bucket; the padding, lane-step and lane-wait counters against sums by
hand and against the benchmark's Recorder on the same run; no step graph
on the CPU; the spans on time.perf_counter's clock; and the Tracer's own
nesting, phases, totals and Chrome JSON."""

import json
import sys
import time
import types
from pathlib import Path

import pytest
import torch

from csinn2_tpu_torch.llm import engine as engine_mod
from csinn2_tpu_torch.llm.config import LlamaConfig
from csinn2_tpu_torch.llm.engine import InferenceEngine, Request, _bucket
from csinn2_tpu_torch.llm.model import init_params
from csinn2_tpu_torch.runtime.profiler import Tracer

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
# (prompt length, max_new_tokens, temperature): more requests than lanes,
# answers of unequal length so that chunks run lanes past their end
SPECS = [(5, 5, 0.0), (2, 9, 0.7), (35, 3, 0.0), (9, 6, 0.7), (40, 2, 0.0), (3, 7, 0.0)]
BATCH, CHUNK = 2, 4
_ORDER = ["prefill.stage", "prefill.forward", "prefill.sample", "prefill.fetch",
          "decode.stage", "decode.launch", "decode.fetch", "decode.commit"]


@pytest.fixture(scope="module")
def params():
    return init_params(LlamaConfig.tiny(), "q8_0", seed=1, device="cpu")


def _prompt(n, salt):
    return [(7 * i + salt) % 250 + 1 for i in range(n)]


def _requests(eos_id=None):
    return [Request(prompt=_prompt(n, k), max_new_tokens=m, temperature=t, eos_id=eos_id)
            for k, (n, m, t) in enumerate(SPECS)]


def _serve(params, tracer, eos_id=None):
    eng = InferenceEngine(LlamaConfig.tiny(), params, batch=BATCH, quantized_kv=True,
                          device="cpu", tracer=tracer)
    reqs = eng.run_queue(_requests(eos_id), chunk=CHUNK, seed=11)
    return eng, reqs


@pytest.fixture(scope="module")
def traced(params):
    """One traced run_queue, between two perf_counter readings."""
    tr = Tracer("serve")
    t0 = time.perf_counter()
    _, reqs = _serve(params, tr)
    t1 = time.perf_counter()
    return tr, reqs, t0, t1


@pytest.mark.parametrize("eos_id", [None, 17])
def test_tokens_are_the_same_with_the_tracer_on_and_off(params, eos_id):
    _, off = _serve(params, None, eos_id)
    tr = Tracer()
    _, on = _serve(params, tr, eos_id)
    assert [r.out for r in on] == [r.out for r in off]
    assert [r.slot for r in on] == [r.slot for r in off]
    assert tr.spans("prefill") and tr.totals["decode.lane_steps"] > 0


def test_off_path_reads_no_clock_and_records_nothing(params, monkeypatch):
    """tracer=None: run_queue never reads perf_counter_ns, which every span
    and wait needs."""
    def no_clock():
        raise AssertionError("the engine read the clock with no tracer")
    monkeypatch.setattr(engine_mod, "time",
                        types.SimpleNamespace(perf_counter_ns=no_clock,
                                              perf_counter=time.perf_counter))
    eng, reqs = _serve(params, None)
    assert all(r.done for r in reqs) and eng.tracer is None


@pytest.mark.parametrize("entry", ["prefill", "prefill_sample", "_prefill_eager",
                                   "generate", "generate_fused"])
def test_prefill_reads_no_clock_with_the_tracer_off(params, monkeypatch, entry):
    """tracer=None: no prefill entry point reads perf_counter_ns, and the
    engine counts nothing."""
    def no_clock():
        raise AssertionError("the engine read the clock with no tracer")
    monkeypatch.setattr(engine_mod, "time",
                        types.SimpleNamespace(perf_counter_ns=no_clock,
                                              perf_counter=time.perf_counter))
    eng = InferenceEngine(LlamaConfig.tiny(), params, batch=BATCH, quantized_kv=True,
                          device="cpu")
    prompt = _prompt(35, 3)
    if entry.startswith("generate"):
        getattr(eng, entry)(prompt, max_new_tokens=3, temperature=0.7, seed=2)
    else:
        getattr(eng, entry)(1, prompt)
    assert eng.slots[0 if entry.startswith("generate") else 1].active and eng.tracer is None


def test_children_lie_inside_their_parents(traced):
    tr = traced[0]
    by_id = {e.id: e for e in tr.spans()}
    kids = {"prefill": {"prefill.stage", "prefill.forward", "prefill.sample", "prefill.fetch"},
            "decode.chunk": {"decode.stage", "decode.launch", "decode.fetch", "decode.commit"},
            "sched.admit": {"prefill"}}
    for e in tr.spans():
        if e.parent is None:
            assert e.name in ("sched.admit", "decode.chunk")
            continue
        p = by_id[e.parent]
        assert e.name in kids[p.name]
        assert p.ts <= e.ts and e.ts + e.dur <= p.ts + p.dur
    for p in tr.spans():
        if p.name in ("prefill", "decode.chunk"):
            names = [e.name for e in tr.spans() if e.parent == p.id]
            assert names == sorted(kids[p.name], key=lambda n: _ORDER.index(n))
    assert all(by_id[p.parent].name == "sched.admit" for p in tr.spans("prefill"))
    waves = tr.spans("sched.admit")
    assert sum(w.args["admitted"] for w in waves) == len(SPECS)
    assert waves[-1].args["queue_left"] == 0


def test_one_prefill_a_request_with_its_index_and_bucket(traced):
    tr, reqs = traced[:2]
    pre = sorted(tr.spans("prefill"), key=lambda e: e.ts)
    assert [e.args["req"] for e in pre] == list(range(len(SPECS)))
    assert [e.args["n_prompt"] for e in pre] == [n for n, _, _ in SPECS]
    assert [e.args["bucket"] for e in pre] == [_bucket(n) for n, _, _ in SPECS]
    assert [e.args["slot"] for e in pre] == [r.slot for r in reqs]


def test_padding_counters_by_hand(traced):
    tr = traced[0]
    assert tr.totals["prefill.tokens"] == sum(n for n, _, _ in SPECS)
    assert tr.totals["prefill.pad_tokens"] == sum(_bucket(n) - n for n, _, _ in SPECS)


def test_chunk_spans_name_their_lanes_and_requests(traced):
    tr, reqs = traced[:2]
    chunks = tr.spans("decode.chunk")
    assert sum(c.args["n_steps"] for c in chunks) * BATCH == tr.totals["decode.lane_steps"]
    for c in chunks:
        for sid, k in c.args["lanes"].items():
            assert reqs[k].slot == sid
        assert c.args["kv_bound"] % 256 == 0 or c.args["kv_bound"] == LlamaConfig.tiny().max_seq_len


def test_lane_steps_add_up_and_match_the_recorder(params):
    """idle + past the end + useful == lane_steps; useful == the lane-steps
    the benchmark's Recorder counts (its spans around decode_steps) on the
    same run."""
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from portbench.record import Recorder
    from portbench.traffic import Spec
    tr = Tracer()
    eng = InferenceEngine(LlamaConfig.tiny(), params, batch=BATCH, quantized_kv=True,
                          device="cpu", tracer=tr)
    reqs = _requests()
    rec = Recorder([Spec(r.prompt, r.max_new_tokens, r.temperature) for r in reqs],
                   BATCH, seconds=1e9)
    rec.install(eng)
    rec.begin()
    eng.run_queue(reqs, chunk=CHUNK, seed=11)
    t = tr.totals
    useful = t["decode.lane_steps"] - t["decode.lane_steps_idle"] - t["decode.lane_steps_past_end"]
    assert useful == sum(u for s in rec.spans if s.kind == "decode" for _, u in s.lanes)
    assert useful == sum(r.max_new_tokens - 1 for r in reqs)     # no eos: every token but the first
    assert t["decode.lane_steps_past_end"] > 0 and t["decode.lane_steps_idle"] > 0
    assert t["decode.lane_steps"] == BATCH * sum(s.n_steps for s in rec.spans if s.kind == "decode")


def test_no_step_graph_on_the_cpu(traced):
    tr = traced[0]
    assert tr.totals.get("decode.captures", 0) == 0 and tr.totals.get("decode.replays", 0) == 0
    assert not tr.spans("decode.capture")


def test_lane_waits_run_from_the_freeing_chunk_or_the_call(traced):
    tr = traced[0]
    assert tr.totals["sched.lane_waits"] == len(SPECS)          # traced from the call's start
    assert tr.totals["sched.lane_wait_ns"] > 0
    # each wait starts inside the call and ends before its prefill starts
    t_call = traced[2] * 1e9
    assert tr.totals["sched.lane_wait_ns"] <= sum(e.ts - t_call for e in tr.spans("prefill"))


def test_spans_are_on_the_perf_counter_clock(traced):
    tr, _, t0, t1 = traced
    for e in tr.spans():
        assert t0 * 1e9 <= e.ts and (e.ts + e.dur) <= t1 * 1e9


def test_tracer_nests_phases_and_totals(tmp_path):
    tr = Tracer("t")
    with tr.event("outer", args={"a": 1}):
        tr.begin("one")
        tr.phase("two")
        tr.end()
        tr.add("n")
        tr.add("n", 2)
    one, two, outer = tr.events
    assert [one.name, two.name, outer.name] == ["one", "two", "outer"]
    assert one.parent == two.parent == outer.id and outer.parent is None
    assert one.ts + one.dur == two.ts                      # a phase starts where the last ended
    assert outer.ts <= one.ts and two.ts + two.dur <= outer.ts + outer.dur
    tr.counter("mem", 5.0)
    doc = json.load(open(tr.save(str(tmp_path / "t.json"))))
    assert doc["otherData"]["origin_ns"] == tr.origin_ns
    assert doc["otherData"]["totals"] == {"n": 3}
    ev = {e["name"]: e for e in doc["traceEvents"]}
    assert ev["outer"]["ts"] == pytest.approx((outer.ts - tr.origin_ns) / 1e3)
    assert ev["outer"]["dur"] == pytest.approx(outer.dur / 1e3)
    assert ev["one"]["args"] == {"id": one.id, "parent": outer.id}
    assert ev["outer"]["args"] == {"a": 1, "id": outer.id, "parent": None}
    assert ev["mem"]["ph"] == "C" and ev["mem"]["args"] == {"value": 5.0}


def test_tracer_end_merges_args():
    tr = Tracer()
    tr.begin("wave", args={"x": 1})
    ev = tr.end(args={"y": 2})
    assert ev.args == {"x": 1, "y": 2} and tr.spans("wave") == [ev]
