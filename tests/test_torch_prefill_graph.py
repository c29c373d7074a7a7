"""Which prefill the serving engine runs, on the CPU: the per-bucket prefill
graph only on one card with no mesh and no MoE layer; on the CPU and for MoE
layers the eager forward, with no prefill.graph_* counter in the tracer.
The graph path's staging (the static tokens, the one-lane staging cache, the
rows copied into the slot, the static logits, one capture a bucket) runs
here under a stand-in capture that replays by rerunning the forward: the
same first tokens and the same cache bytes as _prefill_eager on a second
engine, across buckets, slots and temperatures.  The captured graph itself
is held to _prefill_eager on the card (tests/test_torch_cuda.py
test_prefill_graph_matches_the_eager_prefill)."""

import time
import types

import numpy as np
import pytest
import torch

from csinn2_tpu_torch.llm import engine as engine_mod
from csinn2_tpu_torch.llm.config import LlamaConfig
from csinn2_tpu_torch.llm.engine import InferenceEngine, Request, _prefill_graphable
from csinn2_tpu_torch.llm.model import init_params
from csinn2_tpu_torch.runtime.profiler import Tracer

torch.set_num_threads(2)

CFG = LlamaConfig.tiny(max_seq=640)


@pytest.fixture(scope="module")
def params():
    return init_params(CFG, "q8_0", seed=3, device="cpu")


def _graph_keys(tr):
    return sorted(k for k in tr.totals if k.startswith("prefill.graph_"))


@pytest.mark.parametrize("device", ["cpu", "cuda"])
@pytest.mark.parametrize("mesh", [False, True])
@pytest.mark.parametrize("moe", [False, True])
def test_the_graph_choice(device, mesh, moe):
    """The graph only on a card, with no mesh and no layer with a gate."""
    layers = [{"wqkv": None}, {"wqkv": None, **({"gate": None} if moe else {})}]
    got = _prefill_graphable(torch.device(device), object() if mesh else None, layers)
    assert got == (device == "cuda" and not mesh and not moe)


@pytest.mark.parametrize("entry", ["run_queue", "prefill", "generate", "generate_fused"])
def test_cpu_prefill_is_eager_and_counts_no_graph(params, entry):
    tr = Tracer()
    eng = InferenceEngine(CFG, params, batch=2, quantized_kv=True, device="cpu", tracer=tr)
    prompt = [(5 * i) % 250 + 1 for i in range(40)]
    if entry == "run_queue":
        eng.run_queue([Request(prompt=prompt, max_new_tokens=3),
                       Request(prompt=prompt[:7], max_new_tokens=2, temperature=0.8)], chunk=2)
        assert len(tr.spans("prefill")) == 2
    elif entry == "prefill":
        eng.prefill(0, prompt)
    else:
        getattr(eng, entry)(prompt, max_new_tokens=2)
    assert not eng._graph_prefill
    assert eng._prefill_graphs == {} and eng._prefill_static is None
    assert _graph_keys(tr) == []


def test_moe_prefill_is_eager_and_counts_no_graph():
    cfg = LlamaConfig.tiny_moe(4)
    tr = Tracer()
    eng = InferenceEngine(cfg, init_params(cfg, "q8_0", seed=2, device="cpu"), batch=1,
                          device="cpu", tracer=tr)
    tok = eng.prefill_sample(0, [3, 9, 27, 4, 1])
    assert 0 <= tok < cfg.vocab_size and tr.spans("prefill")
    assert not _prefill_graphable(torch.device("cuda"), None, eng.params["layers"])
    assert eng._prefill_graphs == {} and _graph_keys(tr) == []


class _Replayed:
    """A stand-in CountedGraph on the CPU: the step runs at the warm-up and
    at the capture, whose result is `out`; a replay reruns the step and
    writes its result into `out`, as a graph's replay rewrites its static
    output."""

    def __init__(self, fn):
        fn()
        self.fn, self.out = fn, fn()

    def replay(self):
        self.out.copy_(self.fn())


@pytest.fixture
def stand_in(monkeypatch):
    """The graph path on the CPU: capture, the pool and the capture stream
    replaced; → the names of the graphs captured."""
    made = []

    def capture(fn, name, **kw):
        made.append(name)
        return _Replayed(fn)

    monkeypatch.setattr(engine_mod, "capture", capture)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: None)
    monkeypatch.setattr(torch.cuda, "Stream", lambda device=None: None)
    return made


@pytest.mark.parametrize("quantized_kv", [True, False])
def test_staged_prefill_matches_the_eager_prefill(params, stand_in, quantized_kv):
    """Buckets 32 … 512 and repeats, into slots 0-2 in turn (each slot
    rewritten after longer prompts), greedy and seeded, int8 and bf16 K/V:
    first tokens and both caches byte for byte equal to _prefill_eager's;
    one capture a bucket; the tracer counts a replay a prefill and a
    capture a bucket; the static logits are the eager forward's."""
    tr = Tracer()
    staged = InferenceEngine(CFG, params, batch=3, quantized_kv=quantized_kv, device="cpu",
                             tracer=tr)
    staged._graph_prefill = True
    eager = InferenceEngine(CFG, staged.params, batch=3, quantized_kv=quantized_kv,
                            device="cpu")
    rng = np.random.default_rng(4)
    plan = [(512, 0, 0.0), (32, 0, 0.9), (256, 1, 0.0), (64, 2, 1.2), (128, 1, 0.7),
            (512, 2, 0.0), (32, 1, 0.0)]
    for i, (b, sid, temp) in enumerate(plan):
        n = b - 5 if b > 32 else 17
        prompt = [int(t) for t in rng.integers(1, CFG.vocab_size, n)]
        kw = dict(temperature=temp, seed=7 + i)
        assert staged.prefill_sample(sid, prompt, **kw) == eager._prefill_eager(sid, prompt, **kw)
        assert torch.equal(staged.cache.k, eager.cache.k)
        assert torch.equal(staged.cache.v, eager.cache.v)
        assert staged.slots[sid].pos == eager.slots[sid].pos == n
    assert sorted(staged._prefill_graphs) == [32, 64, 128, 256, 512]
    assert stand_in == ["prefill_graph"] * 5
    assert tr.totals["prefill.graph_replays"] == len(plan)
    assert tr.totals["prefill.graph_captures"] == 5
    # the staging cache holds one lane, rows up to the largest bound
    assert staged._prefill_static["k"].shape == (CFG.n_layers, 1, 640, CFG.n_kv_heads,
                                                 CFG.head_dim)
    assert staged._prefill_static["k"].dtype == staged.cache.k.dtype
    prompt = [int(t) for t in rng.integers(1, CFG.vocab_size, 100)]
    np.testing.assert_array_equal(staged.prefill(1, prompt), eager.prefill(1, prompt))
    assert torch.equal(staged.cache.k, eager.cache.k)


def test_staged_prefill_reads_no_clock_and_scratch_keeps_apart(params, stand_in, monkeypatch):
    """With no tracer the graph path reads no clock and counts nothing; a
    _scratch() engine stages into its own buffers and graphs and leaves the
    parent's cache as it was."""
    eng = InferenceEngine(CFG, params, batch=2, quantized_kv=True, device="cpu")
    eng._graph_prefill = True
    eng.prefill_sample(1, list(range(1, 60)))
    k0, graphs0, static0 = eng.cache.k.clone(), dict(eng._prefill_graphs), eng._prefill_static

    def no_clock():
        raise AssertionError("the engine read the clock with no tracer")

    monkeypatch.setattr(engine_mod, "time",
                        types.SimpleNamespace(perf_counter_ns=no_clock,
                                              perf_counter=time.perf_counter))
    sc = eng._scratch()
    sc.prefill_sample(0, [t % 250 + 1 for t in range(297)])
    assert sc._prefill_graphs.keys() == {512} and sc._prefill_static is not static0
    assert eng._prefill_graphs == graphs0 and eng._prefill_static is static0
    assert torch.equal(eng.cache.k, k0)
    assert sc.cache.k.shape[1] == 1 and int(torch.count_nonzero(sc.cache.k[:, :, :297])) > 0


def test_the_eager_paths_take_run_queues_calls(params):
    """_prefill_eager and _decode_steps_eager take prefill_sample's and
    decode_steps' places in run_queue (chip_smoke.py's eager rerun) and
    give the same tokens."""
    def reqs():
        return [Request(prompt=[(3 * i + k) % 250 + 1 for i in range(n)], max_new_tokens=m,
                        temperature=t) for k, (n, m, t) in enumerate(
                            [(40, 5, 0.0), (9, 3, 0.8), (70, 4, 0.0)])]

    want = InferenceEngine(CFG, params, batch=2, quantized_kv=True,
                           device="cpu").run_queue(reqs(), chunk=2, seed=5)
    eng = InferenceEngine(CFG, params, batch=2, quantized_kv=True, device="cpu",
                          tracer=Tracer())
    eng.prefill_sample, eng.decode_steps = eng._prefill_eager, eng._decode_steps_eager
    got = eng.run_queue(reqs(), chunk=2, seed=5)
    assert [r.out for r in got] == [r.out for r in want]
    assert "decode.lane_steps_past_end" in eng.tracer.totals      # reqs reached _steps
