"""A whole run of the harness on the CPU (run.main with device "cpu": every
step of a run but the look for a card), first sound, then with the timed
path broken underneath: `correct` has to come out false for each fault a
served cell can have.  (The exchange between chips is no fault of these
one-chip cells.)"""

import sys
import types

import pytest
import torch

from portbench import faults
from portbench.drivers import llm_serve
from portbench.tests.helpers import run_cpu


def test_a_sound_run_is_correct(tmp_path):
    rc, res = run_cpu(tmp_path, seed=7)
    assert rc == 0 and res["correct"] is True
    assert list(res)[-1] == "checks"
    assert res["checks"]["checked_tokens"]["value"] >= 1
    assert set(res["metrics"]) == {"output_tok_s", "tpot_p95_ms", "ttft_p95_ms", "setup_s"}
    assert res["attempted"] > 4 and res["failed"] == 0


def test_a_traced_run_reports_the_per_layer_metrics(tmp_path):
    rc, res = run_cpu(tmp_path, seed=8, trace=1)
    assert rc == 0 and res["correct"] is True
    assert set(res["metrics"]) == {"sched.lane_occupancy", "decode.step_ms", "prefill.ms_per_ktok"}


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch"])
def test_a_broken_decode_step_is_caught(tmp_path, fault):
    from csinn2_tpu_torch.llm import engine
    orig = engine._batched_decode_forward
    undo = faults.plant(fault, llm_serve)
    try:
        rc, res = run_cpu(tmp_path, seed=7)
    finally:
        undo()
    assert engine._batched_decode_forward is orig
    assert rc == 0 and res["correct"] is False
    chk = res["checks"]["max_logit_gap"]
    assert chk["value"] > chk["limit"]


class _LatentCache:
    """A cache whose state is not named k and v: one latent row a token a
    layer and a rotary part, beside a plain number."""

    def __init__(self):
        self.latent = torch.arange(12.0).view(2, 6)
        self.rope_part = torch.ones(2, 2, dtype=torch.int8)
        self.scale = 0.05


def _latent_step(params, tokens, cache, pos_vec, cfg, **kw):
    cache.latent.add_(1.0)
    cache.rope_part.fill_(3)
    return torch.zeros(4, 1, 8), cache


@pytest.mark.parametrize("by_keyword", [False, True], ids=["positional", "cache_keyword"])
def test_state_unchanged_restores_a_cache_whose_tensors_have_other_names(by_keyword):
    cache = _LatentCache()
    before = (cache.latent.clone(), cache.rope_part.clone())
    step = faults.state_unchanged(_latent_step)
    if by_keyword:
        logits, c = step(None, None, cache=cache, pos_vec=None, cfg=None)
    else:
        logits, c = step(None, None, cache, None, None, kv_bound=4)
    assert c is cache and logits.shape == (4, 1, 8)
    assert torch.equal(cache.latent, before[0]) and torch.equal(cache.rope_part, before[1])
    _latent_step(None, None, cache, None, None)              # unwrapped, the step moves it
    assert not torch.equal(cache.latent, before[0])


def test_state_unchanged_holds_the_llama_caches_k_and_v_alone():
    """The Llama cells' fault: the same two tensors as before any cache
    could be given, and a cache with no tensor is refused, not passed."""
    from csinn2_tpu_torch.llm.config import LlamaConfig
    from csinn2_tpu_torch.llm.model import KVCache
    cache = KVCache.create(LlamaConfig.tiny(), 2, quantized=True, device="cpu")
    assert list(faults._tensors(cache)) == ["k", "v"]
    with pytest.raises(TypeError):
        faults.state_unchanged(_latent_step)(None, None, types.SimpleNamespace(scale=1.0), None, None)


def test_plant_wraps_the_step_that_the_driver_names(monkeypatch):
    from csinn2_tpu_torch.llm import engine
    mod = types.ModuleType("portbench_test_step")
    mod.decode = lambda *a, **kw: (torch.arange(4.0)[:, None], None)
    monkeypatch.setitem(sys.modules, mod.__name__, mod)
    orig, engine_step = mod.decode, engine._batched_decode_forward
    undo = faults.plant("half_batch", types.SimpleNamespace(DECODE_STEP=(mod.__name__, "decode")))
    try:
        assert mod.decode is not orig and engine._batched_decode_forward is engine_step
        assert mod.decode()[0][:, 0].tolist() == [0.0, 1.0, 0.0, 1.0]
    finally:
        undo()
    assert mod.decode is orig
    undo = faults.plant("half_batch", llm_serve)                    # the Llama cells' step
    assert engine._batched_decode_forward is not engine_step
    undo()
    assert engine._batched_decode_forward is engine_step
    with pytest.raises(ValueError, match="names no DECODE_STEP"):   # names none: no fallback
        faults.plant("half_batch", types.SimpleNamespace(__name__="portbench.drivers.other"))
    assert engine._batched_decode_forward is engine_step


def test_an_altered_token_is_caught(tmp_path, monkeypatch):
    """Each request's first token, where prefill_sample produces it, is
    changed to the next id."""
    from csinn2_tpu_torch.llm.engine import InferenceEngine
    orig = InferenceEngine.prefill_sample

    def altered(self, slot_id, prompt, *a, **kw):
        return (orig(self, slot_id, prompt, *a, **kw) + 1) % self.cfg.vocab_size
    monkeypatch.setattr(InferenceEngine, "prefill_sample", altered)
    rc, res = run_cpu(tmp_path, seed=7)
    assert rc == 0 and res["correct"] is False


def test_a_dropped_token_is_caught(tmp_path, monkeypatch):
    """A finished request whose output lost a token fails the exact length
    check."""
    from csinn2_tpu_torch.llm import engine
    orig = engine.InferenceEngine.run_queue

    def dropping(self, requests, *a, **kw):
        try:
            return orig(self, requests, *a, **kw)
        finally:
            for r in requests:
                if r.done and len(r.out) > 2:
                    r.out.pop()
    monkeypatch.setattr(engine.InferenceEngine, "run_queue", dropping)
    rc, res = run_cpu(tmp_path, seed=7)
    assert rc == 0 and res["correct"] is False
    assert res["checks"]["length_mismatches"]["value"] > 0


def test_calibrate_judges_the_control_by_the_cells_limits():
    """calibrate.py's verdicts: the program's readings and each control's,
    put in the program's place, through check.judge and the limits file."""
    from portbench import calibrate
    limits = {"max_logit_gap": {"limit": 2.0}, "mean_logit_gap": {"limit": 0.4}}
    row = {"max_logit_gap": 0.7, "mean_logit_gap": 0.05, "checked_tokens": 300,
           "length_mismatches": 0, "control_max_gap": 3.1, "control_mean_gap": 0.7,
           "kv4_max_gap": 1.9, "kv4_mean_gap": 0.41}
    assert calibrate.verdicts(row, limits) == {"correct": True, "control_correct": False,
                                               "kv4_correct": False}
    assert calibrate.verdicts({**row, "length_mismatches": 1}, limits)["correct"] is False
    assert calibrate.verdicts({"checked_tokens": 0}, limits) == {"correct": False}
