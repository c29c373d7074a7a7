"""A whole run of the harness on the CPU (run.main with device "cpu": every
step of a run but the look for a card), first sound, then with the timed
path broken underneath: `correct` has to come out false for each fault a
served cell can have.  (The exchange between chips is no fault of these
one-chip cells.)"""

import pytest

from portbench import faults
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
    undo = faults.plant(fault)
    try:
        rc, res = run_cpu(tmp_path, seed=7)
    finally:
        undo()
    assert engine._batched_decode_forward is orig
    assert rc == 0 and res["correct"] is False
    chk = res["checks"]["max_logit_gap"]
    assert chk["value"] > chk["limit"]


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
