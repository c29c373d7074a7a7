"""On the card only: a 20 s window of each cell of BENCHMARK.json through
run.py, traced and not, as the check runs them (skips without a card;
~5 min on the card: `python3 -m pytest portbench/tests -q -m card`)."""

import contextlib
import io
import json

import pytest

from portbench import run

with open(run.ROOT / "BENCHMARK.json") as f:
    CELLS = [w["name"] for w in json.load(f)["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_on_the_card(cell, trace):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = run.main(["--workload", cell, "--seed", "2147483659", "--seconds", "20",
                       "--trace", str(trace)])
    res = json.loads(out.getvalue().strip().splitlines()[-1])
    assert rc == 0 and res["correct"] is True
    assert res["device"]["platform"] == "gpu" and res["device"]["count"] == 1
    if trace:
        assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]
