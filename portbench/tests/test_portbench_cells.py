"""BENCHMARK.json against the files it names: each cell finds its
configuration, its driver's sizes, its reference, traffic mix and output
limits; each metric's `workloads` names only cells that exist and has a
reader; each limits file's readings lie on the right side of its limits."""

import json

import pytest

from portbench import check, traffic, weights
from portbench.reference import llama
from portbench.run import HERE, ROOT, cell_metrics, load_reader, resolve

with open(ROOT / "BENCHMARK.json") as f:
    BENCH = json.load(f)
CELLS = {w["name"]: w for w in BENCH["workloads"]}
CONFIGS = {c["name"]: c for c in BENCH["configs"]}
LLAMA_CELLS = ["mistral7b-q4_0.gen", "mistral7b-q4_0.rag", "deepseek7b-q8_0.chat"]
METRICS = [("e2e", m) for m in BENCH["end_to_end"]] + [("metrics", m) for m in BENCH["per_layer"]]


def _config(cell: str) -> dict:
    with open(ROOT / CONFIGS[CELLS[cell]["config"]]["file"]) as f:
        return json.load(f)


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_cell_resolves_its_files(cell):
    w = CELLS[cell]
    conf = CONFIGS[w["config"]]
    cfg = _config(cell)
    assert cfg["name"] == conf["name"]
    assert set(conf["reduced"]) == set(cfg["reduced"])
    driver, d, ref = resolve(cfg)
    assert d["batch"] >= 1
    assert callable(driver.serve) and callable(ref.logits_at)
    mix = traffic.load_mix(w["traffic"], root=HERE)
    assert mix["check"]["served_tokens"] >= 1
    limits = check.load_limits(cell, root=HERE)
    assert set(limits) & set(check.GAPS), f"limits/{cell}.json limits no gap"


@pytest.mark.parametrize("cell", LLAMA_CELLS)
def test_llama_cells_keep_their_sizes_and_reference(cell):
    """The driver's dims are weights.dims key for key, and the reference
    is reference/llama.py, as before configurations could name others."""
    cfg = _config(cell)
    _, d, ref = resolve(cfg)
    assert d == weights.dims(cfg)
    assert ref is llama and "reference" not in cfg


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_cell_reports_setup_another_end_to_end_and_a_layer_metric(cell):
    e2e = {m["name"] for m in cell_metrics(BENCH, cell, trace=False)}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell_metrics(BENCH, cell, trace=True)


@pytest.mark.parametrize("kind,metric", METRICS, ids=[m["name"] for _, m in METRICS])
def test_metric_names_only_cells_that_exist_and_has_its_reader(kind, metric):
    assert set(metric.get("workloads", [])) <= set(CELLS)
    mod = load_reader(kind, metric["name"])
    assert (mod.UNIT, mod.SOURCE) == (metric["unit"], metric["source"])


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_limits_lie_between_the_program_and_the_control(cell):
    limits = check.load_limits(cell, root=HERE)
    for name in check.GAPS:
        if name not in limits:
            continue
        lim = limits[name]
        assert len(lim["program"]) >= 12 and len(lim["control"]) >= 3
        assert max(lim["program"]) == lim["lower"] < lim["limit"]
        assert lim["limit"] < lim["upper"] == min(lim["control"])
