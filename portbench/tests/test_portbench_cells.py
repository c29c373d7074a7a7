"""BENCHMARK.json against the files it names: each cell finds its
configuration, traffic mix and output limits; each metric's `workloads`
names only cells that exist and has a reader; each limits file's readings
lie on the right side of its limits."""

import json

import pytest

from portbench import check, traffic, weights
from portbench.run import HERE, ROOT, cell_metrics, load_reader

with open(ROOT / "BENCHMARK.json") as f:
    BENCH = json.load(f)
CELLS = {w["name"]: w for w in BENCH["workloads"]}
CONFIGS = {c["name"]: c for c in BENCH["configs"]}
METRICS = [("e2e", m) for m in BENCH["end_to_end"]] + [("metrics", m) for m in BENCH["per_layer"]]


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_cell_resolves_its_files(cell):
    w = CELLS[cell]
    conf = CONFIGS[w["config"]]
    with open(ROOT / conf["file"]) as f:
        cfg = json.load(f)
    assert cfg["name"] == conf["name"]
    assert set(conf["reduced"]) == set(cfg["reduced"])
    assert weights.dims(cfg)["batch"] >= 1
    mix = traffic.load_mix(w["traffic"], root=HERE)
    assert mix["check"]["served_tokens"] >= 1
    limits = check.load_limits(cell, root=HERE)
    assert set(limits) & set(check.GAPS), f"limits/{cell}.json limits no gap"


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
