"""A configuration of a new architecture, added with new files only: a run
gives its driver the driver's own dims(cfg) and judges the served tokens
by the reference that the configuration names (a whole run on the CPU
through a driver and a reference registered as test modules), and a
configuration whose driver or reference is missing exits with code 2
before a weight is made."""

import copy
import json
import sys
import types

import pytest

from portbench import weights
from portbench.drivers import llm_serve
from portbench.reference import llama
from portbench.tests.helpers import BENCH, DATA, run_cpu

NAME = "tiny_other"          # the test driver's and the test reference's module name


def _bench(tmp_path, **keys):
    """BENCH with the tiny cell on a copy of its configuration file, `keys`
    added to it."""
    with open(DATA / "configs" / "tiny-q4_0.json") as f:
        cfg = {**json.load(f), **keys}
    path = tmp_path / "tiny-other.json"
    path.write_text(json.dumps(cfg))
    bench = copy.deepcopy(BENCH)
    bench["configs"][0]["file"] = str(path)
    return bench


def _never(*a, **kw):
    raise AssertionError("called")


@pytest.fixture
def other(monkeypatch):
    """portbench.drivers.tiny_other (dims: weights.dims and kv_lora_rank;
    serve: llm_serve's, its tokens shifted by one where seen["wrong"]) and
    portbench.reference.tiny_other (llama's logits_at, loading the module
    seen["loads"] names); what each was given."""
    seen = {"served": [], "judged": [], "wrong": False, "loads": None}
    drv = types.ModuleType(f"portbench.drivers.{NAME}")
    drv.dims = lambda cfg: {**weights.dims(cfg), "kv_lora_rank": int(cfg["kv_lora_rank"])}

    def serve(d, mix, seed, seconds, device, **kw):
        seen["served"].append(d)
        served = llm_serve.serve(d, mix, seed, seconds, device, **kw)
        if seen["wrong"]:
            served.outs = [o if o is None else [(t + 1) % d["V"] for t in o] for o in served.outs]
        return served
    drv.serve = serve
    ref = types.ModuleType(f"portbench.reference.{NAME}")
    llama_logits_at = llama.logits_at

    def logits_at(d, seed, seqs, rows, device, act="f32", kv_bits=8):
        seen["judged"].append(d)
        if seen["loads"]:                # a module this reference imports as it runs
            monkeypatch.setitem(sys.modules, seen["loads"], types.ModuleType(seen["loads"]))
        return llama_logits_at(d, seed, seqs, rows, device, act=act, kv_bits=kv_bits)
    ref.logits_at = logits_at
    monkeypatch.setitem(sys.modules, drv.__name__, drv)
    monkeypatch.setitem(sys.modules, ref.__name__, ref)
    monkeypatch.setattr(llama, "logits_at", _never)     # only the named reference judges
    return seen


@pytest.mark.parametrize("wrong", [False, True], ids=["sound", "wrong_tokens"])
def test_a_new_architecture_is_served_and_judged_by_its_own_files(tmp_path, other, wrong):
    other["wrong"] = wrong
    bench = _bench(tmp_path, driver=NAME, reference=NAME, kv_lora_rank=64)
    rc, res = run_cpu(tmp_path, seed=7, bench=bench)
    assert rc == 0 and res["correct"] is (not wrong)
    assert "kv_lora_rank" not in weights.dims(json.loads((tmp_path / "tiny-other.json").read_text()))
    assert [d["kv_lora_rank"] for d in other["served"]] == [64]
    assert other["judged"] and all(d["kv_lora_rank"] == 64 for d in other["judged"])
    assert res["checks"]["checked_tokens"]["value"] >= 1


@pytest.mark.parametrize("loads", ["jax", "csinn2_tpu.ops"])
def test_a_reference_that_loads_jax_after_the_window_prints_no_result(
        tmp_path, other, capsys, loads):
    """The look at sys.modules comes after the reference has judged, not
    only after the window: a reference that imports the JAX package (or
    jax) as it runs exits 3 with no result line."""
    other["loads"] = loads
    rc, res = run_cpu(tmp_path, seed=7, bench=_bench(tmp_path, driver=NAME, reference=NAME,
                                                      kv_lora_rank=64))
    assert other["judged"] and rc == 3 and res is None
    top = loads.split(".")[0]
    assert f"modules of ['{top}'] are loaded" in capsys.readouterr().err.splitlines()[-1]


@pytest.mark.parametrize("keys,reason", [
    ({"reference": "no_such_reference"}, "no module portbench/reference/no_such_reference.py"),
    ({"driver": "no_such_driver"}, "no module portbench/drivers/no_such_driver.py"),
    ({"reference": "hollow"}, "portbench/reference/hollow.py defines no logits_at()"),
    ({"driver": "hollow"}, "portbench/drivers/hollow.py defines no dims()"),
    ({"reference": "../llama"}, "'../llama' is not a module name under portbench/reference/"),
], ids=["reference_missing", "driver_missing", "reference_without_logits_at",
        "driver_without_dims", "reference_not_a_name"])
def test_a_missing_driver_or_reference_exits_2_before_a_weight_is_made(
        tmp_path, monkeypatch, capsys, keys, reason):
    for package in ("drivers", "reference"):
        monkeypatch.setitem(sys.modules, f"portbench.{package}.hollow",
                            types.ModuleType(f"portbench.{package}.hollow"))
    monkeypatch.setattr(llm_serve, "serve", _never)
    for fn in ("layer", "embedding", "head"):
        monkeypatch.setattr(weights, fn, _never)
    rc, res = run_cpu(tmp_path, bench=_bench(tmp_path, **keys))
    assert rc == 2 and res is None
    assert capsys.readouterr().err == f"tiny-q4_0: {reason}\n"
