"""Nothing the harness or the reference imports has the top-level name jax,
jaxlib, flax or csinn2_tpu, compared whole (csinn2_tpu_torch begins with
csinn2_tpu and is allowed); the reference imports nothing of the port."""

import json
import subprocess
import sys
import textwrap

import pytest

from portbench import run
from portbench.tests.helpers import BENCH, CELL, DATA

FORBIDDEN = {"jax", "jaxlib", "flax", "csinn2_tpu"}


def _modules_after(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(code)], check=True,
                         capture_output=True, text=True, cwd=str(run.ROOT), timeout=600)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_whole_run_loads_no_jax(tmp_path):
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(BENCH))
    tops = _modules_after(f"""
        import contextlib, io, json, sys
        from pathlib import Path
        sys.path.insert(0, {str(run.ROOT)!r})
        from portbench import run
        with contextlib.redirect_stdout(io.StringIO()):
            rc = run.main(["--workload", {CELL!r}, "--seed", "3", "--seconds", "0.5"],
                          root=Path({str(tmp_path)!r}), data=Path({str(DATA)!r}), device="cpu")
        assert rc == 0
        print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
    """)
    assert "csinn2_tpu_torch" in tops          # the program ran
    assert not tops & FORBIDDEN


REFERENCES = sorted(p.stem for p in (run.HERE / "reference").glob("*.py") if p.stem != "__init__")


@pytest.mark.parametrize("name", REFERENCES)
def test_the_reference_imports_nothing_of_the_program(name):
    """Every module under reference/, each in a fresh process: a reference
    that a later configuration adds is covered by the file that adds it."""
    tops = _modules_after(f"""
        import json, sys
        sys.path.insert(0, {str(run.ROOT)!r})
        import portbench.reference.{name}, portbench.check, portbench.counts
        print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
    """)
    assert not tops & (FORBIDDEN | {"csinn2_tpu_torch"})


def test_every_reference_is_checked():
    assert "llama" in REFERENCES


def test_the_check_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "csinn2_tpu_torch_fake", object())
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert run.forbidden_modules() == ["jax"]


def test_a_run_without_a_card_prints_no_result(tmp_path, capsys):
    """device "cuda" on a host without one: a non-zero exit, no result line."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(BENCH))
    rc = run.main(["--workload", CELL, "--seed", "1", "--seconds", "1"], root=tmp_path, data=DATA)
    assert rc != 0
    assert capsys.readouterr().out == ""
