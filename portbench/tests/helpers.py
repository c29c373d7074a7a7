"""What the tests share: the tiny cell's BENCHMARK.json, written into a
temporary root, and a run of run.main on the CPU that returns its result."""

import contextlib
import io
import json
from pathlib import Path

DATA = Path(__file__).resolve().parent / "data"
CELL = "tiny.gen"

BENCH = {
    "command": ["python3", "portbench/run.py"], "paths": ["portbench"], "run_seconds": 2,
    "configs": [{"name": "tiny-q4_0", "source": "tests", "file": str(DATA / "configs" / "tiny-q4_0.json"),
                 "reduced": [], "why": "tests"}],
    "workloads": [{"name": CELL, "config": "tiny-q4_0", "traffic": "tiny", "chips": 1, "why": "tests"}],
    "end_to_end": [
        {"name": "output_tok_s", "unit": "tokens/s", "better": "higher", "bound": 0.05, "source": "host_clock"},
        {"name": "tpot_p95_ms", "unit": "ms", "better": "lower", "bound": 0.05, "source": "host_clock"},
        {"name": "ttft_p95_ms", "unit": "ms", "better": "lower", "bound": 0.05, "source": "host_clock"},
        {"name": "setup_s", "unit": "s", "better": "lower", "bound": 0.25, "source": "host_clock"}],
    "per_layer": [
        {"name": "sched.lane_occupancy", "unit": "%", "better": "higher", "source": "program_span",
         "layer": "Scheduler (llm/engine.py run_queue)", "moves": "output_tok_s"},
        {"name": "decode.step_ms", "unit": "ms", "better": "lower", "source": "program_span",
         "layer": "Decode step (engine._graph_chunk, _batched_decode_forward)", "moves": "output_tok_s"},
        {"name": "prefill.ms_per_ktok", "unit": "ms/ktok", "better": "lower", "source": "program_span",
         "layer": "Prefill (engine._prefill_local, model.llama_forward)", "moves": "ttft_p95_ms"}],
}


def run_cpu(tmp_path, seed=7, seconds=1.0, trace=0, bench=BENCH):
    """run.main on the CPU for the tiny cell → (exit code, result dict or None).
    `bench` may name another configuration file for the cell."""
    from portbench import run
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = run.main(["--workload", CELL, "--seed", str(seed), "--seconds", str(seconds),
                       "--trace", str(trace)], root=tmp_path, data=DATA, device="cpu")
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None)
