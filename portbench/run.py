#!/usr/bin/env python3
"""Run one cell of BENCHMARK.json on this machine's card and print its
result as the last line of standard output.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

--trace 0: the cell's end-to-end metrics over a window of --seconds.
--trace 1: the same window, then a traced segment (torch.profiler, CUDA
activity) of a couple of seconds; the cell's per-layer metrics, the
device's busy and window seconds and a breakdown of the segment.
Either way, after the window the served tokens are checked against the
float32 reference (check.py) and `correct` says whether they pass.

Everything that belongs to one configuration, traffic mix or metric is a
file found by its name in BENCHMARK.json: configs/<config>.json (its
"driver" names drivers/<driver>.py, its optional "reference" names
reference/<reference>.py, "llama" where it names none), traffic/<traffic>.json,
e2e/<metric>.py, metrics/<metric>.py, limits/<cell>.json.  A configuration
whose driver or reference is missing exits with code 2 before set-up.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "csinn2_tpu")
TRACE_SECONDS = 2.0
CACHE_ENV = {"TRITON_CACHE_DIR": "triton", "TORCH_EXTENSIONS_DIR": "torch_extensions",
             "CUDA_CACHE_PATH": "cuda"}


def load_reader(kind: str, name: str):
    """e2e/<name>.py or metrics/<name>.py as a module (names hold dots)."""
    path = HERE / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench.{kind}.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(bench: dict, cell: str, trace: bool) -> list:
    """The metric entries this cell reports: end-to-end ones (all, or those
    whose "workloads" name the cell) with --trace 0; per-layer ones (those
    whose "workloads" name it, else those whose `moves` the cell reports)
    with --trace 1."""
    e2e = [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if cell in m.get("workloads", [cell] if m["moves"] in moved else [])]


class Unresolved(Exception):
    """A configuration names a driver or a reference that is not there."""


def _module(package: str, name, *needs: str):
    """portbench.<package>.<name>, which has to define each function in `needs`."""
    if not isinstance(name, str) or not name.isidentifier():
        raise Unresolved(f"{name!r} is not a module name under portbench/{package}/")
    full = f"portbench.{package}.{name}"
    try:
        mod = importlib.import_module(full)
    except ModuleNotFoundError as e:
        if e.name != full:
            raise
        raise Unresolved(f"no module portbench/{package}/{name}.py") from None
    for fn in needs:
        if not callable(getattr(mod, fn, None)):
            raise Unresolved(f"portbench/{package}/{name}.py defines no {fn}()")
    return mod


def resolve(cfg: dict):
    """A configuration file's (driver module, the driver's dims(cfg), the
    reference module), before a run makes a weight: the driver is
    drivers/<cfg["driver"]>.py with dims() and serve(), the reference
    reference/<cfg.get("reference", "llama")>.py with logits_at()."""
    driver = _module("drivers", cfg.get("driver"), "dims", "serve")
    ref = _module("reference", cfg.get("reference", "llama"), "logits_at")
    return driver, driver.dims(cfg), ref


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


class RunView:
    """What a reader reads: the recorder, the model's sizes, the set-up
    time and the traced segment's summary (None without a trace)."""

    def __init__(self, served, setup_s: float, trace_summary):
        self.rec = served.rec
        self.dims = served.dims
        self.setup_s = setup_s
        self.trace = trace_summary


def main(argv=None, *, root: Path = ROOT, data: Path = HERE, device: str = "cuda") -> int:
    """root: where BENCHMARK.json lies; data: where traffic/ and limits/ lie
    (the tests pass their own); device "cpu" runs the plain path (tests)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    for var, sub in CACHE_ENV.items():
        os.environ[var] = str(root / ".portbench_cache" / sub)
    with open(root / "BENCHMARK.json") as f:
        bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        print(f"no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    cell = cells[args.workload]
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
    with open(root / conf["file"]) as f:
        cfg = json.load(f)

    import torch
    from portbench import check, devtrace, traffic
    if device == "cuda":
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
            n = torch.cuda.device_count() if torch.cuda.is_available() else 0
            print(f"this cell needs {cell['chips']} CUDA device(s); found {n}", file=sys.stderr)
            return 2
    torch.set_num_threads(2)
    dev = torch.device(device)
    try:
        driver, d, ref = resolve(cfg)
    except Unresolved as e:
        print(f"{conf['name']}: {e}", file=sys.stderr)
        return 2
    mix = traffic.load_mix(cell["traffic"], root=data)
    wanted = cell_metrics(bench, args.workload, bool(args.trace))
    readers = [(m, load_reader("metrics" if args.trace else "e2e", m["name"])) for m in wanted]
    for m, mod in readers:
        if mod.UNIT != m["unit"] or mod.SOURCE != m["source"]:
            raise SystemExit(f"{m['name']}: the reader says {mod.UNIT} / {mod.SOURCE}, "
                             f"BENCHMARK.json {m['unit']} / {m['source']}")

    tracer = devtrace.DeviceTrace() if args.trace and dev.type == "cuda" else None
    setup = {}
    served = driver.serve(d, mix, args.seed, args.seconds, dev, tracer=tracer,
                          trace_seconds=TRACE_SECONDS,
                          on_setup_done=lambda: setup.update(s=time.perf_counter() - T_START))
    summary = None
    if tracer is not None:
        summary = devtrace.summarize(tracer.events, tracer.marks, served.rec.trace_spans())
        marks = sum(devtrace.MARK_NAME in e[0] for e in tracer.events)
        print(f"trace: {len(tracer.events)} device operations, {marks} of "
              f"{len(tracer.marks)} marker kernels"
              + ("" if summary else ": no start or no end marker, no device metric"),
              file=sys.stderr)
    view = RunView(served, setup["s"], summary)
    metrics = {}
    for m, mod in readers:
        v = mod.read(view)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}

    rec = served.rec
    pick = check.served_sample(rec, served.outs, mix, args.seed)
    values = {"length_mismatches": check.length_mismatches(rec, served.outs),
              "checked_tokens": 0, "max_logit_gap": None}
    if pick:
        values.update(check.reference_values(ref, d, args.seed, [served.prompts[k] for k in pick],
                                             [served.outs[k] for k in pick], dev))
    correct, checks = check.judge(values, check.load_limits(args.workload, root=data))

    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": torch.cuda.get_device_name(0) if dev.type == "cuda" else "cpu",
                   "count": int(cell["chips"]), "memory_peak_bytes": served.memory_peak_bytes}
    result = {"correct": correct,
              "attempted": rec.attempted(),
              "failed": 0, "metrics": metrics, "device": device_info}
    if summary is not None:
        device_info.update(busy_s=summary["busy_s"], window_s=summary["window_s"])
        result["breakdown"] = devtrace.breakdown(summary)
    result["checks"] = checks
    print(f"window: {args.seconds} s, requests finished {len(rec.completions)}, decode chunks "
          f"{len(rec.window_spans('decode'))}, prefills {len(rec.window_spans('prefill'))}, "
          f"step graphs captured inside the window {served.captures_in_window}", file=sys.stderr)
    for line in check.lines(checks):
        print(line, file=sys.stderr)
    found = forbidden_modules()       # after the readers and the reference have run too
    if found:
        print(f"modules of {found} are loaded in the benchmark's process", file=sys.stderr)
        return 3
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.path[0] = str(ROOT)       # import portbench.* from the checkout's root
    sys.exit(main())
