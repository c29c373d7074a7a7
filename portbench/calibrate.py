#!/usr/bin/env python3
"""The readings a cell's output limit is set from, in one process: for each
seed, a window of the cell's own traffic at its own sizes, then the
program's logit gaps over the served sample (as run.py reads them) and,
for the --control seeds, each control's (check.CONTROLS; "control" is the
reference at fp8 activations put in the program's place), read at the
same prompts and tokens.  Each row also carries the verdict of
check.judge against the cell's limits file: `correct` for the program,
`<control>_correct` for each control.  --fault plants one of faults.FAULTS
under the timed path (the decode step that the driver names) for every
seed.  The benchmark's own runs never run a control or a fault.

    python3 portbench/calibrate.py --workload <cell> --seeds 11,12,... \
        --control 11,12,13 --seconds 30 [--fault half_batch] [--out FILE.jsonl]
    python3 portbench/calibrate.py --workload <cell> --rejudge FILE.jsonl

One JSON line a seed on standard output (and in --out).  --rejudge needs
no card: it judges rows read before against the cell's limits file as it
stands now.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def verdicts(row: dict, limits: dict) -> dict:
    """check.judge over a row's readings: the program's, and each control's
    gaps put in the program's place (the same tokens checked, lengths
    exact)."""
    from portbench import check
    out = {"correct": check.judge({**row, "length_mismatches": row.get("length_mismatches", 0),
                                   "checked_tokens": row.get("checked_tokens", 0)}, limits)[0]}
    for name in check.CONTROLS:
        if f"{name}_max_gap" in row:
            vals = {"max_logit_gap": row[f"{name}_max_gap"],
                    "mean_logit_gap": row[f"{name}_mean_gap"],
                    "length_mismatches": 0, "checked_tokens": row["checked_tokens"]}
            out[f"{name}_correct"] = check.judge(vals, limits)[0]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--fault", default=None, help="one of faults.FAULTS, planted for every seed")
    ap.add_argument("--rejudge", default=None, help="judge the rows of this file; no card")
    ap.add_argument("--control", default="")
    ap.add_argument("--readings", default="control,kv4",
                    help="what the --control seeds read besides the program (check.CONTROLS)")
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    from portbench import check
    from portbench.run import CACHE_ENV, HERE, Unresolved, resolve
    limits = check.load_limits(args.workload, root=HERE)
    if args.rejudge:
        with open(args.rejudge) as f:
            for line in f:
                row = json.loads(line)
                print(json.dumps({**row, **verdicts(row, limits)}))
        return 0
    import torch
    from portbench import faults, traffic
    for var, sub in CACHE_ENV.items():
        os.environ[var] = str(ROOT / ".portbench_cache" / sub)
    with open(ROOT / "BENCHMARK.json") as f:
        bench = json.load(f)
    cell = next(w for w in bench["workloads"] if w["name"] == args.workload)
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
    with open(ROOT / conf["file"]) as f:
        cfg = json.load(f)
    try:
        driver, d, ref = resolve(cfg)
    except Unresolved as e:
        print(f"{conf['name']}: {e}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    mix = traffic.load_mix(cell["traffic"], root=HERE)
    control = {int(s) for s in args.control.split(",") if s}
    out = open(args.out, "a") if args.out else None
    dev = torch.device("cuda")
    undo = faults.plant(args.fault, driver) if args.fault else None
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        served = driver.serve(d, mix, seed, args.seconds, dev)
        pick = check.served_sample(served.rec, served.outs, mix, seed)
        row = {"workload": args.workload, "seed": seed, "fault": args.fault,
               "finished": len(served.rec.completions), "picked": len(pick),
               "length_mismatches": check.length_mismatches(served.rec, served.outs),
               "checked_tokens": 0}
        if pick:
            row.update(check.reference_values(
                ref, d, seed, [served.prompts[k] for k in pick], [served.outs[k] for k in pick],
                dev, controls=args.readings.split(",") if seed in control else ()))
        row.update(verdicts(row, limits))
        row["seconds"] = time.perf_counter() - t0
        line = json.dumps(row)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()
        del served
        gc.collect()
        torch.cuda.empty_cache()
    if undo is not None:
        undo()
    return 0


if __name__ == "__main__":
    sys.path[0] = str(ROOT)
    sys.exit(main())
