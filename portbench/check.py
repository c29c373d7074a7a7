"""Whether the served tokens are right: after the window, a sample of the
greedy requests the window finished, drawn from the seed with the longest
of them always in it, goes through the float32 reference (prompt and
served tokens, teacher-forced), and each served token is judged by how far
its reference logit lies below the reference's best at that position.

Numbers compared, each against the cell's limit (limits/<cell>.json):
  max_logit_gap     the widest such gap over the sample's served tokens;
  mean_logit_gap    the mean gap over them;
(each of the two compared where the cell's limits file gives it a limit,
at least one of them), and
  length_mismatches finished requests whose output is not exactly their
                    max_new_tokens (eos is off): exact, limit 0;
  checked_tokens    served tokens compared: at least 1.
The control (the reference at fp8 activations put in the program's place)
reads, at each position, the gap of the token IT puts first.

The reference is the module reference/<name>.py that the configuration
file's "reference" key names ("llama" where it names none; run.resolve
finds it before a run makes a weight).  It is plain PyTorch, imports
nothing of the program, and makes the model's inputs again from the seed.
Its one entry point:

  logits_at(d, seed, seqs, rows, device, act="f32", kv_bits=8)
    d        the driver's dims(cfg): the sizes the driver served;
    seed     the run's --seed, from which the weights are made again;
    seqs     token sequences (prompt + served tokens but the last);
    rows     for each sequence, the positions whose next token is judged;
    device   where to compute (the card after the window, or the CPU);
  → one float32 tensor [len(rows[j]), V] of logits for each sequence j.

With the defaults it computes in float32 (TF32 off).  The control keywords
in CONTROLS are read by calibrate.py only, never by a benchmark run, and a
reference has to accept them: act="fp8" (every matmul's activation input
rounded to e4m3, one scale a row: the control), act="bf16" (what the
configuration holds in bf16 rounded so), kv_bits=4 (the cache held in int4
over the int8 cache's range).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np

from portbench.traffic import sub_seed

HERE = Path(__file__).resolve().parent


def load_limits(cell: str, root: Path = HERE) -> dict:
    p = root / "limits" / f"{cell}.json"
    if not p.exists():
        return {}
    with open(p) as f:
        return json.load(f)


def pick(done: Sequence[int], sizes: Sequence[int], served: Sequence[int],
         served_tokens: int, max_requests: int, seed: int) -> List[int]:
    """Indices into `done`: the longest (prompt + output) first, then others
    in an order drawn from the seed, until the served tokens reach
    `served_tokens` or `max_requests` are taken."""
    if not done:
        return []
    first = max(range(len(done)), key=lambda i: (sizes[i], -i))
    rest = [i for i in np.random.default_rng(sub_seed(seed, "check")).permutation(len(done))
            if i != first]
    out, tok = [first], served[first]
    for i in rest:
        if tok >= served_tokens or len(out) >= max_requests:
            break
        out.append(int(i))
        tok += served[i]
    return [done[i] for i in out]


def gaps(ref_logits, tokens_at) -> tuple:
    """(max, mean) over rows of (best reference logit − reference logit of
    the token given for that row)."""
    import torch
    g = torch.cat([lg.max(dim=-1).values
                   - lg.gather(1, torch.as_tensor(list(t), device=lg.device).long()[:, None])[:, 0]
                   for lg, t in zip(ref_logits, tokens_at)])
    return float(g.max()), float(g.mean())


def teacher_forced(prompts, outs):
    """The token sequences the reference runs and the rows that predict
    each served token."""
    seqs = [list(p) + list(o[:-1]) for p, o in zip(prompts, outs)]
    rows = [range(len(p) - 1, len(p) - 1 + len(o)) for p, o in zip(prompts, outs)]
    return seqs, rows


GAPS = ("max_logit_gap", "mean_logit_gap")


def judge(values: dict, limits: dict) -> tuple:
    """→ (correct, the checks {name: {value, limit}} in a fixed order): the
    gaps that the limits file limits (none: not correct), the exact
    lengths, the count of tokens checked."""
    checks = {n: {"value": values.get(n), "limit": limits[n]["limit"]}
              for n in GAPS if n in limits}
    checks["length_mismatches"] = {"value": values["length_mismatches"], "limit": 0}
    checks["checked_tokens"] = {"value": values["checked_tokens"], "at_least": 1}
    ok = bool(limits) and all(c["value"] is not None and c["value"] <= c["limit"]
                              for n, c in checks.items() if n in GAPS)
    ok = ok and values["length_mismatches"] == 0 and values["checked_tokens"] >= 1
    return bool(ok), checks


CONTROLS = {"control": {"act": "fp8"}, "kv4": {"kv_bits": 4}, "bf16": {"act": "bf16"}}


def reference_values(reference, d: dict, seed: int, prompts, outs, device,
                     controls=()) -> dict:
    """The program's gaps over the served tokens, by the reference module's
    logits_at; for each named control (CONTROLS) also the gaps of the tokens
    the control puts first, at the same rows: <name>_max_gap, <name>_mean_gap."""
    seqs, rows = teacher_forced(prompts, outs)
    ref = reference.logits_at(d, seed, seqs, rows, device)
    mx, mean = gaps(ref, outs)
    out = {"max_logit_gap": mx, "mean_logit_gap": mean,
           "checked_tokens": int(sum(len(o) for o in outs))}
    for name in controls:
        ctl = reference.logits_at(d, seed, seqs, rows, device, **CONTROLS[name])
        mx, mean = gaps(ref, [c.argmax(dim=-1).tolist() for c in ctl])
        out.update({f"{name}_max_gap": mx, f"{name}_mean_gap": mean})
        del ctl
    return out


def lines(checks: dict) -> List[str]:
    return [f"check {k}: {v['value']} ("
            + (f"at least {v['at_least']}" if "at_least" in v else f"limit {v['limit']}") + ")"
            for k, v in checks.items()]


def length_mismatches(rec, served_outs) -> int:
    """Requests finished by the deadline whose output is not exactly their
    max_new_tokens long."""
    return sum(1 for k, r in enumerate(rec.reqs) if r.t_done is not None and r.t_done <= rec.deadline
               and (served_outs[k] is None or len(served_outs[k]) != r.max_new))


def served_sample(rec, served_outs, mix: dict, seed: int) -> Optional[List[int]]:
    """The requests to compare: greedy ones finished inside the window."""
    done = [k for k, r in enumerate(rec.reqs)
            if r.greedy and r.t_done is not None and rec.start <= r.t_done <= rec.deadline
            and served_outs[k] is not None]
    c = mix["check"]
    return pick(done, [rec.reqs[k].n_prompt + rec.reqs[k].max_new for k in done],
                [rec.reqs[k].max_new for k in done], c["served_tokens"], c["max_requests"], seed)
