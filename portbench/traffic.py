"""The one traffic generator: a mix file (traffic/<name>.json) and a seed →
the ordered list of requests a closed loop sends.

Every seed gets the same work.  Requests come in blocks of `block`; each
block holds the same multiset of prompt lengths and the same multiset of
output lengths, the stratified quantiles (i + 0.5) / block of a lognormal
(median, sigma) clipped to [min, max], shuffled inside each block (prompt
and output lengths apart) by a stream that is the same for every seed.
The run's seed draws the prompt token ids, uniform over the vocabulary.
So every seed sends the same lengths in the same order: in a closed loop
the order decides which requests share an admission, and with it the
tails of the time to first token and between tokens, so an order drawn
from the seed would make the seed change the work.

Mix keys: loop ("closed": a client sends its next request when its last
one completes, one client a lane); prompt_len / output_len {median, sigma, min, max}; max_total (an
output is cut so that prompt + output <= max_total, or null); temperature
(> 0: sampled) and greedy_every (every n-th request of a block is greedy,
so that the output check has greedy tokens to compare; 1 = all greedy);
eos_id (null: each request decodes exactly its output length); chunk (the
scheduler's decode chunk); warm_in_completions (the window opens once
this many requests have finished, past the start's burst of sends);
requests (how many the list holds; a window that serves them all is an
error, never a short run); check
{served_tokens, max_requests} (the size of the output check's sample);
source, from_source, assumed (the published trace the lengths come from,
what of them is taken from it, and what the mix assumes: read by no code).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import math
import statistics
from pathlib import Path
from typing import List

import numpy as np

HERE = Path(__file__).resolve().parent


@dataclasses.dataclass
class Spec:
    """One request as the generator makes it."""

    prompt: List[int]
    max_new_tokens: int
    temperature: float


def load_mix(name: str, root: Path = HERE) -> dict:
    with open(root / "traffic" / f"{name}.json") as f:
        return json.load(f)


def sub_seed(seed: int, tag: str) -> int:
    """A 63-bit seed for one named stream of the run's seed: the same in
    every process, for any integer seed (negative or past 64 bits too)."""
    h = hashlib.sha256(f"{int(seed)}:{tag}".encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def stratified_lengths(dist: dict, n: int) -> List[int]:
    """n lengths at the quantiles (i + 0.5) / n of the clipped lognormal."""
    nd = statistics.NormalDist()
    out = []
    for i in range(n):
        z = nd.inv_cdf((i + 0.5) / n)
        v = round(dist["median"] * math.exp(dist["sigma"] * z))
        out.append(int(min(max(v, dist["min"]), dist["max"])))
    return out


def make_requests(mix: dict, vocab: int, seed: int) -> List[Spec]:
    if mix["loop"] != "closed" or mix["output_len"]["min"] < 2:
        raise ValueError("the generator makes closed-loop traffic of outputs >= 2 tokens")
    block = int(mix["block"])
    n_req = int(mix["requests"])
    p_base = stratified_lengths(mix["prompt_len"], block)
    o_base = stratified_lengths(mix["output_len"], block)
    order = np.random.default_rng(sub_seed(0, "order"))
    rng = np.random.default_rng(sub_seed(seed, "traffic"))
    every = int(mix.get("greedy_every", 1))
    temp = float(mix.get("temperature", 0.0))
    cap = mix.get("max_total")
    specs = []
    for b0 in range(0, n_req, block):
        p_lens = order.permutation(p_base)
        o_lens = order.permutation(o_base)
        for i in range(min(block, n_req - b0)):
            n_p, n_o = int(p_lens[i]), int(o_lens[i])
            if cap is not None:
                n_o = min(n_o, int(cap) - n_p)
            ids = rng.integers(0, vocab, size=n_p, dtype=np.int64)
            greedy = temp <= 0 or (i % every) == every - 1
            specs.append(Spec(prompt=ids.tolist(), max_new_tokens=n_o,
                              temperature=0.0 if greedy else temp))
    return specs


def reachable(mix: dict) -> dict:
    """What shapes the mix can make the scheduler run: prompt lengths, the
    largest prompt + output, and whether any request samples (every mix
    has greedy requests)."""
    block = int(mix["block"])
    p = stratified_lengths(mix["prompt_len"], block)
    o = stratified_lengths(mix["output_len"], block)
    cap = mix.get("max_total")
    longest = max(p) + max(o) if cap is None else min(max(p) + max(o), int(cap))
    sampled = float(mix.get("temperature", 0.0)) > 0 and int(mix.get("greedy_every", 1)) > 1
    return {"prompt_lens": sorted(set(p)), "min_prompt": min(p), "max_total": longest,
            "sampled": sampled}
