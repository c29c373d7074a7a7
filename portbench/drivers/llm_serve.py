"""Driver of the LLM cells: csinn2_tpu_torch's InferenceEngine serving a
closed loop of requests through run_queue, the one entry the window drives.

Set-up (all of it counted in setup_s): the float weights from the seed,
quantized by the port's quantize_weight_device into the params the engine
takes; the engine and its int8 KV cache; the requests; one eager prefill
per prompt bucket the traffic reaches, and one decode step per step-graph
key it reaches (the graph is captured at a key's first chunk), the
sampler's first draw included.  Then run_queue over the whole request
list, with as many clients as lanes, until the Recorder closes the window.
"""

from __future__ import annotations

import dataclasses
import gc
from typing import List, Optional

import torch

from portbench import traffic, weights
from portbench.record import Recorder, WindowClosed

BUCKETS = (32, 64, 128, 256, 512, 1024, 2048)   # the engine's prompt buckets

dims = weights.dims       # the sizes this driver serves, from the configuration file
DECODE_STEP = ("csinn2_tpu_torch.llm.engine", "_batched_decode_forward")   # faults.plant's


def _round256(n: int, cap: int) -> int:
    return min(-(-n // 256) * 256, cap)


def buckets_for(prompt_lens) -> List[int]:
    return sorted({next(b for b in BUCKETS if n <= b) for n in prompt_lens})


def graph_bounds(reach: dict, chunk: int, cap: int) -> List[int]:
    """Every kv_bound the scheduler can ask for: round256(largest active
    position + steps + 1), from a lane just after its shortest prompt to
    the longest request's last chunk."""
    lo = _round256(reach["min_prompt"] + 2, cap)
    hi = _round256(reach["max_total"] + chunk, cap)
    return list(range(lo, hi + 1, 256))


@dataclasses.dataclass
class Served:
    rec: Recorder
    outs: List[Optional[list]]        # each request's served tokens, None if unfinished
    prompts: List[list]
    dims: dict
    memory_peak_bytes: int
    captures_in_window: int


def build_params(d: dict, seed: int, device, quantize):
    """The port's params dict from the seed's float weights."""
    params = {"tok_embedding": weights.embedding(d, seed, device),
              "norm": torch.ones(d["D"], dtype=torch.float32, device=device),
              "output": quantize(weights.head(d, seed, device), d["mode"]),
              "layers": []}
    for i in range(d["L"]):
        lp = {n: quantize(w, d["mode"]) for n, w in weights.layer(d, seed, i, device).items()}
        lp["attn_norm"] = torch.ones(d["D"], dtype=torch.float32, device=device)
        lp["ffn_norm"] = torch.ones(d["D"], dtype=torch.float32, device=device)
        params["layers"].append(lp)
    return params


def make_engine(d: dict, seed: int, device):
    from csinn2_tpu_torch.llm.config import LlamaConfig
    from csinn2_tpu_torch.llm.engine import InferenceEngine
    from csinn2_tpu_torch.llm.model import quantize_weight_device
    lcfg = LlamaConfig(dim=d["D"], n_layers=d["L"], n_heads=d["hq"], n_kv_heads=d["hk"],
                       ffn_dim=d["F"], vocab_size=d["V"], max_seq_len=d["S"],
                       norm_eps=d["eps"], rope_base=d["rope"], head_dim=d["dh"])
    params = build_params(d, seed, device, quantize_weight_device)
    return InferenceEngine(lcfg, params, batch=d["batch"], quantized_kv=True,
                           kv_scale=d["kv_scale"], device=device)


def _reset(eng) -> None:
    for s in eng.slots:
        s.pos, s.active, s.tokens = 0, False, []


def warm_up(eng, mix: dict, d: dict) -> None:
    """Run each shape the traffic reaches once: the prompt buckets, then
    the decode graphs' keys (kv_bound × greedy/sampled)."""
    reach = traffic.reachable(mix)
    temps = [0.0] + ([mix["temperature"]] if reach["sampled"] else [])
    for b in buckets_for(reach["prompt_lens"]):
        for t in temps:
            eng.prefill_sample(0, [1] * b, temperature=t, seed=0)
    _reset(eng)
    lanes = {sid: 1 for sid in range(eng.batch)}
    for bound in graph_bounds(reach, int(mix["chunk"]), d["S"]):
        for greedy in ([True] if not reach["sampled"] else [False]):
            for s in eng.slots:
                s.pos, s.active = 16, True
            eng.slots[0].pos = bound - 2           # _kv_bound(extra=2) == bound
            temp = 0.0 if greedy else [float(mix["temperature"])] * eng.batch
            eng.decode_steps(lanes, 1, temperature=temp, seed=0)
    _reset(eng)
    if eng.device.type == "cuda":
        torch.cuda.synchronize()


def serve(d: dict, mix: dict, seed: int, seconds: float, device, tracer=None,
          trace_seconds: float = 2.0, on_setup_done=None) -> Served:
    from csinn2_tpu_torch.llm.engine import Request
    eng = make_engine(d, seed, device)
    specs = traffic.make_requests(mix, d["V"], seed)
    reqs = [Request(prompt=s.prompt, max_new_tokens=s.max_new_tokens,
                    eos_id=mix.get("eos_id"), temperature=s.temperature) for s in specs]
    warm_up(eng, mix, d)
    graphs0 = len(eng._graphs)
    rec = Recorder(specs, d["batch"], seconds, tracer=tracer, trace_seconds=trace_seconds,
                   warm_in=int(mix.get("warm_in_completions", 0)))
    rec.install(eng)
    if on_setup_done is not None:
        on_setup_done()
    rec.begin()
    try:
        eng.run_queue(reqs, chunk=int(mix["chunk"]), seed=seed)
    except WindowClosed:
        pass
    else:
        raise RuntimeError(f"the window served all {len(reqs)} requests of the mix before "
                           f"it closed: the mix needs more requests")
    peak = torch.cuda.max_memory_allocated() if eng.device.type == "cuda" else 0
    outs = [list(r.out) if r.done else None for r in reqs]
    served = Served(rec=rec, outs=outs, prompts=[s.prompt for s in specs],
                    dims=d, memory_peak_bytes=int(peak),
                    captures_in_window=len(eng._graphs) - graphs0)
    del eng, reqs
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return served
