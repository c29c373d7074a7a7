"""Inference engine: bucketed one-slot prefill, on-device sampling, chunked
batched decode, a continuous-batching scheduler and the benchmark methods —
counterpart of csinn2_tpu/llm/engine.py, on one device or over a (dp, tp)
process mesh (parallel/mesh.py).

Design, as in the JAX engine:
  * the KV cache is ONE static [L, B, S_max, Hk, Dh] buffer; slot (lane) b
    owns row b and sits at its own position.
  * prefill admits a prompt padded to a bucket length into ONE slot: the
    forward runs on the [L, 1, bound, Hk, Dh] view of that slot's rows
    (bound = the bucket rounded up to 256), so only that slot's rows move —
    here in place, where the JAX engine donates and scatters back.  On one
    card the forward is a captured CUDA graph, one a bucket (the JAX
    engine's jit per bucket), captured at the bucket's first prefill: it
    runs on a static [1, 2048] token buffer and a one-lane staging cache
    [L, 1, bound_max, Hk, Dh], whose rows [0, bucket) are copied into the
    slot's after the replay — the bytes the eager forward leaves there.  The
    first token is sampled outside the graph, from the graph's static
    logits, so the key is the bucket alone.  On the CPU, over a mesh and for
    MoE layers (whose routed/dense dispatch is not capturable) the forward
    is the eager one (_prefill_eager), which the card's tests hold the graph
    to.
  * decode runs ALL lanes in one step with per-row positions: each lane's
    new K/V row lands at its own position (lanes at pos >= S write nothing)
    and the decode attention kernel masks each row at its own kv_len.  A
    bound on the largest position (rounded to 256) limits the KV read.
  * decode_steps() runs a chunk of steps with on-device sampling and moves
    the sampled tokens to the host once, at the end of the chunk; the host
    scheduler admits prompts between chunks.  On the card the chunk replays
    a captured CUDA graph of one step (forward, sampling, pos + 1) — the
    counterpart of the JAX engine's lax.scan executable — once a step; one
    graph per key of what the JAX jit holds static (kv_bound, greedy,
    top_k, top_p).  The graphs work on static token / position /
    temperature buffers and the engine's cache, which prefill writes in
    place, so an admission between chunks is seen by the next replay.  On the CPU the chunk is the eager
    loop (_decode_steps_eager), which the card's tests hold the graph to.

Over a mesh (InferenceEngine(mesh=...)) every rank builds the engine on the
full params and runs the same host code, multi-controller: the weights are
fused per tp shard and sharded (parallel/tp.py), the rank's cache holds its
hk/tp heads of its dp group's batch/dp lanes.  Prefill runs the forward on
every rank, and only the dp group that owns the slot keeps the KV (the
others write a spare one-lane cache); decode runs each dp group's lanes and
gathers the logits and the sampled tokens over dp, so every rank's host
loop sees the same tokens.  Collectives: one all_reduce over tp after wo
and after w2 a layer, the vocab all_gather, the dp all_gather.  The decode
chunk is the step graph where the backend can capture its collectives
(NCCL) and the eager loop under gloo, whose collectives are staged through
the host: chosen once, at construction, from the backend.  Prefill over a
mesh is eager under every backend.
"""

from __future__ import annotations

import copy
import dataclasses
import sys
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from csinn2_tpu_torch.kernels.flash_attention import decode_attention
from csinn2_tpu_torch.llm.config import LlamaConfig
from csinn2_tpu_torch.llm.model import (KVCache, _project_qkv, decode_prologue,
                                        fuse_params, linear, llama_forward, rms_norm,
                                        rope_tables)
from csinn2_tpu_torch.llm.sampling import sample_host, sample_logits
from csinn2_tpu_torch.parallel.mesh import all_gather, all_reduce
from csinn2_tpu_torch.parallel.tp import local_config, shard_llama_params
from csinn2_tpu_torch.utils.cuda_graph import CountedGraph, capture
from csinn2_tpu_torch.utils.device import resolve_device
from csinn2_tpu_torch.utils.timing import long_minus_short


BUCKETS = (32, 64, 128, 256, 512, 1024, 2048)    # prompt lengths a prefill pads to


def _bucket(n: int, buckets=BUCKETS) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


def _round256(n: int, cap: int) -> int:
    return min(-(-n // 256) * 256, cap)


def _prefill_graphable(device: torch.device, mesh, layers) -> bool:
    """Whether prefill runs through the per-bucket graphs: on a card, with
    no mesh (a captured NCCL prefill has no card to check it on, gloo's
    collectives cannot be captured) and no MoE layer (llama_forward's
    routed/dense choice and its dispatch are not capturable as written)."""
    return device.type == "cuda" and mesh is None and not any("gate" in lp for lp in layers)


def _takes(req: "Request", seq: List[int]) -> int:
    """How many of a decode chunk's tokens `seq` a request keeps: up to its
    max_new_tokens, and none after its eos_id."""
    k, last = 0, req.out[-1] if req.out else None
    for t in seq:
        if len(req.out) + k >= req.max_new_tokens or \
                (req.eos_id is not None and last == req.eos_id):
            break
        k, last = k + 1, t
    return k


@dataclasses.dataclass
class Slot:
    """One continuous-batching lane."""

    id: int
    pos: int = 0                 # tokens currently in cache
    active: bool = False
    tokens: List[int] = dataclasses.field(default_factory=list)
    done: bool = False


@dataclasses.dataclass
class Request:
    """One queued generation request (continuous-batching unit of work)."""

    prompt: List[int]
    max_new_tokens: int = 32
    eos_id: Optional[int] = None
    temperature: float = 0.0
    out: List[int] = dataclasses.field(default_factory=list)
    slot: Optional[int] = None
    done: bool = False


class InferenceEngine:
    """Batch decode engine over a static KV cache on one device.

    prefill(): admits a prompt into one slot's cache rows (on one card
    through the prompt bucket's captured prefill graph; prefill_sample,
    generate and generate_fused take the same path).
    decode_step(): one token for every given slot (host-stepped).
    decode_steps(): a chunk of tokens for every given slot, sampled on the
    device (on the card through the captured step graph).  run_queue(): the
    continuous-batching scheduler over Requests.  benchmark_decode(),
    benchmark_decode_device(), benchmark_prefill_device(): tokens/s and
    seconds a prefill, as the JAX engine's methods.

    The engine fuses the params it is given (model.fuse_params: one GEMM
    for q|k|v and one for w1|w3) and keeps int4 weights in their one
    carrier, the packed bytes.

    mesh: a parallel.mesh.Mesh with dp and tp axes; every rank passes the
    FULL params, and the engine runs on mesh.device (`device` is not used).
    batch % dp == 0; lanes dp_idx·batch/dp .. belong to dp group dp_idx.

    tracer: a runtime/profiler.Tracer, or None (no span, no counter, no
    clock read); an attribute that may be set and cleared between calls.
    Spans, per call and per chunk: "sched.admit" (an admission wave of
    run_queue), "prefill" (prefill_sample; children "prefill.stage",
    ".forward", ".sample", ".fetch") and "decode.chunk" (decode_steps;
    children "decode.stage", ".capture", ".launch", ".fetch", ".commit").
    Counters: prefill.tokens, prefill.pad_tokens (bucket − prompt),
    prefill.graph_replays (prefills served by a bucket graph's replay) and
    prefill.graph_captures (its captures, inside ".forward"),
    decode.captures, decode.prologue_fused (the layers of each captured
    step whose attention prologue is the decode_prologue kernel: all of
    them), decode.replays, decode.lane_steps (batch × steps) and
    of them decode.lane_steps_idle (a lane with no request) and
    decode.lane_steps_past_end (a lane run past its request's last token:
    run_queue's chunks only); sched.lane_wait_ns over sched.lane_waits
    admissions of run_queue (from the chunk that freed the lane, or the
    call's start, to the admission's prefill).
    """

    def __init__(self, cfg: LlamaConfig, params, batch: int = 1,
                 quantized_kv: bool = False, kv_scale: float = 0.05,
                 device="cuda", mesh=None, tracer=None):
        self.mesh = mesh
        self.tracer = tracer
        self.cfg = cfg
        tp, dp = (mesh.size("tp"), mesh.size("dp")) if mesh is not None else (1, 1)
        if batch % dp:
            raise ValueError(f"batch {batch} is not a multiple of dp={dp}")
        if mesh is None:
            self.device = resolve_device(device)
            emb_dev = params["tok_embedding"].device
            if emb_dev.type != self.device.type:
                raise ValueError(f"params live on {emb_dev}, engine on {self.device}")
        else:
            self.device = mesh.device
        # one GEMM for q|k|v and one for w1|w3: 7 → 4 launches per layer
        params = fuse_params(params, tp=tp)
        self.lcfg = cfg                    # the config the rank's forward runs
        if mesh is not None:
            self.lcfg = local_config(cfg, tp)
            params = shard_llama_params(params, mesh)
        self.params = params
        self.batch = batch
        self.b_loc = batch // dp           # this rank's lanes
        self._tp_group = mesh.tp_group if mesh is not None else None
        self._dp_group = mesh.dp_group if mesh is not None else None
        self.cache = KVCache.create(self.lcfg, self.b_loc, quantized=quantized_kv,
                                    scale=kv_scale, device=self.device)
        # a dp group prefills slots it does not own into this one-lane cache
        self._spare = None if dp == 1 else KVCache.create(
            self.lcfg, 1, quantized=quantized_kv, scale=kv_scale, device=self.device)
        self.slots = [Slot(id=i) for i in range(batch)]
        # decode chunks through the step graph on the card, unless the
        # collectives are gloo's (host-staged, not capturable)
        backend = mesh.backend() if mesh is not None else None
        self._graph = self.device.type == "cuda" and backend != "gloo"
        if mesh is not None:
            print(f"InferenceEngine: {mesh}, backend {backend}: decode through "
                  f"{'the step graph' if self._graph else 'the eager loop'}",
                  file=sys.stderr, flush=True)
        # the decode step graphs (on the card): key → CountedGraph, their
        # static lanes (tokens, positions, temperatures), generator, memory
        # pool and capture stream, all made at the first capture
        self._graphs: Dict[tuple, CountedGraph] = {}
        self._static = None
        # the prefill graphs (on one card, see _prefill_graphable): bucket →
        # CountedGraph (its `out`: the static logits), and their static
        # tokens, staging cache, memory pool and capture stream, made at the
        # first prefill
        self._graph_prefill = _prefill_graphable(self.device, mesh, self.params["layers"])
        self._prefill_graphs: Dict[int, CountedGraph] = {}
        self._prefill_static = None

    @staticmethod
    def _seed_value(seed: int, salt: int) -> int:
        return (seed * 1_000_003 + salt) % 2**63

    def _generator(self, seed: int, salt: int) -> torch.Generator:
        g = torch.Generator(device=self.device)
        g.manual_seed(self._seed_value(seed, salt))
        return g

    # -- phases ----------------------------------------------------------------

    def _lane0(self) -> int:
        """The first global lane of this rank's dp group."""
        return self.mesh.index("dp") * self.b_loc if self.mesh is not None else 0

    def _prefill_local(self, tokens: torch.Tensor, slot: int) -> torch.Tensor:
        """Forward a [1, bucket] prompt on the view of `slot`'s first `bound`
        cache rows, written in place — or, on a rank whose dp group does not
        own the slot, of the spare cache's."""
        s = tokens.shape[1]
        bound = _round256(s, self.cfg.max_seq_len)
        row = slot - self._lane0()
        c = self.cache
        if not 0 <= row < self.b_loc:
            c, row = self._spare, 0
        sub = KVCache(k=c.k[:, row:row + 1, :bound],
                      v=c.v[:, row:row + 1, :bound], scale=c.scale)
        logits, _ = llama_forward(self.params, tokens, sub, 0, self.lcfg,
                                  kv_bound=bound, tp_group=self._tp_group)
        return logits

    def _prefill_graph(self, toks: torch.Tensor, slot: int, tr=None) -> torch.Tensor:
        """_prefill_local on one card, from the host's [1, bucket] tokens:
        the bucket's graph (captured at its first prefill) replayed on the
        static tokens and the one-lane staging cache, whose rows [0, bucket)
        are then copied into `slot`'s; → the graph's static logits [1,
        bucket, V], which the next replay overwrites.  tr: the Tracer whose
        "prefill.stage" span is open, or None."""
        s = toks.shape[1]
        bound = _round256(s, self.cfg.max_seq_len)
        st = self._prefill_static
        if st is None:
            c = self.cache
            shape = (c.k.shape[0], 1, _round256(BUCKETS[-1], self.cfg.max_seq_len),
                     *c.k.shape[3:])
            st = self._prefill_static = dict(
                tok=torch.zeros((1, BUCKETS[-1]), dtype=torch.long, device=self.device),
                k=torch.zeros(shape, dtype=c.k.dtype, device=self.device),
                v=torch.zeros(shape, dtype=c.v.dtype, device=self.device),
                pool=torch.cuda.graph_pool_handle(),
                stream=torch.cuda.Stream(device=self.device))
        st["tok"][:, :s].copy_(toks)
        if tr is not None:
            tr.phase("prefill.forward")
        graph = self._prefill_graphs.get(s)
        if graph is None:
            if tr is not None:
                tr.add("prefill.graph_captures")

            def forward():
                sub = KVCache(k=st["k"][:, :, :bound], v=st["v"][:, :, :bound],
                              scale=self.cache.scale)
                return llama_forward(self.params, st["tok"][:, :s], sub, 0, self.lcfg,
                                     kv_bound=bound)[0]

            graph = self._prefill_graphs[s] = capture(
                forward, "prefill_graph", stream=st["stream"], pool=st["pool"])
        if tr is not None:
            tr.add("prefill.graph_replays")
        graph.replay()
        self.cache.k[:, slot:slot + 1, :s].copy_(st["k"][:, :, :s])
        self.cache.v[:, slot:slot + 1, :s].copy_(st["v"][:, :, :s])
        return graph.out

    def prefill(self, slot_id: int, prompt: List[int]) -> np.ndarray:
        """Fill `slot_id`'s cache rows with the prompt; returns the logits of
        the last prompt position (host f32)."""
        return self._prefill_device(slot_id, prompt, self._graph_prefill).float().cpu().numpy()

    def _prefill_device(self, slot_id: int, prompt: List[int], graph: bool,
                        tr=None) -> torch.Tensor:
        """The last prompt position's logits, on the device.  graph: through
        the bucket's prefill graph, else the eager forward.  tr: the Tracer
        of prefill_sample's "prefill" span, or None."""
        slot = self.slots[slot_id]
        n = len(prompt)
        s = _bucket(n)
        if n == 0 or n > s or s > self.cfg.max_seq_len:
            raise ValueError(f"prompt of {n} tokens does not fit a bucket "
                             f"<= max_seq_len {self.cfg.max_seq_len}")
        if tr is not None:
            tr.begin("prefill.stage")
            tr.add("prefill.tokens", n)
            tr.add("prefill.pad_tokens", s - n)
        toks = torch.zeros((1, s), dtype=torch.long)
        toks[0, :n] = torch.as_tensor(prompt, dtype=torch.long)
        if graph:
            logits = self._prefill_graph(toks, slot_id, tr)
        else:
            toks = toks.to(self.device)
            if tr is not None:
                tr.phase("prefill.forward")
            logits = self._prefill_local(toks, slot_id)
        if tr is not None:
            tr.end()
        slot.pos = n
        slot.active = True
        slot.tokens = list(prompt)
        return logits[0, n - 1]

    def prefill_sample(self, slot_id: int, prompt: List[int],
                       temperature: float = 0.0, seed: int = 0,
                       top_k: int = 0, top_p: float = 1.0,
                       req: Optional[int] = None) -> int:
        """Admit a prompt AND sample its first token on the device, from a
        generator seeded by (seed, len(prompt)) — the same schedule in
        generate_fused and run_queue, so a sampled request reproduces.  On
        one card the forward is the bucket's prefill graph.
        req: the request's index in run_queue's list, for the tracer."""
        return self._first_token(self._graph_prefill, slot_id, prompt, temperature, seed,
                                 top_k, top_p, req)

    def _prefill_eager(self, slot_id: int, prompt: List[int], temperature: float = 0.0,
                       seed: int = 0, top_k: int = 0, top_p: float = 1.0,
                       req: Optional[int] = None) -> int:
        """prefill_sample through the eager forward on any device: the plain
        version the card's tests and chip_smoke.py hold the prefill graph to
        (it takes prefill_sample's place in run_queue)."""
        return self._first_token(False, slot_id, prompt, temperature, seed, top_k, top_p, req)

    def _first_token(self, graph, slot_id, prompt, temperature, seed, top_k, top_p,
                     req=None) -> int:
        tr = self.tracer
        if tr is not None:
            tr.begin("prefill", args={"req": req, "slot": slot_id, "n_prompt": len(prompt),
                                      "bucket": _bucket(len(prompt))})
        logits = self._prefill_device(slot_id, prompt, graph, tr)
        if tr is not None:
            tr.begin("prefill.sample")
        greedy = temperature <= 0
        gen = None if greedy else self._generator(seed, len(prompt))
        tok = sample_logits(logits.float(), gen,
                            temperature=max(temperature, 1e-6),
                            top_k=top_k, top_p=top_p, greedy=greedy)
        if tr is not None:
            tr.phase("prefill.fetch")
        tok = int(tok)
        if tr is not None:
            tr.end()
            tr.end()
        return tok

    def _kv_bound(self, extra: int = 1) -> int:
        mx = max((s.pos for s in self.slots if s.active), default=16)
        return _round256(mx + extra, self.cfg.max_seq_len)

    def _lanes(self, next_tokens: Dict[int, int]):
        """This rank's lanes of the tokens and positions, on the device."""
        toks = torch.zeros((self.batch,), dtype=torch.long)
        pos = torch.zeros((self.batch,), dtype=torch.int32)
        for sid, tok in next_tokens.items():
            toks[sid] = tok
            pos[sid] = self.slots[sid].pos
        lo = self._lane0()
        return (toks[lo:lo + self.b_loc].to(self.device),
                pos[lo:lo + self.b_loc].to(self.device))

    def decode_step(self, next_tokens: Dict[int, int]) -> Dict[int, np.ndarray]:
        """One decode step for the given {slot_id: token}; returns logits."""
        toks, pos = self._lanes(next_tokens)
        logits, self.cache = _batched_decode_forward(
            self.params, toks[:, None], self.cache, pos, self.lcfg,
            kv_bound=self._kv_bound(), tp_group=self._tp_group)
        logits = all_gather(logits, self._dp_group, 0, "dp")
        out = {}
        for sid in next_tokens:
            self.slots[sid].pos += 1
            self.slots[sid].tokens.append(next_tokens[sid])
            out[sid] = logits[sid, 0].float().cpu().numpy()
        return out

    def decode_steps(self, next_tokens: Dict[int, int], n_steps: int,
                     temperature=0.0, seed: int = 0, top_k: int = 0,
                     top_p: float = 1.0,
                     reqs: Optional[Dict[int, tuple]] = None) -> Dict[int, List[int]]:
        """n_steps decode steps for all given slots with on-device sampling;
        the tokens reach the host once, after the last step.  Returns
        {slot_id: [n_steps sampled tokens]}.  On the card each step replays
        the captured step graph of this chunk's key; on the CPU it is the
        eager loop.  reqs: {slot_id: (index in run_queue's list, Request)},
        for the tracer: the chunk's span names each lane's request, and the
        lane-steps past a request's end are counted."""
        chunk = self._graph_chunk if self._graph else self._eager_chunk
        return self._steps(chunk, next_tokens, n_steps, temperature, seed, top_k, top_p, reqs)

    def _decode_steps_eager(self, next_tokens: Dict[int, int], n_steps: int,
                            temperature=0.0, seed: int = 0, top_k: int = 0,
                            top_p: float = 1.0,
                            reqs: Optional[Dict[int, tuple]] = None) -> Dict[int, List[int]]:
        """decode_steps through the eager loop on any device: the plain
        version the card's tests and chip_smoke.py hold the graph to (it
        takes decode_steps' place in run_queue)."""
        return self._steps(self._eager_chunk, next_tokens, n_steps, temperature, seed,
                           top_k, top_p, reqs)

    def _steps(self, chunk, next_tokens, n_steps, temperature, seed, top_k, top_p,
               reqs=None):
        tr = self.tracer
        bound = self._kv_bound(extra=n_steps + 1)
        if tr is not None:
            tr.begin("decode.chunk", args={
                "n_steps": n_steps, "kv_bound": bound,
                "lanes": {sid: reqs[sid][0] if reqs else None for sid in next_tokens}})
            tr.begin("decode.stage")
        tok, pos = self._lanes(next_tokens)
        temp = np.asarray(temperature, np.float32)        # scalar or [B]
        greedy = bool(np.all(temp <= 0))
        lo = self._lane0()
        temp_b = np.maximum(temp, 1e-6) * np.ones(self.batch, np.float32)      # [B]
        temp_t = torch.from_numpy(temp_b[lo:lo + self.b_loc]).to(self.device)  # this rank's
        if n_steps > 0:
            sampled = chunk(tok, pos, temp_t, n_steps, bound, greedy, seed, top_k, top_p, tr)
            if tr is not None:
                tr.phase("decode.fetch")
            sampled = all_gather(sampled, self._dp_group, 1, "dp").cpu().numpy()  # [n, B]
        else:
            sampled = np.zeros((0, self.batch), np.int64)
        if tr is not None:
            tr.phase("decode.commit")
        out = {}
        for sid, t0 in next_tokens.items():
            seq = [int(t) for t in sampled[:, sid]]
            self.slots[sid].pos += n_steps
            self.slots[sid].tokens.extend([t0] + seq[:-1])
            out[sid] = seq
        if tr is not None:
            tr.add("decode.lane_steps", self.batch * n_steps)
            tr.add("decode.lane_steps_idle", (self.batch - len(next_tokens)) * n_steps)
            if reqs:
                tr.add("decode.lane_steps_past_end",
                       sum(n_steps - _takes(reqs[sid][1], seq) for sid, seq in out.items()))
            tr.end()
            tr.end()
        return out

    def _eager_chunk(self, tok, pos, temp, n_steps, bound, greedy, seed,
                     top_k, top_p, tr=None) -> torch.Tensor:
        """n_steps >= 1 steps of every lane, one chain of launches a step,
        from lanes tok / pos [B] → the sampled tokens [n, B].  tr: the
        Tracer whose "decode.stage" span is open, or None."""
        gen = None if greedy else self._generator(seed, 0)
        if tr is not None:
            tr.phase("decode.launch")
        steps = []
        for _ in range(n_steps):
            logits, _ = _batched_decode_forward(self.params, tok[:, None], self.cache, pos,
                                                self.lcfg, kv_bound=bound,
                                                tp_group=self._tp_group)
            tok = sample_logits(logits[:, 0], gen, temperature=temp, top_k=top_k,
                                top_p=top_p, greedy=greedy)
            pos = pos + 1
            steps.append(tok)
        return torch.stack(steps)

    def _graph_chunk(self, tok, pos, temp, n_steps, bound, greedy, seed,
                     top_k, top_p, tr=None) -> torch.Tensor:
        """_eager_chunk on the card: the key's step graph (captured at its
        first chunk) replayed n_steps times; each replay's token is copied
        out of the static lane buffer."""
        if greedy:
            top_k, top_p = 0, 1.0
        key = (bound, greedy, int(top_k), float(top_p))
        if self._static is None:
            b = self.b_loc
            self._static = dict(
                tok=torch.zeros((b,), dtype=torch.long, device=self.device),
                pos=torch.zeros((b,), dtype=torch.int32, device=self.device),
                temp=torch.ones((b,), dtype=torch.float32, device=self.device),
                gen=torch.Generator(device=self.device),
                pool=torch.cuda.graph_pool_handle(),
                stream=torch.cuda.Stream(device=self.device))
        st = self._static

        def load_lanes():
            st["tok"].copy_(tok)
            st["pos"].copy_(pos)
            st["temp"].copy_(temp)

        load_lanes()
        graph = self._graphs.get(key)
        if graph is None:
            if tr is not None:
                tr.phase("decode.capture")
                tr.add("decode.captures")
            gen = None if greedy else st["gen"]

            def step():
                logits, _ = _batched_decode_forward(self.params, st["tok"][:, None],
                                                    self.cache, st["pos"], self.lcfg,
                                                    kv_bound=bound, tp_group=self._tp_group)
                nxt = sample_logits(logits[:, 0], gen, temperature=st["temp"],
                                    top_k=top_k, top_p=top_p, greedy=greedy)
                st["tok"].copy_(nxt)
                st["pos"].add_(1)

            graph = self._graphs[key] = capture(
                step, "decode_graph", stream=st["stream"], pool=st["pool"],
                generators=() if greedy else (st["gen"],))
            if tr is not None:
                tr.add("decode.prologue_fused", graph.tally["decode_prologue"])
            load_lanes()              # the warm-up step advanced the lanes
        if tr is not None:
            tr.phase("decode.launch")
            tr.add("decode.replays", n_steps)
        if not greedy:
            st["gen"].manual_seed(self._seed_value(seed, 0))
        out = torch.empty((n_steps, self.b_loc), dtype=torch.long, device=self.device)
        for i in range(n_steps):
            graph.replay()
            out[i].copy_(st["tok"])
        return out

    # -- continuous-batching scheduler ------------------------------------------

    def run_queue(self, requests: Sequence[Request], chunk: int = 16,
                  seed: int = 0) -> List[Request]:
        """Continuous batching: admit prompts into free lanes as they open,
        decode all active lanes together in chunks between admissions.  Each
        request collects its completion in `req.out`; returns the same list,
        all done."""
        queue = list(enumerate(requests))    # (index, request), in admission order
        pending: Dict[int, tuple] = {}       # slot -> (index, in-flight request)
        next_tok: Dict[int, int] = {}        # slot -> next token to feed
        step_seed = seed
        # tracer only: slot -> perf_counter_ns when its lane was freed
        freed: Dict[int, int] = {}
        if self.tracer is not None:
            t_call = time.perf_counter_ns()
            freed = {slot.id: t_call for slot in self.slots if not slot.active}

        def admit():
            tr = self.tracer
            admitted = 0
            for slot in self.slots:
                if slot.active or not queue:
                    continue
                k, req = queue.pop(0)
                if tr is not None:
                    if not admitted:
                        tr.begin("sched.admit")
                    t_free = freed.pop(slot.id, None)
                    if t_free is not None:
                        tr.add("sched.lane_wait_ns", time.perf_counter_ns() - t_free)
                        tr.add("sched.lane_waits")
                admitted += 1
                tok = self.prefill_sample(slot.id, req.prompt,
                                          temperature=req.temperature,
                                          seed=seed, req=k)
                req.slot = slot.id
                req.out = [tok]
                pending[slot.id] = (k, req)
                next_tok[slot.id] = tok
            if tr is not None and admitted:
                tr.end(args={"admitted": admitted, "queue_left": len(queue)})

        admit()
        while pending:
            n = min(chunk, max(req.max_new_tokens - len(req.out)
                               for _, req in pending.values()))
            n = max(n, 1)
            # per-row temperature: greedy requests ride along at temp≈0
            temp = np.full((self.batch,), 1e-6, np.float32)
            any_sampled = False
            for sid, (_, req) in pending.items():
                temp[sid] = max(req.temperature, 1e-6)
                any_sampled |= req.temperature > 0
            step_seed += 1
            outs = self.decode_steps(dict(next_tok), n,
                                     temperature=temp if any_sampled else 0.0,
                                     seed=step_seed, reqs=pending)
            tr = self.tracer
            if tr is not None:
                t_end = time.perf_counter_ns()
            for sid, seq in outs.items():
                req = pending[sid][1]
                req.out.extend(seq[:_takes(req, seq)])
                finished = (len(req.out) >= req.max_new_tokens or
                            (req.eos_id is not None and req.eos_id in req.out))
                if finished:
                    if req.eos_id is not None and req.eos_id in req.out:
                        req.out = req.out[:req.out.index(req.eos_id) + 1]
                    req.done = True
                    self.slots[sid].active = False
                    self.slots[sid].pos = 0
                    del pending[sid]
                    del next_tok[sid]
                    if tr is not None:
                        freed[sid] = t_end
                else:
                    next_tok[sid] = req.out[-1]
            admit()                           # refill freed lanes
        return list(requests)

    # -- single-sequence convenience ---------------------------------------------

    def generate(self, prompt: List[int], max_new_tokens: int = 32,
                 temperature: float = 0.0, seed: int = 0, top_k: int = 0,
                 top_p: float = 1.0) -> List[int]:
        """Single-sequence loop, host-stepped, sampled on the host."""
        logits = self.prefill(0, prompt)
        rng = np.random.default_rng(seed)
        out = []
        tok = sample_host(logits, temperature, rng, top_k, top_p)
        for _ in range(max_new_tokens - 1):
            out.append(tok)
            logits = self.decode_step({0: tok})[0]
            tok = sample_host(logits, temperature, rng, top_k, top_p)
        out.append(tok)
        return out

    def generate_fused(self, prompt: List[int], max_new_tokens: int = 32,
                       temperature: float = 0.0, seed: int = 0,
                       top_k: int = 0, top_p: float = 1.0) -> List[int]:
        """Like generate(), but every token is sampled on the device; token
        for token the same as a single-request run_queue with the same seed
        (whose first decode chunk uses seed + 1, as this does)."""
        first = self.prefill_sample(0, prompt, temperature=temperature,
                                    seed=seed, top_k=top_k, top_p=top_p)
        seq = self.decode_steps({0: first}, max_new_tokens - 1,
                                temperature=temperature, seed=seed + 1,
                                top_k=top_k, top_p=top_p)[0]
        return [first] + seq

    # -- benchmarking ------------------------------------------------------------

    def benchmark_decode(self, iters: int = 20, warmup: int = 3) -> float:
        """tokens/s of a full decode batch (all slots active at position >=
        16), host-driven: one eager decode_step a token, its logits fetched."""
        toks = {i: 1 for i in range(self.batch)}
        for s in self.slots:
            s.pos = max(s.pos, 16)
            s.active = True
        for _ in range(warmup):
            self.decode_step(toks)
        t0 = time.perf_counter()
        for _ in range(iters):
            self.decode_step(toks)
        return self.batch * iters / (time.perf_counter() - t0)

    def _scratch(self) -> "InferenceEngine":
        """An engine on the same weights with one lane a dp group (batch 1
        on one device) and a zeroed cache of this engine's kind: a
        benchmark's own, gone with its graphs after it."""
        eng = copy.copy(self)
        c = self.cache
        eng.batch, eng.b_loc = self.batch // self.b_loc, 1
        eng.slots = [Slot(id=i) for i in range(eng.batch)]
        eng.cache = KVCache(k=torch.zeros_like(c.k[:, :1]), v=torch.zeros_like(c.v[:, :1]),
                            scale=c.scale)
        eng._graphs, eng._static = {}, None
        eng._prefill_graphs, eng._prefill_static = {}, None
        return eng

    def benchmark_prefill_device(self, n_prompt: int = 128, iters: int = 8,
                                 reps: int = 3) -> float:
        """Seconds of one prefill at the prompt's bucket (forward and the
        cache writes) into slot 0 of a scratch cache, the engine's cache
        untouched: long-minus-short over 1 and 1 + iters prefills of the
        prompt and the prompt + 1 in turns (utils/timing.long_minus_short).
        On the card both prompts' prefills are captured graphs and the loop
        replays them, so the time is the device's; on the CPU the loop is
        eager under the host clock."""
        s = _bucket(n_prompt)
        toks = torch.zeros((1, s), dtype=torch.long)
        toks[0, :n_prompt] = torch.arange(n_prompt) % 997 + 1
        toks = [toks.to(self.device), (toks + 1).to(self.device)]
        scratch = self._scratch()
        if self._graph:
            stream, pool = torch.cuda.Stream(device=self.device), torch.cuda.graph_pool_handle()
            graphs = [capture(lambda t=t: scratch._prefill_local(t, 0), "prefill_graph",
                              stream=stream, pool=pool) for t in toks]
            step = lambda i: graphs[i % 2].replay()     # noqa: E731
        else:
            step = lambda i: scratch._prefill_local(toks[i % 2], 0)   # noqa: E731

        def run(n):
            for i in range(n):
                step(i)
        return long_minus_short(run, 1, iters, reps, device=self.device)

    def benchmark_decode_device(self, iters: int = 64, reps: int = 3,
                                pos0: int = 16) -> float:
        """tokens/s of the full batch through decode_steps' loop (the step
        graph on the card), greedy from token 1 at position pos0 in every
        lane: long-minus-short over base and base + iters steps (base =
        max(iters // 16, 2)), so set-up and the tokens' fetch cancel.  As in
        the JAX engine, batch 1 decodes on a zeroed scratch cache and leaves
        the engine's untouched; a larger batch decodes on the engine's cache,
        which it overwrites from pos0 on.  The slots are not changed."""
        base = max(iters // 16, 2)
        bound = _round256(pos0 + base + iters + 1, self.cfg.max_seq_len)
        eng = self._scratch() if self.batch == 1 else self
        chunk = eng._graph_chunk if self._graph else eng._eager_chunk
        tok = torch.ones((eng.b_loc,), dtype=torch.long, device=self.device)
        pos = torch.full((eng.b_loc,), pos0, dtype=torch.int32, device=self.device)
        temp = torch.ones((eng.b_loc,), dtype=torch.float32, device=self.device)
        dt = long_minus_short(              # seconds a step
            lambda n: chunk(tok, pos, temp, n, bound, True, 0, 0, 1.0),
            base, iters, reps, device=self.device)
        return self.batch / dt


def _batched_decode_forward(params, tokens, cache: KVCache, pos_vec,
                            cfg: LlamaConfig, kv_bound: Optional[int] = None, tp_group=None):
    """Decode with per-row positions: like llama_forward at s = 1 but pos is
    a vector [B].  RoPE, the KV store and the attention mask use each row's
    own position.  Unlike model.py's bf16 internal linears, the linears here
    return f32 and silu(h1)·h3 is taken in f32, as in the JAX engine.

    Attention: decode_attention, each row masked at kv_len = pos + 1.

    tp_group: cfg is the rank's local config; the f32 outputs of wo and w2
    are summed over the group and the vocab shards of the logits gathered,
    as the JAX engine's psums and all_gather."""
    b, s = tokens.shape
    if s != 1:
        raise ValueError(f"decode takes one token per lane, got {s}")
    if any("gate" in lp for lp in params["layers"]):
        # the JAX engine's batched decode has no MoE branch either (its
        # linear fails on the stacked [E, K, N] experts); MoE prefill runs
        # through llama_forward
        raise ValueError("the batched decode has no MoE branch: a model with "
                         "n_experts serves prefill (llama_forward) only")
    x = params["tok_embedding"][tokens.long()]            # [b, 1, D] bf16
    hq, hk, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    D = hq * dh
    S = cache.k.shape[2]
    # per-row RoPE trig depends only on pos_vec — one evaluation, all layers
    rtabs = rope_tables(pos_vec[:, None], dh, cfg.rope_base)
    kv_len = pos_vec + 1
    for i, lp in enumerate(params["layers"]):
        h = rms_norm(x, lp["attn_norm"], cfg.norm_eps).to(torch.bfloat16)
        qk, v = _project_qkv(h, lp, hq, hk, dh)
        # RoPE on the q|k heads, the K/V rows stored at each lane's position
        # (lanes at pos >= S write nothing): one kernel on the card
        q = decode_prologue(qk, v, rtabs, pos_vec, cache, i)

        k_all, v_all = cache.k[i], cache.v[i]             # [b, S, hk, dh]
        if kv_bound is not None and kv_bound < S:
            k_all, v_all = k_all[:, :kv_bound], v_all[:, :kv_bound]
        q_t = q.permute(0, 2, 1, 3)                        # [b, hq, 1, dh] bf16
        k_t, v_t = k_all.permute(0, 2, 1, 3), v_all.permute(0, 2, 1, 3)
        attn = decode_attention(q_t, k_t, v_t, q_offset=pos_vec, kv_len=kv_len,
                                kv_scale=cache.scale)      # [b, hq, 1, dh]
        attn = attn.permute(0, 2, 1, 3).reshape(b, 1, D).to(torch.bfloat16)
        x = x + all_reduce(linear(attn, lp["wo"]), tp_group, "wo").to(x.dtype)

        h = rms_norm(x, lp["ffn_norm"], cfg.norm_eps).to(torch.bfloat16)
        x = x + all_reduce(linear(_swiglu_hidden(h, lp), lp["w2"]), tp_group,
                           "w2").to(x.dtype)

    x = rms_norm(x, params["norm"], cfg.norm_eps).to(torch.bfloat16)
    return all_gather(linear(x, params["output"]), tp_group, -1, "logits"), cache


def _swiglu_hidden(h, lp):
    """silu(w1 h)·(w3 h) of one decode layer, from f32 linears, as bf16."""
    if "w13" in lp and lp["w13"].layout == "swiglu128":
        # the pairs in the GEMM's epilogue, in f32.  (The JAX engine's decode
        # splits a swiglu128 h13 in halves here, which mixes w1 and w3
        # columns: see ROADMAP queue C.)
        return linear(h, lp["w13"], swiglu=True).to(torch.bfloat16)
    if "w13" in lp:
        h13 = linear(h, lp["w13"])
        Fd = h13.shape[-1] // 2
        h1, h3 = h13[..., :Fd], h13[..., Fd:]
    else:
        h1 = linear(h, lp["w1"])
        h3 = linear(h, lp["w3"])
    return (F.silu(h1) * h3).to(torch.bfloat16)
