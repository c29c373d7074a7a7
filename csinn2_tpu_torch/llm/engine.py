"""Inference engine on one device: bucketed one-slot prefill, on-device
sampling, chunked batched decode, a continuous-batching scheduler and the
benchmark methods — counterpart of csinn2_tpu/llm/engine.py (single device;
the mesh is not ported yet).

Design, as in the JAX engine:
  * the KV cache is ONE static [L, B, S_max, Hk, Dh] buffer; slot (lane) b
    owns row b and sits at its own position.
  * prefill admits a prompt padded to a bucket length into ONE slot: the
    forward runs on the [L, 1, bound, Hk, Dh] view of that slot's rows
    (bound = the bucket rounded up to 256), so only that slot's rows move —
    here in place, where the JAX engine donates and scatters back.
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
    top_k, top_p, CSINN2_DECODE_ATTN read at capture).  The
    graphs work on static token / position / temperature buffers and the
    engine's cache, which prefill writes in place, so an admission between
    chunks is seen by the next replay.  On the CPU the chunk is the eager
    loop (_decode_steps_eager), which the card's tests hold the graph to.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from csinn2_tpu_torch.kernels.flash_attention import decode_attention, flash_attention
from csinn2_tpu_torch.llm.config import LlamaConfig
from csinn2_tpu_torch.llm.model import (KVCache, _project_qkv, fuse_params,
                                        has_int4, linear, llama_forward,
                                        native4_params, quantize_kv, rms_norm,
                                        rope_rotate, rope_tables)
from csinn2_tpu_torch.llm.sampling import sample_host, sample_logits
from csinn2_tpu_torch.utils.cuda_graph import CountedGraph, capture
from csinn2_tpu_torch.utils.device import resolve_device
from csinn2_tpu_torch.utils.timing import long_minus_short


def _bucket(n: int, buckets=(32, 64, 128, 256, 512, 1024, 2048)) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


def _round256(n: int, cap: int) -> int:
    return min(-(-n // 256) * 256, cap)


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

    prefill(): admits a prompt into one slot's cache rows.
    decode_step(): one token for every given slot (host-stepped).
    decode_steps(): a chunk of tokens for every given slot, sampled on the
    device (on the card through the captured step graph).  run_queue(): the
    continuous-batching scheduler over Requests.  benchmark_decode(),
    benchmark_decode_device(), benchmark_prefill_device(): tokens/s and
    seconds a prefill, as the JAX engine's methods.

    native_int4: as in the JAX engine, None picks the native int4 carrier
    for int4 weights on the card and True/False force it; the port has one
    int4 carrier (model.native4_params), so every value gives the same
    weights and the same tokens.
    """

    def __init__(self, cfg: LlamaConfig, params, batch: int = 1,
                 quantized_kv: bool = False, kv_scale: float = 0.05,
                 fuse_weights: bool = True, device="cuda",
                 native_int4: Optional[bool] = None):
        self.device = resolve_device(device)
        emb_dev = params["tok_embedding"].device
        if emb_dev.type != self.device.type:
            raise ValueError(f"params live on {emb_dev}, engine on {self.device}")
        self.cfg = cfg
        if fuse_weights:
            # one GEMM for q|k|v and one for w1|w3: 7 → 4 launches per layer
            params = fuse_params(params)
        self._native4 = bool(has_int4(params) and self.device.type == "cuda"
                             if native_int4 is None else native_int4)
        self.params = native4_params(params) if self._native4 else params
        self.batch = batch
        self.cache = KVCache.create(cfg, batch, quantized=quantized_kv,
                                    scale=kv_scale, device=self.device)
        self.slots = [Slot(id=i) for i in range(batch)]
        # the decode step graphs (on the card): key → CountedGraph, their
        # static lanes (tokens, positions, temperatures), generator, memory
        # pool and capture stream, all made at the first capture
        self._graphs: Dict[tuple, CountedGraph] = {}
        self._static = None

    @staticmethod
    def _seed_value(seed: int, salt: int) -> int:
        return (seed * 1_000_003 + salt) % 2**63

    def _generator(self, seed: int, salt: int) -> torch.Generator:
        g = torch.Generator(device=self.device)
        g.manual_seed(self._seed_value(seed, salt))
        return g

    # -- phases ----------------------------------------------------------------

    def _prefill_local(self, tokens: torch.Tensor, slot: int) -> torch.Tensor:
        """Forward a [1, bucket] prompt on the view of `slot`'s first `bound`
        cache rows; the cache is written in place."""
        s = tokens.shape[1]
        bound = _round256(s, self.cfg.max_seq_len)
        c = self.cache
        sub = KVCache(k=c.k[:, slot:slot + 1, :bound],
                      v=c.v[:, slot:slot + 1, :bound], scale=c.scale)
        logits, _ = llama_forward(self.params, tokens, sub, 0, self.cfg,
                                  kv_bound=bound)
        return logits

    def prefill(self, slot_id: int, prompt: List[int]) -> np.ndarray:
        """Fill `slot_id`'s cache rows with the prompt; returns the logits of
        the last prompt position (host f32)."""
        return self._prefill_device(slot_id, prompt).float().cpu().numpy()

    def _prefill_device(self, slot_id: int, prompt: List[int]) -> torch.Tensor:
        slot = self.slots[slot_id]
        n = len(prompt)
        s = _bucket(n)
        if n == 0 or n > s or s > self.cfg.max_seq_len:
            raise ValueError(f"prompt of {n} tokens does not fit a bucket "
                             f"<= max_seq_len {self.cfg.max_seq_len}")
        toks = torch.zeros((1, s), dtype=torch.long)
        toks[0, :n] = torch.as_tensor(prompt, dtype=torch.long)
        logits = self._prefill_local(toks.to(self.device), slot_id)
        slot.pos = n
        slot.active = True
        slot.tokens = list(prompt)
        return logits[0, n - 1]

    def prefill_sample(self, slot_id: int, prompt: List[int],
                       temperature: float = 0.0, seed: int = 0,
                       top_k: int = 0, top_p: float = 1.0) -> int:
        """Admit a prompt AND sample its first token on the device, from a
        generator seeded by (seed, len(prompt)) — the same schedule in
        generate_fused and run_queue, so a sampled request reproduces."""
        logits = self._prefill_device(slot_id, prompt)
        greedy = temperature <= 0
        gen = None if greedy else self._generator(seed, len(prompt))
        tok = sample_logits(logits.float(), gen,
                            temperature=max(temperature, 1e-6),
                            top_k=top_k, top_p=top_p, greedy=greedy)
        return int(tok)

    def _kv_bound(self, extra: int = 1) -> int:
        mx = max((s.pos for s in self.slots if s.active), default=16)
        return _round256(mx + extra, self.cfg.max_seq_len)

    def _lanes(self, next_tokens: Dict[int, int]):
        toks = torch.zeros((self.batch,), dtype=torch.long)
        pos = torch.zeros((self.batch,), dtype=torch.int32)
        for sid, tok in next_tokens.items():
            toks[sid] = tok
            pos[sid] = self.slots[sid].pos
        return toks.to(self.device), pos.to(self.device)

    def decode_step(self, next_tokens: Dict[int, int]) -> Dict[int, np.ndarray]:
        """One decode step for the given {slot_id: token}; returns logits."""
        toks, pos = self._lanes(next_tokens)
        logits, self.cache = _batched_decode_forward(
            self.params, toks[:, None], self.cache, pos, self.cfg,
            kv_bound=self._kv_bound())
        out = {}
        for sid in next_tokens:
            self.slots[sid].pos += 1
            self.slots[sid].tokens.append(next_tokens[sid])
            out[sid] = logits[sid, 0].float().cpu().numpy()
        return out

    def decode_steps(self, next_tokens: Dict[int, int], n_steps: int,
                     temperature=0.0, seed: int = 0, top_k: int = 0,
                     top_p: float = 1.0) -> Dict[int, List[int]]:
        """n_steps decode steps for all given slots with on-device sampling;
        the tokens reach the host once, after the last step.  Returns
        {slot_id: [n_steps sampled tokens]}.  On the card each step replays
        the captured step graph of this chunk's key; on the CPU it is the
        eager loop."""
        chunk = self._graph_chunk if self.device.type == "cuda" else self._eager_chunk
        return self._steps(chunk, next_tokens, n_steps, temperature, seed, top_k, top_p)

    def _decode_steps_eager(self, next_tokens: Dict[int, int], n_steps: int,
                            temperature=0.0, seed: int = 0, top_k: int = 0,
                            top_p: float = 1.0) -> Dict[int, List[int]]:
        """decode_steps through the eager loop on any device: the plain
        version the card's tests and chip_smoke.py hold the graph to."""
        return self._steps(self._eager_chunk, next_tokens, n_steps, temperature, seed,
                           top_k, top_p)

    def _steps(self, chunk, next_tokens, n_steps, temperature, seed, top_k, top_p):
        tok, pos = self._lanes(next_tokens)
        temp = np.asarray(temperature, np.float32)        # scalar or [B]
        greedy = bool(np.all(temp <= 0))
        temp_t = torch.from_numpy(np.maximum(temp, 1e-6) * np.ones(self.batch, np.float32)
                                  ).to(self.device)       # [B]
        if n_steps > 0:
            sampled = chunk(tok, pos, temp_t, n_steps,
                            self._kv_bound(extra=n_steps + 1), greedy, seed, top_k,
                            top_p).cpu().numpy()           # [n_steps, B]
        else:
            sampled = np.zeros((0, self.batch), np.int64)
        out = {}
        for sid, t0 in next_tokens.items():
            seq = [int(t) for t in sampled[:, sid]]
            self.slots[sid].pos += n_steps
            self.slots[sid].tokens.extend([t0] + seq[:-1])
            out[sid] = seq
        return out

    def _eager_chunk(self, tok, pos, temp, n_steps, bound, greedy, seed,
                     top_k, top_p) -> torch.Tensor:
        """n_steps >= 1 steps of every lane, one chain of launches a step,
        from lanes tok / pos [B] → the sampled tokens [n, B]."""
        gen = None if greedy else self._generator(seed, 0)
        steps = []
        for _ in range(n_steps):
            logits, _ = _batched_decode_forward(self.params, tok[:, None], self.cache, pos,
                                                self.cfg, kv_bound=bound)
            tok = sample_logits(logits[:, 0], gen, temperature=temp, top_k=top_k,
                                top_p=top_p, greedy=greedy)
            pos = pos + 1
            steps.append(tok)
        return torch.stack(steps)

    def _graph_chunk(self, tok, pos, temp, n_steps, bound, greedy, seed,
                     top_k, top_p) -> torch.Tensor:
        """_eager_chunk on the card: the key's step graph (captured at its
        first chunk) replayed n_steps times; each replay's token is copied
        out of the static lane buffer."""
        if greedy:
            top_k, top_p = 0, 1.0
        flash = os.environ.get("CSINN2_DECODE_ATTN") == "flash"
        key = (bound, greedy, int(top_k), float(top_p), flash)
        if self._static is None:
            self._static = dict(
                tok=torch.zeros((self.batch,), dtype=torch.long, device=self.device),
                pos=torch.zeros((self.batch,), dtype=torch.int32, device=self.device),
                temp=torch.ones((self.batch,), dtype=torch.float32, device=self.device),
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
            gen = None if greedy else st["gen"]

            def step():
                logits, _ = _batched_decode_forward(self.params, st["tok"][:, None],
                                                    self.cache, st["pos"], self.cfg,
                                                    kv_bound=bound)
                nxt = sample_logits(logits[:, 0], gen, temperature=st["temp"],
                                    top_k=top_k, top_p=top_p, greedy=greedy)
                st["tok"].copy_(nxt)
                st["pos"].add_(1)

            graph = self._graphs[key] = capture(
                step, "decode_graph", stream=st["stream"], pool=st["pool"],
                generators=() if greedy else (st["gen"],))
            load_lanes()              # the warm-up step advanced the lanes
        if not greedy:
            st["gen"].manual_seed(self._seed_value(seed, 0))
        out = torch.empty((n_steps, self.batch), dtype=torch.long, device=self.device)
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
        queue = list(requests)
        pending: Dict[int, Request] = {}     # slot -> in-flight request
        next_tok: Dict[int, int] = {}        # slot -> next token to feed
        step_seed = seed

        def admit():
            for slot in self.slots:
                if slot.active or not queue:
                    continue
                req = queue.pop(0)
                tok = self.prefill_sample(slot.id, req.prompt,
                                          temperature=req.temperature,
                                          seed=seed)
                req.slot = slot.id
                req.out = [tok]
                pending[slot.id] = req
                next_tok[slot.id] = tok

        admit()
        while pending:
            n = min(chunk, max(req.max_new_tokens - len(req.out)
                               for req in pending.values()))
            n = max(n, 1)
            # per-row temperature: greedy requests ride along at temp≈0
            temp = np.full((self.batch,), 1e-6, np.float32)
            any_sampled = False
            for sid, req in pending.items():
                temp[sid] = max(req.temperature, 1e-6)
                any_sampled |= req.temperature > 0
            step_seed += 1
            outs = self.decode_steps(dict(next_tok), n,
                                     temperature=temp if any_sampled else 0.0,
                                     seed=step_seed)
            for sid, seq in outs.items():
                req = pending[sid]
                for t in seq:
                    if len(req.out) >= req.max_new_tokens or \
                            (req.eos_id is not None and req.out and
                             req.out[-1] == req.eos_id):
                        break
                    req.out.append(t)
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
        """A batch-1 engine on the same weights with a zeroed cache of this
        engine's kind: a benchmark's own, gone with its graphs after it."""
        c = self.cache
        return InferenceEngine(self.cfg, self.params, batch=1,
                               quantized_kv=c.scale is not None, kv_scale=c.scale or 0.05,
                               fuse_weights=False, device=self.device,
                               native_int4=self._native4)

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
        if self.device.type == "cuda":
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
        chunk = eng._graph_chunk if self.device.type == "cuda" else eng._eager_chunk
        tok = torch.ones((self.batch,), dtype=torch.long, device=self.device)
        pos = torch.full((self.batch,), pos0, dtype=torch.int32, device=self.device)
        temp = torch.ones((self.batch,), dtype=torch.float32, device=self.device)
        dt = long_minus_short(              # seconds a step
            lambda n: chunk(tok, pos, temp, n, bound, True, 0, 0, 1.0),
            base, iters, reps, device=self.device)
        return self.batch / dt


def _batched_decode_forward(params, tokens, cache: KVCache, pos_vec,
                            cfg: LlamaConfig, kv_bound: Optional[int] = None):
    """Decode with per-row positions: like llama_forward at s = 1 but pos is
    a vector [B].  RoPE, the KV store and the attention mask use each row's
    own position.  Unlike model.py's bf16 internal linears, the linears here
    return f32 and silu(h1)·h3 is taken in f32, as in the JAX engine.

    Attention: decode_attention, or with CSINN2_DECODE_ATTN=flash in the
    environment the blocked bhsd flash_attention (causal, q_offset = pos,
    kv_len = pos + 1), the JAX engine's alternative decode kernel.  The JAX
    engine reads the variable when it traces; this function reads it on
    every call, once for all layers."""
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
    bidx = torch.arange(b, device=x.device)
    # lanes at pos >= S write nothing (JAX scatter mode="drop"): such a lane
    # rewrites row S-1 with its current contents
    keep = (pos_vec < S)[:, None, None]
    rows = pos_vec.clamp(max=S - 1).long()

    def store_rows(layer, k_new, v_new):
        for buf, new in ((cache.k, k_new), (cache.v, v_new)):
            new = quantize_kv(new[:, 0], cache.scale) if cache.scale is not None \
                else new[:, 0].to(buf.dtype)
            buf[layer, bidx, rows] = torch.where(keep, new, buf[layer, bidx, rows])

    # per-row RoPE trig depends only on pos_vec — one evaluation, all layers
    rtabs = rope_tables(pos_vec[:, None], dh, cfg.rope_base)
    kv_len = pos_vec + 1
    flash = os.environ.get("CSINN2_DECODE_ATTN") == "flash"
    for i, lp in enumerate(params["layers"]):
        h = rms_norm(x, lp["attn_norm"], cfg.norm_eps).to(torch.bfloat16)
        qk, v = _project_qkv(h, lp, hq, hk, dh)
        qk = rope_rotate(qk, None, cfg.rope_base, tables=rtabs)   # q|k heads at once
        q, k = qk[:, :, :hq], qk[:, :, hq:]
        store_rows(i, k, v)

        k_all, v_all = cache.k[i], cache.v[i]             # [b, S, hk, dh]
        if kv_bound is not None and kv_bound < S:
            k_all, v_all = k_all[:, :kv_bound], v_all[:, :kv_bound]
        q_t = q.to(torch.bfloat16).permute(0, 2, 1, 3)     # [b, hq, 1, dh]
        k_t, v_t = k_all.permute(0, 2, 1, 3), v_all.permute(0, 2, 1, 3)
        if flash:
            attn = flash_attention(q_t, k_t, v_t, causal=True, q_offset=pos_vec,
                                   kv_len=kv_len, kv_scale=cache.scale)
        else:
            attn = decode_attention(q_t, k_t, v_t, q_offset=pos_vec, kv_len=kv_len,
                                    kv_scale=cache.scale)  # [b, hq, 1, dh]
        attn = attn.permute(0, 2, 1, 3).reshape(b, 1, D).to(torch.bfloat16)
        x = x + linear(attn, lp["wo"]).to(x.dtype)

        h = rms_norm(x, lp["ffn_norm"], cfg.norm_eps).to(torch.bfloat16)
        x = x + linear(_swiglu_hidden(h, lp), lp["w2"]).to(x.dtype)

    x = rms_norm(x, params["norm"], cfg.norm_eps).to(torch.bfloat16)
    return linear(x, params["output"]), cache


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
