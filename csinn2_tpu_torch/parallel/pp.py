"""Pipeline parallelism: the decoder layers split into stages — counterpart
of csinn2_tpu/parallel/pp.py.

Two forms, as in the JAX package:

* `PipelinedLlama`: one process steps the stages over a list of devices
  (["cuda:0", "cuda:0"] on one card, ["cpu"] * P in tests).  Stage s holds
  a contiguous slice of layers and one KV cache; stage 0 adds the
  embedding, the last stage the final norm and lm_head.  The batch splits
  into microbatches, each stage's cache rows with it (views along the
  batch axis, written in place), and the host streams each microbatch
  through the stages; the activations move with .to(device).
* `SPMDPipelinedLlama`: one process a rank on a mesh with a "pp" axis
  (and optionally "tp": pp × tp).  Rank (s, t) holds layers [s·Lp,
  (s+1)·Lp), under tp further sharded by parallel/tp.py's param_specs and
  run with its local_config.  Every rank runs the GPipe tick loop of
  M + P - 1 ticks: at tick t stage s is active iff 0 <= t - s < M, and only
  an active stage receives its input from stage s - 1, computes microbatch
  t - s (writing that microbatch's cache rows) and sends the result to
  stage s + 1 (mesh.send / recv_into: the JAX lax.ppermute over "pp").
  The ranks post their sends and receives tick by tick in one global
  order, so each receive meets the send of the tick before.  The last
  stage keeps each finished microbatch; after the loop a broadcast over
  the pp group hands every rank the result (the JAX function's masked psum,
  exact either way).  The embedding, final norm and lm_head are replicated
  (not vocab-sharded) and run outside the pipelined region; under tp each
  tick's sublayers all_reduce over the tp group, as tp_llama_forward does.

Both stages run the MoE FFN dense whatever the token count (the JAX stage
functions call moe_ffn_block), never llama_forward's routed dispatch.
Counts: launch_counts["pipeline.tick"] a tick, ["pipeline.stage"] an active
stage's compute, ["p2p.pp"] a send and ["p2p.pp.recv"] a receive.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import torch

from csinn2_tpu_torch.kernels._build import launch_counts
from csinn2_tpu_torch.llm.config import LlamaConfig
from csinn2_tpu_torch.llm.model import (KVCache, QWeight, embed_tokens, llama_head,
                                        llama_layers)
from csinn2_tpu_torch.parallel.mesh import Mesh, broadcast, neighbour, recv_into, send
from csinn2_tpu_torch.parallel.tp import local_config, param_specs, shard_params
from csinn2_tpu_torch.utils.device import resolve_device


def _to(tree, device):
    """A params subtree on `device` (tensors already there are not copied)."""
    if isinstance(tree, QWeight):
        return dataclasses.replace(tree, values=tree.values.to(device),
                                   scales=None if tree.scales is None
                                   else tree.scales.to(device))
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


def _rows(cache: KVCache, lo: int, hi: int) -> KVCache:
    """Batch rows lo..hi-1 of a cache, as views written in place."""
    return KVCache(k=cache.k[:, lo:hi], v=cache.v[:, lo:hi], scale=cache.scale)


def gpipe_schedule(n_stages: int, microbatches: int, stage: int) -> List[Optional[int]]:
    """The microbatch stage `stage` computes at each of the M + P - 1 ticks,
    None where it idles (the bubble)."""
    return [t - stage if 0 <= t - stage < microbatches else None
            for t in range(microbatches + n_stages - 1)]


class PipelinedLlama:
    """Host-stepped pipeline over `devices` (one stage a device; a device
    may appear more than once)."""

    def __init__(self, params, cfg: LlamaConfig, devices: Sequence):
        n_stages = len(devices)
        if cfg.n_layers % n_stages:
            raise ValueError(f"n_layers={cfg.n_layers} not divisible by {n_stages} stages")
        self.cfg = cfg
        self.n_stages = n_stages
        self.devices = [resolve_device(d) for d in devices]
        self.per_stage = cfg.n_layers // n_stages
        self.stage_params: List[dict] = []
        for s, dev in enumerate(self.devices):
            sp = {"layers": _to(params["layers"][s * self.per_stage:
                                                 (s + 1) * self.per_stage], dev)}
            if s == 0:
                sp["tok_embedding"] = _to(params["tok_embedding"], dev)
            if s == n_stages - 1:
                sp["norm"] = _to(params["norm"], dev)
                sp["output"] = _to(params["output"], dev)
            self.stage_params.append(sp)

    def _stage(self, s: int, x, cache: KVCache, pos: int):
        sp = self.stage_params[s]
        if s == 0:
            x = embed_tokens(sp, x)                       # tokens → [b, s, D]
        x = llama_layers(sp["layers"], x, cache, pos, self.cfg)
        if s == self.n_stages - 1:
            x = llama_head(sp, x, self.cfg)
        return x

    def init_caches(self, batch: int, quantized: bool = False) -> List[KVCache]:
        """One cache a stage ([per_stage, b, S, hk, dh]) on its device."""
        sub = dataclasses.replace(self.cfg, n_layers=self.per_stage)
        return [KVCache.create(sub, batch, quantized, device=dev) for dev in self.devices]

    def __call__(self, tokens, caches: List[KVCache], pos: int, microbatches: int = 1):
        """tokens [b, s] → (logits [b, s, V] f32 on the last stage's device,
        caches, updated in place).  b splits into `microbatches` chunks."""
        tokens = torch.as_tensor(tokens)
        b = tokens.shape[0]
        if b % microbatches:
            raise ValueError(f"batch {b} does not split into {microbatches} microbatches")
        mb = b // microbatches
        outs = []
        for m in range(microbatches):
            h = tokens[m * mb:(m + 1) * mb]
            for s in range(self.n_stages):
                h = self._stage(s, h.to(self.devices[s]),
                                _rows(caches[s], m * mb, (m + 1) * mb), pos)
            outs.append(h)
        return torch.cat(outs, dim=0), caches


class SPMDPipelinedLlama:
    """GPipe over the ranks of a mesh's "pp" axis (pp × tp with a "tp" axis;
    no mesh: {"pp": world size} on `device`).

    Every rank constructs it with the FULL params and keeps its stage's
    layers (its tp shard of them under tp) and the replicated embedding,
    norm and lm_head, on mesh.device; later calls reuse those tensors."""

    def __init__(self, params, cfg: LlamaConfig, mesh: Optional[Mesh] = None,
                 microbatches: int = 4, device="cuda"):
        if mesh is None:
            world = torch.distributed.get_world_size() \
                if torch.distributed.is_initialized() else 1
            mesh = Mesh({"pp": world}, device=device)
        extra = [a for a, n in mesh.shape.items() if a not in ("pp", "tp") and n > 1]
        if "pp" not in mesh.shape or extra:
            raise ValueError(f"SPMDPipelinedLlama needs a (pp[, tp]) mesh, got {mesh.shape}")
        self.mesh = mesh
        self.P, self.tp = mesh.size("pp"), mesh.size("tp")
        if cfg.n_layers % self.P:
            raise ValueError(f"n_layers={cfg.n_layers} not divisible by pp={self.P}")
        if len({frozenset(lp) for lp in params["layers"]}) != 1:
            raise ValueError("pipeline stages need uniform layer structure")
        self.cfg = cfg
        self.Lp = cfg.n_layers // self.P
        self.M = microbatches
        self.lcfg = local_config(cfg, self.tp) if self.tp > 1 else cfg
        self.stage = mesh.index("pp")
        lo, hi = self.stage * self.Lp, (self.stage + 1) * self.Lp
        self.layers = shard_params(params["layers"][lo:hi],
                                   param_specs(params)["layers"][lo:hi], mesh)
        self.head = {k: _to(params[k], mesh.device)
                     for k in ("tok_embedding", "norm", "output")}
        self.schedule = gpipe_schedule(self.P, self.M, self.stage)

    def init_cache(self, batch: int, quantized: bool = False) -> KVCache:
        """This rank's cache [Lp, B, S, hk/tp, dh]."""
        return KVCache.create(dataclasses.replace(self.lcfg, n_layers=self.Lp), batch,
                              quantized, device=self.mesh.device)

    def __call__(self, tokens, cache: KVCache, pos: int):
        """tokens [B, s] (the global batch, B = microbatches · mb) →
        (logits [B, s, V] f32 on every rank, this rank's cache, updated in
        place)."""
        tokens = torch.as_tensor(tokens)
        B, s = tokens.shape
        if B % self.M:
            raise ValueError(f"batch {B} does not split into {self.M} microbatches")
        mb = B // self.M
        mesh, last = self.mesh, self.stage == self.P - 1
        x = embed_tokens(self.head, tokens)                        # [B, s, D]
        x_mb = x.view(self.M, mb, s, x.shape[-1])
        out = torch.zeros_like(x_mb)                 # the last stage's results
        h = torch.empty_like(x_mb[0])                # the receive buffer
        for m in self.schedule:
            launch_counts["pipeline.tick"] += 1
            if m is None:
                continue
            if self.stage == 0:
                h = x_mb[m]
            else:
                recv_into(h, neighbour(mesh, "pp", -1), "pp")
            y = llama_layers(self.layers, h, _rows(cache, m * mb, (m + 1) * mb), pos,
                             self.lcfg, tp_group=mesh.tp_group)
            launch_counts["pipeline.stage"] += 1
            if last:
                out[m] = y
            else:
                send(y, neighbour(mesh, "pp", 1), "pp")
        out = broadcast(out, mesh.group("pp"), neighbour(mesh, "pp", self.P - 1 - self.stage),
                        "pp")
        return llama_head(self.head, out.view(B, s, -1), self.cfg), cache
