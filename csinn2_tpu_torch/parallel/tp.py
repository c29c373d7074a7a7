"""Tensor-parallel Llama over a process mesh — counterpart of
csinn2_tpu/parallel/tp.py.

Layout (the Megatron recipe, as in the JAX package):

  wq/wk/wv, wqkv : [D, H·Dh]  column-sharded (heads split across tp)
  wo             : [H·Dh, D]  row-sharded    → all_reduce after wo
  w1/w3, w13     : [D, F]     column-sharded (F split)
  w2             : [F, D]     row-sharded    → all_reduce after w2
  output         : [D, V]     column-sharded → all_gather of the logits
  KV cache       : [L, B, S, H_kv, Dh], batch over dp, heads over tp
  embedding, norms, MoE gate, residual stream: replicated

A spec is a tuple with one entry a dimension: the mesh axis that dimension
is split over, or None (the JAX PartitionSpec); a QWeight's spec is a
QWeight whose values and scales are such tuples.  `shard_llama_params`
takes the FULL params on every rank and returns this rank's shard of every
tensor on its device — the tensors `addressable_shards` of the JAX
function's placement hold on the same device index.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from csinn2_tpu_torch.llm.config import LlamaConfig
from csinn2_tpu_torch.llm.model import (CHANNEL_MODES, FLOAT, KVCache, QWeight,
                                        llama_forward)
from csinn2_tpu_torch.parallel.mesh import Mesh, all_gather

COL = ("wq", "wk", "wv", "wqkv", "w1", "w3", "w13")
ROW = ("wo", "w2")


def local_config(cfg: LlamaConfig, tp: int) -> LlamaConfig:
    """A rank's config under head / ffn sharding (head_dim unchanged)."""
    if cfg.n_heads % tp or cfg.n_kv_heads % tp or cfg.ffn_dim % tp or cfg.vocab_size % tp:
        raise ValueError(f"config not divisible by tp={tp}: heads {cfg.n_heads}/"
                         f"{cfg.n_kv_heads}, ffn {cfg.ffn_dim}, vocab {cfg.vocab_size}")
    return dataclasses.replace(cfg, n_heads=cfg.n_heads // tp,
                               n_kv_heads=cfg.n_kv_heads // tp, ffn_dim=cfg.ffn_dim // tp)


def _qw_spec_for(qw: QWeight, col_sharded: bool, axis: str = "tp",
                 ep_axis: Optional[str] = None) -> QWeight:
    """Spec of a [K, N] weight, or of stacked experts [E, K, N] (E over
    ep_axis when given): col_sharded splits N over `axis`, else K.  Channel
    scales [N] follow N, so a row-sharded weight keeps them whole; block
    scales [K/32, N] and packed int4 values [K/2, N] split with K."""
    e = (ep_axis,) if qw.values.ndim == 3 else ()
    if col_sharded:
        v = e + (None, axis)
        s = None if qw.mode == FLOAT else e + ((axis,) if qw.mode in CHANNEL_MODES
                                               else (None, axis))
    else:
        v = e + (axis, None)
        s = None if qw.mode == FLOAT else (e if qw.mode in CHANNEL_MODES
                                           else e + (axis, None))
    return QWeight(values=v, scales=s, mode=qw.mode, packed=qw.packed, layout=qw.layout)


def param_specs(params, axis: str = "tp", ep_axis: Optional[str] = None) -> dict:
    """The spec of every tensor of a Llama params dict, fused wqkv / w13
    included (fuse_params(tp=...) interleaves their N per shard, so plain
    column sharding hands each rank its own heads).  MoE layers: the gate
    replicated, the stacked experts over ep_axis and, inside each expert,
    over `axis` (the TP×EP layout)."""
    col = dict(col_sharded=True, axis=axis, ep_axis=ep_axis)
    row = dict(col_sharded=False, axis=axis, ep_axis=ep_axis)
    specs = {"tok_embedding": (None, None), "norm": (None,),
             "output": _qw_spec_for(params["output"], **col), "layers": []}
    for lp in params["layers"]:
        ls = {}
        for k, w in lp.items():
            if k in ("attn_norm", "ffn_norm"):
                ls[k] = (None,)
            elif k == "gate":
                ls[k] = (None, None)
            elif k in COL:
                ls[k] = _qw_spec_for(w, **col)
            elif k in ROW:
                ls[k] = _qw_spec_for(w, **row)
            else:
                raise KeyError(f"no TP spec for layer weight {k}")
        specs["layers"].append(ls)
    return specs


def cache_spec() -> tuple:
    """[L, B, S, H_kv, Dh]: batch over dp, heads over tp."""
    return (None, "dp", None, "tp", None)


def shard_tensor(t: Optional[torch.Tensor], spec, mesh: Mesh) -> Optional[torch.Tensor]:
    """This rank's block of t under `spec`, as a new tensor on mesh.device
    (so the full tensor can be freed)."""
    if t is None or spec is None:
        return t
    for dim, ax in enumerate(spec):
        n = mesh.size(ax) if ax else 1
        if n == 1:
            continue
        if t.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(t.shape)} does not split over {ax}={n}")
        step = t.shape[dim] // n
        t = t.narrow(dim, mesh.index(ax) * step, step)
    out = torch.empty(t.shape, dtype=t.dtype, device=mesh.device)
    return out.copy_(t)


def shard_params(params, specs, mesh: Mesh):
    """Map shard_tensor over a params dict and its spec dict."""
    if isinstance(params, QWeight):
        return dataclasses.replace(params, values=shard_tensor(params.values, specs.values, mesh),
                                   scales=shard_tensor(params.scales, specs.scales, mesh))
    if isinstance(params, dict):
        return {k: shard_params(v, specs[k], mesh) for k, v in params.items()}
    if isinstance(params, list):
        return [shard_params(v, s, mesh) for v, s in zip(params, specs)]
    return shard_tensor(params, specs, mesh)


def shard_llama_params(params, mesh: Mesh):
    """Full params → this rank's shard of each tensor per param_specs (with
    ep_axis "ep" where the mesh has that axis: TP×EP)."""
    ep_axis = "ep" if "ep" in mesh.shape else None
    return shard_params(params, param_specs(params, ep_axis=ep_axis), mesh)


def tp_llama_forward(mesh: Mesh, cfg: LlamaConfig):
    """The rank's forward: (params shard, tokens [B, s], cache, pos) →
    (logits [B, s, V], cache).  Tokens are the global batch; the rank runs
    its dp group's rows on its local cache ([L, B/dp, S, H_kv/tp, Dh], e.g.
    KVCache.create(local_config(cfg, tp), B // dp)) with one all_reduce after
    wo and after w2 and the vocab all_gather, and the logits come back
    gathered over dp, so every rank holds all of them.  A mesh with an ep
    axis (MoE params sharded by shard_llama_params) also sums the experts
    over ep: TP×EP."""
    tp, dp = mesh.size("tp"), mesh.size("dp")
    lcfg = local_config(cfg, tp)

    def apply(params, tokens, cache: KVCache, pos: int):
        tokens = torch.as_tensor(tokens)
        b = tokens.shape[0] // dp
        i = mesh.index("dp")
        logits, cache = llama_forward(params, tokens[i * b:(i + 1) * b], cache, pos, lcfg,
                                      tp_group=mesh.tp_group, ep_group=mesh.ep_group)
        return all_gather(logits, mesh.dp_group, 0, "dp"), cache

    return apply
