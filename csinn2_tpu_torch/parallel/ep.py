"""Expert parallelism: MoE experts sharded over an `ep` mesh axis —
counterpart of csinn2_tpu/parallel/ep.py.

Every layer's stacked expert weights w1/w2/w3 [E, K, N] split their expert
axis across ep; attention weights, the gate, the embedding and the norms
are replicated.  The dense no-drop MoE (llm/model.py moe_ffn_block) then
needs one all_reduce a FFN sublayer: each rank runs its E/ep experts on all
tokens, weighted by the router weights of those experts, and the sum over
ep adds the experts' contributions.
"""

from __future__ import annotations

from csinn2_tpu_torch.llm.config import LlamaConfig
from csinn2_tpu_torch.llm.model import KVCache, QWeight, llama_forward
from csinn2_tpu_torch.parallel.mesh import Mesh
from csinn2_tpu_torch.parallel.tp import shard_params


def _qw_replicated(qw: QWeight) -> QWeight:
    return QWeight(values=(None, None),
                   scales=None if qw.scales is None else (None,) * qw.scales.ndim,
                   mode=qw.mode, packed=qw.packed, layout=qw.layout)


def _qw_expert_sharded(qw: QWeight, axis: str = "ep") -> QWeight:
    return QWeight(values=(axis,) + (None,) * (qw.values.ndim - 1),
                   scales=None if qw.scales is None
                   else (axis,) + (None,) * (qw.scales.ndim - 1),
                   mode=qw.mode, packed=qw.packed, layout=qw.layout)


def ep_param_specs(params) -> dict:
    """Specs of a MoE params dict (unfused: wq/wk/wv, stacked w1/w2/w3)."""
    specs = {"tok_embedding": (None, None), "norm": (None,),
             "output": _qw_replicated(params["output"]), "layers": []}
    for lp in params["layers"]:
        specs["layers"].append({
            "attn_norm": (None,), "ffn_norm": (None,), "gate": (None, None),
            **{k: _qw_replicated(lp[k]) for k in ("wq", "wk", "wv", "wo")},
            **{k: _qw_expert_sharded(lp[k]) for k in ("w1", "w2", "w3")}})
    return specs


def shard_moe_params(params, mesh: Mesh):
    """Full MoE params → this rank's experts (the rest replicated), on its
    device."""
    return shard_params(params, ep_param_specs(params), mesh)


def ep_llama_forward(mesh: Mesh, cfg: LlamaConfig):
    """The rank's MoE forward: (params shard, tokens, cache, pos) →
    (logits, cache).  Attention and the cache run replicated on every rank
    (same inputs, same results); only the experts split."""
    ep = mesh.size("ep")
    if cfg.n_experts % ep:
        raise ValueError(f"n_experts={cfg.n_experts} not divisible by ep={ep}")

    def apply(params, tokens, cache: KVCache, pos: int):
        return llama_forward(params, tokens, cache, pos, cfg, ep_group=mesh.ep_group)

    return apply
