"""Llama model configuration — a copy of csinn2_tpu/llm/config.py (the port
imports nothing of the JAX package).  (ref: struct shl_llm_config / llama2_params,
include/llm/shl_llm.h:20-38 — but config-driven instead of 7B-hard-coded)."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class LlamaConfig:
    dim: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 32
    ffn_dim: int = 11008
    vocab_size: int = 32000
    max_seq_len: int = 2048
    norm_eps: float = 1e-5
    rope_base: float = 10000.0
    head_dim: int = 0   # 0 → dim // n_heads; stays fixed under TP localization
    n_experts: int = 0       # 0 → dense FFN; >0 → MoE (net-new vs reference)
    moe_top_k: int = 2       # experts routed per token
    # "auto": measured crossover (dense below 256 tokens, routed above);
    # "dense": always the exact no-drop formulation; "routed": capacity-based
    # dispatch (renormalized over kept experts) — NOTE: under EP or TP
    # sharding the routed dispatch einsums are single-device, so sharded
    # forwards fall back to the dense formulation regardless of this field
    # (llm/model.py llama_forward).
    moe_dispatch: str = "auto"
    moe_capacity_factor: float = 2.0   # routed-dispatch capacity multiplier

    def __post_init__(self):
        if self.head_dim == 0:
            self.head_dim = self.dim // self.n_heads

    @staticmethod
    def llama2_7b() -> "LlamaConfig":
        return LlamaConfig()

    @staticmethod
    def llama2_13b() -> "LlamaConfig":
        return LlamaConfig(dim=5120, n_layers=40, n_heads=40, n_kv_heads=40,
                           ffn_dim=13824)

    @staticmethod
    def llama2_70b() -> "LlamaConfig":
        """GQA geometry (8 KV heads) — the multi-chip TP target; the engine
        and flash/decode kernels handle hq != hk via head-group mapping."""
        return LlamaConfig(dim=8192, n_layers=80, n_heads=64, n_kv_heads=8,
                           ffn_dim=28672, max_seq_len=4096)

    @staticmethod
    def tiny(vocab: int = 256, max_seq: int = 128) -> "LlamaConfig":
        """Small config for tests/dryruns."""
        return LlamaConfig(dim=64, n_layers=2, n_heads=4, n_kv_heads=2,
                           ffn_dim=128, vocab_size=vocab, max_seq_len=max_seq)

    @staticmethod
    def tiny_moe(n_experts: int = 4, vocab: int = 256,
                 max_seq: int = 128) -> "LlamaConfig":
        return LlamaConfig(dim=64, n_layers=2, n_heads=4, n_kv_heads=2,
                           ffn_dim=128, vocab_size=vocab, max_seq_len=max_seq,
                           n_experts=n_experts, moe_top_k=2)
