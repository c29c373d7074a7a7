"""Scaled-dot-product attention, the TORCH tier (counterpart of
csinn2_tpu/ops/ref/attention.py; rope, llm_pos, cache_matmul, cache_conv1d
and fsmn wait, ROADMAP queue A items 10.4 and 11).

(ref: source/thead_rvv/fp16/scaled_dot_product_attention.c:25-76 — per-head
fused QK^T → mask → softmax → V.)
"""

from __future__ import annotations

import math

import torch

from csinn2_tpu_torch.core.dtypes import Api
from csinn2_tpu_torch.ops.params import SDPAParams
from csinn2_tpu_torch.ops.ref.conv import full_f32
from csinn2_tpu_torch.ops.registry import registry


@registry.register("scaled_dot_product_attention", api=Api.TORCH)
def scaled_dot_product_attention(q, k, v, params: SDPAParams):
    """q [b, hq, sq, d]; k/v [b, hk, sk, d], grouped-query broadcast when
    hq > hk; f32.  Without pos_offset and kv_len the causal mask offsets the
    queries by sk - sq (the reference's mask, where decode at sq = 1 sees the
    whole prefix); with either set, query i sits at pos_offset + i and keys
    at kpos >= kv_len are masked.  A fully masked row outputs 0.  (The CUDA
    tier, kernels/autodispatch.py, passes q_offset = pos_offset as the JAX
    package's Pallas tier does, which differs in the first case: ROADMAP
    queue C.)"""
    q, k, v = q.float(), k.float(), v.float()
    b, hq, sq, d = q.shape
    hk, sk = k.shape[1], k.shape[2]
    if hq != hk:
        k = k.repeat_interleave(hq // hk, dim=1)
        v = v.repeat_interleave(hq // hk, dim=1)
    scale = params.norm_factor if params.norm_factor else 1.0 / math.sqrt(d)
    with full_f32():
        logits = torch.matmul(q, k.transpose(-1, -2)) * scale
    kpos = torch.arange(sk, device=q.device)[None, :]
    explicit = bool(params.kv_len or params.pos_offset)
    kv_len = params.kv_len or sk
    mask = None
    if params.causal:
        q_off = params.pos_offset if explicit else sk - sq
        qpos = torch.arange(sq, device=q.device)[:, None] + q_off
        mask = kpos <= qpos
    if explicit:
        valid = (kpos < kv_len).expand(sq, sk)
        mask = valid if mask is None else mask & valid
    if mask is not None:
        logits = logits.masked_fill(~mask, float("-inf"))
    probs = torch.nan_to_num(torch.softmax(logits, dim=-1))   # fully masked rows → 0
    with full_f32():
        return torch.matmul(probs, v)
