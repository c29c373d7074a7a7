"""LLM / sequence ops, the TORCH tier (counterpart of
csinn2_tpu/ops/ref/attention.py): RoPE, scaled-dot-product attention, the
KV-cache position op, and the streaming-ASR cache ops.

(ref: source/thead_rvv/fp16/rope.c:21-100 — interleaved-pair rotation,
theta = freq_scale*pos*base^(-2i/n_dims); scaled_dot_product_attention.c:25-76
— per-head fused QK^T → mask → softmax → V; LLM_POS cache copy ops
source/llm/llama2.c:198-256; cache_matmul/cache_conv1d
source/c906_opt/fp16/cache_matmul.c, FSMN source/reference/fsmn.c.)
"""

from __future__ import annotations

import math

import torch

from csinn2_tpu_torch.core.dtypes import Api
from csinn2_tpu_torch.ops.params import (
    CacheConv1dParams, CacheMatmulParams, Conv1dParams, FSMNParams, LlmPosParams, RopeParams,
    SDPAParams,
)
from csinn2_tpu_torch.ops.ref.conv import conv1d, full_f32
from csinn2_tpu_torch.ops.ref.shape import wrap_index
from csinn2_tpu_torch.ops.registry import registry


def rope_angles(positions, head_dim: int, freq_base: float = 10000.0,
                freq_scale: float = 1.0):
    """theta[p, i] = freq_scale * p * base^(-2i/head_dim) for pair index i."""
    ar = torch.arange(0, head_dim // 2, dtype=torch.float32, device=positions.device)
    inv_freq = torch.pow(torch.tensor(freq_base, dtype=torch.float32, device=ar.device),
                         -ar * 2.0 / head_dim)
    theta = freq_scale * positions.float()[..., None] * inv_freq
    return torch.cos(theta), torch.sin(theta)


@registry.register("rope", api=Api.TORCH)
def rope(x, params: RopeParams, positions=None):
    """x [batch, seq, heads, head_dim]; rotates interleaved pairs
    (x[2i], x[2i+1]), the GGML convention of the reference kernel."""
    x = x.float()
    b, s, h, d = x.shape
    if positions is None:
        positions = params.pos_offset + torch.arange(s, dtype=torch.int32, device=x.device)
    else:
        positions = torch.as_tensor(positions).to(x.device)
    cos, sin = rope_angles(positions, d, params.freq_base, params.freq_scale)
    cos, sin = cos[None, :, None, :], sin[None, :, None, :]
    x0, x1 = x[..., 0::2], x[..., 1::2]
    return torch.stack([x0 * cos - x1 * sin, x0 * sin + x1 * cos], dim=-1).reshape(b, s, h, d)


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


@registry.register("llm_pos", api=Api.TORCH)
def llm_pos(x, cache, params: LlmPosParams):
    """KV-cache copy-in / copy-out at position `pos` (ref: llama2.c:198-256):
    cache_in returns the cache with x [b, s, h, d] written at pos along axis
    1 (the start clamped so the write fits, as lax.dynamic_update_slice
    does), cache_out returns the cache."""
    if params.mode == "cache_in":
        pos = min(max(params.pos, 0), cache.shape[1] - x.shape[1])
        out = cache.clone()
        out[:, pos:pos + x.shape[1]] = x.to(cache.dtype)
        return out
    if params.mode == "cache_out":
        return cache
    raise ValueError(params.mode)


@registry.register("cache_matmul", api=Api.TORCH)
def cache_matmul(x, weight, bias, cache, params: CacheMatmulParams):
    """Streaming-ASR cached projection: y = x @ W^T + b shifted into a
    cache along time (ref: shl_c906_cache_matmul_fp16,
    source/c906_opt/fp16/cache_matmul.c:23-87).  cache [b, T, units];
    returns (output window, new cache), the same tensor."""
    with full_f32():
        y = x.float() @ weight.float().T
    if bias is not None:
        y = y + bias.float()
    new_cache = torch.cat([cache[:, y.shape[1]:].float(), y], dim=1)
    return new_cache, new_cache


@registry.register("cache_conv1d", api=Api.TORCH)
def cache_conv1d(x, weight, bias, cache, params: CacheConv1dParams):
    """Causal streaming conv1d over a cache (ref: shl_c906_cache_conv1d_fp16).
    x [b, C, t_new]; cache [b, C, T_ctx]; returns (out, new cache)."""
    t_new = x.shape[2]
    new_cache = torch.cat([cache[:, :, t_new:].float(), x.float()], dim=2)
    out = conv1d(new_cache, weight, bias,
                 Conv1dParams(group=params.group, stride=params.stride, pad=(0, 0),
                              dilation=params.dilation))
    return (out[:, :, -t_new:] if out.shape[2] >= t_new else out), new_cache


@registry.register("fsmn", api=Api.TORCH)
def fsmn(frame, l_filter, r_filter, frame_sequence, frame_counter, params: FSMNParams):
    """One FSMN frame step (ref: shl_ref_fsmn_f32, source/reference/fsmn.c):
    the sequence drops its oldest row and takes the frame, and the output
    is its centre row plus the lookback and lookahead FIR taps.

    frame [1, D]; l_filter [l_order, D]; r_filter [r_order, D];
    frame_sequence [l_order*l_stride + r_order*r_stride, D].  Returns
    (output [1, D], new sequence, counter + 1)."""
    seq = torch.cat([frame_sequence[1:].float(), frame.float()], dim=0)
    T = seq.shape[0]
    mid = T - 1 - params.r_order * params.r_stride
    ar_l = torch.arange(params.l_order, device=seq.device)
    ar_r = torch.arange(params.r_order, device=seq.device)
    # JAX array indexing: a negative position wraps once, then clamps
    l_idx = wrap_index(mid - ar_l * params.l_stride, T).clamp(0, T - 1)
    r_idx = wrap_index(mid + (ar_r + 1) * params.r_stride, T).clamp(0, T - 1)
    l_sum = torch.sum(seq[l_idx] * l_filter.float(), dim=0, keepdim=True)
    r_sum = torch.sum(seq[r_idx] * r_filter.float(), dim=0, keepdim=True)
    return seq[mid:mid + 1] + l_sum + r_sum, seq, frame_counter + 1
