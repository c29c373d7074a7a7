"""Plain float32 reference of the served model: a Llama-family decoder
(RMSNorm, interleaved-pair RoPE, GQA attention over an int8 KV cache,
SwiGLU FFN) as the configuration states it, computed layer by layer over
whole sequences, with no cache, no batching and no kernel.

It imports nothing of the program.  It takes the same float weights as
the program (portbench.weights, made again here from the seed, one layer
at a time) and quantizes them itself with the frozen block quantizers
below.  The int8 KV cache is part of the configuration: K and V are
rounded to int8 at the static scale before attention, as the program's
cache stores them.  TF32 is off.

`act` is the precision of every matmul's activation input: "f32" for the
reference, "fp8" for the control (e4m3, one scale a row at amax / 448 —
the W4A8 / W8A8 fp8 path a later change could be tempted by).  Two more
readings, for comparison only: `kv_bits` 4 stores the cache in int4 over
the int8 cache's range (scale · 127 / 7); act "bf16" rounds what the
configuration holds in bf16 (matmul inputs, K and V before the int8
cache, the residual stream) as the program does, so its gap is the one
the configured precision alone explains.
"""

from __future__ import annotations

import math
from typing import List, Sequence

import torch

from portbench import weights

FP8_MAX = 448.0
ATTN_ROWS = 512                 # query rows an attention block takes


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def dequant(w: torch.Tensor, mode: str) -> torch.Tensor:
    """f32 [K, N] → its block-quantized value in f32: one f16-rounded scale
    per 32 rows of a column (amax / 127 for q8_0, amax / 7 for q4_0),
    values rounded half to even and clipped."""
    if mode == "float":
        return w.to(torch.bfloat16).float()
    bound = {"q8_0": 127.0, "q4_0": 7.0}[mode]
    K, N = w.shape
    wb = w.float().reshape(K // 32, 32, N)
    d = (wb.abs().amax(dim=1, keepdim=True) / bound).to(torch.float16).float()
    q = torch.where(d == 0, torch.zeros_like(wb),
                    torch.round(wb / torch.where(d == 0, torch.ones_like(d), d)))
    return (q.clamp(-bound, bound) * d).reshape(K, N)


def kv_int8(t: torch.Tensor, scale: float, bits: int = 8) -> torch.Tensor:
    """The value an int8 cache holds: round half to even, clip to ±127
    (bits 4: ±7 at scale · 127 / 7)."""
    top = 2 ** (bits - 1) - 1
    if bits != 8:
        scale = scale * 127 / top
    return torch.clamp(torch.round(t / scale), -top, top) * scale


def bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def act_in(x: torch.Tensor, act: str) -> torch.Tensor:
    if act == "f32":
        return x
    if act == "bf16":
        return bf16(x)
    if act != "fp8":
        raise ValueError(f"unknown activation precision {act!r}")
    s = x.abs().amax(dim=-1, keepdim=True).clamp_min(1e-12) / FP8_MAX
    return (x / s).to(torch.float8_e4m3fn).float() * s


def rms_norm(x: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + eps)


def rope(x: torch.Tensor, base: float) -> torch.Tensor:
    """x [T, h, dh] at positions 0..T-1; pairs (0,1), (2,3), ... rotate by
    pos · base^(-2i/dh)."""
    T, _, dh = x.shape
    inv = base ** (-torch.arange(0, dh // 2, dtype=torch.float32, device=x.device) * 2.0 / dh)
    th = torch.arange(T, dtype=torch.float32, device=x.device)[:, None] * inv
    c, s = torch.cos(th)[:, None, :], torch.sin(th)[:, None, :]
    x0, x1 = x[..., 0::2], x[..., 1::2]
    return torch.stack([x0 * c - x1 * s, x0 * s + x1 * c], dim=-1).reshape(x.shape)


def attention(q, k, v) -> torch.Tensor:
    """Causal softmax attention, q [T, hq, dh], k / v [T, hk, dh] → [T, hq·dh]."""
    T, hq, dh = q.shape
    g = hq // k.shape[1]
    k = k.repeat_interleave(g, dim=1).permute(1, 2, 0)        # [hq, dh, T]
    v = v.repeat_interleave(g, dim=1).permute(1, 0, 2)        # [hq, T, dh]
    out = torch.empty((T, hq, dh), dtype=torch.float32, device=q.device)
    for r0 in range(0, T, ATTN_ROWS):
        r1 = min(T, r0 + ATTN_ROWS)
        s = torch.matmul(q[r0:r1].permute(1, 0, 2), k[:, :, :r1]) / math.sqrt(dh)
        mask = torch.arange(r1, device=q.device)[None, :] > \
            torch.arange(r0, r1, device=q.device)[:, None]
        s = s.masked_fill(mask[None], float("-inf"))
        out[r0:r1] = torch.matmul(torch.softmax(s, dim=-1), v[:, :r1]).permute(1, 0, 2)
    return out.reshape(T, hq * dh)


def block(x: torch.Tensor, W: dict, d: dict, act: str, kv_bits: int = 8) -> torch.Tensor:
    """One decoder layer over a whole sequence x [T, D] (f32)."""
    T = x.shape[0]
    hq, hk, dh = d["hq"], d["hk"], d["dh"]
    held = bf16 if act == "bf16" else (lambda t: t)
    h = act_in(rms_norm(x, d["eps"]), act)
    q = rope((h @ W["wq"]).view(T, hq, dh), d["rope"])
    k = kv_int8(held(rope(held(h @ W["wk"]).view(T, hk, dh), d["rope"])), d["kv_scale"], kv_bits)
    v = kv_int8(held(h @ W["wv"]).view(T, hk, dh), d["kv_scale"], kv_bits)
    x = held(x + act_in(attention(q, k, v), act) @ W["wo"])
    h = act_in(rms_norm(x, d["eps"]), act)
    f = torch.nn.functional.silu(h @ W["w1"]) * (h @ W["w3"])
    return held(x + act_in(f, act) @ W["w2"])


def logits_at(d: dict, seed: int, seqs: Sequence[Sequence[int]],
              rows: Sequence[Sequence[int]], device, act: str = "f32",
              kv_bits: int = 8) -> List[torch.Tensor]:
    """The logits [len(rows[j]), V] (f32) at positions rows[j] of each token
    sequence seqs[j], through all layers, one layer's weights at a time."""
    no_tf32()
    emb = weights.embedding(d, seed, device)
    xs = [emb[torch.as_tensor(list(s), device=device)].float() for s in seqs]   # bf16 values
    del emb
    for i in range(d["L"]):
        W = {n: dequant(w, d["mode"]) for n, w in weights.layer(d, seed, i, device).items()}
        xs = [block(x, W, d, act, kv_bits) for x in xs]
        del W
    head = dequant(weights.head(d, seed, device), d["mode"])
    out = []
    for x, r in zip(xs, rows):
        h = rms_norm(x[torch.as_tensor(list(r), device=device)], d["eps"])
        out.append(act_in(h, act) @ head)
    return out
