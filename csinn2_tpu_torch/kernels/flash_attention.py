"""Attention over a static (optionally int8) KV cache: decode, short-context
prefill and blocked (flash) prefill — counterpart of
csinn2_tpu/kernels/flash_attention.py.

Each entry point launches its CUDA kernel (csrc/attention.cu) for CUDA
tensors and runs the plain PyTorch version `_attention_ref` for CPU tensors.
`prefill_attention` and `flash_attention` share one device kernel
(`attn_fwd_kernel`, which reads q and writes the output through (batch,
seq, head) strides, so the bshd and bhsd layouts need no change to it); they
stay two entry points because the model dispatches between them by the same
8 MiB rule as the JAX package.  Launch counts: `prefill_attention`,
`flash_attention` (bshd) and `flash_attention_bhsd`.

Semantics shared by all three (per batch row b): query i sits at position
q_offset[b] + i; it sees keys kpos < kv_len[b] (and kpos <= its position when
causal); int8 K/V carriers are dequantized by the per-tensor kv_scale; GQA
maps query head h to KV head h // (hq // hk); a row that sees no key outputs
0.  K/V are [b, hk, S, d] and may be strided views (the port passes the
cache's [b, S, hk, d] buffer permuted, without a copy).
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from csinn2_tpu_torch.kernels import _build

NEG_INF = -1e30


def _per_row(val, b: int, device) -> torch.Tensor:
    """Scalar or [b] positions → int32 [b] on `device`."""
    if isinstance(val, torch.Tensor):
        return val.to(device=device, dtype=torch.int32).reshape(-1).expand(b).contiguous()
    return torch.full((b,), int(val), dtype=torch.int32, device=device)


def _attention_ref(q, k, v, *, causal, q_offset, kv_len, scale, kv_scale):
    """Plain f32 attention. q [b, hq, sq, d]; k/v [b, hk, S, d] → f32
    [b, hq, sq, d]."""
    b, hq, sq, d = q.shape
    hk, S = k.shape[1], k.shape[2]
    off = _per_row(q_offset, b, q.device)
    kvl = torch.clamp(_per_row(kv_len, b, q.device), max=S)
    kf = k.float() * (kv_scale if kv_scale is not None else 1.0)
    vf = v.float() * (kv_scale if kv_scale is not None else 1.0)
    if hq != hk:
        kf = kf.repeat_interleave(hq // hk, dim=1)
        vf = vf.repeat_interleave(hq // hk, dim=1)
    s = torch.matmul(q.float(), kf.transpose(-1, -2)) * scale   # [b, hq, sq, S]
    kpos = torch.arange(S, device=q.device)
    mask = kpos[None, None, :] < kvl[:, None, None]              # [b, 1, S]
    if causal:
        qpos = off[:, None] + torch.arange(sq, device=q.device)[None, :]
        mask = mask & (kpos[None, None, :] <= qpos[:, :, None])  # [b, sq, S]
    mask = mask[:, None]
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), torch.zeros_like(s))
    l = p.sum(dim=-1, keepdim=True)
    return torch.matmul(p, vf) / torch.where(l == 0, torch.ones_like(l), l)


def _check_kv(name, q, k, v):
    if q.dtype != torch.bfloat16:
        raise TypeError(f"{name}: q must be bf16 on CUDA, got {q.dtype}")
    if k.dtype != v.dtype or k.dtype not in (torch.int8, torch.bfloat16):
        raise TypeError(f"{name}: k/v must both be int8 or bf16, got "
                        f"{k.dtype}/{v.dtype}")
    for t in (q, k, v):
        if t.device != q.device:
            raise ValueError(f"{name}: all tensors must be on one device")
        if t.stride(-1) != 1 or any(st % 4 for st in t.stride()[:-1]) \
                or t.data_ptr() % 8:
            raise ValueError(f"{name}: need a contiguous last dim, strides "
                             "that are multiples of 4 and 8-byte alignment")


def decode_attention(q, k, v, *, q_offset, kv_len=None,
                     scale: Optional[float] = None,
                     kv_scale: Optional[float] = None):
    """Decode attention: q [b, hq, 1, d]; k/v [b, hk, S, d] → [b, hq, 1, d]
    in q's dtype (q and k/v may be strided views with a contiguous d).  q_offset/kv_len scalar or [b]; kv_len defaults to
    q_offset + 1 and is clamped to S."""
    b, hq, sq, d = q.shape
    _, hk, S, _ = k.shape
    if sq != 1 or hq % hk:
        raise ValueError(f"decode_attention: q {tuple(q.shape)} k {tuple(k.shape)}")
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    if kv_len is None:
        kv_len = (q_offset + 1 if isinstance(q_offset, torch.Tensor)
                  else int(q_offset) + 1)
    if q.device.type == "cpu":
        return _attention_ref(q, k, v, causal=False, q_offset=q_offset,
                              kv_len=kv_len, scale=scale,
                              kv_scale=kv_scale).to(q.dtype)
    _check_kv("decode_attention", q, k, v)
    if d % 4 or d > 256:
        raise ValueError("decode_attention: need d % 4 == 0 and d <= 256")
    kvl = _per_row(kv_len, b, q.device)
    out = torch.empty((b, hq, 1, d), dtype=q.dtype, device=q.device)
    ll = ctypes.c_longlong
    fn = _build.c_function(
        "attention", "decode_attention_launch",
        (ctypes.c_void_p, ll, ll, ctypes.c_void_p, ll, ll, ll, ctypes.c_void_p, ll, ll, ll,
         ctypes.c_void_p, ctypes.c_void_p) + (ctypes.c_int,) * 6
        + (ctypes.c_float, ctypes.c_float, ctypes.c_void_p))
    ks, vs = k.stride(), v.stride()
    err = fn(q.data_ptr(), q.stride(0), q.stride(1), k.data_ptr(), ks[0], ks[1], ks[2],
             v.data_ptr(), vs[0], vs[1], vs[2], kvl.data_ptr(), out.data_ptr(),
             b, hq, hk, S, d, int(k.dtype == torch.int8),
             scale * (kv_scale if kv_scale is not None else 1.0),
             kv_scale if kv_scale is not None else 1.0,
             torch.cuda.current_stream(q.device).cuda_stream)
    _build.check("attention", err, "decode_attention")
    _build.launch_counts["decode_attention"] += 1
    return out


def _attention_fwd(name, q, k, v, causal, q_offset, kv_len, scale, kv_scale,
                   bhsd: bool = False):
    """q [b, sq, hq, d] (bshd) or [b, hq, sq, d] (bhsd); k/v [b, hk, S, d] →
    the output in q's layout."""
    if bhsd:
        b, hq, sq, d = q.shape
    else:
        b, sq, hq, d = q.shape
    _, hk, S, _ = k.shape
    if hq % hk:
        raise ValueError(f"{name}: hq={hq} not a multiple of hk={hk}")
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    if kv_len is None:
        kv_len = S
    if q.device.type in ("cpu", "meta"):      # meta: shapes while a graph records
        if bhsd:
            return _attention_ref(q, k, v, causal=causal, q_offset=q_offset, kv_len=kv_len,
                                  scale=scale, kv_scale=kv_scale).to(q.dtype)
        return _attention_ref(q.permute(0, 2, 1, 3), k, v, causal=causal,
                              q_offset=q_offset, kv_len=kv_len, scale=scale,
                              kv_scale=kv_scale).permute(0, 2, 1, 3).to(q.dtype)
    _check_kv(name, q, k, v)
    if d not in (64, 128):
        raise NotImplementedError(f"{name}: head_dim {d} (CUDA kernel takes 64 or 128)")
    off = _per_row(q_offset, b, q.device)
    kvl = _per_row(kv_len, b, q.device)
    out = torch.empty(tuple(q.shape), dtype=q.dtype, device=q.device)
    # the kernel's (batch, seq, head) strides of q and out, in either layout
    seq_dim, head_dim = (2, 1) if bhsd else (1, 2)
    ll3 = ctypes.c_longlong * 3
    qs = ll3(q.stride(0), q.stride(seq_dim), q.stride(head_dim))
    ks = ll3(*k.stride()[:3])
    vs = ll3(*v.stride()[:3])
    os_ = ll3(out.stride(0), out.stride(seq_dim), out.stride(head_dim))
    vp, sp = ctypes.c_void_p, ctypes.POINTER(ctypes.c_longlong)
    fn = _build.c_function(
        "attention", "attention_fwd_launch",
        (vp, sp) * 3 + (vp, vp, vp, sp) + (ctypes.c_int,) * 8
        + (ctypes.c_float, ctypes.c_float, ctypes.c_void_p))
    err = fn(q.data_ptr(), qs, k.data_ptr(), ks, v.data_ptr(), vs,
             off.data_ptr(), kvl.data_ptr(), out.data_ptr(), os_,
             b, sq, hq, hk, S, d, int(k.dtype == torch.int8), int(causal),
             scale * (kv_scale if kv_scale is not None else 1.0),
             kv_scale if kv_scale is not None else 1.0,
             torch.cuda.current_stream(q.device).cuda_stream)
    _build.check("attention", err, name)
    _build.launch_counts[name] += 1
    return out


def prefill_attention(q, k, v, *, causal: bool = True, q_offset=0,
                      kv_len=None, scale: Optional[float] = None,
                      kv_scale: Optional[float] = None):
    """Short-context prefill attention (the JAX package keeps the whole KV
    resident per step): q [b, sq, hq, d] (bshd), k/v [b, hk, S, d] →
    [b, sq, hq, d]."""
    return _attention_fwd("prefill_attention", q, k, v, causal, q_offset,
                          kv_len, scale, kv_scale)


def flash_attention(q, k, v, *, causal: bool = True, q_offset=0, kv_len=None,
                    scale: Optional[float] = None,
                    kv_scale: Optional[float] = None, qo_layout: str = "bhsd"):
    """Blocked online-softmax attention: q [b, hq, sq, d] (qo_layout "bhsd",
    the JAX default) or [b, sq, hq, d] ("bshd"); k/v [b, hk, S, d] → the
    output in q's layout and dtype.  q_offset / kv_len scalar or [b];
    kv_len defaults to S."""
    if qo_layout not in ("bhsd", "bshd"):
        raise ValueError(f"flash_attention: qo_layout {qo_layout!r}")
    bhsd = qo_layout == "bhsd"
    return _attention_fwd("flash_attention_bhsd" if bhsd else "flash_attention", q, k, v,
                          causal, q_offset, kv_len, scale, kv_scale, bhsd=bhsd)
