"""Functional Llama forward with weight-only quantized linears and a
static-shape (optionally int8) KV cache — counterpart of
csinn2_tpu/llm/model.py: the dense FFN and the mixture of experts (dense
no-drop and capacity-routed dispatch over stacked [E, K, N] expert weights).

Params are a plain dict {"tok_embedding", "norm", "output", "layers": [...]}
whose weights are `QWeight` dataclasses holding tensors.  Unlike the JAX
functions, which return a new cache, `KVCache.store` and everything that
calls it update the cache's tensors IN PLACE (and return the same cache), so
the multi-gigabyte buffer is never copied.

Quantized linears go through kernels.qmatmul.quant_matmul and attention
through kernels.flash_attention: CUDA tensors launch the hand-written
kernels, CPU tensors take their plain PyTorch versions.

Tensor / expert parallelism (parallel/tp.py, parallel/ep.py): the forward
functions take tp_group and ep_group, the torch counterparts of the JAX
functions' tp_axis and ep_axis.  Under tp_group `cfg` is the rank's local
config (heads and ffn divided by tp) and the params the rank's shards; the
block outputs are summed over the group with one all_reduce after wo and
one after w2 (bf16, as the JAX psum sums them), and llama_forward gathers
the vocab shards of the logits.  Under ep_group each rank holds E/ep
experts; moe_ffn_block sums them over the group (f32).
"""

from __future__ import annotations

import ctypes
import dataclasses
import os
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from csinn2_tpu_torch.core.quant import BLOCK_SIZE
from csinn2_tpu_torch.kernels import _build
from csinn2_tpu_torch.kernels.flash_attention import (flash_attention,
                                                      prefill_attention)
from csinn2_tpu_torch.kernels.qmatmul import (pack_int4, quant_matmul,
                                              swiglu_pairs)
from csinn2_tpu_torch.llm.config import LlamaConfig
from csinn2_tpu_torch.parallel.mesh import all_gather, all_reduce
from csinn2_tpu_torch.utils.device import resolve_device

# quant modes for weights (the names of the JAX package)
FLOAT = "float"            # bf16 weights
INT8_CHANNEL = "int8"      # int8 + per-out-channel scale (f32[N])
INT4_CHANNEL = "int4"      # int4 (packed, or int8 carrier in [-8,7]) + per-channel scale
Q8_0 = "q8_0"              # int8 + f16-rounded scale per 32 along K
Q4_0 = "q4_0"              # packed int4 + f16-rounded scale per 32 along K
INT4_MODES = (INT4_CHANNEL, Q4_0)
CHANNEL_MODES = (INT8_CHANNEL, INT4_CHANNEL)

# whole-KV prefill kernel while the KV of one layer fits this budget
# (the JAX package's VMEM rule, kept so both take the same branch)
PREFILL_KV_BYTES = 8 * 2**20


@dataclasses.dataclass
class QWeight:
    """[K, N] weight: bf16 values (FLOAT); int8 values [K, N], or int4
    nibble-packed values [K/2, N] (packed=True, kernels.qmatmul.pack_int4);
    scales None, f32 [N] (channel modes) or f32 [K/32, N] (Q8_0, Q4_0).
    Stacked MoE experts carry a leading [E] on values and scales.
    layout "swiglu128": a fused w1|w3 in 128-column pair order."""

    values: torch.Tensor
    scales: Optional[torch.Tensor] = None
    mode: str = FLOAT
    packed: bool = False        # int4 nibble-packed values (2 weights/byte)
    layout: str = "plain"       # "plain" | "swiglu128"

    @property
    def shape(self):
        """The logical [K, N], also for packed values."""
        v = tuple(self.values.shape)
        return v[:-2] + (2 * v[-2], v[-1]) if self.packed else v


def quantize_weight(w: np.ndarray, mode: str, device="cuda") -> QWeight:
    """f32 [K, N] host array → QWeight on `device`, with the JAX package's
    host math (same rounding, same f16-rounded block scales, same nibble
    packing), so the bytes are identical.  A 3-D [E, K, N] array (stacked
    MoE experts) quantizes each expert on its own and stacks values and
    scales on axis 0."""
    dev = resolve_device(device)
    w = np.asarray(w, np.float32)
    if w.ndim == 3:
        parts = [quantize_weight(w[e], mode, "cpu") for e in range(w.shape[0])]
        return QWeight(values=torch.stack([p.values for p in parts]).to(dev),
                       scales=None if parts[0].scales is None
                       else torch.stack([p.scales for p in parts]).to(dev),
                       mode=mode, packed=parts[0].packed)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    if mode == FLOAT:
        return QWeight(values=torch.from_numpy(w).to(dev, torch.bfloat16),
                       mode=FLOAT)
    if mode in CHANNEL_MODES:
        bound = 127.0 if mode == INT8_CHANNEL else 7.0
        amax = np.abs(w).max(axis=0)                      # per out-channel
        scale = np.where(amax == 0, 1.0, amax / bound).astype(np.float32)
        q = np.clip(np.round(w / scale), -bound - 1, bound).astype(np.int8)
        return _maybe_pack(QWeight(values=t(q), scales=t(scale), mode=mode))
    if mode in (Q8_0, Q4_0):
        K, N = w.shape
        if K % BLOCK_SIZE:
            raise ValueError(f"{mode} needs K % {BLOCK_SIZE} == 0, got K={K}")
        bound = 127.0 if mode == Q8_0 else 7.0
        wb = w.reshape(K // BLOCK_SIZE, BLOCK_SIZE, N)
        amax = np.abs(wb).max(axis=1, keepdims=True)
        d = (amax / bound).astype(np.float16).astype(np.float32)
        q = np.where(d == 0, 0.0, np.round(wb / np.where(d == 0, 1.0, d)))
        q = np.clip(q, -bound, bound).astype(np.int8).reshape(K, N)
        return _maybe_pack(QWeight(values=t(q), scales=t(d[:, 0, :]), mode=mode))
    raise ValueError(f"unknown weight mode {mode!r}")


def _maybe_pack(qw: QWeight) -> QWeight:
    """int4 modes: nibble-pack the carrier (2 weights/byte, half the bytes of
    the decode weight stream).  K % 32 != 0 (INT4_CHANNEL only) keeps the
    int8 carrier, as in the JAX package."""
    if qw.mode not in INT4_MODES or qw.packed or qw.values.shape[-2] % BLOCK_SIZE:
        return qw
    return dataclasses.replace(qw, values=pack_int4(qw.values), packed=True)


def quantize_weight_device(w: torch.Tensor, mode: str) -> QWeight:
    """Quantize an f32 [..., K, N] tensor where it lies — the counterpart of
    the JAX package's quantize_weight_jax (same rounding, f16-rounded block
    scales, same packing; leading dims are stacked experts)."""
    if mode == FLOAT:
        return QWeight(values=w.to(torch.bfloat16), mode=FLOAT)
    w = w.float()
    if mode in CHANNEL_MODES:
        bound = 127.0 if mode == INT8_CHANNEL else 7.0
        amax = w.abs().amax(dim=-2)                        # per out-channel
        scale = torch.where(amax == 0, torch.ones_like(amax), amax / bound)
        q = torch.round(w / scale.unsqueeze(-2)).clamp_(-bound - 1.0, bound).to(torch.int8)
        return _maybe_pack(QWeight(values=q, scales=scale, mode=mode))
    if mode in (Q8_0, Q4_0):
        bound = 127.0 if mode == Q8_0 else 7.0
        *lead, K, N = w.shape
        wb = w.reshape(*lead, K // BLOCK_SIZE, BLOCK_SIZE, N)
        d = (wb.abs().amax(dim=-2, keepdim=True) / bound) \
            .to(torch.float16).to(torch.float32)
        q = torch.where(d == 0, torch.zeros_like(wb),
                        torch.round(wb / torch.where(d == 0, torch.ones_like(d), d)))
        q = q.clamp_(-bound, bound).to(torch.int8).reshape(*lead, K, N)
        return _maybe_pack(QWeight(values=q, scales=d[..., 0, :].contiguous(), mode=mode))
    raise ValueError(f"unknown weight mode {mode!r}")


def _qweights(params):
    """Every QWeight of a params dict (or one QWeight)."""
    if isinstance(params, QWeight):
        yield params
    elif isinstance(params, dict):
        for v in params.values():
            yield from _qweights(v)
    elif isinstance(params, (list, tuple)):
        for v in params:
            yield from _qweights(v)


def qweight_concat(qws: List[QWeight], tp: int = 1) -> QWeight:
    """Concatenate QWeights along the output (N) axis (wq|wk|wv, w1|w3): one
    GEMM launch instead of several, one longer weight stream.  Packed values
    concatenate as they are (packing runs along K).

    tp > 1: the fused N axis is laid out [q0|k0|v0 | q1|k1|v1 | ...] per tp
    shard, so plain column sharding hands each rank its own slices of every
    part (a plain [q|k|v] would give rank 0 only q columns)."""
    m0 = qws[0]
    if any(q.mode != m0.mode or q.packed != m0.packed for q in qws):
        raise ValueError("qweight_concat: mixed modes")

    def cat(parts):
        if tp == 1:
            return torch.cat(parts, dim=-1)
        if any(p.shape[-1] % tp for p in parts):
            raise ValueError(f"qweight_concat: N {[p.shape[-1] for p in parts]} "
                             f"not divisible by tp={tp}")
        chunked = [p.reshape(*p.shape[:-1], tp, p.shape[-1] // tp) for p in parts]
        out = torch.cat(chunked, dim=-1)                  # [..., tp, sum(N)/tp]
        return out.reshape(*out.shape[:-2], -1)

    return QWeight(values=cat([q.values for q in qws]),
                   scales=None if m0.scales is None else cat([q.scales for q in qws]),
                   mode=m0.mode, packed=m0.packed)


def _pad_cols(a: Optional[torch.Tensor], Fp: int) -> Optional[torch.Tensor]:
    if a is None or a.shape[-1] == Fp:
        return a
    return F.pad(a, (0, Fp - a.shape[-1]))


def _pad_rows_qw(qw: QWeight, Kp: int) -> QWeight:
    """Zero-pad a QWeight's K (contraction) dim to Kp: zero rows (and zero
    block scales) contribute nothing."""
    K = qw.shape[-2]
    if K == Kp:
        return qw
    rows = (Kp - K) // 2 if qw.packed else Kp - K
    v = F.pad(qw.values, (0, 0, 0, rows))
    s = qw.scales
    if s is not None and s.ndim >= 2 and s.shape[-2] == K // BLOCK_SIZE:
        s = F.pad(s, (0, 0, 0, (Kp - K) // BLOCK_SIZE))
    return dataclasses.replace(qw, values=v, scales=s)


def qweight_concat_swiglu(w1: QWeight, w3: QWeight, pad_to: int = 512) -> QWeight:
    """Fuse w1|w3 in 128-column PAIR-interleaved order
    [w1[:, 0:128] | w3[:, 0:128] | w1[:, 128:256] | w3[:, 128:256] | ...],
    F zero-padded to a multiple of `pad_to` (7B: 11008 → 11264), so that
    quant_matmul(swiglu=True) computes silu(h1)·h3 in its epilogue and the
    [M, 2F] h13 intermediate is never written out.  silu(0)·0 = 0 in the
    padded tail; fuse_layer_weights pads w2's K to match."""
    if w3.mode != w1.mode or w3.packed != w1.packed:
        raise ValueError("qweight_concat_swiglu: mixed modes")
    Fd = w1.shape[-1]
    if Fd % 128 or w3.shape[-1] != Fd:
        raise ValueError(f"qweight_concat_swiglu: F={Fd} must be a multiple of "
                         "128 and equal for w1 and w3")
    Fp = -(-Fd // pad_to) * pad_to

    def pair(a, b):
        a, b = _pad_cols(a, Fp), _pad_cols(b, Fp)
        g = Fp // 128
        ar = a.reshape(*a.shape[:-1], g, 128)
        br = b.reshape(*b.shape[:-1], g, 128)
        return torch.stack([ar, br], dim=-2).reshape(*a.shape[:-1], 2 * Fp)

    return QWeight(values=pair(w1.values, w3.values),
                   scales=None if w1.scales is None else pair(w1.scales, w3.scales),
                   mode=w1.mode, packed=w1.packed, layout="swiglu128")


def fuse_layer_weights(lp: Dict, tp: int = 1) -> Dict:
    """wqkv = [wq|wk|wv] and w13 = [w1|w3] (dense FFN), as in the JAX
    package; tp > 1 interleaves the fused axis per shard (qweight_concat).
    With CSINN2_SWIGLU_FUSE=1 (opt-in there too), tp == 1 and
    F % 128 == 0, w13 takes the swiglu128 pair layout and w2 is K-padded to
    the padded F."""
    out = dict(lp)
    if all(k in lp for k in ("wq", "wk", "wv")):
        out["wqkv"] = qweight_concat([lp["wq"], lp["wk"], lp["wv"]], tp=tp)
        out.pop("wq"), out.pop("wk"), out.pop("wv")
    if "w1" in lp and "w3" in lp and "gate" not in lp:
        if (tp == 1 and lp["w1"].shape[-1] % 128 == 0
                and os.environ.get("CSINN2_SWIGLU_FUSE") == "1"):
            out["w13"] = qweight_concat_swiglu(lp["w1"], lp["w3"])
            Fp = out["w13"].shape[-1] // 2
            if Fp != lp["w1"].shape[-1]:
                out["w2"] = _pad_rows_qw(lp["w2"], Fp)
        else:
            out["w13"] = qweight_concat([lp["w1"], lp["w3"]], tp=tp)
        out.pop("w1"), out.pop("w3")
    return out


def fuse_params(params: Dict, tp: int = 1) -> Dict:
    return {**params,
            "layers": [fuse_layer_weights(lp, tp=tp) for lp in params["layers"]]}


def linear(x: torch.Tensor, qw: QWeight, *, out_dtype=torch.float32,
           swiglu: bool = False) -> torch.Tensor:
    """y = x @ dequant(qw); x [..., K].  out_dtype=bf16 for internal
    activations, f32 for the logits.  swiglu=True (qw.layout "swiglu128"):
    silu(h1)·h3 over the pair columns, [..., N/2].  FLOAT weights stay a
    plain matmul, with the pairs taken after it (the JAX package leaves them
    to XLA, outside Pallas)."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1]).to(torch.bfloat16).contiguous()
    n_out = qw.shape[-1] // 2 if swiglu else qw.shape[-1]
    if qw.mode == FLOAT:
        out = torch.matmul(x2.float(), qw.values.float())
        out = (swiglu_pairs(out) if swiglu else out).to(out_dtype)
    else:
        Kw = qw.shape[-2]
        if Kw > x2.shape[-1]:
            x2 = F.pad(x2, (0, Kw - x2.shape[-1]))      # a K-padded weight
        out = quant_matmul(x2, qw.values, qw.scales,
                           scale_mode="channel" if qw.mode in CHANNEL_MODES else "block",
                           out_dtype=out_dtype, packed_int4=qw.packed, swiglu=swiglu)
    return out.reshape(*lead, n_out)


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    ms = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * weight).to(x.dtype)


def rope_tables(positions: torch.Tensor, d: int, base: float):
    """RoPE (cos, sin) for a position vector, computed once per forward and
    shared by every layer.  positions [s] or [b, s] → each [1|b, s, 1, d/2]
    f32."""
    dev = positions.device
    inv_freq = base ** (-torch.arange(0, d // 2, dtype=torch.float32,
                                      device=dev) * 2.0 / d)
    theta = positions.float()[..., None] * inv_freq
    if theta.ndim == 2:
        theta = theta[None]
    return torch.cos(theta)[:, :, None, :], torch.sin(theta)[:, :, None, :]


def rope_rotate(x: torch.Tensor, positions, base: float, tables=None):
    """Interleaved-pair RoPE (pairs (0,1), (2,3), ... of the head dim).
    x: [b, s, h, d]; tables: optional (cos, sin) from rope_tables."""
    b, s, h, d = x.shape
    cos, sin = rope_tables(positions, d, base) if tables is None else tables
    xf = x.float()
    x0 = xf[..., 0::2]
    x1 = xf[..., 1::2]
    r0 = x0 * cos - x1 * sin
    r1 = x0 * sin + x1 * cos
    return torch.stack([r0, r1], dim=-1).reshape(b, s, h, d).to(x.dtype)


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

def init_params(cfg: LlamaConfig, mode: str = FLOAT, seed: int = 0,
                scale: float = 0.02, device="cuda") -> Dict:
    """Random-init the parameter dict with the JAX package's numpy RNG
    stream (MoE: the gate and the stacked experts drawn after the attention
    weights, as there), so the same seed gives the same bytes."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)

    def w(shape):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    D, F_ = cfg.dim, cfg.ffn_dim
    kvd = cfg.n_kv_heads * cfg.head_dim
    params = {
        "tok_embedding": torch.from_numpy(w((cfg.vocab_size, D))).to(dev, torch.bfloat16),
        "norm": torch.ones(D, dtype=torch.float32, device=dev),
        "output": quantize_weight(w((D, cfg.vocab_size)), mode, dev),
        "layers": [],
    }
    E = cfg.n_experts
    ex = (E,) if E else ()                  # stacked experts' leading dim
    for _ in range(cfg.n_layers):
        lp = {
            "attn_norm": torch.ones(D, dtype=torch.float32, device=dev),
            "ffn_norm": torch.ones(D, dtype=torch.float32, device=dev),
            "wq": quantize_weight(w((D, D)), mode, dev),
            "wk": quantize_weight(w((D, kvd)), mode, dev),
            "wv": quantize_weight(w((D, kvd)), mode, dev),
            "wo": quantize_weight(w((D, D)), mode, dev),
        }
        if E:
            lp["gate"] = torch.from_numpy(w((D, E))).to(dev)
        lp["w1"] = quantize_weight(w(ex + (D, F_)), mode, dev)
        lp["w2"] = quantize_weight(w(ex + (F_, D)), mode, dev)
        lp["w3"] = quantize_weight(w(ex + (D, F_)), mode, dev)
        params["layers"].append(lp)
    return params


def init_params_device(cfg: LlamaConfig, mode: str = FLOAT, seed: int = 0,
                       scale: float = 0.02, device="cuda") -> Dict:
    """Random-init and quantize on the device from a torch.Generator seeded
    with `seed`: only the seed crosses to the card, which at 7B takes seconds
    where the host path takes minutes.  The values are NOT those of the JAX
    package's init_params_device (torch's generator is not JAX's PRNG); use
    init_params or llm.params.params_from_numpy for weights shared with JAX.
    MoE: the f32 gate [D, E] and the stacked experts [E, ...] follow the
    attention weights."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    def w(shape):
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=torch.float32).mul_(scale)

    def gen_q(shape):
        return quantize_weight_device(w(shape), mode)

    D, F_ = cfg.dim, cfg.ffn_dim
    kvd = cfg.n_kv_heads * cfg.head_dim
    params = {
        "tok_embedding": w((cfg.vocab_size, D)).to(torch.bfloat16),
        "norm": torch.ones(D, dtype=torch.float32, device=dev),
        "output": gen_q((D, cfg.vocab_size)),
        "layers": [],
    }
    E = cfg.n_experts
    ex = (E,) if E else ()
    for _ in range(cfg.n_layers):
        lp = {
            "attn_norm": torch.ones(D, dtype=torch.float32, device=dev),
            "ffn_norm": torch.ones(D, dtype=torch.float32, device=dev),
            "wq": gen_q((D, D)), "wk": gen_q((D, kvd)), "wv": gen_q((D, kvd)),
            "wo": gen_q((D, D)),
        }
        if E:
            lp["gate"] = w((D, E))
        lp.update(w1=gen_q(ex + (D, F_)), w2=gen_q(ex + (F_, D)), w3=gen_q(ex + (D, F_)))
        params["layers"].append(lp)
    return params


def quantize_params(params: Dict, mode: str) -> Dict:
    """Requantize a FLOAT params dict to `mode` through the host math of
    quantize_weight (bytes identical to the JAX package's quantize_params;
    stacked experts per expert, the f32 MoE gate unchanged)."""
    def conv(qw):
        if not isinstance(qw, QWeight):
            return qw
        if qw.mode != FLOAT:
            raise ValueError("quantize_params expects FLOAT params")
        return quantize_weight(qw.values.float().cpu().numpy(), mode,
                               qw.values.device)

    return {"tok_embedding": params["tok_embedding"], "norm": params["norm"],
            "output": conv(params["output"]),
            "layers": [{k: conv(v) for k, v in lp.items()}
                       for lp in params["layers"]]}


# ---------------------------------------------------------------------------
# KV cache
# ---------------------------------------------------------------------------

def quantize_kv(t: torch.Tensor, scale: float) -> torch.Tensor:
    """int8 KV carrier: round half to even, clip to ±127, one scale."""
    return torch.clamp(torch.round(t.float() / scale), -127, 127).to(torch.int8)


@dataclasses.dataclass
class KVCache:
    """Static-shape per-layer K/V buffers [L, B, S_max, H_kv, Dh].  int8 mode
    stores carriers and one per-tensor f32 scale (dequant is fused into the
    attention kernels)."""

    k: torch.Tensor
    v: torch.Tensor
    scale: Optional[float] = None     # None → float cache

    @staticmethod
    def create(cfg: LlamaConfig, batch: int, quantized: bool = False,
               scale: float = 0.05, dtype=torch.bfloat16,
               device="cuda") -> "KVCache":
        dev = resolve_device(device)
        shape = (cfg.n_layers, batch, cfg.max_seq_len, cfg.n_kv_heads,
                 cfg.head_dim)
        dt = torch.int8 if quantized else dtype
        return KVCache(k=torch.zeros(shape, dtype=dt, device=dev),
                       v=torch.zeros(shape, dtype=dt, device=dev),
                       scale=scale if quantized else None)

    def _carrier(self, t: torch.Tensor) -> torch.Tensor:
        return quantize_kv(t, self.scale) if self.scale is not None \
            else t.to(self.k.dtype)

    def store(self, layer: int, pos: int, k_new, v_new) -> "KVCache":
        """Write [b, s, hk, dh] at rows pos .. pos+s-1 of `layer`, in place."""
        s = k_new.shape[1]
        if pos < 0 or pos + s > self.k.shape[2]:
            raise ValueError(f"KVCache.store: rows {pos}..{pos + s} outside "
                             f"the cache's {self.k.shape[2]}")
        self.k[layer, :, pos:pos + s] = self._carrier(k_new)
        self.v[layer, :, pos:pos + s] = self._carrier(v_new)
        return self

    def read(self, layer: int):
        """→ (k, v) [b, S_max, hk, dh]: int8 carriers in int8 mode."""
        return self.k[layer], self.v[layer]


def decode_prologue_ref(qk, v, tables, pos_vec, cache: KVCache, layer: int) -> torch.Tensor:
    """The batched decode step's attention prologue, plainly: interleaved-
    pair RoPE on the q|k heads qk [b, 1, hq + hk, dh] from the step's
    rope_tables (rope_rotate), then the rotated k and the unrotated v
    [b, 1, hk, dh] as the cache's carriers (quantize_kv; a float cache takes
    them in its dtype) stored at row pos_vec[i] of lane i of cache layer
    `layer`, in place.  A lane at pos >= S writes nothing (the JAX scatter's
    mode="drop"): its row S - 1 is rewritten with what it holds.  Returns
    the rotated q [b, 1, hq, dh] in qk's dtype."""
    b, hk = qk.shape[0], v.shape[2]
    hq = qk.shape[2] - hk
    qk = rope_rotate(qk, None, 0.0, tables=tables)
    S = cache.k.shape[2]
    bidx = torch.arange(b, device=qk.device)
    keep = (pos_vec < S)[:, None, None]
    rows = pos_vec.clamp(max=S - 1).long()
    for buf, new in ((cache.k, qk[:, 0, hq:]), (cache.v, v[:, 0])):
        new = cache._carrier(new)
        buf[layer, bidx, rows] = torch.where(keep, new, buf[layer, bidx, rows])
    return qk[:, :, :hq]


def decode_prologue(qk, v, tables, pos_vec, cache: KVCache, layer: int) -> torch.Tensor:
    """decode_prologue_ref in one launch on the card (csrc/decode_prologue.cu,
    launch count `decode_prologue`; q comes back contiguous), bit for bit;
    the plain version for CPU tensors.  On the card qk and v are bf16 (any
    strides with a contiguous head dim), the cache int8 or bf16 and dh
    even; anything else raises."""
    if qk.device.type == "cpu":
        return decode_prologue_ref(qk, v, tables, pos_vec, cache, layer)
    b, s, hqk, d = qk.shape
    hk = v.shape[2]
    hq = hqk - hk
    kbuf, vbuf = cache.k[layer], cache.v[layer]
    int8 = cache.scale is not None
    if s != 1 or v.shape != (b, 1, hk, d) or hq < 1 or d % 2 or \
            kbuf.shape[0] < b or kbuf.shape[2:] != (hk, d) or vbuf.shape != kbuf.shape:
        raise ValueError(f"decode_prologue: qk {tuple(qk.shape)}, v {tuple(v.shape)}, "
                         f"cache layer {tuple(kbuf.shape)}")
    cos, sin = (t.reshape(b, d // 2) for t in tables)
    if qk.dtype != torch.bfloat16 or v.dtype != torch.bfloat16 or \
            kbuf.dtype != (torch.int8 if int8 else torch.bfloat16) or vbuf.dtype != kbuf.dtype \
            or cos.dtype != torch.float32 or sin.dtype != torch.float32:
        raise TypeError(f"decode_prologue: qk / v {qk.dtype} / {v.dtype} (bf16), cache "
                        f"{kbuf.dtype} with scale {cache.scale}, tables {cos.dtype}")
    if any(t.stride(-1) != 1 for t in (qk, v, kbuf, vbuf)) or vbuf.stride() != kbuf.stride() \
            or not (cos.is_contiguous() and sin.is_contiguous()) or \
            any(t.device != qk.device for t in (v, kbuf, cos, sin, pos_vec)):
        raise ValueError("decode_prologue: the head dims must be contiguous, the tables "
                         "contiguous, the cache's K and V strided alike, all on one device")
    pos = pos_vec.to(torch.int32).contiguous()
    q = torch.empty((b, 1, hq, d), dtype=torch.bfloat16, device=qk.device)
    # PyTorch divides a CUDA tensor by a Python float as a product with the
    # scale's reciprocal, taken in double and rounded to f32
    inv_scale = float(np.float32(1.0 / cache.scale)) if int8 else 1.0
    ll, i32, vp = ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p
    fn = _build.c_function("decode_prologue", "decode_prologue_launch",
                           (vp, ll, ll, vp, ll, ll) + (vp,) * 6 + (ll,) * 3 + (i32,) * 6
                           + (ctypes.c_float, vp))
    ks = kbuf.stride()
    err = fn(qk.data_ptr(), qk.stride(0), qk.stride(2), v.data_ptr(), v.stride(0), v.stride(2),
             cos.data_ptr(), sin.data_ptr(), pos.data_ptr(), q.data_ptr(), kbuf.data_ptr(),
             vbuf.data_ptr(), ks[0], ks[1], ks[2], b, kbuf.shape[1], hq, hk, d, int(int8),
             inv_scale, torch.cuda.current_stream(qk.device).cuda_stream)
    _build.check("decode_prologue", err, "decode_prologue")
    _build.launch_counts["decode_prologue"] += 1
    return q


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def attention_block(x, layer_params, cache: KVCache, layer_idx: int, pos: int,
                    cfg: LlamaConfig, kv_bound: Optional[int] = None, tp_group=None):
    """One attention sublayer including the KV-cache update (in place).
    tp_group: the rank's heads (cfg local), wo's row shard, the partial
    outputs summed over the group."""
    b, s, _ = x.shape
    hq, hk, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    lp = layer_params
    qk, v = _project_qkv(x, lp, hq, hk, dh)
    positions = pos + torch.arange(s, device=x.device)
    # q and k heads rotate together: one pass over [b, s, hq + hk, dh]
    qk = rope_rotate(qk, positions, cfg.rope_base, tables=lp.get("_rope_tables"))
    q, k = qk[:, :, :hq], qk[:, :, hq:]

    cache.store(layer_idx, pos, k, v)
    k_all, v_all = cache.read(layer_idx)          # [b, S_max, hk, dh]
    if kv_bound is not None and kv_bound < k_all.shape[1]:
        # the caller guarantees pos + s <= kv_bound: never-written tail rows
        # of the static cache are not read
        k_all, v_all = k_all[:, :kv_bound], v_all[:, :kv_bound]
    k_t = k_all.permute(0, 2, 1, 3)               # [b, hk, S, dh] views
    v_t = v_all.permute(0, 2, 1, 3)
    S_kv = k_t.shape[2]
    kv_bytes = hk * S_kv * max(dh, 128) * 2 * k_t.element_size()
    attn = prefill_attention if s > 1 and kv_bytes <= PREFILL_KV_BYTES \
        else _flash_bshd
    out = attn(q.to(torch.bfloat16), k_t, v_t, causal=True, q_offset=pos,
               kv_len=pos + s, kv_scale=cache.scale)   # [b, s, hq, dh]
    out = linear(out.reshape(b, s, hq * dh), lp["wo"], out_dtype=torch.bfloat16)
    return all_reduce(out, tp_group, "wo"), cache


def _project_qkv(x, lp, hq: int, hk: int, dh: int):
    """x [b, s, D] → (q|k heads [b, s, hq + hk, dh], v [b, s, hk, dh]), bf16,
    through the fused wqkv GEMM when the params carry it."""
    b, s, _ = x.shape
    if "wqkv" in lp:
        qkv = linear(x, lp["wqkv"], out_dtype=torch.bfloat16)
        return (qkv[..., :(hq + hk) * dh].reshape(b, s, hq + hk, dh),
                qkv[..., (hq + hk) * dh:].reshape(b, s, hk, dh))
    q = linear(x, lp["wq"], out_dtype=torch.bfloat16)
    k = linear(x, lp["wk"], out_dtype=torch.bfloat16)
    v = linear(x, lp["wv"], out_dtype=torch.bfloat16)
    return torch.cat([q, k], dim=-1).reshape(b, s, hq + hk, dh), v.reshape(b, s, hk, dh)


def _flash_bshd(q, k, v, **kw):
    return flash_attention(q, k, v, qo_layout="bshd", **kw)


def ffn_block(x, layer_params, tp_group=None):
    """SwiGLU FFN: w2(silu(w1 x) * w3 x).  tp_group: w1/w3 column and w2
    row shards, the partial outputs summed over the group."""
    lp = layer_params
    if "w13" in lp and lp["w13"].layout == "swiglu128":
        # silu(h1)·h3 in the GEMM's epilogue: h13 is never written out
        h = linear(x, lp["w13"], out_dtype=torch.bfloat16, swiglu=True)
    else:
        h = _swiglu_h(x, lp)
    return all_reduce(linear(h, lp["w2"], out_dtype=torch.bfloat16), tp_group, "w2")


def _swiglu_h(x, lp):
    """silu(w1 x)·(w3 x) from bf16 linears (fused w13 or w1 and w3), bf16."""
    if "w13" in lp:
        h13 = linear(x, lp["w13"], out_dtype=torch.bfloat16)
        F_ = h13.shape[-1] // 2
        h1, h3 = h13[..., :F_], h13[..., F_:]
    else:
        h1 = linear(x, lp["w1"], out_dtype=torch.bfloat16)
        h3 = linear(x, lp["w3"], out_dtype=torch.bfloat16)
    return (F.silu(h1.float()) * h3.float()).to(torch.bfloat16)


def _expert_slice(qw: QWeight, e: int) -> QWeight:
    """Expert e of a stacked weight: values[e] and scales[e] are contiguous
    views at an offset, which quant_matmul takes without a copy."""
    return QWeight(values=qw.values[e],
                   scales=None if qw.scales is None else qw.scales[e],
                   mode=qw.mode, packed=qw.packed)


def _gate_top_k(x: torch.Tensor, gate: torch.Tensor, k: int):
    """Router: f32 logits x @ gate (full f32 under torch's default, TF32
    off), their top k with ties to the lower expert index as jax.lax.top_k
    breaks them (a stable descending sort; torch.topk orders equal values in
    no fixed way), and the softmax over the k.
    → (expert ids [..., k], weights [..., k] f32)."""
    logits = torch.matmul(x.float(), gate.float())
    topv, topi = torch.sort(logits, dim=-1, descending=True, stable=True)
    return topi[..., :k], torch.softmax(topv[..., :k], dim=-1)


def _expert_ffn(x: torch.Tensor, lp, e: int) -> torch.Tensor:
    """Expert e's SwiGLU on x [..., D]: f32 linears, silu(h1)·h3 in f32 cast
    to bf16, f32 out — the JAX package's expert body."""
    h1 = linear(x, _expert_slice(lp["w1"], e))
    h3 = linear(x, _expert_slice(lp["w3"], e))
    h = (F.silu(h1) * h3).to(torch.bfloat16)
    return linear(h, _expert_slice(lp["w2"], e))


def moe_ffn_block(x, layer_params, cfg: LlamaConfig, ep_group=None, tp_group=None):
    """Top-k mixture-of-experts SwiGLU FFN, dense no-drop formulation: every
    expert computes on all tokens and its router weight (0 where the token
    did not pick it) scales its output.  x [b, s, D] → f32 [b, s, D].

    ep_group: the rank holds experts ep_rank·n_local .. + n_local - 1 of the
    stacked weights and takes their window of the router weights; tp_group:
    each expert's w1/w3 column and w2 row shards.  The f32 sum is reduced
    over tp, then over ep: one all_reduce a group, as the JAX psums."""
    lp = layer_params
    E, k = cfg.n_experts, cfg.moe_top_k
    topi, topw = _gate_top_k(x, lp["gate"], k)
    # the k picks are distinct experts: a scatter is the one-hot sum exactly
    wts = torch.zeros(*topi.shape[:-1], E, dtype=torch.float32,
                      device=x.device).scatter_(-1, topi, topw)
    n_local = lp["w1"].values.shape[0]
    base = dist.get_rank(ep_group) * n_local if ep_group is not None else 0
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for e in range(n_local):
        out = out + wts[..., base + e:base + e + 1] * _expert_ffn(x, lp, e)
    return all_reduce(all_reduce(out, tp_group, "moe_tp"), ep_group, "moe_ep")


def moe_capacity(T: int, cfg: LlamaConfig, capacity_factor: float) -> int:
    """Tokens an expert's buffer holds: the JAX package's float arithmetic."""
    return max(1, min(T, int(np.ceil(T * cfg.moe_top_k / cfg.n_experts
                                     * capacity_factor))))


def moe_ffn_block_routed(x, layer_params, cfg: LlamaConfig,
                         capacity_factor: float = 2.0):
    """Capacity-routed MoE dispatch, the JAX package's formulation: each
    (token, choice) pair takes the next slot of its expert's buffer of
    cap = moe_capacity(T) rows, in token-major order; pairs past cap are
    dropped and the token's router weights renormalized over its kept
    choices; each expert computes on its buffer only.  The JAX function's
    one-hot dispatch and combine einsums become a gather into the buffers
    and a gather-sum out of them (a slot holds at most one pair, so both are
    exact).  x [b, s, D] → f32 [b, s, D]."""
    lp = layer_params
    b, s, D = x.shape
    T = b * s
    E, k = cfg.n_experts, cfg.moe_top_k
    xt = x.reshape(T, D)
    topi, topw = _gate_top_k(xt, lp["gate"], k)             # [T, k]
    cap = moe_capacity(T, cfg, capacity_factor)

    # rank of each pair in its expert's queue: earlier pairs, token-major
    # (one-hot by comparison: F.one_hot checks its input's range, which
    # waits for the card)
    flat = topi.reshape(T * k)
    oh = (flat[:, None] == torch.arange(E, device=x.device)).long()
    r = (torch.cumsum(oh, dim=0) - oh).gather(1, flat[:, None]).reshape(T, k)
    keep = r < cap
    kept_w = topw * keep
    denom = kept_w.sum(dim=-1, keepdim=True)
    kept_w = torch.where(denom > 0, kept_w / torch.clamp(denom, min=1e-9),
                         torch.zeros_like(kept_w))
    # a kept pair's slot in the [E·cap] buffers; a dropped one points at an
    # extra zero row (E·cap), the JAX one-hot's zero row for r >= cap
    slot = torch.where(keep, topi * cap + r, torch.full_like(r, E * cap))
    tok = torch.arange(T, device=x.device)[:, None].expand(T, k)
    xin = torch.zeros((E * cap + 1, D), dtype=torch.bfloat16, device=x.device)
    xin[slot.reshape(-1)] = xt.to(torch.bfloat16)[tok.reshape(-1)]
    xin = xin[:E * cap].reshape(E, cap, D)
    ye = torch.zeros((E * cap + 1, D), dtype=torch.float32, device=x.device)
    for e in range(E):
        ye[e * cap:(e + 1) * cap] = _expert_ffn(xin[e], lp, e)
    out = torch.zeros((T, D), dtype=torch.float32, device=x.device)
    for j in range(k):
        out = out + kept_w[:, j:j + 1] * ye[slot[:, j]]
    return out.reshape(b, s, D)


def moe_routed(cfg: LlamaConfig, T: int) -> bool:
    """llama_forward's dense/routed choice for T = b·s tokens: the JAX
    package's rule (its v5e crossover: routed from 256 tokens under "auto")."""
    return cfg.moe_dispatch == "routed" or (cfg.moe_dispatch == "auto" and T >= 256)


def embed_tokens(params, tokens) -> torch.Tensor:
    """tokens [b, s] → the embedding rows [b, s, D] (bf16) on the table's
    device."""
    emb = params["tok_embedding"]
    return emb[torch.as_tensor(tokens, device=emb.device).long()]


def llama_layers(layers, x, cache: KVCache, pos: int, cfg: LlamaConfig,
                 kv_bound: Optional[int] = None, tp_group=None, ep_group=None,
                 routed: bool = False) -> torch.Tensor:
    """The decoder layers `layers` over the residual stream x [b, s, D]; layer
    i writes layer i of `cache` (in place).  A layer with a "gate" runs the
    MoE FFN, capacity-routed when `routed`, else dense."""
    # RoPE trig is position-only: once per call, shared by all layers
    tabs = rope_tables(pos + torch.arange(x.shape[1], device=x.device),
                       cfg.head_dim, cfg.rope_base)
    for i, lp in enumerate(layers):
        lp = {**lp, "_rope_tables": tabs}
        h = rms_norm(x, lp["attn_norm"], cfg.norm_eps)
        attn_out, cache = attention_block(h.to(torch.bfloat16), lp, cache, i,
                                          pos, cfg, kv_bound=kv_bound, tp_group=tp_group)
        x = x + attn_out.to(x.dtype)
        h = rms_norm(x, lp["ffn_norm"], cfg.norm_eps).to(torch.bfloat16)
        if "gate" not in lp:
            ffn_out = ffn_block(h, lp, tp_group)
        elif routed:
            ffn_out = moe_ffn_block_routed(h, lp, cfg,
                                           capacity_factor=cfg.moe_capacity_factor)
        else:
            ffn_out = moe_ffn_block(h, lp, cfg, ep_group, tp_group)
        x = x + ffn_out.to(x.dtype)
    return x


def llama_head(params, x, cfg: LlamaConfig, tp_group=None) -> torch.Tensor:
    """Final norm and lm_head: x [b, s, D] → logits [b, s, V] f32; a
    vocab-sharded lm_head's logit shards gathered along the vocab."""
    x = rms_norm(x, params["norm"], cfg.norm_eps)
    return all_gather(linear(x.to(torch.bfloat16), params["output"]), tp_group, -1, "logits")


def llama_forward(params, tokens, cache: KVCache, pos: int, cfg: LlamaConfig,
                  kv_bound: Optional[int] = None, tp_group=None, ep_group=None):
    """tokens [b, s] → (logits [b, s, V] f32, cache).  One function for
    prefill (s = prompt) and decode (s = 1); the cache is updated in place.
    A layer with a "gate" runs the MoE FFN, routed or dense by moe_routed;
    under a group it runs dense (the routed dispatch is one rank's)."""
    x = embed_tokens(params, tokens)
    routed = (moe_routed(cfg, x.shape[0] * x.shape[1])
              and tp_group is None and ep_group is None)
    x = llama_layers(params["layers"], x, cache, pos, cfg, kv_bound=kv_bound,
                     tp_group=tp_group, ep_group=ep_group, routed=routed)
    return llama_head(params, x, cfg, tp_group), cache
