"""Attention over a static (optionally int8) KV cache: decode, short-context
prefill and blocked (flash) prefill — counterpart of
csinn2_tpu/kernels/flash_attention.py.

Each entry point launches its CUDA kernel (csrc/attention.cu) for CUDA
tensors and runs the plain PyTorch version `_attention_ref` for CPU tensors.
`prefill_attention` and `flash_attention` share one device kernel
(`attn_fwd_kernel`, tensor-core flash attention that reads q and writes the
output through (batch, seq, head) strides, so the bshd and bhsd layouts need
no change to it); they stay two entry points because the model dispatches
between them by the same 8 MiB rule as the JAX package.  `_fwd_plan` picks
the kernel's shape: where the GQA group's queries × sq fit one CTA (64
rows: decode) the KV window is split over CTAs and a second kernel merges
the chunks, otherwise the query rows are split.  Launch counts:
`prefill_attention`, `flash_attention` (bshd), `flash_attention_bhsd`, and
`<that name>.combine` for the merge of a split launch; `decode_attention`
(a split-KV kernel of its own, `_decode_plan`) and `decode_attention.combine`.
A head dim above MAX_D = 256 goes, from every entry point, to one more
tensor-core kernel (`attn_wide_mma_kernel` on wgmma, O split over
warpgroups and CTAs by columns; `_wide_plan` picks its shape, with a
split-KV decode whose grid comes nearest 2 CTAs an SM), counted as
`attention_wide.<entry point>` and `attention_wide.<entry point>.combine`
for its merge.

Semantics shared by all (per batch row b): query i sits at position
q_offset[b] + i; it sees keys kpos < kv_len[b] (and kpos <= its position when
causal); int8 K/V carriers are dequantized by the per-tensor kv_scale; GQA
maps query head h to KV head h // (hq // hk); a row that sees no key outputs
0.  K/V are [b, hk, S, d] and may be strided views (the port passes the
cache's [b, S, hk, d] buffer permuted, without a copy).  q is rounded to
bf16 first, as the JAX bodies round it (the kernels as they stage it, the
plain path before `_attention_ref`); the output comes back in q's dtype,
from f32 sums.  On the card: any head dim (the JAX functions pad d to a
multiple of 128 with no cap) and a bf16, f16 or f32 q (other float types
pass through f32).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Optional

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


# q / out dtype codes of csrc/attention.cu
_DT = {torch.bfloat16: 0, torch.float16: 1, torch.float32: 2}
MAX_D = 256                 # attn_fwd_kernel's widest head dim (wider: attn_wide_mma_kernel)
SPLIT_ROWS = 64             # sq·group at or below this: split-KV flash decode
SPLIT_CHUNK = 256           # keys per CTA on the split path


def _check_kv(name, q, k, v):
    if not q.is_floating_point():
        raise TypeError(f"{name}: q must be a float tensor, got {q.dtype}")
    if k.dtype != v.dtype or k.dtype not in (torch.int8, torch.bfloat16):
        raise TypeError(f"{name}: k/v must both be int8 or bf16, got "
                        f"{k.dtype}/{v.dtype}")
    d = q.shape[-1]
    if k.shape[-1] != d or v.shape[-1] != d:
        raise ValueError(f"{name}: head dims q {d}, k {k.shape[-1]}, v {v.shape[-1]}")
    for t in (q, k, v):
        if t.device != q.device:
            raise ValueError(f"{name}: all tensors must be on one device")
        if t.stride(-1) != 1:
            raise ValueError(f"{name}: need a contiguous last dim")


def _kernel_q(q):
    """q as the kernel reads it: bf16, f16 or f32 (other floats through f32)."""
    return q if q.dtype in _DT else q.float()


def _row_align(*ts) -> int:
    """The largest power of two up to 16 bytes that divides the start and
    every (batch, head, seq) stride of each tensor's rows."""
    g = 16
    for t in ts:
        g = math.gcd(g, t.data_ptr())
        for st in t.stride()[:3]:
            g = math.gcd(g, st * t.element_size())
    return g


def _vec_bytes(k, v) -> int:
    """Bytes per K/V load of attn_fwd_kernel: 16, 8 or 4, dividing each row's
    start, stride and length; 0 where none does (element by element)."""
    g = math.gcd(_row_align(k, v), k.shape[-1] * k.element_size())
    return g if g >= 4 else 0


def _fwd_plan(b: int, sq: int, hq: int, hk: int, S: int, d: int, n_sm: int):
    """(row groups rw, key slices kw, keys per chunk, chunks) of
    attn_fwd_kernel.  A CTA is rw × kw warps: rw groups of 16 query rows,
    each K/V tile (64 keys, 32 at d > 128) cut in kw slices of at least 16
    keys (rw·kw <= 4 with slices); the chunks cover all S keys.  sq·group
    <= 64 (flash decode): one CTA row block holds the group's queries, and
    the KV window is cut in chunks of SPLIT_CHUNK keys (a second kernel
    merges them when there are several).  Otherwise one chunk and the
    largest row block of 128 (d <= 128), 64, 32 or 16 rows that still gives
    90 % of the card's n_sm SMs a CTA; below 4 row groups the other warps
    take key slices."""
    rows = sq * (hq // hk)
    max_kw = 2 if d > 128 else 4
    if rows <= SPLIT_ROWS:
        rw = 1 if rows <= 16 else 2 if rows <= 32 else 4
        return rw, min(max_kw, 4 // rw), SPLIT_CHUNK, max(1, -(-S // SPLIT_CHUNK))
    fills = lambda block: -(-rows // block) * hk * b * 10 >= 9 * n_sm
    whole = max(SPLIT_CHUNK, -(-S // SPLIT_CHUNK) * SPLIT_CHUNK)
    if d <= 128 and fills(128):
        return 8, 1, whole, 1
    rw = 4 if fills(64) else 2 if fills(32) else 1
    return rw, min(max_kw, 4 // rw), whole, 1


WIDE_SMEM = 232448          # dynamic shared memory an H100 CTA may take
WIDE_ROWS = 64              # m rows a CTA of attn_wide_mma_kernel: one wgmma m64 tile
WIDE_MAX_WG = 3             # warpgroups a CTA
WIDE_OW = 128               # O columns a warpgroup: 64 f32 registers a thread
WIDE_TILES = ((64, 2), (32, 2), (64, 1), (32, 1))   # (keys a tile, ring stages)
WIDE_CHUNKS = (512, 256, 128, 64)   # keys a CTA the split path picks from


class WidePlan(NamedTuple):
    """attn_wide_mma_kernel's shape: wg warpgroups of WIDE_OW O columns each
    over 64 m rows; `slices` CTAs over O's columns (WIDE_OW·wg each); bkv
    keys a K/V tile; qc dims of Q and K a ring step (d padded to
    64: resident); `stages` ring stages; the KV window in n_chunks chunks of
    `chunk` keys."""
    wg: int
    slices: int
    bkv: int
    qc: int
    stages: int
    chunk: int
    n_chunks: int


def _wide_smem(wg: int, bkv: int, qc: int, stages: int, d: int, kv_bytes: int) -> int:
    """Shared memory of attn_wide_mma_kernel (csrc/attention.cu wide_smem,
    plus the 1024 bytes that align it; regions rounded up to 1024): the
    ring's stages of K (bkv × qc) and V (bkv × vw, vw = min(WIDE_OW·wg, d
    padded to 64)) as bf16 tiles, or as int8 rows 16 bytes apart widened
    into one bf16 K and V tile, plus a Q block (64 × qc) where qc < d
    streams it; Q resident (64 × qc bf16) otherwise; P (64 × 64 bf16), the
    softmax's exchange (1 KB) and the stages' mbarriers (16 bytes)."""
    i8, streamed = kv_bytes == 1, qc < d
    al = lambda x: -(-x // 1024) * 1024
    vw = min(wg * WIDE_OW, -(-d // 64) * 64)
    q, k, v = WIDE_ROWS * qc * 2, bkv * qc * 2, bkv * vw * 2
    stage = (al(bkv * (qc + 16)) + al(bkv * (vw + 16)) if i8 else k + v) + (q if streamed else 0)
    return (stages * stage + (k + v if i8 else 0) + (0 if streamed else q) + WIDE_ROWS * 64 * 2
            + 4 * WIDE_ROWS * 4 + 16 + 1024)


def _wide_plan(b: int, sq: int, hq: int, hk: int, S: int, d: int, kv_bytes: int,
               n_sm: int) -> WidePlan:
    """attn_wide_mma_kernel's plan at d > MAX_D.  O's columns: as few CTA
    slices as take them at WIDE_MAX_WG warpgroups of WIDE_OW columns, then as
    few warpgroups as take a slice's share.  Tiles: the first of WIDE_TILES
    whose shared memory fits WIDE_SMEM with Q and whole K rows resident (qc
    = d padded to 64), else the same over streamed blocks of 256, 128 or 64
    dims, whose shared memory does not grow with d: every d has a plan.
    The KV window splits in chunks of keys, one CTA each: of the whole
    window and the chunks of WIDE_CHUNKS shorter than S, the one whose full
    window gives a grid (b·hk·slices CTAs a block of 64 m rows, times the
    chunks) nearest 2 CTAs an SM; on the card that chunk was the fastest of
    the decode sweep at GQA 32/8 d = 320 and 576 and at absorbed MLA's
    decode, 128 heads on one latent head (PERF.md row 2'').  So the decode
    splits, and so does any grid far under the SMs; a grid already near 2
    CTAs an SM does not.  No chunk is shorter than the one whose f32
    partials (4 bytes a column of each m row) weigh twice its K and V rows
    (2·kv_bytes a column of each key)."""
    dp = -(-d // 64) * 64
    slices = -(-d // (WIDE_MAX_WG * WIDE_OW))
    wg = -(-d // (slices * WIDE_OW))
    slices = -(-d // (wg * WIDE_OW))
    cands = [(bkv, st, dp) for bkv, st in WIDE_TILES]
    cands += [(bkv, st, qc) for qc in (256, 128, 64) if qc < d for bkv, st in WIDE_TILES]
    bkv, stages, qc = next(c for c in cands
                           if _wide_smem(wg, c[0], c[2], c[1], d, kv_bytes) <= WIDE_SMEM)
    rows = sq * (hq // hk)
    ctas = b * hk * slices * -(-rows // WIDE_ROWS)
    chunk = min([S] + [c for c in WIDE_CHUNKS if c * kv_bytes >= rows and c < S],
                key=lambda c: abs(ctas * -(-S // c) - 2 * n_sm))
    if chunk < S:
        return WidePlan(wg, slices, bkv, qc, stages, chunk, -(-S // chunk))
    return WidePlan(wg, slices, bkv, qc, stages, max(bkv, -(-S // bkv) * bkv), 1)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


DECODE_CHUNKS = (512, 256, 128, 64)   # keys per CTA the decode plan picks from
DECODE_SMALL_CHUNKS = (32, 16)        # ... where the shared memory takes no more
DECODE_SMEM = 100 * 1024    # bytes of shared memory a decode CTA may take (2 an SM)
DECODE_WARPS = 4            # csrc/attention.cu DEC_WARPS


def _decode_smem(d: int, kv_bytes: int, group: int, chunk: int) -> int:
    """Shared memory of decode_attn_kernel (csrc/attention.cu dec_smem): the
    chunk's K and V rows (each L lanes × 16 bytes, L the power of two with
    L·16 >= d·kv_bytes), f32 q, scores, (max, sum) and the warps' P·V sums
    for 1 (group 1) or 4 heads a sweep."""
    lanes = 1
    while lanes * 16 < d * kv_bytes:
        lanes *= 2
    rb, dpad = lanes * 16, lanes * 16 // kv_bytes
    hb = 1 if group == 1 else 4
    return 2 * chunk * rb + 4 * (group * dpad + group * chunk + 2 * group
                                 + DECODE_WARPS * hb * dpad)


def _decode_plan(b: int, hq: int, hk: int, S: int, d: int, kv_bytes: int, n_sm: int):
    """(keys per chunk, chunks) of decode_attn_kernel: the longest chunk of
    DECODE_CHUNKS (DECODE_SMALL_CHUNKS where none fits) whose shared memory
    fits DECODE_SMEM and whose split of a full window (S keys) over the hk
    KV heads gives at least 2 CTAs per SM, else the shortest that fits; one
    chunk when the window fits it."""
    group = hq // hk
    fit = lambda cs: [c for c in cs if _decode_smem(d, kv_bytes, group, c) <= DECODE_SMEM]
    fits = fit(DECODE_CHUNKS) or fit(DECODE_SMALL_CHUNKS) or [DECODE_SMALL_CHUNKS[-1]]
    chunk = next((c for c in fits if hk * -(-S // c) >= 2 * n_sm), fits[-1])
    if S <= chunk:
        return max(1, S), 1
    return chunk, -(-S // chunk)


def decode_attention(q, k, v, *, q_offset, kv_len=None,
                     scale: Optional[float] = None,
                     kv_scale: Optional[float] = None):
    """Decode attention: q [b, hq, 1, d]; k/v [b, hk, S, d] → [b, hq, 1, d]
    in q's dtype (q and k/v may be strided views with a contiguous d).
    q_offset/kv_len scalar or [b]; kv_len defaults to q_offset + 1 and is
    clamped to S.  On the card a split-KV kernel (`_decode_plan` chunks,
    merged by a second kernel: launch count `decode_attention.combine`), or
    the wide kernel at d > MAX_D."""
    b, hq, sq, d = q.shape
    _, hk, S, _ = k.shape
    if sq != 1 or hq % hk:
        raise ValueError(f"decode_attention: q {tuple(q.shape)} k {tuple(k.shape)}")
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    if kv_len is None:
        kv_len = (q_offset + 1 if isinstance(q_offset, torch.Tensor)
                  else int(q_offset) + 1)
    if q.device.type == "cpu":      # q rounded to bf16, as the kernel stages it
        return _attention_ref(q.to(torch.bfloat16), k, v, causal=False, q_offset=q_offset,
                              kv_len=kv_len, scale=scale,
                              kv_scale=kv_scale).to(q.dtype)
    if d > MAX_D:                   # the wide kernel, as a one-query, non-causal call
        return _attention_fwd("decode_attention", q, k, v, False, 0, kv_len, scale, kv_scale,
                              bhsd=True)
    _check_kv("decode_attention", q, k, v)
    qk = _kernel_q(q)
    kvl = _per_row(kv_len, b, q.device)
    out = torch.empty((b, hq, 1, d), dtype=qk.dtype, device=q.device)
    chunk, n_chunks = _decode_plan(b, hq, hk, S, d, k.element_size(),
                                   _sm_count(q.device.index or 0))
    part_ml = part_acc = None
    if n_chunks > 1:
        part_ml = torch.empty((b, hk, n_chunks, hq // hk, 2), dtype=torch.float32,
                              device=q.device)
        part_acc = torch.empty((b, hk, n_chunks, hq // hk, d), dtype=torch.float32,
                               device=q.device)
    ll, i32, vp = ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p
    fn = _build.c_function(
        "attention", "decode_attention_launch",
        (vp, i32, ll, ll, vp, ll, ll, ll, vp, ll, ll, ll, vp, vp, i32, vp, vp) + (i32,) * 9
        + (ctypes.c_float, ctypes.c_float, vp))
    ks, vs = k.stride(), v.stride()
    ptr = lambda t: None if t is None else t.data_ptr()
    err = fn(qk.data_ptr(), _DT[qk.dtype], qk.stride(0), qk.stride(1), k.data_ptr(), ks[0],
             ks[1], ks[2], v.data_ptr(), vs[0], vs[1], vs[2], kvl.data_ptr(), out.data_ptr(),
             _DT[out.dtype], ptr(part_ml), ptr(part_acc), b, hq, hk, S, d,
             int(k.dtype == torch.int8), _vec_bytes(k, v), chunk, n_chunks,
             scale * (kv_scale if kv_scale is not None else 1.0),
             kv_scale if kv_scale is not None else 1.0,
             torch.cuda.current_stream(q.device).cuda_stream)
    _build.check("attention", err, "decode_attention")
    _build.launch_counts["decode_attention"] += 1
    if n_chunks > 1:
        _build.launch_counts["decode_attention.combine"] += 1
    return out.to(q.dtype)


def _attention_fwd(name, q, k, v, causal, q_offset, kv_len, scale, kv_scale,
                   bhsd: bool = False):
    """q [b, sq, hq, d] (bshd) or [b, hq, sq, d] (bhsd); k/v [b, hk, S, d] →
    the output in q's layout: attn_fwd_kernel, or attn_wide_mma_kernel at d
    > MAX_D (launch count `attention_wide.<name>`, its merge
    `attention_wide.<name>.combine`)."""
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
        qb = q.to(torch.bfloat16)             # as the kernel stages it
        if bhsd:
            return _attention_ref(qb, k, v, causal=causal, q_offset=q_offset,
                                  kv_len=kv_len, scale=scale, kv_scale=kv_scale).to(q.dtype)
        return _attention_ref(qb.permute(0, 2, 1, 3), k, v, causal=causal,
                              q_offset=q_offset, kv_len=kv_len, scale=scale,
                              kv_scale=kv_scale).permute(0, 2, 1, 3).to(q.dtype)
    _check_kv(name, q, k, v)
    qk = _kernel_q(q)
    out = torch.empty(tuple(q.shape), dtype=qk.dtype, device=q.device)
    # a per-row tensor, or one int for every row (no device copy)
    off = _per_row(q_offset, b, q.device) if isinstance(q_offset, torch.Tensor) else None
    kvl = _per_row(kv_len, b, q.device) if isinstance(kv_len, torch.Tensor) else None
    # the kernel's (batch, seq, head) strides of q and out, in either layout
    seq_dim, head_dim = (2, 1) if bhsd else (1, 2)
    ll3 = ctypes.c_longlong * 3
    vp, sp, i32 = ctypes.c_void_p, ctypes.POINTER(ctypes.c_longlong), ctypes.c_int
    ptr = lambda t: None if t is None else t.data_ptr()
    head = (qk.data_ptr(), ll3(qk.stride(0), qk.stride(seq_dim), qk.stride(head_dim)),
            _DT[qk.dtype], k.data_ptr(), ll3(*k.stride()[:3]), v.data_ptr(),
            ll3(*v.stride()[:3]), ptr(off), 0 if off is not None else int(q_offset),
            ptr(kvl), 0 if kvl is not None else int(kv_len), out.data_ptr(),
            ll3(out.stride(0), out.stride(seq_dim), out.stride(head_dim)), _DT[out.dtype])
    dims = (b, sq, hq, hk, S, d, int(k.dtype == torch.int8), int(causal), _vec_bytes(k, v))
    tail = (scale * (kv_scale if kv_scale is not None else 1.0),
            kv_scale if kv_scale is not None else 1.0,
            torch.cuda.current_stream(q.device).cuda_stream)
    argtypes = (vp, sp, i32, vp, sp, vp, sp, vp, i32, vp, i32, vp, sp, i32)
    if d > MAX_D:
        plan = _wide_plan(b, sq, hq, hk, S, d, k.element_size(), _sm_count(q.device.index or 0))
        n_chunks, entry, key = plan.n_chunks, "attention_wide_launch", f"attention_wide.{name}"
    else:
        plan = _fwd_plan(b, sq, hq, hk, S, d, _sm_count(q.device.index or 0))
        n_chunks, entry, key = plan[-1], "attention_fwd_launch", name
    part_ml = part_acc = None
    if n_chunks > 1:
        rows = sq * (hq // hk)
        part_ml = torch.empty((b, hk, n_chunks, rows, 2), dtype=torch.float32, device=q.device)
        part_acc = torch.empty((b, hk, n_chunks, rows, d), dtype=torch.float32,
                               device=q.device)
    fn = _build.c_function("attention", entry, argtypes + (vp, vp) + (i32,) * (9 + len(plan))
                           + (ctypes.c_float, ctypes.c_float, vp))
    err = fn(*head, ptr(part_ml), ptr(part_acc), *dims, *plan, *tail)
    _build.check("attention", err, name)
    _build.launch_counts[key] += 1
    if n_chunks > 1:
        _build.launch_counts[f"{key}.combine"] += 1
    return out.to(q.dtype)


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
