"""Q4_0 decode dequant-strategy probes: the counterpart of
examples/int4_dequant_probe.py:46-577 (the JAX probe's nine `_mk_call`
bodies and `run_w4a8`), as hand-written CUDA kernels (csrc/int4_probe.cu)
with their plain PyTorch versions.

Each `run_*` takes the JAX function's inputs and returns its output, with
the same outside ops in plain torch (the x halves, x_hi / 16, the block
sums and correction matmuls, the int8 activation quantization of intdot and
w4a8).  `prepare(...)` splits a call into those outside ops, the kernel
(`ProbeCall.kernel()`: one launch, which a probe times alone) and the
finishing corrections (`ProbeCall.finish`).  A CUDA tensor launches the
kernel or raises; a CPU tensor runs the kernel's plain version
(`kernel_ref`).  There is no fallback between the two.

The kernels (launch_counts key "int4_probe_<kind>"):

  kind           JAX body (examples/int4_dequant_probe.py)  weight carrier
  split_i32      _split_kernel :91, shifts "i32"   pack_int4 (Q4_0) [K/2, N]
  split_i8       _split_kernel :91, shifts "i8"    pack_int4
  i4native       _i4_kernel :141                   pack_int4_native [K, N/2]
  bitcast        _bitcast_kernel :173              pack_int4_biased [K/2, N]
  andmask        _andmask_kernel :234              pack_int4_mixed [K/2, N]
  andmask_bf16s  _andmask_bf16s_kernel :395        pack_int4_mixed, bf16 s
  stream         _stream_kernel :294               pack_int4
  intdot         _intdot_kernel :327               pack_int4_mixed
  w4a8           _w4a8_kernel :497 (run_w4a8 :530) pack_int4_mixed
  noscale        _noscale_kernel :440              pack_int4_mixed, bf16 s
  halfq8         _halfq8_kernel :460               pack_int4_mixed, bf16 s

Every kind runs on the skeleton of the port's decode GEMM qmm_decode_kernel
(csrc/decode_ring.cuh): 256-column strips × K splits, a cp.async ring of
raw weight bytes (and the scales and x a kind reads), and the strip's last
CTA summing the splits in the same launch (one launch a call, no reduce
kernel).  The eight kinds of PLANE_KINDS run one tensor-core template
(csrc/int4_probe.cu k_planes: mma.sync m16n8k16 with the widened bf16
weights as A); they differ in their widening only, so their times rank the
pipelines against cur(quant_matmul)'s.  intdot and w4a8 run k_int8, the
int8 decode GEMM's ring and A operand (mma.sync m16n8k32 s8 on the masked
and sign-extended nibbles), so they rank int8 tensor cores against the bf16
ones in the same skeleton; stream runs k_stream, the ring's weight copies
alone with the sampled rows summed from shared memory.

Numerics, as the TPU bodies compute them: the float kernels round each
dequantized plane value w·s to bf16 (s rounded to bf16 first), then sum
x·(w·s) in f32; bitcast's values are 128 + raw' (the re-biased nibble)
times s, rounded to bf16, and its outside correction subtracts
136·(bsum(x) @ s) in f32, which cancels most of the sum (cosine 0.9959
against the exact product in the JAX package itself).  The block sums of a
bf16 x are taken in f32 and rounded once to bf16, as jnp.sum does.  intdot
and w4a8 form exact int32 partials per 32-row block (p_lo + (p_hi >> 4):
exact, since the high plane holds 16·w_hi) and scale them in f32.

Timing-only kernels (their value is their time; they are held against their
plain versions like the others): stream returns xw + the sum of 8 sampled
byte rows per bk-row K tile, so its value depends on bk; noscale adds
s16[(K/bk − 1)·bk/32, (n // bn)·bn] and halfq8 adds x_hi[0, (K/bk − 1)·bk/2],
the single elements the TPU bodies read of the tiles they move.  The CUDA
kernels also load every byte the TPU moves but does not use: noscale's
scale tile, halfq8's x_hi tile and stream's unsampled weight rows go through
the ring (cp.async copies stay in the program).

Where the GPU differs from the TPU:
  * i4native: no GPU load unpacks sub-byte values, so the carrier of
    `jnp.int4 [K, N]` is [K, N/2] bytes packed along N (column 2j in the
    low nibble, 2j+1 in the high, two's complement): one plane, no x split.
  * w4a8: the TPU builds a block-diagonal X′[(g, m), k] (:538-551) to get
    per-block partials out of one MXU dot.  The CUDA kernel computes the
    same int32 partials straight from xq [M, K], one m16n8k32 product a
    block with no expansion; run_w4a8 returns the JAX run_w4a8's y.
  * intdot reads the per-block activation scales sx [M, K/32] directly
    (the TPU's lane-expanded [M, K/2] copy is a VMEM layout).
  * Geometry.  The TPU's (bn, bk) are VMEM tiles walked by a sequential
    grid.  Every kind takes a fixed 256-column strip and the decode GEMM's
    split plan (`plane_geometry`: qmatmul.gemm_plan, the strips' CTAs
    filling two slots an SM in one wave); the one knob left, the K rows per
    split, can be set per call (`prepare(..., ksplit=...)`, the tile
    tuner's sweep).  The tile selects no geometry: the JAX main's
    w4a8_n2048 / w4a8_n1024 variants launch the same kernel as w4a8.  bk
    is the value's tile for stream, noscale and halfq8, and bn for noscale;
    no other kernel's value depends on the tile.  One difference follows:
    where K % bk != 0 (the JAX main's w2, K = 11008 with bk = 512) the JAX
    grid covers only (K // bk)·bk rows of K in its kernels while its
    corrections cover all of K; the port's kernels cover all of K.

CUDA tensors: contiguous, M <= 16, N % 8 == 0, K % 32 == 0, bk a multiple
of 32 and at most K; stream needs K >= 128 (its xw is x[:, :128] tiled).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Callable, Dict, Optional, Tuple

import torch

from csinn2_tpu_torch.core.quant import BLOCK_SIZE
from csinn2_tpu_torch.kernels import _build
from csinn2_tpu_torch.kernels import qmatmul as _qmm
from csinn2_tpu_torch.kernels.qmatmul import DC_BN, DECODE_MAX_M

BLOCK = BLOCK_SIZE
HALF = BLOCK // 2
# kind → code of csrc/int4_probe.cu (enum Kind)
KINDS = {"split_i32": 0, "split_i8": 1, "i4native": 2, "bitcast": 3, "andmask": 4,
         "andmask_bf16s": 5, "stream": 6, "intdot": 7, "w4a8": 8, "noscale": 9, "halfq8": 10}
# the bf16 plane kinds of k_planes (the others: stream k_stream, intdot / w4a8 k_int8)
PLANE_KINDS = ("split_i32", "split_i8", "i4native", "bitcast", "andmask", "andmask_bf16s",
               "noscale", "halfq8")


# -- packers (byte for byte the JAX probe's) -----------------------------------

def _pack_halves(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    v = (lo.to(torch.int32) & 0xF) | ((hi.to(torch.int32) & 0xF) << 4)
    return v.to(torch.uint8).view(torch.int8)


def pack_int4_mixed(q: torch.Tensor) -> torch.Tensor:
    """[K, N] int8 in [-8, 7] → [K/2, N]: low nibble w(j) + 8 (biased), high
    nibble w(j+16) in two's complement (int4_dequant_probe.py:262)."""
    K = q.shape[0]
    q3 = q.to(torch.int32).reshape(K // BLOCK, BLOCK, -1)
    return _pack_halves(q3[:, :HALF] + 8, q3[:, HALF:]).reshape(K // 2, -1)


def pack_int4_biased(q: torch.Tensor) -> torch.Tensor:
    """[K, N] int8 in [-8, 7] → [K/2, N]: both nibbles raw' = w + 8 in
    [0, 15] (the JAX main's re-biased pack, :609-614)."""
    K = q.shape[0]
    q3 = q.to(torch.int32).reshape(K // BLOCK, BLOCK, -1) + 8
    return _pack_halves(q3[:, :HALF], q3[:, HALF:]).reshape(K // 2, -1)


def pack_int4_native(q: torch.Tensor) -> torch.Tensor:
    """[K, N] int8 in [-8, 7] → [K, N/2], the carrier of `jnp.int4 [K, N]`:
    byte j of a row holds column 2j (low nibble) and 2j+1 (high)."""
    return _pack_halves(q[:, 0::2], q[:, 1::2])


def _nibbles(p: torch.Tensor):
    """(low, high) nibbles of int8 bytes as int32 in [0, 15]."""
    u = p.view(torch.uint8).to(torch.int32)
    return u & 0xF, u >> 4


def _sign4(n: torch.Tensor) -> torch.Tensor:
    return (n ^ 8) - 8


def unpack_int4_native(w4: torch.Tensor) -> torch.Tensor:
    """[K, N/2] → [K, N] int32 values in [-8, 7]."""
    lo, hi = _nibbles(w4)
    return torch.stack([_sign4(lo), _sign4(hi)], dim=2).reshape(w4.shape[0], -1)


# -- geometry --------------------------------------------------------------------

def plane_geometry(M: int, N: int, K: int, n_sm: int,
                   ksplit: Optional[int] = None) -> Tuple[int, int]:
    """(columns per CTA, K rows per split) of every kind: the decode GEMM's
    256-column strip and, unless `ksplit` sets it, its split plan
    (qmatmul.gemm_plan on n_sm SMs)."""
    if ksplit is None:
        ksplit = _qmm.gemm_plan(M, N, K, False, n_sm)["blocks_per_split"] * BLOCK
    return DC_BN, ksplit


# -- the kernels' plain versions ---------------------------------------------------

def _bf16_rows(s: torch.Tensor, rows: int) -> torch.Tensor:
    """Block scales rounded to bf16, repeated over `rows` rows each, as f32."""
    return torch.repeat_interleave(s.to(torch.bfloat16).float(), rows, dim=0)


def _plane(v: torch.Tensor, s_rows: Optional[torch.Tensor]) -> torch.Tensor:
    """bf16(v) · bf16(s) rounded to bf16 (v is exact in bf16), as f32."""
    v = v.float()
    return v if s_rows is None else (v * s_rows).to(torch.bfloat16).float()


def _two_plane_values(kind: str, w: torch.Tensor):
    """The (low, high) plane values the body dequantizes from a byte."""
    lo, hi = _nibbles(w)
    if kind in ("split_i32", "split_i8"):
        return _sign4(lo), _sign4(hi)
    if kind == "bitcast":
        return 128 + lo, 128 + hi
    # andmask family: p & 0x0F = w_lo + 8, p & 0xF0 = 16·w_hi (signed byte)
    return lo, w.to(torch.int32) & -16


def _int_partials(xl, xh, w, M, G, N):
    """Exact int32 partials z[m, g, n] = Σ x_lo·(p & 0x0F) + (Σ x_hi·(p & 0xF0)) >> 4
    over the 16 byte rows of each block (f64 sums of integers, exact)."""
    lo, _ = _nibbles(w)
    l8 = lo.double().reshape(G, HALF, N)
    h8 = (w.to(torch.int32) & -16).double().reshape(G, HALF, N)
    zl = torch.einsum("mgj,gjn->mgn", xl.double().reshape(M, G, HALF), l8)
    zh = torch.einsum("mgj,gjn->mgn", xh.double().reshape(M, G, HALF), h8)
    return zl.long() + (zh.long() >> 4)


def kernel_ref(kind: str, t: Dict[str, torch.Tensor], M: int, N: int, K: int,
               bn: int, bk: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel part of `kind` on the tensors
    `prepare` made (f32 [M, N])."""
    G = K // BLOCK
    nk = K // bk
    if kind == "i4native":
        w = _plane(unpack_int4_native(t["w"]), _bf16_rows(t["s"], BLOCK))
        return t["xa"].float() @ w
    if kind == "stream":
        r = bk // 16
        rows = (torch.arange(nk, device=t["w"].device)[:, None] * (bk // 2)
                + torch.arange(8, device=t["w"].device)[None, :] * r).reshape(-1)
        return t["xw"] + t["w"][rows].to(torch.int64).sum(0).float()
    if kind in ("intdot", "w4a8"):
        if kind == "w4a8":
            x3 = t["xa"].reshape(M, G, BLOCK)
            z = _int_partials(x3[:, :, :HALF], x3[:, :, HALF:], t["w"], M, G, N)
            sc = t["s"][None]
        else:
            z = _int_partials(t["xa"], t["xb"], t["w"], M, G, N)
            sc = t["sx"][:, :, None] * t["s"][None]
        return (z.float() * sc).sum(1)
    if kind == "halfq8":
        w = _plane(t["w"].to(torch.int32), _bf16_rows(t["s"], HALF))
        y = t["xa"].float() @ w
        return y + t["xb"][0, (nk - 1) * (bk // 2)].float()
    lo, hi = _two_plane_values(kind, t["w"])
    s_rows = None if kind == "noscale" else _bf16_rows(t["s"], HALF)
    y = t["xa"].float() @ _plane(lo, s_rows) + t["xb"].float() @ _plane(hi, s_rows)
    if kind == "noscale":
        cols = (torch.arange(N, device=y.device) // bn) * bn
        y = y + t["s"][(nk - 1) * (bk // BLOCK), cols].float()
    return y


# -- the CUDA launch -------------------------------------------------------------

_VP, _CI, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_LAUNCH_ARGTYPES = (_CI,) + (_VP,) * 8 + (_LL, _VP) + (_CI,) * 7 + (_VP,)
# the tensors each kind's kernel reads: name → dtype
_INPUTS = {
    **{k: {"xa": torch.bfloat16, "xb": torch.bfloat16, "w": torch.int8, "s": torch.float32}
       for k in ("split_i32", "split_i8", "bitcast", "andmask")},
    **{k: {"xa": torch.bfloat16, "xb": torch.bfloat16, "w": torch.int8, "s": torch.bfloat16}
       for k in ("andmask_bf16s", "noscale", "halfq8")},
    "i4native": {"xa": torch.bfloat16, "w": torch.int8, "s": torch.float32},
    "stream": {"xw": torch.float32, "w": torch.int8},
    "intdot": {"xa": torch.int8, "xb": torch.int8, "sx": torch.float32, "w": torch.int8,
               "s": torch.float32},
    "w4a8": {"xa": torch.int8, "w": torch.int8, "s": torch.float32},
}


@functools.lru_cache(maxsize=None)
def _workspace_floats(M: int, N: int, K: int, ksplit: int) -> int:
    """f32 workspace floats (the split partials) the kernel asks for."""
    ws = _build.c_function("int4_probe", "int4_probe_workspace", (_CI,) * 4, restype=_LL)
    return int(ws(M, N, K, ksplit))


def _launch(kind: str, t: Dict[str, torch.Tensor], M: int, N: int, K: int,
            bn: int, bk: int, ksplit: Optional[int]) -> torch.Tensor:
    dev = t["w"].device
    for name, dt in _INPUTS[kind].items():
        a = t[name]
        if a.device != dev or a.dtype != dt or not a.is_contiguous() or a.data_ptr() % 16:
            raise ValueError(f"int4_probe {kind}: {name} must be a contiguous, 16-byte "
                             f"aligned {dt} tensor on {dev} (got {a.dtype} on {a.device})")
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    _, ksplit = plane_geometry(M, N, K, _qmm._sm_count(index), ksplit)
    n_ws = _workspace_floats(M, N, K, ksplit)
    out = torch.empty((M, N), dtype=torch.float32, device=dev)
    ws = torch.empty((n_ws,), dtype=torch.float32, device=dev) if n_ws else None
    stream = torch.cuda.current_stream(dev)
    counters = _qmm.strip_counters(dev, stream)
    ptr = lambda name: t[name].data_ptr() if name in t else None
    fn = _build.c_function("int4_probe", "int4_probe_launch", _LAUNCH_ARGTYPES)
    err = fn(KINDS[kind], ptr("xa"), ptr("xb"), ptr("sx"), t["w"].data_ptr(), ptr("s"),
             ptr("xw"), out.data_ptr(), None if ws is None else ws.data_ptr(), n_ws,
             counters.data_ptr(), _qmm.COUNTER_SLOTS, M, N, K, ksplit, bn, bk,
             stream.cuda_stream)
    _build.check("int4_probe", err, f"int4_probe {kind}")
    _build.launch_counts[f"int4_probe_{kind}"] += 1
    return out


def kernel_bytes(kind: str, M: int, N: int, K: int) -> int:
    """Bytes the kernel of `kind` must move: each input it reads once (the
    weight K·N/2, the scales at 4 bytes or 2 for bf16, stream none; the
    activations as the kernel takes them) and its f32 output [M, N]."""
    weight, out = K * N // 2, M * N * 4
    if kind == "stream":
        return weight + M * N * 4 + out               # xw is read, no scales
    scales = (K // BLOCK) * N * (2 if _INPUTS[kind]["s"] == torch.bfloat16 else 4)
    x = {"intdot": M * K + M * (K // BLOCK) * 4, "w4a8": M * K}.get(kind, M * K * 2)
    return weight + scales + x + out


def kernel_attrs(kind: str, M: int, device: int = 0) -> Dict[str, int]:
    """Registers per thread, static and dynamic shared memory per CTA (the
    ring is dynamic) and CTAs per SM with both
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor) of the kernel that
    serves (kind, M): the fit check of the tile tuner."""
    fn = _build.c_function("int4_probe", "int4_probe_attrs",
                           (_CI, _CI, _CI) + (ctypes.POINTER(_CI),) * 4)
    regs, smem, dyn, ctas = _CI(0), _CI(0), _CI(0), _CI(0)
    _build.check("int4_probe", fn(KINDS[kind], M, device, ctypes.byref(regs), ctypes.byref(smem),
                                  ctypes.byref(dyn), ctypes.byref(ctas)), "int4_probe attrs")
    return {"regs": regs.value, "smem": smem.value, "dyn_smem": dyn.value,
            "ctas_per_sm": ctas.value}


# -- calls: the outside ops, the kernel, the corrections ------------------------------

@dataclasses.dataclass
class ProbeCall:
    """One probe call split into the kernel's inputs (made by the outside
    ops), the kernel, and the corrections that finish it."""
    kind: str
    tensors: Dict[str, torch.Tensor]
    M: int
    N: int
    K: int
    bn: int
    bk: int
    finish: Callable[[torch.Tensor], torch.Tensor]
    ksplit: Optional[int] = None     # K rows per split (None: the decode GEMM's plan)

    def kernel(self) -> torch.Tensor:
        """The kernel part: the CUDA kernel for CUDA tensors, its plain
        version for CPU tensors."""
        dev = self.tensors["w"].device.type
        if dev == "cpu":
            return kernel_ref(self.kind, self.tensors, self.M, self.N, self.K, self.bn, self.bk)
        if dev != "cuda":
            raise ValueError(f"int4_probe: unsupported device {dev}")
        return _launch(self.kind, self.tensors, self.M, self.N, self.K, self.bn, self.bk,
                       self.ksplit)

    def __call__(self) -> torch.Tensor:
        return self.finish(self.kernel())


def _halves(x3: torch.Tensor, M: int, K: int):
    return (x3[:, :, :HALF].reshape(M, K // 2).contiguous(),
            x3[:, :, HALF:].reshape(M, K // 2).contiguous())


def _bf16_bsum(x3: torch.Tensor) -> torch.Tensor:
    """jnp.sum over the last axis of a bf16 array: f32 sum rounded to bf16."""
    return x3.float().sum(2).to(torch.bfloat16).float()


def _check(kind, x, bm, bn, bk, N, K):
    M = x.shape[0]
    if M % bm or bk % BLOCK or not 0 < bk <= K or K % BLOCK or bn <= 0:
        raise ValueError(f"int4_probe {kind}: M={M} bm={bm} bn={bn} bk={bk} K={K} (need "
                         "M % bm == 0, bk a multiple of 32 and at most K, K % 32 == 0)")
    if x.device.type == "cuda":
        if M > DECODE_MAX_M or N % 8 or (kind == "stream" and K < 128):
            raise ValueError(f"int4_probe {kind} on the card: M={M} (<= {DECODE_MAX_M}), "
                             f"N={N} (% 8), K={K} (stream: >= 128)")


def prepare(kind: str, x: torch.Tensor, w: torch.Tensor, s: torch.Tensor,
            bm: int, bn: int, bk: int, ksplit: Optional[int] = None) -> ProbeCall:
    """The outside ops of the JAX run_* for `kind` (x: [M, K]; w: the kind's
    carrier; s: f32 [K/32, N], bf16 for andmask_bf16s / noscale / halfq8).
    ksplit: K rows per split of the launch (a multiple of 32), None for the
    decode GEMM's plan."""
    if ksplit is not None and (ksplit <= 0 or ksplit % BLOCK):
        raise ValueError(f"int4_probe {kind}: ksplit={ksplit} (a positive multiple of 32)")
    call = _prepare(kind, x, w, s, bm, bn, bk)
    call.ksplit = ksplit
    return call


def _prepare(kind: str, x: torch.Tensor, w: torch.Tensor, s: torch.Tensor,
             bm: int, bn: int, bk: int) -> ProbeCall:
    M = x.shape[0]
    K, N = (w.shape[0], 2 * w.shape[1]) if kind == "i4native" else (2 * w.shape[0], w.shape[1])
    _check(kind, x, bm, bn, bk, N, K)
    G = K // BLOCK
    ident = lambda y: y
    if kind == "stream":
        xw = x[:, :128].repeat(1, -(-N // 128))[:, :N].float().contiguous()
        return ProbeCall(kind, {"xw": xw, "w": w}, M, N, K, bn, bk, ident)
    if kind == "i4native":
        return ProbeCall(kind, {"xa": x.to(torch.bfloat16).contiguous(), "w": w, "s": s},
                         M, N, K, bn, bk, ident)
    if kind == "w4a8":
        xf = x.float()
        sx = xf.abs().amax(1, keepdim=True) / 127.0 + 1e-12
        xq = torch.clamp(torch.round(xf / sx), -127, 127).to(torch.int8)
        bsum = xq.reshape(M, G, BLOCK)[:, :, :HALF].to(torch.int32).sum(2).float()

        def finish(y):
            return (y - 8.0 * (bsum @ s)) * sx
        return ProbeCall(kind, {"xa": xq, "w": w, "s": s}, M, N, K, bn, bk, finish)
    if kind == "intdot":
        x3 = x.float().reshape(M, G, BLOCK)
        sx = x3.abs().amax(2) / 127.0 + 1e-12
        xq3 = torch.clamp(torch.round(x3 / sx[:, :, None]), -127, 127)
        xlo, xhi = _halves(xq3.to(torch.int8), M, K)
        bsum_lo = xq3[:, :, :HALF].sum(2) * sx

        def finish(y):
            return y - 8.0 * (bsum_lo @ s)
        return ProbeCall(kind, {"xa": xlo, "xb": xhi, "sx": sx.contiguous(), "w": w, "s": s},
                         M, N, K, bn, bk, finish)
    x3 = x.to(torch.bfloat16).reshape(M, G, BLOCK)
    xlo, xhi = _halves(x3, M, K)
    t = {"xa": xlo, "xb": xhi, "w": w, "s": s}
    if kind == "bitcast":
        corr = _bf16_bsum(x3) @ s
        return ProbeCall(kind, t, M, N, K, bn, bk, lambda y: y - 136.0 * corr)
    if kind in ("andmask", "andmask_bf16s"):
        t["xb"] = xhi / 16
        corr = _bf16_bsum(x3[:, :, :HALF]) @ s.float()
        return ProbeCall(kind, t, M, N, K, bn, bk, lambda y: y - 8.0 * corr)
    if kind in KINDS:            # split_*, noscale, halfq8
        return ProbeCall(kind, t, M, N, K, bn, bk, ident)
    raise ValueError(f"int4_probe: unknown kind {kind!r}")


# -- the JAX probe's run_* ------------------------------------------------------------

def run_split(x, wp, s, bm, bn, bk, shifts):
    """x_lo @ bf16(lo·s) + x_hi @ bf16(hi·s) on the Q4_0 pack; shifts "i32"
    or "i8" (int4_dequant_probe.py:121)."""
    if shifts not in ("i32", "i8"):
        raise ValueError(f"run_split: shifts {shifts!r}")
    return prepare(f"split_{shifts}", x, wp, s, bm, bn, bk)()


def run_i4(x, w4, s, bm, bn, bk):
    """x @ bf16(w·s) on the [K, N/2] carrier of jnp.int4 [K, N] (:159)."""
    return prepare("i4native", x, w4, s, bm, bn, bk)()


def run_bitcast(x, wp_biased, s, bm, bn, bk):
    """kernel(x, raw') − 136·(x_blocksum @ s) (:210)."""
    return prepare("bitcast", x, wp_biased, s, bm, bn, bk)()


def run_andmask(x, wp_mixed, s, bm, bn, bk):
    """AND-mask planes of the mixed pack, − 8·(bsum_lo @ s) (:272)."""
    return prepare("andmask", x, wp_mixed, s, bm, bn, bk)()


def run_andmask_bf16s(x, wp_mixed, s16, bm, bn, bk):
    """run_andmask with bf16 scales given (:417)."""
    return prepare("andmask_bf16s", x, wp_mixed, s16, bm, bn, bk)()


def run_stream(x, wp, s, bm, bn, bk):
    """Timing only: xw + 8 sampled byte rows per K tile (:314); s is not
    read (the JAX function takes it and ignores it)."""
    return prepare("stream", x, wp, s, bm, bn, bk)()


def run_intdot(x, wp_mixed, s, bm, bn, bk):
    """W4A8 with per-32-block int8 activations (:362)."""
    return prepare("intdot", x, wp_mixed, s, bm, bn, bk)()


def run_w4a8(x, wp_mixed, s, bm, bn, bk):
    """W4A8 with a per-row int8 activation scale (:530)."""
    return prepare("w4a8", x, wp_mixed, s, bm, bn, bk)()


def run_timing_variant(kern: str, x, wp, s16, bm, bn, bk):
    """Timing only: kern "noscale" (:440) or "halfq8" (:460) (:478)."""
    if kern not in ("noscale", "halfq8"):
        raise ValueError(f"run_timing_variant: {kern!r}")
    return prepare(kern, x, wp, s16, bm, bn, bk)()


__all__ = ["KINDS", "PLANE_KINDS", "ProbeCall", "kernel_attrs", "kernel_bytes",
           "kernel_ref", "pack_int4_biased", "pack_int4_mixed",
           "pack_int4_native", "plane_geometry", "prepare", "run_andmask", "run_andmask_bf16s",
           "run_bitcast", "run_i4", "run_intdot", "run_split", "run_stream",
           "run_timing_variant", "run_w4a8", "unpack_int4_native"]
