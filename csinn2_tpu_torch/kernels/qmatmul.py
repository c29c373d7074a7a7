"""Fused dequant-GEMM: y = (x @ dequant(w_q)) · epilogue_scale + bias, with
the requantize/cast epilogue (counterpart of csinn2_tpu/kernels/qmatmul.py).

`quant_matmul` launches a hand-written CUDA kernel for CUDA tensors and runs
`quant_matmul_ref`, its plain PyTorch version, for CPU tensors.  Every mode
of the JAX function is ported:

  * scale_mode "block" (Q8_0, Q4_0: f32 [K/32, N] scales), "channel" ([N])
    or "none"; int8 values [K, N], nibble-packed int4 [K/2, N]
    (`pack_int4`), or with w_transposed the [N, K] / packed [N, K/2]
    "rearranged" layout (`pack_int4_t`; block scales [N, K/32]);
  * a float x (bf16 carrier; an int8 x is converted exactly) through
    csrc/qmatmul.cuh (built as csrc/qmatmul.cu for int8 values and
    csrc/qmatmul_int4.cu for packed int4), f32 accumulation;
  * an int8 x with int8 or packed [K, N] or int8 [N, K] weights and
    channel or no scales (JAX's int_dot path) through csrc/qmatmul_int8dot.cu:
    s8×s8 products summed exactly in int32 on the tensor cores (its decode
    kernel at M <= 16 on the float decode GEMM's skeleton, `int8dot_plan`
    mirrors its launch plan);
  * epilogues: channel scale, epilogue_scale, f32 bias, the swiglu pairs
    (float epilogue), and the output cast — f32/bf16, int8/uint8/int16 as
    clip(round(y) + out_zp), int32 as a plain cast; or, with rq_mult /
    rq_shift (int8 x and int8 weights, scale_mode "none"), an int32 bias
    added to the exact sum and the fixed-point requantize of
    kernels/requant.py.

Numerics: the plain version dequantizes and accumulates in f32.  On the
card every float-x kernel (the decode kernel at M <= 16, the prefill
kernels above) forms block-scaled weights as bf16(q)·bf16(s) rounded to
bf16, as the TPU kernel does, and accumulates in f32 on the tensor cores;
the decode kernel sums its K splits in split order in the same launch
(`gemm_plan` mirrors the launch plan, `workspace_floats` the workspace).
The float epilogue follows what the JAX kernel's compiled code computes
(XLA on the CPU): the last multiply before the bias add is one fused
multiply-add, fma(acc·s, e, b) or fma(acc, s, b); the plain version
emulates it in f64 (the product of two f32 is exact there) and rounds once.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import numpy as np
import torch

from csinn2_tpu_torch.core.quant import BLOCK_SIZE
from csinn2_tpu_torch.kernels import _build
from csinn2_tpu_torch.kernels.requant import requant_int

BLOCK = BLOCK_SIZE
SWIGLU_HALF = 128     # columns per half of a swiglu128 pair


# -- int4 nibble packing ------------------------------------------------------
# llama.cpp Q4_0 byte layout, byte-identical to the JAX package's: byte row
# b*16+j of the packed [K/2, N] array holds K-rows b*32+j (low nibble) and
# b*32+16+j (high nibble), two's complement.

def _to_byte(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    v = (lo.to(torch.int32) & 0xF) | ((hi.to(torch.int32) & 0xF) << 4)
    return v.to(torch.uint8).view(torch.int8)


def _sign4(n: torch.Tensor) -> torch.Tensor:
    """4-bit two's complement (values 0..15) → int8 in [-8, 7]."""
    return ((n ^ 8) - 8).to(torch.int8)


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """[K, N] int8 values in [-8, 7] → [K/2, N] packed bytes."""
    K = q.shape[0]
    if K % BLOCK:
        raise ValueError(f"pack_int4: K={K} is not a multiple of {BLOCK}")
    q3 = q.reshape(K // BLOCK, BLOCK, -1)
    return _to_byte(q3[:, :16], q3[:, 16:]).reshape(K // 2, -1)


def pack_int4_t(qt: torch.Tensor) -> torch.Tensor:
    """[N, K] int8 values in [-8, 7] → [N, K/2] packed bytes (the transposed
    layout; same per-32-block nibble grouping along K)."""
    N, K = qt.shape
    if K % BLOCK:
        raise ValueError(f"pack_int4_t: K={K} is not a multiple of {BLOCK}")
    q3 = qt.reshape(N, K // BLOCK, BLOCK)
    return _to_byte(q3[:, :, :16], q3[:, :, 16:]).reshape(N, K // 2)


def unpack_int4(packed: torch.Tensor, K: int) -> torch.Tensor:
    """[K/2, N] packed bytes → [K, N] int8 values in [-8, 7]."""
    p3 = packed.view(torch.uint8).to(torch.int32).reshape(K // BLOCK, 16, -1)
    return torch.cat([_sign4(p3 & 0xF), _sign4(p3 >> 4)], dim=1).reshape(K, -1)


def unpack_int4_t(packed: torch.Tensor, K: int) -> torch.Tensor:
    """[N, K/2] packed bytes → [N, K] int8 values in [-8, 7]."""
    N = packed.shape[0]
    p3 = packed.view(torch.uint8).to(torch.int32).reshape(N, K // BLOCK, 16)
    return torch.cat([_sign4(p3 & 0xF), _sign4(p3 >> 4)], dim=2).reshape(N, K)


def swiglu_pairs(h: torch.Tensor) -> torch.Tensor:
    """silu(h1)·h3 over 128-column pair-interleaved columns (swiglu128), in
    f32: [M, N] → [M, N/2]."""
    M, N = h.shape
    a = h.float().reshape(M, N // (2 * SWIGLU_HALF), 2, SWIGLU_HALF)
    return (torch.nn.functional.silu(a[:, :, 0]) * a[:, :, 1]).reshape(M, N // 2)


# -- arguments ------------------------------------------------------------------

# output dtype → (kind code of csrc/epilogue.cuh, (qmin, qmax) of the clip or None)
OUT_KINDS = {torch.float32: (0, None), torch.bfloat16: (1, None),
             torch.int8: (2, (-128, 127)), torch.uint8: (3, (0, 255)),
             torch.int16: (4, (-32768, 32767)), torch.int32: (5, None)}


def _check_args(x, scale_mode, out_dtype, packed_int4, w_transposed, swiglu,
                rq_mult, rq_shift, bias, w_dtype=torch.int8) -> bool:
    """The JAX wrapper's asserts as ValueError; returns int_dot (s8×s8 → s32:
    int8 x and int8 weights with channel or no scales, not packed [N, K/2])."""
    if scale_mode not in ("block", "channel", "none"):
        raise ValueError(f"quant_matmul: scale_mode {scale_mode!r}")
    if out_dtype not in OUT_KINDS:
        raise ValueError(f"quant_matmul: out_dtype {out_dtype} not supported")
    int_out = OUT_KINDS[out_dtype][1] is not None
    int_dot = (x.dtype == torch.int8 and w_dtype == torch.int8
               and scale_mode in ("channel", "none")
               and not (packed_int4 and w_transposed))
    if packed_int4 and w_transposed and bias is not None:
        raise ValueError("quant_matmul: bias not supported with packed-int4 split dots")
    if swiglu and int_out:
        raise ValueError("quant_matmul: the swiglu epilogue is float-only")
    if (rq_mult is None) != (rq_shift is None):
        raise ValueError("quant_matmul: rq_mult and rq_shift go together")
    if rq_mult is not None:
        if scale_mode != "none":
            raise ValueError("quant_matmul: fold scales into rq_mult/rq_shift "
                             "(scale_mode='none')")
        if not int_dot:
            raise ValueError("quant_matmul: rq_mult requires int8 x and unpacked int8 w")
        if not int_out:
            raise ValueError("quant_matmul: integer out_dtype required with rq_mult")
    return int_dot


def _weight_kn(w_q, K: int, packed_int4: bool, w_transposed: bool) -> torch.Tensor:
    """The int8 weight values as [K, N] (a view for int8 [N, K])."""
    if w_transposed:
        return (unpack_int4_t(w_q, K) if packed_int4 else w_q).t()
    return unpack_int4(w_q, K) if packed_int4 else w_q


def _fma_epilogue(acc: torch.Tensor, scales, scale_mode, epilogue_scale, bias):
    """acc [· s] [· e] [+ b] in f32 as the JAX kernel's compiled epilogue
    rounds it: with a bias, the last multiply and the add are one fused
    multiply-add (emulated in f64, rounded once)."""
    mults = ([scales.float()] if scale_mode == "channel" else []) \
        + ([epilogue_scale] if epilogue_scale is not None else [])
    if bias is None:
        for m in mults:
            acc = acc * m
        return acc
    for m in mults[:-1]:
        acc = acc * m
    if not mults:
        return acc + bias.float()
    last = mults[-1]
    last = last.double() if isinstance(last, torch.Tensor) else last
    return (acc.double() * last + bias.double()).float()


def quant_matmul_ref(x, w_q, scales=None, bias=None, *, scale_mode="channel",
                     out_dtype=torch.float32, epilogue_scale=None,
                     packed_int4: bool = False, w_transposed: bool = False,
                     out_zp: float = 0.0, swiglu: bool = False,
                     rq_mult=None, rq_shift=None):
    """Plain PyTorch version of the same contraction (CPU path and the CUDA
    kernels' yardstick).  A float x: f32, y = x @ (q · s repeated over 32-row
    K blocks) for block scales, x @ q for channel/none.  The int_dot modes:
    the exact integer sum (f64 products and sums, exact below 2^53), wrapped
    to int32 as the TPU's int32 accumulator; with rq_mult the int32 bias and
    requant_int; else converted to f32.  Then the epilogue (_fma_epilogue),
    the swiglu pairs, and the output cast."""
    int_dot = _check_args(x, scale_mode, out_dtype, packed_int4, w_transposed, swiglu,
                          rq_mult, rq_shift, bias, w_q.dtype)
    K = x.shape[-1]
    w = _weight_kn(w_q, K, packed_int4, w_transposed)
    N = w.shape[1]
    clip = OUT_KINDS[out_dtype][1]
    if int_dot:
        acc32 = (x.double() @ w.double()).long().to(torch.int32)
        if rq_mult is not None:
            if bias is not None:
                acc32 = acc32 + bias.to(torch.int32)
            return requant_int(acc32, rq_mult, rq_shift, int(out_zp),
                               clip[0], clip[1]).to(out_dtype)
        acc = acc32.float()
    else:
        x = x.float()
        if scale_mode == "block":
            s = (scales.t() if w_transposed else scales).float()
            w = (w.float().reshape(K // BLOCK, BLOCK, N) * s[:, None, :]).reshape(K, N)
        acc = x @ w.float()
    acc = _fma_epilogue(acc, scales, scale_mode, epilogue_scale, bias)
    if swiglu:
        acc = swiglu_pairs(acc)
    if clip is not None:
        acc = torch.clamp(torch.round(acc) + float(out_zp), clip[0], clip[1])
    return acc.to(out_dtype)


def launch_key(scale_mode: str, packed_int4: bool, swiglu: bool, *,
               w_transposed: bool = False, int_dot: bool = False,
               requant: bool = False) -> str:
    """The launch_counts name of a quant_matmul mode family (a suffix
    ".decode" for M <= 16 or ".prefill" marks the kernel variant)."""
    if requant:
        return "quant_matmul_requant"
    if int_dot:
        return "quant_matmul_int8dot"
    if w_transposed:
        return "quant_matmul_t"
    if swiglu:
        return "quant_matmul_swiglu"
    if scale_mode == "none":
        return "quant_matmul_none"
    if scale_mode == "block":
        return "quant_matmul_q4_0" if packed_int4 else "quant_matmul"
    return "quant_matmul_int4_channel" if packed_int4 else "quant_matmul_channel"


DECODE_MAX_M = 16     # csrc/qmatmul.cuh and qmatmul_int8dot.cu: the M <= 16 variants
SCALE_KINDS = {"block": 0, "channel": 1, "none": 2}

# csrc/qmatmul.cuh's prefill kernels (M > 16): CTA tile, k per stage, ring
# depth, and the cost model of their split plan
PF_BM, PF_BN, PF_SK, PF_STAGES = 128, 256, 64, 5
PF_BLOCK_COST, PF_MAX_SPLITS = 1260, 16
# its decode kernel (M <= 16): strip columns, resident CTAs an SM, x rows a
# stage holds, and a decode split's blocks (a multiple of DC_SPLIT_ALIGN)
DC_BN, DC_CTAS_PER_SM, DC_MT, DC_SPLIT_ALIGN = 256, 2, 16, 4
SMEM_LIMIT = 232448   # bytes of dynamic shared memory a CTA may have on sm_90
SM_SMEM = 233472      # bytes of shared memory an SM has (1024 reserved per CTA)
COUNTER_SLOTS = 4096  # decode strip counters a device buffer holds: N <= 2^20


def prefill_smem(packed_int4: bool) -> int:
    """Dynamic shared memory of the prefill kernels: PF_STAGES stages of the
    bf16 x tile, the raw weight tile and two blocks of f32 scales, and 1024
    bytes to align the ring for wgmma's 128-byte swizzle."""
    stage = PF_BM * PF_SK * 2 + PF_SK * PF_BN // (2 if packed_int4 else 1) \
        + (PF_SK // BLOCK) * PF_BN * 4
    return PF_STAGES * stage + 1024


def decode_stages(w_transposed: bool) -> int:
    """Ring slots of the decode kernel: 3 of 16 KB stages for [K, N], 2 of
    32 KB for [N, K]."""
    return 2 if w_transposed else 3


def decode_smem(packed_int4: bool, w_transposed: bool) -> int:
    """Dynamic shared memory of the decode kernel: its stages of raw weight
    bytes (64 per column of [K, N], 128 per row of [N, K]), their f32 block
    scales and DC_MT bf16 x rows."""
    row = 128 if w_transposed else 64
    sb = (2 if w_transposed else 1) * (4 if packed_int4 else 2)
    stage = row * DC_BN + sb * DC_BN * 4 + DC_MT * sb * BLOCK * 2
    return decode_stages(w_transposed) * stage


def gemm_plan(M: int, N: int, K: int, w_transposed: bool, n_sm: int) -> dict:
    """The launch plan of csrc/qmatmul.cuh plan_split_k, mirrored: kernel
    ("decode" and "t_decode", the [K, N] and [N, K] layouts of one kernel,
    or "prefill"), splits and 32-k blocks per split, the grid, and for the
    prefill kernel its tile and stages.  Decode (M <= 16): as many splits (of
    a multiple of DC_SPLIT_ALIGN blocks) as let the 256-column strips fill
    DC_CTAS_PER_SM CTAs an SM in one wave; one counter slot a strip.  Prefill: the split count (<= PF_MAX_SPLITS,
    a 64-k stage at least per split) that minimises waves of CTAs on the
    busiest SM × blocks per CTA, plus the partials' cost.  The plan does not
    depend on the weight layout."""
    nb = K // BLOCK
    if M > DECODE_MAX_M:
        tiles = -(-M // PF_BM) * -(-N // PF_BN)
        best = None
        for sp in range(1, max(1, min(PF_MAX_SPLITS, nb // 2)) + 1):
            bps = -(-nb // sp)
            if -(-nb // bps) != sp:
                continue
            waves = -(-(tiles * sp) // n_sm)
            cost = waves * bps * PF_BLOCK_COST + (8 * sp * M * N // 3000 if sp > 1 else 0)
            if best is None or cost < best[0]:
                best = (cost, sp, bps)
        return dict(kernel="prefill", splits=best[1], blocks_per_split=best[2],
                    tile=(PF_BM, PF_BN), stage_k=PF_SK, stages=PF_STAGES,
                    grid=(-(-M // PF_BM), -(-N // PF_BN), best[1]))
    strips = -(-N // DC_BN)
    want = max(1, min(nb, DC_CTAS_PER_SM * n_sm // strips))
    bps = -(-max(1, -(-nb // want)) // DC_SPLIT_ALIGN) * DC_SPLIT_ALIGN
    sp = max(1, -(-nb // bps))
    return dict(kernel="t_decode" if w_transposed else "decode", splits=sp,
                blocks_per_split=bps, strip=DC_BN, stages=decode_stages(w_transposed),
                grid=(strips, sp), counter_slots=strips)


# csrc/qmatmul_int8dot.cu's prefill kernel (M > 16): CTA tile rows, k per
# stage, and the cost model of its split plan
PI_BM, PI_SK, PI_BLOCK_COST, PI_MAX_SPLITS = 128, 128, 600, 16


def int8dot_plan(M: int, N: int, K: int, n_sm: int, counter_slots: int = None) -> dict:
    """The launch plan of csrc/qmatmul_int8dot.cu plan_i8, mirrored: kernel
    ("decode" at M <= 16, "prefill" above), splits, 32-k blocks per split
    (K rounded up to 32), the grid and the int32 workspace [splits, M, N]
    (0 without a split).  Decode: the float decode GEMM's plan over ceil(K /
    32) blocks.  Prefill: the split count (whole 128-k stages, <=
    PI_MAX_SPLITS) minimising waves of one-CTA-an-SM 128 × 256 tiles ×
    blocks a split plus the partials' cost; none when the tiles outnumber
    the counter slots."""
    slots = COUNTER_SLOTS if counter_slots is None else counter_slots
    nb = -(-K // BLOCK)
    strips = -(-N // DC_BN)
    if M <= DECODE_MAX_M:
        plan = gemm_plan(M, N, nb * BLOCK, False, n_sm)
        sp, bps = plan["splits"], plan["blocks_per_split"]
        grid = (strips, sp)
    else:
        tiles = -(-M // PI_BM) * strips
        sp, bps, best = 1, nb, None
        if tiles <= slots:
            align = PI_SK // BLOCK
            for s in range(1, max(1, min(PI_MAX_SPLITS, nb // align)) + 1):
                b = -(-(-(-nb // s)) // align) * align
                if -(-nb // b) != s:
                    continue
                cost = -(-(tiles * s) // n_sm) * b * PI_BLOCK_COST \
                    + (8 * s * M * N // 1000 if s > 1 else 0)
                if best is None or cost < best:
                    best, sp, bps = cost, s, b
        grid = (strips, sp, -(-M // PI_BM))
    return dict(kernel="decode" if M <= DECODE_MAX_M else "prefill", splits=sp,
                blocks_per_split=bps, grid=grid, workspace=sp * M * N if sp > 1 else 0)


def kernel_int8dot_plan(M: int, N: int, K: int, device: int) -> dict:
    """The same plan from the CUDA library (quant_matmul_int8dot_plan): the
    card checks the mirror against it."""
    fn = _build.c_function("qmatmul_int8dot", "quant_matmul_int8dot_plan",
                           (ctypes.c_int,) * 5 + (ctypes.POINTER(ctypes.c_int),) * 3,
                           restype=ctypes.c_longlong)
    sp, bps, err = ctypes.c_int(0), ctypes.c_int(0), ctypes.c_int(0)
    n = fn(M, N, K, device, COUNTER_SLOTS, ctypes.byref(sp), ctypes.byref(bps),
           ctypes.byref(err))
    _build.check("qmatmul_int8dot", err.value, "quant_matmul_int8dot plan")
    return dict(splits=sp.value, blocks_per_split=bps.value, workspace=n)


def workspace_floats(M: int, N: int, K: int, swiglu: bool, reduce_epi: bool,
                     n_sm: int) -> int:
    """f32 workspace the float-x kernels need (csrc/qmatmul.cuh
    workspace_floats, mirrored): the [splits, M, N] partial sums when K is
    split or the swiglu epilogue pairs columns, and at prefill also when the
    epilogue goes through qmm_reduce (the decode kernel applies every
    epilogue itself); else 0."""
    sp = gemm_plan(M, N, K, False, n_sm)["splits"]      # the same for both layouts
    need = sp > 1 or swiglu or (M > DECODE_MAX_M and reduce_epi)
    return sp * M * N if need else 0


def kernel_workspace_floats(M: int, N: int, K: int, swiglu: bool, reduce_epi: bool,
                            device: int) -> int:
    """The same number from the CUDA library (quant_matmul_workspace): the
    card checks the mirror against it."""
    fn = _build.c_function("qmatmul", "quant_matmul_workspace",
                           (ctypes.c_int,) * 6 + (ctypes.POINTER(ctypes.c_int),),
                           restype=ctypes.c_longlong)
    err = ctypes.c_int(0)
    n = fn(M, N, K, int(swiglu), int(reduce_epi), device, ctypes.byref(err))
    _build.check("qmatmul", err.value, "quant_matmul workspace")
    return n


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _device_index(x) -> int:
    return x.device.index if x.device.index is not None else torch.cuda.current_device()


# (device index, stream) → the decode kernel's strip counters: int32
# [COUNTER_SLOTS], zeroed once, left at zero by every launch (its last CTA of
# a strip resets the strip's count), so a launch needs no host work besides
# itself; one buffer a stream, since concurrent launches may not share one.
_counters: dict = {}


def strip_counters(device: torch.device, stream) -> torch.Tensor:
    index = device.index if device.index is not None else torch.cuda.current_device()
    key = (index, stream.cuda_stream)
    buf = _counters.get(key)
    if buf is None:
        buf = _counters[key] = torch.zeros((COUNTER_SLOTS,), dtype=torch.int32,
                                           device=torch.device("cuda", index))
    return buf


def _ptr(t):
    return None if t is None else t.data_ptr()


_VP, _CI, _CF = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C signatures of csrc/qmatmul.cu quant_matmul_int8 (and _int4), of their
# decode ring alone (quant_matmul_int8_ring, _int4_ring) and of
# csrc/qmatmul_int8dot.cu quant_matmul_int8dot
_FLOAT_ARGTYPES = (_VP,) * 5 + (_CI,) * 4 + (_CF, _CI, _CF, _VP, ctypes.c_longlong, _VP) \
    + (_CI,) * 5 + (_VP,)
_RING_ARGTYPES = (_VP,) * 3 + (_CI,) * 4 + (_VP,)
_INT8DOT_ARGTYPES = (_VP, _VP, _CI, _VP, _VP, _CI, _VP, _VP, _CI, _CI, _VP, _CI, _CF, _CI,
                     _CF, _CI, _VP, ctypes.c_longlong, _VP) + (_CI,) * 5 + (_VP,)


def _check_tensors(tensors, dtypes):
    dev = tensors[0].device
    for t, dt in zip(tensors, dtypes):
        if t is None:
            continue
        if t.device != dev:
            raise ValueError("quant_matmul: all tensors must be on one device")
        if t.dtype != dt:
            raise TypeError(f"quant_matmul: want {dt}, got {t.dtype} "
                            f"(shape {tuple(t.shape)})")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("quant_matmul: tensors must be contiguous and 16-byte aligned")


def quant_matmul(x, w_q, scales=None, bias=None, *, scale_mode: str = "channel",
                 out_dtype=torch.float32, epilogue_scale: Optional[float] = None,
                 packed_int4: bool = False, w_transposed: bool = False,
                 out_zp: float = 0.0, swiglu: bool = False, rq_mult=None, rq_shift=None):
    """y[M, N] = (x[M, K] @ dequant(w_q, scales)) · epilogue_scale + bias[N],
    cast to out_dtype (integers: clip(round(y) + out_zp)); with swiglu the
    pairs of the swiglu128 layout give y[M, N/2]; with rq_mult/rq_shift
    ([N] or scalars, int32) the fixed-point requantize of acc + bias.

    w_q: int8 [K, N]; packed int4 [K/2, N] with packed_int4; with
    w_transposed int8 [N, K] or packed [N, K/2].  scales: f32 [K/32, N]
    (block; [N, K/32] transposed), [N] (channel) or None (none).
    CUDA tensors, all contiguous and 16-byte aligned:
      * float path: x bf16 (or int8, converted), scales/bias f32;
        K % 32 == 0, N % 16 == 0 (swiglu: N % 256 == 0).
      * int_dot path (x int8, w int8 and not packed [N, K/2], channel or
        none scales): bias f32, or int32 with rq_mult; K % 16 == 0 (packed:
        % 32), N % 16 == 0 (swiglu: N % 256 == 0).
    CPU tensors (and meta tensors, whose shapes a recording graph infers):
    quant_matmul_ref."""
    int_dot = _check_args(x, scale_mode, out_dtype, packed_int4, w_transposed, swiglu,
                          rq_mult, rq_shift, bias, w_q.dtype)
    kw = dict(scale_mode=scale_mode, out_dtype=out_dtype, epilogue_scale=epilogue_scale,
              packed_int4=packed_int4, w_transposed=w_transposed, out_zp=out_zp,
              swiglu=swiglu, rq_mult=rq_mult, rq_shift=rq_shift)
    if x.device.type in ("cpu", "meta"):      # meta: shapes while a graph records
        return quant_matmul_ref(x, w_q, scales, bias, **kw)
    if x.device.type != "cuda":
        raise ValueError(f"quant_matmul: unsupported device {x.device}")
    M, K = x.shape
    if w_transposed:
        N = w_q.shape[0]
        w_shape = (N, K // 2) if packed_int4 else (N, K)
    else:
        N = w_q.shape[1]
        w_shape = (K // 2, N) if packed_int4 else (K, N)
    s_shape = {"block": (N, K // BLOCK) if w_transposed else (K // BLOCK, N),
               "channel": (N,), "none": None}[scale_mode]
    bad = (tuple(w_q.shape) != w_shape or N % 16
           or (None if scales is None else tuple(scales.shape)) != s_shape
           or (bias is not None and tuple(bias.shape) != (N,))
           or (swiglu and N % (2 * SWIGLU_HALF)))
    if int_dot:
        bad = bad or K % (BLOCK if packed_int4 else 16)
    else:
        bad = bad or K % BLOCK
    if bad:
        raise ValueError(f"quant_matmul: bad shapes x{tuple(x.shape)} w{tuple(w_q.shape)} "
                         f"s{None if scales is None else tuple(scales.shape)} (scale_mode="
                         f"{scale_mode!r}, packed_int4={packed_int4}, w_transposed="
                         f"{w_transposed}, swiglu={swiglu}; need N % 16 == 0, K % 32 == 0 "
                         "(int8 x with int8 w: K % 16), swiglu N % 256 == 0)")
    out = torch.empty((M, N // 2 if swiglu else N), dtype=out_dtype, device=x.device)
    if M == 0:
        return out
    variant = "decode" if M <= DECODE_MAX_M else "prefill"
    if int_dot:
        _launch_int8dot(x, w_q, scales, bias, out, M, N, K, **kw)
        key = launch_key(scale_mode, packed_int4, swiglu, int_dot=True,
                         requant=rq_mult is not None)
    else:
        if x.dtype == torch.int8:
            x = x.to(torch.bfloat16)            # exact carrier
        _launch_float(x, w_q, scales, bias, out, M, N, K, **kw)
        key = launch_key(scale_mode, packed_int4, swiglu, w_transposed=w_transposed)
    _build.launch_counts[f"{key}.{variant}"] += 1
    return out


def _launch_float(x, w_q, scales, bias, out, M, N, K, *, scale_mode, out_dtype,
                  epilogue_scale, packed_int4, w_transposed, out_zp, swiglu, **_):
    _check_tensors([x, w_q, scales, bias],
                   [torch.bfloat16, torch.int8, torch.float32, torch.float32])
    kind = OUT_KINDS[out_dtype][0]
    device = _device_index(x)
    stream = torch.cuda.current_stream(x.device)
    # as csrc/qmatmul.cuh run(): prefill epilogues past one rounding go through the reduce
    reduce_epi = (not out_dtype.is_floating_point or epilogue_scale is not None
                  or (scale_mode == "channel" and bias is not None))
    n_ws = workspace_floats(M, N, K, swiglu, reduce_epi, _sm_count(device))
    workspace = (torch.empty((n_ws,), dtype=torch.float32, device=x.device)
                 if n_ws else None)
    counters = strip_counters(x.device, stream) if M <= DECODE_MAX_M else None
    lib, entry = ("qmatmul_int4", "quant_matmul_int4") if packed_int4 \
        else ("qmatmul", "quant_matmul_int8")
    fn = _build.c_function(lib, entry, _FLOAT_ARGTYPES)
    err = fn(x.data_ptr(), w_q.data_ptr(), _ptr(scales), _ptr(bias), out.data_ptr(),
             kind, SCALE_KINDS[scale_mode], int(swiglu), int(w_transposed),
             float(epilogue_scale if epilogue_scale is not None else 1.0),
             int(epilogue_scale is not None), float(out_zp),
             _ptr(workspace), n_ws, _ptr(counters), COUNTER_SLOTS, M, N, K, device,
             stream.cuda_stream)
    _build.check(lib, err, "quant_matmul")


def reduce_launches() -> int:
    """qmm_reduce launches so far, as both float-x libraries count them (the
    prefill kernels' second launch; the decode kernel launches none)."""
    return sum(_build.c_function(lib, f"quant_matmul_{name}_reduce_launches", (),
                                 restype=ctypes.c_longlong)()
               for lib, name in (("qmatmul", "int8"), ("qmatmul_int4", "int4")))


def decode_ring_stream(x, w_q, scales, packed_int4: bool) -> None:
    """The decode kernel's cp.async ring alone over a block-scaled [K, N]
    int8 or [K/2, N] packed weight, its scales and x (M <= 8): the same
    plan and loads, no math, nothing written.  A timing aid (the copy rate
    the kernel's loads reach), not counted in launch_counts."""
    M, K = x.shape
    N = w_q.shape[1]
    if not (x.is_cuda and 1 <= M <= 8 and K % BLOCK == 0 and N % 16 == 0
            and tuple(w_q.shape) == ((K // 2, N) if packed_int4 else (K, N))
            and tuple(scales.shape) == (K // BLOCK, N)):
        raise ValueError("decode_ring_stream: a CUDA x [M <= 8, K] and a block-scaled "
                         "[K, N] / [K/2, N] weight")
    _check_tensors([x, w_q, scales], [torch.bfloat16, torch.int8, torch.float32])
    lib, entry = ("qmatmul_int4", "quant_matmul_int4_ring") if packed_int4 \
        else ("qmatmul", "quant_matmul_int8_ring")
    fn = _build.c_function(lib, entry, _RING_ARGTYPES)
    err = fn(x.data_ptr(), w_q.data_ptr(), scales.data_ptr(), M, N, K, _device_index(x),
             torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, err, "decode_ring_stream")


# weight layouts of csrc/qmatmul_int8dot.cu
W_KN, W_NK, W_PACKED_KN = 0, 1, 2


def _launch_int8dot(x, w_q, scales, bias, out, M, N, K, *, scale_mode, out_dtype,
                    epilogue_scale, packed_int4, w_transposed, out_zp, swiglu, rq_mult,
                    rq_shift):
    requant = rq_mult is not None

    def per_channel(v):
        """(int32 [N] on the card or None, the scalar when None): a scalar
        rides by value; a per-channel array is used as it lies when it is
        already an int32 [N] on the card (a host copy per call would wait
        for the queue)."""
        if not isinstance(v, torch.Tensor) and np.ndim(v) == 0:
            return None, int(v)
        t = torch.as_tensor(v).to(device=x.device, dtype=torch.int32).reshape(-1)
        return t.expand(N).contiguous(), 0
    mult, mult_s = per_channel(rq_mult) if requant else (None, 0)
    shift, shift_s = per_channel(rq_shift) if requant else (None, 0)
    _check_tensors([x, w_q, scales, bias, mult, shift],
                   [torch.int8, torch.int8, torch.float32,
                    torch.int32 if requant else torch.float32, torch.int32, torch.int32])
    layout = W_NK if w_transposed else (W_PACKED_KN if packed_int4 else W_KN)
    device = _device_index(x)
    stream = torch.cuda.current_stream(x.device)
    n_ws = int8dot_plan(M, N, K, _sm_count(device))["workspace"]
    workspace = torch.empty((n_ws,), dtype=torch.int32, device=x.device) if n_ws else None
    fn = _build.c_function("qmatmul_int8dot", "quant_matmul_int8dot", _INT8DOT_ARGTYPES)
    err = fn(x.data_ptr(), w_q.data_ptr(), layout, _ptr(scales), _ptr(bias), int(requant),
             _ptr(mult), _ptr(shift), mult_s, shift_s, out.data_ptr(), OUT_KINDS[out_dtype][0],
             float(epilogue_scale if epilogue_scale is not None else 1.0),
             int(epilogue_scale is not None), float(out_zp), int(swiglu), _ptr(workspace),
             n_ws, strip_counters(x.device, stream).data_ptr(), COUNTER_SLOTS, M, N, K,
             device, stream.cuda_stream)
    _build.check("qmatmul_int8dot", err, "quant_matmul (int8 x)")
