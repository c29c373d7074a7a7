"""Fused depthwise-separable block: depthwise k×k → requantize → pointwise
1×1 → requantize, int8 in → int8 out (counterpart of
csinn2_tpu/kernels/dsblock.py).

`fused_dsconv` launches the hand-written CUDA kernel (csrc/dsblock.cu) for
CUDA tensors and runs `fused_dsconv_ref`, its plain PyTorch version, for CPU
tensors.  `ds_block_xla` is the unfused composition (the two qconv paths,
named as in the JAX package, where XLA runs it); `ds_block_cb` is the
"ds_block" op callback that graph/fuse.py puts in the graph: CUDA tensors go
to the kernel, CPU tensors to the composition.  The composition is never a
retry after a failed build or launch.

Semantics (equal bit for bit to the unfused pair, kernels/qconv.py):

  mid = clip(round(act(dwacc·effd[c] + bd[c]) · (1/s_mid)), -128, 127)
  out = clip(round(act(pwacc·effp[o] + bp[o]) · (1/s_out)) + zo, -128, 127)

with dwacc and pwacc exact integer sums (activation zp = 0, so zero padding
is exact), acc·eff + b rounded once to f32 and 1/s the f32 reciprocal (see
kernels/qconv.py).  Without out_scale the output is the f32 `act(...)`.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from csinn2_tpu_torch.core.dtypes import Api, Dtype, Layout
from csinn2_tpu_torch.core.quant import QuantInfo
from csinn2_tpu_torch.core.tensor import TensorMeta
from csinn2_tpu_torch.kernels import _build
from csinn2_tpu_torch.kernels.qconv import (_conv2d_quant, _depthwise_quant, check_exact,
                                            mul_add, static_scalar)
from csinn2_tpu_torch.ops.params import Conv2dParams
from csinn2_tpu_torch.ops.registry import registry

# csrc/dsblock.cu: output channels of a pointwise tile, the weight ring's
# slots, the largest pointwise k chunk; a CTA's dynamic shared memory limit,
# an SM's shared memory and the part of it reserved per CTA
OT, STAGES, KC_MAX = 64, 3, 128
SMEM_LIMIT, SM_SMEM, CTA_RESERVED = 232448, 233472, 1024


def out_hw(H: int, W: int, k: int, stride: int, pads) -> Tuple[int, int]:
    pt, pd, pl, pr = pads
    return (H + pt + pd - k) // stride + 1, (W + pl + pr - k) // stride + 1


def _act(y: torch.Tensor, relu: bool, relu6: bool) -> torch.Tensor:
    if relu6:
        return torch.clamp(y, 0.0, 6.0)
    if relu:
        return torch.clamp_min(y, 0.0)
    return y


def _inv(scale: float) -> float:
    """f32 reciprocal of a scale, computed in f32."""
    return float(np.float32(1.0) / np.float32(scale))


def _check_args(x, dw_w, effd, bd, pw_w, effp, bp, k, stride, pads, out_scale, out_dtype):
    if k not in (3, 5) or stride not in (1, 2):
        raise ValueError(f"fused_dsconv: k={k}, stride={stride} (want k in (3, 5), "
                         "stride in (1, 2))")
    if len(pads) != 4 or any(not 0 <= p <= k // 2 for p in pads):
        raise ValueError(f"fused_dsconv: pads {pads} (each in 0..{k // 2})")
    if x.dim() != 4:
        raise ValueError(f"fused_dsconv: x must be [N, H, W, C], got {tuple(x.shape)}")
    N, H, W, C = x.shape
    O = pw_w.shape[-1]
    if tuple(dw_w.shape) != (k * k, C) or pw_w.dim() != 2 or pw_w.shape[0] != C \
            or tuple(effd.shape) != (C,) or tuple(bd.shape) != (C,) \
            or tuple(effp.shape) != (O,) or tuple(bp.shape) != (O,):
        raise ValueError(f"fused_dsconv: bad shapes x{tuple(x.shape)} dw{tuple(dw_w.shape)} "
                         f"pw{tuple(pw_w.shape)} effd{tuple(effd.shape)} bd{tuple(bd.shape)} "
                         f"effp{tuple(effp.shape)} bp{tuple(bp.shape)}")
    if x.dtype != torch.int8 or dw_w.dtype != torch.int8 or pw_w.dtype != torch.int8 \
            or any(t.dtype != torch.float32 for t in (effd, bd, effp, bp)):
        raise TypeError("fused_dsconv: want x, dw_w, pw_w int8 and effd, bd, effp, bp f32")
    if out_scale is None and out_dtype != torch.float32:
        raise TypeError(f"fused_dsconv: out_dtype {out_dtype} without out_scale (want f32)")
    if out_scale is not None and out_dtype != torch.int8:
        raise TypeError(f"fused_dsconv: out_dtype {out_dtype} (want int8)")
    if min(out_hw(H, W, k, stride, pads)) <= 0:
        raise ValueError(f"fused_dsconv: empty output for H={H} W={W} k={k} pads={pads}")
    check_exact(C, "fused_dsconv")


def fused_dsconv_ref(x, dw_w, effd, bd, pw_w, effp, bp, *, k: int, stride: int,
                     pads: Tuple[int, int, int, int], mid_scale: float,
                     mid_relu: bool, mid_relu6: bool, out_relu: bool,
                     out_relu6: bool, out_scale: Optional[float], out_zp: float = 0.0,
                     out_dtype=torch.int8):
    """Plain PyTorch version of `fused_dsconv` (the CPU path, and the CUDA
    kernel's yardstick on the card): int32 depthwise taps, the mid epilogue,
    the pointwise sum as an exact f32 matmul, the out epilogue."""
    _check_args(x, dw_w, effd, bd, pw_w, effp, bp, k, stride, pads, out_scale, out_dtype)
    N, H, W, C = x.shape
    O = pw_w.shape[1]
    pt, pd, pl, pr = pads
    Ho, Wo = out_hw(H, W, k, stride, pads)
    xp = F.pad(x.to(torch.int32), (0, 0, pl, pr, pt, pd))
    taps = dw_w.to(torch.int32)
    acc = torch.zeros((N, Ho, Wo, C), dtype=torch.int32, device=x.device)
    for dy in range(k):
        for dx in range(k):
            acc += xp[:, dy:dy + (Ho - 1) * stride + 1:stride,
                      dx:dx + (Wo - 1) * stride + 1:stride] * taps[dy * k + dx]
    y = _act(mul_add(acc.float(), effd, bd), mid_relu, mid_relu6)
    mid = torch.clamp(torch.round(y * _inv(mid_scale)), -128.0, 127.0)
    accp = (mid.reshape(-1, C) @ pw_w.float()).reshape(N, Ho, Wo, O)
    y2 = _act(mul_add(accp, effp, bp), out_relu, out_relu6)
    if out_scale is None:
        return y2
    q = torch.clamp(torch.round(y2 * _inv(out_scale)) + float(np.float32(out_zp)),
                    -128.0, 127.0)
    return q.to(torch.int8)


def smem_bytes(P: int, C: int, W: int, ck: int, halo_rows: int, kc: int, k: int) -> int:
    """A CTA's dynamic shared memory (csrc/dsblock.cu layout_of, mirrored):
    the mid tile [P][C padded to 32, + 16], the weight ring, the out tile,
    the halo rows of a CK-channel chunk, its depthwise weights and the
    pixels' tap origins, each 16-byte aligned."""
    cp = -(-C // 32) * 32
    up16 = lambda n: -(-n // 16) * 16
    return (P * (cp + 16) + STAGES * OT * (kc + 16) + P * (OT + 16)
            + up16(halo_rows * W * ck) + up16(k * k * ck) + P * 16)


def ds_plan(N: int, H: int, W: int, C: int, O: int, k: int, stride: int, pads,
            n_sm: int) -> dict:
    """The launch plan of csrc/dsblock.cu: P, the output pixels of a CTA (128,
    or 64 where 128-pixel tiles would not fill the SMs once or C >= 512,
    whose 128-pixel mid tile leaves the halo a few narrow chunks); the halo rows a
    P-pixel tile may need (D output rows past its first, each at most
    max(stride, J) input rows on, J the step across an image boundary, plus
    k); the pointwise k chunk; the widest depthwise channel chunk CK (a power
    of two, a multiple of 16 when C is) that keeps two CTAs an SM, else one;
    and o_chunk, the output channels of a CTA: all of O, split into OT
    multiples while the grid stays within two CTAs an SM (each chunk
    recomputes the depthwise tile)."""
    Ho, Wo = out_hw(H, W, k, stride, pads)
    NP = N * Ho * Wo
    P = 128 if -(-NP // 128) >= n_sm and C < 512 else 64
    cp = -(-C // 32) * 32
    kc = min(cp, KC_MAX)
    span = (P + Wo - 2) // Wo
    halo_rows = min(span * max(stride, H - (Ho - 1) * stride) + k, N * H)
    ck_min = 16 if C % 16 == 0 else 4
    ck_max = max(ck_min, 1 << (-(-C // 4) * 4 - 1).bit_length())
    for limit in (SM_SMEM // 2 - CTA_RESERVED, SMEM_LIMIT):
        ck = ck_max
        while ck >= ck_min and smem_bytes(P, C, W, ck, halo_rows, kc, k) > limit:
            ck //= 2
        if ck >= ck_min:
            break
    else:
        raise ValueError(f"fused_dsconv: a {P}-pixel tile of W={W}, C={C} does not fit "
                         "shared memory")
    tiles = -(-NP // P)
    o_tiles = -(-O // OT)
    o_chunk = -(-o_tiles // min(o_tiles, max(1, 2 * n_sm // tiles))) * OT
    return dict(P=P, o_chunk=o_chunk, ck=ck, halo_rows=halo_rows, kc=kc,
                smem=smem_bytes(P, C, W, ck, halo_rows, kc, k), grid=(tiles, -(-O // o_chunk)))


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _weight_oc(pw_w: torch.Tensor) -> torch.Tensor:
    """The pointwise weight as the kernel takes it, [O, C] contiguous: the
    storage of a transposed view of a contiguous [O, C] as it is, a
    contiguous [C, O] transposed into a copy."""
    oc = pw_w.t()
    return oc if oc.is_contiguous() else oc.contiguous()


def fused_dsconv(x, dw_w, effd, bd, pw_w, effp, bp, *, k: int, stride: int,
                 pads: Tuple[int, int, int, int], mid_scale: float,
                 mid_relu: bool, mid_relu6: bool, out_relu: bool,
                 out_relu6: bool, out_scale: Optional[float], out_zp: float = 0.0,
                 out_dtype=torch.int8):
    """x [N,H,W,C] int8 NHWC; dw_w [k*k, C] int8; pw_w [C, O] int8 (a
    contiguous [C, O], or the transposed view of a contiguous [O, C], the
    graph weight's own layout, which the kernel reads without a copy);
    effd/bd [C] f32 (sx·sw_dw, dw bias); effp/bp [O] f32 (s_mid·sw_pw, pw
    bias); returns [N, Ho, Wo, O] int8, or f32 when out_scale is None.

    CUDA tensors (contiguous but pw_w, on one device) launch
    csrc/dsblock.cu with ds_plan's geometry; CPU tensors run
    fused_dsconv_ref.  k in (3, 5), stride in (1, 2), each pad in 0..k//2,
    C <= 1024."""
    _check_args(x, dw_w, effd, bd, pw_w, effp, bp, k, stride, pads, out_scale, out_dtype)
    kw = dict(k=k, stride=stride, pads=tuple(pads), mid_scale=mid_scale, mid_relu=mid_relu,
              mid_relu6=mid_relu6, out_relu=out_relu, out_relu6=out_relu6,
              out_scale=out_scale, out_zp=out_zp, out_dtype=out_dtype)
    if x.device.type == "cpu":
        return fused_dsconv_ref(x, dw_w, effd, bd, pw_w, effp, bp, **kw)
    if x.device.type != "cuda":
        raise ValueError(f"fused_dsconv: unsupported device {x.device}")
    if any(t.device != x.device for t in (dw_w, effd, bd, pw_w, effp, bp)):
        raise ValueError("fused_dsconv: all tensors must be on one device")
    if not all(t.is_contiguous() for t in (x, dw_w, effd, bd, effp, bp)) \
            or not (pw_w.is_contiguous() or pw_w.t().is_contiguous()):
        raise ValueError("fused_dsconv: tensors must be contiguous (pw_w: [C, O] or the "
                         "transposed view of a contiguous [O, C])")
    N, H, W, C = x.shape
    O = pw_w.shape[1]
    Ho, Wo = out_hw(H, W, k, stride, pads)
    out = torch.empty((N, Ho, Wo, O), dtype=out_dtype, device=x.device)
    if out.numel() == 0:
        return out
    index = x.device.index if x.device.index is not None else torch.cuda.current_device()
    plan = ds_plan(N, H, W, C, O, k, stride, pads, _sm_count(index))
    tensors = (x, dw_w, effd, bd, _weight_oc(pw_w), effp, bp)
    fn = _build.c_function("dsblock", "fused_dsconv_int8",
                           (ctypes.c_void_p,) * 8 + (ctypes.c_int,) * 11
                           + (ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                              ctypes.c_float, ctypes.c_float) + (ctypes.c_int,) * 5
                           + (ctypes.c_void_p,))
    act = lambda relu, relu6: 2 if relu6 else (1 if relu else 0)
    err = fn(*(t.data_ptr() for t in tensors), out.data_ptr(), N, H, W, C, O, Ho, Wo, k,
             stride, pads[0], pads[2], _inv(mid_scale), act(mid_relu, mid_relu6),
             act(out_relu, out_relu6), int(out_scale is not None),
             _inv(out_scale) if out_scale is not None else 0.0, float(np.float32(out_zp)),
             plan["P"], plan["o_chunk"], plan["ck"], plan["halo_rows"], plan["kc"],
             torch.cuda.current_stream(x.device).cuda_stream)
    _build.check("dsblock", err, "fused_dsconv")
    _build.launch_counts["fused_dsconv"] += 1
    return out


# --- op callback + registration ---------------------------------------------

@functools.lru_cache(maxsize=256)
def _mid_qinfo(mid_scale: float, scheme) -> QuantInfo:
    """One QuantInfo per mid scale, so its device tensors are made once."""
    return QuantInfo(scale=mid_scale, zero_point=0, dtype=Dtype.INT8, scheme=scheme)


def ds_block_xla(arrays, metas, params, out_qinfo, *, k, mid_scale, mid_relu,
                 mid_relu6, pw_relu, pw_relu6):
    """The unfused composition: the two qconv paths, depthwise then
    pointwise, exactly as the unfused graph runs them (named after the JAX
    package's XLA fallback).  The CPU path of ds_block_cb."""
    x, w1, b1, w2, b2 = arrays
    xm, w1m, b1m, w2m, b2m = metas
    mid_qi = _mid_qinfo(mid_scale, xm.qinfo.scheme)
    dw_params = dataclasses.replace(params, fuse_relu=mid_relu, fuse_relu6=mid_relu6)
    mid = _depthwise_quant([x, w1, b1], [xm, w1m, b1m], dw_params, mid_qi)
    mid_meta = TensorMeta(shape=tuple(mid.shape), dtype=Dtype.INT8,
                          layout=Layout.NHWC, qinfo=mid_qi)
    pw_params = Conv2dParams(stride=(1, 1), pad=(0, 0, 0, 0), group=1,
                             layout=Layout.NHWC, fuse_relu=pw_relu,
                             fuse_relu6=pw_relu6)
    return _conv2d_quant([mid, w2, b2], [mid_meta, w2m, b2m], pw_params, out_qinfo)


def fused_args(arrays, metas, params, out_qinfo, *, k, mid_scale, mid_relu,
               mid_relu6, pw_relu, pw_relu6):
    """The (args, kwargs) of the fused_dsconv call that ds_block_cb makes for
    these op arguments, or None where the JAX package also takes the
    composition (a non-static input or output scale)."""
    x, w1, b1, w2, b2 = arrays
    xm, w1m, w2m = metas[0], metas[1], metas[3]
    if static_scalar(xm.qinfo.scale) is None:
        return None
    if out_qinfo is None or out_qinfo.dtype.is_float:
        out_scale, out_zp = None, 0.0
        out_dtype = torch.float32 if out_qinfo is None else out_qinfo.dtype.torch
    else:
        out_scale = static_scalar(out_qinfo.scale)
        out_zp = static_scalar(out_qinfo.zero_point)
        if out_scale is None or out_zp is None:
            return None
        out_dtype = out_qinfo.dtype.torch
    C = x.shape[-1]
    O = w2.shape[0]
    dev = x.device
    # the same f32 products as the unfused pair's eff = sx·sw (qconv)
    sx = xm.qinfo.tensors(dev)[0]
    effd = (sx * w1m.qinfo.tensors(dev)[0]).expand(C).contiguous()
    effp = (w2m.qinfo.tensors(dev)[0] * float(np.float32(mid_scale))).expand(O).contiguous()
    dw_w = w1.reshape(C, k * k).t().contiguous()          # [k*k, C]
    pw_w = w2.reshape(O, C).t()                           # [C, O], a view of [O, C]
    bd = b1.float().contiguous() if b1 is not None else torch.zeros(C, device=dev)
    bp = b2.float().contiguous() if b2 is not None else torch.zeros(O, device=dev)
    args = (x.contiguous(), dw_w, effd, bd, pw_w, effp, bp)
    kw = dict(k=k, stride=int(params.stride[0]), pads=tuple(params.pad),
              mid_scale=mid_scale, mid_relu=mid_relu, mid_relu6=mid_relu6,
              out_relu=pw_relu, out_relu6=pw_relu6, out_scale=out_scale,
              out_zp=out_zp, out_dtype=out_dtype)
    return args, kw


def ds_block_cb(arrays, metas, params, out_qinfo, **extra):
    """Fused depthwise-separable block (op "ds_block").

    arrays = [x, dw_w [C,1,k,k], dw_b, pw_w [O,C,1,1], pw_b] (int8 carriers
    + f32 biases); extra = k, mid_scale and the four activation flags.
    graph/fuse.py guarantees the structural preconditions.  CUDA tensors
    launch fused_dsconv; CPU tensors, and a non-static input or output
    scale (as in the JAX package), take ds_block_xla."""
    call = fused_args(arrays, metas, params, out_qinfo, **extra) \
        if arrays[0].device.type == "cuda" else None
    if call is None:
        return ds_block_xla(arrays, metas, params, out_qinfo, **extra)
    args, kw = call
    return fused_dsconv(*args, **kw)


registry.register("ds_block", ds_block_cb, api=Api.TORCH, quant_direct=True)
