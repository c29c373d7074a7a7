"""Quantized conv2d / fc over integer carriers (counterpart of
csinn2_tpu/kernels/qconv.py, which holds no Pallas kernel: its convolutions
are XLA's, and here they are plain PyTorch ops).

Ported branches: the symmetric integer path of `_conv2d_quant` (int8 x and
w, activation zero-point 0: exact s8×s8 accumulation, then the symmetric
epilogue ·eff + bias → relu/relu6 → requantize) and of `_depthwise_quant`,
and both branches of `_fc_quant` (integer dot, and the float carrier that
MobileNetV1's fc takes: x rounded to bf16, int8 w, f32 accumulation).  The
u8 carriers, nonzero zero-points (the zp-weight-sum fold), the float-carrier
conv, int16 carriers and the folded asymmetric-output epilogue raise
NotImplementedError (ROADMAP queue A item 10).

Exactness: PyTorch has no int8 convolution, so the integer accumulation is
carried in f32, exact while every partial sum stays within 2^24
(K·128·128 ≤ 2^24, K ≤ 1024 taps·channels; MobileNetV1's largest K is
1024).  A 1×1 stride-1 conv is a matmul over the pixels (cuBLAS / CPU BLAS);
any other runs F.conv2d with cuDNN off, so the card takes PyTorch's direct
depthwise kernel or im2col + GEMM, never a transform-based algorithm that
would round.

Numerics follow what the JAX package's compiled graph computes on the CPU:
acc·eff + bias is one fused multiply-add there (XLA contracts it), so here
it is computed in f64 and rounded once to f32 (the product of an integer
below 2^24 and an f32 is exact in f64); a division by a constant output
scale is a multiplication by its f32 reciprocal there, and here.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from csinn2_tpu_torch.core.dtypes import Api, Layout, QuantScheme
from csinn2_tpu_torch.ops.ref.conv import conv_nchw, from_nchw, to_nchw, unported_epilogue
from csinn2_tpu_torch.ops.registry import registry

_QSCHEMES = [QuantScheme.INT8_SYM, QuantScheme.INT8_ASYM,
             QuantScheme.INT8_ASYM_W_SYM, QuantScheme.INT4_SYM,
             QuantScheme.INT4_ASYM_W_SYM, QuantScheme.INT16_SYM]
_U8_SCHEMES = [QuantScheme.UINT8_ASYM, QuantScheme.UINT8_SYM]

EXACT_F32 = 2 ** 24       # integers up to this magnitude are exact in f32


def _unported(what: str):
    return NotImplementedError(f"{what} is not ported yet (ROADMAP queue A item 10); "
                               "this package runs int8 carriers with zero zero-points")


def _scales(qi, device):
    """(scale, zero_point) as f32 tensors on `device`, or (None, None) for
    the identity when the tensor is float/unquantized."""
    if qi is None or qi.dtype.is_float:
        return None, None
    s, z, _ = qi.tensors(device)
    return s, z


def _static_zp(qi) -> float:
    """Activation zero-point when statically known, else None."""
    if qi is None:
        return 0.0
    try:
        return float(np.asarray(qi.zero_point).reshape(()))
    except Exception:
        return None


def _static_zp_vec(qi):
    """Weight zero-point as a static numpy vector/scalar, else None."""
    if qi is None:
        return np.float32(0.0)
    try:
        return np.asarray(qi.zero_point)
    except Exception:
        return None


def check_exact(K: int, what: str):
    """Raise unless a K-term sum of int8 products is exact in f32."""
    if K * 128 * 128 > EXACT_F32:
        raise ValueError(f"{what}: {K}-term int8 sums can pass 2^24 and are not exact "
                         "in f32 (K <= 1024)")


def _int_conv(x: torch.Tensor, w: torch.Tensor, params) -> torch.Tensor:
    """Exact s8×s8 convolution in f32, in params.layout; w is OIHW."""
    O, Ig, kh, kw = w.shape
    check_exact(Ig * kh * kw, "conv2d")
    if params.layout == Layout.NHWC and (kh, kw) == (1, 1) and params.group == 1 \
            and tuple(params.stride) == (1, 1) and tuple(params.pad) == (0, 0, 0, 0):
        N, H, W, C = x.shape
        return (x.reshape(-1, C).float() @ w.reshape(O, C).float().T).reshape(N, H, W, O)
    with torch.backends.cudnn.flags(enabled=False):
        out = conv_nchw(to_nchw(x.float(), params.layout), w.float(), params)
    return from_nchw(out, params.layout).contiguous()


def mul_add(acc: torch.Tensor, eff, bias) -> torch.Tensor:
    """acc·eff + bias rounded once to f32 (XLA's fused multiply-add)."""
    if bias is None:
        return acc if eff is None else acc * eff
    e = 1.0 if eff is None else eff.double()
    return (acc.double() * e + bias.double()).float()


def _requant(y: torch.Tensor, out_qinfo, relu: bool, relu6: bool):
    """relu/relu6, then the symmetric requantize clip(round(y/so)+zo) with
    y/so as y·(1/so) — or the float output."""
    if relu:
        y = torch.clamp_min(y, 0.0)
    if relu6:
        y = torch.clamp(y, 0.0, 6.0)
    if out_qinfo is None:
        return y
    if out_qinfo.dtype.is_float:
        return y.to(out_qinfo.dtype.torch)
    if _static_zp(out_qinfo) != 0.0:
        raise _unported("the folded epilogue of an asymmetric output (MobileNetV2-u8)")
    _, zo, inv = out_qinfo.tensors(y.device)
    q = torch.clamp(torch.round(y * inv) + zo, out_qinfo.dtype.qmin, out_qinfo.dtype.qmax)
    return q.to(out_qinfo.dtype.torch)


def _conv2d_quant(arrays, metas, params, out_qinfo, w_layout=Layout.OIHW):
    """x int8 carrier, w int8 carrier (per-channel symmetric), optional f32
    bias; out int8 (or float without an integer out_qinfo)."""
    unported_epilogue(params)
    x, w = arrays[0], arrays[1]
    bias = arrays[2] if len(arrays) > 2 else None
    x_qi, w_qi = metas[0].qinfo, metas[1].qinfo
    if w_layout == Layout.OHWI:
        w = w.permute(0, 3, 1, 2)
    zp, w_zp = _static_zp(x_qi), _static_zp_vec(w_qi)
    if x.dtype != torch.int8 or w.dtype != torch.int8 or zp is None or zp != 0.0 \
            or w_zp is None or np.any(w_zp != 0):
        raise _unported(f"conv2d on {x.dtype} x {w.dtype} carriers with zero-points "
                        f"{zp}/{w_zp} (the u8, asymmetric and float-carrier branches)")
    acc = _int_conv(x, w, params)
    caxis = 1 if params.layout == Layout.NCHW else 3
    shape = [1] * 4
    shape[caxis] = -1
    sx, _ = _scales(x_qi, acc.device)
    sw, _ = _scales(w_qi, acc.device)
    eff = sx if sw is None else (sw if sx is None else sx * sw)   # [O] or scalar, f32
    b = lambda v: v.reshape(shape) if v is not None and v.dim() else v
    y = mul_add(acc, b(eff), b(bias.float()) if bias is not None else None)
    return _requant(y, out_qinfo, params.fuse_relu, params.fuse_relu6)


def _depthwise_quant(arrays, metas, params, out_qinfo, w_layout=Layout.OIHW):
    caxis = 1 if params.layout == Layout.NCHW else 3
    return _conv2d_quant(arrays, metas,
                         dataclasses.replace(params, group=metas[0].shape[caxis]),
                         out_qinfo, w_layout)


def _fc_quant(arrays, metas, params, out_qinfo):
    """y = (x - zx) @ (W - zw)^T · (sx·sw) + b, requantized."""
    x, w = arrays[0], arrays[1]
    bias = arrays[2] if len(arrays) > 2 else None
    x_qi, w_qi = metas[0].qinfo, metas[1].qinfo
    zp, w_zp = _static_zp(x_qi), _static_zp_vec(w_qi)
    if w.dtype != torch.int8 or w_zp is None or np.any(w_zp != 0) or zp != 0.0:
        raise _unported(f"fullyconnected on {w.dtype} weights with zero-points "
                        f"{zp}/{w_zp} (the u8 and asymmetric branches)")
    if x.dtype == torch.int8:
        # integer dot s8×s8, exact in f32
        check_exact(x.shape[-1], "fullyconnected")
        acc = x.float() @ w.float().T
    elif x.is_floating_point():
        # float carrier: x rounded to bf16 (exact products with the int8
        # weights), f32 accumulation — the sum order differs from XLA's
        acc = x.to(torch.bfloat16).float() @ w.float().T
    else:
        raise _unported(f"fullyconnected on {x.dtype} activations")
    sx, _ = _scales(x_qi, acc.device)
    sw, _ = _scales(w_qi, acc.device)
    eff = sx if sw is None else (sw if sx is None else sx * sw)
    y = mul_add(acc, eff, bias.float() if bias is not None else None)
    return _requant(y, out_qinfo, False, False)


for _s in _QSCHEMES + _U8_SCHEMES:
    registry.register("conv2d", _conv2d_quant, api=Api.TORCH, scheme=_s,
                      quant_direct=True)
    registry.register("depthwise_conv2d", _depthwise_quant, api=Api.TORCH, scheme=_s,
                      quant_direct=True)
    registry.register("fullyconnected", _fc_quant, api=Api.TORCH, scheme=_s,
                      quant_direct=True)
