"""Quantized conv2d / fc over integer carriers (counterpart of
csinn2_tpu/kernels/qconv.py, which holds no Pallas kernel: its convolutions
are XLA's, and here they are plain PyTorch ops).

Every branch of the JAX module is here:
  * the integer path: s8×s8 and s16×s16 sums; a nonzero activation
    zero-point pads the input with zp and subtracts zp·Σw[o] (the per-channel
    weight-sum vector `precompute_zp_wsum`, or the same sum taken in the
    graph);
  * u8 carriers: u8×u8 shifts both carriers by 128 into s8 and subtracts
    zw[o]·Σwindow(x − zx) (a ones-kernel convolution) for asymmetric
    weights; a u8 input with s8 weights (the u8 graph edge into the s8
    interior) shifts the input only;
  * the float-carrier fallback for mixed carriers (both widened, zero-points
    subtracted, an f32 convolution);
  * the fused residual (fuse_add: the tensor after the bias) and the fused
    hardswish (fuse_hswish);
  * the folded epilogue of an asymmetric output — one multiply-add by
    eff/so and zo + b/so, the fused clamps folded into the clip bounds —
    taken exactly where the JAX package takes it: zo ≠ 0 and no hardswish;
  * `_fc_quant`'s u8, zero-point, int16 and float-carrier branches, and the
    `group_conv2d` registration.

Exactness: the JAX package accumulates the integer sums in int32
(preferred_element_type=int32), exact at every K.  PyTorch has no integer
convolution, so the port carries a sum of K products, each at most B in
magnitude (B = 2^14 for s8 carriers, 2^30 for s16), in f32 where K·B ≤ 2^24
and in f64 otherwise (exact while K·B ≤ 2^53: every s8 shape, and s16 up to
K = 2^23).  So MobileNetV1's convolutions stay f32 and ResNet-50's 3×3 convs
past 113 input channels and its 1×1 convs past K = 1024 run in f64, on the
CPU and on the card alike.  A 1×1 stride-1 unpadded NHWC conv is a matmul
over the pixels (cuBLAS / CPU BLAS); any other runs F.conv2d with cuDNN off,
so the card takes PyTorch's direct depthwise kernel or im2col + GEMM, never
a transform-based algorithm that would round.  Zero-point corrections are
then taken in f64, exact, and the sum is rounded once to f32, as the JAX
package converts its int32 accumulator.

Numerics follow what the JAX package's compiled graph computes on the CPU
(x86): a product that feeds one add is one fused multiply-add there (XLA
lets LLVM contract it), so here it is computed in f64 and rounded once to
f32 (the product of two f32s is exact in f64); a division by a constant is
a multiplication by its f32 reciprocal there, and here; a quotient of two
constants (eff/so, sr/so) is folded as a true f32 division.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from csinn2_tpu_torch.core.dtypes import Api, Layout, QuantScheme
from csinn2_tpu_torch.ops.ref.conv import conv_nchw, from_nchw, hswish, to_nchw
from csinn2_tpu_torch.ops.registry import registry

_QSCHEMES = [QuantScheme.INT8_SYM, QuantScheme.INT8_ASYM,
             QuantScheme.INT8_ASYM_W_SYM, QuantScheme.INT4_SYM,
             QuantScheme.INT4_ASYM_W_SYM, QuantScheme.INT16_SYM]
_U8_SCHEMES = [QuantScheme.UINT8_ASYM, QuantScheme.UINT8_SYM]

EXACT_F32 = 2 ** 24       # integers up to this magnitude are exact in f32
_ABSMAX = {torch.int8: 128, torch.uint8: 255, torch.int16: 32768}


def _scales(qi, device):
    """(scale, zero_point) as f32 tensors on `device`, or (None, None) for
    the identity when the tensor is float/unquantized."""
    if qi is None or qi.dtype.is_float:
        return None, None
    s, z, _ = qi.tensors(device)
    return s, z


def _static_zp(qi) -> float:
    """Activation zero-point when statically known, else None."""
    return 0.0 if qi is None else static_scalar(qi.zero_point)


def _static_zp_vec(qi):
    """Weight zero-point as a static numpy vector/scalar, else None."""
    if qi is None:
        return np.float32(0.0)
    try:
        return np.asarray(qi.zero_point)
    except Exception:
        return None


def static_scalar(v):
    """A per-tensor scale or zero-point as a Python float, else None."""
    try:
        return float(np.asarray(v).reshape(()))
    except Exception:
        return None


def check_exact(K: int, what: str):
    """Raise unless a K-term sum of int8 products is exact in f32."""
    if K * 128 * 128 > EXACT_F32:
        raise ValueError(f"{what}: {K}-term int8 sums can pass 2^24 and are not exact "
                         "in f32 (K <= 1024)")


def exact_dtype(K: int, bound: int) -> torch.dtype:
    """The float dtype in which a K-term sum of products of magnitude at
    most `bound` is exact: f32 up to 2^24, else f64."""
    return torch.float32 if K * bound <= EXACT_F32 else torch.float64


def precompute_zp_wsum(w_np, w_layout=Layout.OIHW) -> np.ndarray:
    """Per-out-channel weight sum for the activation-zp correction, computed
    once at graph build from the const weight: with zp-padding every window
    is full, so y = acc − zx·Σw[o] exactly (the reference's fuse_zp_to_bias
    AOT fold, tests/validation_layer/testutil.h).  u8-stored weights count
    as their s8 carriers (w − 128).  int32 [O], numpy."""
    w = np.asarray(w_np)
    if w_layout == Layout.OHWI:
        w = np.transpose(w, (0, 3, 1, 2))
    if w.dtype == np.uint8:
        w = w.astype(np.int64) - 128
    return w.astype(np.int64).sum(axis=(1, 2, 3)).astype(np.int32)


def _shift_u8(t: torch.Tensor) -> torch.Tensor:
    """A u8 carrier as its s8 carrier t − 128 (same values about zp − 128)."""
    return (t.to(torch.int16) - 128).to(torch.int8)


def _widen_conv(a: torch.Tensor) -> torch.Tensor:
    """A conv carrier widened as the JAX fallback widens it: through int32
    (a float carrier truncates), then bf16, or f32 for int16."""
    return a.to(torch.int32).to(torch.float32 if a.dtype == torch.int16 else torch.bfloat16)


def _int_conv(x: torch.Tensor, w: torch.Tensor, params, bound: int,
              zp_pad: float = 0.0) -> torch.Tensor:
    """Exact convolution of integer-valued x (in params.layout) and w
    (OIHW), |x·w| <= bound: f32 or f64 per `exact_dtype`.  zp_pad pads the
    input with that value instead of zero (the pads then leave params)."""
    O, Ig, kh, kw = w.shape
    dt = exact_dtype(Ig * kh * kw, bound)
    xf, wf = x.to(dt), w.to(dt)
    if zp_pad and any(params.pad):
        pt, pd, pl, pr = params.pad
        spatial = (0, 0, pl, pr, pt, pd) if params.layout == Layout.NHWC else (pl, pr, pt, pd)
        xf = torch.nn.functional.pad(xf, spatial, value=zp_pad)
        params = dataclasses.replace(params, pad=(0, 0, 0, 0))
    if params.layout == Layout.NHWC and (kh, kw) == (1, 1) and params.group == 1 \
            and tuple(params.stride) == (1, 1) and tuple(params.pad) == (0, 0, 0, 0):
        N, H, W, C = xf.shape
        return (xf.reshape(-1, C) @ wf.reshape(O, C).T).reshape(N, H, W, O)
    with torch.backends.cudnn.flags(enabled=False):
        out = conv_nchw(to_nchw(xf, params.layout), wf, params)
    return from_nchw(out, params.layout).contiguous()


def fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """a·b + c rounded once to f32 (XLA's contracted multiply-add), taken in
    f64 where the product of two f32s is exact."""
    return (a.double() * (b.double() if isinstance(b, torch.Tensor) else b)
            + (c.double() if isinstance(c, torch.Tensor) else c)).float()


def mul_add(acc: torch.Tensor, eff, bias) -> torch.Tensor:
    """acc·eff + bias rounded once to f32 (XLA's fused multiply-add)."""
    if bias is None:
        return acc if eff is None else acc * eff
    return fma(acc, 1.0 if eff is None else eff, bias)


def _requant(y: torch.Tensor, out_qinfo, relu: bool = False, relu6: bool = False,
             hs: bool = False):
    """relu/relu6/hardswish, then the requantize clip(round(y/so)+zo) with
    y/so as y·(1/so) — or the float output."""
    if relu:
        y = torch.clamp_min(y, 0.0)
    if relu6:
        y = torch.clamp(y, 0.0, 6.0)
    if hs:
        y = hswish(y)
    if out_qinfo is None:
        return y
    if out_qinfo.dtype.is_float:
        return y.to(out_qinfo.dtype.torch)
    _, zo, inv = out_qinfo.tensors(y.device)
    q = torch.clamp(torch.round(y * inv) + zo, out_qinfo.dtype.qmin, out_qinfo.dtype.qmax)
    return q.to(out_qinfo.dtype.torch)


def _folded(acc, eff, bias, residual, r_qi, params, out_qinfo, b):
    """The folded requantize of an asymmetric output: y = acc·(eff/so) +
    (zo + bias/so) as one multiply-add, the residual r·(sr/so) − zr·sr/so,
    round, and the clip with relu/relu6 folded into its bounds."""
    dev = acc.device
    so, zo, inv_so = out_qinfo.tensors(dev)
    so_f, zo_f = static_scalar(out_qinfo.scale), static_scalar(out_qinfo.zero_point)
    scale2 = eff / so
    bias2 = zo if bias is None else fma(bias, inv_so, zo)
    lo, hi = float(out_qinfo.dtype.qmin), float(out_qinfo.dtype.qmax)
    if params.fuse_relu or params.fuse_relu6:
        lo = max(lo, zo_f)
    if params.fuse_relu6:
        hi = min(hi, float(np.round(6.0 / so_f)) + zo_f)
    y = fma(acc, b(scale2), b(bias2))
    if residual is not None:
        if r_qi is None or r_qi.dtype.is_float:
            y = fma(residual.float(), inv_so, y)
        else:
            sr, zr = _scales(r_qi, dev)
            y = fma(residual.float(), sr / so, y) - zr * sr / so
    q = torch.clamp(torch.round(y), lo, hi)
    return q.to(out_qinfo.dtype.torch)


def _conv2d_quant(arrays, metas, params, out_qinfo, w_layout=Layout.OIHW):
    """x int carrier, w int carrier (per-channel), optional f32 bias, then
    the residual (fuse_add) and the zp weight-sum vector (`__zp_wsum__`,
    appended by the op API) — see the module docstring for the branches."""
    arrays, metas = list(arrays), list(metas)
    smap = None
    if len(arrays) > 2 and getattr(metas[-1], "name", "") == "__zp_wsum__":
        smap = arrays.pop()
        metas.pop()
    residual = r_qi = None
    if params.fuse_add:
        residual, r_qi = arrays[3], metas[3].qinfo
        arrays = arrays[:3]
    x, w = arrays[0], arrays[1]
    bias = arrays[2] if len(arrays) > 2 else None
    x_qi, w_qi = metas[0].qinfo, metas[1].qinfo
    if w_layout == Layout.OHWI:
        w = w.permute(0, 3, 1, 2)
    caxis = 1 if params.layout == Layout.NCHW else 3
    shape = [1] * 4
    shape[caxis] = -1
    dev = x.device
    sx, zx = _scales(x_qi, dev)
    sw, zw_f = _scales(w_qi, dev)

    zp, w_zp = _static_zp(x_qi), _static_zp_vec(w_qi)
    u8 = x.dtype == torch.uint8 and w.dtype == torch.uint8 and zp is not None \
        and w_zp is not None
    if u8:
        # (x_u8 − zx)(w_u8 − zw) == (x_s8 − zx')(w_s8 − zw'), shifted by 128
        x, w = _shift_u8(x), _shift_u8(w)
        zp -= 128.0
        zw_vec = np.asarray(w_zp, np.int64) - 128
    elif x.dtype == torch.uint8 and w.dtype == torch.int8 and zp is not None:
        # the u8 graph edge into the s8 interior: shift the input once
        x = _shift_u8(x)
        zp -= 128.0
    if x.dtype == w.dtype and x.dtype in (torch.int8, torch.int16) and zp is not None:
        zp_i = int(round(zp))
        bound = _ABSMAX[x.dtype] * _ABSMAX[w.dtype]
        acc = _int_conv(x, w, params, bound, zp_pad=float(zp_i))
        if zp_i != 0 or (u8 and np.any(zw_vec != 0)):
            acc = acc.double()
        if zp_i != 0:
            # every window is full (zp-padded): subtract zp·Σw[o]
            wsum = smap if smap is not None and smap.dim() == 1 else \
                w.to(torch.int64).sum(dim=(1, 2, 3))
            acc = acc - zp_i * wsum.double().reshape(shape)
        if u8 and np.any(zw_vec != 0):
            # asymmetric weights: − zw[o]·Σwindow(x − zx'), a ones-kernel conv
            g = params.group
            O, ig, kh, kw = w.shape
            ones = torch.ones((g, ig, kh, kw), dtype=torch.int8, device=dev)
            winsum = _int_conv(x, ones, params, 128, zp_pad=float(zp_i)).double() \
                - zp_i * (ig * kh * kw)
            if g != O:
                winsum = winsum.repeat_interleave(O // g, dim=caxis)
            zw = torch.tensor(np.broadcast_to(zw_vec, (O,)).astype(np.float64), device=dev)
            acc = acc - zw.reshape(shape) * winsum
        acc = acc.float()
    else:
        # float-carrier fallback (mixed carriers): each carrier through
        # int32 into bf16 (f32 for int16; f32 both when they differ), the
        # zero-points subtracted in that dtype, then a convolution whose
        # sums are taken exactly and rounded once to f32
        xb, wb = _widen_conv(x), _widen_conv(w)
        if xb.dtype != wb.dtype:
            xb, wb = xb.float(), wb.float()
        if zx is not None:
            xb = xb - zx.to(xb.dtype)
        if zw_f is not None:
            wb = wb - (zw_f.reshape(-1, 1, 1, 1) if zw_f.dim() else zw_f).to(wb.dtype)
        with torch.backends.cudnn.flags(enabled=False):
            acc = conv_nchw(to_nchw(xb.double(), params.layout), wb.double(), params)
        acc = from_nchw(acc, params.layout).contiguous().float()

    b = lambda v: v.reshape(shape) if isinstance(v, torch.Tensor) and v.dim() else v
    eff = sx if sw is None else (sw if sx is None else sx * sw)   # [O] or scalar, f32
    if eff is None:
        eff = torch.ones((), device=dev)
    bias_f = bias.float() if bias is not None else None
    if out_qinfo is not None and not out_qinfo.dtype.is_float:
        so_f, zo_f = static_scalar(out_qinfo.scale), static_scalar(out_qinfo.zero_point)
        if so_f is not None and zo_f != 0.0 and not params.fuse_hswish:
            return _folded(acc, eff, bias_f, residual, r_qi, params, out_qinfo, b)
    y = mul_add(acc, b(eff), b(bias_f))
    if residual is not None:
        if r_qi is None or r_qi.dtype.is_float:
            y = y + residual.float()
        else:
            sr, zr = _scales(r_qi, dev)
            y = fma(residual.float() - zr, sr, y)
    return _requant(y, out_qinfo, params.fuse_relu, params.fuse_relu6, params.fuse_hswish)


def _depthwise_quant(arrays, metas, params, out_qinfo, w_layout=Layout.OIHW):
    caxis = 1 if params.layout == Layout.NCHW else 3
    return _conv2d_quant(arrays, metas,
                         dataclasses.replace(params, group=metas[0].shape[caxis]),
                         out_qinfo, w_layout)


def _fc_quant(arrays, metas, params, out_qinfo):
    """y = (x − zx) @ (W − zw)^T · (sx·sw) + b, requantized."""
    x, w = arrays[0], arrays[1]
    bias = arrays[2] if len(arrays) > 2 else None
    x_qi, w_qi = metas[0].qinfo, metas[1].qinfo
    dev = x.device
    sx, zx = _scales(x_qi, dev)
    sw, zw_f = _scales(w_qi, dev)
    zp, w_zp = _static_zp(x_qi), _static_zp_vec(w_qi)
    u8 = x.dtype == torch.uint8 and w.dtype == torch.uint8 and zp is not None \
        and w_zp is not None
    if u8:
        x, w = _shift_u8(x), _shift_u8(w)
        zp -= 128.0
    elif x.dtype == torch.uint8 and w.dtype == torch.int8 and zp is not None:
        x = _shift_u8(x)
        zp -= 128.0
    if x.dtype == w.dtype and x.dtype in (torch.int8, torch.int16) and zp is not None:
        # integer dot; the zp corrections are exact for a dense dot:
        # (x−zx)@(W−zw)ᵀ = x@Wᵀ − zx·Σ_k W − zw·(Σ_k x − K·zx)
        K = x.shape[-1]
        dt = exact_dtype(K, _ABSMAX[x.dtype] * _ABSMAX[w.dtype])
        acc = (x.to(dt) @ w.to(dt).T).double()
        zp_i = int(round(zp))
        if zp_i != 0:
            acc = acc - zp_i * w.to(torch.int64).sum(dim=1).double()
        if u8:
            zw_vec = np.asarray(w_zp, np.int64) - 128
            if np.any(zw_vec != 0):
                xsum = x.to(torch.int64).sum(dim=-1, keepdim=True).double()
                zw = torch.tensor(np.broadcast_to(zw_vec, (w.shape[0],)).astype(np.float64),
                                  device=dev)
                acc = acc - zw * (xsum - K * zp_i)
        acc = acc.float()
    else:
        # float carrier: 8-bit carriers and float x ride bf16 (x rounded to
        # bf16, exact products with 8-bit weights), int16 rides f32, a
        # mixed pair f32; the sum is taken in f64 and rounded once to f32,
        # so the card and the CPU agree (XLA sums in f32, in its own order:
        # the one place the port may round the other way)
        def widen(a):
            if a.dtype == torch.int16:
                return a.float()
            return a.to(torch.bfloat16)
        xb, wb = widen(x), widen(w)
        if xb.dtype != wb.dtype:
            xb, wb = xb.float(), wb.float()
        if zx is not None:
            xb = xb - zx.to(xb.dtype)
        if zw_f is not None:
            wb = wb - (zw_f.reshape(-1, 1) if zw_f.dim() else zw_f).to(wb.dtype)
        acc = (xb.double() @ wb.double().T).float()
    eff = sx if sw is None else (sw if sx is None else sx * sw)
    y = mul_add(acc, eff, bias.float() if bias is not None else None)
    return _requant(y, out_qinfo)


for _s in _QSCHEMES + _U8_SCHEMES:
    registry.register("conv2d", _conv2d_quant, api=Api.TORCH, scheme=_s,
                      quant_direct=True)
    registry.register("group_conv2d", _conv2d_quant, api=Api.TORCH, scheme=_s,
                      quant_direct=True)
    registry.register("depthwise_conv2d", _depthwise_quant, api=Api.TORCH, scheme=_s,
                      quant_direct=True)
    registry.register("fullyconnected", _fc_quant, api=Api.TORCH, scheme=_s,
                      quant_direct=True)
