"""Unary math, binary arithmetic, comparison and logical ops (counterpart of
csinn2_tpu/ops/ref/elementwise.py, the whole module).

(ref: source/reference/{abs,acos,...,xor}.c — the long tail of the op zoo.)
All broadcast like the reference's diso ops.  Float ops compute in f32;
the logical ops take their inputs as bool, the bitwise ops keep the
integer carrier.
"""

from __future__ import annotations

import torch

from csinn2_tpu_torch.core.dtypes import Api
from csinn2_tpu_torch.ops.registry import registry


def _f(x) -> torch.Tensor:
    return x.float() if isinstance(x, torch.Tensor) else torch.as_tensor(x, dtype=torch.float32)


def _u(name, fn):
    registry.register(name, lambda x, params=None, _fn=fn: _fn(_f(x)), api=Api.TORCH)


def _b(name, fn):
    registry.register(name, lambda a, b, params=None, _fn=fn: _fn(_f(a), _f(b)),
                      api=Api.TORCH)


def _bool(x) -> torch.Tensor:
    return x.bool() if isinstance(x, torch.Tensor) else torch.as_tensor(x, dtype=torch.bool)


# --- unary (ref: siso ops) --------------------------------------------------
_u("abs", torch.abs)
_u("acos", torch.acos)
_u("acosh", torch.acosh)
_u("asin", torch.asin)
_u("asinh", torch.asinh)
_u("atan", torch.atan)
_u("atanh", torch.atanh)
_u("ceil", torch.ceil)
_u("cos", torch.cos)
_u("cosh", torch.cosh)
_u("exp", torch.exp)
_u("expm1", torch.expm1)
_u("floor", torch.floor)
_u("log", torch.log)
_u("log1p", torch.log1p)
_u("negative", torch.neg)
_u("round", torch.round)           # half to even, as jnp.round
_u("rsqrt", torch.rsqrt)
_u("sign", torch.sign)
_u("sin", torch.sin)
_u("sinh", torch.sinh)
_u("sqrt", torch.sqrt)
_u("square", torch.square)
_u("tan", torch.tan)
_u("trunc", torch.trunc)
_u("isnan", torch.isnan)

# --- binary arithmetic (ref: diso ops) --------------------------------------
_b("add", torch.add)
_b("sub", torch.sub)
_b("mul", torch.mul)
_b("div", torch.div)
_b("power", torch.pow)
_b("maximum", torch.maximum)
_b("minimum", torch.minimum)
_b("mod", torch.fmod)                   # ref MOD: C fmod semantics
_b("floor_mod", torch.remainder)        # python/floor semantics
_b("floor_divide", lambda a, b: torch.floor(a / b))

# --- comparison -------------------------------------------------------------
_b("equal", torch.eq)          # ref enum typo "EQUANL"
_b("not_equal", torch.ne)
_b("greater", torch.gt)        # ref enum typo "GREATHER"
_b("greater_equal", torch.ge)
_b("less", torch.lt)
_b("less_equal", torch.le)

# --- logical ----------------------------------------------------------------
registry.register("logical_and", lambda a, b, params=None: torch.logical_and(_bool(a), _bool(b)),
                  api=Api.TORCH)
registry.register("logical_or", lambda a, b, params=None: torch.logical_or(_bool(a), _bool(b)),
                  api=Api.TORCH)
registry.register("logical_xor", lambda a, b, params=None: torch.logical_xor(_bool(a), _bool(b)),
                  api=Api.TORCH)
registry.register("logical_not", lambda x, params=None: torch.logical_not(_bool(x)),
                  api=Api.TORCH)

# bitwise forms (ref AND/OR/XOR/NOT operate on integer tensors)
registry.register("and", lambda a, b, params=None: torch.bitwise_and(a, b), api=Api.TORCH)
registry.register("or", lambda a, b, params=None: torch.bitwise_or(a, b), api=Api.TORCH)
registry.register("xor", lambda a, b, params=None: torch.bitwise_xor(a, b), api=Api.TORCH)
registry.register("not", lambda x, params=None: torch.bitwise_not(x), api=Api.TORCH)


@registry.register("select", api=Api.TORCH)
def select(cond, a, b, params=None):
    """(ref: shl_ref_select_f32 / CSINN_OP_SELECT, also WHERE with 3 args)."""
    return torch.where(_bool(cond), _f(a), _f(b))


registry.register("where", select, api=Api.TORCH)


@registry.register("where_softmax", api=Api.TORCH)
def where_softmax(cond, x, params=None, axis: int = -1):
    """masked softmax: where(cond, x, -inf) then softmax
    (ref: CSINN_OP_WHERE_SOFTMAX, used for attention masks)."""
    masked = torch.where(_bool(cond), _f(x), torch.tensor(float("-inf")))
    return torch.softmax(masked, dim=axis)


@registry.register("data_convert", api=Api.TORCH)
def data_convert(x, params=None):
    """Identity in float space; the op API's quant wrapper performs the
    actual dequant→requant into the requested out_qinfo
    (ref: CSINN_OP_DATA_CONVERT, source/thead_rvv/*/data_convert.c)."""
    return x
