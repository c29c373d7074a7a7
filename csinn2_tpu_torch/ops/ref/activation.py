"""Activations (counterpart of csinn2_tpu/ops/ref/activation.py, the whole
module).

(ref: source/reference/{relu,relu1,relu6,relun,leaky_relu,prelu,elu,
sigmoid,hard_sigmoid,softmax,log_softmax,softplus,softsign,erf,clip,
threshold_relu,softrelu}.c.)  All compute in f32.  `hard_sigmoid` is
x·(1/6) + 0.5 as one fused multiply-add, what the JAX package's compiled
graph computes for `x / 6.0 + 0.5` (XLA turns the division by a constant
into a product by its f32 reciprocal and contracts it with the add).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from csinn2_tpu_torch.core.dtypes import Api
from csinn2_tpu_torch.ops.params import ClipParams, PReluParams, ReluParams, SoftmaxParams
from csinn2_tpu_torch.ops.registry import registry

_INV6 = float(np.float32(1.0) / np.float32(6.0))


def _reg_unary(name, fn):
    registry.register(name, lambda x, params=None, _fn=fn: _fn(x.float()), api=Api.TORCH)


def hard_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """clip(fma(x, f32(1/6), 0.5), 0, 1); the fma is taken in f64, where
    the product of two f32s is exact."""
    return torch.clamp((x.double() * _INV6 + 0.5).float(), 0.0, 1.0)


_reg_unary("relu", lambda x: torch.clamp_min(x, 0.0))
_reg_unary("relu1", lambda x: torch.clamp(x, 0.0, 1.0))
_reg_unary("relu6", lambda x: torch.clamp(x, 0.0, 6.0))
_reg_unary("sigmoid", torch.sigmoid)
_reg_unary("hard_sigmoid", hard_sigmoid)
_reg_unary("silu", F.silu)
_reg_unary("erf", torch.erf)
_reg_unary("tanh", torch.tanh)
_reg_unary("softplus", lambda x: torch.logaddexp(x, torch.zeros_like(x)))
_reg_unary("softrelu", lambda x: torch.logaddexp(x, torch.zeros_like(x)))  # log(1+e^x)
_reg_unary("softsign", lambda x: x / (1.0 + torch.abs(x)))
_reg_unary("gelu", lambda x: F.gelu(x, approximate="tanh"))    # jax.nn.gelu's default


@registry.register("relun", api=Api.TORCH)
def relun(x, params: ReluParams):
    return torch.clamp(x.float(), 0.0, params.n)


@registry.register("leaky_relu", api=Api.TORCH)
def leaky_relu(x, params: ReluParams):
    x = x.float()
    return torch.where(x >= 0, x, x * params.n)


@registry.register("threshold_relu", api=Api.TORCH)
def threshold_relu(x, params: ReluParams):
    x = x.float()
    return torch.where(x > params.n, x, torch.zeros_like(x))


@registry.register("prelu", api=Api.TORCH)
def prelu(x, alpha, params: PReluParams):
    """alpha is per-channel along params.axis (ref: shl_ref_prelu_f32)."""
    x = x.float()
    shape = [1] * x.dim()
    shape[params.axis] = -1
    return torch.where(x >= 0, x, x * alpha.float().reshape(shape))


@registry.register("elu", api=Api.TORCH)
def elu(x, params=None):
    return F.elu(x.float())


@registry.register("clip", api=Api.TORCH)
def clip(x, params: ClipParams):
    return torch.clamp(x.float(), params.min_value, params.max_value)


@registry.register("softmax", api=Api.TORCH)
def softmax(x, params: SoftmaxParams):
    return torch.softmax(x.float(), dim=params.axis)


@registry.register("log_softmax", api=Api.TORCH)
def log_softmax(x, params: SoftmaxParams):
    return torch.log_softmax(x.float(), dim=params.axis)
