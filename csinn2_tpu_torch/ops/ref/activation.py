"""Activations (counterpart of csinn2_tpu/ops/ref/activation.py; relu, relu6
and softmax, the activations MobileNetV1's builder calls; the rest of the
family is not ported yet).

(ref: source/reference/{relu,relu6,softmax}.c.)
"""

from __future__ import annotations

import torch

from csinn2_tpu_torch.core.dtypes import Api
from csinn2_tpu_torch.ops.params import SoftmaxParams
from csinn2_tpu_torch.ops.registry import registry


@registry.register("relu", api=Api.TORCH)
def relu(x, params=None):
    return torch.clamp_min(x.float(), 0.0)


@registry.register("relu6", api=Api.TORCH)
def relu6(x, params=None):
    return torch.clamp(x.float(), 0.0, 6.0)


@registry.register("softmax", api=Api.TORCH)
def softmax(x, params: SoftmaxParams):
    return torch.softmax(x.float(), dim=params.axis)
