"""Shape ops (counterpart of csinn2_tpu/ops/ref/shape.py; flatten, the shape
op MobileNetV1 records; the rest of the family is not ported yet)."""

from __future__ import annotations

from csinn2_tpu_torch.core.dtypes import Api
from csinn2_tpu_torch.ops.registry import registry


@registry.register("flatten", api=Api.TORCH)
def flatten(x, params=None):
    return x.reshape(x.shape[0], -1)
