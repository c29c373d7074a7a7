"""Pooling (counterpart of csinn2_tpu/ops/ref/pool.py; global_avgpool2d, the
pool MobileNetV1 records; the windowed and max pools are not ported yet).

(ref: source/reference/global_averagepool.c.)
"""

from __future__ import annotations

import numpy as np

from csinn2_tpu_torch.core.dtypes import Api, Layout
from csinn2_tpu_torch.ops.params import PoolParams
from csinn2_tpu_torch.ops.registry import registry


@registry.register("global_avgpool2d", api=Api.TORCH)
def global_avgpool2d(x, params: PoolParams):
    """Mean over H and W, kept as 1×1: the sum times the f32 reciprocal of
    the count, as XLA computes `jnp.mean`."""
    axes = (2, 3) if params.layout == Layout.NCHW else (1, 2)
    x = x.float()
    count = x.shape[axes[0]] * x.shape[axes[1]]
    return x.sum(dim=axes, keepdim=True) * float(np.float32(1.0) / np.float32(count))
