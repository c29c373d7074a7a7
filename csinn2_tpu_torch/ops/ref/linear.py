"""Dense layers (counterpart of csinn2_tpu/ops/ref/linear.py:
fullyconnected, matmul and embedding).

(ref: source/reference/fullyconnected.c, matmul.c.)
"""

from __future__ import annotations

import torch

from csinn2_tpu_torch.core.dtypes import Api
from csinn2_tpu_torch.ops.params import FCParams, GatherParams, MatmulParams
from csinn2_tpu_torch.ops.ref.conv import full_f32
from csinn2_tpu_torch.ops.ref.shape import gather
from csinn2_tpu_torch.ops.registry import registry


@registry.register("fullyconnected", api=Api.TORCH)
def fullyconnected(x, weight, bias, params: FCParams):
    """y = x @ W^T + b; weight [units, in]; leading dims of x are batch."""
    with full_f32():
        out = x.float() @ weight.float().T
    if bias is not None and bias.numel() > 0:
        out = out + bias.float()
    return out


@registry.register("matmul", api=Api.TORCH)
def matmul(a, b, params: MatmulParams):
    """Batched matmul with optional transposes, in f32 (ref: shl_ref_matmul_f32)."""
    a, b = a.float(), b.float()
    if params.trans_a:
        a = a.transpose(-1, -2)
    if params.trans_b:
        b = b.transpose(-1, -2)
    with full_f32():
        return torch.matmul(a, b)


@registry.register("embedding", api=Api.TORCH)
def embedding(ids, table, params=None):
    """Token-id lookup (ref: shl_rvv_embedding): jnp.take's rules, as gather."""
    return gather(table, ids, GatherParams(axis=0))
