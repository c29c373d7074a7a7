"""Dense layer (counterpart of csinn2_tpu/ops/ref/linear.py; fullyconnected,
the dense op MobileNetV1 records; matmul and embedding are not ported yet).

(ref: source/reference/fullyconnected.c.)
"""

from __future__ import annotations

from csinn2_tpu_torch.core.dtypes import Api
from csinn2_tpu_torch.ops.params import FCParams
from csinn2_tpu_torch.ops.ref.conv import full_f32
from csinn2_tpu_torch.ops.registry import registry


@registry.register("fullyconnected", api=Api.TORCH)
def fullyconnected(x, weight, bias, params: FCParams):
    """y = x @ W^T + b; weight [units, in]; leading dims of x are batch."""
    with full_f32():
        out = x.float() @ weight.float().T
    if bias is not None and bias.numel() > 0:
        out = out + bias.float()
    return out
