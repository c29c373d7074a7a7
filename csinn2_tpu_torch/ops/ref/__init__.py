"""Float reference implementations in plain PyTorch of the full op zoo
(counterpart of csinn2_tpu/ops/ref/): conv, activation, elementwise, pool,
norm, reduce, linear, shape, attention and the streaming-ASR cache ops,
detection and the rest (misc).  They back the float sessions and the
generic dequant→f32→requant path of ops/api.py.

Importing this package populates the op registry.
"""

from csinn2_tpu_torch.ops.ref import (  # noqa: F401
    activation,
    attention,
    conv,
    detection,
    elementwise,
    linear,
    misc,
    norm,
    pool,
    reduce,
    shape,
)
