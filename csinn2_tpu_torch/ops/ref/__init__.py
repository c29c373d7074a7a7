"""Float reference implementations in plain PyTorch (counterpart of
csinn2_tpu/ops/ref/; conv, activation, elementwise, pool, linear, shape and
attention — the ops the CNN models record, matmul and scaled-dot-product
attention).  They back the
float session that `forward_f32` and `calibrate` run, and the generic
dequant→f32→requant path of ops/api.py.

Importing this package populates the op registry.
"""

from csinn2_tpu_torch.ops.ref import (  # noqa: F401
    activation,
    attention,
    conv,
    elementwise,
    linear,
    pool,
    shape,
)
