"""Op-level API: one function per operator, mirroring the reference's
csinn_<op>() surface (counterpart of csinn2_tpu/ops/, every op it
registers).

In LAYER run-mode each call executes eagerly (quantized semantics =
dequant→f32→requant through the registered implementation); in GRAPH mode
the same calls are recorded by the active Session into the graph IR
(ref: csinn_data_structure.h:557-563, the `est` hooks).
"""

from csinn2_tpu_torch.ops.registry import OpRegistry, registry  # noqa: F401
import csinn2_tpu_torch.ops.ref  # noqa: F401 — populates the registry
import csinn2_tpu_torch.kernels.qconv  # noqa: F401 — scheme-specialized integer paths
import csinn2_tpu_torch.kernels.dsblock  # noqa: F401 — fused dw→pw block kernel
from csinn2_tpu_torch.ops.params import *  # noqa: F401,F403
from csinn2_tpu_torch.ops.api import *  # noqa: F401,F403
