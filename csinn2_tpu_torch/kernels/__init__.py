"""Hand-written CUDA kernels (csrc/) with their plain PyTorch versions, and
their op-API tier (autodispatch).

`launch_counts` counts, per kernel, the wrapper calls that launched it on
the card, and the launches a replayed CUDA graph makes (utils/cuda_graph.py
adds each replay's tally); `reset_launch_counts()` zeroes them.  Importing this package
registers the CUDA callbacks of kernels/autodispatch.py."""

from csinn2_tpu_torch.kernels._build import launch_counts, reset_launch_counts
from csinn2_tpu_torch.kernels import autodispatch  # noqa: F401 — registers the CUDA tier
from csinn2_tpu_torch.kernels.qmatmul import quant_matmul

__all__ = ["launch_counts", "reset_launch_counts", "quant_matmul"]
