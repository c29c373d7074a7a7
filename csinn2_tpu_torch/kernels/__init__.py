"""Hand-written CUDA kernels (csrc/) with their plain PyTorch versions.

`launch_counts` counts, per kernel, the wrapper calls that launched it on
the card; `reset_launch_counts()` zeroes them."""

from csinn2_tpu_torch.kernels._build import launch_counts, reset_launch_counts

__all__ = ["launch_counts", "reset_launch_counts"]
