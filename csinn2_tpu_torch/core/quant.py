"""Quantization constants shared by the port (counterpart of
csinn2_tpu/core/quant.py; only the block size is ported so far)."""

BLOCK_SIZE = 32  # llama.cpp-compatible block quant granularity along K
