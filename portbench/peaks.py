"""Peak rates of one NVIDIA H100 SXM (80 GB HBM3), from NVIDIA's data
sheet: dense rates without sparsity, at the full 700 W power limit.  A
share against them is stated beside the card's power limit."""

TENSOR_FLOPS = 989e12          # bf16 / fp16 dense on the tensor cores
HBM_BYTES_S = 3.35e12          # HBM3
