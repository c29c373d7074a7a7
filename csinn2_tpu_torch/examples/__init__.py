"""Runnable programs of the port (counterparts of the repository's examples/):

    python3 -m csinn2_tpu_torch.examples.int4_dequant_probe   # the dequant probes
    python3 -m csinn2_tpu_torch.examples.int4_tile_tune       # andmask's split-length sweep
    python3 -m csinn2_tpu_torch.examples.llama_generate       # the LLM demo (--device cpu)
    python3 -m csinn2_tpu_torch.examples.llama7b_bench        # Llama-2-7B TTFT, decode tok/s
    python3 -m csinn2_tpu_torch.examples.decode_step_profile  # a decode step's kernels (card only)
    python3 -m csinn2_tpu_torch.examples.moe_dispatch_probe   # MoE dense vs routed dispatch

They run on the card unless called with device="cpu" (--device cpu)."""
