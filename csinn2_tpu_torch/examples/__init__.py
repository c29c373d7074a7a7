"""Runnable programs of the port (counterparts of the repository's examples/):

    python3 -m csinn2_tpu_torch.examples.int4_dequant_probe   # the dequant probes
    python3 -m csinn2_tpu_torch.examples.int4_tile_tune       # andmask's split-length sweep

They run on the card unless called with device="cpu"."""
