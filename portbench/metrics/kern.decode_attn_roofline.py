"""Decode attention (kernels/flash_attention.py decode_attention:
`decode_attn_kernel` and its merge `attn_combine_kernel`) over the traced
decode chunks: its least time (each needed lane's int8 K/V rows up to its
own position, q in and out in bf16; counts.decode_step's "attn") over the
summed device time of the kernels so named."""

from portbench import counts
from portbench.stats import step_positions

UNIT = "%"
LAYER = "Kernels (kernels/qmatmul.py, kernels/flash_attention.py)"
MOVES = "output_tok_s"
SOURCE = "device_trace"
KERNELS = ("decode_attn_kernel", "attn_combine_kernel")


def read(run):
    if run.trace is None:
        return None
    t = sum(dur for name, _, dur, kind in run.trace["ops"]
            if kind == "decode" and any(k in name for k in KERNELS))
    if t <= 0:
        return None
    need = sum(counts.least_seconds(counts.decode_step(run.dims, pos)["attn"])
               for s in run.rec.trace_spans("decode") for pos in step_positions(s))
    return 100.0 * need / t
