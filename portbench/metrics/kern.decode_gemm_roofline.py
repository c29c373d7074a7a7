"""The decode GEMMs (kernels/qmatmul.py, `qmm_decode_kernel`) over the traced
decode chunks: their least time (every weight's values and scales once,
the needed lanes' bf16 activations; counts.decode_step's "gemm") over the
summed device time of the kernels so named."""

from portbench import counts
from portbench.stats import step_positions

UNIT = "%"
LAYER = "Kernels (kernels/qmatmul.py, kernels/flash_attention.py)"
MOVES = "output_tok_s"
SOURCE = "device_trace"
KERNELS = ("qmm_decode_kernel",)


def read(run):
    if run.trace is None:
        return None
    t = sum(dur for name, _, dur, kind in run.trace["ops"]
            if kind == "decode" and any(k in name for k in KERNELS))
    if t <= 0:
        return None
    need = sum(counts.least_seconds(counts.decode_step(run.dims, pos)["gemm"])
               for s in run.rec.trace_spans("decode") for pos in step_positions(s))
    return 100.0 * need / t
