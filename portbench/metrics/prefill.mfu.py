"""The window's prefills' least time on the chip (counts.prefill of their
real tokens: the larger of FLOPs over the bf16 tensor peak and bytes over
HBM) over their measured host time."""

from portbench import counts

UNIT = "%"
LAYER = "Prefill (engine._prefill_local, model.llama_forward)"
MOVES = "ttft_p95_ms"
SOURCE = "program_span"


def read(run):
    spans = run.rec.window_spans("prefill")
    took = sum(s.t1 - s.t0 for s in spans)
    if not spans or took <= 0:
        return None
    need = sum(counts.least_seconds(counts.prefill(run.dims, s.n_prompt)) for s in spans)
    return 100.0 * need / took
