"""The window's decode steps' least time on the chip (counts.decode_step of
the lanes that needed each step, at their own positions) over their
measured host time."""

from portbench import counts
from portbench.stats import step_positions

UNIT = "%"
LAYER = "Decode step (engine._graph_chunk, _batched_decode_forward)"
MOVES = "output_tok_s"
SOURCE = "program_span"


def read(run):
    spans = run.rec.window_spans("decode")
    took = sum(s.t1 - s.t0 for s in spans)
    if not spans or took <= 0:
        return None
    need = sum(counts.least_seconds(counts.decode_step(run.dims, pos))
               for s in spans for pos in step_positions(s))
    return 100.0 * need / took
