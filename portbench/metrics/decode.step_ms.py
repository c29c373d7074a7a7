"""Host time inside decode_steps over the steps it ran, across the whole
window (a chunk replays the step graph n times and fetches its tokens)."""

UNIT = "ms"
LAYER = "Decode step (engine._graph_chunk, _batched_decode_forward)"
MOVES = "output_tok_s"
SOURCE = "program_span"


def read(run):
    spans = run.rec.window_spans("decode")
    steps = sum(s.n_steps for s in spans)
    if not steps:
        return None
    return sum(s.t1 - s.t0 for s in spans) * 1e3 / steps
