"""Lane-steps that decoded a token a request needed, over batch × decode
steps, in the window's decode chunks.  The rest is idle lanes and lanes
run past their request's last token to the end of a chunk."""

UNIT = "%"
LAYER = "Scheduler (llm/engine.py run_queue)"
MOVES = "output_tok_s"
SOURCE = "program_span"


def read(run):
    spans = run.rec.window_spans("decode")
    steps = sum(s.n_steps for s in spans)
    if not steps:
        return None
    used = sum(u for s in spans for _, u in s.lanes)
    return 100.0 * used / (run.rec.batch * steps)
