"""Prefills served by a replay of their bucket's captured CUDA graph (the
engine's prefill.graph_replays) over the engine's prefills (its "prefill"
spans), over the traced segment.  None where the engine counts no replay:
an engine whose prefill is eager, or one without prefill graphs."""

from portbench import progspans

UNIT = "%"
LAYER = "Prefill (engine._prefill_local, model.llama_forward)"
MOVES = "output_tok_s"
SOURCE = "program_counter"

progspans.hook()      # loaded before the run serves: give the engine its tracer


def read(run):
    s = progspans.summary(run)
    replays = progspans.total(run, "prefill.graph_replays")
    if s is None or replays is None or "prefill" not in s["spans"]:
        return None
    return 100.0 * replays / s["spans"]["prefill"][2]
