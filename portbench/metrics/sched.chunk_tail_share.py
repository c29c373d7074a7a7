"""Lane-steps run past their request's last token to the end of a chunk
(the engine's decode.lane_steps_past_end) over all lane-steps
(decode.lane_steps), over the traced segment's chunks."""

from portbench import progspans

UNIT = "%"
LAYER = "Scheduler (llm/engine.py run_queue)"
MOVES = "output_tok_s"
SOURCE = "program_counter"

progspans.hook()      # loaded before the run serves: give the engine its tracer


def read(run):
    past = progspans.total(run, "decode.lane_steps_past_end")
    steps = progspans.total(run, "decode.lane_steps")
    if past is None or not steps:
        return None
    return 100.0 * past / steps
