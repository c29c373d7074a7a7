"""A freed lane's mean wait, in the engine's run_queue, from the end of
the chunk that freed it to the start of the next request's prefill in it
(sched.lane_wait_ns over sched.lane_waits): the prefills stacked ahead of
it.  Over the traced segment's admissions whose lane was freed inside it."""

from portbench import progspans

UNIT = "ms"
LAYER = "Scheduler (llm/engine.py run_queue)"
MOVES = "output_tok_s"
SOURCE = "program_counter"

progspans.hook()      # loaded before the run serves: give the engine its tracer


def read(run):
    wait, n = progspans.total(run, "sched.lane_wait_ns"), progspans.total(run, "sched.lane_waits")
    if wait is None or not n:
        return None
    return wait / n / 1e6
