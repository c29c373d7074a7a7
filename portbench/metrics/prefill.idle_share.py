"""The device's idle share inside the engine's own "prefill" spans (its
Tracer, on the host clock the device trace is tied to): the idle seconds
in them over their seconds, over the traced segment.  Its children's idle
time is on run.py's stderr line ("program spans")."""

from portbench import progspans

UNIT = "%"
LAYER = "Prefill (engine._prefill_local, model.llama_forward)"
MOVES = "output_tok_s"
SOURCE = "device_trace"

progspans.hook()      # loaded before the run serves: give the engine its tracer


def read(run):
    return progspans.idle_share(run, "prefill")
