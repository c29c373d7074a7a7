"""The device's idle share inside the engine's own "decode.chunk" spans
(a chunk: staging, the step graph's replays, the tokens' fetch, the
lanes' commit): the idle seconds in them over their seconds, over the
traced segment."""

from portbench import progspans

UNIT = "%"
LAYER = "Decode step (engine._graph_chunk, _batched_decode_forward)"
MOVES = "output_tok_s"
SOURCE = "device_trace"

progspans.hook()      # loaded before the run serves: give the engine its tracer


def read(run):
    return progspans.idle_share(run, "decode.chunk")
