"""Bucket padding: the engine's prefill.pad_tokens over prefill.tokens +
prefill.pad_tokens, over the traced segment's prefills (the forward runs
on the whole bucket)."""

from portbench import progspans

UNIT = "%"
LAYER = "Prefill (engine._prefill_local, model.llama_forward)"
MOVES = "ttft_p95_ms"
SOURCE = "program_counter"

progspans.hook()      # loaded before the run serves: give the engine its tracer


def read(run):
    pad, real = progspans.total(run, "prefill.pad_tokens"), progspans.total(run, "prefill.tokens")
    if pad is None or real is None or pad + real <= 0:
        return None
    return 100.0 * pad / (pad + real)
