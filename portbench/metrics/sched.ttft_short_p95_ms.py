"""95th percentile of first-token time − send time over the window's
requests, in cells whose short prompts make the eager prefill host-paced:
there the tail is the scheduler's stacking of admissions, a layer metric."""

from portbench.stats import percentile, ttfts_ms

UNIT = "ms"
LAYER = "Scheduler (llm/engine.py run_queue)"
MOVES = "output_tok_s"
SOURCE = "program_span"


def read(run):
    return percentile(ttfts_ms(run.rec), 95)
