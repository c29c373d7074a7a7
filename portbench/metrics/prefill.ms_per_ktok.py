"""Host time inside prefill_sample (the forward over the bucket-padded
prompt, the cache writes, the first token's sampling and fetch) per 1000
real prompt tokens, over the window's prefills.  Bucket padding counts as
cost."""

UNIT = "ms/ktok"
LAYER = "Prefill (engine._prefill_local, model.llama_forward)"
MOVES = "ttft_p95_ms"
SOURCE = "program_span"


def read(run):
    spans = run.rec.window_spans("prefill")
    toks = sum(s.n_prompt for s in spans)
    if not toks:
        return None
    return sum(s.t1 - s.t0 for s in spans) * 1e6 / toks
