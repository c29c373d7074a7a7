"""Faults planted under the timed path, for the tests and for calibrate.py's
readings at a cell's own size: each wraps the port's batched decode step
(`csinn2_tpu_torch.llm.engine._batched_decode_forward`, which the eager
step and the captured step graph both call), so a run with one planted
serves wrong tokens and its output check has to come out false.  The
benchmark's own runs plant none."""

from __future__ import annotations


def state_unchanged(orig):
    """A decode step that leaves its state (the KV cache) as it found it."""
    def step(params, tokens, cache, pos_vec, cfg, **kw):
        k, v = cache.k.clone(), cache.v.clone()
        out = orig(params, tokens, cache, pos_vec, cfg, **kw)
        cache.k.copy_(k)
        cache.v.copy_(v)
        return out
    return step


def half_batch(orig):
    """The upper half of the lanes left out: they get the lower half's
    logits."""
    def step(params, tokens, cache, pos_vec, cfg, **kw):
        import torch
        logits, c = orig(params, tokens, cache, pos_vec, cfg, **kw)
        h = logits.shape[0] // 2
        return torch.cat([logits[:h], logits[:logits.shape[0] - h]]), c
    return step


FAULTS = {"state_unchanged": state_unchanged, "half_batch": half_batch}


def plant(name: str):
    """Plant the named fault in the port's engine module; returns a call
    that takes it out again."""
    from csinn2_tpu_torch.llm import engine
    orig = engine._batched_decode_forward
    engine._batched_decode_forward = FAULTS[name](orig)

    def undo():
        engine._batched_decode_forward = orig
    return undo
