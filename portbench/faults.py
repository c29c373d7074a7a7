"""Faults planted under the timed path, for the tests and for calibrate.py's
readings at a cell's own size: each wraps the port's batched decode step,
so a run with one planted serves wrong tokens and its output check has to
come out false.  The benchmark's own runs plant none.

The step wrapped is the one the cell's driver names in its module
attribute DECODE_STEP, (module, function name): for drivers/llm_serve.py
`csinn2_tpu_torch.llm.engine._batched_decode_forward`, which the eager
step and the captured step graph both call.  A driver that names none
cannot have a fault planted.  A step takes its cache as its third
argument (or as `cache=`) and returns the logits, [batch, ...], first.
"""

from __future__ import annotations

import importlib


def _tensors(cache) -> dict:
    """Every attribute of the cache object that is a tensor, by name."""
    import torch
    found = {n: t for n, t in vars(cache).items() if isinstance(t, torch.Tensor)}
    if not found:
        raise TypeError(f"{type(cache).__name__} has no tensor attribute to hold unchanged")
    return found


def state_unchanged(orig):
    """A decode step that leaves its state (every tensor of the cache) as
    it found it."""
    def step(*args, **kw):
        cache = kw["cache"] if "cache" in kw else args[2]
        saved = {n: t.clone() for n, t in _tensors(cache).items()}
        out = orig(*args, **kw)
        for n, t in saved.items():
            getattr(cache, n).copy_(t)
        return out
    return step


def half_batch(orig):
    """The upper half of the lanes left out: they get the lower half's
    logits."""
    def step(*args, **kw):
        import torch
        logits, *rest = orig(*args, **kw)
        h = logits.shape[0] // 2
        return (torch.cat([logits[:h], logits[:logits.shape[0] - h]]), *rest)
    return step


FAULTS = {"state_unchanged": state_unchanged, "half_batch": half_batch}


def plant(name: str, driver):
    """Plant the named fault in the step that `driver` (a driver module)
    names in DECODE_STEP; returns a call that takes it out again."""
    step = getattr(driver, "DECODE_STEP", None)
    if step is None:
        raise ValueError(f"{getattr(driver, '__name__', driver)} names no DECODE_STEP "
                         f"to plant {name} in")
    mod_name, fn = step
    mod = importlib.import_module(mod_name)
    orig = getattr(mod, fn)
    setattr(mod, fn, FAULTS[name](orig))

    def undo():
        setattr(mod, fn, orig)
    return undo
