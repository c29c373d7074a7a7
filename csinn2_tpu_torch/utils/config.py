"""Runtime configuration & op gating (a copy of csinn2_tpu/utils/config.py).

Re-expression of the reference's config tiers (ref: SURVEY.md §5 — Kconfig
per-op source gating consumed as `#ifndef CONFIG_..._DISABLED` in setup.c,
CMake target flags, runtime session fields): one process-wide Config with
env-var initialization.  `disable("conv2d@int8_sym")` is the analog of
CONFIG_THEAD_RVV_CONV2D_INT8_DISABLED and forces dispatch down the fallback
chain (fast path → generic).

Env vars:
  CSINN_TPU_DISABLE_OPS   comma list of op or op@scheme keys to gate off
  CSINN_TPU_USE_PALLAS    0/1 force the hand-written kernels on or off
  CSINN_TPU_DEBUG         DEBUG|INFO|WARNING|ERROR|FATAL (logging level)
"""

from __future__ import annotations

import os
from typing import Optional, Set


class Config:
    def __init__(self):
        self.disabled_ops: Set[str] = set(
            s.strip() for s in os.environ.get("CSINN_TPU_DISABLE_OPS", "").split(",")
            if s.strip())
        up = os.environ.get("CSINN_TPU_USE_PALLAS")
        self.use_pallas: Optional[bool] = None if up is None else up == "1"

    def disable(self, key: str):
        """Gate off an op ('conv2d') or op@scheme ('conv2d@int8_sym')."""
        self.disabled_ops.add(key)

    def enable(self, key: str):
        self.disabled_ops.discard(key)

    def is_disabled(self, op: str, scheme_value: Optional[str] = None) -> bool:
        if op in self.disabled_ops:
            return True
        return scheme_value is not None and f"{op}@{scheme_value}" in self.disabled_ops


config = Config()
