"""Op dispatch registry: (op, scheme, api) → implementation (counterpart of
csinn2_tpu/ops/registry.py).

Re-expression of the reference's callback-table dispatch (ref:
shl_op_callback_map / shl_cb_func_table, source/nn2/setup.c:97-124, and the
per-target chains like rvm→rvv→ref, source/thead_rvv/setup.c:43-57): a
hand-written CUDA kernel if one is registered and its `caps` accept the
shapes, else the plain PyTorch implementation.

All implementations are functional: f(inputs, params) → tensors.  The
quantized wrapping (dequant→f32→requant) happens in ops/api.py.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

from csinn2_tpu_torch.core.dtypes import Api, QuantScheme


@dataclasses.dataclass
class OpCallback:
    """(ref: struct csinn_callback {init, est, exec, caps, perf},
    csinn_data_structure.h:557-563)."""

    exec: Callable
    init: Optional[Callable] = None       # weight prepack: params → params'
    caps: Optional[Callable] = None       # (metas, params, device) → bool: is this kernel applicable?
    api: Api = Api.TORCH
    name: str = ""
    quant_direct: bool = False            # consumes integer carriers + qinfos directly


class OpRegistry:
    def __init__(self):
        # op → {api → OpCallback}; scheme-specific overrides op+"@"+scheme
        self._table: Dict[str, Dict[Api, OpCallback]] = {}

    def register(self, op: str, fn: Callable = None, *, api: Api = Api.TORCH,
                 scheme: Optional[QuantScheme] = None, init: Callable = None,
                 caps: Callable = None, quant_direct: bool = False):
        """Register an implementation; usable as decorator."""
        def do(fn):
            key = f"{op}@{scheme.value}" if scheme else op
            self._table.setdefault(key, {})[api] = OpCallback(
                exec=fn, init=init, caps=caps, api=api,
                name=f"{key}:{api.value}", quant_direct=quant_direct)
            return fn
        return do(fn) if fn is not None else do

    def lookup(self, op: str, scheme: Optional[QuantScheme] = None,
               api: Api = Api.AUTO, metas=None, params=None, device=None) -> OpCallback:
        """Resolve with the fallback chain CUDA → TORCH (the rvv→ref analog).

        AUTO prefers the CUDA kernel when its `caps` accepts the shapes on
        `device`, the device the op runs on (the JAX package asks whether
        its default backend is a TPU).
        Config-gated keys (the Kconfig CONFIG_*_DISABLED analog) are skipped,
        forcing the fallback chain."""
        from csinn2_tpu_torch.utils.config import config
        cands = {}
        if scheme is not None and not config.is_disabled(op, scheme.value):
            cands.update(self._table.get(f"{op}@{scheme.value}", {}))
        base = self._table.get(op, {})
        for k, v in base.items():
            cands.setdefault(k, v)
        if not cands:
            raise NotImplementedError(f"op '{op}' has no registered implementation")
        if api in (Api.CUDA, Api.TORCH, Api.REF):
            if api in cands:
                return cands[api]
            if api == Api.CUDA and Api.TORCH in cands:
                return cands[Api.TORCH]   # fallback chain
            if Api.REF in cands and api != Api.CUDA:
                return cands[Api.REF]
            raise NotImplementedError(f"op '{op}' has no {api.value} implementation")
        # AUTO
        cu = cands.get(Api.CUDA)
        if cu is not None:
            if cu.caps is None or cu.caps(metas, params, device):
                return cu
        return cands.get(Api.TORCH) or cands.get(Api.REF) or cu

    def ops(self):
        return sorted({k.split("@")[0] for k in self._table})

    def has(self, op: str) -> bool:
        return op in self._table or any(k.startswith(op + "@") for k in self._table)


registry = OpRegistry()
