"""Weights carried across from the JAX package: a params tree of numpy arrays
→ the port's params dict.

The tree is what `jax.tree_util.tree_map(np.asarray, params)` gives for the
JAX package's params: dicts and lists, numpy arrays, and weight leaves with
`.values/.scales/.mode/.packed/.layout` attributes (read by duck typing —
this module imports neither JAX nor the JAX package).  Packed int4 bytes
and the swiglu128 layout cross as they are.  JAX's bfloat16 arrays
arrive as numpy arrays of the ml_dtypes bfloat16 dtype, which
`torch.from_numpy` rejects: they cross as their uint16 bit patterns and are
viewed as torch.bfloat16 on the other side, bit for bit.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from csinn2_tpu_torch.llm.model import QWeight
from csinn2_tpu_torch.utils.device import resolve_device


def tensor_from_numpy(a, device) -> torch.Tensor:
    """numpy array (bfloat16 included) → tensor on `device`, bit-exact."""
    # writable + C-contiguous (copies only arrays that are not: JAX hands
    # out read-only views, which torch.from_numpy warns about)
    a = np.require(np.asarray(a), requirements=["C", "W"])
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device)


def params_from_numpy(tree: Any, device="cuda") -> Any:
    """Convert a numpy params tree into the port's params (QWeight leaves,
    tensors on `device`)."""
    dev = resolve_device(device)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(conv(v) for v in node)
        if hasattr(node, "values") and hasattr(node, "mode"):
            return QWeight(
                values=tensor_from_numpy(node.values, dev),
                scales=None if node.scales is None
                else tensor_from_numpy(node.scales, dev),
                mode=node.mode, packed=bool(getattr(node, "packed", False)),
                layout=getattr(node, "layout", "plain"))
        if node is None:
            return None
        return tensor_from_numpy(node, dev)

    return conv(tree)
