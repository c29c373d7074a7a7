"""Graph IR: node list + topological executor (counterpart of
csinn2_tpu/graph/ir.py).

Re-expression of GREF (ref: include/graph/shl_node.h:22-36 — shl_node{type,
in, out, data}; include/shl_utils.h:43-51 — shl_ref_graph; executor
shl_gref_session_run, source/graph_ref/setup.c:1305-1417).  The JAX package
replays the node list once inside jax.jit; this package replays it eagerly
on every run, each node's exec function launching its PyTorch ops or CUDA
kernel on the session's device (a CUDA graph of the replay is later work).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence

from csinn2_tpu_torch.core.tensor import Tensor


@dataclasses.dataclass
class Node:
    """One graph op (ref: struct shl_node, shl_node.h:22-36)."""

    op: str
    inputs: List[Tensor]            # graph edges (symbolic) or constants
    params: Any
    exec_fn: Callable               # (list_of_tensors) -> tensor or tuple of tensors
    outputs: List[Tensor] = dataclasses.field(default_factory=list)
    name: str = ""
    cb_name: str = ""               # resolved kernel name, for trace attribution
    device: str = "accel"           # placement tag for HYBRID partitioning
    structure: Any = None           # how call_op's positional args map onto `inputs`
    extra: Any = None               # kwargs forwarded to the kernel
    out_qinfo: Any = None

    def __repr__(self):
        return f"Node({self.op}:{self.name or id(self) % 9973})"


class Graph:
    """Recorded op graph (ref: struct shl_ref_graph)."""

    def __init__(self):
        self.nodes: List[Node] = []
        self.inputs: List[Tensor] = []
        self.outputs: List[Tensor] = []

    def add_node(self, node: Node):
        self.nodes.append(node)

    # -- execution -----------------------------------------------------------

    def execute(self, input_arrays: Sequence, const_arrays: Dict[str, Any],
                trace_hook: Optional[Callable] = None):
        """Replay the node list.  input_arrays align with self.inputs;
        const_arrays maps const-tensor key → tensor (the session's copies on
        its device)."""
        env: Dict[int, Any] = {}
        for t, arr in zip(self.inputs, input_arrays):
            env[id(t)] = arr

        def lookup(t: Tensor):
            if id(t) in env:
                return env[id(t)]
            key = _const_key(t)
            if key in const_arrays:
                return const_arrays[key]
            if t.data is not None:
                return t.data
            raise KeyError(f"unbound tensor {t}")

        for node in self.nodes:
            args = [lookup(t) if isinstance(t, Tensor) else t for t in node.inputs]
            result = node.exec_fn(args)
            if trace_hook is not None:
                trace_hook(node, result)
            if not isinstance(result, (tuple, list)):
                result = (result,)
            for t, r in zip(node.outputs, result):
                env[id(t)] = r
        return tuple(env[id(t)] for t in self.outputs)

    def collect_consts(self) -> Dict[str, Any]:
        """All constant (data-bearing, non-input) tensors referenced by nodes."""
        consts: Dict[str, Any] = {}
        input_ids = {id(t) for t in self.inputs}
        produced = {id(t) for n in self.nodes for t in n.outputs}
        for node in self.nodes:
            for t in node.inputs:
                if isinstance(t, Tensor) and id(t) not in input_ids \
                        and id(t) not in produced and t.data is not None:
                    consts[_const_key(t)] = t.data
        return consts

    def topo_check(self):
        """Validate producer-before-consumer order (the reference topo-sorts
        in shl_subgraph_topology_sort, source/graph_ref/subgraph.c:1332).
        Raises ValueError naming the offending node and tensor."""
        produced = {id(t) for n in self.nodes for t in n.outputs}
        seen = {id(t) for t in self.inputs}
        for node in self.nodes:
            for t in node.inputs:
                if not isinstance(t, Tensor) or id(t) in seen:
                    continue
                if id(t) in produced:
                    raise ValueError(
                        f"graph not topologically ordered: {node} consumes "
                        f"tensor {t.meta.name or id(t)} before its producer runs")
                if t.data is None:
                    raise ValueError(
                        f"{node} consumes unbound tensor "
                        f"{t.meta.name or id(t)} (no producer, no data)")
            for t in node.outputs:
                seen.add(id(t))
        return True

    def __repr__(self):
        return f"Graph({len(self.nodes)} nodes, {len(self.inputs)} in, {len(self.outputs)} out)"


def _const_key(t: Tensor) -> str:
    return t.meta.const_key or f"c{id(t)}"
