"""Heterogeneous subgraph partitioner + hybrid executor (counterpart of
csinn2_tpu/graph/partition.py).

Re-expression of the reference's CPU↔NPU subgraph offload
(ref: source/graph_ref/subgraph.c — shl_subgraph_establish :44-110,
shl_subgraph_fvisit_fuse :956, shl_subgraph_generate :1252,
shl_subgraph_topology_sort :1332, shl_subgraph_rebuild :1346; run mode
CSINN_RM_CPU_BASE_HYBRID, csinn_data_structure.h:122).

The two logical devices are the session's device ("accel", the card unless
the session was made with device="cpu") and the host CPU ("host", always
torch.device("cpu")).  `partition` and `_finalize` are the JAX package's
graph logic unchanged.  The executor replays each subgraph eagerly on its
device; its constants are placed there once, at set-up, and the cut-edge
tensors move between devices with `.to(device)`.

Fusion criterion (acyclicity): walking nodes in topological record order, a
node may join the *latest* subgraph of its device iff none of its producers
live in a later subgraph — otherwise it opens a new subgraph.  This keeps
plain list order a valid subgraph topological order (the reference re-sorts
explicitly in shl_subgraph_topology_sort; our record order already is one).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch

from csinn2_tpu_torch.core.tensor import Tensor, place_block
from csinn2_tpu_torch.graph.ir import Graph, Node, _const_key
from csinn2_tpu_torch.utils import logging as log

# Ops that default to host placement when the session doesn't say otherwise —
# data-dependent control flow / effectively-scalar work that a host core runs
# with far less overhead (the analog of ops an NPU rejects via `caps`,
# falling back to the CPU base graph).
DEFAULT_HOST_OPS = frozenset({"non_max_suppression", "proposal", "shape"})


@dataclasses.dataclass
class Subgraph:
    """One fused same-device region (ref: CSINN_SUBGRAPH node, subgraph.c:44)."""

    device: str
    nodes: List[Node] = dataclasses.field(default_factory=list)
    # resolved at finalize():
    ext_inputs: List[Tensor] = dataclasses.field(default_factory=list)
    outputs: List[Tensor] = dataclasses.field(default_factory=list)
    const_keys: List[str] = dataclasses.field(default_factory=list)
    # placed by HybridExecutor: const key → tensor (or block pair) on the device
    consts: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def __repr__(self):
        return (f"Subgraph({self.device}, {len(self.nodes)} nodes, "
                f"{len(self.ext_inputs)}→{len(self.outputs)})")


def partition(graph: Graph, device_of: Optional[Callable[[Node], str]] = None
              ) -> List[Subgraph]:
    """Fuse same-device node runs into subgraphs (ref: shl_subgraph_establish).

    Returns subgraphs in a valid topological execution order.
    """
    if device_of is None:
        def device_of(n: Node) -> str:
            if n.device and n.device != "accel":
                return n.device
            return "host" if n.op in DEFAULT_HOST_OPS else "accel"

    subgraphs: List[Subgraph] = []
    producer_sub: Dict[int, int] = {}   # id(tensor) -> producing subgraph index

    for node in graph.nodes:
        dev = device_of(node)
        latest_same = next((i for i in range(len(subgraphs) - 1, -1, -1)
                            if subgraphs[i].device == dev), None)
        max_producer = max((producer_sub[id(t)] for t in node.inputs
                            if isinstance(t, Tensor) and id(t) in producer_sub),
                           default=-1)
        if latest_same is not None and latest_same >= max_producer:
            si = latest_same
        else:
            subgraphs.append(Subgraph(device=dev))
            si = len(subgraphs) - 1
        subgraphs[si].nodes.append(node)
        for t in node.outputs:
            producer_sub[id(t)] = si

    _finalize(graph, subgraphs, producer_sub)
    return subgraphs


def _finalize(graph: Graph, subgraphs: List[Subgraph],
              producer_sub: Dict[int, int]):
    """Resolve each subgraph's cut edges (ext inputs / exported outputs) and
    constant keys (ref: subgraph input/output rewiring, shl_subgraph_rebuild)."""
    input_ids = {id(t) for t in graph.inputs}
    output_ids = {id(t) for t in graph.outputs}

    for si, sg in enumerate(subgraphs):
        local_produced = {id(t) for n in sg.nodes for t in n.outputs}
        seen_in: Dict[int, Tensor] = {}
        const_keys: List[str] = []
        for node in sg.nodes:
            for t in node.inputs:
                if not isinstance(t, Tensor) or id(t) in local_produced:
                    continue
                if id(t) in input_ids or id(t) in producer_sub:
                    seen_in.setdefault(id(t), t)
                elif t.data is not None:
                    key = _const_key(t)
                    if key not in const_keys:
                        const_keys.append(key)
        sg.ext_inputs = list(seen_in.values())
        sg.const_keys = const_keys

        # outputs: produced here and consumed by a later subgraph or the graph
        consumed_later = {id(t)
                          for sj in range(len(subgraphs)) if sj != si
                          for n in subgraphs[sj].nodes
                          for t in n.inputs if isinstance(t, Tensor)}
        sg.outputs = [t for n in sg.nodes for t in n.outputs
                      if id(t) in consumed_later or id(t) in output_ids]


def _place(value, device: torch.device):
    """A constant on `device`: a block (values, scales) pair by place_block
    (scales as f32), a tensor by .to (no copy when it is there already)."""
    return place_block(value, device) if isinstance(value, tuple) else value.to(device)


class HybridExecutor:
    """Place and run a partitioned graph (ref: hybrid base-graph execution,
    CSINN_RM_CPU_BASE_HYBRID; per-NPU-subgraph sessions in shl_subgraph_setup).

    `consts` maps const key → tensor (the session's copies on its device).
    Each subgraph holds its own constants on its device, placed here once;
    `run` replays each subgraph's nodes eagerly there, moving cut-edge
    tensors across the boundary with `.to(device)` (the PCIe-transfer
    analog)."""

    def __init__(self, graph: Graph, consts: Dict[str, Any], device,
                 device_of: Optional[Callable[[Node], str]] = None):
        self.graph = graph
        self.subgraphs = partition(graph, device_of)
        self._devices = _resolve_devices(device)
        for sg in self.subgraphs:
            dev = self._devices[sg.device]
            sg.consts = {k: _place(consts[k], dev) for k in sg.const_keys}
        log.info("hybrid: %d subgraphs: %s", len(self.subgraphs),
                 ", ".join(repr(s) for s in self.subgraphs))

    def update_const(self, key: str, value):
        """Re-place a swapped constant in every subgraph that reads it."""
        for sg in self.subgraphs:
            if key in sg.consts:
                sg.consts[key] = _place(value, self._devices[sg.device])

    def run_subgraph(self, sg: Subgraph, env: Dict[int, Any]):
        """Replay one subgraph on its device: its external inputs are read
        from `env` (id(tensor) → tensor) and moved there, its outputs are
        written back into `env`."""
        dev = self._devices[sg.device]
        local: Dict[int, Any] = {id(t): env[id(t)].to(dev) for t in sg.ext_inputs}

        def lookup(t: Tensor):
            if id(t) in local:
                return local[id(t)]
            key = _const_key(t)
            if key in sg.consts:
                return sg.consts[key]
            if t.data is not None:
                return t.data
            raise KeyError(f"unbound tensor {t} in {sg!r}")

        for node in sg.nodes:
            args = [lookup(t) if isinstance(t, Tensor) else t for t in node.inputs]
            result = node.exec_fn(args)
            if not isinstance(result, (tuple, list)):
                result = (result,)
            for t, r in zip(node.outputs, result):
                local[id(t)] = r
        for t in sg.outputs:
            env[id(t)] = local[id(t)]

    def run(self, input_arrays: Sequence) -> tuple:
        env: Dict[int, Any] = {id(t): a for t, a in zip(self.graph.inputs, input_arrays)}
        for sg in self.subgraphs:
            self.run_subgraph(sg, env)
        return tuple(env[id(t)] for t in self.graph.outputs)


def _resolve_devices(device) -> Dict[str, torch.device]:
    """The two logical devices: "accel" is the session's device, "host" the
    CPU.  Both are the CPU only when the session itself was made with
    device="cpu" (the partition and transfer logic still runs, as in the
    tests); nothing here falls back to the CPU for want of a card."""
    return {"host": torch.device("cpu"), "accel": torch.device(device)}
