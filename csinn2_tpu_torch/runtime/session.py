"""Session: the user-facing runtime object (counterpart of
csinn2_tpu/runtime/session.py; GRAPH and LAYER modes.  HYBRID mode, the
profiler levels, dump_outputs, run_layer_benchmark and update_const are
ROADMAP queue A item 12).

Re-expression of the csinn session API (ref: include/csinn/csinn_runtime.h:
165-340; impl source/nn2/setup.c:153-560):

    sess = Session(run_mode=RunMode.GRAPH, device="cuda")
    with sess.build():                      # ≈ csinn_session_init + est hooks
        x = sess.input(TensorMeta(...))
        y = ops.conv2d(x, w, b, params)
        sess.set_output(y)
    sess.setup()                            # ≈ csinn_session_setup
    out = sess.run(x_data)                  # ≈ csinn_update_input + session_run

`setup()` fuses (graph/fuse.py), checks the order, and moves every constant
to the session's device once.  Inputs keep their carriers (a u8 scheme's
uint8 input goes in as uint8); `compute_dtype` is the float type of the
generic dequant→op→requant path (bf16 for the FLOAT16/BFLOAT16 schemes'
model sessions, as in the JAX package).  The JAX package then compiles the node list
with jax.jit; here `run()` replays it eagerly, each node launching its
PyTorch ops or CUDA kernel on the device.
"""

from __future__ import annotations

import contextlib
import statistics
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from csinn2_tpu_torch.core.dtypes import Api, ProfilerLevel, RunMode
from csinn2_tpu_torch.core.tensor import Tensor, TensorMeta, place_block
from csinn2_tpu_torch.graph.ir import Graph, Node
from csinn2_tpu_torch.utils import logging as log
from csinn2_tpu_torch.utils.device import resolve_device

_session_stack: List["Session"] = []


def current_session() -> Optional["Session"]:
    return _session_stack[-1] if _session_stack else None


class Session:
    def __init__(self, run_mode: RunMode = RunMode.GRAPH, api: Api = Api.AUTO,
                 compute_dtype=torch.float32,
                 profiler_level: ProfilerLevel = ProfilerLevel.UNSET,
                 name: str = "sess", device="cuda"):
        if run_mode == RunMode.HYBRID:
            raise NotImplementedError("RunMode.HYBRID (host/device partitioning) is not "
                                      "ported yet (ROADMAP queue A item 12)")
        if profiler_level != ProfilerLevel.UNSET:
            raise NotImplementedError("session profiler levels are not ported yet "
                                      "(ROADMAP queue A item 12)")
        self.device = resolve_device(device)
        self.run_mode = run_mode
        self.api = api
        self.compute_dtype = compute_dtype
        self.profiler_level = profiler_level
        self.name = name
        self.graph = Graph()
        self._consts: Dict[str, Any] = {}
        self._setup_done = False

    # -- build phase ---------------------------------------------------------

    @contextlib.contextmanager
    def build(self):
        """Graph-recording scope: op API calls inside are intercepted
        (the `est` hook analog, ref: csinn_data_structure.h:560)."""
        _session_stack.append(self)
        try:
            yield self
        finally:
            _session_stack.pop()

    def input(self, meta: TensorMeta) -> Tensor:
        """(ref: csinn_set_input / csinn_set_tensor_entry, setup.c:524)."""
        t = Tensor(meta=meta, producer=None)
        self.graph.inputs.append(t)
        return t

    def set_output(self, *tensors: Tensor):
        """(ref: csinn_set_output)."""
        self.graph.outputs.extend(tensors)

    def record(self, node: Node):
        self.graph.add_node(node)

    @property
    def recording(self) -> bool:
        return self.run_mode == RunMode.GRAPH and not self._setup_done

    # -- setup -----------------------------------------------------------------

    def setup(self):
        """Fuse, check and place the recorded graph
        (ref: csinn_session_setup → shl_gref_session_setup, setup.c:688)."""
        t0 = time.perf_counter()
        if self.run_mode == RunMode.GRAPH:
            # conv-pair fusion (ref: the partitioner-level fusion
            # shl_subgraph_fvisit_fuse, source/graph_ref/subgraph.c:956)
            from csinn2_tpu_torch.graph.fuse import fuse_ds_blocks
            n_fused = fuse_ds_blocks(self.graph)
            if n_fused:
                log.info("%s: fused %d depthwise→pointwise pairs", self.name, n_fused)
        self.graph.topo_check()
        # a block weight's (values, scales) pair moves once, scales as f32
        self._consts = {k: place_block(v, self.device) if isinstance(v, tuple)
                        else v.to(self.device)
                        for k, v in self.graph.collect_consts().items()}
        self._setup_done = True
        log.info("%s: setup %d nodes on %s in %.1f ms", self.name, len(self.graph.nodes),
                 self.device, (time.perf_counter() - t0) * 1e3)
        return self

    # -- run -------------------------------------------------------------------

    def _inputs(self, input_arrays) -> List[torch.Tensor]:
        out = []
        for a in input_arrays:
            a = a.data if isinstance(a, Tensor) else a
            if not isinstance(a, torch.Tensor):
                a = torch.from_numpy(np.array(a))
            out.append(a.to(self.device))
        return out

    def run(self, *input_arrays, unwrap: bool = True):
        """(ref: csinn_session_run, setup.c:493).  Outputs are tensors on the
        session's device."""
        assert self._setup_done, "call setup() first"
        with torch.inference_mode():
            out = self.graph.execute(self._inputs(input_arrays), self._consts)
        if unwrap and len(out) == 1:
            return out[0]
        return out

    def run_benchmark(self, *input_arrays, iters: int = 10, warmup: int = 3) -> float:
        """Host-clock seconds per run over `iters` runs, each ending in a
        device synchronize (ref: session-verb wall-clock, setup.c:471-507)."""
        arrays = self._inputs(input_arrays)
        for _ in range(warmup):
            self.run(*arrays)
        self._sync()
        t0 = time.perf_counter()
        for _ in range(iters):
            self.run(*arrays)
            self._sync()
        return (time.perf_counter() - t0) / iters

    def run_benchmark_device(self, *input_arrays, iters: int = 50,
                             reps: int = 3) -> float:
        """Seconds per run on the card: CUDA events around `iters`
        back-to-back runs, median of `reps` (host launch gaps between the
        runs' kernels included, as a caller sees them).  Raises off the card:
        a device time is never taken from the host."""
        if self.device.type != "cuda":
            raise RuntimeError("run_benchmark_device needs a session on a CUDA device")
        arrays = self._inputs(input_arrays)
        for _ in range(2):
            self.run(*arrays)
        torch.cuda.synchronize(self.device)
        times = []
        for _ in range(reps):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(iters):
                self.run(*arrays)
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b) / 1e3 / iters)
        return statistics.median(times)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
