"""Session: the user-facing runtime object (counterpart of
csinn2_tpu/runtime/session.py; GRAPH, HYBRID and LAYER modes, the profiler
levels, dump / layer benchmark / update_const / export_json).

Re-expression of the csinn session API (ref: include/csinn/csinn_runtime.h:
165-340; impl source/nn2/setup.c:153-560):

    sess = Session(run_mode=RunMode.GRAPH, device="cuda")
    with sess.build():                      # ≈ csinn_session_init + est hooks
        x = sess.input(TensorMeta(...))
        y = ops.conv2d(x, w, b, params)
        sess.set_output(y)
    sess.setup()                            # ≈ csinn_session_setup
    out = sess.run(x_data)                  # ≈ csinn_update_input + session_run

`setup()` fuses (graph/fuse.py, GRAPH mode only, as in the JAX package),
checks the order, and moves every constant to the session's device once.
Inputs keep their carriers (a u8 scheme's uint8 input goes in as uint8);
`compute_dtype` is the float type of the generic dequant→op→requant path
(bf16 for the FLOAT16/BFLOAT16 schemes' model sessions, as in the JAX
package).  The JAX package then compiles the node list with jax.jit; here
`run()` replays it eagerly, each node launching its PyTorch ops or CUDA
kernel on the device.  A HYBRID session partitions the graph
(graph/partition.py): nodes recorded under `device_scope("host")` (and
the partitioner's default host ops) run on the CPU, the rest on the
session's device, each subgraph replayed eagerly on its own device.
"""

from __future__ import annotations

import contextlib
import os
import statistics
import tempfile
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
        self.device = resolve_device(device)
        self.run_mode = run_mode
        self.api = api
        self.compute_dtype = compute_dtype
        self.profiler_level = profiler_level
        self.name = name
        self.graph = Graph()
        self._consts: Dict[str, Any] = {}
        self._setup_done = False
        self.trace = None           # runtime/profiler.py Tracer at the TRACE / ALL levels
        self.layer_times: Dict[str, float] = {}   # run_layer_benchmark's last result
        self._hybrid = None         # graph/partition.py HybridExecutor (HYBRID)
        self._current_device = "accel"   # stamp for recorded nodes
        if profiler_level in (ProfilerLevel.TRACE, ProfilerLevel.ALL):
            from csinn2_tpu_torch.runtime.profiler import Tracer
            self.trace = Tracer(session_name=name)

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

    @contextlib.contextmanager
    def device_scope(self, device: str):
        """Place ops recorded inside on `device` ("accel" | "host") — the
        per-node device tag driving HYBRID partitioning (ref: node-device
        assignment consumed by shl_subgraph_get_device, subgraph.c:791)."""
        prev, self._current_device = self._current_device, device
        try:
            yield
        finally:
            self._current_device = prev

    @property
    def record_device(self) -> torch.device:
        """The device whose op tier a node recorded now takes: the CPU for
        a node a HYBRID session places on the host, else the session's."""
        if self.run_mode == RunMode.HYBRID and self._current_device == "host":
            return torch.device("cpu")
        return self.device

    def record(self, node: Node):
        node.device = self._current_device
        self.graph.add_node(node)

    @property
    def recording(self) -> bool:
        return self.run_mode in (RunMode.GRAPH, RunMode.HYBRID) and not self._setup_done

    # -- setup -----------------------------------------------------------------

    def setup(self):
        """Fuse (GRAPH mode), check and place the recorded graph
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
        if self.run_mode == RunMode.HYBRID:
            # host/device partitioned execution (ref: CSINN_RM_CPU_BASE_HYBRID
            # + shl_subgraph_establish, source/graph_ref/subgraph.c:44)
            from csinn2_tpu_torch.graph.partition import HybridExecutor
            self._hybrid = HybridExecutor(self.graph, self._consts, self.device)
            log.info("%s: hybrid setup, %d subgraphs", self.name,
                     len(self._hybrid.subgraphs))
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

    def _execute(self, arrays):
        if self._hybrid is not None:
            return self._hybrid.run(arrays)
        return self.graph.execute(arrays, self._consts)

    def run(self, *input_arrays, unwrap: bool = True):
        """(ref: csinn_session_run, setup.c:493).  Outputs are tensors on the
        session's device (a HYBRID graph output made on the host stays on
        the CPU).  At the TRACE / ALL profiler levels the run is one
        "session_run" event of self.trace, the device synchronized inside
        it."""
        assert self._setup_done, "call setup() first"
        with torch.inference_mode():
            if self.trace is not None:
                with self.trace.event("session_run", cat="runtime"):
                    out = self._execute(self._inputs(input_arrays))
                    self._sync()
            else:
                out = self._execute(self._inputs(input_arrays))
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
        a device time is never taken from the host.

        A HYBRID session is timed the same way, by events around whole
        runs, where the JAX package falls back to the host clock: a host
        subgraph's cut-edge copies and CPU work sit between the card's
        kernels of one run, so the events on the card's stream span them,
        and the time is the run's as a caller sees it."""
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

    # -- profiler levels -------------------------------------------------------

    def dump_outputs(self, *input_arrays, out_dir: Optional[str] = None) -> Dict[str, tuple]:
        """Per-layer output dump — the DUMP profiler level (ref:
        shl_dump_output_tensor invoked per node under
        CSINN_PROFILER_LEVEL_DUMP, source/graph_ref/setup.c:1358-1372).
        Writes one .npy per node output, `<index>_<node name>_out<j>.npy`,
        into out_dir (default: csinn2_tpu_torch_dump under the temp
        directory); returns {filename: shape}.  numpy has no bfloat16, so a
        bf16 output is written as f32 (the JAX package writes ml_dtypes'
        bfloat16): the same values in a wider dtype."""
        assert self._setup_done, "call setup() first"
        out_dir = out_dir or os.path.join(tempfile.gettempdir(), "csinn2_tpu_torch_dump")
        os.makedirs(out_dir, exist_ok=True)
        index = {id(n): i for i, n in enumerate(self.graph.nodes)}
        written: Dict[str, tuple] = {}

        def tap(node, result):
            outs = result if isinstance(result, (tuple, list)) else (result,)
            for j, v in enumerate(outs):
                v = v.detach().cpu()
                if v.dtype == torch.bfloat16:
                    v = v.float()
                name = f"{index[id(node)]:03d}_{node.name}_out{j}.npy"
                np.save(os.path.join(out_dir, name), v.numpy())
                written[name] = tuple(v.shape)

        with torch.inference_mode():
            self.graph.execute(self._inputs(input_arrays), self._consts, trace_hook=tap)
        return written

    def run_layer_benchmark(self, *input_arrays, iters: int = 5):
        """Per-layer timing report (ref: SHL_LAYER_BENCHMARK timer loop,
        source/graph_ref/setup.c:1333-1357): runtime/profiler.py
        LayerBenchmark, {"<idx> <name>": ms}."""
        from csinn2_tpu_torch.runtime.profiler import LayerBenchmark
        results = LayerBenchmark(self).run(*input_arrays, iters=iters)
        self.layer_times = results
        return results

    def update_const(self, tensor: Tensor, new_data):
        """Swap a weight without re-recording (ref: csinn_update_input
        re-points data, source/graph_ref/setup.c:51-56).  The new data is
        placed on the session's device (and on that of each HYBRID subgraph
        that reads it).

        Also refreshes any '__zp_wsum__' per-channel weight-sum const
        (appended by ops/api._zp_sumw_tensor for integer convs with nonzero
        activation zero-point) in nodes consuming this tensor as a weight —
        otherwise the zp correction would silently keep the OLD weight's sums."""
        from csinn2_tpu_torch.graph.ir import _const_key
        key = _const_key(tensor)
        assert key in self._consts, "tensor is not a bound constant"
        self._set_const(key, new_data)
        self._refresh_zp_wsum(tensor, new_data)

    def _set_const(self, key: str, data):
        value = data if isinstance(data, torch.Tensor) else torch.from_numpy(np.array(data))
        self._consts[key] = value.to(self.device)
        if self._hybrid is not None:
            self._hybrid.update_const(key, self._consts[key])

    def _refresh_zp_wsum(self, tensor: Tensor, new_data):
        from csinn2_tpu_torch.graph.ir import _const_key
        from csinn2_tpu_torch.kernels.qconv import precompute_zp_wsum
        from csinn2_tpu_torch.ops.api import _w_layout
        if isinstance(new_data, torch.Tensor):
            new_data = new_data.detach().cpu().numpy()
        for node in self.graph.nodes:
            if not node.inputs or len(node.inputs) < 2:
                continue
            last = node.inputs[-1]
            if not isinstance(last, Tensor) or \
                    getattr(last.meta, "name", "") != "__zp_wsum__":
                continue
            if any(t is tensor for t in node.inputs[:-1]):
                wsum = precompute_zp_wsum(np.asarray(new_data),
                                          w_layout=_w_layout(node.inputs[1]))
                skey = _const_key(last)
                if skey in self._consts:
                    self._set_const(skey, wsum)

    # -- introspection -------------------------------------------------------

    def export_json(self) -> str:
        """(ref: shl_export_model_json, source/utils/export.c:24)."""
        from csinn2_tpu_torch.runtime.export import graph_to_json
        return graph_to_json(self.graph)