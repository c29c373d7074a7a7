"""CUDA graphs whose kernel launches keep their counts.

The kernel wrappers count their launches in Python (`_build.launch_counts`),
so the launches of a replayed graph would reach no count.  `capture` runs
the step once eagerly on the capture stream first (the warm-up: libraries
loaded, each launcher's first-call attributes set, the capture stream's own
buffers such as the decode GEMM's strip counters made outside the capture),
then captures it and records the launches the capture made, the graph's
tally.  The warm-up's and the capture's launches are taken back out of the
kernels' counts: the warm-up's go to `<name>.warmup`, the captures to
`<name>.capture`.  `CountedGraph.replay` adds the tally once per replay and
counts `<name>.replay`, so a kernel's count reads as it would after the
same steps run eagerly.

Random draws: each generator in `generators` is registered with the graph
(its state restored after the warm-up), so every replay draws the numbers
the eager step would draw next from it.

What the step returns at the capture is the graph's static output
(`CountedGraph.out`): every replay rewrites it in place.
"""

from __future__ import annotations

import collections
from typing import Any, Callable, Sequence

import torch

from csinn2_tpu_torch.kernels._build import launch_counts


class CountedGraph:
    """A captured graph, the kernel launches one replay makes and its static
    output."""

    def __init__(self, graph: "torch.cuda.CUDAGraph", tally: collections.Counter, name: str,
                 out=None):
        self.graph = graph
        self.tally = tally
        self.name = name
        self.out = out

    def replay(self) -> None:
        self.graph.replay()
        launch_counts.update(self.tally)
        launch_counts[f"{self.name}.replay"] += 1


def capture(fn: Callable[[], Any], name: str, *, stream: "torch.cuda.Stream", pool=None,
            generators: Sequence[torch.Generator] = ()) -> CountedGraph:
    """Warm up, then capture fn() on `stream` into a graph that allocates
    from `pool` (graphs that replay one after another may share one).  fn
    works on static tensors only; what the captured call returns is the
    graph's `out`."""
    before = collections.Counter(launch_counts)
    states = [g.get_state() for g in generators]
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()
    for g, state in zip(generators, states):
        g.set_state(state)
    warm = collections.Counter(launch_counts)
    graph = torch.cuda.CUDAGraph()
    for g in generators:
        graph.register_generator_state(g)
    with torch.cuda.graph(graph, pool=pool, stream=stream):
        out = fn()
    torch.cuda.current_stream().wait_stream(stream)
    tally = collections.Counter(launch_counts) - warm
    launch_counts.clear()
    launch_counts.update(before)
    launch_counts[f"{name}.warmup"] += sum((warm - before).values())
    launch_counts[f"{name}.capture"] += 1
    return CountedGraph(graph, tally, name, out)
