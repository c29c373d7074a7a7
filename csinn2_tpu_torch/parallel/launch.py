"""Run one function on every rank of a fresh process group, from one process.

The port's counterpart of the JAX package's virtual CPU mesh (the tests'
8-device host platform) and of the orchestrator in
examples/multihost_dryrun.py: `spawn` starts world_size processes (the
"spawn" start method of torch.multiprocessing), joins them into a process
group that meets through a file in a fresh temporary directory (no TCP
port, so concurrent callers never collide), runs fn(*args) on each and
returns the ranks' results in rank order.

A rank's exception fails the call with that rank's traceback; a rank that
dies without a result fails it too; the join has a hard time limit, after
which every rank still running is killed and the call raises TimeoutError.
Results cross by pickle: return numpy arrays and Python values, not tensors.
"""

from __future__ import annotations

import os
import queue as queue_mod
import tempfile
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.multiprocessing as mp


def _rank_main(rank, fn, args, world_size, local_world_size, init_method, backend, device,
               timeout_s, results):
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world_size),
                      LOCAL_RANK=str(rank % local_world_size),
                      LOCAL_WORLD_SIZE=str(local_world_size))
    import torch.distributed as dist
    from csinn2_tpu_torch.parallel.mesh import init_distributed
    if str(device) == "cpu":
        torch.set_num_threads(1)       # the ranks share the host's cores
    try:
        init_distributed(init_method, world_size, rank, backend=backend, device=device,
                         timeout_s=timeout_s)
        out = fn(*args)
    except BaseException:                # noqa: B036 — reported, then the rank exits 1
        results.put((rank, False, traceback.format_exc()))
        raise SystemExit(1)
    results.put((rank, True, out))
    dist.destroy_process_group()


def spawn(fn: Callable[..., Any], world_size: int, *, backend: Optional[str] = None,
          device="cuda", timeout_s: float = 300.0, args: Sequence = (),
          local_world_size: Optional[int] = None) -> List[Any]:
    """fn(*args) on world_size ranks → their results, rank order.

    fn must be importable by name (a module-level function).  backend: as
    init_distributed (NCCL on cuda, gloo on cpu by default).
    local_world_size: ranks a "host" (LOCAL_WORLD_SIZE and LOCAL_RANK of the
    ranks; default all of them), for make_multihost_mesh."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    local = local_world_size or world_size
    with tempfile.TemporaryDirectory(prefix="csinn2_rdzv_") as td:
        init_method = "file://" + os.path.join(td, "store")
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(r, fn, tuple(args), world_size, local, init_method,
                                   backend, str(device), timeout_s, results))
                 for r in range(world_size)]
        for p in procs:
            p.start()
        got = {}
        deadline = time.monotonic() + timeout_s
        try:
            while len(got) < world_size:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(f"spawn: ranks {sorted(set(range(world_size)) - set(got))} "
                                       f"gave no result within {timeout_s} s")
                try:
                    rank, ok, out = results.get(timeout=min(left, 0.5))
                except queue_mod.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if r not in got and p.exitcode not in (None, 0)]
                    if dead and results.empty():
                        raise RuntimeError(f"spawn: rank {dead[0]} exited with code "
                                           f"{procs[dead[0]].exitcode} and no result")
                    continue
                if not ok:
                    raise RuntimeError(f"spawn: rank {rank} failed:\n{out}")
                got[rank] = out
            for p in procs:
                p.join(timeout=max(deadline - time.monotonic(), 1.0))
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join()
            results.close()
    return [got[r] for r in range(world_size)]
