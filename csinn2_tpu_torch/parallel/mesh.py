"""Process mesh on torch.distributed — counterpart of
csinn2_tpu/parallel/mesh.py.

The JAX package runs one controller over every chip and maps a function over
a jax.sharding.Mesh with shard_map.  The port is SPMD over processes, as the
JAX package's multi-controller mode is: one process a rank, one device a
rank, and every rank runs the same host code on its own shards.  Where the
JAX code has psum(x, "tp") the port has all_reduce(x, mesh.tp_group); where
it has all_gather(..., tiled=True), an all_gather concatenated along the same
axis.

A Mesh names its axes outer to inner (dp, tp: rank = dp_idx·tp + tp_idx, the
JAX mesh's reshape(dp, tp), so tp stays on neighbouring ranks), holds this
rank's coordinates, one process group per axis (the ranks that differ only
along it) and this rank's device.

Where the JAX code has lax.ppermute (ring attention's K/V rotation, the SPMD
pipeline's stage-to-stage hop) the port sends point to point: `shift` is one
hop of a ring along an axis, `send` / `recv_into` one link of a chain.
Gloo's send and recv take CPU tensors only, so under gloo these helpers copy
a CUDA tensor into a host buffer, send it, and copy what they receive back to
the card: that copy is the transport of ranks that share a card (and says
so on stderr once a process).  Under NCCL they send the device tensor.
"""

from __future__ import annotations

import datetime
import functools
import math
import os
import sys
from typing import Dict, Optional

import torch
import torch.distributed as dist

from csinn2_tpu_torch.kernels._build import launch_counts
from csinn2_tpu_torch.utils.device import resolve_device


def init_distributed(init_method: Optional[str] = None, world_size: Optional[int] = None,
                     rank: Optional[int] = None, backend: Optional[str] = None,
                     device="cuda", timeout_s: float = 600.0) -> int:
    """Join the process group (idempotent); returns the world size.

    With no init_method and no WORLD_SIZE > 1 in the environment (a single
    process) it stays local and returns 1, as the JAX function does.  The
    backend defaults to NCCL on cuda and gloo on cpu; a caller may ask for
    gloo on cuda, which stages every collective through the host and is how
    several ranks share one card (NCCL refuses two ranks on one device).
    RANK, WORLD_SIZE and LOCAL_RANK come from the environment where not given
    (torchrun sets them)."""
    if dist.is_initialized():
        return dist.get_world_size()
    dev = resolve_device(device)
    world_size = int(os.environ.get("WORLD_SIZE", "1")) if world_size is None else world_size
    if init_method is None and world_size == 1:
        return 1
    rank = int(os.environ.get("RANK", "0")) if rank is None else rank
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if dev.type == "cuda":
        torch.cuda.set_device(_local_device(rank))
        if backend == "gloo":
            print(f"init_distributed: rank {rank} of {world_size} on gloo with CUDA tensors: "
                  "collectives and point-to-point sends are staged through the host",
                  file=sys.stderr, flush=True)
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=world_size, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return world_size


def _local_device(rank: int) -> torch.device:
    """cuda:(local rank % cards): ranks past the card count share cards."""
    local = int(os.environ.get("LOCAL_RANK", str(rank)))
    return torch.device("cuda", local % torch.cuda.device_count())


class Mesh:
    """This rank's place in a mesh of processes.

    axes: {name: size}, outer to inner; their product is the world size.
    `shape` is that dict, `coords` this rank's index along each axis,
    `group(name)` the process group of the ranks that share every other
    coordinate (None where the axis has size 1: nothing to reduce), and
    `device` this rank's device."""

    def __init__(self, axes: Dict[str, int], device="cuda"):
        self.shape = dict(axes)
        world = dist.get_world_size() if dist.is_initialized() else 1
        self.rank = dist.get_rank() if dist.is_initialized() else 0
        if math.prod(self.shape.values()) != world:
            raise ValueError(f"mesh {self.shape} does not cover the world of {world} ranks")
        dev = resolve_device(device)
        self.device = _local_device(self.rank) if dev.type == "cuda" else dev
        names = list(self.shape)
        self.coords = {}
        rem = self.rank
        for name in reversed(names):
            self.coords[name] = rem % self.shape[name]
            rem //= self.shape[name]
        self.coords = {n: self.coords[n] for n in names}
        self._groups = {}
        # every rank builds every group, in one order (dist.new_group is
        # collective over the world), and keeps the one it belongs to
        for name in names:
            if self.shape[name] == 1:
                self._groups[name] = None
                continue
            for ranks in self._axis_groups(name):
                g = dist.new_group(ranks)
                if self.rank in ranks:
                    self._groups[name] = g

    def _axis_groups(self, name):
        """The rank lists along `name`, one for each setting of the others."""
        names = list(self.shape)
        sizes = [self.shape[n] for n in names]
        strides = [math.prod(sizes[i + 1:]) for i in range(len(names))]
        k = names.index(name)
        others = [i for i in range(len(names)) if i != k]
        out = []
        for flat in range(math.prod(sizes[i] for i in others)):
            base, rem = 0, flat
            for i in reversed(others):
                base += (rem % sizes[i]) * strides[i]
                rem //= sizes[i]
            out.append([base + j * strides[k] for j in range(sizes[k])])
        return out

    def size(self, name: str) -> int:
        return self.shape.get(name, 1)

    def index(self, name: str) -> int:
        return self.coords.get(name, 0)

    def group(self, name: str):
        return self._groups.get(name)

    @property
    def tp_group(self):
        return self.group("tp")

    @property
    def dp_group(self):
        return self.group("dp")

    @property
    def ep_group(self):
        return self.group("ep")

    def backend(self) -> Optional[str]:
        """The process group's backend ("nccl", "gloo"), None for one rank."""
        return dist.get_backend() if dist.is_initialized() else None

    def __repr__(self):
        return f"Mesh({self.shape}, rank {self.rank} at {self.coords}, {self.device})"


def make_mesh(tp: Optional[int] = None, dp: Optional[int] = None, device="cuda") -> Mesh:
    """(dp, tp) mesh over the world (every rank calls it): tp alone → dp =
    world / tp, neither → tp = world."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    if tp is None and dp is None:
        tp, dp = n, 1
    elif tp is None:
        tp = n // dp
    elif dp is None:
        dp = n // tp
    if dp * tp != n:
        raise ValueError(f"dp ({dp}) x tp ({tp}) != world size ({n})")
    return Mesh({"dp": dp, "tp": tp}, device=device)


def make_multihost_mesh(tp: Optional[int] = None, dp: Optional[int] = None,
                        device="cuda") -> Mesh:
    """(dp, tp) mesh over several hosts with tp kept INSIDE a host, so the
    per-layer all_reduces stay on the host's links and only dp's (per step)
    all_gathers cross hosts.  LOCAL_WORLD_SIZE (ranks a host, as torchrun
    sets it) plays the part of the JAX function's local_device_count; ranks
    are numbered host by host.  One host: make_mesh."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    local = int(os.environ.get("LOCAL_WORLD_SIZE", str(n)))
    if n % local:
        raise ValueError(f"world size {n} is not a multiple of LOCAL_WORLD_SIZE {local}")
    nproc = n // local
    if nproc == 1:
        return make_mesh(tp=tp, dp=dp, device=device)
    tp = tp or local
    if tp > local or local % tp:
        raise ValueError(f"tp={tp} must divide the {local} ranks of a host")
    want_dp = nproc * (local // tp)
    if dp not in (None, want_dp):
        raise ValueError(f"dp={dp} != hosts x (ranks a host / tp) = {want_dp}")
    return Mesh({"dp": want_dp, "tp": tp}, device=device)


def all_reduce(x: torch.Tensor, group, tag: str) -> torch.Tensor:
    """Sum x over `group` in x's dtype (the JAX psum); counts
    launch_counts["all_reduce.<tag>"].  No group: x as it is."""
    if group is None:
        return x
    x = x.contiguous()
    dist.all_reduce(x, group=group)
    launch_counts[f"all_reduce.{tag}"] += 1
    return x


def all_gather(x: torch.Tensor, group, dim: int, tag: str) -> torch.Tensor:
    """The group's x concatenated along `dim` in rank order (the JAX
    all_gather(..., tiled=True)); counts launch_counts["all_gather.<tag>"]."""
    if group is None:
        return x
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    launch_counts[f"all_gather.{tag}"] += 1
    return torch.cat(parts, dim=dim)


def broadcast(x: torch.Tensor, group, src: int, tag: str) -> torch.Tensor:
    """x of global rank `src` on every rank of `group` (in place); counts
    launch_counts["broadcast.<tag>"].  No group: x as it is."""
    if group is None:
        return x
    x = x.contiguous()
    dist.broadcast(x, src=src, group=group)
    launch_counts[f"broadcast.{tag}"] += 1
    return x


def neighbour(mesh: Mesh, axis: str, step: int) -> int:
    """The global rank `step` hops from this one along `axis` (a ring: the
    index wraps), every other coordinate the same."""
    coords = dict(mesh.coords)
    coords[axis] = (coords[axis] + step) % mesh.shape[axis]
    rank = 0
    for name, size in mesh.shape.items():
        rank = rank * size + coords[name]
    return rank


def _staged(x: torch.Tensor) -> bool:
    """Gloo and a CUDA tensor: the send goes through a host buffer."""
    if x.device.type != "cuda" or dist.get_backend() != "gloo":
        return False
    _say_staged()
    return True


@functools.lru_cache(maxsize=None)
def _say_staged() -> None:
    print(f"mesh: rank {dist.get_rank()}: gloo sends CPU tensors only: point-to-point sends "
          "of CUDA tensors are copied through host buffers", file=sys.stderr, flush=True)


def shift(x: torch.Tensor, mesh: Mesh, axis: str, step: int, tag: str) -> torch.Tensor:
    """One hop of a ring along `axis` (lax.ppermute with j → j + step): x
    goes to the rank `step` ahead, and the x of the rank `step` behind comes
    back as a new tensor.  The receive is posted before the send and both
    are waited on, so every rank of the ring can call it at once.  Counts
    launch_counts["p2p.<tag>"].  An axis of size 1: x as it is."""
    if mesh.size(axis) == 1:
        return x
    staged = _staged(x)
    out = x.contiguous()
    out = out.cpu() if staged else out
    buf = torch.empty_like(out)
    recv = dist.irecv(buf, src=neighbour(mesh, axis, -step))
    sent = dist.isend(out, dst=neighbour(mesh, axis, step))
    recv.wait()
    sent.wait()
    launch_counts[f"p2p.{tag}"] += 1
    return buf.to(x.device) if staged else buf


def send(x: torch.Tensor, dst: int, tag: str) -> None:
    """x to global rank `dst` (blocking); counts launch_counts["p2p.<tag>"]."""
    out = x.contiguous()
    dist.send(out.cpu() if _staged(out) else out, dst=dst)
    launch_counts[f"p2p.{tag}"] += 1


def recv_into(buf: torch.Tensor, src: int, tag: str) -> torch.Tensor:
    """What global rank `src` sends, written into buf (contiguous; its shape
    and dtype; blocking); counts launch_counts["p2p.<tag>.recv"].  Returns
    buf."""
    tmp = torch.empty(buf.shape, dtype=buf.dtype) if _staged(buf) else buf
    dist.recv(tmp, src=src)
    if tmp is not buf:
        buf.copy_(tmp)
    launch_counts[f"p2p.{tag}.recv"] += 1
    return buf
