"""Context (sequence) parallelism: ring attention over a mesh axis —
counterpart of csinn2_tpu/parallel/cp.py.

Q/K/V are sharded along the sequence across the ranks of the `cp` axis.
Each ring step runs one online-softmax block of the rank's queries against
the resident K/V shard, then passes K/V one hop along the ring (rank j to
j + 1, mesh.shift: the JAX function's lax.ppermute).  After n steps every
query shard has seen the whole sequence.

Why the signature differs from the JAX function's: that function takes the
GLOBAL [B, H, S, D] arrays and maps `local` over the mesh with shard_map;
the port runs one process a rank, so `ring_attention` takes and returns
THIS rank's shard [B, H, S/n, D], the block at mesh.index(axis).
`shard_sequence` and `gather_sequence` cut a global tensor into that block
and put the blocks back together.

The arithmetic is the JAX function's: q and k in f32, the online-softmax
update of `_flash_block`, acc / max(l, 1e-30) cast back to q's dtype, the
resident block's owner (idx - i) mod n, the causal mask kpos <= qpos.  The
block's two products are plain torch.matmul, as the JAX block's einsums run
outside any Pallas kernel.  The last of the n hops only brings each rank's
own block home again and is never read, so the port leaves it out: a call
shifts K and V n - 1 times each (launch_counts["p2p.cp"] = 2 (n - 1)).
"""

from __future__ import annotations

from typing import Optional

import torch

from csinn2_tpu_torch.parallel.mesh import Mesh, all_gather, shift

_NEG = -1e30


def _flash_block(q, k, v, m, l, acc, qpos, kpos, scale: float, causal: bool):
    """One online-softmax block update.  q: [B, H, Sq, D] f32, k/v: [B, H,
    Sk, D]; m, l: [B, H, Sq]; acc: [B, H, Sq, D] f32."""
    s = torch.matmul(q, k.float().transpose(-1, -2)).mul_(scale)
    if causal:
        s.masked_fill_(kpos[None, :] > qpos[:, None], _NEG)
    m_new = torch.maximum(m, s.amax(dim=-1))
    corr = torch.exp(m - m_new)
    p = s.sub_(m_new[..., None]).exp_()               # s is not read again
    l = l * corr + p.sum(dim=-1)
    acc = acc * corr[..., None] + torch.matmul(p, v.float())
    return m_new, l, acc


def ring_attention(q, k, v, mesh: Mesh, axis: str = "cp", causal: bool = True,
                   scale: Optional[float] = None) -> torch.Tensor:
    """Sequence-sharded attention.  q/k/v: this rank's shards [B, H, S/n, D]
    (block mesh.index(axis) of the sequence); returns this rank's output
    shard [B, H, S/n, D] in q's dtype.  Every rank of the axis calls it."""
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    n, idx = mesh.size(axis), mesh.index(axis)
    b, h, sl, d = q.shape
    pos = torch.arange(sl, device=q.device)
    qpos = idx * sl + pos
    qf = q.float()
    m = torch.full((b, h, sl), _NEG, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, sl), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, h, sl, d), dtype=torch.float32, device=q.device)
    kb, vb = k, v
    for i in range(n):
        src = (idx - i) % n                # owner of the resident K/V block
        m, l, acc = _flash_block(qf, kb, vb, m, l, acc, qpos, src * sl + pos, scale, causal)
        if i < n - 1:
            kb = shift(kb, mesh, axis, 1, "cp")
            vb = shift(vb, mesh, axis, 1, "cp")
    return (acc / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype)


def ring_attention_reference(q, k, v, causal: bool = True, scale: Optional[float] = None,
                             q_block: Optional[int] = None) -> torch.Tensor:
    """One-device golden: plain masked softmax attention over the global
    [B, H, S, D] tensors.  q_block: the queries in blocks of that many rows
    (each row's softmax is its own, so the function is the same; the score
    matrix is then [.., q_block, S] at a time)."""
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    sq, sk = q.shape[-2], k.shape[-2]
    kf, vf = k.float(), v.float()
    step = q_block or sq
    outs = []
    for r0 in range(0, sq, step):
        s = torch.matmul(q[..., r0:r0 + step, :].float(), kf.transpose(-1, -2)) * scale
        if causal:
            qpos = torch.arange(r0, min(r0 + step, sq), device=q.device)
            s = s.masked_fill(torch.arange(sk, device=q.device)[None, :] > qpos[:, None], _NEG)
        outs.append(torch.matmul(torch.softmax(s, dim=-1), vf).to(q.dtype))
    return torch.cat(outs, dim=-2)


def shard_sequence(x: torch.Tensor, mesh: Mesh, axis: str = "cp") -> torch.Tensor:
    """This rank's block of the sequence (dim 2) of a global [B, H, S, D]
    tensor, as a contiguous tensor on mesh.device."""
    n = mesh.size(axis)
    if x.shape[2] % n:
        raise ValueError(f"sequence {x.shape[2]} does not split over {axis}={n}")
    sl = x.shape[2] // n
    blk = x[:, :, mesh.index(axis) * sl:(mesh.index(axis) + 1) * sl]
    return torch.empty(blk.shape, dtype=blk.dtype, device=mesh.device).copy_(blk)


def gather_sequence(x: torch.Tensor, mesh: Mesh, axis: str = "cp") -> torch.Tensor:
    """The axis' shards [B, H, S/n, D] back into the global [B, H, S, D] on
    every rank (launch_counts["all_gather.cp"])."""
    return all_gather(x, mesh.group(axis), 2, "cp")
