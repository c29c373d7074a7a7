"""Token sampling: greedy / temperature / top-k / top-p (nucleus) on the
device — counterpart of csinn2_tpu/llm/sampling.py.

Semantics (llama.cpp ordering — filters act on the untempered logits, the
temperature divides last):
  greedy            → argmax (top_k/top_p ignored)
  top_k > 0         → keep logits >= the k-th largest (ties all survive)
  0 < top_p < 1     → keep the smallest prefix of the sorted distribution
                      whose cumulative mass reaches top_p (the argmax always
                      survives); top_p >= 1 disables the filter
Filters compose: top-k first, then top-p over the survivors.

Random draws come from an explicit torch.Generator (Gumbel-max over the
filtered, tempered logits).  They are reproducible within the port for a
fixed seed; they cannot reproduce jax.random's stream.  Greedy decoding and
the filter masks match the JAX package exactly.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

_NEG = -1e30


def filter_top_k(logits: torch.Tensor, top_k: int) -> torch.Tensor:
    """Keep entries >= the k-th largest logit of the last axis, others → -1e30
    (ties at the k-th logit all survive)."""
    if top_k <= 0 or top_k >= logits.shape[-1]:
        return logits
    kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
    return torch.where(logits < kth, torch.full_like(logits, _NEG), logits)


def filter_top_p(logits: torch.Tensor, top_p: float) -> torch.Tensor:
    """Nucleus filter on the last axis.  top_p >= 1 keeps everything (f32
    cumsum saturates at 1.0 before the tail)."""
    if top_p >= 1.0:
        return logits
    sorted_lg = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_lg, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep = (cum - probs) < top_p
    keep[..., 0] = True
    thresh = torch.where(keep, sorted_lg, torch.full_like(sorted_lg, float("inf"))) \
        .amin(dim=-1, keepdim=True)
    return torch.where(logits < thresh, torch.full_like(logits, _NEG), logits)


def sample_logits(logits: torch.Tensor, generator: Optional[torch.Generator],
                  *, temperature: Union[float, torch.Tensor] = 1.0,
                  top_k: int = 0, top_p: float = 1.0,
                  greedy: bool = False) -> torch.Tensor:
    """logits [..., V] → token ids [...] (int64) on the logits' device."""
    lg = logits.float()
    if greedy:
        return torch.argmax(lg, dim=-1)
    lg = filter_top_k(lg, top_k)
    lg = filter_top_p(lg, min(max(float(top_p), 1e-6), 1.0))
    temp = torch.as_tensor(temperature, dtype=torch.float32,
                           device=lg.device).clamp_min(1e-6)
    if temp.ndim and temp.ndim == lg.ndim - 1:
        temp = temp[..., None]         # per-row temperature over [B, V]
    u = torch.rand(lg.shape, generator=generator, device=lg.device,
                   dtype=torch.float32).clamp_(1e-20, 1.0)
    return torch.argmax(lg / temp - torch.log(-torch.log(u)), dim=-1)


def sample_host(logits, temperature: float, rng, top_k: int = 0,
                top_p: float = 1.0) -> int:
    """Host-side sampler (numpy RNG) for the step-wise generate() path — the
    same function as the JAX package's sample_host."""
    lg = np.array(logits, np.float64, copy=True)
    if temperature <= 0:
        return int(np.argmax(lg))
    if 0 < top_k < lg.shape[-1]:
        kth = np.sort(lg)[-top_k]
        lg = np.where(lg < kth, -np.inf, lg)
    if 0.0 < top_p < 1.0:
        order = np.argsort(lg)[::-1]
        p_sorted = np.exp(lg[order] - lg[order[0]])
        p_sorted /= p_sorted.sum()
        cum = np.cumsum(p_sorted)
        keep = (cum - p_sorted) < top_p
        keep[0] = True
        lg[order[~keep]] = -np.inf
    p = np.exp((lg - lg.max()) / temperature)
    p /= p.sum()
    return int(rng.choice(len(p), p=p))
