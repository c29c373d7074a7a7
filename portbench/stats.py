"""Order statistics over every sample of a window (no trimming)."""

from __future__ import annotations

import statistics
from typing import Optional, Sequence


def percentile(values: Sequence[float], q: int) -> Optional[float]:
    """The q-th percentile, linear between order statistics (Python's
    statistics.quantiles, method "inclusive"); None below two samples."""
    v = list(values)
    if len(v) < 2:
        return None
    return statistics.quantiles(v, n=100, method="inclusive")[q - 1]


def ttfts_ms(rec) -> list:
    """First-token host time − send time, ms, of every request whose first
    token reached the host inside the window [start, deadline]: none of the
    closed loop's opening burst, whose first tokens came before it opened."""
    out = []
    for k, r in enumerate(rec.reqs):
        if r.t_first is not None and rec.start <= r.t_first <= rec.deadline:
            out.append((r.t_first - rec.send_time(k)) * 1e3)
    return out


def tpots_ms(rec) -> list:
    """(last token's host time − first token's) / (tokens − 1), ms, of every
    request that finished inside the window [start, deadline]."""
    return [(r.t_done - r.t_first) * 1e3 / (r.max_new - 1) for r in rec.reqs
            if r.t_done is not None and rec.start <= r.t_done <= rec.deadline and r.max_new > 1]


def step_positions(span):
    """Each step of a decode span: the positions of the lanes that needed it."""
    for j in range(span.n_steps):
        yield [p0 + j for p0, useful in span.lanes if useful > j]
