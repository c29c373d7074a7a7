"""The work a step NEEDS, from the configuration and the traffic alone —
never from a kernel's launch plan, so any implementation is held to the
same count.

Bytes: each weight's values and block scales read once, at the format's
own width (Q4_0: 16 bytes of nibbles + one f16 scale per 32 weights; Q8_0:
32 + 2); int8 K/V read for each lane up to its own position, and written
for each new row; bf16 activations where a kernel's share is counted.
FLOPs: 2 a weight a token, and 2 · 2 · dh a query head a key for
attention, causal keys only.  Padding (bucket rows, idle lanes, lanes past
their last token) is not needed work and is not counted.
"""

from __future__ import annotations

from typing import Iterable

from portbench.peaks import HBM_BYTES_S, TENSOR_FLOPS

BYTES_PER_WEIGHT = {"q4_0": (16 + 2) / 32, "q8_0": (32 + 2) / 32, "float": 2.0}
ACT_BYTES = 2                 # bf16


def layer_weights(d: dict) -> int:
    D, F, qd, kvd = d["D"], d["F"], d["hq"] * d["dh"], d["hk"] * d["dh"]
    return D * qd + 2 * D * kvd + qd * D + 3 * D * F


def head_weights(d: dict) -> int:
    return d["D"] * d["V"]


def weight_bytes(d: dict) -> float:
    """Every matmul weight of the model (the layers and the head) once."""
    return (d["L"] * layer_weights(d) + head_weights(d)) * BYTES_PER_WEIGHT[d["mode"]]


def kv_row_bytes(d: dict) -> int:
    """One position's int8 K and V over all layers."""
    return 2 * d["L"] * d["hk"] * d["dh"]


def gemm_act_bytes(d: dict, lanes: int) -> int:
    """bf16 inputs and outputs of a decode step's matmuls, `lanes` rows."""
    D, F, qd, kvd, V = d["D"], d["F"], d["hq"] * d["dh"], d["hk"] * d["dh"], d["V"]
    per_layer = (D + qd + 2 * kvd) + (qd + D) + (D + 2 * F) + (F + D)
    return lanes * ACT_BYTES * (d["L"] * per_layer + D + V)


def attn_flops(d: dict, keys: int) -> int:
    """One query row attending to `keys` keys, all layers."""
    return 4 * d["L"] * d["hq"] * d["dh"] * keys


def decode_step(d: dict, positions: Iterable[int]) -> dict:
    """One decode step of the lanes at `positions` (each writes row p and
    reads rows 0..p): FLOPs and bytes, the GEMMs' and attention's shares."""
    pos = list(positions)
    n = len(pos)
    keys = sum(p + 1 for p in pos)
    w = weight_bytes(d)
    kv_read = keys * kv_row_bytes(d)
    kv_write = n * kv_row_bytes(d)
    q_o = n * 2 * d["L"] * d["hq"] * d["dh"] * ACT_BYTES
    gemm_flops = 2 * n * (d["L"] * layer_weights(d) + head_weights(d))
    return {"flops": gemm_flops + attn_flops(d, keys),
            "bytes": w + kv_read + kv_write + n * d["D"] * ACT_BYTES,
            "gemm": {"flops": gemm_flops, "bytes": w + gemm_act_bytes(d, n)},
            "attn": {"flops": attn_flops(d, keys), "bytes": kv_read + q_o}}


def prefill(d: dict, n: int) -> dict:
    """One prompt of n real tokens: every layer over n rows, causal
    attention, the head for the last row only (the one that samples)."""
    flops = (2 * n * d["L"] * layer_weights(d) + 2 * head_weights(d)
             + attn_flops(d, n * (n + 1) // 2))
    return {"flops": flops,
            "bytes": weight_bytes(d) + n * kv_row_bytes(d) + n * d["D"] * ACT_BYTES}


def least_seconds(work: dict) -> float:
    """The least time the chip could take: the larger of FLOPs over the
    tensor-core peak and bytes over the HBM peak."""
    return max(work["flops"] / TENSOR_FLOPS, work["bytes"] / HBM_BYTES_S)
