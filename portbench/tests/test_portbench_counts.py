"""The byte and FLOP counts against hand counts at both configurations'
published widths."""

import json

import pytest

from portbench import counts, peaks, weights
from portbench.run import HERE


def _dims(name):
    with open(HERE / "configs" / f"{name}.json") as f:
        return weights.dims(json.load(f))


MISTRAL = _dims("mistral-7b-v0.1-q4_0")
DEEPSEEK = _dims("deepseek-llm-7b-q8_0")


def test_mistral_weights_by_hand():
    # wq 4096² + wk, wv 4096·1024 each + wo 4096² + w1, w3, w2 4096·14336 each
    layer = 4096 * 4096 * 2 + 4096 * 1024 * 2 + 3 * 4096 * 14336
    assert layer == 218_103_808 == counts.layer_weights(MISTRAL)
    total = 32 * layer + 4096 * 32000
    assert counts.weight_bytes(MISTRAL) == pytest.approx(total * 18 / 32)    # Q4_0: 4.5 bits
    assert counts.weight_bytes(MISTRAL) == pytest.approx(3_999_596_544)
    assert counts.kv_row_bytes(MISTRAL) == 64 * 1024                         # GQA: 64 KiB


def test_deepseek_weights_by_hand():
    layer = 4 * 4096 * 4096 + 3 * 4096 * 11008
    assert layer == 202_375_168 == counts.layer_weights(DEEPSEEK)
    total = 30 * layer + 4096 * 102400
    assert counts.weight_bytes(DEEPSEEK) == pytest.approx(total * 34 / 32)   # Q8_0: 8.5 bits
    assert counts.weight_bytes(DEEPSEEK) == pytest.approx(6_896_353_280)
    assert counts.kv_row_bytes(DEEPSEEK) == 240 * 1024                       # MHA: 240 KiB


@pytest.mark.parametrize("d", [MISTRAL, DEEPSEEK], ids=["mistral", "deepseek"])
def test_decode_step_by_hand(d):
    pos = [100, 2000, 7]
    w = counts.weight_bytes(d)
    kv = counts.kv_row_bytes(d)
    step = counts.decode_step(d, pos)
    keys = 101 + 2001 + 8
    assert step["bytes"] == pytest.approx(w + keys * kv + 3 * kv + 3 * d["D"] * 2)
    params = d["L"] * counts.layer_weights(d) + d["D"] * d["V"]
    attn = 4 * d["L"] * d["hq"] * d["dh"] * keys
    assert step["flops"] == 2 * 3 * params + attn
    assert step["attn"]["bytes"] == keys * kv + 3 * 2 * d["L"] * d["hq"] * d["dh"] * 2
    assert step["gemm"]["bytes"] > w
    # a decode step is bound by bytes: least time = bytes / HBM
    assert counts.least_seconds(step) == pytest.approx(step["bytes"] / peaks.HBM_BYTES_S)


@pytest.mark.parametrize("d", [MISTRAL, DEEPSEEK], ids=["mistral", "deepseek"])
def test_prefill_by_hand(d):
    n = 1500
    work = counts.prefill(d, n)
    attn = 4 * d["L"] * d["hq"] * d["dh"] * (n * (n + 1) // 2)
    assert work["flops"] == 2 * n * d["L"] * counts.layer_weights(d) + 2 * d["D"] * d["V"] + attn
    assert work["bytes"] == pytest.approx(counts.weight_bytes(d) + n * counts.kv_row_bytes(d)
                                          + n * d["D"] * 2)
    # a 1500-token prefill is bound by FLOPs
    assert counts.least_seconds(work) == pytest.approx(work["flops"] / peaks.TENSOR_FLOPS)


def test_padding_and_idle_lanes_are_not_work():
    assert counts.decode_step(MISTRAL, [])["flops"] == 0
    assert counts.prefill(MISTRAL, 1000)["flops"] < counts.prefill(MISTRAL, 1024)["flops"]
