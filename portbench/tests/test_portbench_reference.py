"""The float32 reference against the port at a tiny width on the CPU (the
port's plain path), the frozen quantizer against the port's, and the
control at that size: fp8 activations read far wider gaps than the
program on the same served tokens."""

import json

import pytest
import torch

from portbench import check, traffic, weights
from portbench.drivers import llm_serve
from portbench.reference import llama
from portbench.tests.helpers import DATA

CPU = torch.device("cpu")


def _tiny():
    with open(DATA / "configs" / "tiny-q4_0.json") as f:
        return weights.dims(json.load(f))


@pytest.mark.parametrize("mode", ["q4_0", "q8_0"])
def test_frozen_quantizer_matches_the_port(mode):
    from csinn2_tpu_torch.llm.model import quantize_weight_device
    from csinn2_tpu_torch.kernels.qmatmul import unpack_int4
    w = torch.randn(256, 96, generator=torch.Generator().manual_seed(3)) * 0.02
    w[:32, 0] = 0.0                                    # an all-zero block
    qw = quantize_weight_device(w, mode)
    q = unpack_int4(qw.values, 256) if qw.packed else qw.values
    port = q.float() * qw.scales.repeat_interleave(32, dim=0)
    assert torch.equal(llama.dequant(w, mode), port)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_reference_agrees_with_the_port(seed):
    """The port's prefill (llama_forward over an int8 cache) against the
    reference's logits at every position: the same model, apart from the
    port's bf16 rounding."""
    from csinn2_tpu_torch.llm.model import KVCache, llama_forward
    d = _tiny()
    eng = llm_serve.make_engine(d, seed, CPU)
    toks = torch.randint(0, d["V"], (1, 96), generator=torch.Generator().manual_seed(seed))
    cache = KVCache.create(eng.cfg, 1, quantized=True, scale=d["kv_scale"], device=CPU)
    port, _ = llama_forward(eng.params, toks, cache, 0, eng.cfg, kv_bound=256)
    ref = llama.logits_at(d, seed, [toks[0].tolist()], [range(96)], CPU)[0]
    cos = torch.nn.functional.cosine_similarity(port[0].flatten(), ref.flatten(), dim=0)
    assert float(cos) > 0.999
    assert float((port[0] - ref).abs().mean()) < 0.05 * float(ref.std())


def test_reference_rows_match_a_whole_sequence():
    """Scoring a few rows gives those rows of the full logits."""
    d = _tiny()
    seq = list(range(40))
    full = llama.logits_at(d, 5, [seq], [range(40)], CPU)[0]
    some = llama.logits_at(d, 5, [seq], [[3, 17, 39]], CPU)[0]
    assert torch.allclose(some, full[[3, 17, 39]], atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_control_reads_above_the_limits_where_the_program_reads_below(seed):
    """The tiny cell's limits (tests/data/limits) were set between the
    program's gaps and the control's on the first 16 requests of seeds
    1-20, served whole; on these seeds the control fails both and the
    program passes both."""
    from csinn2_tpu_torch.llm.engine import Request
    d = _tiny()
    mix = traffic.load_mix("tiny", root=DATA)
    eng = llm_serve.make_engine(d, seed, CPU)
    reqs = [Request(prompt=s.prompt, max_new_tokens=s.max_new_tokens, temperature=s.temperature)
            for s in traffic.make_requests(mix, d["V"], seed)[:16]]
    eng.run_queue(reqs, chunk=mix["chunk"], seed=seed)
    greedy = [r for r in reqs if r.temperature == 0]
    v = check.reference_values(llama, d, seed, [r.prompt for r in greedy],
                               [r.out for r in greedy], CPU, controls=("control",))
    limits = check.load_limits("tiny.gen", root=DATA)
    for name, ctl in (("max_logit_gap", "control_max_gap"), ("mean_logit_gap", "control_mean_gap")):
        assert v[name] <= limits[name]["limit"] < v[ctl]


def test_fp8_control_rounds_each_row_to_e4m3():
    x = torch.tensor([[1.0, 0.3, -0.7, 448.0], [0.001, 0.002, 0.003, 0.004]])
    y = llama.act_in(x, "fp8")
    assert torch.allclose(y[0], x[0], rtol=0.07)
    assert torch.allclose(y[1], x[1], rtol=0.07)          # scaled per row: no underflow
    assert not torch.equal(y, x)
    assert torch.equal(llama.act_in(x, "f32"), x)


def test_kv_int8_rounds_and_clips():
    t = torch.tensor([-7.0, 7.0, 0.049, 0.26])
    assert torch.allclose(llama.kv_int8(t, 0.05), torch.tensor([-6.35, 6.35, 0.05, 0.25]))
