"""The PyTorch port's Llama forward, engine and sampling against the JAX
package, on the CPU (plain versions of the kernels) at tiny sizes with the
same weights (carried across with params_from_numpy).

Gates: llama_forward logits cosine >= 0.999 against JAX
llama_forward(use_pallas=False), in every weight mode and with the swiglu128
fusion; the engine's greedy tokens identical to the JAX
InferenceEngine(use_pallas=False); the top-k / top-p masks identical;
quantized against float logits at the JAX package's gates.
Sampled (temperature > 0) tokens cannot match jax.random's stream; they are
checked for reproducibility within the port."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from csinn2_tpu.llm import model as jm
from csinn2_tpu.llm import sampling as jsamp
from csinn2_tpu.llm.config import LlamaConfig as JConfig
from csinn2_tpu.llm.engine import InferenceEngine as JEngine
from csinn2_tpu.llm.engine import Request as JRequest
from csinn2_tpu.utils.verify import cosine_similarity
from csinn2_tpu_torch.llm import model as tm
from csinn2_tpu_torch.llm import sampling as tsamp
from csinn2_tpu_torch.llm.config import LlamaConfig as TConfig
from csinn2_tpu_torch.llm.engine import InferenceEngine, Request, _batched_decode_forward
from csinn2_tpu_torch.llm.params import params_from_numpy

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MHA = dict(dim=64, n_layers=2, n_heads=4, n_kv_heads=4, ffn_dim=128,
           vocab_size=256, max_seq_len=128)
PROMPTS = [[3, 7, 11, 2, 9], [5, 2], list(range(1, 36))]


def _cfgs(name):
    if name == "gqa":
        return JConfig.tiny(), TConfig.tiny()
    return JConfig(**MHA), TConfig(**MHA)


@pytest.fixture(scope="module")
def weights():
    """(jax params, port params) per (config, mode), built once."""
    out = {}
    for name in ("gqa", "mha"):
        jcfg, _ = _cfgs(name)
        modes = (jm.FLOAT, jm.Q8_0) + ((jm.Q4_0, jm.INT8_CHANNEL, jm.INT4_CHANNEL)
                                       if name == "gqa" else ())
        for mode in modes:
            jp = jm.init_params(jcfg, mode, seed=1)
            out[name, mode] = (jp, params_from_numpy(
                jax.tree_util.tree_map(np.asarray, jp), device="cpu"))
    return out


@pytest.mark.parametrize("cfg_name", ["gqa", "mha"])
@pytest.mark.parametrize("mode", [jm.FLOAT, jm.Q8_0])
@pytest.mark.parametrize("quantized_kv", [False, True])
def test_llama_forward_matches_jax(weights, cfg_name, mode, quantized_kv):
    jcfg, tcfg = _cfgs(cfg_name)
    jp, tp = weights[cfg_name, mode]
    toks = np.array([[3, 7, 11, 19, 5, 2, 9, 4], [1, 2, 3, 4, 5, 6, 7, 8]], np.int32)
    jc = jm.KVCache.create(jcfg, 2, quantized=quantized_kv)
    want, jc = jm.llama_forward(jp, jnp.asarray(toks), jc, 0, jcfg, use_pallas=False)
    tc = tm.KVCache.create(tcfg, 2, quantized=quantized_kv, device="cpu")
    got, tc = tm.llama_forward(tp, torch.from_numpy(toks), tc, 0, tcfg)
    assert got.shape == (2, 8, tcfg.vocab_size) and got.dtype == torch.float32
    cs = cosine_similarity(got.numpy(), np.asarray(want))
    assert cs >= 0.999, cs
    # a decode step on top of the prefilled cache, through both packages
    nxt = np.array([[17], [23]], np.int32)
    want2, _ = jm.llama_forward(jp, jnp.asarray(nxt), jc, 8, jcfg, use_pallas=False)
    got2, _ = tm.llama_forward(tp, torch.from_numpy(nxt), tc, 8, tcfg)
    cs2 = cosine_similarity(got2.numpy(), np.asarray(want2))
    assert cs2 >= 0.999, cs2


@pytest.mark.parametrize("quantized_kv", [False, True])
def test_prefill_decode_consistency(weights, quantized_kv):
    """Token-by-token decode reproduces the prefill logits (as the JAX test
    does), and both match the JAX package's prefill."""
    jcfg, tcfg = _cfgs("gqa")
    jp, tp = weights["gqa", jm.Q8_0]
    toks = np.array([[3, 7, 11, 19, 5, 2, 9, 4]], np.int32)
    full, _ = tm.llama_forward(tp, torch.from_numpy(toks),
                               tm.KVCache.create(tcfg, 1, quantized=quantized_kv,
                                                 device="cpu"), 0, tcfg)
    cache = tm.KVCache.create(tcfg, 1, quantized=quantized_kv, device="cpu")
    steps = []
    for t in range(toks.shape[1]):
        lg, cache = tm.llama_forward(tp, torch.from_numpy(toks[:, t:t + 1]), cache, t, tcfg)
        steps.append(lg[:, 0])
    step = torch.stack(steps, dim=1).numpy()
    assert cosine_similarity(step, full.numpy()) > 0.999
    jfull, _ = jm.llama_forward(jp, jnp.asarray(toks),
                                jm.KVCache.create(jcfg, 1, quantized=quantized_kv), 0,
                                jcfg, use_pallas=False)
    assert cosine_similarity(step, np.asarray(jfull)) > 0.999


@pytest.mark.parametrize("mode,quantized_kv", [(jm.FLOAT, False), (jm.Q8_0, True)])
def test_generate_fused_greedy_matches_jax(weights, mode, quantized_kv):
    jcfg, tcfg = _cfgs("gqa")
    jp, tp = weights["gqa", mode]
    want = JEngine(jcfg, jp, batch=1, use_pallas=False, quantized_kv=quantized_kv) \
        .generate_fused([3, 7, 11], max_new_tokens=8)
    got = InferenceEngine(tcfg, tp, batch=1, quantized_kv=quantized_kv, device="cpu") \
        .generate_fused([3, 7, 11], max_new_tokens=8)
    assert got == want


def test_generate_stepwise_matches_jax(weights):
    jcfg, tcfg = _cfgs("mha")
    jp, tp = weights["mha", jm.Q8_0]
    want = JEngine(jcfg, jp, batch=1, use_pallas=False).generate([5, 9, 2], max_new_tokens=6)
    got = InferenceEngine(tcfg, tp, batch=1, device="cpu").generate([5, 9, 2],
                                                                   max_new_tokens=6)
    assert got == want


@pytest.mark.parametrize("mode,quantized_kv", [(jm.FLOAT, False), (jm.Q8_0, True)])
def test_run_queue_matches_jax(weights, mode, quantized_kv):
    """Batch 2, three requests: continuous batching admits the third into the
    first lane to free up; tokens are those of the JAX engine."""
    jcfg, tcfg = _cfgs("gqa")
    jp, tp = weights["gqa", mode]
    jdone = JEngine(jcfg, jp, batch=2, use_pallas=False, quantized_kv=quantized_kv) \
        .run_queue([JRequest(p, max_new_tokens=5) for p in PROMPTS], chunk=2)
    tdone = InferenceEngine(tcfg, tp, batch=2, quantized_kv=quantized_kv, device="cpu") \
        .run_queue([Request(p, max_new_tokens=5) for p in PROMPTS], chunk=2)
    assert all(r.done for r in tdone)
    assert [r.out for r in tdone] == [r.out for r in jdone]
    assert [r.slot for r in tdone] == [r.slot for r in jdone]


def test_engine_prefill_and_decode_step_logits_match_jax(weights):
    jcfg, tcfg = _cfgs("gqa")
    jp, tp = weights["gqa", jm.Q8_0]
    je = JEngine(jcfg, jp, batch=2, use_pallas=False, quantized_kv=True)
    te = InferenceEngine(tcfg, tp, batch=2, quantized_kv=True, device="cpu")
    for sid, p in enumerate(PROMPTS[:2]):
        assert cosine_similarity(te.prefill(sid, p), je.prefill(sid, p)) > 0.999
    nxt = {0: 4, 1: 9}
    jl, tl = je.decode_step(nxt), te.decode_step(nxt)
    for sid in nxt:
        assert tl[sid].dtype == np.float32
        assert cosine_similarity(tl[sid], jl[sid]) > 0.999
    assert [s.pos for s in te.slots] == [s.pos for s in je.slots]


def test_decode_kv_store_drops_lanes_past_the_cache(weights):
    """A lane whose position is >= S writes no KV row (JAX scatter
    mode="drop"); the other lane writes its row."""
    _, tcfg = _cfgs("gqa")
    _, tp = weights["gqa", jm.Q8_0]
    tp = tm.fuse_params(tp)
    cache = tm.KVCache.create(tcfg, 2, quantized=True, device="cpu")
    cache.k.fill_(7)
    cache.v.fill_(7)
    S = tcfg.max_seq_len
    pos = torch.tensor([S, 3], dtype=torch.int32)
    logits, cache = _batched_decode_forward(tp, torch.tensor([[1], [2]]), cache, pos, tcfg)
    assert torch.isfinite(logits).all()
    assert bool((cache.k[:, 0] == 7).all()) and bool((cache.v[:, 0] == 7).all())
    assert not bool((cache.k[:, 1, 3] == 7).all())
    assert bool((cache.k[:, 1, :3] == 7).all()) and bool((cache.k[:, 1, 4:] == 7).all())


@pytest.mark.parametrize("mode,quantized_kv", [(jm.FLOAT, False), (jm.Q8_0, True)])
def test_flash_decode_greedy_matches_jax(weights, monkeypatch, mode, quantized_kv):
    """CSINN2_DECODE_ATTN=flash: the batched decode takes bhsd
    flash_attention (decode_attention is never called); run_queue's greedy
    tokens equal the JAX engine's."""
    import csinn2_tpu_torch.llm.engine as te

    def no_decode_kernel(*a, **k):
        raise AssertionError("decode_attention called under CSINN2_DECODE_ATTN=flash")

    monkeypatch.setenv("CSINN2_DECODE_ATTN", "flash")
    monkeypatch.setattr(te, "decode_attention", no_decode_kernel)
    jcfg, tcfg = _cfgs("gqa")
    jp, tp = weights["gqa", mode]
    jdone = JEngine(jcfg, jp, batch=2, use_pallas=False, quantized_kv=quantized_kv) \
        .run_queue([JRequest(p, max_new_tokens=5) for p in PROMPTS], chunk=2)
    tdone = InferenceEngine(tcfg, tp, batch=2, quantized_kv=quantized_kv, device="cpu") \
        .run_queue([Request(p, max_new_tokens=5) for p in PROMPTS], chunk=2)
    assert [r.out for r in tdone] == [r.out for r in jdone]


def test_sampled_generation_reproducible_within_port(weights):
    """Temperature sampling: the same seed gives the same tokens, through
    generate_fused and through a single-request run_queue (shared seed
    schedule); a different seed gives another sequence."""
    _, tcfg = _cfgs("gqa")
    _, tp = weights["gqa", jm.FLOAT]
    prompt, n, temp, seed = [3, 7, 11], 8, 1.5, 11

    def fused(s):
        return InferenceEngine(tcfg, tp, batch=1, device="cpu").generate_fused(
            prompt, max_new_tokens=n, temperature=temp, seed=s)

    a, b = fused(seed), fused(seed)
    assert a == b and len(a) == n and all(0 <= t < tcfg.vocab_size for t in a)
    req = Request(prompt, max_new_tokens=n, temperature=temp)
    InferenceEngine(tcfg, tp, batch=1, device="cpu").run_queue([req], chunk=n, seed=seed)
    assert req.out == a
    assert fused(seed + 1) != a


# -- the weight modes of the second slice -----------------------------------------

MODE_CASES = [(jm.Q4_0, False), (jm.INT8_CHANNEL, False), (jm.INT4_CHANNEL, False),
              (jm.Q4_0, True)]     # (mode, CSINN2_SWIGLU_FUSE=1)


@pytest.mark.parametrize("mode,swiglu", MODE_CASES)
@pytest.mark.parametrize("quantized_kv", [False, True])
def test_llama_forward_modes_match_jax(weights, monkeypatch, mode, swiglu, quantized_kv):
    """Q4_0, INT8_CHANNEL, INT4_CHANNEL and Q4_0 with the swiglu128 fusion:
    fused params of both packages, prefill then one decode step, logits
    cosine >= 0.999."""
    if swiglu:
        monkeypatch.setenv("CSINN2_SWIGLU_FUSE", "1")
    else:
        monkeypatch.delenv("CSINN2_SWIGLU_FUSE", raising=False)
    jcfg, tcfg = _cfgs("gqa")
    jp, tp = weights["gqa", mode]
    jp, tp = jm.fuse_params(jp), tm.fuse_params(tp)
    assert (tp["layers"][0]["w13"].layout == "swiglu128") == swiglu
    toks = np.array([[3, 7, 11, 19, 5, 2, 9, 4], [1, 2, 3, 4, 5, 6, 7, 8]], np.int32)
    jc = jm.KVCache.create(jcfg, 2, quantized=quantized_kv)
    want, jc = jm.llama_forward(jp, jnp.asarray(toks), jc, 0, jcfg, use_pallas=False)
    tc = tm.KVCache.create(tcfg, 2, quantized=quantized_kv, device="cpu")
    got, tc = tm.llama_forward(tp, torch.from_numpy(toks), tc, 0, tcfg)
    assert cosine_similarity(got.numpy(), np.asarray(want)) >= 0.999
    nxt = np.array([[17], [23]], np.int32)
    want2, _ = jm.llama_forward(jp, jnp.asarray(nxt), jc, 8, jcfg, use_pallas=False)
    got2, _ = tm.llama_forward(tp, torch.from_numpy(nxt), tc, 8, tcfg)
    assert cosine_similarity(got2.numpy(), np.asarray(want2)) >= 0.999


@pytest.mark.parametrize("quantized_kv", [False, True])
def test_run_queue_q4_0_matches_jax(weights, quantized_kv):
    jcfg, tcfg = _cfgs("gqa")
    jp, tp = weights["gqa", jm.Q4_0]
    jdone = JEngine(jcfg, jp, batch=2, use_pallas=False, quantized_kv=quantized_kv,
                    native_int4=False) \
        .run_queue([JRequest(p, max_new_tokens=5) for p in PROMPTS], chunk=2)
    tdone = InferenceEngine(tcfg, tp, batch=2, quantized_kv=quantized_kv, device="cpu") \
        .run_queue([Request(p, max_new_tokens=5) for p in PROMPTS], chunk=2)
    assert all(r.done for r in tdone)
    assert [r.out for r in tdone] == [r.out for r in jdone]


def test_native_int4_gives_identical_tokens(weights):
    """native_int4 True / False / None run the same packed weights: identical
    tokens, and those of the JAX engine on its packed carrier."""
    jcfg, tcfg = _cfgs("gqa")
    jp, tp = weights["gqa", jm.Q4_0]
    prompt = [3, 1, 4, 1, 5]
    outs = [InferenceEngine(tcfg, tp, batch=1, device="cpu", native_int4=n)
            .generate_fused(prompt, max_new_tokens=12) for n in (True, False, None)]
    assert outs[0] == outs[1] == outs[2]
    want = JEngine(jcfg, jp, batch=1, use_pallas=False, native_int4=False) \
        .generate_fused(prompt, max_new_tokens=12)
    assert outs[0] == list(want)


def test_engine_swiglu_fusion_decodes_the_pairs(weights, monkeypatch):
    """With CSINN2_SWIGLU_FUSE=1 the engine's prefill and batched decode take
    the swiglu epilogue; their logits match the unfused JAX engine's."""
    jcfg, tcfg = _cfgs("gqa")
    jp, tp = weights["gqa", jm.Q4_0]
    monkeypatch.delenv("CSINN2_SWIGLU_FUSE", raising=False)
    je = JEngine(jcfg, jp, batch=2, use_pallas=False, quantized_kv=True, native_int4=False)
    monkeypatch.setenv("CSINN2_SWIGLU_FUSE", "1")
    te = InferenceEngine(tcfg, tp, batch=2, quantized_kv=True, device="cpu")
    assert te.params["layers"][0]["w13"].layout == "swiglu128"
    for sid, p in enumerate(PROMPTS[:2]):
        assert cosine_similarity(te.prefill(sid, p), je.prefill(sid, p)) > 0.999
    nxt = {0: 4, 1: 9}
    jl, tl = je.decode_step(nxt), te.decode_step(nxt)
    for sid in nxt:
        assert cosine_similarity(tl[sid], jl[sid]) > 0.999
    done = InferenceEngine(tcfg, tp, batch=2, quantized_kv=True, device="cpu") \
        .run_queue([Request(p, max_new_tokens=4) for p in PROMPTS], chunk=2)
    assert all(r.done and len(r.out) == 4 for r in done)


@pytest.mark.parametrize("mode,gate", [(jm.INT8_CHANNEL, 0.99), (jm.Q8_0, 0.99),
                                       (jm.Q4_0, 0.95)])
def test_quantized_weights_cosine(mode, gate):
    """The port's analog of tests/test_llm.py::test_quantized_weights_cosine:
    weight-only quant keeps the prefill logits' cosine against float above
    the reference's LLM gate."""
    _, tcfg = _cfgs("gqa")
    fp = tm.init_params(tcfg, tm.FLOAT, seed=1, device="cpu")
    toks = torch.tensor([[3, 7, 11, 19]])

    def logits(params):
        cache = tm.KVCache.create(tcfg, 1, device="cpu")
        return tm.llama_forward(params, toks, cache, 0, tcfg)[0].numpy()

    cs = cosine_similarity(logits(tm.quantize_params(fp, mode)), logits(fp))
    assert cs >= gate, f"{mode}: cs={cs}"


@pytest.mark.parametrize("top_k", [0, 1, 5, 49])
@pytest.mark.parametrize("top_p", [1e-9, 0.3, 0.9, 1.0])
def test_sampling_filter_masks_match_jax(rng, top_k, top_p):
    lg = (rng.standard_normal((3, 50)) * 3).astype(np.float32)
    lg[1, 10] = lg[1, 11]                          # a tie at the k-th logit
    jk = np.asarray(jsamp.filter_top_k(jnp.asarray(lg), top_k)) > -1e29
    tk = tsamp.filter_top_k(torch.from_numpy(lg), top_k).numpy() > -1e29
    assert np.array_equal(jk, tk)
    jp = np.asarray(jsamp.filter_top_p(jnp.asarray(lg), top_p)) > -1e29
    tp = tsamp.filter_top_p(torch.from_numpy(lg), top_p).numpy() > -1e29
    assert np.array_equal(jp, tp)
    both_j = np.asarray(jsamp.filter_top_p(jsamp.filter_top_k(jnp.asarray(lg), top_k),
                                           top_p)) > -1e29
    both_t = tsamp.filter_top_p(tsamp.filter_top_k(torch.from_numpy(lg), top_k),
                                top_p).numpy() > -1e29
    assert np.array_equal(both_j, both_t)


def test_sample_logits_support_and_greedy(rng):
    lg = torch.from_numpy(np.log(np.asarray([0.5, 0.25, 0.15, 0.06, 0.04], np.float32)))
    assert int(tsamp.sample_logits(lg, None, greedy=True)) == 0
    g = torch.Generator().manual_seed(0)
    toks = {int(tsamp.sample_logits(lg, g, temperature=1.0, top_k=2)) for _ in range(64)}
    assert toks <= {0, 1} and len(toks) == 2
    toks = {int(tsamp.sample_logits(lg, g, temperature=1.0, top_p=0.7)) for _ in range(64)}
    assert toks <= {0, 1}
    host = np.asarray(lg)
    for seed in range(3):
        assert jsamp.sample_host(host, 0.8, np.random.default_rng(seed), top_k=3) == \
            tsamp.sample_host(host, 0.8, np.random.default_rng(seed), top_k=3)


def test_engine_needs_cuda_unless_cpu_asked(weights, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tcfg = _cfgs("gqa")
    _, tp = weights["gqa", jm.Q8_0]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        InferenceEngine(tcfg, tp, batch=1)
    InferenceEngine(tcfg, tp, batch=1, device="cpu")


def test_port_imports_no_jax():
    """Importing the port and running its CPU forward, engine, an MoE
    forward (dense and routed), the parallel package on a one-process mesh
    (tp_llama_forward, ep_llama_forward; spawn and the multihost example
    imported; ring attention and the pipelines imported, a two-stage
    PipelinedLlama forward on the CPU), a GGUF convert / CTBM load round trip, a small fused
    MobileNetV1 INT8 session, small MobileNetV2-u8, MobileNetV3 and ResNet-50
    sessions, the Q4_0 dequant probe, the op zoo's modules (a proposal
    recorded into a GRAPH session), two streamed chunks of a tiny DFSMN,
    and the rest of the runtime (a HYBRID session with a host node, the
    profiler's layer benchmark and trace, save_model / load_model, the
    roofline, the data loader, utils.platform and the two CNN examples'
    modules) loads neither jax nor any module of the JAX package."""
    code = (
        "import sys\n"
        "import torch\n"
        "torch.set_num_threads(1)\n"
        "import csinn2_tpu_torch\n"
        "from csinn2_tpu_torch.llm.config import LlamaConfig\n"
        "from csinn2_tpu_torch.llm.engine import InferenceEngine\n"
        "from csinn2_tpu_torch.llm.model import init_params\n"
        "import csinn2_tpu_torch.llm.params, csinn2_tpu_torch.utils.verify\n"
        "cfg = LlamaConfig.tiny()\n"
        "for mode in ('q8_0', 'q4_0', 'int8'):\n"
        "    eng = InferenceEngine(cfg, init_params(cfg, mode, device='cpu'), batch=1,\n"
        "                          quantized_kv=True, device='cpu')\n"
        "    assert len(eng.generate_fused([1, 2, 3], max_new_tokens=3)) == 3\n"
        "import dataclasses, tempfile\n"
        "import numpy as np\n"
        "from csinn2_tpu_torch.llm.model import KVCache, llama_forward\n"
        "for disp in ('dense', 'routed'):\n"
        "    mcfg = dataclasses.replace(LlamaConfig.tiny_moe(4), moe_dispatch=disp)\n"
        "    lg, _ = llama_forward(init_params(mcfg, 'q4_0', device='cpu'),\n"
        "                          torch.arange(8)[None], KVCache.create(mcfg, 1, device='cpu'),\n"
        "                          0, mcfg)\n"
        "    assert lg.shape == (1, 8, mcfg.vocab_size) and bool(torch.isfinite(lg).all())\n"
        "import csinn2_tpu_torch.parallel.launch, csinn2_tpu_torch.examples.multihost_dryrun\n"
        "from csinn2_tpu_torch.parallel.mesh import make_mesh\n"
        "from csinn2_tpu_torch.parallel.tp import shard_llama_params, tp_llama_forward\n"
        "from csinn2_tpu_torch.parallel.ep import ep_llama_forward, shard_moe_params\n"
        "mesh = make_mesh(device='cpu')\n"
        "lg, _ = tp_llama_forward(mesh, cfg)(\n"
        "    shard_llama_params(init_params(cfg, 'q4_0', device='cpu'), mesh),\n"
        "    torch.arange(4)[None], KVCache.create(cfg, 1, device='cpu'), 0)\n"
        "assert lg.shape == (1, 4, cfg.vocab_size)\n"
        "mcfg = LlamaConfig.tiny_moe(4)\n"
        "ep1 = type(mesh)({'ep': 1}, device='cpu')\n"
        "lg, _ = ep_llama_forward(ep1, mcfg)(\n"
        "    shard_moe_params(init_params(mcfg, 'q8_0', device='cpu'), ep1),\n"
        "    torch.arange(4)[None], KVCache.create(mcfg, 1, device='cpu'), 0)\n"
        "assert bool(torch.isfinite(lg).all())\n"
        "from csinn2_tpu_torch.parallel.cp import ring_attention, ring_attention_reference\n"
        "from csinn2_tpu_torch.parallel.pp import PipelinedLlama, SPMDPipelinedLlama\n"
        "pipe = PipelinedLlama(init_params(cfg, 'q8_0', device='cpu'), cfg, ['cpu', 'cpu'])\n"
        "lg, _ = pipe(torch.arange(8).reshape(2, 4), pipe.init_caches(2, True), 0, 2)\n"
        "assert lg.shape == (2, 4, cfg.vocab_size) and bool(torch.isfinite(lg).all())\n"
        "import csinn2_tpu_torch.__main__, csinn2_tpu_torch.examples.moe_dispatch_probe\n"
        "from csinn2_tpu_torch.llm.gguf_io import write_gguf\n"
        "from csinn2_tpu_torch.llm.convert import convert_gguf\n"
        "from csinn2_tpu_torch.llm.json_io import load_llm, save_llm\n"
        "from csinn2_tpu_torch.llm.tokenizer import load_tokenizer\n"
        "from csinn2_tpu_torch.runtime.bm import load_bm\n"
        "rng = np.random.default_rng(0)\n"
        "D, V, Fd, kvd = cfg.dim, cfg.vocab_size, cfg.ffn_dim, cfg.n_kv_heads * cfg.head_dim\n"
        "w = lambda o, i: (rng.standard_normal((o, i)) * 0.05).astype(np.float32)\n"
        "t = {'token_embd.weight': w(V, D), 'output_norm.weight': np.ones(D, np.float32),\n"
        "     'output.weight': w(V, D)}\n"
        "for i in range(cfg.n_layers):\n"
        "    b = f'blk.{i}.'\n"
        "    t.update({b + 'attn_norm.weight': np.ones(D, np.float32),\n"
        "              b + 'ffn_norm.weight': np.ones(D, np.float32), b + 'attn_q.weight': w(D, D),\n"
        "              b + 'attn_k.weight': w(kvd, D), b + 'attn_v.weight': w(kvd, D),\n"
        "              b + 'attn_output.weight': w(D, D), b + 'ffn_gate.weight': w(Fd, D),\n"
        "              b + 'ffn_down.weight': w(D, Fd), b + 'ffn_up.weight': w(Fd, D)})\n"
        "toks = ['<unk>', '<s>', '</s>'] + [f'<0x{i:02X}>' for i in range(256)]\n"
        "md = {'general.architecture': 'llama', 'llama.embedding_length': D,\n"
        "      'llama.block_count': cfg.n_layers, 'llama.attention.head_count': cfg.n_heads,\n"
        "      'llama.attention.head_count_kv': cfg.n_kv_heads,\n"
        "      'llama.feed_forward_length': Fd, 'tokenizer.ggml.tokens': toks}\n"
        "with tempfile.TemporaryDirectory() as d:\n"
        "    write_gguf(d + '/m.gguf', md, t, quantize={'blk.0.ffn_down.weight': 'q8_0'})\n"
        "    ccfg, cp = load_llm(convert_gguf(d + '/m.gguf', d + '/m', mode='q4_0'), device='cpu')\n"
        "    assert load_tokenizer(d + '/m').encode('ab', bos=True)[0] == 1\n"
        "    lg, _ = llama_forward(cp, torch.arange(4)[None], KVCache.create(ccfg, 1, device='cpu'),\n"
        "                          0, ccfg)\n"
        "    assert bool(torch.isfinite(lg).all())\n"
        "    save_llm(d + '/again', ccfg, cp)\n"
        "    assert len(load_bm(d + '/again/weights.ctbm')) == len(load_bm(d + '/m/weights.ctbm'))\n"
        "import os\n"
        "os.environ['CSINN2_FUSE_DS'] = '1'\n"
        "from csinn2_tpu_torch.core.dtypes import QuantScheme\n"
        "from csinn2_tpu_torch.models.mobilenet import MobileNetV1\n"
        "import csinn2_tpu_torch.kernels.dsblock, csinn2_tpu_torch.graph.fuse\n"
        "m = MobileNetV1(alpha=0.25, input_size=32)\n"
        "x = torch.rand(m.input_shape(1)).numpy()\n"
        "m.calibrate(x, device='cpu')\n"
        "s = m.build_session(QuantScheme.INT8_SYM, batch=1, device='cpu')\n"
        "assert sum(n.op == 'ds_block' for n in s.graph.nodes) == 13\n"
        "assert tuple(s.run(m.prepare_input(x, s)).shape) == (1, 1000)\n"
        "from csinn2_tpu_torch.models.mobilenet import MobileNetV2, MobileNetV3\n"
        "from csinn2_tpu_torch.models.resnet import ResNet50\n"
        "for cls, sch in ((MobileNetV2, 'UINT8_ASYM'), (MobileNetV3, 'INT8_SYM'),\n"
        "                 (ResNet50, 'INT8_SYM')):\n"
        "    m = cls(input_size=32)\n"
        "    m.calibrate(x, device='cpu')\n"
        "    s = m.build_session(QuantScheme[sch], batch=1, device='cpu')\n"
        "    assert tuple(s.run(m.prepare_input(x, s)).shape) == (1, 1000)\n"
        "from csinn2_tpu_torch.examples import int4_dequant_probe, int4_tile_tune\n"
        "import csinn2_tpu_torch.kernels.int4_probe, csinn2_tpu_torch.utils.timing\n"
        "recs = int4_dequant_probe.probe(device='cpu', shapes=[(512, 256, 4096, 128)],\n"
        "                                log=lambda line: None)\n"
        "assert len(recs) == 18 and all(r['cos'] > 0.99 for r in recs if r['kind'] in\n"
        "                                 ('cur', 'andmask', 'w4a8', 'i4native'))\n"
        "import csinn2_tpu_torch.ops.ref.shape, csinn2_tpu_torch.ops.ref.reduce\n"
        "import csinn2_tpu_torch.ops.ref.norm, csinn2_tpu_torch.ops.ref.misc\n"
        "import csinn2_tpu_torch.ops.ref.detection, csinn2_tpu_torch.core.layout\n"
        "import csinn2_tpu_torch.utils.memstats, csinn2_tpu_torch.examples.dfsmn_stream\n"
        "from csinn2_tpu_torch.examples import op_zoo\n"
        "assert op_zoo.run_graph('proposal', 'cpu')[0].shape == (50, 5)\n"
        "from csinn2_tpu_torch.models.dfsmn_asr import DFSMNASR, DFSMNConfig\n"
        "asr = DFSMNASR(DFSMNConfig(feat_dim=8, hidden=16, proj=12, blocks=2, l_order=3,\n"
        "                           r_order=1, classes=5), seed=0, device='cpu')\n"
        "st = asr.stream(batch=1, chunk=4)\n"
        "ys = [st.step(np.zeros((1, 4, 8), np.float32)) for _ in range(2)]\n"
        "assert all(tuple(y.shape) == (1, 4, 5) for y in ys)\n"
        "import tempfile as _tf\n"
        "from csinn2_tpu_torch.core.dtypes import Dtype, ProfilerLevel, RunMode\n"
        "from csinn2_tpu_torch.core.tensor import TensorMeta\n"
        "from csinn2_tpu_torch import ops\n"
        "from csinn2_tpu_torch.runtime.session import Session\n"
        "hs = Session(run_mode=RunMode.HYBRID, profiler_level=ProfilerLevel.TRACE, device='cpu')\n"
        "with hs.build():\n"
        "    hx = hs.input(TensorMeta(shape=(2, 3), dtype=Dtype.FLOAT32))\n"
        "    with hs.device_scope('host'):\n"
        "        hy = ops.sigmoid(hx)\n"
        "    hs.set_output(ops.relu(hy))\n"
        "hs.setup()\n"
        "assert len(hs._hybrid.subgraphs) == 2\n"
        "assert tuple(hs.run(np.ones((2, 3), np.float32)).shape) == (2, 3)\n"
        "assert len(hs.run_layer_benchmark(np.ones((2, 3), np.float32), iters=1)) == 2\n"
        "from csinn2_tpu_torch.runtime.export import load_model, save_model\n"
        "from csinn2_tpu_torch.runtime.roofline import analyze\n"
        "from csinn2_tpu_torch.runtime.dataloader import DataLoader, write_archive\n"
        "from csinn2_tpu_torch.runtime.profiler import device_trace\n"
        "from csinn2_tpu_torch.utils.platform import backend_summary\n"
        "import csinn2_tpu_torch.examples.mobilenet_int8, csinn2_tpu_torch.examples.deploy_save_load\n"
        "m = MobileNetV1(alpha=0.25, input_size=32)\n"
        "m.calibrate(x, device='cpu')\n"
        "s = m.build_session(QuantScheme.INT8_SYM, batch=1, device='cpu')\n"
        "assert analyze(s).fused_sol_s > 0\n"
        "with _tf.TemporaryDirectory() as d:\n"
        "    with device_trace(d, device='cpu'):\n"
        "        want = s.run(m.prepare_input(x, s))\n"
        "    save_model(s, d + '/m', aot=True)\n"
        "    assert torch.equal(load_model(d + '/m', device='cpu').run(m.prepare_input(x, s)),\n"
        "                       want)\n"
        "    write_archive(d + '/a.f32', np.zeros((3, 4), np.float32))\n"
        "    assert [b.shape[0] for b in DataLoader(d + '/a.f32', (4,), 2)] == [2, 1]\n"
        "assert backend_summary('cpu').startswith('cpu')\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'jaxlib' or m == 'csinn2_tpu' or m.startswith('csinn2_tpu.')]\n"
        "print('LOADED', bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
