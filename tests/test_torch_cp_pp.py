"""Context and pipeline parallelism of the PyTorch port (parallel/cp.py,
parallel/pp.py, mesh.py's point-to-point helpers) against the JAX package on
the CPU.

The port runs one process a rank: its ranks go through
parallel.launch.spawn on gloo in three spawns (2, 4 and 8 ranks, the
module-scoped fixtures below) whose ranks return numpy results; the JAX side
runs in this process on the 8-device virtual CPU mesh of tests/conftest.py.
Weights come from the port's init_params, whose numpy stream gives the JAX
package's bytes for the same seed.

Gates, each the analog of a JAX test:
  ring_attention at cp 2 / 4 / 8, causal and not, against the JAX
  ring_attention and reference at rtol = atol = 2e-5, and bf16 at 0.05
  (tests/test_ring_attention.py); K and V shifted 2 (n - 1) times a call;
  PipelinedLlama at (stages, microbatches) (2, 1) and (4, 2), pp x MoE, and
  Q8_0 with an int8 KV cache; SPMDPipelinedLlama at (2, 2) and (4, 2) (and
  Q8_0 with an int8 KV cache), pp x tp at (2, 4) and (4, 2): prefill logits,
  the cache and a decode step at pos 8 against the JAX classes at rtol =
  atol = 2e-2 (tests/test_moe_pp.py), and every case bit for bit against
  the port's own one-process forward run microbatch by microbatch in the
  same process (llama_forward, or its pieces embed_tokens / llama_layers /
  llama_head where the SPMD class runs the head over the whole batch or the
  layers under tp); a second SPMD call at a new pos on the same sharded
  tensors; the GPipe tick schedule at (4, 4) and (4, 8) through the counts
  (M + P - 1 ticks, M stage computes a rank, M sends on every rank but the
  last); the C.1 depth check: at a narrow 32-layer config the port's tp = 2
  forward falls from its one-process forward no further than the JAX
  tp_llama_forward falls from its one device, in logits and in every
  layer's KV cache."""

import dataclasses

import numpy as np
import pytest
import torch

from csinn2_tpu_torch.kernels import launch_counts, reset_launch_counts
from csinn2_tpu_torch.llm.config import LlamaConfig as TConfig
from csinn2_tpu_torch.llm.model import (FLOAT, KVCache, embed_tokens, init_params,
                                        llama_forward, llama_head, llama_layers,
                                        quantize_params)
from csinn2_tpu_torch.parallel.cp import (gather_sequence, ring_attention,
                                          ring_attention_reference, shard_sequence)
from csinn2_tpu_torch.parallel.launch import spawn
from csinn2_tpu_torch.parallel.mesh import Mesh, neighbour, recv_into, send, shift
from csinn2_tpu_torch.parallel.pp import PipelinedLlama, SPMDPipelinedLlama, gpipe_schedule
from csinn2_tpu_torch.parallel.tp import local_config, shard_llama_params, tp_llama_forward
from csinn2_tpu_torch.utils.verify import cosine_similarity

TIME_LIMIT = 240
TOKENS = [[3, 1, 4, 1, 5, 9, 2, 6]]
# the JAX tests' configs (tests/test_moe_pp.py)
PP_CFG = dict(dim=64, n_layers=4, n_heads=4, n_kv_heads=2, ffn_dim=128, vocab_size=256,
              max_seq_len=64)
PPTP_CFG = dict(PP_CFG, n_kv_heads=4)
MOE_CFG = dict(dim=64, n_layers=2, n_heads=4, n_kv_heads=2, ffn_dim=128, vocab_size=128,
               max_seq_len=32, n_experts=2, moe_top_k=1)
TICK_CFG = dict(dim=32, n_layers=4, n_heads=2, n_kv_heads=2, ffn_dim=64, vocab_size=64,
                max_seq_len=32)
EXEC_CFG = dict(TICK_CFG, n_layers=2)
# C.1: a narrow 32-layer config, a 32-token prompt
DEPTH_CFG = dict(dim=256, n_layers=32, n_heads=4, n_kv_heads=4, ffn_dim=512, vocab_size=512,
                 max_seq_len=64)
DEPTH_TOKENS = [[int(t) for t in np.random.default_rng(3).integers(1, 512, 32)]]
# C.1's margin: the port's deficit (1 - cosine) against its one process may
# be at most DEPTH_RATIO times the JAX pair's plus DEPTH_FLOOR.  Both pairs
# fall ~1e-4 at 32 layers from rounding alone (the bf16 partial sums of wo
# and w2 reduced across ranks).  The JAX pair falls 10-25 % less, because
# XLA's CPU backend skips bf16 roundings of intermediates (its default
# --xla_allow_excess_precision; with it off the two pairs agree within 7 %
# at every layer); DEPTH_FLOOR covers the first layers, where both are ~0.
# Skipping one layer's wo all_reduce of 32 costs ~1e-2, swapping two heads'
# wv shards ~4e-2.
DEPTH_RATIO, DEPTH_FLOOR = 1.5, 1e-5
# SPMD cases: (name, config, seed, pp, tp, microbatches, weight mode, int8 KV)
SPMD_CASES = {"2x2": (PP_CFG, 5, 2, 1, 2, FLOAT, False),
              "4x2": (PP_CFG, 5, 4, 1, 2, FLOAT, False),
              "2x2_q8_0_kv8": (PP_CFG, 5, 2, 1, 2, "q8_0", True),
              "pp2tp4": (PPTP_CFG, 5, 2, 4, 2, FLOAT, False),
              "pp4tp2": (PPTP_CFG, 5, 4, 2, 2, FLOAT, False)}


def _arr(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    a = np.asarray(x)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def _params(cfg_kw, seed, mode=FLOAT):
    p = init_params(TConfig(**cfg_kw), FLOAT, seed=seed, device="cpu")
    return p if mode == FLOAT else quantize_params(p, mode)


def _ring_inputs(dtype="f32"):
    """The JAX tests' inputs: [2, 4, 64, 16] f32, or [1, 2, 32, 8] bf16 values
    (q and k times 4) as f32 arrays."""
    rng = np.random.default_rng(42)
    if dtype == "f32":
        return [rng.standard_normal((2, 4, 64, 16)).astype(np.float32) for _ in range(3)]
    shape = (1, 2, 32, 8)
    q, k = ((rng.standard_normal(shape) * 4).astype(np.float32) for _ in range(2))
    v = rng.standard_normal(shape).astype(np.float32)
    return [torch.from_numpy(a).to(torch.bfloat16).float().numpy() for a in (q, k, v)]


def _rows(cache, lo, hi):
    return KVCache(k=cache.k[:, lo:hi], v=cache.v[:, lo:hi], scale=cache.scale)


def _mb_reference(params, layers, cfg, lcfg, mesh, cache, tokens, pos, M):
    """The SPMD pipeline's function without the pipeline: llama_forward's
    pieces over all of `layers` (this rank's tp shard of every layer under
    tp, with the tp all_reduces), microbatch by microbatch into `cache`'s
    rows, then the head over the whole batch."""
    mb = tokens.shape[0] // M
    x = embed_tokens(params, tokens)
    hs = [llama_layers(layers, x[m * mb:(m + 1) * mb], _rows(cache, m * mb, (m + 1) * mb),
                       pos, lcfg, tp_group=mesh.tp_group) for m in range(M)]
    return llama_head(params, torch.cat(hs), cfg)


# -- the ranks' jobs (module level: spawn pickles them by name) ----------------

def _ring_job(mesh, dtype="f32", causals=(True, False)):
    """ring_attention on this rank's shards → the gathered output per causal
    setting, and the shifts a call."""
    q, k, v = (torch.from_numpy(a) for a in _ring_inputs(dtype))
    if dtype == "bf16":
        q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
    out = {}
    for causal in causals:
        reset_launch_counts()
        o = ring_attention(*(shard_sequence(t, mesh) for t in (q, k, v)), mesh, causal=causal)
        out[causal] = dict(shifts=launch_counts["p2p.cp"], dtype=str(o.dtype),
                           out=_arr(gather_sequence(o, mesh)))
    return out


def _spmd_job(name):
    """One SPMD case on a (pp[, tp]) mesh: the JAX test's prefill of the
    tiled TOKENS and decode step at pos 8, the local cache after the
    prefill, and the same two calls of the one-process reference run
    microbatch by microbatch on this rank: bit for bit."""
    cfg_kw, seed, pp, tp, M, mode, kv8 = SPMD_CASES[name]
    cfg = TConfig(**cfg_kw)
    axes = {"pp": pp, "tp": tp} if tp > 1 else {"pp": pp}
    mesh = Mesh(axes, device="cpu")
    params = _params(cfg_kw, seed, mode)
    toks = torch.tensor(np.tile(TOKENS, (4, 1)))
    pipe = SPMDPipelinedLlama(params, cfg, mesh=mesh, microbatches=M)
    cache = pipe.init_cache(4, quantized=kv8)
    reset_launch_counts()
    logits, cache = pipe(toks, cache, 0)
    counts = dict(launch_counts)
    k_pre = cache.k.clone()
    step, cache = pipe(toks[:, :1], cache, 8)

    # the reference: every layer on this rank (its tp shard under tp), the
    # microbatches one after another, the head over the whole batch
    lcfg = local_config(cfg, tp)
    layers = shard_llama_params(params, mesh)["layers"] if tp > 1 else params["layers"]
    ref = KVCache.create(lcfg, 4, quantized=kv8, device="cpu")

    def reference(t, pos):
        return _mb_reference(params, layers, cfg, lcfg, mesh, ref, t, pos, M)
    want = reference(toks, 0)
    lo, hi = pipe.stage * pipe.Lp, (pipe.stage + 1) * pipe.Lp
    exact = {"logits": torch.equal(logits, want), "cache": torch.equal(k_pre, ref.k[lo:hi])}
    exact["decode"] = torch.equal(step, reference(toks[:, :1], 8))
    exact["cache_v"] = torch.equal(cache.v, ref.v[lo:hi])
    if tp == 1:
        # llama_forward itself, microbatch by microbatch: the same cache rows
        # (and, at one microbatch, the same logits)
        ref2 = KVCache.create(cfg, 4, quantized=kv8, device="cpu")
        mb = 4 // M
        lf = torch.cat([llama_forward(params, toks[m * mb:(m + 1) * mb],
                                      _rows(ref2, m * mb, (m + 1) * mb), 0, cfg)[0]
                        for m in range(M)])
        exact["llama_forward_cache"] = torch.equal(k_pre, ref2.k[lo:hi])
        if M == 1:
            exact["llama_forward_logits"] = torch.equal(logits, lf)
    return dict(logits=_arr(logits), step=_arr(step), cache_k=_arr(k_pre), exact=exact,
                counts=counts, coords=mesh.coords, stage=pipe.stage, Lp=pipe.Lp)


def _exec_job():
    """A second call at a new pos runs on the tensors the constructor
    sharded (the same data_ptrs), and gives the reference's logits."""
    cfg = TConfig(**EXEC_CFG)
    params = _params(EXEC_CFG, 6)
    pipe = SPMDPipelinedLlama(params, cfg, microbatches=2, device="cpu")

    def ptrs():
        out = []
        for lp in pipe.layers:
            for w in lp.values():
                out += [w.data_ptr()] if isinstance(w, torch.Tensor) else [w.values.data_ptr()]
        return out + [pipe.head["tok_embedding"].data_ptr(), pipe.head["output"].values.data_ptr()]
    before = ptrs()
    cache = pipe.init_cache(2)
    toks = torch.tensor([[1, 2], [3, 4]])
    _, cache = pipe(toks, cache, 0)
    after_first = ptrs()
    second, cache = pipe(toks, cache, 2)
    ref = KVCache.create(cfg, 2, device="cpu")
    _mb_reference(params, params["layers"], cfg, cfg, pipe.mesh, ref, toks, 0, 2)
    want = _mb_reference(params, params["layers"], cfg, cfg, pipe.mesh, ref, toks, 2, 2)
    return dict(same_ptrs=before == after_first == ptrs(), n_tensors=len(before),
                second=_arr(second), want=_arr(want))


def _tick_job(M):
    cfg = TConfig(**TICK_CFG)
    pipe = SPMDPipelinedLlama(_params(TICK_CFG, 7), cfg, microbatches=M, device="cpu")
    cache = pipe.init_cache(M)
    reset_launch_counts()
    pipe(torch.arange(4 * M).reshape(M, 4) % cfg.vocab_size, cache, 0)
    return dict(counts=dict(launch_counts), schedule=pipe.schedule)


def _p2p_job():
    """mesh.neighbour / shift / send / recv_into on a 2 x 2 mesh: each rank
    sends its rank number."""
    mesh = Mesh({"a": 2, "b": 2}, device="cpu")
    me = torch.full((3,), float(mesh.rank))
    reset_launch_counts()
    out = dict(next_b=neighbour(mesh, "b", 1), prev_a=neighbour(mesh, "a", -1),
               from_b=shift(me, mesh, "b", 1, "t").tolist(),
               from_a=shift(me, mesh, "a", -1, "t").tolist())
    buf = torch.zeros(3)
    if mesh.rank == 0:
        send(me + 10, 3, "chain")
    elif mesh.rank == 3:
        out["chain"] = recv_into(buf, 0, "chain").tolist()
    out["counts"] = dict(launch_counts)
    return out


def _depth_job():
    """C.1: the port's tp = 2 forward of DEPTH_CFG in FLOAT and Q8_0: the
    logits and this rank's KV cache shard."""
    mesh = Mesh({"dp": 1, "tp": 2}, device="cpu")
    cfg = TConfig(**DEPTH_CFG)
    fwd = tp_llama_forward(mesh, cfg)
    out = {}
    for mode in (FLOAT, "q8_0"):
        cache = KVCache.create(local_config(cfg, 2), 1, device="cpu")
        logits, cache = fwd(shard_llama_params(_params(DEPTH_CFG, 1, mode), mesh),
                            torch.tensor(DEPTH_TOKENS), cache, 0)
        out[mode] = dict(logits=_arr(logits), k=_arr(cache.k), v=_arr(cache.v))
    return out


def _two_rank_job():
    mesh = Mesh({"cp": 2}, device="cpu")
    return dict(ring=_ring_job(mesh), spmd={n: _spmd_job(n) for n in
                                            ("2x2", "2x2_q8_0_kv8")},
                exec=_exec_job(), depth=_depth_job())


def _four_rank_job():
    mesh = Mesh({"cp": 4}, device="cpu")
    return dict(ring=_ring_job(mesh), ring_bf16=_ring_job(mesh, "bf16", (True,)),
                spmd={"4x2": _spmd_job("4x2")}, ticks={M: _tick_job(M) for M in (4, 8)},
                p2p=_p2p_job())


def _eight_rank_job():
    mesh = Mesh({"cp": 8}, device="cpu")
    return dict(ring=_ring_job(mesh), spmd={n: _spmd_job(n) for n in ("pp2tp4", "pp4tp2")})


# -- fixtures -------------------------------------------------------------------

@pytest.fixture(scope="module")
def ranks():
    """{world size: the ranks' results} of the three spawns."""
    return {n: spawn(job, n, device="cpu", timeout_s=TIME_LIMIT) for n, job in
            ((2, _two_rank_job), (4, _four_rank_job), (8, _eight_rank_job))}


@pytest.fixture(scope="module")
def jx():
    """The JAX modules, imported here (the ranks import this file and need
    no JAX)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh as JMesh
    from csinn2_tpu.llm import model as jm
    from csinn2_tpu.llm.config import LlamaConfig
    from csinn2_tpu.parallel import cp as jcp
    from csinn2_tpu.parallel import mesh as jmesh
    from csinn2_tpu.parallel import pp as jpp
    from csinn2_tpu.parallel import tp as jtp
    return dict(jax=jax, jnp=jnp, JMesh=JMesh, jm=jm, cfg=LlamaConfig, cp=jcp, mesh=jmesh,
                pp=jpp, tp=jtp)


def _jparams(jx, cfg_kw, seed, mode=FLOAT):
    jm = jx["jm"]
    p = jm.init_params(jx["cfg"](**cfg_kw), jm.FLOAT, seed=seed)
    return p if mode == FLOAT else jm.quantize_params(p, mode)


def _close(got, want, tol):
    np.testing.assert_allclose(got, _arr(want), rtol=tol, atol=tol)


def _cos(a, b) -> float:
    return float(cosine_similarity(_arr(a), _arr(b)))


# -- ring attention -------------------------------------------------------------

@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("cp", [2, 4, 8])
def test_ring_matches_jax(jx, ranks, causal, cp):
    jnp = jx["jnp"]
    q, k, v = _ring_inputs()
    mesh = jx["JMesh"](np.array(jx["jax"].devices()[:cp]), ("cp",))
    jring = jx["cp"].ring_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), mesh,
                                    causal=causal)
    jref = jx["cp"].ring_attention_reference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                             causal=causal)
    for r in ranks[cp]:
        got = r["ring"][causal]
        assert got["shifts"] == 2 * (cp - 1) and got["dtype"] == "torch.float32"
        _close(got["out"], jring, 2e-5)
        _close(got["out"], jref, 2e-5)
        assert np.array_equal(got["out"], ranks[cp][0]["ring"][causal]["out"])


def test_ring_bf16_matches_jax(jx, ranks):
    jnp = jx["jnp"]
    q, k, v = (jnp.asarray(a, jnp.bfloat16) for a in _ring_inputs("bf16"))
    mesh = jx["JMesh"](np.array(jx["jax"].devices()[:4]), ("cp",))
    jring = jx["cp"].ring_attention(q, k, v, mesh, causal=True)
    jref = jx["cp"].ring_attention_reference(q, k, v, causal=True)
    for r in ranks[4]:
        got = r["ring_bf16"][True]
        assert got["dtype"] == "torch.bfloat16" and np.isfinite(got["out"]).all()
        _close(got["out"], jring, 0.05)
        _close(got["out"], jref, 0.05)


@pytest.mark.parametrize("q_block", [None, 24])
def test_ring_reference_matches_jax(jx, q_block):
    """The port's one-device golden (whole, and in query blocks of 24 rows,
    a ragged last block) against the JAX golden, and the port's ring at one
    rank (no shift) against it."""
    jnp = jx["jnp"]
    q, k, v = _ring_inputs()
    for causal in (True, False):
        want = jx["cp"].ring_attention_reference(jnp.asarray(q), jnp.asarray(k),
                                                 jnp.asarray(v), causal=causal)
        tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
        got = ring_attention_reference(tq, tk, tv, causal=causal, q_block=q_block)
        _close(_arr(got), want, 2e-5)
        reset_launch_counts()
        one = ring_attention(tq, tk, tv, Mesh({"cp": 1}, device="cpu"), causal=causal)
        _close(_arr(one), want, 2e-5)
        assert launch_counts["p2p.cp"] == 0


# -- point-to-point helpers ------------------------------------------------------

def test_p2p_helpers(ranks):
    """Ranks (a, b) = r // 2, r % 2: a shift along b by +1 brings the rank
    one behind along b, along a by -1 the rank one ahead; send / recv_into
    carry a chain link from rank 0 to rank 3."""
    for r, got in enumerate(r["p2p"] for r in ranks[4]):
        a, b = divmod(r, 2)
        assert got["next_b"] == a * 2 + (b + 1) % 2 and got["prev_a"] == ((a - 1) % 2) * 2 + b
        assert got["from_b"] == [float(a * 2 + (b - 1) % 2)] * 3
        assert got["from_a"] == [float(((a + 1) % 2) * 2 + b)] * 3
        assert got["counts"].get("p2p.t") == 2
    assert ranks[4][3]["p2p"]["chain"] == [10.0] * 3
    assert ranks[4][0]["p2p"]["counts"]["p2p.chain"] == 1
    assert ranks[4][3]["p2p"]["counts"]["p2p.chain.recv"] == 1


# -- the host-stepped pipeline ------------------------------------------------------

def _pp_case(cfg_kw, seed, stages, micro, batch, mode=FLOAT, kv8=False, decode=True):
    """PipelinedLlama on ["cpu"] * stages: prefill (and a decode step at pos
    8), and llama_forward run microbatch by microbatch on a full-depth cache:
    the same logits and cache rows bit for bit."""
    cfg = TConfig(**cfg_kw)
    params = _params(cfg_kw, seed, mode)
    toks = torch.tensor(np.tile(TOKENS, (batch, 1)))
    pipe = PipelinedLlama(params, cfg, ["cpu"] * stages)
    caches = pipe.init_caches(batch, quantized=kv8)
    got, caches = pipe(toks, caches, 0, microbatches=micro)
    k_pre = torch.cat([c.k for c in caches]).clone()
    ref = KVCache.create(cfg, batch, quantized=kv8, device="cpu")
    mb = batch // micro

    def per_mb(t, pos):
        return torch.cat([llama_forward(params, t[m * mb:(m + 1) * mb],
                                        _rows(ref, m * mb, (m + 1) * mb), pos, cfg)[0]
                          for m in range(micro)])
    assert torch.equal(got, per_mb(toks, 0))
    assert torch.equal(k_pre, ref.k)
    out = {"logits": got}
    if decode:
        out["step"], caches = pipe(toks[:, :1], caches, 8, microbatches=micro)
        assert torch.equal(out["step"], per_mb(toks[:, :1], 8))
        assert torch.equal(torch.cat([c.v for c in caches]), ref.v)
    return out


def _jax_pp(jx, cfg_kw, seed, stages, micro, batch, mode=FLOAT, kv8=False, decode=True):
    jnp = jx["jnp"]
    pipe = jx["pp"].PipelinedLlama(_jparams(jx, cfg_kw, seed, mode), jx["cfg"](**cfg_kw),
                                   jx["jax"].devices()[:stages], use_pallas=False)
    toks = jnp.asarray(np.tile(TOKENS, (batch, 1)))
    logits, caches = pipe(toks, pipe.init_caches(batch=batch, quantized=kv8), 0,
                          microbatches=micro)
    out = {"logits": logits}
    if decode:
        out["step"], _ = pipe(toks[:, :1], caches, 8, microbatches=micro)
    return out


@pytest.mark.parametrize("stages,micro", [(2, 1), (4, 2)])
def test_pp_matches_jax(jx, stages, micro):
    got = _pp_case(PP_CFG, 3, stages, micro, 2)
    want = _jax_pp(jx, PP_CFG, 3, stages, micro, 2)
    for key in ("logits", "step"):
        _close(_arr(got[key]), want[key], 2e-2)


def test_pp_moe_matches_jax(jx):
    """pp x MoE: 2 stages of MoE layers (dense dispatch), one microbatch."""
    got = _pp_case(MOE_CFG, 4, 2, 1, 1, decode=False)
    want = _jax_pp(jx, MOE_CFG, 4, 2, 1, 1, decode=False)
    _close(_arr(got["logits"]), want["logits"], 2e-2)


def test_pp_q8_0_int8_kv_matches_jax(jx):
    got = _pp_case(PP_CFG, 3, 2, 2, 4, mode="q8_0", kv8=True)
    want = _jax_pp(jx, PP_CFG, 3, 2, 2, 4, mode="q8_0", kv8=True)
    for key in ("logits", "step"):
        _close(_arr(got[key]), want[key], 2e-2)


def test_pp_stage_runs_moe_dense():
    """At 256 tokens and more llama_forward takes the routed MoE dispatch
    (here with a capacity that drops tokens); a pipeline stage stays dense, as the JAX stage function does: its
    logits equal llama_forward's under moe_dispatch="dense"."""
    cfg = dataclasses.replace(TConfig(**MOE_CFG), max_seq_len=256, n_experts=4, moe_top_k=2,
                              moe_capacity_factor=0.5)
    params = _params(dataclasses.asdict(cfg), 4)
    toks = torch.arange(256)[None] % cfg.vocab_size
    pipe = PipelinedLlama(params, cfg, ["cpu"] * 2)
    got, _ = pipe(toks, pipe.init_caches(1), 0)
    dense = dataclasses.replace(cfg, moe_dispatch="dense")
    want, _ = llama_forward(params, toks, KVCache.create(cfg, 1, device="cpu"), 0, dense)
    auto, _ = llama_forward(params, toks, KVCache.create(cfg, 1, device="cpu"), 0, cfg)
    assert torch.equal(got, want)
    assert not torch.equal(auto, want)


# -- the SPMD pipeline ---------------------------------------------------------------

def _jax_spmd(jx, name):
    jax, jnp = jx["jax"], jx["jnp"]
    cfg_kw, seed, pp, tp, M, mode, kv8 = SPMD_CASES[name]
    kw = dict(n_stages=pp) if tp == 1 else dict(
        mesh=jx["JMesh"](np.array(jax.devices()[:pp * tp]).reshape(pp, tp), ("pp", "tp")))
    pipe = jx["pp"].SPMDPipelinedLlama(_jparams(jx, cfg_kw, seed, mode), jx["cfg"](**cfg_kw),
                                       microbatches=M, use_pallas=False, **kw)
    toks = jnp.asarray(np.tile(TOKENS, (4, 1)))
    logits, cache = pipe(toks, pipe.init_cache(batch=4, quantized=kv8), 0)
    k_pre = np.asarray(cache.k, np.float32)
    step, _ = pipe(toks[:, :1], cache, 8)
    return dict(logits=logits, step=step, cache_k=k_pre)


def _check_spmd(jx, ranks, name):
    cfg_kw, seed, pp, tp, M, mode, kv8 = SPMD_CASES[name]
    want = _jax_spmd(jx, name)
    hk = cfg_kw["n_kv_heads"] // tp
    for r in ranks:
        assert all(r["exact"].values()), (r["coords"], r["exact"])
        _close(r["logits"], want["logits"], 2e-2)
        _close(r["step"], want["step"], 2e-2)
        # this rank's block of the JAX cache: its layers, its heads
        t = r["coords"].get("tp", 0)
        lo = r["stage"] * r["Lp"]
        jk = want["cache_k"][lo:lo + r["Lp"], :, :, t * hk:(t + 1) * hk]
        if kv8:
            # int8 carriers: the two packages' K differ by rounding, and where
            # that straddles a half step of the quantizer the carriers are
            # neighbours (~1 % of the prompt's rows)
            n = len(TOKENS[0])
            assert np.abs(r["cache_k"] - jk).max() <= 1
            assert np.mean(r["cache_k"][:, :, :n] != jk[:, :, :n]) < 0.05
        else:
            _close(r["cache_k"], jk, 2e-2)
        assert np.array_equal(r["logits"], ranks[0]["logits"])


@pytest.mark.parametrize("name", ["2x2", "4x2", "2x2_q8_0_kv8"])
def test_spmd_pipeline_matches_jax(jx, ranks, name):
    """(stages, microbatches) = (2, 2), (4, 2), and (2, 2) in Q8_0 with an
    int8 KV cache: prefill, cache, decode at pos 8."""
    _check_spmd(jx, [r["spmd"][name] for r in ranks[SPMD_CASES[name][2]]], name)


@pytest.mark.parametrize("name", ["pp2tp4", "pp4tp2"])
def test_spmd_pipeline_pp_tp_matches_jax(jx, ranks, name):
    _check_spmd(jx, [r["spmd"][name] for r in ranks[8]], name)


def test_spmd_pipeline_reuses_its_shards(ranks):
    """The analog of the JAX test's one executable: a second call at a new
    pos runs on the tensors the constructor placed (no re-sharding), and
    gives llama_forward's logits."""
    for r in ranks[2]:
        assert r["exec"]["same_ptrs"] and r["exec"]["n_tensors"] > 10
        assert np.array_equal(r["exec"]["second"], r["exec"]["want"])


@pytest.mark.parametrize("micro", [4, 8])
def test_spmd_tick_schedule(ranks, micro):
    """GPipe at P = 4: M + P - 1 ticks on every rank, M stage computes a
    rank, M sends from every stage but the last and M receives on every
    stage but the first; the bubble (P - 1)/(M + P - 1) < 0.5."""
    P = 4
    for s, r in enumerate(x["ticks"][micro] for x in ranks[4]):
        c = r["counts"]
        assert r["schedule"] == gpipe_schedule(P, micro, s)
        assert c["pipeline.tick"] == micro + P - 1
        assert c["pipeline.stage"] == micro
        assert c.get("p2p.pp", 0) == (micro if s < P - 1 else 0)
        assert c.get("p2p.pp.recv", 0) == (micro if s > 0 else 0)
        assert c["broadcast.pp"] == 1
    busy = [sum(m is not None for m in gpipe_schedule(P, micro, s)) for s in range(P)]
    assert busy == [micro] * P
    assert (P - 1) / (micro + P - 1) < 0.5


def test_gpipe_schedule():
    assert gpipe_schedule(2, 3, 0) == [0, 1, 2, None]
    assert gpipe_schedule(2, 3, 1) == [None, 0, 1, 2]
    assert gpipe_schedule(1, 2, 0) == [0, 1]


def test_pipelines_reject_bad_shapes():
    """One process (world 1): a mesh without a pp axis, layers that do not
    split into the stages, a batch that does not split into the
    microbatches."""
    cfg = TConfig(**TICK_CFG)
    params = _params(TICK_CFG, 7)
    with pytest.raises(ValueError):
        SPMDPipelinedLlama(params, cfg, mesh=Mesh({"tp": 1}, device="cpu"))
    with pytest.raises(ValueError):
        PipelinedLlama(params, cfg, ["cpu"] * 3)
    pipe = SPMDPipelinedLlama(params, cfg, microbatches=2, device="cpu")
    with pytest.raises(ValueError):
        pipe(torch.zeros((3, 2), dtype=torch.long), pipe.init_cache(3), 0)


# -- C.1: the depth of the tp = 2 gap ---------------------------------------------------

def _deficit(a, b) -> float:
    return 1.0 - _cos(a, b)


@pytest.mark.parametrize("mode", [FLOAT, "q8_0"])
def test_tp_depth_gap_matches_jax(jx, ranks, mode):
    """C.1: at 32 layers (dim 256) the port's tp = 2 forward (gloo) lies from
    its one-process forward no further than the JAX tp_llama_forward (2
    virtual devices) lies from its one device, within DEPTH_RATIO and
    DEPTH_FLOOR: in the
    logits and in every layer's K and V cache (the ranks' head shards put
    together).  A fault of sharding (a lost all_reduce, a head's shard in
    the wrong place) opens a gap far past the margin."""
    jax, jnp, jm, jtp = jx["jax"], jx["jnp"], jx["jm"], jx["tp"]
    cfg = TConfig(**DEPTH_CFG)
    one = KVCache.create(cfg, 1, device="cpu")
    logits, one = llama_forward(_params(DEPTH_CFG, 1, mode), torch.tensor(DEPTH_TOKENS), one,
                                0, cfg)
    port = dict(logits=_arr(logits), k=_arr(one.k), v=_arr(one.v))
    shards = [r["depth"][mode] for r in ranks[2]]
    port_tp = dict(logits=shards[0]["logits"],
                   **{kv: np.concatenate([s[kv] for s in shards], axis=3) for kv in "kv"})

    jcfg = jx["cfg"](**DEPTH_CFG)
    jp = _jparams(jx, DEPTH_CFG, 1, mode)
    toks = np.asarray(DEPTH_TOKENS, np.int32)
    jone_l, jone = jax.jit(lambda p, t, c: jm.llama_forward(p, t, c, 0, jcfg, use_pallas=False))(
        jp, toks, jm.KVCache.create(jcfg, batch=1))
    mesh = jx["mesh"].make_mesh(tp=2, dp=1, devices=jax.devices()[:2])
    jtp_l, jtpc = jax.jit(jtp.tp_llama_forward(mesh, jcfg, use_pallas=False))(
        jtp.shard_llama_params(jp, mesh), toks, jm.KVCache.create(jcfg, batch=1), 0)
    jone = dict(logits=jone_l, k=jone.k, v=jone.v)
    jtp_ = dict(logits=jtp_l, k=jtpc.k, v=jtpc.v)

    assert np.array_equal(shards[0]["logits"], shards[1]["logits"])
    gap_port = _deficit(port_tp["logits"], port["logits"])
    gap_jax = _deficit(jtp_["logits"], jone["logits"])
    assert gap_port <= DEPTH_RATIO * gap_jax + DEPTH_FLOOR, (gap_port, gap_jax)
    for kv in "kv":
        for layer in range(cfg.n_layers):
            gp = _deficit(port_tp[kv][layer], port[kv][layer])
            gj = _deficit(_arr(jtp_[kv])[layer], _arr(jone[kv])[layer])
            assert gp <= DEPTH_RATIO * gj + DEPTH_FLOOR, (kv, layer, gp, gj)
