"""Tensor, data and expert parallelism of the PyTorch port (parallel/,
llm/model.py's tp_group / ep_group, InferenceEngine(mesh=...)) against the
JAX package on the CPU.

The port runs one process a rank: every multi-rank case goes through
parallel.launch.spawn on gloo, with a hard time limit, in a few spawns whose
ranks return numpy results (the module-scoped fixtures below); the JAX side
runs in this process on the 8-device virtual CPU mesh of tests/conftest.py.
The ranks build their weights with the port's init_params, whose numpy
stream gives the JAX package's bytes for the same seed.

Gates: qweight_concat(tp) and fuse_params(tp) equal to the JAX functions bit
for bit in every weight mode; every rank's shard of every weight and scale
equal to the JAX placement's addressable shard on the same device index
(shard_llama_params, the fused params, shard_moe_params, param_specs with
ep_axis on a 2 x 2 mesh); tp_llama_forward at tp = 2 against the JAX
tp_llama_forward and the single-device forward at the JAX tests' gate
(verify(tol=2e-2, min_cosine=0.999), cosine > 0.999); the engine over tp = 2
x dp = 2 reproducing single-device greedy tokens (lane 3 in dp group 1),
run_queue across dp groups matching single-slot outputs, and its benchmark
methods returning finite rates; ep_llama_forward at
ep = 2 and 4 and TP x EP against the single-device forward (rtol = atol =
2e-2), then a decode step on the updated cache; the port's
multihost_dryrun.py --device cpu printing PASS; spawn's failure and time
limit; the single-process and no-card paths."""

import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from csinn2_tpu_torch.kernels import launch_counts, reset_launch_counts
from csinn2_tpu_torch.llm.config import LlamaConfig as TConfig
from csinn2_tpu_torch.llm.engine import InferenceEngine, Request
from csinn2_tpu_torch.llm.model import (FLOAT, KVCache, fuse_params, init_params,
                                        llama_forward, qweight_concat, quantize_params)
from csinn2_tpu_torch.parallel.ep import ep_llama_forward, shard_moe_params
from csinn2_tpu_torch.parallel.launch import spawn
from csinn2_tpu_torch.parallel.mesh import Mesh, init_distributed, make_mesh
from csinn2_tpu_torch.parallel.tp import (local_config, shard_llama_params,
                                          tp_llama_forward)
from csinn2_tpu_torch.runtime.profiler import Tracer
from csinn2_tpu_torch.utils.verify import verify

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = TConfig.tiny()
MODES = ["float", "int8", "q8_0", "q4_0", "int4"]
TOKENS = [[3, 7, 11, 19]]
MOE_TOKENS = [[3, 1, 4, 1, 5, 9, 2, 6]]
PROMPTS = [[3, 7, 11], [5, 2], [9, 4, 1, 8]]
# tp_llama_forward cases: (weight mode, fused per tp shard)
TP_CASES = {"float": (FLOAT, False), "int8": ("int8", False),
            "float_fused": (FLOAT, True), "q4_0_fused": ("q4_0", True)}
TIME_LIMIT = 240


def _arr(x) -> np.ndarray:
    """A torch tensor or JAX / numpy array as numpy (bf16 as f32, exact)."""
    if isinstance(x, torch.Tensor):
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    a = np.asarray(x)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def _flat(tree, key="") -> dict:
    """{path: numpy} over a params tree of either package (a QWeight of
    either by its values and scales)."""
    if isinstance(tree, dict):
        return {k: v for n in sorted(tree) for k, v in _flat(tree[n], f"{key}/{n}").items()}
    if isinstance(tree, list):
        return {k: v for i, t in enumerate(tree) for k, v in _flat(t, f"{key}/{i}").items()}
    if type(tree).__name__ == "QWeight":
        out = {f"{key}.values": _arr(tree.values)}
        if tree.scales is not None:
            out[f"{key}.scales"] = _arr(tree.scales)
        return out
    return {key: _arr(tree)}


def _params(mode, seed=1, cfg=CFG):
    p = init_params(cfg, FLOAT, seed=seed, device="cpu")
    return p if mode == FLOAT else quantize_params(p, mode)


def _single_forward(params, cfg, tokens, cache=None, pos=0):
    cache = cache or KVCache.create(cfg, 1, device="cpu")
    logits, cache = llama_forward(params, torch.tensor(tokens), cache, pos, cfg)
    return logits.numpy(), cache


def _mesh_info(mesh):
    return {"coords": mesh.coords, "groups": {a: None if mesh.group(a) is None
                                              else torch.distributed.get_process_group_ranks(
                                                  mesh.group(a)) for a in mesh.shape}}


# -- the ranks' jobs (module level: spawn pickles them by name) ----------------

def _ep_job(mesh):
    cfg = TConfig.tiny_moe(4)
    params = _params(FLOAT, seed=2, cfg=cfg)
    shard = (shard_moe_params(params, mesh) if "tp" not in mesh.shape
             else shard_llama_params(params, mesh))
    lcfg = local_config(cfg, mesh.size("tp"))
    fwd = (ep_llama_forward(mesh, cfg) if "tp" not in mesh.shape
           else tp_llama_forward(mesh, cfg))
    cache = KVCache.create(lcfg, 1, device="cpu")
    logits, cache = fwd(shard, torch.tensor(MOE_TOKENS), cache, 0)
    step, _ = fwd(shard, torch.tensor(MOE_TOKENS)[:, :1], cache, 8)
    return {"shards": _flat(shard), "logits": logits.numpy(), "decode": step.numpy(),
            **_mesh_info(mesh)}


def _two_rank_job():
    """tp = 2: the shards in every mode (plain and fused), the forward cases;
    then ep = 2 on the same ranks."""
    mesh = make_mesh(tp=2, device="cpu")
    out = {"shards": {}, "fused_shards": {}, "logits": {}, **_mesh_info(mesh)}
    for mode in MODES:
        p = _params(mode)
        out["shards"][mode] = _flat(shard_llama_params(p, mesh))
        out["fused_shards"][mode] = _flat(shard_llama_params(fuse_params(p, tp=2), mesh))
    fwd = tp_llama_forward(mesh, CFG)
    for case, (mode, fused) in TP_CASES.items():
        p = _params(mode)
        p = fuse_params(p, tp=2) if fused else p
        cache = KVCache.create(local_config(CFG, 2), 1, device="cpu")
        reset_launch_counts()
        logits, cache = fwd(shard_llama_params(p, mesh), torch.tensor(TOKENS), cache, 0)
        out["logits"][case] = logits.numpy()
        out["cache_shape"] = tuple(cache.k.shape)
        out["collectives"] = {k: n for k, n in launch_counts.items()
                              if k.startswith(("all_reduce", "all_gather"))}
    out["ep2"] = _ep_job(Mesh({"ep": 2}, device="cpu"))
    return out


def _four_rank_job():
    """tp = 2 x dp = 2: the engine (lane 3 in dp group 1, run_queue across
    the dp groups); then ep = 4, then tp = 2 x ep = 2."""
    mesh = make_mesh(tp=2, dp=2, device="cpu")
    params = _params(FLOAT)
    out = _mesh_info(mesh)
    eng = InferenceEngine(CFG, params, batch=4, mesh=mesh)
    got = [int(np.argmax(eng.prefill(3, [3, 7, 11])))]
    for _ in range(3):
        got.append(int(np.argmax(eng.decode_step({3: got[-1]})[3])))
    got += eng.decode_steps({3: got[-1]}, n_steps=2)[3]
    out["lane3"] = got
    out["lane3_cache"] = tuple(eng.cache.k.shape)
    tr = Tracer()
    eng = InferenceEngine(CFG, params, batch=4, mesh=mesh, tracer=tr)
    reqs = eng.run_queue([Request(prompt=p, max_new_tokens=4) for p in PROMPTS], chunk=2)
    out["queue"] = [r.out for r in reqs]
    out["queue_slots"] = [r.slot for r in reqs]
    out["prefill_graph"] = dict(
        graphed=eng._graph_prefill, graphs=len(eng._prefill_graphs),
        prefills=len(tr.spans("prefill")),
        counters=sorted(k for k in tr.totals if k.startswith("prefill.graph_")))
    out["bench"] = (eng.benchmark_decode_device(iters=2, reps=1),
                    eng.benchmark_prefill_device(n_prompt=8, iters=1, reps=1),
                    eng.benchmark_decode(iters=1, warmup=1))
    out["ep4"] = _ep_job(Mesh({"ep": 4}, device="cpu"))
    out["tp2ep2"] = _ep_job(Mesh({"ep": 2, "tp": 2}, device="cpu"))
    return out


def _fail_on_rank_1():
    if torch.distributed.get_rank() == 1:
        raise ValueError("rank 1 fails on purpose")
    torch.distributed.barrier()
    return "unreachable"


def _sleep(seconds):
    time.sleep(seconds)
    return seconds


# -- fixtures -------------------------------------------------------------------

@pytest.fixture(scope="module")
def two_ranks():
    return spawn(_two_rank_job, 2, device="cpu", timeout_s=TIME_LIMIT)


@pytest.fixture(scope="module")
def four_ranks():
    return spawn(_four_rank_job, 4, device="cpu", timeout_s=TIME_LIMIT)


@pytest.fixture(scope="module")
def jx():
    """The JAX modules, imported here (the ranks import this file and need
    no JAX)."""
    import jax
    from csinn2_tpu.llm import model as jm
    from csinn2_tpu.llm.config import LlamaConfig
    from csinn2_tpu.parallel import ep as jep
    from csinn2_tpu.parallel import mesh as jmesh
    from csinn2_tpu.parallel import tp as jtp
    return dict(jax=jax, jm=jm, cfg=LlamaConfig.tiny(), moe_cfg=LlamaConfig.tiny_moe(4),
                ep=jep, mesh=jmesh, tp=jtp)


def _jparams(jx, mode, seed=1, cfg=None):
    jm = jx["jm"]
    p = jm.init_params(cfg or jx["cfg"], jm.FLOAT, seed=seed)
    return p if mode == FLOAT else jm.quantize_params(p, mode)


def _jax_shards(jx, placed, rank) -> dict:
    """Rank `rank`'s block of every array of a placed JAX params tree: the
    addressable shard on device `rank`."""
    dev = jx["jax"].devices()[rank]

    def local(a):
        return np.asarray(next(s.data for s in a.addressable_shards if s.device == dev))
    tree = jx["jax"].tree_util.tree_map(local, placed)
    return _flat(tree)


def _same_shards(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        assert np.array_equal(got[k], want[k]), k


# -- single process ------------------------------------------------------------

@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("tp", [2, 4])
def test_qweight_concat_matches_jax(jx, mode, tp):
    """wq|wk|wv interleaved per tp shard: the same bytes as the JAX package."""
    jm = jx["jm"]
    jp, tpp = _jparams(jx, mode), _params(mode)
    keys = ("wq", "wk", "wv")
    want = jm.qweight_concat([jp["layers"][0][k] for k in keys], tp=tp)
    got = qweight_concat([tpp["layers"][0][k] for k in keys], tp=tp)
    _same_shards(_flat(got), _flat(want))


@pytest.mark.parametrize("mode", MODES)
def test_fuse_params_tp_matches_jax(jx, mode):
    jm = jx["jm"]
    want = jm.fuse_params(_jparams(jx, mode), tp=2)
    got = fuse_params(_params(mode), tp=2)
    _same_shards(_flat(got), _flat(want))
    assert all(lp["wqkv"].layout == "plain" and lp["w13"].layout == "plain"
               for lp in got["layers"])


def test_specs_match_jax(jx):
    """param_specs (TP, and TP x EP on MoE params) and cache_spec: the JAX
    PartitionSpecs as tuples."""
    from csinn2_tpu_torch.parallel.tp import cache_spec, param_specs

    def spec_flat(tree):
        return {k: tuple(v) if v is not None else None for k, v in _spec_items(tree)}
    for make, jmake, ep in ((_params, _jparams, None), (
            lambda m: _params(m, 2, TConfig.tiny_moe(4)),
            lambda jx_, m: _jparams(jx_, m, 2, jx_["moe_cfg"]), "ep")):
        for mode in ("q8_0", "q4_0", "int8"):
            got = spec_flat(param_specs(make(mode), ep_axis=ep))
            want = spec_flat(jx["tp"].param_specs(jmake(jx, mode), ep_axis=ep))
            assert got == want
    assert tuple(jx["tp"].cache_spec().k) == cache_spec()


def _spec_items(tree, key=""):
    if isinstance(tree, dict):
        for n in sorted(tree):
            yield from _spec_items(tree[n], f"{key}/{n}")
    elif isinstance(tree, list):
        for i, t in enumerate(tree):
            yield from _spec_items(t, f"{key}/{i}")
    elif type(tree).__name__ == "QWeight":
        yield f"{key}.values", tree.values
        yield f"{key}.scales", tree.scales
    else:
        yield key, tree


def test_single_process_stays_local_and_cuda_raises_without_a_card(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert init_distributed(device="cpu") == 1
    assert not torch.distributed.is_initialized()
    mesh = make_mesh(device="cpu")
    assert mesh.shape == {"dp": 1, "tp": 1} and mesh.tp_group is None
    assert mesh.coords == {"dp": 0, "tp": 0} and mesh.device.type == "cpu"
    with pytest.raises(ValueError):
        make_mesh(tp=2, device="cpu")
    with pytest.raises(ValueError):
        local_config(CFG, 4)                 # n_kv_heads 2
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            make_mesh()                      # device="cuda" by default


# -- spawn ----------------------------------------------------------------------

def test_spawn_reports_a_failing_rank():
    with pytest.raises(RuntimeError, match="rank 1 fails on purpose"):
        spawn(_fail_on_rank_1, 2, device="cpu", timeout_s=60)


def test_spawn_time_limit_kills_the_ranks():
    t0 = time.monotonic()
    with pytest.raises(TimeoutError):
        spawn(_sleep, 1, device="cpu", timeout_s=4, args=(120,))
    assert time.monotonic() - t0 < 60


def test_mesh_coordinates_and_groups(two_ranks, four_ranks):
    assert [r["coords"] for r in two_ranks] == [{"dp": 0, "tp": 0}, {"dp": 0, "tp": 1}]
    assert two_ranks[0]["groups"] == {"dp": None, "tp": [0, 1]}
    assert [r["coords"] for r in four_ranks] == [
        {"dp": d, "tp": t} for d in range(2) for t in range(2)]
    assert four_ranks[2]["groups"] == {"dp": [0, 2], "tp": [2, 3]}
    assert four_ranks[3]["tp2ep2"]["coords"] == {"ep": 1, "tp": 1}
    assert four_ranks[1]["tp2ep2"]["groups"] == {"ep": [1, 3], "tp": [0, 1]}


# -- tensor parallelism ---------------------------------------------------------

@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("fused", [False, True])
def test_shard_llama_params_matches_jax(jx, two_ranks, mode, fused):
    jm, jtp = jx["jm"], jx["tp"]
    mesh = jx["mesh"].make_mesh(tp=2, dp=1, devices=jx["jax"].devices()[:2])
    jp = _jparams(jx, mode)
    placed = jtp.shard_llama_params(jm.fuse_params(jp, tp=2) if fused else jp, mesh)
    for r in range(2):
        _same_shards(two_ranks[r]["fused_shards" if fused else "shards"][mode],
                     _jax_shards(jx, placed, r))


@pytest.mark.parametrize("case", list(TP_CASES))
def test_tp_forward_matches_jax_and_single_device(jx, two_ranks, case):
    jm, jtp = jx["jm"], jx["tp"]
    mode, fused = TP_CASES[case]
    jp = _jparams(jx, mode)
    mesh = jx["mesh"].make_mesh(tp=2, dp=1, devices=jx["jax"].devices()[:2])
    sharded = jtp.shard_llama_params(jm.fuse_params(jp, tp=2) if fused else jp, mesh)
    fwd = jx["jax"].jit(jtp.tp_llama_forward(mesh, jx["cfg"], use_pallas=False))
    jlogits, _ = fwd(sharded, np.asarray(TOKENS, np.int32), jm.KVCache.create(jx["cfg"], batch=1),
                     0)
    single, _ = _single_forward(_params(mode), CFG, TOKENS)
    got = two_ranks[0]["logits"][case]
    assert np.array_equal(got, two_ranks[1]["logits"][case])
    for want in (np.asarray(jlogits, np.float32), single):
        r = verify(got, want, tol=2e-2, min_cosine=0.999)
        assert r.cosine_sim > 0.999, r
    assert two_ranks[0]["cache_shape"] == (CFG.n_layers, 1, CFG.max_seq_len, 1, CFG.head_dim)
    # one all_reduce after wo and after w2 a layer, one vocab all_gather
    assert two_ranks[0]["collectives"] == {"all_reduce.wo": 2, "all_reduce.w2": 2,
                                           "all_gather.logits": 1}


# -- the engine over tp = 2 x dp = 2 -----------------------------------------------

def test_engine_over_mesh_matches_single(jx, four_ranks):
    """Prefill into lane 3 (dp group 1: the owner-only store), host-stepped
    decode, then a decode_steps chunk from the same state: the single-device
    greedy tokens of the port and of the JAX engine, on every rank."""
    from csinn2_tpu.llm.engine import InferenceEngine as JEngine
    want = InferenceEngine(CFG, _params(FLOAT), batch=1, device="cpu").generate(
        [3, 7, 11], max_new_tokens=6)
    jwant = JEngine(jx["cfg"], _jparams(jx, FLOAT), batch=1, use_pallas=False).generate(
        [3, 7, 11], max_new_tokens=6)
    assert want == jwant
    for r in four_ranks:
        assert r["lane3"] == want, (r["coords"], r["lane3"], want)
        assert r["lane3_cache"] == (CFG.n_layers, 2, CFG.max_seq_len, 1, CFG.head_dim)


def test_engine_mesh_run_queue(four_ranks):
    """Continuous batching with requests in lanes of both dp groups: each
    request's tokens equal a single-slot engine's."""
    for p, *outs in zip(PROMPTS, *[r["queue"] for r in four_ranks]):
        want = InferenceEngine(CFG, _params(FLOAT), batch=1, device="cpu").generate(
            p, max_new_tokens=4)
        assert all(o == want for o in outs), (p, outs, want)
    assert four_ranks[0]["queue_slots"] == [0, 1, 2]


def test_engine_mesh_prefill_is_eager(four_ranks):
    """Over a mesh the prefill is the eager forward: no prefill graph, and
    the tracer counts no prefill.graph_* on any rank."""
    for r in four_ranks:
        assert r["prefill_graph"] == dict(graphed=False, graphs=0, prefills=len(PROMPTS),
                                          counters=[])


def test_engine_mesh_benchmarks(four_ranks):
    """The benchmark methods over the mesh: finite positive numbers on every
    rank (their step counts are the same on every rank, so the collectives
    pair up)."""
    for r in four_ranks:
        assert all(np.isfinite(v) and v > 0 for v in r["bench"]), r["bench"]


# -- expert parallelism -------------------------------------------------------------

def _moe_single():
    cfg = TConfig.tiny_moe(4)
    params = _params(FLOAT, seed=2, cfg=cfg)
    logits, cache = _single_forward(params, cfg, MOE_TOKENS)
    step, _ = _single_forward(params, cfg, [MOE_TOKENS[0][:1]], cache, 8)
    return logits, step


@pytest.mark.parametrize("layout", ["ep2", "ep4", "tp2ep2"])
def test_ep_forward_matches_single_device(two_ranks, four_ranks, layout):
    ranks = two_ranks if layout == "ep2" else four_ranks
    want, want_step = _moe_single()
    for r in ranks:
        got = r[layout]
        np.testing.assert_allclose(got["logits"], want, rtol=2e-2, atol=2e-2)
        np.testing.assert_allclose(got["decode"], want_step, rtol=2e-2, atol=2e-2)
        assert np.isfinite(got["decode"]).all()


@pytest.mark.parametrize("layout", ["ep2", "ep4", "tp2ep2"])
def test_moe_shards_match_jax(jx, two_ranks, four_ranks, layout):
    """shard_moe_params (ep) and param_specs(ep_axis="ep") on a 2 x 2
    (ep, tp) mesh: every rank's block equals the JAX placement's shard."""
    from jax.sharding import Mesh as JMesh, NamedSharding
    jax = jx["jax"]
    jp = _jparams(jx, FLOAT, seed=2, cfg=jx["moe_cfg"])
    ranks = two_ranks if layout == "ep2" else four_ranks
    n = len(ranks)
    if layout == "tp2ep2":
        mesh = JMesh(np.array(jax.devices()[:4]).reshape(2, 2), ("ep", "tp"))
        specs = jx["tp"].param_specs(jp, ep_axis="ep")
        placed = jax.tree_util.tree_map(
            lambda x, s: x if x is None or s is None else jax.device_put(
                x, NamedSharding(mesh, s)), jp, specs, is_leaf=lambda x: x is None)
    else:
        mesh = JMesh(np.array(jax.devices()[:n]), ("ep",))
        placed = jx["ep"].shard_moe_params(jp, mesh)
    for r in range(n):
        _same_shards(ranks[r][layout]["shards"], _jax_shards(jx, placed, r))


# -- the multi-controller dryrun ----------------------------------------------------

def test_multihost_dryrun_cpu_prints_pass():
    script = os.path.join(REPO, "csinn2_tpu_torch", "examples", "multihost_dryrun.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, script, "--device", "cpu"], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=TIME_LIMIT)
    assert r.returncode == 0, (r.stdout + r.stderr)[-3000:]
    assert "PASS" in r.stdout, r.stdout[-2000:]
