"""The engine's chunked decode and its benchmark methods in the PyTorch port
against the JAX package's InferenceEngine(use_pallas=False), on the CPU
(the eager loop: the captured step graph needs a card and is held to the
eager loop by tests/test_torch_cuda.py), at LlamaConfig.tiny() with the
same seeded weights carried across by params_from_numpy.

Gates: greedy tokens equal to the JAX engine's, and the slots' positions,
activity and token histories equal after each call; the benchmark methods
return finite positive numbers; the long-minus-short helper returns the
marginal cost of one iteration on a fake clock; the port's
llama_generate.py runs at its defaults on the CPU without JAX, and with
--ckpt serves a model directory converted by the port's command line."""

import importlib.util
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from csinn2_tpu.llm import model as jm
from csinn2_tpu.llm.config import LlamaConfig as JConfig
from csinn2_tpu.llm.engine import InferenceEngine as JEngine
from csinn2_tpu.llm.engine import Request as JRequest
from csinn2_tpu_torch.llm.config import LlamaConfig as TConfig
from csinn2_tpu_torch.llm.engine import InferenceEngine, Request
from csinn2_tpu_torch.llm.params import params_from_numpy
from csinn2_tpu_torch.utils.timing import long_minus_short

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROMPTS = [[3, 7, 11, 2, 9], [5, 2], list(range(1, 36))]


@pytest.fixture(scope="module")
def weights():
    """(jax params, port params), Q8_0 at LlamaConfig.tiny(), built once."""
    jp = jm.init_params(JConfig.tiny(), jm.Q8_0, seed=1)
    return jp, params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), device="cpu")


def _engines(weights, batch):
    jp, tp = weights
    return (JEngine(JConfig.tiny(), jp, batch=batch, use_pallas=False, quantized_kv=True),
            InferenceEngine(TConfig.tiny(), tp, batch=batch, quantized_kv=True,
                            device="cpu"))


def _slots(eng):
    return [(s.pos, s.active, [int(t) for t in s.tokens]) for s in eng.slots]


def _queue(make, prompts):
    return [make(p, max_new_tokens=5) for p in prompts]


def _same_queue(je, te):
    """run_queue over three requests on both engines: the same greedy tokens
    and lanes."""
    jdone = je.run_queue(_queue(JRequest, PROMPTS), chunk=2)
    tdone = te.run_queue(_queue(Request, PROMPTS), chunk=2)
    assert [r.out for r in tdone] == [r.out for r in jdone]
    assert [r.slot for r in tdone] == [r.slot for r in jdone]
    assert [r.done for r in tdone] == [r.done for r in jdone]


@pytest.mark.parametrize("n", [1, 3, 8])
def test_decode_steps_chunks_match_jax(weights, n):
    """Two lanes prefilled, then decode_steps in chunks of n (greedy): the
    same tokens and slot states as the JAX engine after every chunk."""
    je, te = _engines(weights, 2)
    nxt = {}
    for sid, p in enumerate(PROMPTS[:2]):
        nxt[sid] = te.prefill_sample(sid, p)
        assert je.prefill_sample(sid, p) == nxt[sid]
    for _ in range(2):
        want = je.decode_steps(dict(nxt), n)
        got = te.decode_steps(dict(nxt), n)
        assert got == want
        assert _slots(te) == _slots(je)
        nxt = {sid: seq[-1] for sid, seq in got.items()}


def test_decode_steps_eager_is_decode_steps_on_the_cpu(weights):
    """On the CPU decode_steps is the eager loop: the same tokens, sampled
    or greedy, from the same state."""
    _, tp = weights
    a, b = (InferenceEngine(TConfig.tiny(), tp, batch=2, quantized_kv=True, device="cpu")
            for _ in range(2))
    for e in (a, b):
        for sid, p in enumerate(PROMPTS[:2]):
            e.prefill(sid, p)
    for kw in (dict(), dict(temperature=np.array([0.8, 1.2], np.float32), seed=5, top_k=9,
                            top_p=0.9)):
        got = a.decode_steps({0: 4, 1: 9}, 4, **kw)
        assert got == b._decode_steps_eager({0: 4, 1: 9}, 4, **kw)
    assert _slots(a) == _slots(b)


def test_benchmark_decode_matches_jax_state(weights):
    """benchmark_decode marks every lane active at position >= 16 and steps
    them: the same slot states as the JAX engine's; run_queue then finds no
    free lane in either; with the lanes released, run_queue gives the JAX
    engine's tokens over the cache the benchmark wrote."""
    je, te = _engines(weights, 2)
    je.prefill(0, PROMPTS[2])
    te.prefill(0, PROMPTS[2])
    je.benchmark_decode(iters=3, warmup=1)
    tps = te.benchmark_decode(iters=3, warmup=1)
    assert np.isfinite(tps) and tps > 0
    assert _slots(te) == _slots(je)
    _same_queue(je, te)
    for eng in (je, te):
        for s in eng.slots:
            s.active, s.pos = False, 0
    _same_queue(je, te)


@pytest.mark.parametrize("batch", [1, 2])
def test_benchmark_decode_device_matches_jax_state(weights, batch):
    """benchmark_decode_device leaves the slots as they were in both
    packages (batch 1 on a scratch cache, the engine's untouched; batch 2 on
    the engine's cache); a following run_queue gives the JAX engine's
    tokens."""
    je, te = _engines(weights, batch)
    je.prefill(0, PROMPTS[0])
    te.prefill(0, PROMPTS[0])
    k0 = te.cache.k.clone()
    je.benchmark_decode_device(iters=4, reps=1)
    tps = te.benchmark_decode_device(iters=4, reps=1)
    assert np.isfinite(tps) and tps > 0
    assert _slots(te) == _slots(je)
    if batch == 1:
        assert torch.equal(te.cache.k, k0)
    else:      # lanes from position 16 on hold the benchmark's rows
        assert torch.equal(te.cache.k[:, :, :16], k0[:, :, :16])
        assert not torch.equal(te.cache.k[:, :, 16:40], k0[:, :, 16:40])
    te.slots[0].active = je.slots[0].active = False
    _same_queue(je, te)


def test_benchmark_prefill_device_matches_jax_state(weights):
    """benchmark_prefill_device returns seconds a prefill and leaves the
    engine's cache and slots as they were, as in the JAX engine."""
    je, te = _engines(weights, 2)
    k0, v0 = te.cache.k.clone(), te.cache.v.clone()
    je.benchmark_prefill_device(n_prompt=20, iters=2, reps=1)
    t = te.benchmark_prefill_device(n_prompt=20, iters=2, reps=1)
    assert np.isfinite(t) and t > 0
    assert torch.equal(te.cache.k, k0) and torch.equal(te.cache.v, v0)
    assert _slots(te) == _slots(je)
    _same_queue(je, te)


class _FakeClock:
    """Advances by fixed + per_iter·n over each fn(n), plus a slow first call
    and noise that only ever adds."""

    def __init__(self, fixed, per_iter):
        self.t, self.fixed, self.per_iter = 100.0, fixed, per_iter
        self.calls = []

    def __call__(self):
        return self.t

    def run(self, n):
        extra = 5.0 if not self.calls else 0.25 * (len(self.calls) % 3)
        self.calls.append(n)
        self.t += self.fixed + self.per_iter * n + extra


def test_long_minus_short_on_a_fake_clock():
    """(min over reps of t(short + iters)) − (min of t(short)), over iters:
    the fixed cost, the first call's extra and the noise drop out."""
    clk = _FakeClock(fixed=2.0, per_iter=0.125)
    got = long_minus_short(clk.run, 3, 16, reps=3, clock=clk)
    assert got == pytest.approx(0.125, rel=1e-12)
    assert clk.calls == [3, 19] + [3] * 3 + [19] * 3
    # a long loop no slower than the short one: a floor, not a negative time
    flat = _FakeClock(fixed=1.0, per_iter=-0.5)
    assert long_minus_short(flat.run, 2, 8, reps=2, clock=flat) == pytest.approx(1e-12 / 8)


LLAMA_GENERATE = os.path.join(REPO, "csinn2_tpu_torch", "examples", "llama_generate.py")


def test_llama_generate_runs_on_the_cpu_without_jax():
    """The port's llama_generate.py at its defaults on the CPU (Q8_0, int8
    KV) prints PASS, exits 0 and loads neither jax nor the JAX package."""
    code = ("import runpy, sys\n"
            f"sys.argv = [{LLAMA_GENERATE!r}, '--device', 'cpu', '--quant-kv']\n"
            "try:\n"
            f"    runpy.run_path({LLAMA_GENERATE!r}, run_name='__main__')\n"
            "except SystemExit as e:\n"
            "    rc = e.code\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
            "       or m == 'csinn2_tpu' or m.startswith('csinn2_tpu.')]\n"
            "print('LOADED', bad)\n"
            "sys.exit(rc or (1 if bad else 0))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "2"
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    lines = r.stdout.splitlines()
    assert "PASS" in lines and "LOADED []" in lines, r.stdout
    assert any(line.startswith("decode throughput (eager loop, device loop)") for line in lines)


def test_llama_generate_ckpt_is_not_ported(tmp_path, capsys):
    """--ckpt, once refused, serves a converted directory: a tiny GGUF with a
    vocabulary, converted by `python -m csinn2_tpu_torch convert`, then
    load_llm, its tokenizer, generate_fused and benchmark_decode_device on
    the CPU; it prints PASS."""
    from csinn2_tpu_torch.llm.gguf_io import write_gguf
    cfg = TConfig.tiny(vocab=300)
    rng = np.random.default_rng(0)
    D, Fd, kvd = cfg.dim, cfg.ffn_dim, cfg.n_kv_heads * cfg.head_dim

    def w(o, i):
        return (rng.standard_normal((o, i)) * 0.05).astype(np.float32)

    t = {"token_embd.weight": w(cfg.vocab_size, D), "output_norm.weight": np.ones(D, np.float32),
         "output.weight": w(cfg.vocab_size, D)}
    for i in range(cfg.n_layers):
        b = f"blk.{i}."
        t.update({b + "attn_norm.weight": np.ones(D, np.float32),
                  b + "ffn_norm.weight": np.ones(D, np.float32),
                  b + "attn_q.weight": w(D, D), b + "attn_k.weight": w(kvd, D),
                  b + "attn_v.weight": w(kvd, D), b + "attn_output.weight": w(D, D),
                  b + "ffn_gate.weight": w(Fd, D), b + "ffn_down.weight": w(D, Fd),
                  b + "ffn_up.weight": w(Fd, D)})
    toks = ["<unk>", "<s>", "</s>"] + [f"<0x{b:02X}>" for b in range(256)] + ["▁", "▁a", "b"]
    toks += [f"tok{i}" for i in range(len(toks), cfg.vocab_size)]
    md = {"general.architecture": "llama", "llama.embedding_length": D,
          "llama.block_count": cfg.n_layers, "llama.attention.head_count": cfg.n_heads,
          "llama.attention.head_count_kv": cfg.n_kv_heads, "llama.feed_forward_length": Fd,
          "llama.context_length": cfg.max_seq_len, "tokenizer.ggml.tokens": toks,
          "tokenizer.ggml.scores": [0.0] * len(toks)}
    write_gguf(str(tmp_path / "m.gguf"), md, t,
               quantize={k: "q8_0" for k, v in t.items() if v.ndim == 2 and "embd" not in k})
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-m", "csinn2_tpu_torch", "convert",
                        str(tmp_path / "m.gguf"), str(tmp_path / "m"), "--mode", "q8_0"],
                       cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    spec = importlib.util.spec_from_file_location("port_llama_generate", LLAMA_GENERATE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.main(["--ckpt", str(tmp_path / "m"), "--device", "cpu", "--quant-kv",
                     "--tokens", "4", "--prompt", "a b"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert "PASS" in lines and any(x.startswith("prompt -> ") for x in lines), lines
