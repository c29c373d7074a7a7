"""The PyTorch port's LLM weight I/O against the JAX package, on the CPU:
GGUF writer and reader, the SP-BPE tokenizer, the CTBM serializer (the
port's own build of native/bmfmt.cpp), save_llm / load_llm and the GGUF and
HF converters, and the `python -m csinn2_tpu_torch` command line.

Gates: files byte-identical to the JAX package's (GGUF, weights.ctbm,
config.json, tokenizer.json); each package loads the other's model
directory (MoE, packed int4 and fused weights included) with the same
tensors and llama_forward logits cosine >= 0.999; a converted synthetic
GGUF at logit cosine >= 0.999 against the float forward on its
pre-conversion weights (bench.py's real-weights gate)."""

import dataclasses
import filecmp
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from csinn2_tpu.llm import gguf_io as jg
from csinn2_tpu.llm import model as jm
from csinn2_tpu.llm.config import LlamaConfig as JConfig
from csinn2_tpu.llm.convert import convert_gguf as j_convert_gguf
from csinn2_tpu.llm.json_io import load_llm as j_load_llm
from csinn2_tpu.llm.json_io import save_llm as j_save_llm
from csinn2_tpu.llm.tokenizer import SPTokenizer as JTokenizer
from csinn2_tpu.runtime import bm as jbm
from csinn2_tpu.utils.verify import cosine_similarity
from csinn2_tpu_torch.llm import gguf_io as tg
from csinn2_tpu_torch.llm import model as tm
from csinn2_tpu_torch.llm.config import LlamaConfig as TConfig
from csinn2_tpu_torch.llm.convert import convert_gguf, convert_hf
from csinn2_tpu_torch.llm.json_io import load_llm, save_llm
from csinn2_tpu_torch.llm.tokenizer import SPTokenizer, load_tokenizer
from csinn2_tpu_torch.runtime import bm as tbm

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODES = ["float", "int8", "int4", "q8_0", "q4_0"]


def _tiny(cls=JConfig):
    return cls(dim=64, n_layers=2, n_heads=4, n_kv_heads=2, ffn_dim=96, vocab_size=199,
               max_seq_len=64, norm_eps=1e-5, rope_base=10000.0)


def _metadata(cfg, with_vocab=True):
    md = {"general.architecture": "llama", "general.alignment": 32,
          "llama.embedding_length": cfg.dim, "llama.block_count": cfg.n_layers,
          "llama.attention.head_count": cfg.n_heads,
          "llama.attention.head_count_kv": cfg.n_kv_heads,
          "llama.feed_forward_length": cfg.ffn_dim,
          "llama.context_length": cfg.max_seq_len,
          "llama.attention.layer_norm_rms_epsilon": cfg.norm_eps,
          "llama.rope.freq_base": cfg.rope_base}
    if with_vocab:
        toks = ["<unk>", "<s>", "</s>"] + [f"<0x{b:02X}>" for b in range(256)] \
            + ["▁", "ab", "▁a", "b"]
        while len(toks) < cfg.vocab_size + 64:
            toks.append(f"tok{len(toks)}")
        md["tokenizer.ggml.tokens"] = toks
        md["tokenizer.ggml.scores"] = [0.0] * len(toks)
        md["tokenizer.ggml.bos_token_id"] = 1
        md["tokenizer.ggml.eos_token_id"] = 2
    return md


def _tensors(cfg, seed=2):
    """Random float weights in GGUF numpy layout ([out, in] rows)."""
    rng = np.random.default_rng(seed)
    D, F, V = cfg.dim, cfg.ffn_dim, cfg.vocab_size
    kvd = cfg.n_kv_heads * cfg.head_dim

    def w(o, i):
        return (rng.standard_normal((o, i)) * 0.05).astype(np.float32)

    t = {"token_embd.weight": w(V, D), "output_norm.weight": np.ones((D,), np.float32),
         "output.weight": w(V, D)}
    for i in range(cfg.n_layers):
        b = f"blk.{i}."
        t[b + "attn_norm.weight"] = np.ones((D,), np.float32)
        t[b + "ffn_norm.weight"] = np.ones((D,), np.float32)
        t[b + "attn_q.weight"] = w(D, D)
        t[b + "attn_k.weight"] = w(kvd, D)
        t[b + "attn_v.weight"] = w(kvd, D)
        t[b + "attn_output.weight"] = w(D, D)
        t[b + "ffn_gate.weight"] = w(F, D)
        t[b + "ffn_down.weight"] = w(D, F)
        t[b + "ffn_up.weight"] = w(F, D)
    return t


def _linears(tensors):
    return [k for k, v in tensors.items()
            if v.ndim == 2 and "norm" not in k and "embd" not in k]


@pytest.fixture(scope="module")
def gguf_file(tmp_path_factory):
    """A tiny synthetic GGUF written by the port: Q8_0 linears, one Q4_0
    linear (blk.0.ffn_down), one F16 linear (blk.1.attn_v), a vocabulary.
    → (path, float tensors before writing)."""
    cfg = _tiny()
    t = _tensors(cfg)
    t["blk.1.attn_v.weight"] = t["blk.1.attn_v.weight"].astype(np.float16)
    q = {k: "q8_0" for k in _linears(t) if k != "blk.1.attn_v.weight"}
    q["blk.0.ffn_down.weight"] = "q4_0"
    path = str(tmp_path_factory.mktemp("gguf") / "model.gguf")
    tg.write_gguf(path, _metadata(cfg), t, quantize=q)
    return path, t


def _tnp(t):
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _jnp(a):
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _same_params(jp, tp):
    """Every leaf of a JAX params tree equal, bit for bit, to the port's."""
    def leaf(j, t):
        if isinstance(j, jm.QWeight):
            assert (t.mode, t.packed) == (j.mode, j.packed)
            leaf(j.values, t.values)
            assert (j.scales is None) == (t.scales is None)
            if j.scales is not None:
                leaf(j.scales, t.scales)
        else:
            assert np.array_equal(_tnp(t), _jnp(j)), (t.dtype, np.asarray(j).dtype)
    for k in ("tok_embedding", "norm", "output"):
        leaf(jp[k], tp[k])
    assert len(jp["layers"]) == len(tp["layers"])
    for jl, tl in zip(jp["layers"], tp["layers"]):
        assert sorted(jl) == sorted(tl)
        for k in jl:
            leaf(jl[k], tl[k])


def _forwards(jcfg, jp, tcfg, tp, T=8):
    toks = np.random.default_rng(T).integers(0, jcfg.vocab_size, (1, T)).astype(np.int32)
    want, _ = jm.llama_forward(jp, jnp.asarray(toks), jm.KVCache.create(jcfg, 1), 0, jcfg,
                               use_pallas=False)
    got, _ = tm.llama_forward(tp, torch.from_numpy(toks),
                              tm.KVCache.create(tcfg, 1, device="cpu"), 0, tcfg)
    return cosine_similarity(got.numpy(), np.asarray(want))


def _same_dirs(a, b, names=("weights.ctbm", "config.json", "tokenizer.json")):
    for n in names:
        pa, pb = os.path.join(a, n), os.path.join(b, n)
        assert os.path.exists(pa) == os.path.exists(pb), n
        if os.path.exists(pa):
            assert filecmp.cmp(pa, pb, shallow=False), n


# -- GGUF ------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["scalars", "llama"])
def test_write_gguf_bytes_match_jax(tmp_path, kind):
    if kind == "scalars":
        rng = np.random.default_rng(0)
        md = {"general.architecture": "llama", "x.n": 7, "x.neg": -3, "x.f": 0.5,
              "x.s": "hi", "x.b": True, "x.arr": ["a", "b"], "x.ints": [1, -2, 3],
              "x.floats": [0.5, 1.5]}
        t = {"a": (rng.standard_normal((8, 64)) * 2).astype(np.float32),
             "b": rng.standard_normal((4, 32)).astype(np.float16),
             "c": rng.integers(-128, 128, (3, 5)).astype(np.int8),
             "d": rng.standard_normal((7,)).astype(np.float32)}
        q = {"a": "q8_0"}
    else:
        cfg = _tiny()
        md, t = _metadata(cfg), _tensors(cfg)
        q = {k: "q8_0" for k in _linears(t)}
    jg.write_gguf(str(tmp_path / "j.gguf"), md, t, quantize=q)
    tg.write_gguf(str(tmp_path / "t.gguf"), md, t, quantize=q)
    assert filecmp.cmp(tmp_path / "j.gguf", tmp_path / "t.gguf", shallow=False)


def test_gguf_file_reads_match_jax(gguf_file):
    path, _ = gguf_file
    j, t = jg.GGUFFile(path), tg.GGUFFile(path)
    assert t.version == j.version and t.tensors == j.tensors
    assert sorted(t.metadata) == sorted(j.metadata)
    for k, v in j.metadata.items():
        assert np.array_equal(np.asarray(t.metadata[k]), np.asarray(v)), k
    types = {i["type"] for i in t.tensors.values()}
    assert {tg.GGML_F32, tg.GGML_F16, tg.GGML_Q8_0, tg.GGML_Q4_0} <= types
    for name, info in t.tensors.items():
        assert np.array_equal(t.tensor(name), j.tensor(name)), name
        if info["type"] in (tg.GGML_Q8_0, tg.GGML_Q4_0):
            for a, b in zip(t.tensor_quantized(name), j.tensor_quantized(name)):
                assert np.array_equal(a, b), name
    t.close()
    j.close()


@pytest.mark.parametrize("shape", [(48, 64), (8, 32)])
def test_q4_0_blocks_are_the_q4_0_mode(tmp_path, shape):
    """The writer's Q4_0 blocks, read back by the JAX reader, hold the
    values and scales of llm/model.py's Q4_0 quantizer on the [in, out]
    weight (blocks along the input dim)."""
    w = (np.random.default_rng(1).standard_normal(shape) * 0.3).astype(np.float32)
    w[0, :32] = 0.0                                   # an all-zero block
    path = str(tmp_path / "q4.gguf")
    tg.write_gguf(path, {"general.architecture": "llama"}, {"w": w}, quantize={"w": "q4_0"})
    q, d = jg.GGUFFile(path).tensor_quantized("w")
    qw = jm.quantize_weight(np.ascontiguousarray(w.T), jm.Q4_0)
    from csinn2_tpu.kernels.qmatmul import unpack_int4
    assert np.array_equal(q.T, np.asarray(unpack_int4(qw.values, shape[1])))
    assert np.array_equal(d.T, np.asarray(qw.scales))


# -- tokenizer ---------------------------------------------------------------------

def _vocab():
    toks = ["<unk>", "<s>", "</s>"] + [f"<0x{b:02X}>" for b in range(256)]
    base = len(toks)
    toks += ["▁", "h", "e", "l", "o", "he", "ll", "hell", "hello", "▁hello", "▁w", "or"]
    scores = [0.0] * base + [-1, -2, -2, -2, -2, -0.5, -0.6, -0.3, -0.2, -0.1, -0.4, -0.7]
    return toks, scores


@pytest.mark.parametrize("text", ["hello", "hello world", "h€llo ☃", "", "  lo he"])
def test_sp_tokenizer_matches_jax(tmp_path, text):
    toks, scores = _vocab()
    j, t = JTokenizer(toks, scores), SPTokenizer(toks, scores)
    for bos, eos in ((True, False), (False, True)):
        ids = t.encode(text, bos=bos, eos=eos)
        assert ids == j.encode(text, bos=bos, eos=eos)
        assert t.decode(ids) == j.decode(ids)
    j.save(str(tmp_path / "j.json"))
    t.save(str(tmp_path / "t.json"))
    assert filecmp.cmp(tmp_path / "j.json", tmp_path / "t.json", shallow=False)
    assert SPTokenizer.load(str(tmp_path / "j.json")).encode(text) == j.encode(text)


# -- CTBM ---------------------------------------------------------------------------

def test_bm_files_match_jax_both_ways(tmp_path):
    rng = np.random.default_rng(0)
    f32 = rng.standard_normal((3, 5)).astype(np.float32)
    arrays = {"f32": f32, "i8": rng.integers(-128, 128, (64,)).astype(np.int8),
              "u8": np.arange(7, dtype=np.uint8), "i32": np.arange(6, dtype=np.int32).reshape(2, 3),
              "f16": f32.astype(np.float16), "b": np.array([True, False]),
              "empty": np.zeros((0, 4), np.float32)}
    jb = dict(arrays, bf16=np.asarray(jnp.asarray(f32, jnp.bfloat16)))
    tb = dict(arrays, bf16=torch.from_numpy(f32).to(torch.bfloat16))
    jbm.save_bm(str(tmp_path / "j.ctbm"), jb)
    tbm.save_bm(str(tmp_path / "t.ctbm"), tb)
    assert filecmp.cmp(tmp_path / "j.ctbm", tmp_path / "t.ctbm", shallow=False)
    back = tbm.load_bm(str(tmp_path / "j.ctbm"))
    for k, v in arrays.items():
        assert back[k].dtype == v.dtype and np.array_equal(back[k], v), k
    assert np.array_equal(back["bf16"], _tnp(tb["bf16"]))     # bf16 as its bits
    with tbm.BinaryModel(str(tmp_path / "j.ctbm")) as bm:
        views = bm.tensors()
        t = bm.tensor("bf16", views["bf16"], "cpu")
        assert bm.bf16 == {"bf16"} and t.dtype == torch.bfloat16
    assert torch.equal(t, tb["bf16"])                          # outlives the mapping
    jback = jbm.load_bm(str(tmp_path / "t.ctbm"))
    assert np.array_equal(_jnp(jback["bf16"]), _tnp(tb["bf16"]))


def test_native_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    monkeypatch.setattr(tbm, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(tbm, "SOURCE", tmp_path / "broken.cpp")
    (tmp_path / "broken.cpp").write_text("int f( {\n")
    with pytest.raises(RuntimeError, match="broken.cpp"):
        tbm._build()
    assert not any((tmp_path / "build").iterdir())      # no half-written library


def test_native_build_is_safe_across_processes(tmp_path):
    """Six processes building into an empty directory at once (the CPU
    tests' worker count) all load a whole library."""
    code = ("import sys; from pathlib import Path\n"
            "from csinn2_tpu_torch.runtime import bm\n"
            "bm.BUILD_DIR = Path(sys.argv[1])\n"
            "bm.save_bm(sys.argv[2], {'x': __import__('numpy').arange(3)})\n")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path / "b"),
                               str(tmp_path / f"{i}.ctbm")], cwd=REPO) for i in range(6)]
    assert [p.wait(timeout=120) for p in procs] == [0] * 6
    assert len(list((tmp_path / "b").glob("libbmfmt-*.so"))) == 1
    assert not list((tmp_path / "b").glob(".libbmfmt.*"))
    assert all(filecmp.cmp(tmp_path / "0.ctbm", tmp_path / f"{i}.ctbm", shallow=False)
               for i in range(1, 6))


# -- save_llm / load_llm ------------------------------------------------------------

MODELS = {  # name → (config kwargs, mode, fuse)
    "dense-q8_0": (dict(), "q8_0", False),
    "dense-q4_0-fused": (dict(), "q4_0", True),
    "dense-int4": (dict(), "int4", False),
    "moe-q4_0": (dict(n_experts=4), "q4_0", False),
    "moe-float": (dict(n_experts=4), "float", False),
}


def _model(name):
    kw, mode, fuse = MODELS[name]
    jcfg = dataclasses.replace(JConfig.tiny(), **kw)
    tcfg = dataclasses.replace(TConfig.tiny(), **kw)
    jp = jm.init_params(jcfg, mode, seed=3)
    tp = tm.init_params(tcfg, mode, seed=3, device="cpu")
    if fuse:
        jp, tp = jm.fuse_params(jp), tm.fuse_params(tp)
    return jcfg, jp, tcfg, tp


@pytest.mark.parametrize("name", list(MODELS))
def test_save_llm_bytes_match_jax(tmp_path, name):
    jcfg, jp, tcfg, tp = _model(name)
    j_save_llm(str(tmp_path / "j"), jcfg, jp)
    save_llm(str(tmp_path / "t"), tcfg, tp)
    _same_dirs(str(tmp_path / "j"), str(tmp_path / "t"))


@pytest.mark.parametrize("name", list(MODELS))
@pytest.mark.parametrize("direction", ["jax-to-port", "port-to-jax"])
def test_load_llm_across_packages(tmp_path, name, direction):
    jcfg, jp, tcfg, tp = _model(name)
    if direction == "jax-to-port":
        j_save_llm(str(tmp_path), jcfg, jp)
        cfg, lp = load_llm(str(tmp_path), device="cpu")
        assert dataclasses.asdict(cfg) == dataclasses.asdict(tcfg)
        _same_params(jp, lp)
        assert _forwards(jcfg, jp, cfg, lp) >= 0.999
    else:
        save_llm(str(tmp_path), tcfg, tp)
        cfg, lp = j_load_llm(str(tmp_path))
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
        _same_params(lp, tp)
        assert _forwards(cfg, lp, tcfg, tp) >= 0.999


def test_load_llm_needs_cuda_unless_asked(tmp_path, monkeypatch):
    jcfg, jp, _, _ = _model("dense-q8_0")
    j_save_llm(str(tmp_path), jcfg, jp)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        load_llm(str(tmp_path))


# -- converters -----------------------------------------------------------------------

@pytest.mark.parametrize("mode", MODES)
def test_convert_gguf_matches_jax(tmp_path, gguf_file, mode):
    """The same GGUF (Q8_0, Q4_0 and F16 linears) through both converters:
    byte-identical directories, Q8_0 / Q4_0 blocks verbatim where the mode
    matches and requantized elsewhere."""
    path, _ = gguf_file
    j_convert_gguf(path, str(tmp_path / "j"), mode=mode)
    convert_gguf(path, str(tmp_path / "t"), mode=mode)
    _same_dirs(str(tmp_path / "j"), str(tmp_path / "t"))
    cfg, p = load_llm(str(tmp_path / "t"), device="cpu")
    assert all(q.mode == mode for lp in p["layers"] for q in lp.values()
               if isinstance(q, tm.QWeight))


def test_convert_gguf_keeps_blocks_verbatim(gguf_file, tmp_path):
    path, _ = gguf_file
    gg = tg.GGUFFile(path)
    convert_gguf(path, str(tmp_path / "q4"), mode="q4_0")
    _, p = load_llm(str(tmp_path / "q4"), device="cpu")
    w2 = p["layers"][0]["w2"]                    # the Q4_0 tensor, kept as it was
    q, d = gg.tensor_quantized("blk.0.ffn_down.weight")
    from csinn2_tpu_torch.kernels.qmatmul import unpack_int4
    assert w2.packed and np.array_equal(unpack_int4(w2.values, q.shape[1]).numpy(), q.T)
    assert np.array_equal(w2.scales.numpy(), d.T)
    gg.close()


def test_converted_gguf_logits_match_the_float_weights(gguf_file, tmp_path):
    """bench.py's real-weights gate: converted Q8_0 logits against the float
    forward on the dequantized pre-conversion weights."""
    path, _ = gguf_file
    out = convert_gguf(path, str(tmp_path / "m"), mode="q8_0")
    cfg, params = load_llm(out, device="cpu")
    gg = tg.GGUFFile(path)

    def fq(name):
        return tm.QWeight(values=torch.from_numpy(np.ascontiguousarray(gg.tensor(name).T)))

    gp = {"tok_embedding": torch.from_numpy(gg.tensor("token_embd.weight").copy()),
          "norm": torch.from_numpy(gg.tensor("output_norm.weight").copy()),
          "output": fq("output.weight"), "layers": []}
    for i in range(cfg.n_layers):
        b = f"blk.{i}."
        gp["layers"].append({
            "attn_norm": torch.from_numpy(gg.tensor(b + "attn_norm.weight").copy()),
            "ffn_norm": torch.from_numpy(gg.tensor(b + "ffn_norm.weight").copy()),
            "wq": fq(b + "attn_q.weight"), "wk": fq(b + "attn_k.weight"),
            "wv": fq(b + "attn_v.weight"), "wo": fq(b + "attn_output.weight"),
            "w1": fq(b + "ffn_gate.weight"), "w2": fq(b + "ffn_down.weight"),
            "w3": fq(b + "ffn_up.weight")})
    gg.close()
    toks = torch.arange(16)[None] % cfg.vocab_size
    got, _ = tm.llama_forward(params, toks, tm.KVCache.create(cfg, 1, device="cpu"), 0, cfg)
    gold, _ = tm.llama_forward(gp, toks, tm.KVCache.create(cfg, 1, device="cpu"), 0, cfg)
    assert cosine_similarity(got.numpy(), gold.numpy()) >= 0.999
    tok = load_tokenizer(out)
    ids = tok.encode("ab", bos=True)
    assert ids[0] == 1 and "ab" in tok.decode(ids)


@pytest.fixture(scope="module")
def hf_checkpoint(tmp_path_factory):
    transformers = pytest.importorskip("transformers")
    from safetensors.torch import save_file
    hf_cfg = transformers.LlamaConfig(
        hidden_size=64, intermediate_size=96, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, vocab_size=128,
        max_position_embeddings=64, rms_norm_eps=1e-5, rope_theta=10000.0,
        tie_word_embeddings=False)
    torch.manual_seed(0)
    model = transformers.LlamaForCausalLM(hf_cfg).eval()
    ckpt = tmp_path_factory.mktemp("hf")
    save_file({k: v.contiguous() for k, v in model.state_dict().items()},
              str(ckpt / "model.safetensors"))
    cfg_dict = json.loads(hf_cfg.to_json_string())
    cfg_dict["model_type"] = "llama"
    (ckpt / "config.json").write_text(json.dumps(cfg_dict))
    ids = np.array([[1, 7, 23, 42, 99]], np.int64)
    with torch.no_grad():
        ref = model(torch.from_numpy(ids)).logits.float().numpy()
    return str(ckpt), ids, ref


@pytest.mark.parametrize("mode", ["float", "q8_0", "q4_0"])
def test_convert_hf_matches_jax_and_transformers(tmp_path, hf_checkpoint, mode):
    from csinn2_tpu.llm.convert import convert_hf as j_convert_hf
    ckpt, ids, ref = hf_checkpoint
    j_convert_hf(ckpt, str(tmp_path / "j"), mode=mode)
    convert_hf(ckpt, str(tmp_path / "t"), mode=mode)
    _same_dirs(str(tmp_path / "j"), str(tmp_path / "t"))
    cfg, params = load_llm(str(tmp_path / "t"), device="cpu")
    logits, _ = tm.llama_forward(params, torch.from_numpy(ids),
                                 tm.KVCache.create(cfg, 1, device="cpu"), 0, cfg)
    if mode == "q4_0":    # no transformers gate in the JAX tests: held to JAX
        jcfg, jp = j_load_llm(str(tmp_path / "j"))
        want, _ = jm.llama_forward(jp, jnp.asarray(ids, jnp.int32), jm.KVCache.create(jcfg, 1),
                                   0, jcfg, use_pallas=False)
        cs = cosine_similarity(logits.numpy(), np.asarray(want))
        assert cs >= 0.999, cs
    else:                 # tests/test_convert.py's gates against transformers
        cs = cosine_similarity(logits.numpy().ravel(), ref.ravel())
        assert cs >= (0.999 if mode == "float" else 0.99), cs


# -- command line ------------------------------------------------------------------------

def _cli(*args):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, "-m", "csinn2_tpu_torch", *args], cwd=REPO,
                          env=env, capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("mode", ["q8_0", "q4_0"])
def test_cli_convert_matches_jax(tmp_path, gguf_file, mode):
    path, _ = gguf_file
    r = _cli("convert", path, str(tmp_path / "t"), "--mode", mode)
    assert r.returncode == 0, r.stderr
    assert "converted" in r.stdout
    j_convert_gguf(path, str(tmp_path / "j"), mode=mode)
    _same_dirs(str(tmp_path / "j"), str(tmp_path / "t"))


def test_cli_whereis_and_ops():
    r = _cli("--whereis")
    assert r.returncode == 0 and r.stdout.strip() == os.path.join(REPO, "csinn2_tpu_torch")
    r = _cli("--ops")
    assert r.returncode == 0 and {"conv2d", "ds_block"} <= set(r.stdout.split())
    r = _cli()
    assert r.returncode == 0 and "convert" in r.stdout
