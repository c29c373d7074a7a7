"""Real-checkpoint ingestion: GGUF / HF-safetensors → CTBM model directory —
the counterpart of csinn2_tpu/llm/convert.py, writing byte-identical
directories.

    convert_gguf("llama-2-7b.Q8_0.gguf", "out_dir")
    convert_hf("Llama-2-7b-hf/", "out_dir", mode="q8_0")
    python -m csinn2_tpu_torch convert <gguf-or-hf-dir> <out_dir> [--mode q8_0]

Both write the llm/json_io.py layout (config.json + weights.ctbm +
tokenizer.json), which load_llm and examples/llama_generate.py --ckpt read.
Conversion is host work: every tensor stays in host memory (CPU tensors),
none goes to a device.

Weight layout (llm/model.py QWeight): values are [K(in), N(out)]; Q8_0/Q4_0
block scales [K/32, N] f32 (f16-rounded).  GGUF stores a linear weight as
rows of the input dim ([out, in] in numpy order) with its blocks along the
input dim, so values and block scales transpose straight into place: a
tensor already in the requested block mode converts without a dequantize /
requantize round trip.  Any other tensor is dequantized and requantized.

RoPE: rope_rotate is interleaved-pair (the Meta/GGML layout); HF
checkpoints permute q_proj/k_proj for rotate-half RoPE, so the HF import
un-permutes them.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Dict, Optional

import numpy as np
import torch

from csinn2_tpu_torch.llm import gguf_io
from csinn2_tpu_torch.llm.config import LlamaConfig
from csinn2_tpu_torch.llm.model import (FLOAT, INT4_CHANNEL, INT8_CHANNEL, Q4_0, Q8_0,
                                        QWeight, _maybe_pack, quantize_weight)
from csinn2_tpu_torch.llm.tokenizer import SPTokenizer

MODES = (FLOAT, INT8_CHANNEL, INT4_CHANNEL, Q8_0, Q4_0)


def _host(a: np.ndarray, dtype=None) -> torch.Tensor:
    """numpy → CPU tensor (a copy), optionally cast."""
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


def _quantize(w: np.ndarray, mode: str) -> QWeight:
    return quantize_weight(np.ascontiguousarray(w), mode, device="cpu")


def _qweight_from_blocks(q: np.ndarray, d: np.ndarray, mode: str) -> QWeight:
    """(int8 values [out, in], f32 scales [out, in/32]) → QWeight ([in, out]
    values, [in/32, out] scales), int4 modes nibble-packed."""
    return _maybe_pack(QWeight(values=_host(q.T), scales=_host(d.T.astype(np.float32)),
                               mode=mode))


def _import_linear(gg: gguf_io.GGUFFile, name: str, mode: str) -> QWeight:
    """One GGUF linear tensor → QWeight in `mode`: Q8_0/Q4_0 blocks kept
    verbatim when the mode matches, else dequantized and requantized."""
    t = gg.tensors[name]["type"]
    if t == gguf_io.GGML_Q8_0 and mode == Q8_0:
        return _qweight_from_blocks(*gg.tensor_quantized(name), mode=Q8_0)
    if t == gguf_io.GGML_Q4_0 and mode == Q4_0:
        return _qweight_from_blocks(*gg.tensor_quantized(name), mode=Q4_0)
    w = gg.tensor(name)                     # [out, in] f32
    if mode == FLOAT:
        return QWeight(values=_host(w.T, torch.bfloat16), mode=FLOAT)
    return _quantize(w.T, mode)


def config_from_gguf(gg: gguf_io.GGUFFile) -> LlamaConfig:
    md = gg.metadata
    arch = md.get("general.architecture", "llama")
    if arch != "llama":
        raise ValueError(f"unsupported architecture {arch}")
    p = "llama."
    n_heads = int(md[p + "attention.head_count"])
    emb = gg.tensors["token_embd.weight"]["ne"]
    return LlamaConfig(
        dim=int(md[p + "embedding_length"]),
        n_layers=int(md[p + "block_count"]),
        n_heads=n_heads,
        n_kv_heads=int(md.get(p + "attention.head_count_kv", n_heads)),
        ffn_dim=int(md[p + "feed_forward_length"]),
        vocab_size=int(emb[1]),
        max_seq_len=int(md.get(p + "context_length", 2048)),
        norm_eps=float(md.get(p + "attention.layer_norm_rms_epsilon", 1e-5)),
        rope_base=float(md.get(p + "rope.freq_base", 10000.0)),
    )


def params_from_gguf(gg: gguf_io.GGUFFile, cfg: LlamaConfig,
                     mode: str = Q8_0) -> Dict:
    params = {
        "tok_embedding": _host(gg.tensor("token_embd.weight"), torch.bfloat16),
        "norm": _host(gg.tensor("output_norm.weight"), torch.float32),
        "layers": [],
    }
    if "output.weight" in gg.tensors:
        params["output"] = _import_linear(gg, "output.weight", mode)
    else:                                   # tied embeddings
        params["output"] = _quantize(gg.tensor("token_embd.weight").T, mode)
    for i in range(cfg.n_layers):
        b = f"blk.{i}."
        params["layers"].append({
            "attn_norm": _host(gg.tensor(b + "attn_norm.weight"), torch.float32),
            "ffn_norm": _host(gg.tensor(b + "ffn_norm.weight"), torch.float32),
            "wq": _import_linear(gg, b + "attn_q.weight", mode),
            "wk": _import_linear(gg, b + "attn_k.weight", mode),
            "wv": _import_linear(gg, b + "attn_v.weight", mode),
            "wo": _import_linear(gg, b + "attn_output.weight", mode),
            "w1": _import_linear(gg, b + "ffn_gate.weight", mode),
            "w2": _import_linear(gg, b + "ffn_down.weight", mode),
            "w3": _import_linear(gg, b + "ffn_up.weight", mode),
        })
    return params


def tokenizer_from_gguf(gg: gguf_io.GGUFFile) -> Optional[SPTokenizer]:
    md = gg.metadata
    toks = md.get("tokenizer.ggml.tokens")
    if toks is None:
        return None
    scores = md.get("tokenizer.ggml.scores")
    return SPTokenizer(
        list(toks),
        None if scores is None else list(np.asarray(scores, np.float32)),
        bos_id=int(md.get("tokenizer.ggml.bos_token_id", 1)),
        eos_id=int(md.get("tokenizer.ggml.eos_token_id", 2)),
        unk_id=int(md.get("tokenizer.ggml.unknown_token_id", 0)))


def convert_gguf(gguf_path: str, out_dir: str, mode: str = Q8_0) -> str:
    """GGUF checkpoint → CTBM model dir (config.json + weights.ctbm +
    tokenizer.json)."""
    from csinn2_tpu_torch.llm.json_io import save_llm
    gg = gguf_io.GGUFFile(gguf_path)
    cfg = config_from_gguf(gg)
    save_llm(out_dir, cfg, params_from_gguf(gg, cfg, mode=mode))
    tok = tokenizer_from_gguf(gg)
    if tok is not None:
        tok.save(os.path.join(out_dir, "tokenizer.json"))
    gg.close()
    return out_dir


# -- HuggingFace safetensors ---------------------------------------------------

def _hf_unpermute(w: np.ndarray, n_heads: int) -> np.ndarray:
    """Inverse of transformers' convert_llama_weights_to_hf permute: HF
    rotate-half row order → Meta interleaved-pair order (what rope_rotate
    expects).  w: [out, in]."""
    out, k = w.shape
    dh2 = out // n_heads // 2
    return (w.reshape(n_heads, 2, dh2, k).swapaxes(1, 2)
            .reshape(out, k))


def _hf_shards(model_dir: str):
    """Yield (name, f32/f16 numpy array) for every tensor across the
    checkpoint's safetensors shard(s), read through torch so bf16-stored
    checkpoints load (`safetensors` is imported here only)."""
    from safetensors import safe_open
    idx = os.path.join(model_dir, "model.safetensors.index.json")
    if os.path.exists(idx):
        with open(idx) as f:
            weight_map = json.load(f)["weight_map"]
        files = sorted(set(weight_map.values()))
    else:
        files = [f for f in sorted(os.listdir(model_dir))
                 if f.endswith(".safetensors")]
    for fn in files:
        with safe_open(os.path.join(model_dir, fn), framework="pt") as f:
            for name in f.keys():
                t = f.get_tensor(name)
                if t.dtype in (torch.bfloat16, torch.float64):
                    t = t.to(torch.float32)
                yield name, t.numpy()


def config_from_hf(model_dir: str) -> LlamaConfig:
    with open(os.path.join(model_dir, "config.json")) as f:
        hc = json.load(f)
    if hc.get("model_type") != "llama":
        raise ValueError(f"unsupported model_type {hc.get('model_type')}")
    return LlamaConfig(
        dim=hc["hidden_size"], n_layers=hc["num_hidden_layers"],
        n_heads=hc["num_attention_heads"],
        n_kv_heads=hc.get("num_key_value_heads", hc["num_attention_heads"]),
        ffn_dim=hc["intermediate_size"], vocab_size=hc["vocab_size"],
        max_seq_len=hc.get("max_position_embeddings", 2048),
        norm_eps=hc.get("rms_norm_eps", 1e-5),
        rope_base=hc.get("rope_theta", 10000.0))


_HF_MAP = {           # HF name suffix → (our key, heads to un-permute by)
    "self_attn.q_proj.weight": ("wq", "q"),
    "self_attn.k_proj.weight": ("wk", "k"),
    "self_attn.v_proj.weight": ("wv", None),
    "self_attn.o_proj.weight": ("wo", None),
    "mlp.gate_proj.weight": ("w1", None),
    "mlp.down_proj.weight": ("w2", None),
    "mlp.up_proj.weight": ("w3", None),
    "input_layernorm.weight": ("attn_norm", None),
    "post_attention_layernorm.weight": ("ffn_norm", None),
}


def convert_hf(model_dir: str, out_dir: str, mode: str = Q8_0) -> str:
    """HF Llama checkpoint dir (config.json + *.safetensors) → CTBM model
    dir.  Copies the fast-tokenizer file when present (tokenizer.json →
    tokenizer_hf.json, served by llm/tokenizer.HFTokenizer)."""
    from csinn2_tpu_torch.llm.json_io import save_llm
    cfg = config_from_hf(model_dir)
    layers = [dict() for _ in range(cfg.n_layers)]
    params: Dict = {"layers": layers}
    for name, arr in _hf_shards(model_dir):
        arr = np.asarray(arr)
        if arr.dtype not in (np.float32, np.float16):
            arr = arr.astype(np.float32)
        if name == "model.embed_tokens.weight":
            params["tok_embedding"] = _host(arr, torch.bfloat16)
        elif name == "model.norm.weight":
            params["norm"] = _host(arr, torch.float32)
        elif name == "lm_head.weight":
            params["output"] = _quantize(arr.astype(np.float32).T, mode)
        elif name.startswith("model.layers."):
            li, suffix = name.split(".", 2)[2].split(".", 1)
            key, unperm = _HF_MAP.get(suffix, (None, None))
            if key is None:
                continue
            w = arr.astype(np.float32)
            if key in ("attn_norm", "ffn_norm"):
                layers[int(li)][key] = _host(w, torch.float32)
                continue
            if unperm == "q":
                w = _hf_unpermute(w, cfg.n_heads)
            elif unperm == "k":
                w = _hf_unpermute(w, cfg.n_kv_heads)
            layers[int(li)][key] = _quantize(w.T, mode)
    if "output" not in params:                    # tied embeddings
        emb = params["tok_embedding"].float().numpy()
        params["output"] = _quantize(emb.T, mode)
    save_llm(out_dir, cfg, params)
    src = os.path.join(model_dir, "tokenizer.json")
    if os.path.exists(src):
        shutil.copy(src, os.path.join(out_dir, "tokenizer_hf.json"))
    return out_dir


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(
        prog="python -m csinn2_tpu_torch convert",
        description="Convert a GGUF or HF-safetensors Llama checkpoint to "
                    "the CTBM model dir format")
    ap.add_argument("src", help="GGUF file or HF model directory")
    ap.add_argument("out", help="output model directory")
    ap.add_argument("--mode", default=Q8_0, choices=list(MODES))
    a = ap.parse_args(argv)
    if os.path.isdir(a.src):
        convert_hf(a.src, a.out, mode=a.mode)
    else:
        convert_gguf(a.src, a.out, mode=a.mode)
    print(f"converted {a.src} -> {a.out}")
    return 0
