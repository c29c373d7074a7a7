"""The model's float weights, made on the device from the run's seed — the
inputs that the program and the reference both take.

Each layer's seven matrices come from ONE draw of a generator seeded by
(seed, layer), split in a fixed order; the embedding and the output head
have a draw each.  So the reference can make any one layer again after
the window, alone, bit for bit, without the rest.  Values are normal at
the configuration's initializer_range (0.02); RMSNorm weights are ones.
Matrices are [in, out] (x @ W), as the port's params take them.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from portbench.traffic import sub_seed


def dims(cfg: dict) -> dict:
    """The sizes the program, the counts and the reference use, from a
    configuration file's published keys."""
    D = int(cfg["hidden_size"])
    hq = int(cfg["num_attention_heads"])
    hk = int(cfg.get("num_key_value_heads", hq))
    dh = int(cfg.get("head_dim") or D // hq)
    return {"D": D, "hq": hq, "hk": hk, "dh": dh, "F": int(cfg["intermediate_size"]),
            "L": int(cfg["num_hidden_layers"]), "V": int(cfg["vocab_size"]),
            "eps": float(cfg["rms_norm_eps"]), "rope": float(cfg["rope_theta"]),
            "S": int(cfg["serving"]["max_seq_len"]),
            "batch": int(cfg["serving"]["batch"]),
            "mode": cfg["serving"]["weight_mode"],
            "kv_scale": float(cfg["serving"]["kv_scale"]),
            "scale": float(cfg.get("initializer_range", 0.02))}


def layer_shapes(d: dict) -> List[Tuple[str, Tuple[int, int]]]:
    D, F, qd, kvd = d["D"], d["F"], d["hq"] * d["dh"], d["hk"] * d["dh"]
    return [("wq", (D, qd)), ("wk", (D, kvd)), ("wv", (D, kvd)), ("wo", (qd, D)),
            ("w1", (D, F)), ("w2", (F, D)), ("w3", (D, F))]


def _draw(seed: int, tag: str, n: int, scale: float, device) -> torch.Tensor:
    g = torch.Generator(device=device)
    g.manual_seed(sub_seed(seed, tag))
    return torch.randn(n, generator=g, device=device, dtype=torch.float32).mul_(scale)


def layer(d: dict, seed: int, i: int, device) -> Dict[str, torch.Tensor]:
    """Layer i's seven f32 matrices, views into one draw."""
    shapes = layer_shapes(d)
    flat = _draw(seed, f"layer{i}", sum(a * b for _, (a, b) in shapes), d["scale"], device)
    out, at = {}, 0
    for name, (a, b) in shapes:
        out[name] = flat[at:at + a * b].view(a, b)
        at += a * b
    return out


def embedding(d: dict, seed: int, device) -> torch.Tensor:
    """[V, D] in bf16, the type the model serves it in."""
    return _draw(seed, "embedding", d["V"] * d["D"], d["scale"], device) \
        .view(d["V"], d["D"]).to(torch.bfloat16)


def head(d: dict, seed: int, device) -> torch.Tensor:
    """The output projection, f32 [D, V]."""
    return _draw(seed, "head", d["D"] * d["V"], d["scale"], device).view(d["D"], d["V"])
