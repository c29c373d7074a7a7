"""LLM weight persistence: JSON index + CTBM binary blob — the counterpart of
csinn2_tpu/llm/json_io.py, in the same format, so each package loads the
other's directories.

(ref: shl_llm_load_json / shl_llm_save_json, source/llm/llm_json.cpp:38-57 —
mmap'd weight blob + JSON metadata.)

save_llm(path, cfg, params) writes
  <path>/config.json   — LlamaConfig + per-weight quant mode
  <path>/weights.ctbm  — every array through the native 4096-aligned writer
byte-identical to the JAX package's for the same params (the same keys in
the same order).  load_llm(path, device) rebuilds (cfg, params) with every
tensor copied out of the mapping onto `device`; a layer's keys are what was
saved (MoE gate, stacked experts, packed int4, fused wqkv / w13).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, Tuple

from csinn2_tpu_torch.llm.config import LlamaConfig
from csinn2_tpu_torch.llm.model import QWeight
from csinn2_tpu_torch.runtime.bm import BinaryModel, save_bm
from csinn2_tpu_torch.utils.device import resolve_device

FORMAT = "csinn2_tpu-llm-v1"


def _flatten(params) -> Tuple[Dict[str, object], Dict[str, str]]:
    arrays: Dict[str, object] = {}
    modes: Dict[str, str] = {}

    def put(key, val):
        if isinstance(val, QWeight):
            arrays[key + ".values"] = val.values
            if val.scales is not None:
                arrays[key + ".scales"] = val.scales
            modes[key] = f"{val.mode}:packed" if val.packed else val.mode
        else:
            arrays[key] = val

    put("tok_embedding", params["tok_embedding"])
    put("norm", params["norm"])
    put("output", params["output"])
    for i, lp in enumerate(params["layers"]):
        for k, v in lp.items():
            put(f"layers.{i}.{k}", v)
    return arrays, modes


def save_llm(path: str, cfg: LlamaConfig, params) -> str:
    os.makedirs(path, exist_ok=True)
    arrays, modes = _flatten(params)
    save_bm(os.path.join(path, "weights.ctbm"), arrays)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump({"config": dataclasses.asdict(cfg), "quant_modes": modes,
                   "format": FORMAT}, f, indent=1)
    return path


def load_llm(path: str, device="cuda") -> Tuple[LlamaConfig, dict]:
    dev = resolve_device(device)
    with open(os.path.join(path, "config.json")) as f:
        doc = json.load(f)
    cfg = LlamaConfig(**doc["config"])
    modes = doc["quant_modes"]
    with BinaryModel(os.path.join(path, "weights.ctbm")) as bm:
        arrays = bm.tensors()                 # zero-copy views of the mapping

        def get(key):
            if key in modes:
                mode, _, flag = modes[key].partition(":")
                scales = key + ".scales"
                return QWeight(values=bm.tensor(key + ".values",
                                                arrays[key + ".values"], dev),
                               scales=bm.tensor(scales, arrays[scales], dev)
                               if scales in arrays else None,
                               mode=mode, packed=flag == "packed")
            return bm.tensor(key, arrays[key], dev)

        params = {"tok_embedding": get("tok_embedding"), "norm": get("norm"),
                  "output": get("output"), "layers": []}
        layer_keys: Dict[int, set] = {}
        for name in set(arrays) | set(modes):
            if name.startswith("layers."):
                _, idx, key = name.split(".")[:3]
                layer_keys.setdefault(int(idx), set()).add(key)
        for i in sorted(layer_keys):
            params["layers"].append({k: get(f"layers.{i}.{k}")
                                     for k in sorted(layer_keys[i])})
    return cfg, params
