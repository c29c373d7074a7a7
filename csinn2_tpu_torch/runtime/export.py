"""Model export: JSON graph dump + serialized deployable model (save & LOAD)
(counterpart of csinn2_tpu/runtime/export.py).

(ref: shl_export_model_json, source/utils/export.c:24 +
export_json_wrapper.cpp — graph→JSON with enum names; and the binary-model
serializer/loader, source/nn2/format.c:23-1333 — csinn_import_binary_model
:1304-1331 → shl_gref_load_binary_model, source/graph_ref/setup.c:929-977,
which reconstructs a runnable session in a fresh process.)

`save_model` / `load_model` write and read a directory with
  manifest.json     — graph structure, op params, quant info: the JAX
                      package's format, "csinn2_tpu-graph-v1";
  weights.npz       — the constant arrays, under the same keys;
  placed_consts.pt  — with aot=True only: the set-up session's constants
                      as setup() placed them, written by torch.save (tensors
                      only), see save_model.
A directory saved by either package without AOT loads in the other.  Each
node's "kernel" field is the saving package's callback name; the loader
ignores it and looks the op up again.
"""

from __future__ import annotations

import dataclasses
import enum
import json
import os
import typing
from typing import Any, Dict, Optional

import numpy as np
import torch

FORMAT = "csinn2_tpu-graph-v1"
PLACED_CONSTS = "placed_consts.pt"


def _jsonable(obj: Any):
    if isinstance(obj, enum.Enum):
        return obj.value
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {k: _jsonable(v) for k, v in dataclasses.asdict(obj).items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if isinstance(obj, dict):
        return {str(k): _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (np.integer,)):
        return int(obj)
    if isinstance(obj, (np.floating,)):
        return float(obj)
    if isinstance(obj, np.ndarray):
        return obj.tolist() if obj.size <= 16 else f"<array {obj.shape} {obj.dtype}>"
    if isinstance(obj, torch.device):
        return str(obj)
    if hasattr(obj, "shape") and hasattr(obj, "dtype"):
        return f"<array {tuple(obj.shape)} {obj.dtype}>"
    return obj


def _qinfo_json(q) -> Optional[dict]:
    """Round-trippable QuantInfo serialization — unlike _jsonable, per-channel
    scale/zero-point arrays are written in full (they must reload exactly)."""
    if q is None:
        return None

    def arr(v):
        a = np.asarray(v)
        return a.tolist() if a.ndim else a.item()

    return {"scale": arr(q.scale), "zero_point": arr(q.zero_point),
            "dtype": q.dtype.value, "axis": q.axis, "scheme": q.scheme.value}


def _qinfo_from_json(d: Optional[dict]):
    if d is None:
        return None
    from csinn2_tpu_torch.core.dtypes import Dtype, QuantScheme
    from csinn2_tpu_torch.core.quant import QuantInfo

    def arr(v, dt):
        return np.asarray(v, dt) if isinstance(v, list) else v

    return QuantInfo(scale=arr(d["scale"], np.float32),
                     zero_point=arr(d["zero_point"], np.int32),
                     dtype=Dtype(d["dtype"]), axis=d["axis"],
                     scheme=QuantScheme(d["scheme"]))


def _extra_json(extra: Optional[dict]) -> Optional[dict]:
    """Serialize call_op's **extra kwargs with explicit enum tags so values
    like w_layout=Layout.OIHW survive the round trip as enums, not strings."""
    if not extra:
        return None

    def enc(v):
        if isinstance(v, enum.Enum):
            return {"__enum__": type(v).__name__, "value": v.value}
        if isinstance(v, (list, tuple)):
            return [enc(x) for x in v]
        return _jsonable(v)

    return {k: enc(v) for k, v in extra.items()}


def _extra_from_json(d: Optional[dict]) -> dict:
    if not d:
        return {}
    from csinn2_tpu_torch.core import dtypes as D

    def dec(v):
        if isinstance(v, dict) and "__enum__" in v:
            return getattr(D, v["__enum__"])(v["value"])
        if isinstance(v, list):
            return [dec(x) for x in v]
        return v

    return {k: dec(v) for k, v in d.items()}


def _params_from_json(type_name: Optional[str], d: Optional[dict]):
    if type_name is None or d is None:
        return None
    from csinn2_tpu_torch.ops import params as P
    cls = getattr(P, type_name)
    hints = typing.get_type_hints(cls)
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name not in d:
            continue
        v = d[f.name]
        t = hints.get(f.name)
        if isinstance(t, type) and issubclass(t, enum.Enum) and v is not None:
            v = t(v)
        elif isinstance(v, list):
            v = tuple(v)
        kwargs[f.name] = v
    return cls(**kwargs)


def graph_to_json(graph) -> str:
    """(ref: shl_export_model_json).  Carries everything load_model needs to
    rebuild a runnable graph: per-node op/params(+type)/arg-structure/extra
    kwargs/output qinfo, per-tensor meta incl. mem_type and full quant info.
    A constant that a load bound (meta.const_key "c<n>") keeps its key as
    "t<n>", so a reloaded model saves again under its weights' keys."""
    tensors = {}
    nodes = []

    def tname(t):
        ck = t.meta.const_key
        key = "t" + ck[1:] if ck else f"t{id(t)}"
        if key not in tensors:
            tensors[key] = {
                "name": t.meta.name or key,
                "shape": list(t.shape),
                "dtype": t.dtype.value,
                "layout": t.layout.value,
                "mem_type": t.meta.mem_type.value,
                "quant": _qinfo_json(t.qinfo),
            }
        return key

    for node in graph.nodes:
        nodes.append({
            "op": node.op,
            "name": node.name,
            "kernel": node.cb_name,
            "inputs": [tname(t) for t in node.inputs if hasattr(t, "meta")],
            "outputs": [tname(t) for t in node.outputs],
            "params": _jsonable(node.params) if node.params is not None else None,
            "params_type": type(node.params).__name__ if node.params is not None else None,
            "structure": _jsonable(node.structure) if node.structure else None,
            "extra": _extra_json(node.extra),
            "out_qinfo": _qinfo_json(node.out_qinfo),
        })
    doc = {
        "format": FORMAT,
        "inputs": [tname(t) for t in graph.inputs],
        "outputs": [tname(t) for t in graph.outputs],
        "nodes": nodes,
        "tensors": tensors,
    }
    return json.dumps(doc, indent=1)


def _to_numpy(v: torch.Tensor) -> np.ndarray:
    """A constant as numpy; numpy has no bfloat16, so a bf16 constant is
    written as f32 (load_model casts it back by the manifest's dtype)."""
    v = v.detach().cpu()
    return (v.float() if v.dtype == torch.bfloat16 else v).numpy()


def save_model(session, path: str, aot: bool = False):
    """Serialize graph manifest + weights (the .bm analog,
    ref: csinn binary model format.c:23-1333).

    aot=True also writes placed_consts.pt: the set-up session's constants
    as setup() placed them (block scales already f32), saved by torch.save
    as a dict of tensors and (values, scales) pairs.  The port has no
    serializable executable to write in its place: a captured CUDA graph
    does not outlive its process, and torch.export cannot carry the ctypes
    kernels.  A load_model that finds the file reads the constants from it
    with torch.load(weights_only=True) onto the session's device and skips
    the weights.npz parse and the host-to-device placement; it still
    replays the manifest through the op API to rebuild the graph."""
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "manifest.json"), "w") as f:
        f.write(graph_to_json(session.graph))
    consts = session._consts or session.graph.collect_consts()
    flat: Dict[str, np.ndarray] = {}
    for k, v in consts.items():
        if isinstance(v, tuple):  # block-quant (values, scales)
            flat[k + ".values"] = _to_numpy(v[0])
            flat[k + ".scales"] = _to_numpy(v[1])
        else:
            flat[k] = _to_numpy(v)
    np.savez(os.path.join(path, "weights.npz"), **flat)
    if aot:
        export_aot(session, os.path.join(path, PLACED_CONSTS))
    return path


def load_model(path: str, device="cuda"):
    """Rebuild a runnable Session on `device` from a save_model directory in
    a fresh process — the deployment half of the binary model
    (ref: csinn_import_binary_model, source/nn2/format.c:1304-1331 →
    shl_gref_load_binary_model, source/graph_ref/setup.c:929-977).

    Replays each manifest node through the op API (call_op) inside a new
    recording GRAPH session, binding the saved constants under their
    ORIGINAL keys (TensorMeta.const_key), then setup()s.  Fused `ds_block`
    nodes replay as ds_block nodes.  With placed_consts.pt present (a
    save_model(aot=True) of this package) the constants come from it,
    already on the device, instead of weights.npz."""
    import csinn2_tpu_torch.ops  # noqa: F401 — registers every op, ds_block too
    from csinn2_tpu_torch.core.dtypes import Dtype, Layout, MemType, RunMode
    from csinn2_tpu_torch.core.tensor import Tensor, TensorMeta
    from csinn2_tpu_torch.ops.api import call_op
    from csinn2_tpu_torch.runtime.session import Session

    with open(os.path.join(path, "manifest.json")) as f:
        doc = json.load(f)
    if doc.get("format") != FORMAT:
        raise ValueError(f"{path}: manifest format {doc.get('format')!r}, want {FORMAT!r}")
    sess = Session(run_mode=RunMode.GRAPH, device=device)
    placed_path = os.path.join(path, PLACED_CONSTS)
    placed = weights = None
    if os.path.exists(placed_path):
        placed = load_aot(placed_path, sess.device)
    else:
        with np.load(os.path.join(path, "weights.npz")) as z:
            weights = dict(z)

    def meta_from(key, const_key=None):
        td = doc["tensors"][key]
        return TensorMeta(shape=tuple(td["shape"]), dtype=Dtype(td["dtype"]),
                          layout=Layout(td["layout"]),
                          qinfo=_qinfo_from_json(td.get("quant")),
                          name=td.get("name", ""),
                          mem_type=MemType(td.get("mem_type", MemType.DEFAULT.value)),
                          const_key=const_key)

    tmap: Dict[str, Tensor] = {}

    def const_data(ck: str, meta: TensorMeta):
        if placed is not None:
            if ck not in placed:
                raise KeyError(f"weight {ck} missing from {PLACED_CONSTS}")
            return placed[ck]
        if ck + ".values" in weights:
            return (torch.from_numpy(weights[ck + ".values"]),
                    torch.from_numpy(weights[ck + ".scales"]))
        if ck not in weights:
            raise KeyError(f"weight {ck} missing from weights.npz")
        data = torch.from_numpy(np.array(weights[ck]))
        if meta.dtype == Dtype.BFLOAT16 and data.dtype != torch.bfloat16:
            data = data.to(torch.bfloat16)
        return data

    def get_tensor(key):
        if key in tmap:
            return tmap[key]
        ck = "c" + key[1:]            # weights were saved under _const_key(t)
        meta = meta_from(key, const_key=ck)
        t = Tensor(data=const_data(ck, meta), meta=meta)
        tmap[key] = t
        return t

    with sess.build():
        for key in doc["inputs"]:
            tmap[key] = sess.input(meta_from(key))
        for nd in doc["nodes"]:
            params = _params_from_json(nd.get("params_type"), nd.get("params"))
            keys = iter(nd["inputs"])
            structure = nd.get("structure") or ["T"] * len(nd["inputs"])
            tensors = []
            for s in structure:
                if s == "N":
                    tensors.append(None)
                elif s == "T":
                    tensors.append(get_tensor(next(keys)))
                else:                     # ["L", n]
                    tensors.append([get_tensor(next(keys)) for _ in range(s[1])])
            out = call_op(nd["op"], tensors, params,
                          out_qinfo=_qinfo_from_json(nd.get("out_qinfo")),
                          **_extra_from_json(nd.get("extra")))
            outs = out if isinstance(out, tuple) else (out,)
            for k, t in zip(nd["outputs"], outs):
                tmap[k] = t
        sess.set_output(*[tmap[k] for k in doc["outputs"]])
    return sess.setup()


def export_aot(session, path: str) -> str:
    """Write a set-up `session`'s placed constants to `path` (the
    placed_consts.pt of save_model(aot=True)); the counterpart of the JAX
    package's export_aot, which serializes an executable the port does not
    have."""
    if not session._setup_done:
        raise ValueError("export_aot: call setup() first (the constants are not placed)")
    torch.save({"format": FORMAT, "consts": dict(session._consts)}, path)
    return path


def load_aot(path: str, device="cuda") -> Dict[str, Any]:
    """The constants export_aot wrote, on `device` (torch.load,
    weights_only=True)."""
    doc = torch.load(path, map_location=torch.device(device), weights_only=True)
    if doc.get("format") != FORMAT:
        raise ValueError(f"{path}: format {doc.get('format')!r}")
    return {k: tuple(v) if isinstance(v, (tuple, list)) else v
            for k, v in doc["consts"].items()}
