#!/usr/bin/env python3
"""Multi-host TP x DP dryrun — counterpart of examples/multihost_dryrun.py:
the engine over a mesh of two "hosts" with two ranks each, against a
single-process run of the same seeded model.

    python3 csinn2_tpu_torch/examples/multihost_dryrun.py [--device cuda|cpu]

Four ranks are started by parallel.launch.spawn with LOCAL_WORLD_SIZE 2
(ranks 0-1 are host 0, ranks 2-3 host 1), and each builds
make_multihost_mesh(tp=2): tp inside a host, dp = 2 across the hosts.  Each
rank runs one prefill and one decode_steps chunk of the engine; every rank's
logits and tokens must be equal bit for bit (the host loops see the same
tokens), the tokens equal to the single-process engine's and the logits
within the JAX TP tests' gate of its logits (verify(tol=2e-2,
min_cosine=0.999)).  Prints PASS, or exits 1.

--device cuda (the default; it raises without a card): the ranks use NCCL
when there are at least four cards, one a rank, and gloo otherwise, several
ranks sharing a card with collectives staged through the host.
"""

import argparse
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import torch  # noqa: E402

from csinn2_tpu_torch.llm.config import LlamaConfig  # noqa: E402
from csinn2_tpu_torch.llm.engine import InferenceEngine  # noqa: E402
from csinn2_tpu_torch.llm.model import FLOAT, INT8_CHANNEL, init_params, quantize_params  # noqa: E402,E501
from csinn2_tpu_torch.parallel.launch import spawn  # noqa: E402
from csinn2_tpu_torch.parallel.mesh import make_multihost_mesh  # noqa: E402
from csinn2_tpu_torch.utils.device import resolve_device  # noqa: E402
from csinn2_tpu_torch.utils.verify import verify  # noqa: E402

TP, HOSTS, LOCAL = 2, 2, 2
PROMPT = [3, 1, 4, 1, 5]


def build_and_run(mesh, device):
    """The seeded model and one engine step over `mesh` (None: one
    process) → (prefill logits, decode tokens) as numpy."""
    cfg = LlamaConfig(dim=64, n_layers=2, n_heads=4, n_kv_heads=4, ffn_dim=128,
                      vocab_size=256 * TP, max_seq_len=64)
    params = quantize_params(init_params(cfg, FLOAT, seed=0, device=device), INT8_CHANNEL)
    eng = InferenceEngine(cfg, params, batch=mesh.size("dp") if mesh else 1, device=device,
                          mesh=mesh)
    logits = eng.prefill(0, PROMPT)
    toks = eng.decode_steps({0: int(np.argmax(logits))}, n_steps=4)[0]
    return np.asarray(logits, np.float32), np.asarray(toks, np.int64)


def rank_main(device: str):
    mesh = make_multihost_mesh(tp=TP, device=device)
    if mesh.shape != {"dp": HOSTS * LOCAL // TP, "tp": TP}:
        raise AssertionError(f"mesh {mesh.shape}")
    logits, toks = build_and_run(mesh, mesh.device)
    return {"logits": logits, "toks": toks, "coords": mesh.coords, "device": str(mesh.device)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = ap.parse_args()
    dev = resolve_device(args.device)
    world = HOSTS * LOCAL
    backend = "nccl" if dev.type == "cuda" and torch.cuda.device_count() >= world else "gloo"
    gold_logits, gold_toks = build_and_run(None, dev)
    print(f"single process on {dev}: tokens {gold_toks.tolist()}")
    outs = spawn(rank_main, world, backend=backend, device=args.device, timeout_s=600,
                 args=(args.device,), local_world_size=LOCAL)
    for r, o in enumerate(outs):
        print(f"rank {r} (host {r // LOCAL}) at {o['coords']} on {o['device']}: "
              f"tokens {o['toks'].tolist()}")
    ok = True
    for r, o in enumerate(outs[1:], 1):
        if not (np.array_equal(o["logits"], outs[0]["logits"])
                and np.array_equal(o["toks"], outs[0]["toks"])):
            print(f"FAIL: rank {r}'s logits or tokens differ from rank 0's")
            ok = False
    res = verify(outs[0]["logits"], gold_logits, tol=2e-2, min_cosine=0.999)
    if not np.array_equal(outs[0]["toks"], gold_toks) or res.cosine_sim <= 0.999:
        print(f"FAIL: multihost vs single process: tokens {outs[0]['toks'].tolist()} vs "
              f"{gold_toks.tolist()}, {res}")
        ok = False
    if not ok:
        return 1
    print(f"multihost({HOSTS}x{LOCAL}, dp {HOSTS * LOCAL // TP} x tp {TP}, {backend}) PASS: "
          f"tokens identical on every rank and to the single process, logits cos "
          f"{res.cosine_sim:.6f}, max|d| {res.max_abs_err:.2e} vs single process")
    return 0


if __name__ == "__main__":
    sys.exit(main())
