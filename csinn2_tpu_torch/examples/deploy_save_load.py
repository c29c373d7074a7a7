#!/usr/bin/env python3
"""Deployment flow on the port (counterpart of examples/deploy_save_load.py):
quantize a model, save the model directory, then reload it in a FRESH
process and serve — the csinn binary-model path (ref: save in
shl_gref_session_setup, source/graph_ref/setup.c:735; load via
csinn_import_binary_model, source/nn2/format.c:1304-1331).

    python3 -m csinn2_tpu_torch.examples.deploy_save_load [--size 32] [--aot]
        [--device cuda|cpu]

MobileNetV1 INT8_SYM at batch 1 (weights seed 0, image numpy seed 0) is
calibrated, built and run; runtime/export.save_model writes manifest.json
and weights.npz (with --aot also placed_consts.pt, the placed constants)
into a temporary directory; a fresh interpreter load_model()s it on the same
device and must reproduce the saved logits bit for bit: PASS or FAIL.
CSINN2_FUSE_DS=1 in the environment saves and reloads the fused blocks.
"""

import argparse
import os
import subprocess
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))

import numpy as np  # noqa: E402


def build_and_save(path: str, size: int, aot: bool, device) -> np.ndarray:
    from csinn2_tpu_torch.core.dtypes import QuantScheme
    from csinn2_tpu_torch.models.mobilenet import MobileNetV1
    from csinn2_tpu_torch.runtime.export import save_model

    model = MobileNetV1(input_size=size)
    x = np.random.default_rng(0).random(model.input_shape(1)).astype(np.float32)
    model.calibrate(x, device=device)
    sess = model.build_session(QuantScheme.INT8_SYM, batch=1, device=device)
    xq = model.prepare_input(x, sess)
    out = sess.run(xq).cpu().numpy()
    save_model(sess, path, aot=aot)
    np.save(os.path.join(path, "example_input.npy"), xq.cpu().numpy())
    np.save(os.path.join(path, "expected_output.npy"), out)
    n = sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path))
    print(f"saved model → {path} ({n / 2**20:.1f} MiB; "
          f"{sum(nd.op == 'ds_block' for nd in sess.graph.nodes)} ds_block nodes)", flush=True)
    return out


def load_and_serve(path: str, device: str) -> int:
    """Run in a fresh interpreter: reload on `device` and check against the
    saved output.  Returns the process's exit code."""
    code = f"""
import sys; sys.path.insert(0, {str(REPO)!r})
import numpy as np
from csinn2_tpu_torch.runtime.export import load_model
sess = load_model({path!r}, device={device!r})
x = np.load({os.path.join(path, 'example_input.npy')!r})
want = np.load({os.path.join(path, 'expected_output.npy')!r})
got = sess.run(x).cpu().numpy()
ok = got.dtype == want.dtype and np.array_equal(got, want)
print("fresh-process reload:", "outputs match bit for bit" if ok else "MISMATCH",
      f"({{len(sess.graph.nodes)}} nodes)", flush=True)
sys.exit(0 if ok else 1)
"""
    return subprocess.run([sys.executable, "-c", code], env={**os.environ}).returncode


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=32)
    ap.add_argument("--aot", action="store_true",
                    help="also save the placed constants (placed_consts.pt)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    from csinn2_tpu_torch.utils.device import resolve_device
    from csinn2_tpu_torch.utils.platform import backend_summary
    dev = resolve_device(args.device)
    print(f"== deploy/save/load on {backend_summary(dev)} ==", flush=True)

    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "model")
        build_and_save(path, args.size, args.aot, dev)
        rc = load_and_serve(path, str(dev))
    print("PASS" if rc == 0 else "FAIL")
    return rc


if __name__ == "__main__":
    sys.exit(main())
