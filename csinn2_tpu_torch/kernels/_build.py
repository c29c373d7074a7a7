"""Build and load the CUDA kernel libraries from kernels/csrc/.

Each `csrc/<name>.cu` is compiled by nvcc for sm_90a into its own shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds), all sources in parallel, at first use.  Libraries live under
`_build/<hash>/`, where the hash covers every source, header and flag: a
changed source rebuilds.  Wrappers call the C entry points through ctypes
with `data_ptr()`s and the current stream; every entry point returns
`cudaGetLastError()` right after its launch, and a non-zero code raises.

Nothing here runs at import time: the CPU tests import every module of the
package on a host without nvcc or a card.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-O3", "-std=c++17", "-gencode", "arch=compute_90a,code=sm_90a",
              "-shared", "-Xcompiler", "-fPIC", "-lineinfo", "-Xptxas", "-v")

# launches of each kernel, one per wrapper call that launched it on the card
launch_counts: Dict[str, int] = collections.Counter()

_lock = threading.Lock()
_libs: Optional[Dict[str, ctypes.CDLL]] = None
build_seconds: Optional[float] = None     # wall time of the last build/load


def reset_launch_counts() -> None:
    launch_counts.clear()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                       "(set CUDA_HOME or put nvcc on PATH)")


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        if p.suffix in (".cu", ".cuh"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _build_all(out_dir: Path) -> None:
    """Compile every csrc/*.cu into out_dir/lib<name>.so, one nvcc each, all
    started together.  Writes to a temporary name and renames, so a process
    that finds the library finds it whole."""
    nvcc = _nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = []
    for src in sorted(CSRC.glob("*.cu")):
        lib = out_dir / f"lib{src.stem}.so"
        if lib.exists():
            continue
        tmp = out_dir / f".lib{src.stem}.{os.getpid()}.so"
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(src)]
        procs.append((src, tmp, lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    errors = []
    for src, tmp, lib, proc in procs:
        log, _ = proc.communicate()
        (out_dir / f"{src.stem}.log").write_text(log)
        if proc.returncode != 0:
            errors.append(f"{src.name} (exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, lib)
    if errors:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(errors))


def libs() -> Dict[str, ctypes.CDLL]:
    """Build (if needed) and load every kernel library; name → CDLL."""
    global _libs, build_seconds
    with _lock:
        if _libs is None:
            t0 = time.perf_counter()
            out_dir = BUILD_ROOT / _source_hash()
            _build_all(out_dir)
            _libs = {src.stem: ctypes.CDLL(str(out_dir / f"lib{src.stem}.so"))
                     for src in sorted(CSRC.glob("*.cu"))}
            build_seconds = time.perf_counter() - t0
        return _libs


def build_logs() -> Dict[str, str]:
    """nvcc/ptxas output (registers, shared memory, spills) per source."""
    out_dir = BUILD_ROOT / _source_hash()
    return {p.stem: p.read_text() for p in sorted(out_dir.glob("*.log"))}


@functools.lru_cache(maxsize=None)
def c_function(lib: str, name: str, argtypes: tuple, restype=ctypes.c_int):
    """The C entry point `name` of csrc/<lib>.cu, typed."""
    fn = getattr(libs()[lib], name)
    fn.argtypes = list(argtypes)
    fn.restype = restype
    return fn


def check(lib: str, err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error (each library exports
    csinn2_cuda_error_string from csrc/common.cuh)."""
    if err != 0:
        msg = getattr(libs()[lib], "csinn2_cuda_error_string")
        msg.argtypes = [ctypes.c_int]
        msg.restype = ctypes.c_char_p
        raise RuntimeError(f"{what}: CUDA error {err}: "
                           f"{msg(err).decode(errors='replace')}")
