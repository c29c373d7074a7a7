"""Binary-model I/O: the ctypes binding of the native CTBM serializer — the
counterpart of csinn2_tpu/runtime/bm.py, on the port's copy of the C++
library (native/bmfmt.cpp).

(ref: binary model save/load — csinn_import_binary_model,
source/nn2/format.c:1304-1331.)  The library writes 4096-aligned sections
and mmaps them back zero-copy; files are byte-identical to the JAX
package's for the same arrays.  It is built with g++ at first use into
native/_build/ (named by a hash of the source and flags, written to a
temporary name and renamed, so concurrent first uses each find a whole
library); a failed build raises with the compiler's output, nothing falls
back.

bfloat16 sections (dtype code 12) cross as their uint16 bit patterns: numpy
has no bfloat16 without ml_dtypes.  save_bm takes numpy arrays (an ml_dtypes
bfloat16 array from a JAX tree included) and torch tensors (bf16 written as
its bits); BinaryModel.tensors() returns numpy views with bf16 sections as
uint16 and names them in BinaryModel.bf16, and BinaryModel.tensor() gives a
torch tensor copied out of the mapping.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import warnings
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

NATIVE = Path(__file__).resolve().parent.parent / "native"
SOURCE = NATIVE / "bmfmt.cpp"
BUILD_DIR = NATIVE / "_build"
CXX_FLAGS = ("-O2", "-fPIC", "-std=c++17", "-Wall", "-shared")
_MAX_NAME = 192
_MAX_DIMS = 8

# dtype codes: stable small ints (not numpy internals) for the on-disk format
_DTYPE_CODES = {
    "int8": 1, "uint8": 2, "int16": 3, "uint16": 4, "int32": 5, "uint32": 6,
    "int64": 7, "float16": 8, "float32": 9, "float64": 10, "bool": 11,
    "bfloat16": 12,
}
_CODE_DTYPES = {v: k for k, v in _DTYPE_CODES.items()}
BF16 = _DTYPE_CODES["bfloat16"]

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def build_native(source: Path, build_dir: Path, flags) -> Path:
    """The shared library `lib<stem>-<hash>.so` of a C++ source in
    build_dir, built with g++ (or $CXX) if missing; the hash covers the
    source and the flags.  The library is written to a temporary name and
    renamed, so concurrent first uses each find a whole library; a failed
    build raises with the compiler's output."""
    h = hashlib.sha256(" ".join(flags).encode() + source.read_bytes())
    so = build_dir / f"lib{source.stem}-{h.hexdigest()[:16]}.so"
    if so.exists():
        return so
    build_dir.mkdir(parents=True, exist_ok=True)
    tmp = build_dir / f".lib{source.stem}.{os.getpid()}.{threading.get_ident()}.so"
    cxx = os.environ.get("CXX", "g++")
    r = subprocess.run([cxx, *flags, "-o", str(tmp), str(source)],
                       capture_output=True, text=True)
    if r.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building {source.name} failed ({cxx} exit {r.returncode}):\n"
                           f"{r.stdout}{r.stderr}")
    os.replace(tmp, so)
    return so


def _build() -> Path:
    """The library for this source and these flags, built if missing."""
    return build_native(SOURCE, BUILD_DIR, CXX_FLAGS)


def _load_lib() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(_build()))
        lib.ctbm_writer_open.restype = ctypes.c_void_p
        lib.ctbm_writer_open.argtypes = [ctypes.c_char_p, ctypes.c_uint64]
        lib.ctbm_writer_add.restype = ctypes.c_int
        lib.ctbm_writer_add.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                        ctypes.c_int32, ctypes.c_int32,
                                        ctypes.POINTER(ctypes.c_int64),
                                        ctypes.c_void_p, ctypes.c_uint64]
        lib.ctbm_writer_close.restype = ctypes.c_int
        lib.ctbm_writer_close.argtypes = [ctypes.c_void_p]
        lib.ctbm_open.restype = ctypes.c_void_p
        lib.ctbm_open.argtypes = [ctypes.c_char_p]
        lib.ctbm_n_sections.restype = ctypes.c_uint64
        lib.ctbm_n_sections.argtypes = [ctypes.c_void_p]
        lib.ctbm_section.restype = ctypes.c_void_p
        lib.ctbm_section.argtypes = [ctypes.c_void_p, ctypes.c_uint64,
                                     ctypes.c_char_p,
                                     ctypes.POINTER(ctypes.c_int32),
                                     ctypes.POINTER(ctypes.c_int32),
                                     ctypes.POINTER(ctypes.c_int64),
                                     ctypes.POINTER(ctypes.c_uint64)]
        lib.ctbm_close.argtypes = [ctypes.c_void_p]
        _lib = lib
        return lib


def _as_numpy(a):
    """An array or tensor → (C-contiguous host numpy array, dtype code):
    bfloat16 as its uint16 bits with code 12."""
    if isinstance(a, torch.Tensor):
        t = a.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), BF16
        a = t.numpy()
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        return a.view(np.uint16), BF16
    if a.dtype.name not in _DTYPE_CODES:
        raise ValueError(f"unsupported dtype {a.dtype.name}")
    return a, _DTYPE_CODES[a.dtype.name]


def save_bm(path: str, tensors: Dict[str, object]) -> str:
    """Write a CTBM file (native writer; 4096-aligned sections)."""
    lib = _load_lib()
    w = lib.ctbm_writer_open(os.fsencode(path), len(tensors))
    if not w:
        raise IOError(f"cannot open {path}")
    try:
        for name, arr in tensors.items():
            arr, code = _as_numpy(arr)
            shape = (ctypes.c_int64 * _MAX_DIMS)(*arr.shape)
            rc = lib.ctbm_writer_add(
                w, name.encode(), code, arr.ndim, shape,
                arr.ctypes.data_as(ctypes.c_void_p) if arr.size else None,
                arr.nbytes)
            if rc != 0:
                raise IOError(f"write failed for {name}: rc={rc}")
    finally:
        rc = lib.ctbm_writer_close(w)
    if rc != 0:
        raise IOError(f"close failed: rc={rc}")
    return path


class BinaryModel:
    """mmap'd CTBM file; tensors() returns zero-copy numpy views (valid
    until close), bf16 sections as uint16 with their names in .bf16."""

    def __init__(self, path: str):
        self._lib = _load_lib()
        self._r = self._lib.ctbm_open(os.fsencode(path))
        if not self._r:
            raise IOError(f"cannot open/parse {path}")
        self.path = path
        self.bf16 = set()

    def tensors(self) -> Dict[str, np.ndarray]:
        out = {}
        for i in range(self._lib.ctbm_n_sections(self._r)):
            name = ctypes.create_string_buffer(_MAX_NAME)
            dtype = ctypes.c_int32()
            ndim = ctypes.c_int32()
            shape = (ctypes.c_int64 * _MAX_DIMS)()
            nbytes = ctypes.c_uint64()
            ptr = self._lib.ctbm_section(self._r, i, name, ctypes.byref(dtype),
                                         ctypes.byref(ndim), shape,
                                         ctypes.byref(nbytes))
            if not ptr:
                raise IOError(f"bad section {i}")
            key = name.value.decode()
            shp = tuple(shape[j] for j in range(ndim.value))
            if dtype.value == BF16:
                npdt = np.dtype(np.uint16)
                self.bf16.add(key)
            else:
                npdt = np.dtype(_CODE_DTYPES[dtype.value])
            buf = (ctypes.c_char * nbytes.value).from_address(ptr)
            arr = np.frombuffer(buf, dtype=npdt).reshape(shp)
            arr.flags.writeable = False
            out[key] = arr
        return out

    def tensor(self, name: str, view: np.ndarray, device) -> torch.Tensor:
        """Section `name` (its view from tensors()) as a tensor on `device`,
        copied out of the mapping, so it outlives close()."""
        with warnings.catch_warnings():
            # the view is read-only; torch only reads it before the copy
            warnings.simplefilter("ignore", UserWarning)
            if name in self.bf16:
                t = torch.from_numpy(view.view(np.int16)).view(torch.bfloat16)
            else:
                t = torch.from_numpy(view)
        return t.to(device, copy=True)

    def close(self):
        if self._r:
            self._lib.ctbm_close(self._r)
            self._r = None

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


def load_bm(path: str) -> Dict[str, np.ndarray]:
    """Load all tensors as numpy arrays copied out of the mapping (bf16
    sections as their uint16 bits)."""
    with BinaryModel(path) as bm:
        return {k: np.array(v) for k, v in bm.tensors().items()}
