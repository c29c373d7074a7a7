"""Python binding for the native prefetching data loader (counterpart of
csinn2_tpu/runtime/dataloader.py, on the port's copy of the C++ source,
native/dataloader.cpp — mmap + a background prefetch thread).

The reference feeds inputs synchronously from disk in its example mains
(ref: example/c906_mobilenetv1_f16.c get_binary_from_file); an accelerator
needs its host to stage inputs while the previous batch runs, so batches
are produced by a native thread into a bounded queue.

    dl = DataLoader("samples.f32", sample_shape=(224, 224, 3), batch=8)
    for batch in dl:              # np.float32 [<=batch, *sample_shape]
        sess.run(batch)

The library is built with g++ at first use into native/_build/, named by a
hash of the source and flags, as runtime/bm.py builds bmfmt.cpp; a failed
build raises with the compiler's output.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional, Sequence

import numpy as np

from csinn2_tpu_torch.runtime.bm import BUILD_DIR, NATIVE, build_native

SOURCE = NATIVE / "dataloader.cpp"
CXX_FLAGS = ("-O2", "-fPIC", "-std=c++17", "-Wall", "-shared", "-pthread")

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def _load_lib() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build_native(SOURCE, BUILD_DIR, CXX_FLAGS)))
        lib.dl_open.restype = ctypes.c_void_p
        lib.dl_open.argtypes = [ctypes.c_char_p, ctypes.c_uint64, ctypes.c_uint64,
                                ctypes.c_int, ctypes.c_uint64]
        lib.dl_n_samples.restype = ctypes.c_uint64
        lib.dl_n_samples.argtypes = [ctypes.c_void_p]
        lib.dl_next.restype = ctypes.c_uint64
        lib.dl_next.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_float)]
        lib.dl_close.restype = None
        lib.dl_close.argtypes = [ctypes.c_void_p]
        _lib = lib
        return lib


class DataLoader:
    def __init__(self, path: str, sample_shape: Sequence[int], batch: int,
                 loop: bool = False, prefetch_depth: int = 4):
        self.sample_shape = tuple(int(d) for d in sample_shape)
        self.batch = int(batch)
        if self.batch < 1:
            raise ValueError(f"batch must be >= 1, got {batch}")
        self._floats = int(np.prod(self.sample_shape))
        lib = _load_lib()
        self._lib = lib
        self._h = lib.dl_open(str(path).encode(), self._floats, self.batch,
                              1 if loop else 0, prefetch_depth)
        if not self._h:
            raise OSError(f"dl_open failed for {path} "
                          f"(size must be a multiple of {self._floats * 4} bytes)")
        self.n_samples = int(lib.dl_n_samples(self._h))
        self._buf = np.empty((self.batch, self._floats), np.float32)

    def next(self) -> Optional[np.ndarray]:
        """Next batch [n, *sample_shape] (n ≤ batch at EOF), or None."""
        if not self._h:
            raise ValueError("DataLoader is closed")
        got = self._lib.dl_next(
            self._h, self._buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        if got == 0:
            return None
        return self._buf[:got].reshape((got,) + self.sample_shape).copy()

    def __iter__(self):
        while True:
            b = self.next()
            if b is None:
                return
            yield b

    def close(self):
        if getattr(self, "_h", None):
            self._lib.dl_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def write_archive(path: str, samples: np.ndarray):
    """Producer helper: raw little-endian f32 archive (numpy tofile)."""
    np.asarray(samples, np.float32).tofile(path)
