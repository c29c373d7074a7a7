"""Self-contained GGUF reader/writer (no external gguf dependency) — a copy
of csinn2_tpu/llm/gguf_io.py (the port imports nothing of the JAX package;
numpy only), whose writer also emits Q4_0 blocks.

The reference vendors llama.cpp's gguf-py + convert script to turn HF/Meta
checkpoints into its own mmap'd format (ref: tests/llm/convert/shl-convert.py,
tests/llm/convert/gguf-py/).  Here the same role is played by a ~300-line
parser for the subset the LLM engine needs: GGUF v2/v3 little-endian files,
metadata KVs (ints/floats/strings/arrays), and tensor payloads of type
F32/F16/BF16/Q8_0/Q4_0.  The writer exists for round-trip unit tests and for
re-exporting (it emits valid GGUF that this reader and llama.cpp can read).

Layout notes (matching ggml):
  - tensor dims are stored ne-order (ne[0] = fastest/contiguous); a 2-D
    tensor [ne0, ne1] is numpy shape (ne1, ne0) — rows of ne0 elements.
  - Q8_0 block (34 B) = f16 scale + 32×int8, blocks along ne0.
  - Q4_0 block (18 B) = f16 scale + 16 B nibbles; byte j holds elements j
    (low nibble) and j+16 (high nibble), value = nibble − 8.  The writer
    rounds as llm/model.py's Q4_0 mode: d = f16(amax / 7), q in [-7, 7].
    (ref: block layout consumed by block_dequantize_q4/q8,
    source/nn2/utils.c:2079-2180.)
"""

from __future__ import annotations

import struct
from typing import Any, Dict, List, Tuple

import numpy as np

GGUF_MAGIC = 0x46554747          # "GGUF"

# metadata value types
T_U8, T_I8, T_U16, T_I16, T_U32, T_I32, T_F32, T_BOOL, T_STR, T_ARR, \
    T_U64, T_I64, T_F64 = range(13)

# ggml tensor types (subset)
GGML_F32, GGML_F16 = 0, 1
GGML_Q4_0 = 2
GGML_Q8_0 = 8
GGML_I8, GGML_I16, GGML_I32 = 24, 25, 26
GGML_BF16 = 30

_SCALAR_FMT = {T_U8: "<B", T_I8: "<b", T_U16: "<H", T_I16: "<h",
               T_U32: "<I", T_I32: "<i", T_F32: "<f", T_BOOL: "<B",
               T_U64: "<Q", T_I64: "<q", T_F64: "<d"}

BLOCK = 32


class _Reader:
    def __init__(self, buf: memoryview):
        self.buf = buf
        self.pos = 0

    def read(self, fmt: str):
        v = struct.unpack_from(fmt, self.buf, self.pos)
        self.pos += struct.calcsize(fmt)
        return v[0] if len(v) == 1 else v

    def read_str(self) -> str:
        n = self.read("<Q")
        s = bytes(self.buf[self.pos:self.pos + n]).decode("utf-8")
        self.pos += n
        return s

    def read_value(self, vtype: int):
        if vtype == T_STR:
            return self.read_str()
        if vtype == T_ARR:
            etype = self.read("<I")
            n = self.read("<Q")
            if etype in _SCALAR_FMT:
                fmt = _SCALAR_FMT[etype]
                width = struct.calcsize(fmt)
                arr = np.frombuffer(self.buf, dtype=np.dtype(fmt[1]),
                                    count=n, offset=self.pos).copy()
                self.pos += n * width
                if etype == T_BOOL:
                    arr = arr.astype(bool)
                return arr.tolist() if etype in (T_STR,) else arr
            return [self.read_value(etype) for _ in range(n)]
        if vtype == T_BOOL:
            return bool(self.read("<B"))
        return self.read(_SCALAR_FMT[vtype])


def _dequant_blocks_q8_0(raw: np.ndarray, n: int) -> Tuple[np.ndarray, np.ndarray]:
    """raw bytes of n/32 Q8_0 blocks → (int8 values [n], f32 scales [n/32])."""
    nb = n // BLOCK
    rec = raw[:nb * 34].reshape(nb, 34)
    d = rec[:, :2].copy().view(np.float16).reshape(nb).astype(np.float32)
    q = rec[:, 2:].copy().view(np.int8).reshape(nb * BLOCK)
    return q, d


def _dequant_blocks_q4_0(raw: np.ndarray, n: int) -> Tuple[np.ndarray, np.ndarray]:
    """raw bytes of n/32 Q4_0 blocks → (int8 carrier [n] in [-8,7], f32
    scales [n/32])."""
    nb = n // BLOCK
    rec = raw[:nb * 18].reshape(nb, 18)
    d = rec[:, :2].copy().view(np.float16).reshape(nb).astype(np.float32)
    pk = rec[:, 2:]                                   # [nb, 16]
    lo = (pk & 0x0F).astype(np.int8) - 8
    hi = (pk >> 4).astype(np.int8) - 8
    q = np.concatenate([lo, hi], axis=1).reshape(nb * BLOCK)
    return q, d


def _quant_blocks_q8_0(x: np.ndarray) -> bytes:
    x = np.asarray(x, np.float32).reshape(-1, BLOCK)
    amax = np.abs(x).max(axis=1, keepdims=True)
    d = (amax / 127.0).astype(np.float16)
    df = d.astype(np.float32)
    q = np.where(df == 0, 0.0, np.round(x / np.where(df == 0, 1.0, df)))
    q = np.clip(q, -127, 127).astype(np.int8)
    out = np.empty((x.shape[0], 34), np.uint8)
    out[:, :2] = d.view(np.uint8).reshape(-1, 2)
    out[:, 2:] = q.view(np.uint8)
    return out.tobytes()


def _quant_blocks_q4_0(x: np.ndarray) -> bytes:
    x = np.asarray(x, np.float32).reshape(-1, BLOCK)
    amax = np.abs(x).max(axis=1, keepdims=True)
    d = (amax / 7.0).astype(np.float16)
    df = d.astype(np.float32)
    q = np.where(df == 0, 0.0, np.round(x / np.where(df == 0, 1.0, df)))
    n = (np.clip(q, -7, 7) + 8).astype(np.uint8)          # nibble = q + 8
    out = np.empty((x.shape[0], 18), np.uint8)
    out[:, :2] = d.view(np.uint8).reshape(-1, 2)
    out[:, 2:] = n[:, :16] | (n[:, 16:] << 4)
    return out.tobytes()


class GGUFFile:
    """Parsed GGUF: .metadata (dict), .tensors (name → info), and
    tensor(name) → numpy array (dequantized layout preserved: quantized
    tensors return (int8_values, f32_scales_per_block) pairs via
    tensor_quantized, or dequantized f32 via tensor())."""

    def __init__(self, path: str):
        self.path = path
        self._mm = np.memmap(path, dtype=np.uint8, mode="r")
        r = _Reader(memoryview(self._mm))
        magic = r.read("<I")
        assert magic == GGUF_MAGIC, f"not a GGUF file: {path}"
        self.version = r.read("<I")
        assert self.version in (2, 3), f"unsupported GGUF v{self.version}"
        n_tensors = r.read("<Q")
        n_kv = r.read("<Q")
        self.metadata: Dict[str, Any] = {}
        for _ in range(n_kv):
            key = r.read_str()
            vtype = r.read("<I")
            self.metadata[key] = r.read_value(vtype)
        self.tensors: Dict[str, dict] = {}
        order: List[str] = []
        for _ in range(n_tensors):
            name = r.read_str()
            nd = r.read("<I")
            ne = [r.read("<Q") for _ in range(nd)]
            ttype = r.read("<I")
            off = r.read("<Q")
            self.tensors[name] = {"ne": ne, "type": ttype, "offset": off}
            order.append(name)
        align = int(self.metadata.get("general.alignment", 32))
        data_start = (r.pos + align - 1) // align * align
        self._data_start = data_start

    def _raw(self, name: str) -> Tuple[np.ndarray, dict]:
        info = self.tensors[name]
        n = int(np.prod(info["ne"]))
        t = info["type"]
        if t == GGML_F32:
            nbytes = n * 4
        elif t in (GGML_F16, GGML_BF16):
            nbytes = n * 2
        elif t == GGML_Q8_0:
            nbytes = n // BLOCK * 34
        elif t == GGML_Q4_0:
            nbytes = n // BLOCK * 18
        elif t == GGML_I8:
            nbytes = n
        else:
            raise NotImplementedError(f"ggml type {t} ({name})")
        s = self._data_start + info["offset"]
        return np.asarray(self._mm[s:s + nbytes]), info

    def _np_shape(self, info) -> Tuple[int, ...]:
        return tuple(reversed(info["ne"]))

    def tensor(self, name: str) -> np.ndarray:
        """Dequantized numpy array in natural (numpy) shape — rows of ne0."""
        raw, info = self._raw(name)
        n = int(np.prod(info["ne"]))
        shape = self._np_shape(info)
        t = info["type"]
        if t == GGML_F32:
            return raw.view(np.float32).reshape(shape)
        if t == GGML_F16:
            return raw.view(np.float16).reshape(shape).astype(np.float32)
        if t == GGML_BF16:
            u32 = raw.view(np.uint16).astype(np.uint32) << 16
            return u32.view(np.float32).reshape(shape)
        if t == GGML_I8:
            return raw.view(np.int8).reshape(shape)
        q, d = self.tensor_quantized(name)
        return (q.reshape(-1, BLOCK).astype(np.float32)
                * d.reshape(-1, 1)).reshape(shape)

    def tensor_quantized(self, name: str) -> Tuple[np.ndarray, np.ndarray]:
        """Q8_0/Q4_0 tensor → (int8 values [np shape], f32 scales
        [..., ne0/32]) without dequantizing (blocks run along ne0)."""
        raw, info = self._raw(name)
        n = int(np.prod(info["ne"]))
        shape = self._np_shape(info)
        t = info["type"]
        if t == GGML_Q8_0:
            q, d = _dequant_blocks_q8_0(raw, n)
        elif t == GGML_Q4_0:
            q, d = _dequant_blocks_q4_0(raw, n)
        else:
            raise ValueError(f"{name} is not block-quantized (type {t})")
        return q.reshape(shape), d.reshape(shape[:-1] + (shape[-1] // BLOCK,))

    def close(self):
        del self._mm


def write_gguf(path: str, metadata: Dict[str, Any],
               tensors: Dict[str, np.ndarray],
               quantize: Dict[str, str] | None = None,
               align: int = 32):
    """Minimal GGUF v3 writer (round-trip tests / re-export).  metadata
    values: int → i64 (or u32 when key ends with known u32 fields), float →
    f32, str, bool, list[str] / list[float] / list[int] arrays.
    quantize: tensor name → "q8_0" or "q4_0" writes that tensor as Q8_0 or
    Q4_0 blocks."""
    quantize = quantize or {}

    def enc_str(s: str) -> bytes:
        b = s.encode("utf-8")
        return struct.pack("<Q", len(b)) + b

    def enc_value(v) -> Tuple[int, bytes]:
        if isinstance(v, bool):
            return T_BOOL, struct.pack("<B", int(v))
        if isinstance(v, (int, np.integer)):
            return T_U32 if 0 <= v < 2**32 else T_I64, \
                struct.pack("<I" if 0 <= v < 2**32 else "<q", int(v))
        if isinstance(v, (float, np.floating)):
            return T_F32, struct.pack("<f", float(v))
        if isinstance(v, str):
            return T_STR, enc_str(v)
        if isinstance(v, (list, tuple, np.ndarray)):
            items = list(v)
            if all(isinstance(i, str) for i in items):
                body = b"".join(enc_str(i) for i in items)
                et = T_STR
            elif all(isinstance(i, (int, np.integer)) for i in items):
                body = b"".join(struct.pack("<i", int(i)) for i in items)
                et = T_I32
            else:
                body = b"".join(struct.pack("<f", float(i)) for i in items)
                et = T_F32
            return T_ARR, struct.pack("<IQ", et, len(items)) + body
        raise TypeError(type(v))

    blobs = []
    infos = []
    offset = 0
    for name, arr in tensors.items():
        arr = np.asarray(arr)
        ne = list(reversed(arr.shape))
        mode = quantize.get(name)
        if mode == "q8_0":
            assert arr.shape[-1] % BLOCK == 0, name
            blob = _quant_blocks_q8_0(arr)
            ttype = GGML_Q8_0
        elif mode == "q4_0":
            assert arr.shape[-1] % BLOCK == 0, name
            blob = _quant_blocks_q4_0(arr)
            ttype = GGML_Q4_0
        elif arr.dtype == np.float16:
            blob = arr.astype(np.float16).tobytes()
            ttype = GGML_F16
        elif arr.dtype == np.int8:
            blob = arr.tobytes()
            ttype = GGML_I8
        else:
            blob = arr.astype(np.float32).tobytes()
            ttype = GGML_F32
        infos.append((name, ne, ttype, offset))
        pad = (-len(blob)) % align
        blobs.append(blob + b"\x00" * pad)
        offset += len(blob) + pad

    out = bytearray()
    out += struct.pack("<IIQQ", GGUF_MAGIC, 3, len(infos), len(metadata))
    for k, v in metadata.items():
        vt, body = enc_value(v)
        out += enc_str(k) + struct.pack("<I", vt) + body
    for name, ne, ttype, off in infos:
        out += enc_str(name) + struct.pack("<I", len(ne))
        for d in ne:
            out += struct.pack("<Q", d)
        out += struct.pack("<IQ", ttype, off)
    pad = (-len(out)) % align
    out += b"\x00" * pad
    with open(path, "wb") as f:
        f.write(bytes(out))
        for b in blobs:
            f.write(b)
    return path
