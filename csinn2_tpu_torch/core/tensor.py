"""Tensor and TensorMeta: the framework's tensor handle (counterpart of
csinn2_tpu/core/tensor.py).

(ref: include/csinn/csinn_data_structure.h:505-520 — data, dtype, dims,
name, layout, quant info, mem type.)  Data is a torch tensor, or for a
block-quantized weight (`Tensor(block=BlockQuant)`, mem type BLOCK_Q8_0 /
BLOCK_Q4_0) the (values, scales) pair; in graph mode a Tensor may be
symbolic (data=None) and carry the node that produces it.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import numpy as np
import torch

from csinn2_tpu_torch.core.dtypes import Dtype, Layout, MemType, QuantScheme, dtype_of
from csinn2_tpu_torch.core.quant import BLOCK_SIZE, BlockQuant, QuantInfo, dequantize, quantize

BLOCK_MEM_TYPES = (MemType.BLOCK_Q4_0, MemType.BLOCK_Q8_0)


@dataclasses.dataclass
class TensorMeta:
    """Static metadata of a tensor (shape/dtype/layout/quant)."""

    shape: Tuple[int, ...]
    dtype: Dtype = Dtype.FLOAT32
    layout: Layout = Layout.NCHW
    qinfo: Optional[QuantInfo] = None
    name: str = ""
    mem_type: MemType = MemType.DEFAULT
    const_key: Optional[str] = None   # stable weight key for saved models

    @property
    def size(self) -> int:
        """Element count (ref: csinn_tensor_size, source/nn2/utils.c)."""
        return int(np.prod(self.shape)) if self.shape else 1

    @property
    def byte_size(self) -> int:
        """Storage bytes incl. the fp16 scale of each 32-element block
        (ref: csinn_tensor_byte_size, source/nn2/utils.c)."""
        base = (self.size * self.dtype.bits + 7) // 8
        if self.mem_type in BLOCK_MEM_TYPES:
            base += (self.size // BLOCK_SIZE) * 2
        return base


class Tensor:
    """A torch tensor + quant/layout metadata, or a symbolic graph edge."""

    __slots__ = ("data", "meta", "producer", "out_index", "_placed")

    def __init__(self, data=None, meta: Optional[TensorMeta] = None,
                 qinfo: Optional[QuantInfo] = None, layout: Layout = Layout.NCHW,
                 dtype: Optional[Dtype] = None, name: str = "",
                 producer: Any = None, out_index: int = 0,
                 block: Optional[BlockQuant] = None):
        if block is not None:
            # block-quantized payload: data is the (values, scales) pair
            data = tuple(v if isinstance(v, torch.Tensor) else torch.from_numpy(np.array(v))
                         for v in (block.values, block.scales))
            mem = (MemType.BLOCK_Q4_0 if block.scheme == QuantScheme.BLOCK_Q4_0
                   else MemType.BLOCK_Q8_0)
            meta = meta or TensorMeta(
                shape=tuple(data[0].shape),
                dtype=Dtype.INT4 if mem == MemType.BLOCK_Q4_0 else Dtype.INT8,
                layout=layout, qinfo=qinfo, name=name, mem_type=mem)
        elif data is not None and not isinstance(data, torch.Tensor):
            data = torch.from_numpy(np.array(data))
        if meta is None:
            if data is None:
                raise ValueError("Tensor needs data or meta")
            meta = TensorMeta(shape=tuple(data.shape), dtype=dtype or dtype_of(data.dtype),
                              layout=layout, qinfo=qinfo, name=name)
        self.data = data
        self.meta = meta
        self.producer = producer    # graph Node that computes this tensor (graph mode)
        self.out_index = out_index
        self._placed = {}           # device → block pair moved there (see on_device)

    # -- convenience views ---------------------------------------------------
    @property
    def shape(self):
        return self.meta.shape

    @property
    def dtype(self):
        return self.meta.dtype

    @property
    def layout(self):
        return self.meta.layout

    @property
    def qinfo(self):
        return self.meta.qinfo

    @property
    def name(self):
        return self.meta.name

    @property
    def is_symbolic(self):
        return self.data is None

    @property
    def is_block(self) -> bool:
        return self.meta.mem_type in BLOCK_MEM_TYPES

    def on_device(self, device):
        """The data on `device`.  A block pair moves once per device and is
        kept there, its fp16 scales widened (exactly) to the f32 the kernels
        read; other data moves on every call."""
        device = torch.device(device)
        if not self.is_block:
            return self.data.to(device)
        if device not in self._placed:
            self._placed[device] = place_block(self.data, device)
        return self._placed[device]

    def astype_f32(self) -> torch.Tensor:
        """Dequantized f32 view (ref: shl_ref_tensor_transform_f32,
        source/reference/utils.c:579)."""
        if self.qinfo is not None and not self.qinfo.dtype.is_float:
            return dequantize(self.data, self.qinfo)
        return self.data.float()

    def numpy(self):
        return self.data.detach().cpu().numpy()

    def __repr__(self):
        q = f", q={self.qinfo.scheme.value}" if self.qinfo else ""
        sym = ", symbolic" if self.is_symbolic else ""
        return (f"Tensor({self.name or '?'}: {self.dtype.value}{list(self.shape)}, "
                f"{self.layout.value}{q}{sym})")


def from_float(x, qinfo: QuantInfo, layout: Layout = Layout.NCHW, name: str = "") -> Tensor:
    """Quantize a float array into a Tensor with the given qinfo."""
    q = quantize(x, qinfo)
    meta = TensorMeta(shape=tuple(q.shape), dtype=qinfo.dtype, layout=layout,
                      qinfo=qinfo, name=name)
    return Tensor(data=q, meta=meta)


def place_block(pair, device):
    """A (values, scales) block pair on `device`, scales as f32."""
    values, scales = pair
    return values.to(device), scales.to(device=device, dtype=torch.float32)
