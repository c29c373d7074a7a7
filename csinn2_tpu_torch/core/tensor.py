"""Tensor and TensorMeta: the framework's tensor handle (counterpart of
csinn2_tpu/core/tensor.py; block-quant payloads are not ported yet).

(ref: include/csinn/csinn_data_structure.h:505-520 — data, dtype, dims,
name, layout, quant info, mem type.)  Data is a torch tensor; in graph mode
a Tensor may be symbolic (data=None) and carry the node that produces it.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import numpy as np
import torch

from csinn2_tpu_torch.core.dtypes import Dtype, Layout, MemType, dtype_of
from csinn2_tpu_torch.core.quant import QuantInfo, quantize


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


class Tensor:
    """A torch tensor + quant/layout metadata, or a symbolic graph edge."""

    __slots__ = ("data", "meta", "producer", "out_index")

    def __init__(self, data=None, meta: Optional[TensorMeta] = None,
                 qinfo: Optional[QuantInfo] = None, layout: Layout = Layout.NCHW,
                 dtype: Optional[Dtype] = None, name: str = "",
                 producer: Any = None, out_index: int = 0):
        if data is not None and not isinstance(data, torch.Tensor):
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
