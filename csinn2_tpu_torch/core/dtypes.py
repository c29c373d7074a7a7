"""Core enums: dtypes, quant schemes, layouts, run modes, backends
(counterpart of csinn2_tpu/core/dtypes.py).

Re-expression of the reference's data-structure enums
(ref: include/csinn/csinn_data_structure.h:37-134, :393-441).  The JAX
package's routing tiers keep their meaning here: the float reference path,
the plain lowering (XLA there, plain PyTorch ops here: `Api.TORCH`), the
hand-written kernel tier (Pallas there, CUDA here: `Api.CUDA`), and AUTO.
"""

from __future__ import annotations

import enum

import torch


class Dtype(enum.Enum):
    """Tensor element types (ref: csinn_dtype_enum, csinn_data_structure.h:37-52)."""

    BOOL = "bool"
    INT4 = "int4"      # carried in int8 (packed form is a storage detail)
    UINT8 = "uint8"
    INT8 = "int8"
    UINT16 = "uint16"
    INT16 = "int16"
    UINT32 = "uint32"
    INT32 = "int32"
    FLOAT16 = "float16"
    BFLOAT16 = "bfloat16"
    FLOAT32 = "float32"
    FLOAT64 = "float64"
    INT64 = "int64"

    @property
    def torch(self) -> torch.dtype:
        """The torch dtype that carries this element type."""
        return _TORCH_MAP[self]

    @property
    def bits(self) -> int:
        return _BITS[self]

    @property
    def is_float(self) -> bool:
        return self in (Dtype.FLOAT16, Dtype.BFLOAT16, Dtype.FLOAT32, Dtype.FLOAT64)

    @property
    def is_quantized_int(self) -> bool:
        return self in (Dtype.INT4, Dtype.UINT8, Dtype.INT8, Dtype.UINT16, Dtype.INT16)

    @property
    def qmin(self) -> int:
        return _QRANGE[self][0]

    @property
    def qmax(self) -> int:
        return _QRANGE[self][1]


_TORCH_MAP = {
    Dtype.BOOL: torch.bool,
    Dtype.INT4: torch.int8,
    Dtype.UINT8: torch.uint8,
    Dtype.INT8: torch.int8,
    Dtype.UINT16: torch.uint16,
    Dtype.INT16: torch.int16,
    Dtype.UINT32: torch.uint32,
    Dtype.INT32: torch.int32,
    Dtype.FLOAT16: torch.float16,
    Dtype.BFLOAT16: torch.bfloat16,
    Dtype.FLOAT32: torch.float32,
    Dtype.FLOAT64: torch.float64,
    Dtype.INT64: torch.int64,
}

_BITS = {
    Dtype.BOOL: 8, Dtype.INT4: 4, Dtype.UINT8: 8, Dtype.INT8: 8,
    Dtype.UINT16: 16, Dtype.INT16: 16, Dtype.UINT32: 32, Dtype.INT32: 32,
    Dtype.FLOAT16: 16, Dtype.BFLOAT16: 16, Dtype.FLOAT32: 32,
    Dtype.FLOAT64: 64, Dtype.INT64: 64,
}

# integer quantization ranges (ref: quantize clamp bounds in source/nn2/utils.c)
_QRANGE = {
    Dtype.INT4: (-8, 7),
    Dtype.UINT8: (0, 255),
    Dtype.INT8: (-128, 127),
    Dtype.UINT16: (0, 65535),
    Dtype.INT16: (-32768, 32767),
    Dtype.INT32: (-(2**31), 2**31 - 1),
    Dtype.BOOL: (0, 1),
    Dtype.UINT32: (0, 2**32 - 1),
    Dtype.INT64: (-(2**63), 2**63 - 1),
    Dtype.FLOAT16: (0, 0), Dtype.BFLOAT16: (0, 0),
    Dtype.FLOAT32: (0, 0), Dtype.FLOAT64: (0, 0),
}


def dtype_of(t: torch.dtype) -> Dtype:
    """The Dtype carried by torch dtype `t`."""
    for d, td in _TORCH_MAP.items():
        if td == t and d != Dtype.INT4:
            return d
    raise ValueError(f"no Dtype for {t}")


class QuantScheme(enum.Enum):
    """Quantization schemes (ref: csinn_quant_enum, csinn_data_structure.h:70-88)."""

    UNSET = "unset"
    INT4_SYM = "int4_sym"
    UINT8_ASYM = "uint8_asym"
    UINT8_SYM = "uint8_sym"
    INT8_ASYM = "int8_asym"
    INT8_SYM = "int8_sym"
    INT16_SYM = "int16_sym"
    FLOAT16 = "float16"
    BFLOAT16 = "bfloat16"
    FLOAT32 = "float32"
    INT4_ASYM_W_SYM = "int4_asym_w_sym"    # asym activations, sym weights
    INT8_ASYM_W_SYM = "int8_asym_w_sym"
    FLOAT16_W_INT8 = "float16_w_int8"      # fp16 activations, int8-sym weights
    BLOCK_Q2_K = "block_q2_k"
    BLOCK_Q4_0 = "block_q4_0"              # llama.cpp-style 32-elem blocks, fp16 scale
    BLOCK_Q8_0 = "block_q8_0"

    @property
    def act_dtype(self) -> Dtype:
        return _SCHEME_ACT[self]

    @property
    def weight_dtype(self) -> Dtype:
        return _SCHEME_W[self]

    @property
    def asym_act(self) -> bool:
        return self in (QuantScheme.UINT8_ASYM, QuantScheme.INT8_ASYM,
                        QuantScheme.INT4_ASYM_W_SYM, QuantScheme.INT8_ASYM_W_SYM)

    @property
    def is_block(self) -> bool:
        return self in (QuantScheme.BLOCK_Q2_K, QuantScheme.BLOCK_Q4_0, QuantScheme.BLOCK_Q8_0)


_SCHEME_ACT = {
    QuantScheme.UNSET: Dtype.FLOAT32,
    QuantScheme.INT4_SYM: Dtype.INT4,
    QuantScheme.UINT8_ASYM: Dtype.UINT8,
    QuantScheme.UINT8_SYM: Dtype.UINT8,
    QuantScheme.INT8_ASYM: Dtype.INT8,
    QuantScheme.INT8_SYM: Dtype.INT8,
    QuantScheme.INT16_SYM: Dtype.INT16,
    QuantScheme.FLOAT16: Dtype.FLOAT16,
    QuantScheme.BFLOAT16: Dtype.BFLOAT16,
    QuantScheme.FLOAT32: Dtype.FLOAT32,
    QuantScheme.INT4_ASYM_W_SYM: Dtype.INT4,
    QuantScheme.INT8_ASYM_W_SYM: Dtype.INT8,
    QuantScheme.FLOAT16_W_INT8: Dtype.FLOAT16,
    QuantScheme.BLOCK_Q2_K: Dtype.FLOAT16,
    QuantScheme.BLOCK_Q4_0: Dtype.FLOAT16,
    QuantScheme.BLOCK_Q8_0: Dtype.FLOAT16,
}

_SCHEME_W = {
    **_SCHEME_ACT,
    QuantScheme.INT4_ASYM_W_SYM: Dtype.INT4,
    QuantScheme.INT8_ASYM_W_SYM: Dtype.INT8,
    QuantScheme.FLOAT16_W_INT8: Dtype.INT8,
    QuantScheme.BLOCK_Q4_0: Dtype.INT4,
    QuantScheme.BLOCK_Q8_0: Dtype.INT8,
}


class MemType(enum.Enum):
    """Weight storage formats (ref: csinn_mem_type_enum, csinn_data_structure.h:56-68)."""

    DEFAULT = "default"
    BLOCK_Q2_K = "block_q2_k"
    BLOCK_Q4_0 = "block_q4_0"
    BLOCK_Q8_0 = "block_q8_0"
    BLOCK_Q4_0_REARRANGE = "block_q4_0_rearrange"
    BLOCK_Q8_0_REARRANGE = "block_q8_0_rearrange"


class Layout(enum.Enum):
    """Logical tensor layouts (ref: csinn_layout_enum, csinn_data_structure.h:393-441)."""

    N = "n"
    NC = "nc"
    NCW = "ncw"
    NWC = "nwc"
    NCHW = "nchw"
    NHWC = "nhwc"
    NCDHW = "ncdhw"
    NDHWC = "ndhwc"
    # weight layouts
    OI = "oi"
    OIW = "oiw"
    OWI = "owi"
    OIHW = "oihw"
    OHWI = "ohwi"
    O1HW = "o1hw"    # depthwise NCHW weight
    HWO1 = "1hwo"    # depthwise NHWC weight (ref name "1HWO")


class RunMode(enum.Enum):
    """Execution modes (ref: csinn_rmode_enum, csinn_data_structure.h:118-124)."""

    LAYER = "layer"          # eager per-op execution
    GRAPH = "graph"          # record into the IR, replay the node list (= CPU_GRAPH)
    HYBRID = "hybrid"        # host/device partitioned graph (= CPU_BASE_HYBRID)


class Api(enum.Enum):
    """Backend routing (ref: csinn_api_enum, csinn_data_structure.h:94-115).

    The JAX package's tiers, named for what they are on an H100: TORCH is
    its XLA tier (plain PyTorch ops), CUDA its PALLAS tier (a hand-written
    kernel, kernels/csrc/)."""

    REF = "ref"        # float path with explicit (de)quantize — accuracy oracle
    TORCH = "torch"    # plain PyTorch lowering (the JAX package's Api.XLA)
    CUDA = "cuda"      # hand-written CUDA kernel (the JAX package's Api.PALLAS)
    AUTO = "auto"      # registry choice (the "caps" arbitration analog)


class ProfilerLevel(enum.Enum):
    """(ref: csinn_profiler_enum, csinn_data_structure.h:466-475)."""

    UNSET = 0
    TIMER = 1
    DUMP = 2
    ALL = 3
    TRACE = 4


class DebugLevel(enum.IntEnum):
    """(ref: csinn_debug_enum, csinn_data_structure.h:478-484)."""

    DEBUG = 0
    INFO = 1
    WARNING = 2
    ERROR = 3
    FATAL = 4
