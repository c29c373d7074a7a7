"""The hand-kernel tier of the op API: CUDA callbacks with profitability
predicates, so AUTO dispatch picks them where they win (counterpart of
csinn2_tpu/kernels/autodispatch.py, whose tier is Pallas on a TPU).

(ref: shl_gref_best_callback, source/graph_ref/setup.c:617-652 — prefer the
specialized kernel unless `caps` says the shapes don't qualify.)  The caps
mirror the JAX package's, with "on a TPU" read as "the op runs on a CUDA
device" (the registry passes the session's device in GRAPH mode, the first
input's in layer mode); on the CPU AUTO resolves to the TORCH tier, as the
JAX package resolves to XLA there.

  * SDPA → bhsd `flash_attention` (csrc/attention.cu): for decode over a
    cache (pos_offset or kv_len set) or once sq·sk ≥ 128·512; head dim
    d ≤ 256, as the JAX caps.  It
    passes q_offset = pos_offset, as the Pallas tier does: a causal call
    with sq < sk and neither set lets query i see keys <= i, where the
    TORCH tier offsets the queries by sk - sq (ROADMAP queue C).
  * fullyconnected / matmul with a Q8_0 or Q4_0 block weight → quant_matmul
    on the [N, K] values and [N, K/32] scales with w_transposed (the JAX
    code transposes the weight to [K, N] first; the kernels read [N, K]
    directly), bias added after, an integer out_qinfo requantized as
    clip(round(y · (1/s)) + zp).

Importing this module populates the registry (kernels/__init__ does).
"""

from __future__ import annotations

import torch

from csinn2_tpu_torch.core.dtypes import Api, MemType
from csinn2_tpu_torch.core.quant import quantize
from csinn2_tpu_torch.kernels.flash_attention import flash_attention
from csinn2_tpu_torch.kernels.qmatmul import quant_matmul
from csinn2_tpu_torch.ops.params import SDPAParams
from csinn2_tpu_torch.ops.registry import registry


def _on_cuda(device) -> bool:
    return device is not None and torch.device(device).type == "cuda"


# --- flash attention as the CUDA sdpa callback ------------------------------

def _sdpa_caps(metas, params, device=None) -> bool:
    if not _on_cuda(device) or metas is None or len(metas) < 3:
        return False
    sq = metas[0].shape[-2]
    sk = metas[1].shape[-2]
    if metas[0].shape[-1] > 256:
        return False
    if params is not None and (getattr(params, "kv_len", 0)
                               or getattr(params, "pos_offset", 0)):
        # decode over a static, partially filled cache: the kernel's kv_len
        # mask skips the dead keys whatever the total size
        return True
    return sq * sk >= 128 * 512


def _sdpa_cuda(q, k, v, params: SDPAParams):
    scale = params.norm_factor if params.norm_factor else None
    kv_len = params.kv_len or None                 # 0 → all of sk
    return flash_attention(q.to(torch.bfloat16).contiguous(),
                           k.to(torch.bfloat16).contiguous(),
                           v.to(torch.bfloat16).contiguous(),
                           causal=params.causal, q_offset=params.pos_offset,
                           kv_len=kv_len, scale=scale).float()


registry.register("scaled_dot_product_attention", _sdpa_cuda, api=Api.CUDA,
                  caps=_sdpa_caps)


# --- block-quant GEMM as the CUDA matmul / fc callback -----------------------

_BLOCK = (MemType.BLOCK_Q4_0, MemType.BLOCK_Q8_0,
          MemType.BLOCK_Q4_0_REARRANGE, MemType.BLOCK_Q8_0_REARRANGE)


def _block_caps(metas, params, device=None) -> bool:
    return (_on_cuda(device) and metas is not None and len(metas) >= 2
            and metas[1].mem_type in _BLOCK)


def _block_matmul(arrays, metas, params, out_qinfo, **extra):
    """x float [..., K]; the weight a (values [N, K] int8, scales [N, K/32]
    f32) pair; optional bias [N].  y = x · dequant(w)ᵀ in f32 (ref:
    shl_c920_matmul_a0b1_fp16_block_quant, matmul_fp16.c:304-347)."""
    x = arrays[0]
    values, scales = arrays[1]
    bias = arrays[2] if len(arrays) > 2 and arrays[2] is not None else None
    lead, K = x.shape[:-1], x.shape[-1]
    y = quant_matmul(x.reshape(-1, K).to(torch.bfloat16).contiguous(), values,
                     scales.float(), scale_mode="block", w_transposed=True)
    y = y.reshape(*lead, values.shape[0])
    if bias is not None:
        y = y + bias.to(y.dtype)
    if out_qinfo is not None and not out_qinfo.dtype.is_float:
        return quantize(y, out_qinfo, by_reciprocal=True)
    return y


for _op in ("matmul", "fullyconnected"):
    registry.register(_op, _block_matmul, api=Api.CUDA, caps=_block_caps, quant_direct=True)
