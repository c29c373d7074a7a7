#!/usr/bin/env python3
"""Smoke run of csinn2_tpu_torch, the PyTorch/CUDA port, on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and continued):
  1. the card (nvidia-smi name and power limit), torch/CUDA versions, and the
     build of every CUDA kernel from csinn2_tpu_torch/kernels/csrc/;
  2. each kernel held against its plain PyTorch version on the card at
     Llama-2-7B shapes, timed (median GPU time of back-to-back calls queued
     behind a sleep kernel, CUDA events) beside the plain version and one
     library call (a yardstick only): the GEMM launch plan's Python mirror
     against the library's workspace size at every 7B projection; then
     quant_matmul in every weight mode (Q8_0, Q4_0, INT8_CHANNEL,
     INT4_CHANNEL, and the swiglu epilogue on a Q8_0 and a Q4_0 w13 in the
     swiglu128 layout) at M = 1, 4, 8, 16 and 128 on wqkv, wo, w13, w2 and
     lm_head, the decode rows (M <= 16) also cold (utils/timing.gpu_ms_cold
     over weight copies beyond twice the L2, beside torch.matmul cold), and
     the Q8_0 and Q4_0 w13 also at the long prompts' prefill buckets M = 512
     and 2048; the attention
     kernels (the split-KV decode_attention, also timed cold over KV copies
     beyond twice the L2 beside SDPA cold; the tensor-core attn_fwd_kernel
     at prefill and, split over the KV window, at flash decode, its decode
     also cold), the batched decode's attention prologue (decode_prologue:
     RoPE, K/V quantisation, the row store) at 16 lanes, GQA 32/8 and MHA
     32/32, bit for bit against its plain version and timed beside it,
     then every attention entry point at head
     dims 16, 32, 80, 96 and 256 with an f32 and a bf16 q, int8 and bf16 KV;
     then the head dims above 256 (attn_wide_mma_kernel, on wgmma): the
     four entry points at d = 320 and 576, int8 and bf16 KV, driven once
     each with the launch counts zeroed before and read after (their path:
     a launch a call, a merge for each split-KV decode), each held against
     its plain version, the kv_len = 0 row 0, and flash bhsd and decode at
     both d timed beside SDPA on the dequantized K/V;
  3. model parity: a 2-layer model at full 7B width (int8 KV) over a
     128-token prompt, logits on the card against the same model through the
     port's plain path on the CPU (cosine >= 0.999), for Q8_0, Q4_0,
     INT8_CHANNEL, INT4_CHANNEL and Q4_0 with CSINN2_SWIGLU_FUSE=1;
  4. the first slice's main path: Llama-2-7B geometry (32 layers), Q8_0
     weights made on the card from a seed, int8 KV,
     InferenceEngine(batch=4).run_queue over six greedy requests (prompts
     5..1100 tokens, 16 new tokens each), its prefills through the prompt
     buckets' captured prefill graphs (a replay a request, a capture a
     bucket) and its decode chunks through the
     engine's captured decode-step graph, with the kernel launch counts of
     that run (the graphs' tallies, one replay a step: each kernel's
     launches a step those of the eager step, one capture a key) and its
     tokens equal to a rerun of the same requests through the eager prefill
     and the eager loop (_prefill_eager, _decode_steps_eager); then TTFT at
     prompts 128 and 1100 (CUDA events around prefill_sample, beside the
     eager prefill, and the device's prefill alone by
     benchmark_prefill_device), one seeded sampled chunk (per-row
     temperatures, top-k, top-p) through the graph equal to the eager
     loop's, decode tokens/s at batch 4 through the graph beside the eager
     loop (in turns, CUDA events) and by benchmark_decode_device at batch 4
     and 1, with the qmm_reduce launches per eager decode step (the
     libraries' own count; the decode GEMM finishes its splits in one
     launch); then the engine at LlamaConfig.tiny() (head dim 16, GQA 4/2)
     on the card, logits against the same engine on the CPU (cosine
     >= 0.999);
  5. this slice's main path: the same with Q4_0 weights;
  6. the paths of the other weight modes, each the same run at full width
     and depth: INT8_CHANNEL, INT4_CHANNEL, and Q4_0 with the swiglu128
     fusion (CSINN2_SWIGLU_FUSE=1);
  7. the CNN path: MobileNetV1 (alpha 1.0, 224x224, 1000 classes, seed 0)
     calibrated on the card on one seeded image, INT8_SYM graph sessions at
     batch 128 and 1 with CSINN2_FUSE_DS=1 (13 ds_block nodes, the
     fused_dsconv CUDA kernel) and without; the fused session's forward at
     batch 128 is the main path whose launches are counted (13 expected);
     fused logits equal to unfused ones bit for bit (batch 128 and 1), to
     the port's CPU plain path within the fc's 1 LSB (batch 1), cosine
     >= 0.99 against forward_f32 (bench.py's gate); img/s at batch 128 and
     batch-1 latency, fused and unfused (CUDA events), and the fused_dsconv
     launches over those runs; each of the 13 block shapes of fused_dsconv
     against fused_dsconv_ref (bit for bit), timed beside its bound, the
     plain version and the unfused pair, and their sum against the summed
     bound.
  8. the op API's CUDA tier (kernels/autodispatch.py) at Llama-2-7B width:
     ops.fullyconnected on Q8_0 and Q4_0 block tensors of one layer's four
     projections (wqkv, wo, w13, w2; made on the card from a seed) at M = 128
     and 4, and ops.scaled_dot_product_attention at prefill [1, 32, 2048, 128]
     and decode [4, 32, 1, 128] over S = 2048, recorded into a GRAPH
     Session(device="cuda") with Api.AUTO and run in layer mode; every node
     on the CUDA tier (quant_matmul_t, flash_attention_bhsd), outputs against
     an Api.TORCH session on the card (fc cosine >= 0.9999, SDPA
     verify(tol=2e-2, min_cosine=0.9999)), an int8 out_qinfo within 1 LSB;
  9. (none: the number is left free so that phases 10-18 keep the
     numbers the documents cite);
 10. the probe path: the port's Q4_0 dequant-strategy probe
     (csinn2_tpu_torch.examples.int4_dequant_probe, the eleven kernels of
     kernels/int4_probe.py beside cur(quant_matmul), every one on the decode
     GEMM's tensor-core skeleton: the eight bf16 plane kinds, intdot and
     w4a8 on int8 tensor cores, stream the ring's copies alone) at the four Llama-2-7B
     decode shapes (wqkv, w13, w2, wo; M = 8), every variant timed cold
     (rotating over weight copies that exceed twice the L2) and no row
     above 105 % of its own bytes bound; then each kernel held against its
     plain version on the card at every shape (stream bit for bit, the
     others within 1e-5·max|y|), timed beside the plain version and
     torch.matmul on the dequantized bf16 weight (cold), with its factor
     over cur and over torch.matmul; then the tile tuner's split-length
     sweep of the andmask kernel at the four shapes;
 11. the port's LLM examples as a user runs them, each in a process of its
     own: csinn2_tpu_torch/examples/llama_generate.py --mode q8_0 --quant-kv
     (2 layers, dim 256: generate, decode tokens/s host-stepped and through
     the step graph, the Q8_0-vs-float logit cosine gate) and
     llama7b_bench.py --mode q4_0 --layers 32 (TTFT, decode tokens/s at
     batch 1 through the step graph, the weight-read bound); each must exit
     0 and print PASS;
 12. mixture of experts at Mixtral-8x7B width (dim 4096, GQA 32/8, ffn
     14336, E = 8, top-2, vocab 32000, rope_base 1e6; max_seq_len cut to
     2048), experts on quant_matmul: first quant_matmul at one expert's
     shapes (w1/w3 K 4096 N 14336, w2 K 14336 N 4096) in Q8_0 and Q4_0 at M
     = 1, 4 (cold) and 256 against its plain version, timed beside its
     bound and torch.matmul; then 2 layers in Q8_0 and Q4_0 (int8 KV),
     llama_forward's logits on the card against the CPU plain path (cosine
     >= 0.999) at a 128-token prompt (dense), a 512-token prompt (routed by
     "auto") and 512 under moe_dispatch="dense", each forward's
     quant_matmul launches counted against layers x (4 + 3E) + 1; then all
     32 layers in Q4_0 made on the card: a 512-token prefill and 16 greedy
     decode steps through llama_forward at s = 1, timed by CUDA events,
     beside the decode step's bytes bound (dense decode reads every
     expert), launches counted; then
     csinn2_tpu_torch/examples/moe_dispatch_probe.py in a process of its
     own (dense vs routed at T = 8-512, bf16 experts, then Q4_0 ones),
     which must exit 0;
 13. the LLM weight I/O: a 2-layer GGUF at Llama-2-7B width written by the
     port (seeded; Q8_0 linears, one Q4_0 and one F16 linear, an F16
     embedding, a 32000-piece vocabulary), converted by `python -m
     csinn2_tpu_torch convert --mode q8_0` in a process of its own,
     load_llm(device="cuda") (write, convert and load times, host clock,
     and the load's GB/s), its logits against the float forward on the
     pre-conversion weights (cosine >= 0.999, bench.py's real-weights
     gate) with the forward's quant_matmul launches counted, then
     llama_generate.py --ckpt on the directory, which must exit 0 and print
     PASS.  Its files live in _smoke/ under the checkout and are removed.
 14. tensor, data and expert parallelism (csinn2_tpu_torch/parallel/), its
     ranks spawned after phase 1's build (no rank builds a kernel) and
     sharing the one card over gloo, whose collectives are staged through
     the host (NCCL refuses two ranks on a device): (a) quant_matmul at a
     rank's GEMM shapes under tp = 2 (Llama-2-7B wqkv, wo, w13, w2 with K
     5504, lm_head; a Mixtral-8x7B expert's w1/w3 and w2 under tp = 2 x ep =
     2) in Q8_0 and Q4_0 at M = 1, 4 (cold), 128 and 2048, and the three
     attention kernels at 16 heads, each against its plain version, timed
     beside its bound and torch.matmul / SDPA; (b) tp = 2: two ranks each
     make phase 4's Q8_0 Llama-2-7B (32 layers) on the card from its seed,
     keep their shard (InferenceEngine(batch=4, mesh=...)), run_queue over
     phase 4's six requests: tokens identical on both ranks, the logits of
     a 128-token prefill and of the first decode step against phase 4's
     single-process engine (cosine >= 0.999), the share of tokens equal to
     phase 4's, each rank's launches, the collectives a decode step and one
     all_reduce's host-clock time (gloo's staging, not a TP speed); (c) tp =
     2 x dp = 2 on four ranks, 7B width, 4 layers, Q4_0, requests in both dp
     groups, against a single-process engine of the same model; (d) EP at
     Mixtral-8x7B width (2 layers): ep = 2 on two ranks, then tp = 2 x ep = 2
     on four, Q8_0 and Q4_0, the logits of a 128-token prompt and of one
     decode step against the single-process llama_forward (cosine >=
     0.999); (e) csinn2_tpu_torch/examples/multihost_dryrun.py --device cuda
     in a process of its own (must print PASS); (f) with two cards or more,
     (b) again over NCCL, one card a rank, through the step graph, tokens
     equal to (b)'s — with one card it logs "NCCL path: not run" and the
     kernels line's "mesh" record says so.
 15. context and pipeline parallelism (parallel/cp.py, parallel/pp.py),
     ranks sharing the card over gloo, whose point-to-point sends are copied
     through host buffers: (a) ring attention at Llama-2-7B's attention
     width (b 1, 32 heads, d 128) on four ranks (cp = 2 as two rings, cp =
     4 as one): S = 4096 in f32 and bf16, causal and not, and S = 16384 at
     cp = 4, bf16, causal, each gathered output against
     ring_attention_reference in this process (rtol = atol = 2e-5 in f32,
     0.05 in bf16), the host time a call, 2 (cp - 1) K/V shifts a rank a
     call, one hop of a [1, 32, 2048, 128] bf16 block timed alone; (b) pp =
     2 at Llama-2-7B Q8_0, all 32 layers, int8 KV, batch 4 of 128-token
     prompts then 8 greedy decode steps fed the one-process run's tokens:
     PipelinedLlama with both stages on cuda:0 and SPMDPipelinedLlama on two
     ranks, at 1 and 2 microbatches, logits and every layer's K/V rows bit
     for bit against llama_forward (the batch whole at 1 microbatch; at 2,
     microbatch by microbatch, the SPMD head over the whole batch), each
     rank's p2p.pp sends, ticks, launches and an eager step's host time;
     (c) pp = 2 x tp = 2 on four ranks, 7B width, 4 layers, Q4_0, 2
     microbatches: logits and each rank's K/V block against one process
     (cosine >= 0.999); (d) pp x MoE: PipelinedLlama, 2 stages at
     Mixtral-8x7B width (2 layers, Q4_0), a 128-token prompt, against
     llama_forward (cosine >= 0.999).
 16. the rest of the CNN zoo through the graph session at bench.py's sizes
     (224, 1000 classes), each model seeded 0 and calibrated on the card on
     one rng.random image (bench.py:168-176): (a) MobileNetV2 UINT8_ASYM,
     MobileNetV3 INT8_SYM and ResNet-50 INT8_SYM sessions at batch 128 and
     1: the dequantized batch-1 logits (the session's own output qinfo)
     against forward_f32, cosine >= 0.99 (bench.py:151-165); batch 1 on the
     card against the port's CPU plain path with the same recorder, within
     the fc's 1 LSB; img/s at batch 128 and batch-1 latency
     (run_benchmark_device); (b) ResNet-50 NCHW against NHWC at batch 1,
     seed 5: forward_f32 within verify(tol=1e-3) (tests/test_models.py:79-88)
     and the INT8_SYM logits on one recorder bit for bit; (c) MobileNetV2
     and MobileNetV3 INT8_SYM with CSINN2_FUSE_DS=1: 7 and 1 ds_block nodes
     (the residual and hardswish pairs stay unfused), the fused forward at
     batch 128 (its launches counted: 7 and 1 fused_dsconv) and at batch 1
     equal to the unfused one bit for bit, and each block's fused_dsconv
     against fused_dsconv_ref and the unfused pair, bit for bit, timed
     beside its bound.  The kernels line carries (a)-(b) under "cnn_zoo"
     and (c)'s blocks under fused_dsconv's "zoo".
 17. the streaming-ASR path and the op zoo: (a) DFSMN at the width of
     examples/dfsmn_stream.py (feat 80, hidden 512, proj 256, 6 blocks,
     l_order 10, r_order 2, 218 classes, seed 0) through GRAPH sessions on
     the card: offline over [1, 256, 80] and streamed in chunks of 8, the
     streamed logits against the offline ones on the interior frames
     (cosine > 0.9999, max |d| < 1e-3), both against the port's CPU plain
     path (rtol = atol = 2e-4); the steady-state chunk latency and frames/s
     by run_benchmark_device at batch 1 and at 64 concurrent streams, the
     peak device memory (utils/memstats.device_memory_stats), then
     `python3 -m csinn2_tpu_torch.examples.dfsmn_stream` in a process of its
     own, which must print PASS; (b) every case of
     csinn2_tpu_torch/examples/op_zoo.py recorded into a GRAPH session on the
     card and held against the same call on the CPU plain path (integer,
     boolean and tolerance-0 outputs bit for bit).  No CUDA kernel of the
     port lies on this path (plain PyTorch ops, as the JAX package's XLA
     ops); the kernels line carries the phase under "dfsmn" and "op_zoo".
 18. the rest of the runtime: (a) phase 8's op-API graph at Llama-2-7B
     width (Q8_0 block weights made on the card, M = 128) with wo under
     device_scope("host") and w13 fed by its output, as a RunMode.HYBRID
     session: three subgraphs (accel, host, accel) logged with their nodes
     and the bytes moved across, quant_matmul_t launched by the accel
     subgraphs only (each subgraph run alone with the counts zeroed), the
     outputs against the same graph in a GRAPH session on the card (cosine
     >= 0.9999, phase 8's gate), one run's time beside the GRAPH session's;
     (b) MobileNetV1 INT8_SYM at 224, batch 128, CSINN2_FUSE_DS=1 (13
     ds_block nodes): save_model with and without the placed constants,
     each directory load_model()ed in a fresh process, which must give the
     logits bit for bit with 13 fused_dsconv launches; export_json parsed;
     run_layer_benchmark's ten slowest nodes, their sum against the whole
     forward (run_benchmark_device) and the 13 blocks' share;
     roofline.analyze's fused and unfused bounds beside the forward; every
     node's output dumped, the last file equal to the output; (c) in a
     process of its own (torch.profiler's after-effect on launches stays
     there): device_trace around one fused forward of the saved model, its
     top five kernels by device time, dsconv_kernel among them, then
     `python3 -m csinn2_tpu_torch.examples.mobilenet_int8 --size 224` and
     `deploy_save_load --size 224 --aot` (CSINN2_FUSE_DS=1), each must
     print PASS; (d) runtime/dataloader.py's DataLoader over an archive of
     256 seeded 224x224x3 f32 samples (154 MB, in a temporary directory)
     feeding (b)'s session: img/s beside the resident input's, the first
     batch's logits equal to (b)'s; (e) `python3 -m csinn2_tpu_torch
     --backend` must print the card.  The kernels line carries the phase
     under "runtime", quant_matmul_t's HYBRID launches as
     "launches_hybrid" and fused_dsconv's (b) launches as
     "launches_runtime".
Phase 2 also holds the fourth slice's kernel modes (int8 x with float and
integer epilogues, the fixed-point requantize bit for bit, scale_mode
"none", the transposed weights, bhsd flash_attention) against their plain
versions at 7B shapes, then times the int8-x GEMM (row 1d) cold at w13, M
= 1-2048, in the float and requantize epilogues beside its bound and
torch._int_mm's faster operand layout; the modes without a package caller
(rows 1b' and 1d, the int8-x swiglu) are then driven once each through
quant_matmul, which is their path.
Each path's run zeroes the launch counts just before it and reads them just
after.  No phase uses torch.profiler: once it has traced,
host-side launches stay slower for the rest of the process, which would skew
the serving phases.  The last two lines are the kernels' JSON record and the
run's JSON result; the kernels line also carries phase 14's summary under "mesh",
phase 15's under "pipeline", and phase 15's launches of quant_matmul,
quant_matmul_q4_0 and the attention entries under "launches_pp".
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
BF16_FLOPS = 989e12            # H100 SXM dense bf16 tensor-core peak
INT8_OPS = 1979e12             # H100 SXM dense int8 tensor-core peak

QMM_SOURCE = "csinn2_tpu_torch/kernels/csrc/qmatmul.cuh"
QMM_REPLACES = "csinn2_tpu/kernels/qmatmul.py:287"
ATTN_SOURCE = "csinn2_tpu_torch/kernels/csrc/attention.cu"
I8_SOURCE = "csinn2_tpu_torch/kernels/csrc/qmatmul_int8dot.cu"
# kernel name (launch_counts key without its .decode/.prefill suffix) →
# (source, TPU function replaced)
KERNELS = {
    "quant_matmul": (QMM_SOURCE, QMM_REPLACES),
    "quant_matmul_q4_0": (QMM_SOURCE, QMM_REPLACES),
    "quant_matmul_channel": (QMM_SOURCE, QMM_REPLACES),
    "quant_matmul_int4_channel": (QMM_SOURCE, QMM_REPLACES),
    "quant_matmul_swiglu": (QMM_SOURCE, QMM_REPLACES),
    "decode_attention": (ATTN_SOURCE, "csinn2_tpu/kernels/flash_attention.py:142"),
    "prefill_attention": (ATTN_SOURCE, "csinn2_tpu/kernels/flash_attention.py:248"),
    "flash_attention": (ATTN_SOURCE, "csinn2_tpu/kernels/flash_attention.py:312"),
    "fused_dsconv": ("csinn2_tpu_torch/kernels/csrc/dsblock.cu",
                     "csinn2_tpu/kernels/dsblock.py:164"),
    "quant_matmul_none": (QMM_SOURCE, QMM_REPLACES),
    "quant_matmul_int8dot": (I8_SOURCE, QMM_REPLACES),
    "quant_matmul_requant": (I8_SOURCE, "csinn2_tpu/kernels/requant.py:40"),
    "quant_matmul_t": (QMM_SOURCE, QMM_REPLACES),
    "flash_attention_bhsd": (ATTN_SOURCE, "csinn2_tpu/kernels/flash_attention.py:312"),
    # attn_wide_mma_kernel: d > 256 in all three functions (also :142
    # decode_attention, :248 prefill_attention)
    "attention_wide": (ATTN_SOURCE, "csinn2_tpu/kernels/flash_attention.py:312"),
    # the batched decode's RoPE, K/V quantisation and row store, which the
    # JAX engine leaves to XLA (csinn2_tpu/llm/engine.py, no Pallas kernel)
    "decode_prologue": ("csinn2_tpu_torch/kernels/csrc/decode_prologue.cu", "none"),
}
# the probe kernels: kind → (line of the JAX body or pallas_call function in
# examples/int4_dequant_probe.py, the probe's variant name)
PROBE_KERNELS = {"split_i32": (91, "split_i32"), "split_i8": (91, "split_i8"),
                 "i4native": (141, "i4native"), "bitcast": (173, "bitcast"),
                 "andmask": (234, "andmask"), "andmask_bf16s": (395, "andmask_bf16s"),
                 "stream": (294, "stream"), "intdot": (327, "intdot"), "w4a8": (530, "w4a8"),
                 "noscale": (440, "noscale(timing)"), "halfq8": (460, "halfq8(timing)")}
for _kind, (_line, _) in PROBE_KERNELS.items():
    KERNELS[f"int4_probe_{_kind}"] = ("csinn2_tpu_torch/kernels/csrc/int4_probe.cu",
                                      f"examples/int4_dequant_probe.py:{_line}")
ATTENTION = ("decode_attention", "prefill_attention", "flash_attention")
# weight mode → (scale_mode, packed_int4) of its quant_matmul calls
QMM_MODES = {"q8_0": ("block", False), "q4_0": ("block", True),
             "int8": ("channel", False), "int4": ("channel", True)}
PROMPTS = (5, 37, 128, 300, 700, 1100)
CNN_BATCH = 128                # bench.py:51


def log(msg: str) -> None:
    print(msg, flush=True)


def bound(nbytes: float, flops: float, peak: float = BF16_FLOPS):
    t_b, t_f = nbytes / HBM_BYTES_PER_S, flops / peak
    return max(t_b, t_f) * 1e3, ("bytes" if t_b >= t_f else "operations")


def launches(counts, name: str) -> int:
    """Launches of kernel `name` in a launch_counts snapshot (all variants)."""
    return sum(n for k, n in counts.items() if k.split(".")[0] == name)


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def _qmm_weights(g, mode: str, K: int, N: int):
    """Random carriers over the mode's full range (-128 / -8 included), f16-
    rounded scales, and a bf16 dequantized copy for the library yardstick."""
    import torch
    from csinn2_tpu_torch.kernels.qmatmul import pack_int4
    scale_mode, packed = QMM_MODES[mode]
    lo, hi = (-8, 8) if packed else ((-128, 128) if scale_mode == "channel" else (-127, 128))
    q = torch.randint(lo, hi, (K, N), generator=g, device="cuda", dtype=torch.int8)
    if scale_mode == "block":
        s = (torch.rand((K // 32, N), generator=g, device="cuda") * 2e-4 + 1e-5) \
            .to(torch.float16).float()
        w_deq = (q.float().reshape(K // 32, 32, N) * s[:, None]).reshape(K, N)
    else:
        s = torch.rand((N,), generator=g, device="cuda") * 2e-4 + 1e-5
        w_deq = q.float() * s
    return (pack_int4(q) if packed else q), s, w_deq.to(torch.bfloat16)


def _gemm_cold(x, w, s, w_deq, run):
    """Cold times (utils/timing.gpu_ms_cold) of a GEMM call run(w, s) and of
    torch.matmul(x, w_deq), each over copies of its weight whose total
    exceeds twice the L2."""
    import torch
    from csinn2_tpu_torch.utils.timing import cold_copies, gpu_ms_cold, l2_bytes
    n = cold_copies(w.numel() + (0 if s is None else s.numel() * 4), l2_bytes())
    copies = [(w, s)] + [(w.clone(), None if s is None else s.clone()) for _ in range(n - 1)]
    ms = gpu_ms_cold([lambda c=c: run(*c) for c in copies])
    del copies
    deqs = [w_deq] + [w_deq.clone()
                      for _ in range(cold_copies(w_deq.numel() * 2, l2_bytes()) - 1)]
    lib = gpu_ms_cold([lambda d=d: torch.matmul(x, d) for d in deqs])
    return ms, lib


DECODE_MS = (1, 4, 8, 16)


def _check_qmm_case(records, key, label, g, mode, K, N, odt, swiglu=False, record_m=4,
                    ms_list=DECODE_MS + (128,)):
    import torch
    from csinn2_tpu_torch.kernels.qmatmul import quant_matmul, quant_matmul_ref
    from csinn2_tpu_torch.utils.timing import gpu_ms
    from csinn2_tpu_torch.utils.verify import cosine_similarity
    scale_mode, packed = QMM_MODES[mode]
    kw = dict(scale_mode=scale_mode, packed_int4=packed, swiglu=swiglu, out_dtype=odt)
    w, s, w_deq = _qmm_weights(g, mode, K, N)
    worst = records.get(key, {}).get("max_abs_err", 0.0)
    for M in ms_list:
        x = torch.randn((M, K), generator=g, device="cuda").to(torch.bfloat16)
        y = quant_matmul(x, w, s, **kw)
        torch.cuda.synchronize()
        ref = quant_matmul_ref(x, w, s, **kw)
        yf, rf = y.float().cpu().numpy(), ref.float().cpu().numpy()
        err = float(abs(yf - rf).max())
        cos = cosine_similarity(yf, rf)
        rel = err / float(abs(rf).max())
        if not (cos >= 0.9999 and rel <= 1e-2):
            raise AssertionError(f"{key} {label} M={M}: cos={cos} max|d|/max|y|={rel}")
        worst = max(worst, err)
        ms = gpu_ms(lambda: quant_matmul(x, w, s, **kw))
        plain = gpu_ms(lambda: quant_matmul_ref(x, w, s, **kw), reps=3)
        lib = gpu_ms(lambda: torch.matmul(x, w_deq))
        osz = torch.empty((), dtype=odt).element_size()
        n_out = N // 2 if swiglu else N
        b_ms, b_by = bound(M * K * 2 + w.numel() + s.numel() * 4 + M * n_out * osz,
                           2.0 * M * N * K)
        cold = ""
        if M <= 16:                            # the decode kernel, cold
            ms_cold, lib_cold = _gemm_cold(x, w, s, w_deq,
                                           lambda wc, sc: quant_matmul(x, wc, sc, **kw))
            cold = (f" cold: ms={ms_cold:.4f} lib_ms={lib_cold:.4f} "
                    f"roofline={b_ms / ms_cold:.3f}")
        log(f"  {key} {label:7s} M={M:4d} K={K:5d} N={N:5d} ms={ms:.4f} plain_ms={plain:.4f} "
            f"lib_ms={lib:.4f} bound_ms={b_ms:.4f} ({b_by}) roofline={b_ms / ms:.3f} "
            f"cos={cos:.6f} max_abs_err={err:.3e}{cold}")
        if record_m is not None and M <= 16:  # the decode kernel at the recorded shape
            records.setdefault(key, {}).setdefault("decode_cold", {})[f"M={M}"] = dict(
                ms=ms_cold, library_ms=lib_cold, bound_ms=b_ms)
        if M == record_m:
            records.setdefault(key, {}).update(
                ms=ms, plain_ms=plain, library_ms=lib, bound_ms=b_ms, bound_by=b_by,
                ms_cold=ms_cold, library_ms_cold=lib_cold,
                shape=f"{label} M={M} K={K} N={N} {'bf16' if osz == 2 else 'f32'} out")
        if record_m is not None and M > 16:   # the prefill kernel at the recorded shape
            records.setdefault(key, {}).setdefault("prefill", {})[f"M={M}"] = dict(
                ms=ms, library_ms=lib, bound_ms=b_ms, bound_by=b_by)
    records.setdefault(key, {})["max_abs_err"] = worst
    del w, s, w_deq


def check_quant_matmul(records):
    """Every weight mode at the 7B shapes (M = 1, 4, 8, 16, 128); the record
    of each mode is the batch-4 decode FFN GEMM, w13 at M = 4, with the
    decode rows cold at M <= 16."""
    import torch
    from csinn2_tpu_torch.kernels.qmatmul import launch_key
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    shapes = [("wqkv", 4096, 12288, torch.bfloat16), ("wo", 4096, 4096, torch.bfloat16),
              ("w13", 4096, 22016, torch.bfloat16), ("w2", 11008, 4096, torch.bfloat16),
              ("lm_head", 4096, 32000, torch.float32)]
    for mode, (scale_mode, packed) in QMM_MODES.items():
        key = launch_key(scale_mode, packed, swiglu=False)
        for label, K, N, odt in shapes:
            # the prefill buckets of a long prompt (512, 2048 rows) on the Q8_0 and Q4_0 w13
            long = label == "w13" and scale_mode == "block"
            _check_qmm_case(records, key, label, g, mode, K, N, odt,
                            record_m=4 if label == "w13" else None,
                            ms_list=DECODE_MS + ((128, 512, 2048) if long else (128,)))
    # the swiglu epilogue on a w13 in the swiglu128 layout (F 11008 padded to
    # 11264): N = 22528 → out [M, 11264]; recorded for Q4_0
    for mode in ("q8_0", "q4_0"):
        _check_qmm_case(records, "quant_matmul_swiglu", f"w13sw-{mode}", g, mode, 4096, 22528,
                        torch.bfloat16, swiglu=True, record_m=4 if mode == "q4_0" else None)


def check_gemm_plan():
    """kernels/qmatmul.py's mirror of the GEMM launch plan (workspace floats)
    against the CUDA library's own number at every Llama-2-7B projection,
    M 1-2048, with and without the reduce (the plan is the same for both
    weight layouts)."""
    import torch
    from csinn2_tpu_torch.kernels import qmatmul as tq
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    n = 0
    for K, N in ((4096, 12288), (4096, 4096), (4096, 22016), (4096, 22528), (11008, 4096),
                 (4096, 32000)) + tuple((K, N) for _, K, N, _ in SHARD_SHAPES):
        for M in (1, 2, 4, 8, 16, 17, 32, 64, 128, 512, 1024, 2048):
            for swiglu, reduce_epi in ((False, False), (True, False), (False, True)):
                want = tq.kernel_workspace_floats(M, N, K, swiglu, reduce_epi, 0)
                got = tq.workspace_floats(M, N, K, swiglu, reduce_epi, n_sm)
                if got != want:
                    raise AssertionError(f"GEMM plan mirror M={M} K={K} N={N}: {got} floats, "
                                         f"the library {want}")
                n += 1
    log(f"  GEMM plan mirror = library workspace at {n} 7B and tp-shard cases; w13 M=128: "
        f"{tq.gemm_plan(128, 22016, 4096, False, n_sm)}")
    n = 0
    for K, N in ((4096, 12288), (4096, 4096), (4096, 22016), (11008, 4096), (4096, 32000)):
        for M in (1, 4, 8, 16, 17, 128, 512, 2048):
            want = tq.kernel_int8dot_plan(M, N, K, 0)
            got = tq.int8dot_plan(M, N, K, n_sm)
            if {k: got[k] for k in want} != want:
                raise AssertionError(f"int8-x GEMM plan mirror M={M} K={K} N={N}: {got}, "
                                     f"the library {want}")
            n += 1
    log(f"  int8-x GEMM plan mirror = library at {n} 7B cases; w13 M=128: "
        f"{tq.int8dot_plan(128, 22016, 4096, n_sm)}")


def _kv_case(g, b, hk, S, d, scale):
    """int8 K/V in the cache's [b, S, hk, d] layout, seen as [b, hk, S, d]."""
    import torch
    k = torch.randint(-127, 128, (b, S, hk, d), generator=g, device="cuda", dtype=torch.int8)
    v = torch.randint(-127, 128, (b, S, hk, d), generator=g, device="cuda", dtype=torch.int8)
    return k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3)


def _verify_attn(name, out, ref):
    from csinn2_tpu_torch.utils.verify import verify
    r = verify(out.float().cpu().numpy(), ref.float().cpu().numpy(), tol=2e-2,
               min_cosine=0.9999)
    if not (r.passed and r.cosine_sim >= 0.9999):
        raise AssertionError(f"{name}: {r}")
    return r


def _decode_cold(g, b, hk, S, d, kv_scale, run, lib):
    """Cold times (utils/timing.gpu_ms_cold) of a decode attention call
    `run(k, v)` and of its library call `lib(kd, vd)` on dequantized bf16
    K/V, each over copies of the cache whose total exceeds twice the L2."""
    import torch
    from csinn2_tpu_torch.utils.timing import cold_copies, gpu_ms_cold, l2_bytes
    caches = [_kv_case(g, b, hk, S, d, kv_scale)
              for _ in range(cold_copies(2 * b * S * hk * d, l2_bytes()))]
    ms = gpu_ms_cold([lambda c=c: run(*c) for c in caches])
    deq = [tuple((t.float() * kv_scale).to(torch.bfloat16) for t in c)
           for c in caches[:cold_copies(4 * b * S * hk * d, l2_bytes())]]
    lib_ms = gpu_ms_cold([lambda c=c: lib(*c) for c in deq])
    return ms, lib_ms


def check_attention(records, heads: int = 32, tag: str = None):
    """The three attention kernels at Llama-2-7B's head dim over `heads`
    query and KV heads (16: a rank's under tp = 2).  tag: the records go
    under records[name][tag][shape] (the tp-shard rows of phase 14), not
    over the kernel's own record."""
    import torch
    import torch.nn.functional as F
    from csinn2_tpu_torch.kernels import flash_attention as fa
    from csinn2_tpu_torch.utils.timing import gpu_ms
    g = torch.Generator(device="cuda")
    g.manual_seed(1)
    hq = hk = heads
    d, kv_scale = 128, 0.05          # the engine's default int8 KV scale
    sm = 1.0 / math.sqrt(d)

    def put(name, rec):
        if tag is None:
            records[name] = rec
        else:
            records.setdefault(name, {}).setdefault(tag, {})[rec["shape"]] = rec

    # decode: b=4, one lane with kv_len = 0 (an inactive continuous-batching slot)
    worst = 0.0
    for S in (256, 2048):
        b = 4
        k, v = _kv_case(g, b, hk, S, d, kv_scale)
        q = torch.randn((b, hq, 1, d), generator=g, device="cuda").to(torch.bfloat16)
        kv_len = torch.tensor([S, S // 2 + 3, 0, 17], dtype=torch.int32, device="cuda")
        pos = kv_len - 1
        run = lambda: fa.decode_attention(q, k, v, q_offset=pos, kv_len=kv_len,
                                          kv_scale=kv_scale)
        out = run()
        torch.cuda.synchronize()
        ref = fa._attention_ref(q, k, v, causal=False, q_offset=pos, kv_len=kv_len,
                                scale=sm, kv_scale=kv_scale).to(torch.bfloat16)
        r = _verify_attn(f"decode_attention S={S}", out, ref)
        if not bool(torch.isfinite(out).all()) or float(out[2].abs().max()) != 0.0:
            raise AssertionError("decode_attention: kv_len=0 lane must output 0")
        worst = max(worst, r.max_abs_err)
        ms = gpu_ms(run)
        plain = gpu_ms(lambda: fa._attention_ref(q, k, v, causal=False, q_offset=pos,
                                                    kv_len=kv_len, scale=sm,
                                                    kv_scale=kv_scale), reps=5)
        kd = (k.float() * kv_scale).to(torch.bfloat16)
        vd = (v.float() * kv_scale).to(torch.bfloat16)
        mask = (torch.arange(S, device="cuda")[None, :] < kv_len[:, None])[:, None, None, :]
        lib = gpu_ms(lambda: F.scaled_dot_product_attention(q, kd, vd, attn_mask=mask))
        n_kv = int(kv_len.clamp(max=S).sum())
        b_ms, b_by = bound(b * hq * d * 2 * 2 + 2 * n_kv * hk * d, 4.0 * n_kv * hq * d)
        log(f"  decode_attention b={b} hq=hk={hq} S={S:4d} kv_len={kv_len.tolist()} ms={ms:.4f} "
            f"plain_ms={plain:.4f} lib_ms={lib:.4f} bound_ms={b_ms:.4f} ({b_by}) "
            f"roofline={b_ms / ms:.3f} {r}")
        if S == 2048:
            cold, lib_cold = _decode_cold(
                g, b, hk, S, d, kv_scale,
                lambda k, v: fa.decode_attention(q, k, v, q_offset=pos, kv_len=kv_len,
                                                 kv_scale=kv_scale),
                lambda kd, vd: F.scaled_dot_product_attention(q, kd, vd, attn_mask=mask))
            log(f"  decode_attention cold (KV copies beyond twice the L2): ms={cold:.4f} "
                f"lib_ms={lib_cold:.4f} bound_ms={b_ms:.4f} roofline={b_ms / cold:.3f}")
            put("decode_attention", dict(ms=ms, plain_ms=plain, library_ms=lib,
                                         bound_ms=b_ms, bound_by=b_by, ms_cold=cold,
                                         library_ms_cold=lib_cold,
                                         shape=f"b=4 hq=hk={hq} d=128 S={S}"))
    rec = records["decode_attention"]
    rec["max_abs_err"] = max(rec.get("max_abs_err", 0.0), worst)

    # prefill (whole KV fits 8 MiB) and flash (bshd, longer prompts).  The
    # engine pads a prompt to its bucket, so run_queue gives the 128-token
    # prompt sq=128 over S=256, and the 1100-token one sq=kv_len=2048 over
    # S=2048 (recorded); sq=kv_len=1100 checks a ragged tail.
    for name, sq, S, kvl, record in (("prefill_attention", 128, 256, 128, True),
                                     ("flash_attention", 1100, 2048, 1100, False),
                                     ("flash_attention", 2048, 2048, 2048, True)):
        k, v = _kv_case(g, 1, hk, S, d, kv_scale)
        q = torch.randn((1, sq, hq, d), generator=g, device="cuda").to(torch.bfloat16)
        if name == "prefill_attention":
            run = lambda: fa.prefill_attention(q, k, v, causal=True, q_offset=0,
                                               kv_len=kvl, kv_scale=kv_scale)
        else:
            run = lambda: fa.flash_attention(q, k, v, causal=True, q_offset=0, kv_len=kvl,
                                             kv_scale=kv_scale, qo_layout="bshd")
        out = run()
        torch.cuda.synchronize()
        plain_fn = lambda: fa._attention_ref(q.permute(0, 2, 1, 3), k, v, causal=True,
                                             q_offset=0, kv_len=kvl, scale=sm,
                                             kv_scale=kv_scale)
        ref = plain_fn().permute(0, 2, 1, 3).to(torch.bfloat16)
        r = _verify_attn(name, out, ref)
        ms = gpu_ms(run)
        plain = gpu_ms(plain_fn, reps=5)
        qh = q.permute(0, 2, 1, 3)
        kd = (k[:, :, :kvl].float() * kv_scale).to(torch.bfloat16)
        vd = (v[:, :, :kvl].float() * kv_scale).to(torch.bfloat16)
        lib = gpu_ms(lambda: F.scaled_dot_product_attention(qh, kd, vd, is_causal=True))
        pairs = sq * (sq + 1) // 2               # causal (query, key) pairs, q_offset 0
        b_ms, b_by = bound(sq * hq * d * 2 * 2 + 2 * kvl * hk * d, 4.0 * pairs * hq * d)
        log(f"  {name} hq=hk={hq} sq={sq} S={S} kv_len={kvl} ms={ms:.4f} plain_ms={plain:.4f} "
            f"lib_ms={lib:.4f} bound_ms={b_ms:.4f} ({b_by}) roofline={b_ms / ms:.3f} {r}")
        worst = max(records.get(name, {}).get("max_abs_err", 0.0), r.max_abs_err)
        if record:
            put(name, dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=b_ms,
                           bound_by=b_by, shape=f"b=1 sq={sq} S={S} kv_len={kvl} "
                                                f"hq=hk={hq} d=128"))
        records.setdefault(name, {})["max_abs_err"] = worst
        del k, v


def check_decode_prologue(records):
    """The batched decode step's attention prologue (llm/model.py
    decode_prologue: RoPE on the q|k heads, the int8 K/V quantisation and
    the row store, one launch of csrc/decode_prologue.cu) against its plain
    version decode_prologue_ref on the card, at the served cells' shapes: 16
    lanes over a 4096-row int8 cache layer, head dim 128, GQA 32/8
    (Mistral-7B, gen) and MHA 32/32 (DeepSeek-LLM-7B, chat), one lane past
    the cache.  Identical q bits and caches; times behind a sleep kernel
    beside the bytes bound and the plain version's (its ~25 PyTorch
    kernels, back to back)."""
    import torch
    from csinn2_tpu_torch.llm import model as tm
    from csinn2_tpu_torch.utils.timing import gpu_ms
    g = torch.Generator(device="cuda")
    g.manual_seed(3)
    b, d, S = 16, 128, 4096
    for label, hq, hk in (("gqa", 32, 8), ("mha", 32, 32)):
        qkv = (torch.randn((b, 1, (hq + 2 * hk) * d), generator=g, device="cuda") * 4) \
            .to(torch.bfloat16)
        qk = qkv[..., :(hq + hk) * d].reshape(b, 1, hq + hk, d)
        v = qkv[..., (hq + hk) * d:].reshape(b, 1, hk, d)
        pos = torch.randint(0, S, (b,), generator=g, device="cuda", dtype=torch.int32)
        pos[0] = S
        tables = tm.rope_tables(pos[:, None], d, 10000.0)
        cache = tm.KVCache(*(torch.randint(-127, 128, (1, b, S, hk, d), generator=g,
                                           device="cuda", dtype=torch.int8) for _ in range(2)),
                           scale=0.05)
        plain = tm.KVCache(k=cache.k.clone(), v=cache.v.clone(), scale=cache.scale)
        q = tm.decode_prologue(qk, v, tables, pos, cache, 0)
        want = tm.decode_prologue_ref(qk, v, tables, pos, plain, 0)
        torch.cuda.synchronize()
        if not (torch.equal(q.view(torch.int16), want.contiguous().view(torch.int16)) and
                torch.equal(cache.k, plain.k) and torch.equal(cache.v, plain.v)):
            raise AssertionError(f"decode_prologue {label}: not bit for bit the plain version")
        ms = gpu_ms(lambda: tm.decode_prologue(qk, v, tables, pos, cache, 0))
        plain_ms = gpu_ms(lambda: tm.decode_prologue_ref(qk, v, tables, pos, plain, 0))
        # read: the q|k|v heads, the tables, pos; written: q, a K and a V row
        # a lane that writes (lane 0 is past the cache)
        nbytes = b * (hq + 2 * hk) * d * 2 + b * d * 4 + b * 4 + b * hq * d * 2 \
            + 2 * (b - 1) * hk * d
        b_ms, b_by = bound(nbytes, 0.0)
        shape = f"b={b} hq={hq} hk={hk} d={d} S={S} int8"
        log(f"  decode_prologue {shape} ms={ms:.4f} plain_ms={plain_ms:.4f} "
            f"bound_ms={b_ms:.5f} ({b_by}) roofline={b_ms / ms:.3f}: q and cache bit for bit")
        rec = dict(ms=ms, plain_ms=plain_ms, library_ms=None, bound_ms=b_ms, bound_by=b_by,
                   shape=shape, max_abs_err=0.0)
        if label == "gqa":
            records["decode_prologue"] = rec
        else:
            records["decode_prologue"]["mha"] = rec
        del cache, plain


# ---------------------------------------------------------------------------
# phase 2, the fourth slice's kernel modes: int8 x, requantize, scale_mode
# "none", the transposed layouts, bhsd flash_attention
# ---------------------------------------------------------------------------

# (label, K, N, Ms) of the 7B GEMMs the new modes are held at
NEW_SHAPES = (("w13", 4096, 22016, (4, 128)), ("wqkv", 4096, 12288, (128,)),
              ("w2", 11008, 4096, (128,)))


def _new_qmm_case(g, kind: str, K: int, N: int):
    """(weight, scales, bias, quant_matmul kwargs, bf16 dequantized [K, N]
    weight for the library yardstick or None) of one new mode; random
    carriers over the full range, f16-rounded scales."""
    import torch
    from csinn2_tpu_torch.core.quant import quantize_multiplier
    from csinn2_tpu_torch.kernels.qmatmul import pack_int4_t
    ri = lambda lo, hi, shape: torch.randint(lo, hi, shape, generator=g, device="cuda",
                                             dtype=torch.int8)
    rs = lambda shape, a=2e-4: (torch.rand(shape, generator=g, device="cuda") * a + 1e-5) \
        .to(torch.float16).float()
    if kind in ("int8dot", "int8dot_q", "requant", "none"):
        w = ri(-128, 128, (K, N))
        if kind == "none":
            return w, None, None, dict(scale_mode="none"), w.to(torch.bfloat16)
        if kind == "requant":
            bias = torch.randint(-2**18, 2**18, (N,), generator=g, device="cuda",
                                 dtype=torch.int32)
            eff = torch.rand((N,), generator=g, device="cuda").double().cpu().numpy() * 1e-4 + 1e-6
            mult, shift = quantize_multiplier(eff)
            kw = dict(scale_mode="none", out_dtype=torch.int8, out_zp=3.0,
                      rq_mult=torch.from_numpy(mult).cuda(), rq_shift=torch.from_numpy(shift).cuda())
            return w, None, bias, kw, None
        s = rs((N,), 1e-3)
        if kind == "int8dot":
            return w, s, None, dict(scale_mode="channel"), None
        bias = torch.randn((N,), generator=g, device="cuda") * 4
        return w, s * 0.05, bias, dict(scale_mode="channel", out_dtype=torch.int8,
                                       epilogue_scale=0.37, out_zp=3.0), None
    # transposed weights of the op API's block tensors, and the rest of 1e'
    packed = kind == "t_packed"
    lo = -8 if kind in ("t_q4_0", "t_packed") else -128
    q = ri(lo, 8 if lo == -8 else 128, (N, K))
    if kind == "t_int8_channel":
        s = rs((N,))
        deq = q.float() * s[:, None]
        kw = dict(scale_mode="channel", w_transposed=True)
    else:
        s = rs((N, K // 32))
        deq = (q.float().reshape(N, K // 32, 32) * s[:, :, None]).reshape(N, K)
        kw = dict(scale_mode="block", w_transposed=True, packed_int4=packed)
    return (pack_int4_t(q) if packed else q), s, None, kw, deq.t().to(torch.bfloat16)


NEW_QMM = {  # kind → (launch_counts name, label)
    "int8dot": ("quant_matmul_int8dot", "int8 x, channel, f32 out"),
    "int8dot_q": ("quant_matmul_int8dot", "int8 x, channel·e + b → int8 (zp 3)"),
    "requant": ("quant_matmul_requant", "int8 x, int32 bias, rq_mult → int8"),
    "none": ("quant_matmul_none", "bf16 x, scale_mode none, f32 out"),
    "t_q8_0": ("quant_matmul_t", "Q8_0 [N,K] + [N,K/32]"),
    "t_q4_0": ("quant_matmul_t", "Q4_0 carrier [N,K] + [N,K/32]"),
    "t_int8_channel": ("quant_matmul_t", "INT8_CHANNEL [N,K]"),
    "t_packed": ("quant_matmul_t", "Q4_0 packed [N,K/2] + [N,K/32]"),
}
# the case each new kernel's record shows (w13; decode M = 4); the int8-x
# kernels' records come from check_int8dot_cold
NEW_RECORD = {"quant_matmul_none": "none", "quant_matmul_t": "t_q8_0"}


def _x_for(g, kind, M, K):
    import torch
    if kind in ("int8dot", "int8dot_q", "requant"):
        return torch.randint(-128, 128, (M, K), generator=g, device="cuda", dtype=torch.int8)
    return torch.randn((M, K), generator=g, device="cuda").to(torch.bfloat16)


def _int_mm_x(x):
    """x as torch._int_mm takes it: it refuses M <= 16, so x zero-padded to 32
    rows there."""
    import torch
    if x.shape[0] > 16:
        return x
    return torch.cat([x, x.new_zeros((32 - x.shape[0], x.shape[1]))])


def int_mm_ms(x, w):
    """torch._int_mm's time on the same int8 operands (int32 sums only), warm."""
    import torch
    from csinn2_tpu_torch.utils.timing import gpu_ms
    xp = _int_mm_x(x)
    return gpu_ms(lambda: torch._int_mm(xp, w))


def check_int8dot_cold(records):
    """Row 1d on its redesigned kernels: the int8-x GEMM at w13 (INT8_CHANNEL
    [K, N] weight) at M = 1, 4, 8, 16, 128, 512 and 2048 in the float
    epilogue (channel scale, f32 out) and the requantize (int32 bias,
    rq_mult → int8), bit for bit the plain version, timed cold (weight
    copies beyond twice the L2) beside its bound and torch._int_mm's faster
    operand layout, cold: w [K, N], or the [N, K] copy's .t() view, which
    cuBLASLt takes column-major (x zero-padded to 32 rows at M <= 16).  The
    records of quant_matmul_int8dot and quant_matmul_requant: M = 4, with
    the prefill rows under "prefill"."""
    import numpy as np
    import torch
    from csinn2_tpu_torch.core.quant import quantize_multiplier
    from csinn2_tpu_torch.kernels.qmatmul import quant_matmul, quant_matmul_ref
    from csinn2_tpu_torch.utils.timing import cold_copies, gpu_ms, gpu_ms_cold, l2_bytes
    g = torch.Generator(device="cuda")
    g.manual_seed(4)
    K, N = 4096, 22016
    w = torch.randint(-128, 128, (K, N), generator=g, device="cuda", dtype=torch.int8)
    s = torch.rand((N,), generator=g, device="cuda") * 1e-3 + 1e-5
    bias = torch.randint(-2**18, 2**18, (N,), generator=g, device="cuda", dtype=torch.int32)
    mult, shift = quantize_multiplier(np.random.default_rng(4).uniform(1e-6, 1e-4, N))
    epilogues = {
        "quant_matmul_int8dot": ("float: channel, f32 out", s, None, dict(scale_mode="channel")),
        "quant_matmul_requant": ("requant: int32 bias, rq_mult -> int8", None, bias,
                                 dict(scale_mode="none", out_dtype=torch.int8, out_zp=3.0,
                                      rq_mult=torch.from_numpy(mult).cuda(),
                                      rq_shift=torch.from_numpy(shift).cuda()))}
    copies = [w] + [w.clone() for _ in range(cold_copies(w.numel(), l2_bytes()) - 1)]
    lib_layouts = {"w [K,N]": copies, "[N,K].t()": [c.t().contiguous().t() for c in copies]}
    for M in (1, 4, 8, 16, 128, 512, 2048):
        x = torch.randint(-128, 128, (M, K), generator=g, device="cuda", dtype=torch.int8)
        xp = _int_mm_x(x)
        libs = {name: gpu_ms_cold([lambda c=c: torch._int_mm(xp, c) for c in cs])
                for name, cs in lib_layouts.items()}
        lib_name = min(libs, key=libs.get)
        for key, (label, sc, b, kw) in epilogues.items():
            y = quant_matmul(x, w, sc, b, **kw)
            torch.cuda.synchronize()
            if not torch.equal(y, quant_matmul_ref(x, w, sc, b, **kw)):
                raise AssertionError(f"{key} w13 M={M}: {int((y != quant_matmul_ref(x, w, sc, b, **kw)).sum())} outputs differ")
            ms = gpu_ms_cold([lambda c=c: quant_matmul(x, c, sc, b, **kw) for c in copies])
            plain = gpu_ms(lambda: quant_matmul_ref(x, w, sc, b, **kw), reps=3)
            nbytes = M * K + K * N + 8 * N + M * N * y.element_size()
            b_ms, b_by = bound(nbytes, 2.0 * M * N * K, INT8_OPS)
            log(f"  {key} {label} w13 M={M:4d} cold: ms={ms:.4f} plain_ms={plain:.4f} "
                f"bound_ms={b_ms:.4f} ({b_by}) roofline={b_ms / ms:.3f} torch._int_mm "
                f"{libs['w [K,N]']:.4f} (w [K,N]) / {libs['[N,K].t()']:.4f} ([N,K].t()): "
                f"x{ms / libs[lib_name]:.2f} of the faster; bit for bit")
            rec = records.setdefault(key, {"max_abs_err": 0.0})
            row = dict(ms=ms, plain_ms=plain, library_ms=libs[lib_name], bound_ms=b_ms,
                       bound_by=b_by, library_layout=lib_name)
            if M == 4:
                rec.update(row, shape=f"{label} w13 M=4 K={K} N={N} [K,N], cold (library: "
                                      f"torch._int_mm, x zero-padded to 32 rows, {lib_name})")
            elif M > 16:
                rec.setdefault("prefill", {})[f"M={M}"] = row
    del copies, lib_layouts


def kernel_api_path():
    """The path of the modes no package caller reaches (rows 1b' and 1d,
    the int8-x swiglu too): the public kernel API, quant_matmul, once per
    mode at each 7B shape.  Returns the launch counts of exactly these
    calls."""
    import torch
    from csinn2_tpu_torch.kernels import launch_counts, reset_launch_counts
    from csinn2_tpu_torch.kernels.qmatmul import quant_matmul
    g = torch.Generator(device="cuda")
    g.manual_seed(2)
    calls = []
    for kind in ("int8dot", "int8dot_q", "requant", "none"):
        for _, K, N, Ms in NEW_SHAPES:
            w, s, b, kw, _ = _new_qmm_case(g, kind, K, N)
            calls += [(_x_for(g, kind, M, K), w, s, b, kw) for M in Ms]
            if kind == "int8dot" and N % 256 == 0:     # the swiglu pairs (w13)
                calls += [(_x_for(g, kind, M, K), w, s, b, dict(kw, swiglu=True)) for M in Ms]
    torch.cuda.synchronize()
    reset_launch_counts()
    for x, w, s, b, kw in calls:
        quant_matmul(x, w, s, b, **kw)
    torch.cuda.synchronize()
    counts = dict(launch_counts)
    log(f"  kernel API path: {len(calls)} quant_matmul calls; launches {counts}")
    return counts


def check_new_quant_matmul(records):
    """Every new mode against its plain version at the 7B shapes, timed
    beside its bound, the plain version and a library call: torch._int_mm
    (int32 sums only; at M <= 16, which it refuses, on x zero-padded to 32
    rows) for the int8 x rows, torch.matmul on the dequantized bf16 weight
    for the float rows.  int8 x with f32 out and the requantize: bit for bit; the
    float epilogue to int8: 1 LSB on under 0.1 % (a double-rounding tie of
    the plain version's f64 fma)."""
    import torch
    from csinn2_tpu_torch.kernels.qmatmul import quant_matmul, quant_matmul_ref
    from csinn2_tpu_torch.utils.timing import gpu_ms
    from csinn2_tpu_torch.utils.verify import cosine_similarity
    g = torch.Generator(device="cuda")
    g.manual_seed(3)
    for kind, (key, label) in NEW_QMM.items():
        for name, K, N, Ms in NEW_SHAPES:
            w, s, b, kw, deq = _new_qmm_case(g, kind, K, N)
            for M in Ms:
                x = _x_for(g, kind, M, K)
                run = lambda: quant_matmul(x, w, s, b, **kw)
                y = run()
                torch.cuda.synchronize()
                ref = quant_matmul_ref(x, w, s, b, **kw)
                if kind in ("int8dot", "requant"):
                    if not torch.equal(y, ref):
                        raise AssertionError(f"{key} {kind} {name} M={M}: "
                                             f"{int((y != ref).sum())} outputs differ")
                    err, note = 0.0, "bit for bit"
                elif kind == "int8dot_q":
                    d = (y.int() - ref.int()).abs()
                    frac = float((d > 0).float().mean())
                    if int(d.max()) > 1 or frac >= 1e-3:
                        raise AssertionError(f"{key} int8 epilogue {name} M={M}: "
                                             f"max {int(d.max())} LSB on {frac:.2e}")
                    err, note = float(d.max()), f"{frac:.2e} of outputs 1 LSB off"
                else:
                    yf, rf = y.float().cpu().numpy(), ref.float().cpu().numpy()
                    err = float(abs(yf - rf).max())
                    cos = cosine_similarity(yf, rf)
                    if not (cos >= 0.9999 and err <= 1e-2 * float(abs(rf).max())):
                        raise AssertionError(f"{key} {kind} {name} M={M}: cos={cos} err={err}")
                    note = f"cos={cos:.6f}"
                ms = gpu_ms(run)
                plain = gpu_ms(lambda: quant_matmul_ref(x, w, s, b, **kw), reps=3)
                cold = {}
                if deq is not None:
                    xb = x.to(torch.bfloat16)
                    lib = gpu_ms(lambda: torch.matmul(xb, deq))
                    if M <= 16:                # the decode kernel, cold
                        cold = dict(zip(("ms_cold", "library_ms_cold"), _gemm_cold(
                            xb, w, s, deq, lambda wc, sc: quant_matmul(x, wc, sc, b, **kw))))
                        note += (f" cold: ms={cold['ms_cold']:.4f} "
                                 f"lib_ms={cold['library_ms_cold']:.4f}")
                else:
                    lib = int_mm_ms(x, w)
                osz = y.element_size()
                int_x = x.dtype == torch.int8
                nbytes = (x.numel() * x.element_size() + w.numel()
                          + (0 if s is None else s.numel() * 4)
                          + (0 if b is None else N * 4) + (8 * N if kind == "requant" else 0)
                          + M * N * osz)
                b_ms, b_by = bound(nbytes, 2.0 * M * N * K, INT8_OPS if int_x else BF16_FLOPS)
                log(f"  {key} {label} {name} M={M:4d} K={K:5d} N={N:5d} ms={ms:.4f} "
                    f"plain_ms={plain:.4f} lib_ms={lib:.4f} bound_ms={b_ms:.4f} ({b_by}) "
                    f"roofline={b_ms / ms:.3f} {note}")
                rec = records.setdefault(key, {"max_abs_err": 0.0})
                rec["max_abs_err"] = max(rec["max_abs_err"], err)
                if NEW_RECORD.get(key) == kind and name == "w13" and M == 4:
                    padded = " (library: x zero-padded to 32 rows)" if deq is None else ""
                    rec.update(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=b_ms,
                               bound_by=b_by, shape=f"{label} w13 M=4 K={K} N={N}{padded}",
                               **cold)
            del w, s, b, deq


def check_flash_bhsd(records):
    """bhsd flash_attention at the decode shape of row 2 (b = 4, hq = hk = 32,
    d = 128, S = 2048, kv_len 2048/1027/1/17, causal, q_offset = kv_len - 1:
    the split-KV decode the op API's decode SDPA launches) and at sq = S =
    2048 (the op API's prefill SDPA), against the plain version."""
    import torch
    import torch.nn.functional as F
    from csinn2_tpu_torch.kernels import flash_attention as fa
    from csinn2_tpu_torch.utils.timing import gpu_ms
    g = torch.Generator(device="cuda")
    g.manual_seed(4)
    hq = hk = 32
    d, kv_scale, S = 128, 0.05, 2048
    sm = 1.0 / math.sqrt(d)
    worst = 0.0
    for case in ("decode", "prefill"):
        b, sq = (4, 1) if case == "decode" else (1, S)
        k, v = _kv_case(g, b, hk, S, d, kv_scale)
        q = torch.randn((b, hq, sq, d), generator=g, device="cuda").to(torch.bfloat16)
        kvl = torch.tensor([2048, 1027, 1, 17] if case == "decode" else [S],
                           dtype=torch.int32, device="cuda")
        off = kvl - 1 if case == "decode" else torch.zeros_like(kvl)
        kw = dict(causal=True, q_offset=off, kv_len=kvl, kv_scale=kv_scale)
        run = lambda: fa.flash_attention(q, k, v, **kw)
        out = run()
        torch.cuda.synchronize()
        plain_fn = lambda: fa._attention_ref(q, k, v, scale=sm, **kw)
        r = _verify_attn(f"flash_attention_bhsd {case}", out, plain_fn().to(torch.bfloat16))
        worst = max(worst, r.max_abs_err)
        ms = gpu_ms(run)
        plain = gpu_ms(plain_fn, reps=5)
        kd = (k.float() * kv_scale).to(torch.bfloat16)
        vd = (v.float() * kv_scale).to(torch.bfloat16)
        if case == "decode":
            mask = (torch.arange(S, device="cuda")[None, :] < kvl[:, None])[:, None, None, :]
            lib = gpu_ms(lambda: F.scaled_dot_product_attention(q, kd, vd, attn_mask=mask))
            n_kv = int(kvl.sum())
            b_ms, b_by = bound(b * hq * d * 2 * 2 + 2 * n_kv * hk * d, 4.0 * n_kv * hq * d)
        else:
            lib = gpu_ms(lambda: F.scaled_dot_product_attention(q, kd, vd, is_causal=True))
            pairs = sq * (sq + 1) // 2
            b_ms, b_by = bound(sq * hq * d * 2 * 2 + 2 * S * hk * d, 4.0 * pairs * hq * d)
        shape = (f"b={b} hq=hk=32 sq={sq} d=128 S={S} kv_len={kvl.tolist()} causal, "
                 f"q_offset {'kv_len - 1' if case == 'decode' else '0'}")
        log(f"  flash_attention_bhsd {shape} ms={ms:.4f} plain_ms={plain:.4f} lib_ms={lib:.4f} "
            f"bound_ms={b_ms:.4f} ({b_by}) roofline={b_ms / ms:.3f} {r}")
        if case == "decode":
            cold, lib_cold = _decode_cold(
                g, b, hk, S, d, kv_scale, lambda k_, v_: fa.flash_attention(q, k_, v_, **kw),
                lambda kd_, vd_: F.scaled_dot_product_attention(q, kd_, vd_, attn_mask=mask))
            log(f"  flash_attention_bhsd decode cold: ms={cold:.4f} lib_ms={lib_cold:.4f} "
                f"roofline={b_ms / cold:.3f}")
            records["flash_attention_bhsd"] = dict(ms=ms, plain_ms=plain, library_ms=lib,
                                                   bound_ms=b_ms, bound_by=b_by, ms_cold=cold,
                                                   library_ms_cold=lib_cold, shape=shape)
        del k, v
    records["flash_attention_bhsd"]["max_abs_err"] = worst


ATTN_DIMS = (16, 32, 80, 96, 256)
ATTN_ENTRIES = ("prefill_attention", "flash_attention", "flash_attention_bhsd",
                "decode_attention")


def _attend(name, q, k, v, kw):
    """(output, its plain version on q rounded to bf16) of one attention entry
    point; q is [b, sq, hq, d] for prefill and bshd flash, [b, hq, sq, d]
    for bhsd flash and decode."""
    import torch
    from csinn2_tpu_torch.kernels import flash_attention as fa
    if name == "decode_attention":
        out = fa.decode_attention(q, k, v, q_offset=kw["q_offset"], kv_len=kw["kv_len"],
                                  kv_scale=kw["kv_scale"])
        kw = dict(kw, causal=False)
    elif name == "flash_attention_bhsd":
        out = fa.flash_attention(q, k, v, **kw)
    elif name == "flash_attention":
        out = fa.flash_attention(q, k, v, qo_layout="bshd", **kw)
    else:
        out = fa.prefill_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    bhsd = name in ("flash_attention_bhsd", "decode_attention")
    qb = q.to(torch.bfloat16)
    ref = fa._attention_ref(qb if bhsd else qb.permute(0, 2, 1, 3), k, v,
                            scale=1.0 / math.sqrt(q.shape[-1]), **kw)
    return out, ref if bhsd else ref.permute(0, 2, 1, 3)


def check_attention_dims(records):
    """The head dims the JAX kernels take besides 64 and 128 (they pad d to
    a multiple of 128) and an f32 q (rounded to bf16 in the kernel, as the
    JAX bodies round it), through the four attention entry points with int8
    (kv_scale 0.05) and bf16 KV, GQA 32/8, per-row q_offset / kv_len: b = 2,
    sq = 128 over S = 512 (kv_len 128 / 461, q_offset 0 / 333) and decode at
    kv_len 1 / 334; each output in q's dtype, against its plain version on
    q rounded to bf16 at the attention gate.  Then the split-KV flash decode
    at kv_len 0, 1, 17 and 2048 (sq 1 and 3)."""
    import torch
    g = torch.Generator(device="cuda")
    g.manual_seed(5)
    b, hq, hk, S = 2, 32, 8, 512
    n = 0
    for d in ATTN_DIMS:
        for int8 in (True, False):
            if int8:
                k, v = _kv_case(g, b, hk, S, d, 0.05)
            else:
                k, v = (torch.randn((b, S, hk, d), generator=g, device="cuda")
                        .to(torch.bfloat16).permute(0, 2, 1, 3) for _ in range(2))
            for qdt in (torch.float32, torch.bfloat16):
                for name in ATTN_ENTRIES:
                    sq = 1 if name == "decode_attention" else 128
                    bhsd = name in ("flash_attention_bhsd", "decode_attention")
                    q = torch.randn((b, hq, sq, d) if bhsd else (b, sq, hq, d), generator=g,
                                    device="cuda").to(qdt)
                    off = torch.tensor([0, 333], dtype=torch.int32, device="cuda")
                    kw = dict(causal=True, q_offset=off, kv_len=off + sq,
                              kv_scale=0.05 if int8 else None)
                    out, ref = _attend(name, q, k, v, kw)
                    if out.dtype != qdt or out.shape != q.shape:
                        raise AssertionError(f"{name} d={d}: out {out.dtype} {tuple(out.shape)}")
                    r = _verify_attn(f"{name} d={d} int8={int8} q {qdt}", out, ref)
                    rec = records.setdefault(name, {})
                    rec["max_abs_err"] = max(rec.get("max_abs_err", 0.0), r.max_abs_err)
                    n += 1
            del k, v
    log(f"  head dims {ATTN_DIMS} x int8/bf16 KV x f32/bf16 q x {len(ATTN_ENTRIES)} entry "
        f"points: {n} cases against the plain version, verify(2e-2), cos >= 0.9999")
    # the split-KV flash decode at the window's edges: kv_len 0 (outputs 0), 1, 17, 2048
    k, v = _kv_case(g, 4, hk, 2048, 128, 0.05)
    kvl = torch.tensor([0, 1, 17, 2048], dtype=torch.int32, device="cuda")
    for sq in (1, 3):
        q = torch.randn((4, hq, sq, 128), generator=g, device="cuda").to(torch.bfloat16)
        kw = dict(causal=True, q_offset=(kvl - sq).clamp(min=0), kv_len=kvl, kv_scale=0.05)
        out, ref = _attend("flash_attention_bhsd", q, k, v, kw)
        r = _verify_attn(f"split-KV decode sq={sq} kv_len {kvl.tolist()}", out, ref)
        if float(out[0].abs().max()) != 0.0:
            raise AssertionError("split-KV decode: the kv_len = 0 row must output 0")
        rec = records["flash_attention_bhsd"]
        rec["max_abs_err"] = max(rec["max_abs_err"], r.max_abs_err)
    log(f"  split-KV flash decode, GQA {hq}/{hk}, sq 1 and 3, kv_len {kvl.tolist()}: "
        f"against the plain version, the kv_len = 0 row 0")


WIDE_DS = (320, 576)   # 576: two CTA slices of O's columns
MLA = (128, 1, 576)    # DeepSeek-V2/V3's absorbed latent attention at decode: hq, hk, d


def check_attention_wide(records):
    """Head dims above 256 (attn_wide_mma_kernel, on wgmma): GQA 32/8 at d =
    320 and 576, int8 (kv_scale 0.05) and bf16 KV, per-row q_offset /
    kv_len: the four entry points at b = 2, sq = 128 over S = 512 (kv_len
    128 / 461, q_offset 0 / 333) and decode b = 4 over S = 2048 (kv_len 2048
    / 1027 / 0 / 17); and absorbed MLA's decode (hq 128 on one KV head, d =
    576, the port's one d for K and V where the model's V has 512) at the
    same decode rows.  The calls run once with the launch counts zeroed just
    before and read just after (their path: no package caller reaches d >
    256): one kernel launch a call, and a merge (`.combine`) for each call
    whose plan splits the KV window (the decodes', and at d = 320 the bf16
    prefills'); then each output against
    its plain version at the attention gate, the kv_len = 0 row 0; then
    flash_attention bhsd at sq = S = 512 (causal) and decode_attention at
    both d, and the MLA decode, timed beside the plain version and SDPA on
    the dequantized K/V (GQA-expanded; MLA's one head broadcast).  Returns
    the path's launch counts."""
    import torch
    import torch.nn.functional as F
    from csinn2_tpu_torch.kernels import flash_attention as fa
    from csinn2_tpu_torch.kernels import launch_counts, reset_launch_counts
    from csinn2_tpu_torch.utils.timing import gpu_ms
    g = torch.Generator(device="cuda")
    g.manual_seed(6)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    cases, merges = [], 0
    gqa = [(32, 8, d, name) for d in WIDE_DS for name in ATTN_ENTRIES]
    for hq, hk, d, name in gqa + [MLA + ("decode_attention",)]:
        for int8 in (True, False):
            dec = name == "decode_attention"
            b, S, sq = (4, 2048, 1) if dec else (2, 512, 128)
            if int8:
                k, v = _kv_case(g, b, hk, S, d, 0.05)
            else:
                k, v = (torch.randn((b, S, hk, d), generator=g, device="cuda")
                        .to(torch.bfloat16).permute(0, 2, 1, 3) for _ in range(2))
            bhsd = name in ("flash_attention_bhsd", "decode_attention")
            q = torch.randn((b, hq, sq, d) if bhsd else (b, sq, hq, d), generator=g,
                            device="cuda").to(torch.bfloat16)
            kvl = torch.tensor([2048, 1027, 0, 17] if dec else [128, 461],
                               dtype=torch.int32, device="cuda")
            off = kvl - 1 if dec else torch.tensor([0, 333], dtype=torch.int32, device="cuda")
            cases.append((name, hq, hk, d, int8, q, k, v,
                          dict(causal=True, q_offset=off, kv_len=kvl,
                               kv_scale=0.05 if int8 else None)))
            merges += fa._wide_plan(b, sq, hq, hk, S, d, k.element_size(), n_sm).n_chunks > 1
    torch.cuda.synchronize()
    reset_launch_counts()
    outs = [_attend(name, q, k, v, kw) for name, _, _, _, _, q, k, v, kw in cases]   # synchronizes
    counts = dict(launch_counts)
    log(f"  head dims {WIDE_DS} and MLA {MLA}: the four entry points (MLA: decode), int8 and "
        f"bf16 KV; launches {counts}")
    n_merge = sum(n for key, n in counts.items()
                  if key.startswith("attention_wide.") and key.endswith(".combine"))
    n_kernel = launches(counts, "attention_wide") - n_merge
    if n_kernel != len(cases) or n_merge != merges or launches(counts, "attention_wide") != \
            sum(counts.values()):
        raise AssertionError(f"attention_wide: {n_kernel} launches and {n_merge} merges for "
                             f"{len(cases)} calls and {merges} split plans: {counts}")
    worst = 0.0
    for (name, hq, hk, d, int8, *_), (out, ref) in zip(cases, outs):
        r = _verify_attn(f"attention_wide {name} hq={hq} hk={hk} d={d} int8={int8}", out, ref)
        worst = max(worst, r.max_abs_err)
        if name == "decode_attention" and float(out[2].abs().max()) != 0.0:
            raise AssertionError("attention_wide: the kv_len = 0 row must output 0")
    log(f"  head dims {WIDE_DS} and MLA: {len(cases)} calls against the plain version, "
        f"verify(2e-2), cos >= 0.9999, max_abs_err {worst:.3e}; the kv_len = 0 row 0")
    rec = {"max_abs_err": worst, "launches_combine": n_merge}
    # timing: bhsd flash at sq = S = 512 (causal), and decode at the case above
    kv_scale = 0.05
    timed = [(32, 8, d, case) for d in WIDE_DS for case in ("flash", "decode")]
    for hq, hk, d, case in timed + [MLA + ("decode",)]:
        b, S, sq = (1, 512, 512) if case == "flash" else (4, 2048, 1)
        k, v = _kv_case(g, b, hk, S, d, kv_scale)
        q = torch.randn((b, hq, sq, d), generator=g, device="cuda").to(torch.bfloat16)
        kvl = torch.tensor([S] if case == "flash" else [2048, 1027, 0, 17],
                           dtype=torch.int32, device="cuda")
        if case == "flash":
            kw = dict(causal=True, q_offset=0, kv_len=kvl, kv_scale=kv_scale)
            run = lambda: fa.flash_attention(q, k, v, **kw)
            plain_fn = lambda: fa._attention_ref(q, k, v, scale=1.0 / math.sqrt(d), **kw)
        else:
            kw = dict(q_offset=kvl - 1, kv_len=kvl, kv_scale=kv_scale)
            run = lambda: fa.decode_attention(q, k, v, **kw)
            plain_fn = lambda: fa._attention_ref(q, k, v, causal=False,
                                                 scale=1.0 / math.sqrt(d), **kw)
        ms = gpu_ms(run)
        plain = gpu_ms(plain_fn, reps=3)
        kd, vd = ((x.float() * kv_scale).to(torch.bfloat16) for x in (k, v))
        kd, vd = ((x.expand(-1, hq, -1, -1) if hk == 1 else x.repeat_interleave(hq // hk, dim=1))
                  for x in (kd, vd))
        if case == "flash":
            lib = gpu_ms(lambda: F.scaled_dot_product_attention(q, kd, vd, is_causal=True))
            pairs = sq * (sq + 1) // 2
            b_ms, b_by = bound(2 * b * sq * hq * d * 2 + 2 * S * hk * d,
                               4.0 * pairs * hq * d)
        else:
            mask = (torch.arange(S, device="cuda")[None, :] < kvl[:, None])[:, None, None, :]
            lib = gpu_ms(lambda: F.scaled_dot_product_attention(q, kd, vd, attn_mask=mask))
            n_kv = int(kvl.sum())
            b_ms, b_by = bound(2 * b * hq * d * 2 + 2 * n_kv * hk * d, 4.0 * n_kv * hq * d)
        shape = (f"{'flash_attention bhsd' if case == 'flash' else 'decode_attention'} "
                 f"b={b} hq={hq} hk={hk} sq={sq} d={d} S={S} kv_len={kvl.tolist()}, int8 KV")
        log(f"  attention_wide {shape} ms={ms:.4f} plain_ms={plain:.4f} lib_ms={lib:.4f} "
            f"bound_ms={b_ms:.4f} ({b_by}) roofline={b_ms / ms:.3f}")
        times = dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=b_ms, bound_by=b_by,
                     shape=shape)
        if case == "flash" and d == WIDE_DS[0]:
            rec.update(times)
        elif hk == 1:
            rec["decode_mla"] = times
        else:
            rec[case if d == WIDE_DS[0] else f"{case}_d{d}"] = times
        del k, v, kd, vd
    records["attention_wide"] = rec
    return counts


# ---------------------------------------------------------------------------
# phase 8: the op API's CUDA tier at Llama-2-7B width
# ---------------------------------------------------------------------------

# (name, N, K) of the four projections of one Llama-2-7B layer, [N, K] weights
LAYER_FCS = (("wqkv", 12288, 4096), ("wo", 4096, 4096), ("w13", 22016, 4096),
             ("w2", 4096, 11008))


def _block_tensor(g, scheme, N, K):
    """A Q8_0 / Q4_0 block tensor made on the card from the generator: int8
    values [N, K] (Q4_0 in [-8, 7], the unpacked carrier) and fp16 scales
    [N, K/32]."""
    import torch
    from csinn2_tpu_torch.core.dtypes import QuantScheme
    from csinn2_tpu_torch.core.quant import BlockQuant
    from csinn2_tpu_torch.core.tensor import Tensor
    lim = 8 if scheme == "q4_0" else 128
    values = torch.randint(-lim + (scheme == "q8_0"), lim, (N, K), generator=g, device="cuda",
                           dtype=torch.int8)
    scales = (torch.rand((N, K // 32), generator=g, device="cuda") * 2e-3 + 1e-4).half()
    sch = QuantScheme.BLOCK_Q4_0 if scheme == "q4_0" else QuantScheme.BLOCK_Q8_0
    return Tensor(block=BlockQuant(values=values, scales=scales, scheme=sch))


def _op_graph(api, weights, M, out_qinfo=None, layer_mode=False, xs=None):
    """The four projections (and with M = None the two SDPA calls) through
    the op API: a GRAPH Session on the card, or in layer mode the eager
    calls.  Returns (session or None, outputs)."""
    from csinn2_tpu_torch import ops
    from csinn2_tpu_torch.core.dtypes import Dtype, RunMode
    from csinn2_tpu_torch.core.tensor import Tensor, TensorMeta
    from csinn2_tpu_torch.runtime.session import Session

    def body(inputs):
        if M is None:
            (pq, pk), (dq, dk) = (inputs[0], inputs[1]), (inputs[2], inputs[3])
            return [ops.scaled_dot_product_attention(pq, pk, pk, ops.SDPAParams(causal=True)),
                    ops.scaled_dot_product_attention(
                        dq, dk, dk, ops.SDPAParams(causal=True, pos_offset=1500, kv_len=1501))]
        x4096, x11008 = inputs
        return [ops.fullyconnected(x11008 if name == "w2" else x4096, weights[name],
                                   out_qinfo=out_qinfo if name == "wo" else None)
                for name, _, _ in LAYER_FCS]

    if layer_mode:
        sess = Session(run_mode=RunMode.LAYER, api=api, device="cuda")
        with sess.build():
            return None, [o.data for o in body([Tensor(x) for x in xs])]
    sess = Session(run_mode=RunMode.GRAPH, api=api, device="cuda")
    with sess.build():
        ins = [sess.input(TensorMeta(shape=tuple(x.shape), dtype=Dtype.FLOAT32)) for x in xs]
        sess.set_output(*body(ins))
    sess.setup()
    return sess, None


def op_api_path(records, gpu_line):
    """Phase 8: `ops.fullyconnected` on Q8_0 and Q4_0 block tensors of one
    Llama-2-7B layer's four projections at M = 128 and 4, and
    `ops.scaled_dot_product_attention` at prefill ([1, 32, 2048, 128],
    causal) and decode ([4, 32, 1, 128] over S = 2048, pos_offset 1500,
    kv_len 1501), recorded into a GRAPH Session(device="cuda") with Api.AUTO
    and run in layer mode; held against the same graph in an Api.TORCH
    session.  Returns the launch counts of the AUTO GRAPH runs."""
    import numpy as np
    import torch
    from csinn2_tpu_torch.core.dtypes import Api, Dtype
    from csinn2_tpu_torch.core.quant import QuantInfo
    from csinn2_tpu_torch.kernels import launch_counts, reset_launch_counts
    from csinn2_tpu_torch.utils.verify import cosine_similarity, verify
    g = torch.Generator(device="cuda")
    g.manual_seed(5)
    cases = []
    for scheme in ("q8_0", "q4_0"):
        weights = {name: _block_tensor(g, scheme, N, K) for name, N, K in LAYER_FCS}
        for M in (128, 4):
            xs = [torch.randn((M, K), generator=g, device="cuda") for K in (4096, 11008)]
            cases.append((f"{scheme} fc M={M}", weights, M, xs))
    sdpa_xs = [torch.randn(sh, generator=g, device="cuda").to(torch.bfloat16).float()
               for sh in ((1, 32, 2048, 128), (1, 32, 2048, 128), (4, 32, 1, 128),
                          (4, 32, 2048, 128))]
    cases.append(("sdpa prefill+decode", None, None, sdpa_xs))
    torch.cuda.synchronize()

    counts = {}
    for label, weights, M, xs in cases:
        auto, _ = _op_graph(Api.AUTO, weights, M, xs=xs)
        ref, _ = _op_graph(Api.TORCH, weights, M, xs=xs)
        names = [n.cb_name for n in auto.graph.nodes]
        if not all(n.endswith(":cuda") for n in names):
            raise AssertionError(f"phase 8 {label}: nodes not on the CUDA tier: {names}")
        reset_launch_counts()
        torch.cuda.synchronize()
        outs = auto.run(*xs, unwrap=False)
        torch.cuda.synchronize()
        run_counts = dict(launch_counts)
        for k, n in run_counts.items():
            counts[k] = counts.get(k, 0) + n
        want = ref.run(*xs, unwrap=False)
        _, eager = _op_graph(Api.AUTO, weights, M, layer_mode=True, xs=xs)
        gates = []
        for i, (o, e, w_) in enumerate(zip(outs, eager, want)):
            o, e, w_ = (t.float().cpu().numpy() for t in (o, e, w_))
            if M is None:
                r = verify(o, w_, tol=2e-2, min_cosine=0.9999)
                if not (r.passed and verify(e, w_, tol=2e-2, min_cosine=0.9999).passed):
                    raise AssertionError(f"phase 8 {label} output {i}: {r}")
                gates.append(f"{r.cosine_sim:.6f}")
            else:
                c, ce = cosine_similarity(o, w_), cosine_similarity(e, w_)
                if not (c >= 0.9999 and ce >= 0.9999):
                    raise AssertionError(f"phase 8 {label} {LAYER_FCS[i][0]}: cos {c} / {ce}")
                gates.append(f"{c:.6f}")
        t_auto = auto.run_benchmark_device(*xs, iters=10, reps=3)
        t_ref = ref.run_benchmark_device(*xs, iters=3, reps=3)
        log(f"  {label}: nodes {names}; launches {run_counts}; cos vs Api.TORCH {gates} "
            f"(graph and layer mode); graph run {t_auto * 1e3:.3f} ms vs Api.TORCH "
            f"{t_ref * 1e3:.3f} ms (CUDA events) [{gpu_line}]")
        if label == "q8_0 fc M=4":
            # an int8 out_qinfo on wo: the CUDA tier's requantize vs the TORCH tier's
            y = want[1].float()
            qi = QuantInfo(scale=float(y.abs().max()) / 127.0, zero_point=0, dtype=Dtype.INT8)
            qa, _ = _op_graph(Api.AUTO, weights, M, out_qinfo=qi, xs=xs)
            qr, _ = _op_graph(Api.TORCH, weights, M, out_qinfo=qi, xs=xs)
            a, b = qa.run(*xs, unwrap=False)[1], qr.run(*xs, unwrap=False)[1]
            d = (a.int() - b.int()).abs()
            log(f"  wo with an int8 out_qinfo (scale {qi.scale:.4g}): {a.dtype}, max |d| "
                f"{int(d.max())} LSB, {int((d > 0).sum())} of {d.numel()} off")
            if a.dtype != torch.int8 or int(d.max()) > 1:
                raise AssertionError("phase 8: int8 out_qinfo off by more than 1 LSB")
        del auto, ref, outs, want, eager
    for k in ("quant_matmul_t.prefill", "quant_matmul_t.decode", "flash_attention_bhsd"):
        if counts.get(k, 0) == 0:
            raise AssertionError(f"phase 8 never launched {k}: {counts}")
    log(f"  phase 8 launches (AUTO graph runs): {counts}")
    torch.cuda.empty_cache()
    return counts


# ---------------------------------------------------------------------------
# phase 3: a 2-layer 7B-width model, card against the CPU plain path
# ---------------------------------------------------------------------------

def _to(tree, device):
    import torch
    from csinn2_tpu_torch.llm.model import QWeight
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    if isinstance(tree, QWeight):
        return dataclasses.replace(tree, values=tree.values.to(device),
                                   scales=None if tree.scales is None
                                   else tree.scales.to(device))
    return tree.to(device) if isinstance(tree, torch.Tensor) else tree


@contextlib.contextmanager
def env_flag(name: str, on: bool):
    """Environment variable `name` set to "1" (or unset) inside the block."""
    old = os.environ.pop(name, None)
    if on:
        os.environ[name] = "1"
    try:
        yield
    finally:
        os.environ.pop(name, None)
        if old is not None:
            os.environ[name] = old


def swiglu_fusion(on: bool):
    """CSINN2_SWIGLU_FUSE=1 (or unset) while the params are fused."""
    return env_flag("CSINN2_SWIGLU_FUSE", on)


def model_parity(mode: str, swiglu: bool):
    import numpy as np
    import torch
    from csinn2_tpu_torch.llm.config import LlamaConfig
    from csinn2_tpu_torch.llm.model import KVCache, fuse_params, init_params_device, llama_forward
    from csinn2_tpu_torch.utils.verify import cosine_similarity
    cfg = dataclasses.replace(LlamaConfig.llama2_7b(), n_layers=2, max_seq_len=256)
    with swiglu_fusion(swiglu):
        params = fuse_params(init_params_device(cfg, mode, seed=3, device="cuda"))
    if (params["layers"][0]["w13"].layout == "swiglu128") != swiglu:
        raise AssertionError("swiglu128 fusion not as asked")
    toks = torch.from_numpy(np.random.default_rng(3).integers(1, cfg.vocab_size, (1, 128)))
    cache = KVCache.create(cfg, 1, quantized=True, device="cuda")
    gpu, _ = llama_forward(params, toks, cache, 0, cfg)
    gpu = gpu.float().cpu().numpy()
    cpu_params = _to(params, "cpu")
    del params
    cache = KVCache.create(cfg, 1, quantized=True, device="cpu")
    cpu, _ = llama_forward(cpu_params, toks, cache, 0, cfg)
    cos = cosine_similarity(gpu, cpu.numpy())
    log(f"  2-layer 7B-width {mode}{' +swiglu128' if swiglu else ''} int8-KV prefill s=128: "
        f"logits {gpu.shape} finite={bool(np.isfinite(gpu).all())} "
        f"cosine(card, cpu plain)={cos:.6f}")
    if not (np.isfinite(gpu).all() and cos >= 0.999):
        raise AssertionError(f"model parity {mode} swiglu={swiglu}: cosine {cos}")


# ---------------------------------------------------------------------------
# phases 4-6: serving paths at full width
# ---------------------------------------------------------------------------

def serve(gpu_line: str, mode: str, swiglu: bool = False):
    """Llama-2-7B (32 layers), `mode` weights made on the card, int8 KV:
    run_queue over the six prompts through the decode step graph, its
    launch counts per decode step, and its tokens against a rerun through
    the eager loop (_decode_steps_eager); then TTFT at prompts 128 and 1100
    (host-inclusive, and on the device by benchmark_prefill_device), a
    seeded sampled chunk through the graph against the eager loop, decode
    tokens/s at batch 4 through the graph beside the eager loop in turns,
    and benchmark_decode_device at batch 4 and 1.  Returns dict(counts of
    the run_queue, its tokens (outs), the qmm_reduce launches per eager
    decode step, and the prefill and decode logits and first tokens that
    phase 14 holds the mesh to)."""
    import numpy as np
    import torch
    from csinn2_tpu_torch.kernels import launch_counts, reset_launch_counts
    from csinn2_tpu_torch.kernels.qmatmul import launch_key, reduce_launches
    from csinn2_tpu_torch.llm.config import LlamaConfig
    from csinn2_tpu_torch.llm.engine import InferenceEngine, Request, _bucket
    from csinn2_tpu_torch.llm.model import init_params_device
    from csinn2_tpu_torch.utils.timing import event_ms
    cfg = LlamaConfig.llama2_7b()
    L = cfg.n_layers
    name = f"{mode}{' +swiglu128' if swiglu else ''}"
    t0 = time.perf_counter()
    with swiglu_fusion(swiglu):
        eng = InferenceEngine(cfg, init_params_device(cfg, mode, seed=0, device="cuda"),
                              batch=4, quantized_kv=True, device="cuda")
    torch.cuda.synchronize()
    log(f"  Llama-2-7B {name} weights made and quantized on the card: "
        f"{time.perf_counter() - t0:.2f} s, {torch.cuda.memory_allocated() / 2**30:.2f} GiB "
        f"(weights + int8 KV cache)")
    rng = np.random.default_rng(0)
    prompts = [[int(t) for t in rng.integers(1, cfg.vocab_size, n)] for n in PROMPTS]
    reqs = [Request(prompt=p, max_new_tokens=16) for p in prompts]

    steps = [0]
    decode_steps = eng.decode_steps

    def counted(next_tokens, n_steps, **kw):
        steps[0] += n_steps
        return decode_steps(next_tokens, n_steps, **kw)

    eng.decode_steps = counted
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = eng.run_queue(reqs, chunk=16)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(launch_counts)
    del eng.decode_steps            # the method again (an attribute would hold eng in a cycle)
    log(f"  run_queue: {len(done)} requests, {sum(len(r.out) for r in done)} tokens "
        f"in {wall:.3f} s (host clock, first call, decode step graphs captured); "
        f"launches {counts}")
    for n, r in zip(PROMPTS, done):
        if not r.done or len(r.out) != 16 or not all(0 <= t < cfg.vocab_size for t in r.out):
            raise AssertionError(f"{name} request of prompt {n}: done={r.done} out={r.out}")
    qmm = launch_key(*QMM_MODES[mode], swiglu=False)
    want = [f"{k}.{v}" for k in ((qmm, "quant_matmul_swiglu") if swiglu else (qmm,))
            for v in ("decode", "prefill")] + list(ATTENTION)
    missing = [k for k in want if counts.get(k, 0) == 0]
    if missing:
        raise AssertionError(f"{name} path never launched {missing}")
    # the step graph's counts: a replay a step, a capture a key, and each
    # kernel's launches a step those of the eager step (the tallies)
    captures = counts.get("decode_graph.capture", 0)
    replays = counts.get("decode_graph.replay", 0)
    per_step = {f"{qmm}.decode": (3 if swiglu else 4) * L + 1, "decode_attention": L}
    if swiglu:
        per_step["quant_matmul_swiglu.decode"] = L
    log(f"  decode steps {steps[0]} through the step graph: replays {replays}, captures "
        f"{captures} for {len(eng._graphs)} keys (kv_bound {sorted(k[0] for k in eng._graphs)}), "
        f"the warm-up steps' launches (not in the kernels' counts) "
        f"{counts.get('decode_graph.warmup', 0)}; launches a step "
        + ", ".join(f"{k} {counts.get(k, 0) / max(steps[0], 1):g} (want {n})"
                    for k, n in per_step.items()))
    if replays != steps[0] or captures != len(eng._graphs) or captures == 0 or \
            any(counts.get(k, 0) != n * steps[0] for k, n in per_step.items()):
        raise AssertionError(f"{name}: decode graph counts {counts}")
    # the prefill graphs: a replay a request, a capture a prompt bucket
    buckets = sorted(eng._prefill_graphs)
    log(f"  prefills through the prefill graphs: replays "
        f"{counts.get('prefill_graph.replay', 0)} for {len(prompts)} requests, captures "
        f"{counts.get('prefill_graph.capture', 0)} for buckets {buckets}")
    if counts.get("prefill_graph.replay", 0) != len(prompts) or \
            counts.get("prefill_graph.capture", 0) != len(buckets) or \
            buckets != sorted({_bucket(n) for n in PROMPTS}):
        raise AssertionError(f"{name}: prefill graph counts {counts}")
    outs = [list(r.out) for r in done]
    # the same requests through the eager prefill and the eager loop: the
    # same greedy tokens
    eng.decode_steps = eng._decode_steps_eager
    eng.prefill_sample = eng._prefill_eager
    eager = eng.run_queue([Request(prompt=p, max_new_tokens=16) for p in prompts], chunk=16)
    del eng.decode_steps, eng.prefill_sample
    eager_outs = [list(r.out) for r in eager]
    same = sum(a == b for ra, rb in zip(outs, eager_outs) for a, b in zip(ra, rb))
    log(f"  run_queue tokens through the prefill and step graphs equal to the eager "
        f"prefill's and loop's: {same} of {sum(len(r) for r in outs)} (greedy)")
    if outs != eager_outs:
        raise AssertionError(f"{name}: graph tokens {outs} != eager tokens {eager_outs}")

    # TTFT at prompt 128: prefill + first-token sampling, CUDA events (host
    # launch gaps included), and the prefill on the device alone
    prompt = prompts[2]
    ttfts = [event_ms(lambda: eng.prefill_sample(0, prompt)) for _ in range(5)]
    ttfts_eager = [event_ms(lambda: eng._prefill_eager(0, prompt)) for _ in range(5)]
    tok = eng.prefill_sample(0, prompt)
    logits = eng.prefill(0, prompt)
    if not (np.isfinite(logits).all() and 0 <= tok < cfg.vocab_size):
        raise AssertionError("prefill logits not finite")
    # TTFT at prompt 1100 (bucket 2048: every projection at M = 2048)
    ttfts_long = [event_ms(lambda: eng.prefill_sample(0, prompts[5])) for _ in range(3)]
    ttfts_long_eager = [event_ms(lambda: eng._prefill_eager(0, prompts[5])) for _ in range(3)]
    dev_ttft = eng.benchmark_prefill_device(n_prompt=PROMPTS[2], iters=8, reps=3) * 1e3
    dev_ttft_long = eng.benchmark_prefill_device(n_prompt=PROMPTS[5], iters=4, reps=3) * 1e3
    # decode tokens/s at batch 4: all lanes active at position ~128
    first = {}
    for sid in range(4):
        first[sid] = eng.prefill_sample(sid, prompt)
    step_logits = eng.decode_step(first)
    if not all(np.isfinite(v).all() for v in step_logits.values()):
        raise AssertionError("decode logits not finite")
    nxt = {sid: int(np.argmax(v)) for sid, v in step_logits.items()}

    def chunk(fn, n, **kw):
        for sid in range(4):
            eng.slots[sid].pos = 129
        return fn(nxt, n, **kw)

    # one seeded sampled chunk: per-row temperatures (one lane at ~0), top-k
    # and top-p, through the graph and through the eager loop
    kw = dict(temperature=np.array([0.8, 1.0, 0.0, 1.3], np.float32), seed=11, top_k=40,
              top_p=0.95)
    got, want = chunk(eng.decode_steps, 16, **kw), chunk(eng._decode_steps_eager, 16, **kw)
    log(f"  seeded sampled chunk (16 steps, temperatures 0.8/1.0/0/1.3, top_k 40, top_p "
        f"0.95): graph tokens equal to the eager loop's: {got == want}")
    if got != want:
        raise AssertionError(f"{name}: sampled graph chunk {got} != eager {want}")
    n_steps, rates = 32, {"graph": [], "eager": []}
    loops = {"graph": eng.decode_steps, "eager": eng._decode_steps_eager}
    for fn in loops.values():
        chunk(fn, n_steps)                  # the key's capture, first calls
    reduces = reduce_launches()
    for order in (("graph", "eager"), ("eager", "graph"), ("graph", "eager")):
        for k in order:
            ms = event_ms(lambda: chunk(loops[k], n_steps))
            rates[k].append(4 * n_steps / (ms / 1e3))
    # the libraries' own qmm_reduce count sees the eager launches only
    reduce_per_step = (reduce_launches() - reduces) / (3 * n_steps)
    tps, tps_eager = statistics.median(rates["graph"]), statistics.median(rates["eager"])
    tps_dev = eng.benchmark_decode_device(iters=64, reps=3)
    one = InferenceEngine(cfg, eng.params, batch=1, quantized_kv=True, device="cuda")
    tps_dev1 = one.benchmark_decode_device(iters=64, reps=3)
    del one
    ttft = statistics.median(ttfts)
    log(f"  {name} TTFT prompt 128 (bucket 128): {ttft:.3f} ms (median of 5, CUDA events "
        f"around prefill_sample through the bucket's prefill graph, host gaps included; "
        f"eager prefill {statistics.median(ttfts_eager):.3f} ms); on the device "
        f"(benchmark_prefill_device, prefill graph, long-minus-short) {dev_ttft:.3f} ms "
        f"[{gpu_line}]")
    log(f"  {name} TTFT prompt {PROMPTS[5]} (bucket 2048): {statistics.median(ttfts_long):.3f} "
        f"ms (median of 3, CUDA events; eager prefill "
        f"{statistics.median(ttfts_long_eager):.3f} ms); on the device {dev_ttft_long:.3f} ms "
        f"[{gpu_line}]")
    log(f"  {name} decode batch 4 at pos ~130: step graph {tps:.2f} tok/s, {4e3 / tps:.3f} "
        f"ms/step; eager loop {tps_eager:.2f} tok/s, {4e3 / tps_eager:.3f} ms/step (median of "
        f"3 x {n_steps} steps each, in turns, CUDA events around decode_steps) [{gpu_line}]")
    log(f"  {name} benchmark_decode_device: batch 4 {tps_dev:.2f} tok/s, batch 1 "
        f"{tps_dev1:.2f} tok/s (64 steps from pos 16, long-minus-short, CUDA events) "
        f"[{gpu_line}]")
    log(f"  {name} qmm_reduce launches per eager decode step: {reduce_per_step:g} (the "
        f"libraries' count over the 3 x {n_steps} eager steps)")
    if tps < tps_eager:
        raise AssertionError(f"{name}: step graph {tps} tok/s below the eager loop's "
                             f"{tps_eager}")
    del eng, loops, decode_steps, counted
    torch.cuda.empty_cache()
    return dict(counts=counts, outs=outs, reduce_per_step=reduce_per_step, prefill_logits=logits,
                step_logits=np.stack([step_logits[sid] for sid in range(4)]), first=first)


def serve_tiny():
    """LlamaConfig.tiny() (head dim 16, GQA 4/2; Q8_0, int8 KV) through the
    engine on the card: two prompts prefilled and four greedy decode steps
    at batch 2, logits of each against the same engine on the CPU (cosine
    >= 0.999; the card fed the CPU's tokens)."""
    import numpy as np
    import torch
    from csinn2_tpu_torch.kernels import launch_counts, reset_launch_counts
    from csinn2_tpu_torch.llm.config import LlamaConfig
    from csinn2_tpu_torch.llm.engine import InferenceEngine
    from csinn2_tpu_torch.llm.model import init_params
    from csinn2_tpu_torch.utils.verify import cosine_similarity
    cfg = LlamaConfig.tiny()
    cpu, gpu = (InferenceEngine(cfg, init_params(cfg, "q8_0", seed=5, device=dv),
                                batch=2, quantized_kv=True, device=dv)
                for dv in ("cpu", "cuda"))
    reset_launch_counts()
    cos, nxt = [], {}
    for sid, prompt in enumerate(([3, 7, 11, 19, 4], list(range(1, 40)))):
        want, got = cpu.prefill(sid, prompt), gpu.prefill(sid, prompt)
        cos.append(cosine_similarity(got, want) if np.isfinite(got).all() else 0.0)
        nxt[sid] = int(np.argmax(want))
    for _ in range(4):
        want, got = cpu.decode_step(nxt), gpu.decode_step(nxt)
        cos += [cosine_similarity(got[i], want[i]) if np.isfinite(got[i]).all()
                else 0.0 for i in nxt]
        nxt = {i: int(np.argmax(want[i])) for i in nxt}
    torch.cuda.synchronize()
    run = dict(launch_counts)
    log(f"  LlamaConfig.tiny() (d=16, GQA 4/2) on the card: 2 prefills + 4 decode steps, "
        f"min logit cosine vs the CPU engine {min(cos):.6f} (gate 0.999); launches {run}")
    if min(cos) < 0.999 or run.get("prefill_attention", 0) == 0 or \
            run.get("decode_attention", 0) == 0:
        raise AssertionError(f"tiny engine on the card: cosine {min(cos)}, launches {run}")


# ---------------------------------------------------------------------------
# phase 7: the CNN path, MobileNetV1 INT8_SYM through the graph session
# ---------------------------------------------------------------------------

def _block_calls(sess, xin):
    """(node, op arguments, graph output) of each ds_block node of `sess` in
    one run on xin (that run's launches are not the main path's)."""
    import torch
    from csinn2_tpu_torch.graph.ir import _const_key
    acts = {}
    with torch.inference_mode():
        sess.graph.execute([xin], sess._consts,
                           trace_hook=lambda node, r: acts.__setitem__(id(node.outputs[0]), r))
    value = lambda t: acts[id(t)] if id(t) in acts else (
        xin if t is sess.graph.inputs[0] else sess._consts[_const_key(t)])
    return [(n, [value(t) for t in n.inputs], acts[id(n.outputs[0])])
            for n in sess.graph.nodes if n.op == "ds_block"]


def check_dsconv_blocks(sess, xin, fwd_ms, gpu_line, label):
    """Each ds_block of `sess`: the kernel against its plain version and the
    unfused pair (bit for bit), timed beside its bound.  Returns (the
    slowest block's record, the blocks' summed time and bound, each block's
    record)."""
    import torch
    from csinn2_tpu_torch.kernels import dsblock as ds
    from csinn2_tpu_torch.utils.timing import gpu_ms
    worst, total, total_bound, blocks = None, 0.0, 0.0, []
    calls = _block_calls(sess, xin)
    for i, (node, arrays, graph_out) in enumerate(calls):
        metas = [t.meta for t in node.inputs]
        args, kw = ds.fused_args(arrays, metas, node.params, node.out_qinfo, **node.extra)
        run = lambda: ds.fused_dsconv(*args, **kw)
        plain_fn = lambda: ds.fused_dsconv_ref(*args, **kw)
        pair_fn = lambda: ds.ds_block_xla(arrays, metas, node.params, node.out_qinfo,
                                          **node.extra)
        y = run()
        torch.cuda.synchronize()
        for name, other in (("graph output", graph_out), ("fused_dsconv_ref", plain_fn()),
                            ("unfused pair", pair_fn())):
            if not torch.equal(y, other):
                n_bad = int((y.int() - other.int()).ne(0).sum())
                raise AssertionError(f"{label} fused_dsconv block {i}: {n_bad} of {y.numel()} "
                                     f"outputs differ from the {name}")
        ms = gpu_ms(run)
        plain = gpu_ms(plain_fn, reps=3)
        lib = gpu_ms(pair_fn, reps=5)
        x, dw_w, effd, bd, pw_w, effp, bp = args
        N, H, W, C = x.shape
        _, Ho, Wo, O = y.shape
        k = kw["k"]
        nbytes = x.numel() + dw_w.numel() + pw_w.numel() + 4 * (2 * C + 2 * O) + y.numel()
        b_ms, b_by = bound(nbytes, N * Ho * Wo * (k * k * C + 2 * C * O), INT8_OPS)
        shape = (f"{label} block {i} ({node.name}) N={N} H={H} W={W} C={C} O={O} k={k} "
                 f"s={kw['stride']} pads={kw['pads']} int8 out")
        log(f"  fused_dsconv {shape}: ms={ms:.4f} plain_ms={plain:.4f} "
            f"unfused_pair_ms={lib:.4f} bound_ms={b_ms:.4f} ({b_by}) roofline={b_ms / ms:.3f}")
        total += ms
        total_bound += b_ms
        rec = dict(ms=ms, plain_ms=plain, library_ms=None, unfused_pair_ms=lib,
                   bound_ms=b_ms, bound_by=b_by, shape=shape, max_abs_err=0.0)
        blocks.append(rec)
        if worst is None or ms > worst["ms"]:
            # no single PyTorch call computes the block: library_ms is null,
            # and the unfused pair stands beside it
            worst = rec
    log(f"  {len(calls)} fused_dsconv launches ({label}): {total:.4f} ms against a summed "
        f"bound of {total_bound:.4f} ms ({total_bound / total:.3f}), of the {fwd_ms:.4f} ms "
        f"fused forward ({100 * total / fwd_ms:.1f} %) [{gpu_line}]")
    return worst, total, total_bound, blocks


def cnn_path(records, gpu_line: str):
    """MobileNetV1 INT8_SYM at 224 through the graph session, fused and
    unfused.  Returns the launch counts of the fused batch-128 forward."""
    import numpy as np
    import torch
    from csinn2_tpu_torch.core.dtypes import QuantScheme
    from csinn2_tpu_torch.core.quant import dequantize
    from csinn2_tpu_torch.kernels import launch_counts, reset_launch_counts
    from csinn2_tpu_torch.models.mobilenet import MobileNetV1
    from csinn2_tpu_torch.utils.verify import cosine_similarity
    t0 = time.perf_counter()
    model = MobileNetV1(alpha=1.0, input_size=224, seed=0)
    rng = np.random.default_rng(0)                       # as bench.py:174-176
    x1 = rng.random(model.input_shape(1)).astype(np.float32)
    xb = rng.random(model.input_shape(CNN_BATCH)).astype(np.float32)
    model.calibrate(x1, device="cuda")
    sess = {}
    for fused in (True, False):
        with env_flag("CSINN2_FUSE_DS", fused), env_flag("CSINN2_NO_FUSE_DS", False):
            for batch in (CNN_BATCH, 1):
                s = model.build_session(QuantScheme.INT8_SYM, batch=batch, device="cuda")
                n_ds = sum(n.op == "ds_block" for n in s.graph.nodes)
                if n_ds != (13 if fused else 0):
                    raise AssertionError(f"fused={fused} batch {batch}: {n_ds} ds_block nodes")
                sess[fused, batch] = s
    xin = {b: model.prepare_input(x, sess[True, b]) for b, x in ((CNN_BATCH, xb), (1, x1))}
    torch.cuda.synchronize()
    log(f"  MobileNetV1 224 calibrated on the card and 4 INT8_SYM sessions built: "
        f"{time.perf_counter() - t0:.2f} s")

    reset_launch_counts()
    torch.cuda.synchronize()
    out = {(True, CNN_BATCH): sess[True, CNN_BATCH].run(xin[CNN_BATCH])}
    torch.cuda.synchronize()
    counts = dict(launch_counts)
    log(f"  fused forward, batch {CNN_BATCH}: launches {counts}")
    if counts.get("fused_dsconv", 0) != 13:
        raise AssertionError(f"fused forward launched fused_dsconv "
                             f"{counts.get('fused_dsconv', 0)} times, want 13")
    for key in ((False, CNN_BATCH), (True, 1), (False, 1)):
        before = launch_counts["fused_dsconv"]
        out[key] = sess[key].run(xin[key[1]])
        torch.cuda.synchronize()
        if launch_counts["fused_dsconv"] - before != (13 if key[0] else 0):
            raise AssertionError(f"session {key}: fused_dsconv launches")
    for b in (CNN_BATCH, 1):
        f, u = out[True, b], out[False, b]
        if f.dtype != torch.int8 or tuple(f.shape) != (b, 1000) or not torch.equal(f, u):
            raise AssertionError(f"batch {b}: fused logits differ from unfused in "
                                 f"{int(f.int().ne(u.int()).sum())} of {u.numel()}")
    log(f"  fused int8 logits == unfused, bit for bit, at batch {CNN_BATCH} and 1")

    with env_flag("CSINN2_FUSE_DS", True):
        s_cpu = model.build_session(QuantScheme.INT8_SYM, batch=1, device="cpu")
    cpu = s_cpu.run(model.prepare_input(x1, s_cpu)).numpy().astype(int)
    d = np.abs(cpu - out[True, 1].cpu().numpy().astype(int))
    log(f"  batch 1, card vs the port's CPU plain path (same recorder): max|d|={d.max()} "
        f"LSB, {int((d > 0).sum())} of {d.size} logits differ (fc float-carrier sums)")
    if d.max() > 1:
        raise AssertionError(f"card vs CPU plain path: {d.max()} LSB")
    golden = model.forward_f32(x1, device="cuda").cpu().numpy()
    qi = sess[True, 1].graph.outputs[0].meta.qinfo
    deq = dequantize(out[True, 1].cpu(), qi).numpy()
    cos = cosine_similarity(deq, golden)
    log(f"  cosine(int8 fused batch 1 dequantized, forward_f32) = {cos:.6f} (gate 0.99)")
    if not (np.isfinite(golden).all() and cos >= 0.99):
        raise AssertionError(f"accuracy gate: cosine {cos}")

    times = {}
    for fused in (True, False, False, True):
        for b, iters in ((CNN_BATCH, 10), (1, 50)):
            t = sess[fused, b].run_benchmark_device(xin[b], iters=iters, reps=3)
            times.setdefault((fused, b), []).append(t)
    for fused in (True, False):
        t128 = statistics.median(times[fused, CNN_BATCH])
        t1 = statistics.median(times[fused, 1])
        log(f"  {'fused  ' if fused else 'unfused'}: batch {CNN_BATCH} {CNN_BATCH / t128:.1f} "
            f"img/s ({t128 * 1e3:.3f} ms/forward), batch 1 latency {t1 * 1e3:.3f} ms "
            f"(CUDA events, median of 2x3 x {{10, 50}} runs, host gaps included) [{gpu_line}]")
    # the phase's launches since the main path's reset, before the per-block
    # comparisons (13 a fused forward)
    phase = launch_counts["fused_dsconv"]
    log(f"  fused_dsconv launches over the phase's sessions and timings: {phase} "
        f"({phase // 13} fused forwards of 13)")
    worst, total, total_bound, _ = check_dsconv_blocks(
        sess[True, CNN_BATCH], xin[CNN_BATCH], statistics.median(times[True, CNN_BATCH]) * 1e3,
        gpu_line, f"MobileNetV1 batch {CNN_BATCH}")
    records["fused_dsconv"] = dict(worst, blocks_ms=total, blocks_bound_ms=total_bound,
                                   launches_phase=phase)
    del sess, out
    torch.cuda.empty_cache()
    return counts


# ---------------------------------------------------------------------------
# phase 16: the rest of the CNN zoo, MobileNetV2-u8, MobileNetV3, ResNet-50
# ---------------------------------------------------------------------------

# (model class, scheme, ds_block pairs fused at INT8_SYM under CSINN2_FUSE_DS=1)
ZOO = (("MobileNetV2", "UINT8_ASYM", 7), ("MobileNetV3", "INT8_SYM", 1),
       ("ResNet50", "INT8_SYM", None))


def _zoo_model(name: str, **kw):
    from csinn2_tpu_torch.models.mobilenet import MobileNetV2, MobileNetV3
    from csinn2_tpu_torch.models.resnet import ResNet50
    return {"MobileNetV2": MobileNetV2, "MobileNetV3": MobileNetV3,
            "ResNet50": ResNet50}[name](input_size=224, **kw)


def _device_times(sess, x, budget_s: float = 1.5):
    """run_benchmark_device with enough runs for about budget_s a rep
    (seconds a forward, median of 3 reps)."""
    import torch
    from csinn2_tpu_torch.utils.timing import event_ms
    sess.run(x)
    torch.cuda.synchronize()
    one = event_ms(lambda: sess.run(x)) / 1e3
    iters = max(2, min(50, int(budget_s / max(one, 1e-4))))
    return sess.run_benchmark_device(x, iters=iters, reps=3), iters


def zoo_model_path(name: str, scheme_name: str, gpu_line: str):
    """Phase 16 (a) for one model; returns (the model, its record)."""
    import numpy as np
    import torch
    from csinn2_tpu_torch.core.dtypes import QuantScheme
    from csinn2_tpu_torch.core.quant import dequantize
    from csinn2_tpu_torch.utils.verify import cosine_similarity
    t0 = time.perf_counter()
    scheme = QuantScheme[scheme_name]
    model = _zoo_model(name, seed=0)
    rng = np.random.default_rng(0)                       # as bench.py:174-176
    x1 = rng.random(model.input_shape(1)).astype(np.float32)
    xb = rng.random(model.input_shape(CNN_BATCH)).astype(np.float32)
    model.calibrate(x1, device="cuda")
    with env_flag("CSINN2_FUSE_DS", False):
        sess = {b: model.build_session(scheme, batch=b, device="cuda") for b in (CNN_BATCH, 1)}
    xin = {CNN_BATCH: model.prepare_input(xb, sess[CNN_BATCH]),
           1: model.prepare_input(x1, sess[1])}
    out1 = sess[1].run(xin[1])
    outb = sess[CNN_BATCH].run(xin[CNN_BATCH])
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    if out1.dtype != torch.int8 or tuple(out1.shape) != (1, 1000) \
            or tuple(outb.shape) != (CNN_BATCH, 1000):
        raise AssertionError(f"{name}: outputs {out1.dtype} {tuple(out1.shape)} "
                             f"{tuple(outb.shape)}")
    # the accuracy gate of bench.py:151-165, on the session's own output qinfo
    golden = model.forward_f32(x1, device="cuda").cpu().numpy()
    qi = sess[1].graph.outputs[0].meta.qinfo
    cos = cosine_similarity(dequantize(out1.cpu(), qi).numpy(), golden)
    log(f"  {name} {scheme_name} 224: cosine(batch-1 logits dequantized, forward_f32) = "
        f"{cos:.6f} (gate 0.99); in qinfo {sess[1].input_qinfo.dtype.value} "
        f"zp {sess[1].input_qinfo.zero_point}, out qinfo zp {qi.zero_point}")
    if not (np.isfinite(golden).all() and cos >= 0.99):
        raise AssertionError(f"{name}: accuracy gate: cosine {cos}")
    # the card against the port's CPU plain path, one recorder
    s_cpu = model.build_session(scheme, batch=1, device="cpu")
    cpu = s_cpu.run(model.prepare_input(x1, s_cpu)).numpy().astype(int)
    d = np.abs(cpu - out1.cpu().numpy().astype(int))
    log(f"  {name}: batch 1, card vs the port's CPU plain path (same recorder): "
        f"max|d|={d.max()} LSB, {int((d > 0).sum())} of {d.size} logits differ")
    if d.max() > 1:
        raise AssertionError(f"{name}: card vs CPU plain path: {d.max()} LSB")
    del s_cpu
    tb, itb = _device_times(sess[CNN_BATCH], xin[CNN_BATCH])
    t1, it1 = _device_times(sess[1], xin[1])
    log(f"  {name} {scheme_name}: batch {CNN_BATCH} {CNN_BATCH / tb:.1f} img/s "
        f"({tb * 1e3:.3f} ms/forward, {itb} runs a rep), batch 1 latency {t1 * 1e3:.3f} ms "
        f"({it1} runs a rep) (run_benchmark_device: CUDA events, median of 3 reps, host gaps "
        f"included), {len(sess[1].graph.nodes)} nodes; setup {setup_s:.1f} s [{gpu_line}]")
    rec = dict(scheme=scheme_name, cosine=cos, card_vs_cpu_max_lsb=int(d.max()),
               card_vs_cpu_n_diff=int((d > 0).sum()), imgs_per_s=CNN_BATCH / tb,
               ms_batch128=tb * 1e3, latency_ms_batch1=t1 * 1e3, nodes=len(sess[1].graph.nodes),
               gpu=gpu_line)
    del sess, xin, outb
    torch.cuda.empty_cache()
    return model, rec


def resnet_layout_parity(gpu_line: str):
    """Phase 16 (b): ResNet-50 NCHW against NHWC at batch 1, seed 5."""
    import numpy as np
    import torch
    from csinn2_tpu_torch.core.dtypes import Layout, QuantScheme
    from csinn2_tpu_torch.utils.verify import verify
    m1 = _zoo_model("ResNet50", layout=Layout.NHWC, seed=5)
    m2 = _zoo_model("ResNet50", layout=Layout.NCHW, seed=5)
    x = np.random.default_rng(11).random((1, 224, 224, 3)).astype(np.float32)
    xc = np.ascontiguousarray(np.transpose(x, (0, 3, 1, 2)))
    o1 = m1.forward_f32(x, device="cuda").cpu().numpy()
    o2 = m2.forward_f32(xc, device="cuda").cpu().numpy()
    r = verify(o2, o1, tol=1e-3)
    m1.calibrate(x, device="cuda")
    m2.recorder.ranges = dict(m1.recorder.ranges)
    q = []
    for m, xi in ((m1, x), (m2, xc)):
        s = m.build_session(QuantScheme.INT8_SYM, batch=1, device="cuda")
        q.append(s.run(m.prepare_input(xi, s)).cpu())
    same = torch.equal(q[0], q[1])
    log(f"  ResNet-50 224 seed 5, NCHW vs NHWC: forward_f32 {r} ; INT8_SYM logits on one "
        f"recorder {'equal bit for bit' if same else 'DIFFER'}")
    if not (r.passed and same):
        raise AssertionError(f"ResNet-50 layout parity: {r}, int8 equal {same}")
    torch.cuda.empty_cache()
    return dict(f32_max_abs=float(r.max_abs_err), f32_cosine=float(r.cosine_sim), int8_equal=same)


def zoo_fused_path(model, name: str, pairs: int, gpu_line: str):
    """Phase 16 (c) for one calibrated model: INT8_SYM fused and unfused.
    Returns (the fused batch-128 forward's launch counts, its record)."""
    import torch
    import numpy as np
    from csinn2_tpu_torch.core.dtypes import QuantScheme
    from csinn2_tpu_torch.kernels import launch_counts, reset_launch_counts
    rng = np.random.default_rng(0)
    rng.random(model.input_shape(1))
    xb = rng.random(model.input_shape(CNN_BATCH)).astype(np.float32)
    x1 = np.random.default_rng(0).random(model.input_shape(1)).astype(np.float32)
    sess = {}
    for fused in (True, False):
        with env_flag("CSINN2_FUSE_DS", fused), env_flag("CSINN2_NO_FUSE_DS", False):
            for b in (CNN_BATCH, 1):
                s = model.build_session(QuantScheme.INT8_SYM, batch=b, device="cuda")
                n_ds = sum(n.op == "ds_block" for n in s.graph.nodes)
                if n_ds != (pairs if fused else 0):
                    raise AssertionError(f"{name} fused={fused} batch {b}: {n_ds} ds_block "
                                         f"nodes, want {pairs if fused else 0}")
                sess[fused, b] = s
    xin = {CNN_BATCH: model.prepare_input(xb, sess[True, CNN_BATCH]),
           1: model.prepare_input(x1, sess[True, 1])}
    torch.cuda.synchronize()
    reset_launch_counts()
    torch.cuda.synchronize()
    out = {(True, CNN_BATCH): sess[True, CNN_BATCH].run(xin[CNN_BATCH])}
    torch.cuda.synchronize()
    counts = dict(launch_counts)
    log(f"  {name} INT8_SYM fused forward, batch {CNN_BATCH}: launches {counts}")
    if counts.get("fused_dsconv", 0) != pairs:
        raise AssertionError(f"{name}: the fused forward launched fused_dsconv "
                             f"{counts.get('fused_dsconv', 0)} times, want {pairs}")
    for key in ((False, CNN_BATCH), (True, 1), (False, 1)):
        out[key] = sess[key].run(xin[key[1]])
    torch.cuda.synchronize()
    for b in (CNN_BATCH, 1):
        f, u = out[True, b], out[False, b]
        if f.dtype != torch.int8 or tuple(f.shape) != (b, 1000) or not torch.equal(f, u):
            raise AssertionError(f"{name} batch {b}: fused logits differ from unfused in "
                                 f"{int(f.int().ne(u.int()).sum())} of {u.numel()}")
    log(f"  {name}: {pairs} ds_block nodes; fused int8 logits == unfused, bit for bit, at "
        f"batch {CNN_BATCH} and 1")
    t_f, _ = _device_times(sess[True, CNN_BATCH], xin[CNN_BATCH], budget_s=0.5)
    t_u, _ = _device_times(sess[False, CNN_BATCH], xin[CNN_BATCH], budget_s=0.5)
    log(f"  {name} INT8_SYM batch {CNN_BATCH}: fused {t_f * 1e3:.3f} ms/forward, unfused "
        f"{t_u * 1e3:.3f} [{gpu_line}]")
    worst, total, total_bound, blocks = check_dsconv_blocks(
        sess[True, CNN_BATCH], xin[CNN_BATCH], t_f * 1e3, gpu_line, f"{name} batch {CNN_BATCH}")
    rec = dict(pairs=pairs, launches=int(counts.get("fused_dsconv", 0)),
               fused_ms=t_f * 1e3, unfused_ms=t_u * 1e3, blocks_ms=total,
               blocks_bound_ms=total_bound, blocks=blocks)
    del sess, out, xin
    torch.cuda.empty_cache()
    return counts, rec


def cnn_zoo_path(records, gpu_line: str):
    """Phase 16.  Returns ({model: the fused forward's launch counts}, the
    phase's summary)."""
    t0 = time.perf_counter()
    summary, zoo_counts, zoo_blocks = {}, {}, {}
    for name, scheme, pairs in ZOO:
        model, summary[name] = zoo_model_path(name, scheme, gpu_line)
        if pairs is not None:
            zoo_counts[name], zoo_blocks[name] = zoo_fused_path(model, name, pairs, gpu_line)
        del model
    summary["resnet50_layout_parity"] = resnet_layout_parity(gpu_line)
    records["fused_dsconv"]["zoo"] = zoo_blocks
    summary["seconds"] = time.perf_counter() - t0
    log(f"  phase 16: {summary['seconds']:.1f} s")
    return zoo_counts, summary


# ---------------------------------------------------------------------------
# phase 17: the streaming-ASR path (DFSMN) and the op zoo
# ---------------------------------------------------------------------------

# examples/dfsmn_stream.py:29-41: the model, utterance and chunk
DFSMN_CFG = dict(feat_dim=80, hidden=512, proj=256, blocks=6, l_order=10, r_order=2,
                 classes=218)
DFSMN_FRAMES, DFSMN_CHUNK, DFSMN_STREAMS = 256, 8, 64


def _streamed(model, x, chunk):
    """Logits of x [b, T, feat] streamed chunk by chunk, the flush included."""
    import torch
    st = model.stream(batch=x.shape[0], chunk=chunk)
    outs = [st.step(x[:, i:i + chunk]) for i in range(0, x.shape[1], chunk)]
    return torch.cat(outs + [st.flush()], dim=1).cpu().numpy(), st.delay


def dfsmn_path(here: Path, gpu_line: str):
    """Phase 17 (a).  Returns its record for the kernels line."""
    import numpy as np
    import torch
    from csinn2_tpu_torch.models.dfsmn_asr import DFSMNASR, DFSMNConfig
    from csinn2_tpu_torch.utils.memstats import device_memory_stats
    from csinn2_tpu_torch.utils.verify import cosine_similarity
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = device_memory_stats()["bytes_in_use"]
    cfg = DFSMNConfig(**DFSMN_CFG)
    T, C = DFSMN_FRAMES, DFSMN_CHUNK
    x = np.random.default_rng(0).standard_normal((1, T, cfg.feat_dim)).astype(np.float32)
    card = DFSMNASR(cfg, seed=0, device="cuda")
    offline = card.offline_session(1, T).run(x).cpu().numpy()
    streamed, delay = _streamed(card, x, C)
    lo, hi = cfg.blocks * cfg.l_span, T - cfg.blocks * cfg.r_span
    got, want = streamed[:, delay + lo:delay + hi], offline[:, lo:hi]
    cos, err = cosine_similarity(got, want), float(np.max(np.abs(got - want)))
    log(f"  DFSMN {DFSMN_CFG}, seed 0, on the card: offline [1, {T}, 80] and streamed in "
        f"chunks of {C} (delay {delay} frames): interior frames {lo}..{hi}: cosine {cos:.7f}, "
        f"max|d| {err:.3e} (gates > 0.9999, < 1e-3)")
    if not (np.isfinite(offline).all() and cos > 0.9999 and err < 1e-3):
        raise AssertionError(f"DFSMN streamed vs offline: cosine {cos}, max|d| {err}")
    cpu = DFSMNASR(cfg, seed=0, device="cpu")
    cpu_logits = {"offline": cpu.offline_session(1, T).run(x).numpy(),
                  "streamed": _streamed(cpu, x, C)[0]}
    d_off, d_str = (float(np.max(np.abs(a - cpu_logits[k])))
                    for k, a in (("offline", offline), ("streamed", streamed)))
    log(f"  card vs the port's CPU plain path: offline max|d| {d_off:.3e}, streamed max|d| "
        f"{d_str:.3e} (rtol = atol = 2e-4)")
    for name, a in (("offline", offline), ("streamed", streamed)):
        if not np.allclose(a, cpu_logits[name], rtol=2e-4, atol=2e-4):
            raise AssertionError(f"DFSMN {name}: card vs the CPU plain path max|d| "
                                 f"{np.max(np.abs(a - cpu_logits[name]))}")
    rec = dict(config=DFSMN_CFG, frames=T, chunk=C, delay_frames=delay,
               stream_vs_offline_cosine=cos, stream_vs_offline_max_abs=err,
               card_vs_cpu_offline_max_abs=d_off, card_vs_cpu_streamed_max_abs=d_str,
               gpu=gpu_line)
    for b in (1, DFSMN_STREAMS):
        st = card.stream(batch=b, chunk=C)
        xb = np.random.default_rng(1).standard_normal((b, C, cfg.feat_dim)).astype(np.float32)
        dt = st.sess.run_benchmark_device(xb, *st.state, iters=50, reps=3)
        rec[f"batch{b}"] = dict(chunk_ms=dt * 1e3, frames_per_s=b * C / dt,
                                nodes=len(st.sess.graph.nodes))
        log(f"  DFSMN streaming step, batch {b}: {dt * 1e3:.3f} ms a chunk of {C} frames, "
            f"{b * C / dt:,.0f} frames/s (run_benchmark_device: CUDA events around 50 "
            f"back-to-back steps, median of 3 reps, host gaps included), "
            f"{len(st.sess.graph.nodes)} graph nodes [{gpu_line}]")
    stats = device_memory_stats()
    rec.update(peak_bytes=stats["peak_bytes_in_use"], bytes_before=base)
    log(f"  peak device memory over the phase: {stats['peak_bytes_in_use'] / 2**20:.1f} MiB "
        f"(memstats.device_memory_stats, {base / 2**20:.1f} MiB in use before it)")
    t1 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "csinn2_tpu_torch.examples.dfsmn_stream"],
                       cwd=here, capture_output=True, text=True, timeout=300)
    lines = [line.strip() for line in r.stdout.splitlines()]
    for line in lines:
        log(f"  | {line}")
    log(f"  dfsmn_stream: exit {r.returncode}, {time.perf_counter() - t1:.1f} s")
    if r.returncode != 0 or "PASS" not in lines:
        raise AssertionError(f"phase 17 dfsmn_stream: exit {r.returncode}\n{r.stderr[-4000:]}")
    rec["seconds"] = time.perf_counter() - t0
    del card, cpu
    torch.cuda.empty_cache()
    return rec


def op_zoo_path():
    """Phase 17 (b).  Returns its record for the kernels line."""
    from csinn2_tpu_torch.examples import op_zoo
    t0 = time.perf_counter()
    op_zoo.run("cuda", log=lambda line: log(f"  {line}"))
    return dict(cases=len(op_zoo.CASES), ops=len({op_zoo.case_op(n) for n in op_zoo.CASES}),
                seconds=time.perf_counter() - t0)


# ---------------------------------------------------------------------------
# phase 18: the rest of the runtime — HYBRID partitioning, save / load, the
# profiler levels, the roofline, the data loader, the CLI
# ---------------------------------------------------------------------------

RUNTIME_SAMPLES = 256          # (d): 256 seeded 224x224x3 f32 samples, 154 MB

# (b) and (c), in a process of its own: load each saved directory (twice, the
# second round timed), run it once on the saved input and count its
# fused_dsconv launches; then torch.profiler around one fused forward, then
# the two CNN examples.  Apart from the parent, since host launches stay
# slower in a process that torch.profiler has traced.
RUNTIME_CHILD = r"""
import json, subprocess, sys, time
sys.path.insert(0, sys.argv[1])
import numpy as np, torch
from csinn2_tpu_torch.kernels import launch_counts, reset_launch_counts
from csinn2_tpu_torch.runtime.export import load_model
from csinn2_tpu_torch.runtime.profiler import device_trace, kernel_times
d = sys.argv[2]
x = torch.from_numpy(np.load(d + "/input.npy")).cuda()
want = torch.from_numpy(np.load(d + "/expected.npy"))
loads = {}
for name in ("model", "model_aot") * 2:
    t0 = time.perf_counter()
    sess = load_model(d + "/" + name, device="cuda")
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t0
    reset_launch_counts()
    got = sess.run(x)
    torch.cuda.synchronize()
    loads[name] = dict(load_s=t_load, fused_dsconv=int(launch_counts["fused_dsconv"]),
                       bit_for_bit=bool(torch.equal(got.cpu(), want)),
                       nodes=len(sess.graph.nodes))
print(json.dumps({"loads": loads}), flush=True)
with device_trace(d + "/trace") as path:
    sess.run(x)
kt = kernel_times(path)
print(json.dumps({"kernels": list(kt.items())[:5], "n_names": len(kt),
                  "kernel_ms": sum(kt.values()),
                  "dsconv": [k for k in kt if "dsconv_kernel" in k]}), flush=True)
for args in (("mobilenet_int8", "--size", "224"), ("deploy_save_load", "--size", "224", "--aot")):
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "csinn2_tpu_torch.examples." + args[0], *args[1:]],
                       cwd=sys.argv[1], capture_output=True, text=True, timeout=600)
    print(json.dumps({"example": " ".join(args), "rc": r.returncode, "stdout": r.stdout,
                      "stderr": r.stderr[-3000:], "seconds": time.perf_counter() - t0}),
          flush=True)
"""


def hybrid_path(gpu_line):
    """Phase 18 (a): phase 8's op-API graph (Q8_0 block weights of one
    Llama-2-7B layer made on the card, M = 128) with wo under
    device_scope("host") and w13 fed by its output, as a HYBRID session
    against the same graph in a GRAPH session on the card.  Returns (the
    launch counts of one HYBRID run, its record)."""
    import numpy as np
    import torch
    from csinn2_tpu_torch import ops
    from csinn2_tpu_torch.core.dtypes import Dtype, RunMode
    from csinn2_tpu_torch.core.tensor import TensorMeta
    from csinn2_tpu_torch.kernels import launch_counts, reset_launch_counts
    from csinn2_tpu_torch.runtime.session import Session
    from csinn2_tpu_torch.utils.verify import cosine_similarity
    g = torch.Generator(device="cuda")
    g.manual_seed(18)
    weights = {name: _block_tensor(g, "q8_0", N, K) for name, N, K in LAYER_FCS}
    M = 128
    xs = [torch.randn((M, K), generator=g, device="cuda") for K in (4096, 11008)]

    def build(mode):
        sess = Session(run_mode=mode, device="cuda")
        with sess.build():
            x4096, x11008 = (sess.input(TensorMeta(shape=tuple(x.shape), dtype=Dtype.FLOAT32))
                             for x in xs)
            q = ops.fullyconnected(x4096, weights["wqkv"])
            with sess.device_scope("host"):          # a tag only, in GRAPH mode
                o = ops.fullyconnected(x4096, weights["wo"])
            u = ops.fullyconnected(o, weights["w13"])
            d = ops.fullyconnected(x11008, weights["w2"])
            sess.set_output(q, o, u, d)
        return sess.setup()

    hyb, ref = build(RunMode.HYBRID), build(RunMode.GRAPH)
    subs = hyb._hybrid.subgraphs
    if [s.device for s in subs] != ["accel", "host", "accel"]:
        raise AssertionError(f"phase 18 (a) partition: {subs}")
    home = {id(t): "accel" for t in hyb.graph.inputs}
    for s in subs:
        for n in s.nodes:
            for t in n.outputs:
                home[id(t)] = s.device
    cut = []
    for i, s in enumerate(subs):
        moved = sum(t.meta.byte_size for t in s.ext_inputs if home[id(t)] != s.device)
        cut.append(moved)
        log(f"  subgraph {i} on {s.device} ({'cpu' if s.device == 'host' else 'cuda'}): "
            f"{[f'{n.name}:{n.cb_name}' for n in s.nodes]}, {len(s.ext_inputs)} inputs "
            f"({moved / 2**20:.2f} MiB moved in across devices), {len(s.outputs)} outputs, "
            f"{len(s.const_keys)} constants placed there")
    env = {id(t): x for t, x in zip(hyb.graph.inputs, xs)}
    per_sub = []
    for s in subs:
        reset_launch_counts()
        hyb._hybrid.run_subgraph(s, env)
        torch.cuda.synchronize()
        n = launches(launch_counts, "quant_matmul_t")
        per_sub.append(n)
        if n != (0 if s.device == "host" else len(s.nodes)):
            raise AssertionError(f"phase 18 (a) {s}: quant_matmul_t launched {n} times: "
                                 f"{dict(launch_counts)}")
    log(f"  quant_matmul_t launches by subgraph: {per_sub} (the host's on the CPU tier)")
    reset_launch_counts()
    torch.cuda.synchronize()
    outs = hyb.run(*xs, unwrap=False)
    torch.cuda.synchronize()
    counts = dict(launch_counts)
    want = ref.run(*xs, unwrap=False)
    cos = []
    for (name, _, _), o, w in zip(LAYER_FCS, outs, want):
        c = cosine_similarity(o.float().cpu().numpy(), w.float().cpu().numpy())
        cos.append(c)
        if not (np.isfinite(c) and c >= 0.9999):
            raise AssertionError(f"phase 18 (a) {name}: HYBRID vs GRAPH cosine {c}")
    log(f"  HYBRID vs GRAPH on the card, outputs wqkv, wo (host), w13 (fed by the host), w2: "
        f"cosine {[f'{c:.6f}' for c in cos]} (phase 8's gate 0.9999); launches {counts}")
    t_h = hyb.run_benchmark_device(*xs, iters=5, reps=3)
    t_g = ref.run_benchmark_device(*xs, iters=10, reps=3)
    log(f"  one run: HYBRID {t_h * 1e3:.3f} ms vs GRAPH {t_g * 1e3:.3f} ms (CUDA events "
        f"around whole runs, the host subgraph's copies and CPU work inside) [{gpu_line}]")
    rec = dict(subgraphs=[s.device for s in subs], cut_bytes=cut,
               quant_matmul_t_by_subgraph=per_sub, cosine=cos, hybrid_ms=t_h * 1e3,
               graph_ms=t_g * 1e3, gpu=gpu_line)
    del hyb, ref, weights, outs, want
    torch.cuda.empty_cache()
    return counts, rec


def mobilenet_runtime_path(tmp: Path, gpu_line: str):
    """Phase 18 (b) and (d): MobileNetV1 INT8_SYM at 224, batch 128, fused
    (13 ds_block nodes).  Returns (the launch counts of its forward, its
    record)."""
    import numpy as np
    import torch
    from csinn2_tpu_torch.core.dtypes import QuantScheme
    from csinn2_tpu_torch.kernels import launch_counts, reset_launch_counts
    from csinn2_tpu_torch.models.mobilenet import MobileNetV1
    from csinn2_tpu_torch.runtime.dataloader import DataLoader, write_archive
    from csinn2_tpu_torch.runtime.export import save_model
    from csinn2_tpu_torch.runtime.roofline import analyze
    model = MobileNetV1(alpha=1.0, input_size=224, seed=0)
    rng = np.random.default_rng(0)
    x1 = rng.random(model.input_shape(1)).astype(np.float32)
    data = rng.random((RUNTIME_SAMPLES, 224, 224, 3), dtype=np.float32)
    model.calibrate(x1, device="cuda")
    with env_flag("CSINN2_FUSE_DS", True), env_flag("CSINN2_NO_FUSE_DS", False):
        sess = model.build_session(QuantScheme.INT8_SYM, batch=CNN_BATCH, device="cuda")
    if sum(n.op == "ds_block" for n in sess.graph.nodes) != 13:
        raise AssertionError("phase 18 (b): not 13 ds_block nodes")
    xin = model.prepare_input(data[:CNN_BATCH], sess)
    reset_launch_counts()
    torch.cuda.synchronize()
    out = sess.run(xin)
    torch.cuda.synchronize()
    counts = dict(launch_counts)
    if counts.get("fused_dsconv", 0) != 13:
        raise AssertionError(f"phase 18 (b) forward launches {counts}")
    rec = {"gpu": gpu_line}

    # save (weights.npz, and the placed constants) for the child to reload
    t0 = time.perf_counter()
    save_model(sess, str(tmp / "model"))
    save_model(sess, str(tmp / "model_aot"), aot=True)
    t_save = time.perf_counter() - t0
    np.save(tmp / "input.npy", xin.cpu().numpy())
    np.save(tmp / "expected.npy", out.cpu().numpy())
    log(f"  save_model, without and with the placed constants: {t_save:.2f} s (host clock)")
    doc = json.loads(sess.export_json())
    if len(doc["nodes"]) != len(sess.graph.nodes) or doc["format"] != "csinn2_tpu-graph-v1":
        raise AssertionError("phase 18 (b) export_json")
    log(f"  export_json: {len(doc['nodes'])} nodes, {len(doc['tensors'])} tensors")

    # the whole forward, the per-layer split, the roofline
    t_fwd = sess.run_benchmark_device(xin, iters=20, reps=3)
    layers = sess.run_layer_benchmark(xin, iters=20)
    total = sum(layers.values())
    blocks = sum(ms for k, ms in layers.items() if "+" in k)
    log(f"  forward {t_fwd * 1e3:.3f} ms at batch {CNN_BATCH} ({CNN_BATCH / t_fwd:.1f} img/s; "
        f"run_benchmark_device) [{gpu_line}]")
    log(f"  run_layer_benchmark (each node alone, CUDA events, long minus short over 20 "
        f"calls): sum {total:.4f} ms = {100 * total / (t_fwd * 1e3):.1f} % of the forward; the "
        f"13 fused blocks {blocks:.4f} ms ({100 * blocks / total:.1f} % of the sum); slowest ten:")
    for k, ms in sorted(layers.items(), key=lambda kv: -kv[1])[:10]:
        log(f"    {k:<24} {ms:.4f} ms")
    rf = analyze(sess)
    log(f"  roofline.analyze (H100 SXM: 3.35 TB/s, {rf.peak_tops:.0f} TOP/s int8): fused "
        f"{rf.fused_sol_s * 1e3:.4f} ms, unfused {rf.unfused_sol_s * 1e3:.4f} ms (the eager "
        f"replay's floor) against the measured {t_fwd * 1e3:.3f} ms "
        f"({100 * rf.unfused_sol_s / t_fwd:.1f} % of the unfused bound); "
        f"{rf.total_flops / 1e9:.2f} GOP a forward")
    rec.update(forward_ms=t_fwd * 1e3, layers_ms=layers, layers_sum_ms=total,
               blocks_ms=blocks, roofline_fused_ms=rf.fused_sol_s * 1e3,
               roofline_unfused_ms=rf.unfused_sol_s * 1e3, gop=rf.total_flops / 1e9)

    # DUMP: every node's output; the last file is the output
    written = sess.dump_outputs(xin, out_dir=str(tmp / "dump"))
    last = np.load(tmp / "dump" / sorted(written)[-1])
    if not np.array_equal(last, out.cpu().numpy()):
        raise AssertionError("phase 18 (b): the last dump differs from the output")
    log(f"  dump_outputs: {len(written)} files, the last equal to the output")
    rec["dump_files"] = len(written)

    # (d) the data loader feeding the batch-128 session
    arch = tmp / "samples.f32"
    write_archive(str(arch), data)
    n_img = 0
    with DataLoader(str(arch), (224, 224, 3), batch=CNN_BATCH, loop=True,
                    prefetch_depth=2) as dl:
        first = dl.next()
        if not np.array_equal(first, data[:CNN_BATCH]):
            raise AssertionError("phase 18 (d): the loader's first batch")
        if not torch.equal(sess.run(model.prepare_input(first, sess)), out):
            raise AssertionError("phase 18 (d): the loader-fed forward differs")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(8):
            b = dl.next()
            sess.run(model.prepare_input(b, sess))
            n_img += b.shape[0]
        torch.cuda.synchronize()
        t_fed = time.perf_counter() - t0
    log(f"  DataLoader ({RUNTIME_SAMPLES} samples, {arch.stat().st_size / 1e6:.0f} MB, loop, "
        f"prefetch 2) feeding the session: {n_img / t_fed:.1f} img/s over {n_img} images "
        f"(host clock, the host-to-device copy and quantize included) vs "
        f"{CNN_BATCH / t_fwd:.1f} img/s on the resident input [{gpu_line}]")
    rec.update(loader_img_s=n_img / t_fed, resident_img_s=CNN_BATCH / t_fwd)
    del sess, out, xin, data
    torch.cuda.empty_cache()
    return counts, rec


def runtime_path(here: Path, gpu_line: str):
    """Phase 18.  Returns (the HYBRID run's launch counts, the fused
    forward's, the phase's record)."""
    import shutil
    import tempfile
    import torch
    t0 = time.perf_counter()
    rec, parts = {}, {}
    log("  (a) HYBRID at Llama-2-7B width (Q8_0, M = 128), wo on the host")
    hyb_counts, rec["hybrid"] = hybrid_path(gpu_line)
    parts["a"] = time.perf_counter() - t0
    tmp = Path(tempfile.mkdtemp(prefix="csinn2_phase18_"))
    try:
        log(f"  (b) MobileNetV1 INT8_SYM 224, batch {CNN_BATCH}, CSINN2_FUSE_DS=1: save, "
            "export_json, the layer benchmark, the roofline, DUMP; (d) the data loader")
        t1 = time.perf_counter()
        cnn_counts, rec["mobilenet"] = mobilenet_runtime_path(tmp, gpu_line)
        parts["b_d"] = time.perf_counter() - t1
        log("  (b) and (c) in a process of its own: load_model of both directories, then "
            "device_trace around one fused forward, then mobilenet_int8 --size 224 and "
            "deploy_save_load --size 224 --aot")
        t1 = time.perf_counter()
        with env_flag("CSINN2_FUSE_DS", True):
            r = subprocess.run([sys.executable, "-c", RUNTIME_CHILD, str(here), str(tmp)],
                               cwd=here, capture_output=True, text=True, timeout=900)
        if r.returncode != 0:
            raise AssertionError(f"phase 18 child: exit {r.returncode}\n{r.stdout[-2000:]}\n"
                                 f"{r.stderr[-4000:]}")
        lines = [json.loads(line) for line in r.stdout.strip().splitlines()]
        loads, trace = lines[0]["loads"], lines[1]
        log(f"  load_model in a fresh process (the second of two rounds timed, host clock): "
            f"{loads}")
        for name, v in loads.items():
            if not (v["bit_for_bit"] and v["fused_dsconv"] == 13):
                raise AssertionError(f"phase 18 (b) reload {name}: {v}")
        rec["load"] = loads
        log(f"  trace: {trace['n_names']} kernel names, {trace['kernel_ms']:.3f} ms of kernels "
            f"in one forward; top five by device time:")
        for name, ms in trace["kernels"]:
            log(f"    {ms:.4f} ms  {name[:110]}")
        if not trace["dsconv"]:
            raise AssertionError("phase 18 (c): no dsconv_kernel in the trace")
        rec["trace"] = dict(top5=trace["kernels"], kernel_ms=trace["kernel_ms"],
                            n_names=trace["n_names"], dsconv_names=trace["dsconv"])
        for ex in lines[2:]:
            for line in ex["stdout"].splitlines():
                log(f"  | {line}")
            out_lines = [s.strip() for s in ex["stdout"].splitlines()]
            log(f"  {ex['example']}: exit {ex['rc']}, {ex['seconds']:.1f} s")
            parts[ex["example"].split()[0]] = ex["seconds"]
            if ex["rc"] != 0 or "PASS" not in out_lines:
                raise AssertionError(f"phase 18 (c) {ex['example']}: exit {ex['rc']}\n"
                                     f"{ex['stderr']}")
        parts["child"] = time.perf_counter() - t1
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log("  (e) python3 -m csinn2_tpu_torch --backend")
    t1 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "csinn2_tpu_torch", "--backend"], cwd=here,
                       capture_output=True, text=True, timeout=120)
    name = torch.cuda.get_device_name(0)
    log(f"  | {r.stdout.strip()}")
    if r.returncode != 0 or name not in r.stdout:
        raise AssertionError(f"phase 18 (e): exit {r.returncode}, {r.stdout!r}\n{r.stderr}")
    rec["backend"] = r.stdout.strip()
    parts["e"] = time.perf_counter() - t1
    rec["seconds"] = time.perf_counter() - t0
    rec["seconds_parts"] = parts
    log(f"  phase 18: {rec['seconds']:.1f} s ({', '.join(f'{k} {v:.1f}' for k, v in parts.items())})")
    return hyb_counts, cnn_counts, rec


# ---------------------------------------------------------------------------
# phase 10: the probe path, the Q4_0 dequant-strategy probes
# ---------------------------------------------------------------------------

def check_probe_kernels(records, results, gpu_line):
    """Each probe kernel against its plain version on the card at the four
    shapes (the probe's inputs), timed beside the plain version (warm) and
    torch.matmul on the dequantized bf16 [K, N] weight (cold), with its
    factor over cur(quant_matmul) and over torch.matmul (the probe's cold
    times); the record of each is the w13 shape, with the probe's cold
    kernel time."""
    import numpy as np
    import torch
    from csinn2_tpu_torch.examples import int4_dequant_probe as probe
    from csinn2_tpu_torch.kernels import int4_probe as ip
    from csinn2_tpu_torch.kernels.qmatmul import unpack_int4
    from csinn2_tpu_torch.utils.timing import cold_copies, gpu_ms, gpu_ms_cold, l2_bytes
    M = 8
    rng = np.random.default_rng(0)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    us = {(r["name"], r["K"], r["N"]): r["us"] for r in results}
    for label, (K, N, bn, bk) in zip(probe.SHAPE_NAMES, probe.ALL_SHAPES):
        case = probe.make_case(rng, M, K, N, "cuda")
        x, w = case["x"], case["weights"]
        deq = (unpack_int4(w["wp"], K).float().reshape(K // 32, 32, N)
               * w["s"][:, None]).reshape(K, N).to(torch.bfloat16)
        libs = [deq] + [deq.clone() for _ in range(cold_copies(deq.numel() * 2, l2_bytes()) - 1)]
        lib = gpu_ms_cold([lambda d=d: torch.matmul(x, d) for d in libs])
        del libs, deq
        for kind, (_, variant) in PROBE_KERNELS.items():
            spec = probe.variant_table(M, K, N, bn, bk)[variant]
            call = ip.prepare(kind, x, w[spec[1]], w[spec[2]], M, bn, bk)
            y = call.kernel()
            torch.cuda.synchronize()
            ref = ip.kernel_ref(kind, call.tensors, M, N, K, bn, bk)
            err = float((y - ref).abs().max())
            if kind == "stream" and not torch.equal(y, ref):
                raise AssertionError(f"int4_probe stream {label}: not bit for bit ({err})")
            if err > 1e-5 * float(ref.abs().max()):
                raise AssertionError(f"int4_probe {kind} {label}: max|d| {err} against "
                                     f"max|y| {float(ref.abs().max())}")
            plain = gpu_ms(lambda: ip.kernel_ref(kind, call.tensors, M, N, K, bn, bk), reps=3)
            ms, cur = us[variant, K, N] * 1e-3, us[probe.CUR, K, N] * 1e-3
            b_ms, b_by = bound(ip.kernel_bytes(kind, M, N, K), 2.0 * M * N * K,
                               INT8_OPS if kind in ("intdot", "w4a8") else BF16_FLOPS)
            cols, ksplit = ip.plane_geometry(M, N, K, n_sm)
            shape = (f"{label} M={M} K={K} N={N} (bn {bn} bk {bk}: {cols} columns per CTA, "
                     f"{ksplit}-row splits), cold L2")
            log(f"  int4_probe_{kind} {shape}: ms={ms:.4f} plain_ms={plain:.4f} lib_ms={lib:.4f} "
                f"bound_ms={b_ms:.4f} ({b_by}) roofline={b_ms / ms:.3f} max_abs_err={err:.3e} "
                f"cur_ms={cur:.4f} x_cur={ms / cur:.2f} x_lib={ms / lib:.2f}")
            rec = records.setdefault(f"int4_probe_{kind}", {"max_abs_err": 0.0})
            rec["max_abs_err"] = max(rec["max_abs_err"], err)
            if label == "w13":
                rec.update(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=b_ms, bound_by=b_by,
                           shape=shape, cur_ms=cur)
            del call, y, ref
        del case, x, w
        torch.cuda.empty_cache()
    log(f"  every probe kernel agrees with its plain version at the four shapes [{gpu_line}]")


def probe_path(records, gpu_line):
    """Phase 10: the port's probe at the four 7B decode shapes (its launch
    counts are this path's), then each kernel against its plain version,
    then the tile tuner's sweep.  Returns the probe run's launch counts."""
    import torch
    from csinn2_tpu_torch.examples import int4_dequant_probe as probe
    from csinn2_tpu_torch.examples import int4_tile_tune as tuner
    from csinn2_tpu_torch.kernels import launch_counts, reset_launch_counts
    torch.cuda.synchronize()
    reset_launch_counts()
    results = probe.probe(device="cuda", M=8, log=log)
    torch.cuda.synchronize()
    counts = dict(launch_counts)
    log(f"  probe launches: {counts}")
    missing = [k for k in PROBE_KERNELS if counts.get(f"int4_probe_{k}", 0) == 0]
    if missing or counts.get("quant_matmul_q4_0.decode", 0) == 0:
        raise AssertionError(f"phase 10 never launched {missing} (or quant_matmul_q4_0)")
    over = [(r["name"], r["K"], r["N"], r["bound_us"] / r["us"]) for r in results
            if r["bound_us"] / r["us"] > 1.05]
    if over:
        raise AssertionError(f"phase 10 rows above 105 % of their bytes bound: {over}")
    low = [(r["name"], r["K"], r["N"], r["cos"]) for r in results
           if r["kind"] not in ("stream", "noscale", "halfq8") and r["cos"] < 0.99]
    if low:
        raise AssertionError(f"phase 10 variants off the golden: {low}")
    check_probe_kernels(records, results, gpu_line)
    tuner.tune(device="cuda", log=log)
    torch.cuda.empty_cache()
    return counts


# ---------------------------------------------------------------------------
# phase 11: the port's LLM example programs, as a user runs them
# ---------------------------------------------------------------------------

EXAMPLES = (("llama_generate.py", ("--mode", "q8_0", "--quant-kv")),
            ("llama7b_bench.py", ("--mode", "q4_0", "--layers", "32")))


def examples_path(here: Path):
    """Each example of EXAMPLES in a process of its own (it finds the
    kernels this run built); its output is echoed, and a non-zero exit, a
    FAIL line or no PASS line fails the phase."""
    import torch
    torch.cuda.empty_cache()
    for script, args in EXAMPLES:
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, str(here / "csinn2_tpu_torch" / "examples" / script),
                            *args], cwd=here, capture_output=True, text=True, timeout=600)
        lines = [line.strip() for line in r.stdout.splitlines()]
        for line in lines:
            log(f"  | {line}")
        log(f"  {script} {' '.join(args)}: exit {r.returncode}, "
            f"{time.perf_counter() - t0:.1f} s")
        if r.returncode != 0 or "PASS" not in lines or any(x.startswith("FAIL") for x in lines):
            raise AssertionError(f"phase 11 {script}: exit {r.returncode}\n{r.stderr[-4000:]}")


# ---------------------------------------------------------------------------
# phase 12: mixture of experts at Mixtral-8x7B width
# ---------------------------------------------------------------------------

E_MOE = 8


def mixtral_cfg(n_layers: int, **kw):
    """Mixtral-8x7B's published widths (mistralai/Mixtral-8x7B-v0.1
    config.json: hidden 4096, 32 heads, 8 KV heads, intermediate 14336, 8
    local experts, 2 a token, vocab 32000, rope_theta 1e6, RMSNorm eps 1e-5),
    with max_seq_len cut from 32768 to 2048 and the depth as given."""
    from csinn2_tpu_torch.llm.config import LlamaConfig
    return LlamaConfig(dim=4096, n_layers=n_layers, n_heads=32, n_kv_heads=8, ffn_dim=14336,
                       vocab_size=32000, max_seq_len=2048, rope_base=1e6, n_experts=E_MOE,
                       moe_top_k=2, **kw)


# (label, K, N) of one Mixtral expert's projections: w1 and w3, w2
EXPERT_SHAPES = (("w1/w3", 4096, 14336), ("w2", 14336, 4096))
EXPERT_MS = (1, 4, 256)       # dense decode at batch 1 and 4; the routed cap at T = 512


def check_expert_gemms(records, gpu_line):
    """quant_matmul at the expert shapes, Q8_0 and Q4_0, M = 1, 4 (cold) and
    256: each against quant_matmul_ref, timed beside its bound, the plain
    version and torch.matmul on the dequantized bf16 weight.  Records
    records[key]["moe_experts"][label M] per mode."""
    import torch
    from csinn2_tpu_torch.kernels.qmatmul import launch_key, quant_matmul, quant_matmul_ref
    from csinn2_tpu_torch.utils.timing import gpu_ms
    from csinn2_tpu_torch.utils.verify import cosine_similarity
    g = torch.Generator(device="cuda")
    g.manual_seed(12)
    for mode in ("q8_0", "q4_0"):
        scale_mode, packed = QMM_MODES[mode]
        key = launch_key(scale_mode, packed, swiglu=False)
        kw = dict(scale_mode=scale_mode, packed_int4=packed, out_dtype=torch.float32)
        for label, K, N in EXPERT_SHAPES:
            w, s, w_deq = _qmm_weights(g, mode, K, N)
            for M in EXPERT_MS:
                x = torch.randn((M, K), generator=g, device="cuda").to(torch.bfloat16)
                y = quant_matmul(x, w, s, **kw).cpu().numpy()
                ref = quant_matmul_ref(x, w, s, **kw).cpu().numpy()
                err = float(abs(y - ref).max())
                cos, rel = cosine_similarity(y, ref), err / float(abs(ref).max())
                if not (cos >= 0.9999 and rel <= 1e-2):
                    raise AssertionError(f"expert {label} {mode} M={M}: cos={cos} rel={rel}")
                if M <= 16:
                    ms, lib = _gemm_cold(x, w, s, w_deq,
                                         lambda wc, sc: quant_matmul(x, wc, sc, **kw))
                else:
                    ms = gpu_ms(lambda: quant_matmul(x, w, s, **kw))
                    lib = gpu_ms(lambda: torch.matmul(x, w_deq))
                plain = gpu_ms(lambda: quant_matmul_ref(x, w, s, **kw), reps=3)
                b_ms, b_by = bound(M * K * 2 + w.numel() + s.numel() * 4 + M * N * 4,
                                   2.0 * M * N * K)
                rec = records.setdefault(key, {})
                rec["max_abs_err"] = max(rec.get("max_abs_err", 0.0), err)
                rec.setdefault("moe_experts", {})[f"{label} M={M}"] = dict(
                    ms=ms, plain_ms=plain, library_ms=lib, bound_ms=b_ms, bound_by=b_by,
                    cold=M <= 16)
                log(f"  {key} expert {label:5s} M={M:3d} K={K:5d} N={N:5d} "
                    f"ms={ms:.4f}{' cold' if M <= 16 else ''} plain_ms={plain:.4f} "
                    f"lib_ms={lib:.4f} bound_ms={b_ms:.4f} ({b_by}) roofline={b_ms / ms:.3f} "
                    f"cos={cos:.6f} max_abs_err={err:.3e} [{gpu_line}]")
            del w, s, w_deq
    torch.cuda.empty_cache()


def _qmm_per_forward(cfg) -> int:
    """quant_matmul launches of one unfused MoE llama_forward: wq, wk, wv, wo
    and each expert's w1, w3, w2 a layer, then the lm_head."""
    return cfg.n_layers * (4 + 3 * cfg.n_experts) + 1


@contextlib.contextmanager
def routes(record=None, force=None, stats=None):
    """Wrap llm.model._gate_top_k, the router of both MoE blocks: record
    each call's expert ids and gate logits (record=[]), or replay recorded
    ones (force=[...]) with the router weights softmaxed from this side's
    own gate logits, and for each call append to `stats` (tokens whose own
    top-k set differs, how far the forced picks' lowest logit falls short of
    the own k-th, the RMS difference of the two sides' gate logits)."""
    import torch
    from csinn2_tpu_torch.llm import model as tm
    orig = tm._gate_top_k
    calls = None if force is None else iter(force)

    def wrapped(x, gate, k):
        ids, w = orig(x, gate, k)
        logits = torch.matmul(x.float(), gate.float())
        if calls is None:
            record.append((ids.cpu(), logits.cpu()))
            return ids, w
        forced, their = next(calls)
        forced = forced.to(ids.device)
        srt = torch.sort(logits, dim=-1, descending=True).values
        flip = (torch.sort(ids, dim=-1).values != torch.sort(forced, dim=-1).values).any(-1)
        short = srt[..., k - 1] - logits.gather(-1, forced).min(-1).values
        noise = (logits - their.to(logits.device)).square().mean().sqrt()
        stats.append((flip.reshape(-1), short.reshape(-1), noise.reshape(1)))
        return forced, torch.softmax(logits.gather(-1, forced), dim=-1)

    tm._gate_top_k = wrapped
    try:
        yield
    finally:
        tm._gate_top_k = orig


def moe_parity(mode: str, gpu_line: str):
    """A 2-layer Mixtral-width model (`mode` weights made on the card from a
    seed, int8 KV): llama_forward's logits on the card against the port's
    plain path on the CPU (cosine >= 0.999) at a 128-token prompt (dense),
    a 512-token prompt (routed by "auto") and 512 under moe_dispatch="dense",
    each card forward's quant_matmul launches counted (zeroed just before,
    read just after).

    The router is discontinuous: where a token's k-th and (k+1)-th gate
    logits nearly tie, the bf16 differences between the card's arithmetic
    and the plain path's (rows 1a / 1c: bf16(q)·bf16(s) against f32 w·s)
    can pick another expert, and that token's logits then differ as a
    different function.  So the CPU forward replays the card's expert picks
    (routes(), router weights from its own gate logits), which holds every
    other piece of the forward to the gate; and the picks themselves are
    held apart: the CPU's own top-k differs from the card's on at most 5 %
    of (layer, token) pairs, each a near tie — the card's pick falls short
    of the CPU's own k-th logit by at most 6 σ, σ the RMS difference of the
    two sides' gate logits over that layer's tokens (the largest of ~10^3
    differences of two such noises reaches ~4.7 σ).  Returns the launch
    counts summed over the three card forwards."""
    import numpy as np
    import torch
    from csinn2_tpu_torch.kernels import launch_counts, reset_launch_counts
    from csinn2_tpu_torch.kernels.qmatmul import launch_key
    from csinn2_tpu_torch.llm.model import KVCache, init_params_device, llama_forward, moe_routed
    from csinn2_tpu_torch.utils.verify import cosine_similarity
    cfg = mixtral_cfg(2)
    params = init_params_device(cfg, mode, seed=12, device="cuda")
    cpu_params = _to(params, "cpu")
    key = launch_key(*QMM_MODES[mode], swiglu=False)
    total = {}
    for T, dispatch in ((128, "auto"), (512, "auto"), (512, "dense")):
        c = dataclasses.replace(cfg, moe_dispatch=dispatch)
        toks = torch.from_numpy(np.random.default_rng(T).integers(1, c.vocab_size, (1, T)))
        picks, stats = [], []
        reset_launch_counts()
        with routes(record=picks):
            gpu, _ = llama_forward(params, toks, KVCache.create(c, 1, quantized=True,
                                                                device="cuda"), 0, c)
        torch.cuda.synchronize()
        counts = dict(launch_counts)
        for k, n in counts.items():
            total[k] = total.get(k, 0) + n
        gpu = gpu.cpu().numpy()
        t0 = time.perf_counter()
        with routes(force=picks, stats=stats):
            cpu, _ = llama_forward(cpu_params, toks, KVCache.create(c, 1, quantized=True,
                                                                    device="cpu"), 0, c)
        t_cpu = time.perf_counter() - t0
        cos = cosine_similarity(gpu, cpu.numpy())
        flips = torch.cat([f for f, _, _ in stats])
        # each layer's largest shortfall over its gate-logit noise
        worst = max(float(sh.max() / sg.clamp(min=1e-30)) for _, sh, sg in stats)
        sigma = max(float(sg) for _, _, sg in stats)
        n_qmm = launches(counts, key)
        log(f"  2-layer Mixtral-width {mode} int8-KV prefill s={T} "
            f"({'routed' if moe_routed(c, T) else 'dense'}, moe_dispatch={dispatch}): logits "
            f"{gpu.shape} finite={bool(np.isfinite(gpu).all())} cosine(card, cpu plain on the "
            f"card's expert picks)={cos:.6f}; the cpu's own picks differ on {int(flips.sum())} "
            f"of {flips.numel()} (layer, token) pairs, largest shortfall {worst:.2f} sigma "
            f"(gate-logit noise sigma up to {sigma:.3e}); {key} launches {n_qmm} (want "
            f"{_qmm_per_forward(c)}); cpu "
            f"plain path {t_cpu:.1f} s (host clock) [{gpu_line}]")
        if not (np.isfinite(gpu).all() and cos >= 0.999):
            raise AssertionError(f"MoE parity {mode} T={T} {dispatch}: cosine {cos}")
        if flips.sum() > 0.05 * flips.numel() or worst > 6.0:
            raise AssertionError(f"MoE parity {mode} T={T} {dispatch}: expert picks differ on "
                                 f"{int(flips.sum())} pairs, shortfall {worst} sigma")
        if n_qmm != _qmm_per_forward(c) or counts.get(f"{key}.prefill", 0) != n_qmm:
            raise AssertionError(f"MoE parity {mode} T={T} {dispatch}: launches {counts}")
    del params, cpu_params
    torch.cuda.empty_cache()
    return total


def _decode_bytes(params, cfg, pos: int) -> int:
    """Bytes a dense-MoE decode step at batch 1 must read: every weight
    (every expert: the dense formulation runs all of them), the norms and
    gates, one embedding row, and the int8 KV cache up to pos."""
    import torch
    from csinn2_tpu_torch.llm.model import _qweights
    n = sum(q.values.nbytes + (0 if q.scales is None else q.scales.nbytes)
            for q in _qweights(params))
    n += sum(v.nbytes for lp in params["layers"] for v in lp.values()
             if isinstance(v, torch.Tensor))
    n += params["norm"].nbytes + cfg.dim * 2
    return n + cfg.n_layers * 2 * pos * cfg.n_kv_heads * cfg.head_dim


def moe_full_depth(gpu_line: str, n_layers: int = 32):
    """Mixtral-8x7B at full depth, Q4_0 weights made on the card from a
    seed, int8 KV: a 512-token prefill (routed by "auto") and 16 greedy
    decode steps through llama_forward at s = 1 (dense), timed by CUDA
    events, with the quant_matmul launches of that run (zeroed just before,
    read just after) against layers x (4 + 3E) + 1 a forward.  Returns the
    launch counts."""
    import numpy as np
    import torch
    from csinn2_tpu_torch.kernels import launch_counts, reset_launch_counts
    from csinn2_tpu_torch.kernels.qmatmul import launch_key
    from csinn2_tpu_torch.llm.model import KVCache, init_params_device, llama_forward
    from csinn2_tpu_torch.utils.timing import event_ms
    cfg = mixtral_cfg(n_layers)
    t0 = time.perf_counter()
    params = init_params_device(cfg, "q4_0", seed=12, device="cuda")
    torch.cuda.synchronize()
    log(f"  Mixtral-8x7B ({n_layers} layers) Q4_0 weights made and quantized on the card: "
        f"{time.perf_counter() - t0:.2f} s, {torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    cache = KVCache.create(cfg, 1, quantized=True, device="cuda")
    toks = torch.from_numpy(np.random.default_rng(12).integers(1, cfg.vocab_size, (1, 512)))
    llama_forward(params, toks[:, :16], cache, 0, cfg)             # first calls
    torch.cuda.synchronize()
    reset_launch_counts()
    out = {}
    pre_ms = event_ms(lambda: out.setdefault("logits", llama_forward(params, toks, cache, 0,
                                                                     cfg)[0]))
    nxt = int(out["logits"][0, -1].argmax())
    step_ms, gen = [], []
    for i in range(16):
        tok = torch.tensor([[nxt]])
        ms = event_ms(lambda: out.__setitem__("step", llama_forward(params, tok, cache,
                                                                    512 + i, cfg)[0]))
        step_ms.append(ms)
        nxt = int(out["step"][0, -1].argmax())
        gen.append(nxt)
    torch.cuda.synchronize()
    counts = dict(launch_counts)
    key = launch_key(*QMM_MODES["q4_0"], swiglu=False)
    per = _qmm_per_forward(cfg)
    finite = bool(torch.isfinite(out["logits"]).all() and torch.isfinite(out["step"]).all())
    nbytes = _decode_bytes(params, cfg, 528)
    b_ms = nbytes / HBM_BYTES_PER_S * 1e3
    med = statistics.median(step_ms[1:])
    log(f"  Mixtral-8x7B {n_layers}-layer Q4_0 int8 KV: prefill 512 tokens (routed) "
        f"{pre_ms:.3f} ms; 16 greedy decode steps through llama_forward at s = 1 (dense) "
        f"median {med:.3f} ms/step (first {step_ms[0]:.3f}), {1e3 / med:.2f} tok/s (CUDA "
        f"events around each call, host launch gaps included) [{gpu_line}]")
    log(f"  decode step bytes bound (dense decode reads every expert): {nbytes / 1e9:.3f} GB "
        f"-> {b_ms:.3f} ms at {HBM_BYTES_PER_S / 1e12:.2f} TB/s, {b_ms / med:.3f} of it; "
        f"tokens {gen}; logits finite={finite}")
    log(f"  launches of the run: {key}.prefill {counts.get(f'{key}.prefill', 0)} (want "
        f"{per}), {key}.decode {counts.get(f'{key}.decode', 0)} (want {16 * per}); {counts}")
    if not finite or not all(0 <= t < cfg.vocab_size for t in gen):
        raise AssertionError(f"Mixtral full depth: finite={finite} tokens {gen}")
    if counts.get(f"{key}.prefill", 0) != per or counts.get(f"{key}.decode", 0) != 16 * per:
        raise AssertionError(f"Mixtral full depth launches {counts}")
    del params, cache, out
    torch.cuda.empty_cache()
    return counts, dict(prefill_ms=pre_ms, step_ms=med, bound_ms=b_ms, layers=n_layers)


def moe_path(here: Path, records, gpu_line: str):
    """Phase 12.  Returns {launch_counts key: counts of the phase's card
    runs} for quant_matmul (Q8_0 parity) and quant_matmul_q4_0 (Q4_0 parity
    and the full-depth run)."""
    check_expert_gemms(records, gpu_line)
    q8 = moe_parity("q8_0", gpu_line)
    q4 = moe_parity("q4_0", gpu_line)
    full, summary = moe_full_depth(gpu_line)
    records["quant_matmul_q4_0"]["moe_full_depth"] = summary
    for k, n in full.items():
        q4[k] = q4.get(k, 0) + n
    for mode in ("float", "q4_0"):       # the JAX probe's bf16 experts, then Q4_0 ones
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, str(here / "csinn2_tpu_torch" / "examples" /
                                                "moe_dispatch_probe.py"), "--mode", mode],
                           cwd=here, capture_output=True, text=True, timeout=600)
        for line in r.stdout.splitlines():
            log(f"  | {line.strip()}")
        log(f"  moe_dispatch_probe.py --mode {mode}: exit {r.returncode}, "
            f"{time.perf_counter() - t0:.1f} s")
        if r.returncode != 0:
            raise AssertionError(f"phase 12 moe_dispatch_probe.py --mode {mode}: exit "
                                 f"{r.returncode}\n{r.stderr[-4000:]}")
    return {"quant_matmul": q8, "quant_matmul_q4_0": q4}


# ---------------------------------------------------------------------------
# phase 13: the LLM weight I/O, GGUF -> convert -> CTBM -> load_llm
# ---------------------------------------------------------------------------

def _synthetic_gguf(path: str, cfg):
    """A GGUF at `cfg`'s widths with seeded weights (bench.py's synthetic
    checkpoint, at Llama-2-7B width): an F16 embedding, Q8_0 linears but
    blk.0.ffn_down in Q4_0 and blk.1.attn_v in F16, and a 32000-piece
    SentencePiece vocabulary.  → the float tensors written (GGUF layout)."""
    import numpy as np
    from csinn2_tpu_torch.llm.gguf_io import write_gguf
    rng = np.random.default_rng(13)
    D, Fd, V = cfg.dim, cfg.ffn_dim, cfg.vocab_size
    kvd = cfg.n_kv_heads * cfg.head_dim

    def w(o, i):
        return rng.standard_normal((o, i), dtype=np.float32) * np.float32(0.05)

    t = {"token_embd.weight": w(V, D).astype(np.float16),
         "output_norm.weight": np.ones((D,), np.float32), "output.weight": w(V, D)}
    for i in range(cfg.n_layers):
        b = f"blk.{i}."
        t.update({b + "attn_norm.weight": np.ones((D,), np.float32),
                  b + "ffn_norm.weight": np.ones((D,), np.float32),
                  b + "attn_q.weight": w(D, D), b + "attn_k.weight": w(kvd, D),
                  b + "attn_v.weight": w(kvd, D), b + "attn_output.weight": w(D, D),
                  b + "ffn_gate.weight": w(Fd, D), b + "ffn_down.weight": w(D, Fd),
                  b + "ffn_up.weight": w(Fd, D)})
    t["blk.1.attn_v.weight"] = t["blk.1.attn_v.weight"].astype(np.float16)
    quant = {k: "q8_0" for k, v in t.items()
             if v.ndim == 2 and v.dtype == np.float32 and "embd" not in k}
    quant["blk.0.ffn_down.weight"] = "q4_0"
    toks = ["<unk>", "<s>", "</s>"] + [f"<0x{b:02X}>" for b in range(256)] \
        + ["▁"] + [chr(c) for c in range(ord("a"), ord("z") + 1)] + ["▁a", "▁b", "ab"]
    toks += [f"tok{i}" for i in range(len(toks), V)]
    md = {"general.architecture": "llama", "general.alignment": 32,
          "llama.embedding_length": D, "llama.block_count": cfg.n_layers,
          "llama.attention.head_count": cfg.n_heads,
          "llama.attention.head_count_kv": cfg.n_kv_heads, "llama.feed_forward_length": Fd,
          "llama.context_length": cfg.max_seq_len,
          "llama.attention.layer_norm_rms_epsilon": cfg.norm_eps,
          "llama.rope.freq_base": cfg.rope_base, "tokenizer.ggml.tokens": toks,
          "tokenizer.ggml.scores": [0.0] * len(toks), "tokenizer.ggml.bos_token_id": 1,
          "tokenizer.ggml.eos_token_id": 2}
    write_gguf(path, md, t, quantize=quant)
    return t


def weight_io_path(here: Path, gpu_line: str):
    """Phase 13: a synthetic 2-layer GGUF at Llama-2-7B width written by the
    port, converted by `python -m csinn2_tpu_torch convert --mode q8_0` in a
    process of its own, load_llm(device="cuda"), its llama_forward logits
    (launch counts zeroed just before, read just after) against the float
    forward on the dequantized pre-conversion weights on the card (cosine >=
    0.999, bench.py's real-weights gate), then llama_generate.py --ckpt on
    the directory (exit 0, PASS).  Files go to _smoke/ in the checkout and
    are removed after.  Returns the forward's launch counts."""
    import shutil
    import numpy as np
    import torch
    from csinn2_tpu_torch.kernels import launch_counts, reset_launch_counts
    from csinn2_tpu_torch.llm.config import LlamaConfig
    from csinn2_tpu_torch.llm.gguf_io import GGUFFile
    from csinn2_tpu_torch.llm.json_io import load_llm
    from csinn2_tpu_torch.llm.model import KVCache, QWeight, llama_forward
    from csinn2_tpu_torch.utils.verify import cosine_similarity
    cfg = LlamaConfig(dim=4096, n_layers=2, n_heads=32, n_kv_heads=32, ffn_dim=11008,
                      vocab_size=32000, max_seq_len=2048)
    work = here / "_smoke"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir()
    try:
        gguf, out = str(work / "llama7b-2l.gguf"), str(work / "ctbm")
        t0 = time.perf_counter()
        _synthetic_gguf(gguf, cfg)
        t_write = time.perf_counter() - t0
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, "-m", "csinn2_tpu_torch", "convert", gguf, out,
                            "--mode", "q8_0"], cwd=here, capture_output=True, text=True,
                           timeout=600)
        t_conv = time.perf_counter() - t0
        if r.returncode != 0:
            raise AssertionError(f"phase 13 convert: exit {r.returncode}\n{r.stderr[-4000:]}")
        ctbm = os.path.getsize(os.path.join(out, "weights.ctbm"))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cfg2, params = load_llm(out, device="cuda")
        torch.cuda.synchronize()
        t_load = time.perf_counter() - t0
        log(f"  GGUF {os.path.getsize(gguf) / 1e9:.3f} GB written in {t_write:.1f} s; "
            f"convert (CLI, own process) {t_conv:.1f} s -> weights.ctbm {ctbm / 1e9:.3f} GB; "
            f"load_llm onto the card {t_load:.2f} s = {ctbm / t_load / 1e9:.2f} GB/s (host "
            f"clock) [{gpu_line}]")
        widths = ("dim", "n_layers", "n_heads", "n_kv_heads", "ffn_dim", "vocab_size",
                  "max_seq_len", "rope_base")     # (norm_eps crosses as an f32)
        if any(getattr(cfg2, f) != getattr(cfg, f) for f in widths):
            raise AssertionError(f"phase 13 config {cfg2}")
        toks = torch.arange(16)[None] % cfg.vocab_size
        reset_launch_counts()
        logits, _ = llama_forward(params, toks, KVCache.create(cfg, 1, device="cuda"), 0, cfg)
        torch.cuda.synchronize()
        counts = dict(launch_counts)
        logits = logits.float().cpu().numpy()
        del params
        gg = GGUFFile(gguf)

        def fq(name):
            return QWeight(values=torch.from_numpy(np.ascontiguousarray(gg.tensor(name).T))
                           .to("cuda"))

        def vec(name):
            return torch.from_numpy(np.array(gg.tensor(name))).to("cuda")

        gp = {"tok_embedding": vec("token_embd.weight"), "norm": vec("output_norm.weight"),
              "output": fq("output.weight"), "layers": []}
        for i in range(cfg.n_layers):
            b = f"blk.{i}."
            gp["layers"].append({
                "attn_norm": vec(b + "attn_norm.weight"), "ffn_norm": vec(b + "ffn_norm.weight"),
                "wq": fq(b + "attn_q.weight"), "wk": fq(b + "attn_k.weight"),
                "wv": fq(b + "attn_v.weight"), "wo": fq(b + "attn_output.weight"),
                "w1": fq(b + "ffn_gate.weight"), "w2": fq(b + "ffn_down.weight"),
                "w3": fq(b + "ffn_up.weight")})
        gg.close()
        gold, _ = llama_forward(gp, toks, KVCache.create(cfg, 1, device="cuda"), 0, cfg)
        gold = gold.float().cpu().numpy()
        del gp
        torch.cuda.empty_cache()
        cos = cosine_similarity(logits, gold)
        n_qmm = launches(counts, "quant_matmul")
        log(f"  converted Q8_0 logits on the card vs the float forward on the pre-conversion "
            f"weights: cosine {cos:.6f} (gate 0.999), finite={bool(np.isfinite(logits).all())}; "
            f"quant_matmul launches {n_qmm} (want {cfg.n_layers * 7 + 1}); {counts}")
        if not (np.isfinite(logits).all() and cos >= 0.999):
            raise AssertionError(f"phase 13 logits cosine {cos}")
        if n_qmm != cfg.n_layers * 7 + 1:
            raise AssertionError(f"phase 13 launches {counts}")
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, str(here / "csinn2_tpu_torch" / "examples" /
                                                "llama_generate.py"), "--ckpt", out,
                            "--quant-kv", "--prompt", "a b ab"],
                           cwd=here, capture_output=True, text=True, timeout=600)
        lines = [line.strip() for line in r.stdout.splitlines()]
        for line in lines:
            log(f"  | {line}")
        log(f"  llama_generate.py --ckpt: exit {r.returncode}, {time.perf_counter() - t0:.1f} s")
        if r.returncode != 0 or "PASS" not in lines:
            raise AssertionError(f"phase 13 llama_generate.py --ckpt: exit {r.returncode}\n"
                                 f"{r.stderr[-4000:]}")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return counts


# ---------------------------------------------------------------------------
# phase 14: tensor, data and expert parallelism over ranks sharing the card
# ---------------------------------------------------------------------------

# (label, K, N, out dtype) of a rank's GEMMs at tp = 2: the Llama-2-7B
# projections (wqkv and w13 fused and interleaved per shard, w2's K 5504 = 172
# blocks of 32) and a Mixtral-8x7B expert's under tp = 2 x ep = 2
SHARD_SHAPES = (("wqkv/tp2", 4096, 6144, "bf16"), ("wo/tp2", 2048, 4096, "bf16"),
                ("w13/tp2", 4096, 11008, "bf16"), ("w2/tp2", 5504, 4096, "bf16"),
                ("lm_head/tp2", 4096, 16000, "f32"), ("expert w1/w3/tp2", 4096, 7168, "f32"),
                ("expert w2/tp2", 7168, 4096, "f32"))
SHARD_MS = (1, 4, 128, 2048)
MESH_TIMEOUT_S = 300
# (b)'s model cut to this depth for the cosine gate of 0.999: at 32 layers
# the seeded random-weight 7B model amplifies rounding alone past that gate
# (one bf16 ulp of noise on its embedding moves its logits to a cosine near
# 0.98, _noise_floor), so there the sharded run is held to that floor
PARITY_LAYERS = 2


def check_shard_gemms(records, gpu_line):
    """quant_matmul at the shard shapes, Q8_0 and Q4_0, M = 1, 4 (cold), 128
    and 2048: each against quant_matmul_ref, timed beside its bound, the
    plain version and torch.matmul on the dequantized bf16 weight.  Records
    records[key]["tp_shards"][label M] per mode."""
    import torch
    from csinn2_tpu_torch.kernels.qmatmul import launch_key, quant_matmul, quant_matmul_ref
    from csinn2_tpu_torch.utils.timing import gpu_ms
    from csinn2_tpu_torch.utils.verify import cosine_similarity
    g = torch.Generator(device="cuda")
    g.manual_seed(14)
    for mode in ("q8_0", "q4_0"):
        scale_mode, packed = QMM_MODES[mode]
        key = launch_key(scale_mode, packed, swiglu=False)
        for label, K, N, odt in SHARD_SHAPES:
            odt = torch.bfloat16 if odt == "bf16" else torch.float32
            kw = dict(scale_mode=scale_mode, packed_int4=packed, out_dtype=odt)
            w, s, w_deq = _qmm_weights(g, mode, K, N)
            for M in SHARD_MS:
                x = torch.randn((M, K), generator=g, device="cuda").to(torch.bfloat16)
                y = quant_matmul(x, w, s, **kw).float().cpu().numpy()
                ref = quant_matmul_ref(x, w, s, **kw).float().cpu().numpy()
                err = float(abs(y - ref).max())
                cos, rel = cosine_similarity(y, ref), err / float(abs(ref).max())
                if not (cos >= 0.9999 and rel <= 1e-2):
                    raise AssertionError(f"shard {label} {mode} M={M}: cos={cos} rel={rel}")
                if M <= 16:
                    ms, lib = _gemm_cold(x, w, s, w_deq,
                                         lambda wc, sc: quant_matmul(x, wc, sc, **kw))
                else:
                    ms = gpu_ms(lambda: quant_matmul(x, w, s, **kw))
                    lib = gpu_ms(lambda: torch.matmul(x, w_deq))
                plain = gpu_ms(lambda: quant_matmul_ref(x, w, s, **kw), reps=3)
                osz = 2 if odt == torch.bfloat16 else 4
                b_ms, b_by = bound(M * K * 2 + w.numel() + s.numel() * 4 + M * N * osz,
                                   2.0 * M * N * K)
                rec = records.setdefault(key, {})
                rec["max_abs_err"] = max(rec.get("max_abs_err", 0.0), err)
                rec.setdefault("tp_shards", {})[f"{label} M={M}"] = dict(
                    ms=ms, plain_ms=plain, library_ms=lib, bound_ms=b_ms, bound_by=b_by,
                    cold=M <= 16)
                log(f"  {key} {label:17s} M={M:4d} K={K:5d} N={N:5d} "
                    f"ms={ms:.4f}{' cold' if M <= 16 else ''} plain_ms={plain:.4f} "
                    f"lib_ms={lib:.4f} bound_ms={b_ms:.4f} ({b_by}) roofline={b_ms / ms:.3f} "
                    f"cos={cos:.6f} max_abs_err={err:.3e} [{gpu_line}]")
            del w, s, w_deq
    torch.cuda.empty_cache()


def _mesh_prompts(cfg):
    """Phase 4's six prompts (5..1100 tokens, seeded)."""
    import numpy as np
    rng = np.random.default_rng(0)
    return [[int(t) for t in rng.integers(1, cfg.vocab_size, n)] for n in PROMPTS]


def _parity_probe(eng, cfg, first=None):
    """The logits of a 128-token prefill into lane 0 and of one decode step
    of all four lanes at position 128 (phase 4's sequence), fed the tokens
    `first` (the reference's) where given, else those the engine samples
    from its prefills."""
    import numpy as np
    prompt = _mesh_prompts(cfg)[2]
    logits = eng.prefill(0, prompt)
    if first is None:
        first = {sid: eng.prefill_sample(sid, prompt) for sid in range(4)}
    else:
        for sid in range(4):
            eng.prefill(sid, prompt)
    step = eng.decode_step(first)
    return dict(logits=logits, step=np.stack([step[sid] for sid in range(4)]), first=first)


def _engine_probe(eng, cfg, n_new=16, first=None):
    """run_queue over the six prompts with its launch counts and decode
    steps, then _parity_probe."""
    import numpy as np
    import torch
    from csinn2_tpu_torch.kernels import launch_counts, reset_launch_counts
    from csinn2_tpu_torch.llm.engine import Request
    prompts = _mesh_prompts(cfg)
    steps = [0]
    decode_steps = eng.decode_steps

    def counted(next_tokens, n_steps, **kw):
        steps[0] += n_steps
        return decode_steps(next_tokens, n_steps, **kw)

    eng.decode_steps = counted
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = eng.run_queue([Request(prompt=p, max_new_tokens=n_new) for p in prompts], chunk=16)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(launch_counts)
    del eng.decode_steps
    return dict(outs=[list(r.out) for r in done], slots=[r.slot for r in done], counts=counts,
                wall=wall, steps=steps[0], **_parity_probe(eng, cfg, first))


def _collective_ms(mesh, shape, dtype, reps=50):
    """Host-clock ms of one all_reduce over tp of a CUDA tensor (synchronised
    before and after each): under gloo, its staging through the host."""
    import torch
    from csinn2_tpu_torch.parallel.mesh import all_reduce
    x = torch.ones(shape, dtype=dtype, device=mesh.device)
    for _ in range(3):
        all_reduce(x, mesh.tp_group, "timing")
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        all_reduce(x, mesh.tp_group, "timing")
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def mesh_engine_job(mode: str, n_layers: int, tp: int, dp: int, first: dict,
                    parity_first: dict = None):
    """One rank of phase 14 (b), (c) and (f): Llama-2-7B geometry at
    n_layers, `mode` weights made whole on the card from phase 4's seed,
    sharded by InferenceEngine(batch=4, mesh=make_mesh(tp, dp)) (the rest
    freed), int8 KV: _engine_probe, then one 8-step decode chunk timed by
    the host clock with its collectives counted, and one all_reduce of a
    decode step's and of a 128-token prefill's shape timed alone.  first:
    the single-process run's first tokens, which the decode step is fed.
    parity_first: then the same model cut to PARITY_LAYERS, _parity_probe
    fed these tokens (its single-process run's)."""
    import dataclasses
    import torch
    from csinn2_tpu_torch.kernels import launch_counts, reset_launch_counts
    from csinn2_tpu_torch.llm.config import LlamaConfig
    from csinn2_tpu_torch.llm.engine import InferenceEngine
    from csinn2_tpu_torch.llm.model import init_params_device
    from csinn2_tpu_torch.parallel.mesh import make_mesh
    mesh = make_mesh(tp=tp, dp=dp, device="cuda")
    cfg = dataclasses.replace(LlamaConfig.llama2_7b(), n_layers=n_layers)
    t0 = time.perf_counter()
    eng = InferenceEngine(cfg, init_params_device(cfg, mode, seed=0, device=mesh.device),
                          batch=4, quantized_kv=True, mesh=mesh)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    build = time.perf_counter() - t0
    mem = torch.cuda.memory_allocated(mesh.device) / 2**30
    out = _engine_probe(eng, cfg, first=first)
    nxt = {sid: int(out["step"][sid].argmax()) for sid in range(4)}
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.decode_steps(nxt, 8)
    torch.cuda.synchronize()
    out["chunk_ms_per_step"] = (time.perf_counter() - t0) * 1e3 / 8
    out["chunk_counts"] = dict(launch_counts)
    out.update(mesh=str(mesh), backend=mesh.backend(), graph=eng._graph, build_s=build,
               mem_gib=mem, coords=mesh.coords, n_graphs=len(eng._graphs),
               ar_decode_ms=_collective_ms(mesh, (eng.b_loc, 1, cfg.dim), torch.float32),
               ar_prefill_ms=_collective_ms(mesh, (1, 128, cfg.dim), torch.bfloat16, reps=20))
    del out["first"]
    if parity_first is not None:
        del eng
        torch.cuda.empty_cache()
        cfg2 = dataclasses.replace(cfg, n_layers=PARITY_LAYERS)
        eng = InferenceEngine(cfg2, init_params_device(cfg2, mode, seed=0, device=mesh.device),
                              batch=4, quantized_kv=True, mesh=mesh)
        out["parity"] = _parity_probe(eng, cfg2, parity_first)
    return out


def mesh_moe_job(axes: dict, modes=("q8_0", "q4_0")):
    """One rank of phase 14 (d): Mixtral-8x7B width (2 layers), each mode's
    weights made whole on the card (seed 14), this rank's experts (and, with
    a tp axis, its shard of each) kept; the logits of a 128-token prompt and
    of one decode step at position 128, with the launches of the two
    forwards."""
    import torch
    from csinn2_tpu_torch.kernels import launch_counts, reset_launch_counts
    from csinn2_tpu_torch.llm.model import KVCache, init_params_device
    from csinn2_tpu_torch.parallel.ep import ep_llama_forward, shard_moe_params
    from csinn2_tpu_torch.parallel.mesh import Mesh
    from csinn2_tpu_torch.parallel.tp import local_config, shard_llama_params, tp_llama_forward
    mesh = Mesh(axes, device="cuda")
    cfg = mixtral_cfg(2)
    out = {"mesh": str(mesh)}
    for mode in modes:
        full = init_params_device(cfg, mode, seed=14, device=mesh.device)
        if "tp" in axes:
            params, fwd = shard_llama_params(full, mesh), tp_llama_forward(mesh, cfg)
        else:
            params, fwd = shard_moe_params(full, mesh), ep_llama_forward(mesh, cfg)
        del full
        torch.cuda.empty_cache()
        cache = KVCache.create(local_config(cfg, mesh.size("tp")), 1, quantized=True,
                               device=mesh.device)
        toks = _moe_tokens(cfg)
        reset_launch_counts()
        logits, cache = fwd(params, toks, cache, 0)
        step, _ = fwd(params, toks[:, -1:], cache, toks.shape[1])
        torch.cuda.synchronize()
        out[mode] = dict(logits=logits[0, -1].float().cpu().numpy(),
                         step=step[0, -1].float().cpu().numpy(), counts=dict(launch_counts),
                         experts=int(params["layers"][0]["w1"].values.shape[0]))
        del params, cache
        torch.cuda.empty_cache()
    return out


def _moe_tokens(cfg):
    import torch
    g = torch.Generator().manual_seed(14)
    return torch.randint(1, cfg.vocab_size, (1, 128), generator=g)


def _cos(a, b) -> float:
    from csinn2_tpu_torch.utils.verify import cosine_similarity
    return float(cosine_similarity(a, b))


def _check_mesh_run(label, ranks, ref, gpu_line, mode, floor=None, parity=None):
    """Every rank's tokens equal; every rank launched the path's kernels;
    the prefill and first-step logits of each rank against the
    single-process run's: cosine >= 0.999, or, where `floor` (the
    single-process run against itself with a perturbed embedding, _noise_floor)
    is given, above the floor's cosines, with `parity` (the single-process
    run of the model at PARITY_LAYERS) held at >= 0.999 instead; the share of
    greedy tokens equal to the single process; each rank's launches and the
    collectives a decode step with their host-clock staging time."""
    import numpy as np
    from csinn2_tpu_torch.kernels.qmatmul import launch_key
    qmm = launch_key(*QMM_MODES[mode], swiglu=False)
    want = (f"{qmm}.decode", f"{qmm}.prefill", "decode_attention", "prefill_attention")
    for i, r in enumerate(ranks):
        missing = [k for k in want if r["counts"].get(k, 0) == 0]
        if missing:
            raise AssertionError(f"{label}: rank {i} never launched {missing}")
    for r in ranks[1:]:
        if r["outs"] != ranks[0]["outs"]:
            raise AssertionError(f"{label}: rank tokens differ: {ranks[0]['outs']} vs {r['outs']}")
    cos_prefill = min(_cos(r["logits"], ref["prefill_logits"]) for r in ranks)
    cos_step = min(_cos(r["step"][i], ref["step_logits"][i]) for r in ranks for i in range(4))
    same = sum(a == b for ra, rb in zip(ranks[0]["outs"], ref["outs"]) for a, b in zip(ra, rb))
    total = sum(len(o) for o in ref["outs"])
    r0 = ranks[0]
    per_step = {k: n / 8 for k, n in r0["chunk_counts"].items() if k.startswith("all_")}
    n_ar = sum(n for k, n in per_step.items() if k.startswith("all_reduce"))
    log(f"  {label}: {r0['mesh']}, backend {r0['backend']}, decode through "
        f"{'the step graph' if r0['graph'] else 'the eager loop'} ({r0['n_graphs']} graphs); "
        f"weights made whole and sharded in {r0['build_s']:.2f} s, {r0['mem_gib']:.2f} GiB a "
        f"rank after (weights + int8 KV + spare) [{gpu_line}]")
    log(f"  {label}: run_queue {len(r0['outs'])} requests in {r0['wall']:.3f} s (host clock, "
        f"{r0['steps']} decode steps) on every rank; tokens identical on all {len(ranks)} ranks; "
        f"greedy tokens equal to the single process: {same} of {total}; lanes {r0['slots']}")
    if floor is None:
        gate = (0.999, 0.999)
        log(f"  {label}: logits cosine against the single process: 128-token prefill "
            f"{cos_prefill:.6f}, first decode step (4 lanes, the same input tokens) "
            f"{cos_step:.6f} (gate 0.999)")
    else:
        gate = (floor["cos_prefill"], floor["cos_step"])
        cp2 = min(_cos(r["parity"]["logits"], parity["logits"]) for r in ranks)
        cs2 = min(_cos(r["parity"]["step"][i], parity["step"][i]) for r in ranks
                  for i in range(4))
        log(f"  {label}: logits cosine against the single process: 128-token prefill "
            f"{cos_prefill:.6f}, first decode step (4 lanes, the same input tokens) "
            f"{cos_step:.6f}; the single process against itself with its embedding "
            f"perturbed by 2^-8 (at most one bf16 ulp): {gate[0]:.6f} / {gate[1]:.6f} (gate: "
            f"above these); the same model cut to {PARITY_LAYERS} layers, sharded against "
            f"one process: {cp2:.6f} / {cs2:.6f} (gate 0.999)")
        if cp2 < 0.999 or cs2 < 0.999:
            raise AssertionError(f"{label}: {PARITY_LAYERS}-layer logits cosine {cp2} / {cs2}")
    for i, r in enumerate(ranks):
        log(f"  {label}: rank {i} {r['coords']} launches {r['counts']}")
    log(f"  {label}: a decode step (batch 4, 8-step chunk, host clock) {r0['chunk_ms_per_step']:.3f} "
        f"ms with collectives a step {per_step}; one all_reduce alone (host clock around "
        f"synchronize, median): decode shape {r0['ar_decode_ms']:.3f} ms, 128-token prefill "
        f"shape {r0['ar_prefill_ms']:.3f} ms, so {n_ar:g} a step stage ~{n_ar * r0['ar_decode_ms']:.1f} "
        f"ms through the host — gloo's staging, not a TP speed [{gpu_line}]")
    if cos_prefill < gate[0] or cos_step < gate[1]:
        raise AssertionError(f"{label}: logits cosine {cos_prefill} / {cos_step}, gate {gate}")
    if any(not np.isfinite(r["logits"]).all() for r in ranks):
        raise AssertionError(f"{label}: logits not finite")
    return dict(same=same, total=total, cos_prefill=cos_prefill, cos_step=cos_step,
                gate=gate, counts=[r["counts"] for r in ranks], ar_per_step=n_ar,
                ar_decode_ms=r0["ar_decode_ms"], step_ms=r0["chunk_ms_per_step"])


def _noise_floor(cfg, mode, ref):
    """The single-process engine of phase 4's model again (its logits must
    equal `ref`'s bit for bit) and with its embedding times (1 ± 2^-8)
    (signs seeded; at most one bf16 ulp): the cosines of the perturbed run's
    _parity_probe against `ref`, fed the same tokens, say how far two
    forwards of this model that differ by rounding alone may lie apart."""
    import numpy as np
    import torch
    from csinn2_tpu_torch.llm.engine import InferenceEngine
    from csinn2_tpu_torch.llm.model import init_params_device
    params = init_params_device(cfg, mode, seed=0, device="cuda")
    eng = InferenceEngine(cfg, params, batch=4, quantized_kv=True, device="cuda")
    again = _parity_probe(eng, cfg, ref["first"])
    if not (np.array_equal(again["logits"], ref["prefill_logits"])
            and np.array_equal(again["step"], ref["step_logits"])):
        raise AssertionError("the single-process engine is not deterministic across runs")
    g = torch.Generator(device="cuda").manual_seed(15)
    emb = params["tok_embedding"]
    sign = torch.randint(0, 2, emb.shape, generator=g, device="cuda", dtype=torch.int8) * 2 - 1
    # in place: the bucket's captured prefill graph reads this tensor's memory
    emb.copy_((emb.float() * (1 + sign * 2.0 ** -8)).to(torch.bfloat16))
    noisy = _parity_probe(eng, cfg, ref["first"])
    out = dict(cos_prefill=_cos(noisy["logits"], ref["prefill_logits"]),
               cos_step=min(_cos(noisy["step"][i], ref["step_logits"][i]) for i in range(4)))
    del eng, params, emb, sign
    torch.cuda.empty_cache()
    return out


def _moe_reference(mode):
    """The single-process llama_forward of mesh_moe_job's model: the last
    prompt row's and the decode step's logits."""
    import torch
    from csinn2_tpu_torch.llm.model import KVCache, init_params_device, llama_forward
    cfg = mixtral_cfg(2)
    params = init_params_device(cfg, mode, seed=14, device="cuda")
    toks = _moe_tokens(cfg)
    cache = KVCache.create(cfg, 1, quantized=True, device="cuda")
    logits, cache = llama_forward(params, toks, cache, 0, cfg)
    step, _ = llama_forward(params, toks[:, -1:], cache, toks.shape[1], cfg)
    out = dict(logits=logits[0, -1].float().cpu().numpy(), step=step[0, -1].float().cpu().numpy())
    del params, cache
    torch.cuda.empty_cache()
    return out


def mesh_path(here: Path, records, gpu_line: str, q8_0_ref):
    """Phase 14.  Returns {label: summary} for the kernels line."""
    import dataclasses
    import torch
    from csinn2_tpu_torch.llm.config import LlamaConfig
    from csinn2_tpu_torch.llm.engine import InferenceEngine
    from csinn2_tpu_torch.llm.model import init_params_device
    from csinn2_tpu_torch.parallel.launch import spawn
    t_phase = time.perf_counter()
    summary = {}
    log("  (a) the kernels at a rank's shapes under tp = 2")
    check_shard_gemms(records, gpu_line)
    check_attention(records, heads=16, tag="tp_shards")
    torch.cuda.empty_cache()

    log("  (b) tp = 2, dp = 1: two ranks on the card over gloo, Llama-2-7B Q8_0, 32 layers, "
        "int8 KV, run_queue batch 4 (phase 4's requests)")
    cfg = LlamaConfig.llama2_7b()
    floor = _noise_floor(cfg, "q8_0", q8_0_ref)
    cfg2 = dataclasses.replace(cfg, n_layers=PARITY_LAYERS)
    parity = _parity_probe(InferenceEngine(cfg2, init_params_device(cfg2, "q8_0", seed=0,
                                                                    device="cuda"),
                                           batch=4, quantized_kv=True, device="cuda"), cfg2)
    torch.cuda.empty_cache()
    ranks = spawn(mesh_engine_job, 2, backend="gloo", device="cuda", timeout_s=MESH_TIMEOUT_S,
                  args=("q8_0", 32, 2, 1, q8_0_ref["first"], parity["first"]))
    summary["tp2_q8_0"] = _check_mesh_run("(b) tp2 Q8_0", ranks, q8_0_ref, gpu_line, "q8_0",
                                          floor, parity)
    tp2_outs = ranks[0]["outs"]
    del ranks

    log("  (c) tp = 2 x dp = 2: four ranks on the card over gloo, Llama-2-7B width, 4 layers, "
        "Q4_0, int8 KV, run_queue batch 4 (lanes of both dp groups)")
    cfg4 = dataclasses.replace(LlamaConfig.llama2_7b(), n_layers=4)
    one = InferenceEngine(cfg4, init_params_device(cfg4, "q4_0", seed=0, device="cuda"),
                          batch=4, quantized_kv=True, device="cuda")
    ref4 = _engine_probe(one, cfg4)
    ref4.update(prefill_logits=ref4["logits"], step_logits=ref4["step"])
    del one
    torch.cuda.empty_cache()
    ranks = spawn(mesh_engine_job, 4, backend="gloo", device="cuda", timeout_s=MESH_TIMEOUT_S,
                  args=("q4_0", 4, 2, 2, ref4["first"]))
    if sorted({s // 2 for s in ranks[0]["slots"]}) != [0, 1]:
        raise AssertionError(f"(c): requests did not land in both dp groups: {ranks[0]['slots']}")
    summary["tp2dp2_q4_0"] = _check_mesh_run("(c) tp2 x dp2 Q4_0", ranks, ref4, gpu_line,
                                             "q4_0")
    del ranks

    log("  (d) EP at Mixtral-8x7B width (2 layers, E = 8, top-2), Q8_0 and Q4_0, int8 KV: "
        "ep = 2 on two ranks, then tp = 2 x ep = 2 on four, against the single-process "
        "llama_forward")
    refs = {mode: _moe_reference(mode) for mode in ("q8_0", "q4_0")}
    for axes in ({"ep": 2}, {"ep": 2, "tp": 2}):
        n = 2 if len(axes) == 1 else 4
        ranks = spawn(mesh_moe_job, n, backend="gloo", device="cuda", timeout_s=MESH_TIMEOUT_S,
                      args=(axes,))
        for mode, ref in refs.items():
            cp = min(_cos(r[mode]["logits"], ref["logits"]) for r in ranks)
            cs = min(_cos(r[mode]["step"], ref["step"]) for r in ranks)
            log(f"  (d) {axes} {mode}: {ranks[0][mode]['experts']} "
                f"experts a rank; logits cosine vs single process: 128-token prompt {cp:.6f}, "
                f"decode step {cs:.6f} (gate 0.999); rank 0 launches {ranks[0][mode]['counts']}")
            if cp < 0.999 or cs < 0.999:
                raise AssertionError(f"(d) {axes} {mode}: cosine {cp} / {cs}")
            summary[f"{'x'.join(f'{k}{v}' for k, v in axes.items())}_{mode}"] = dict(
                cos_prefill=cp, cos_step=cs, counts=ranks[0][mode]["counts"])
        del ranks

    log("  (e) csinn2_tpu_torch/examples/multihost_dryrun.py --device cuda, a process of its own")
    r = subprocess.run([sys.executable, str(here / "csinn2_tpu_torch" / "examples" /
                                            "multihost_dryrun.py"), "--device", "cuda"],
                       cwd=str(here), capture_output=True, text=True, timeout=MESH_TIMEOUT_S)
    for line in r.stdout.strip().splitlines()[-6:]:
        log(f"    {line}")
    if r.returncode != 0 or "PASS" not in r.stdout:
        raise AssertionError(f"(e) multihost_dryrun.py: exit {r.returncode}\n{r.stderr[-4000:]}")

    if torch.cuda.device_count() >= 2:
        log("  (f) (b) again over NCCL, one card a rank, through the step graph")
        ranks = spawn(mesh_engine_job, 2, backend="nccl", device="cuda",
                      timeout_s=MESH_TIMEOUT_S,
                      args=("q8_0", 32, 2, 1, q8_0_ref["first"], parity["first"]))
        summary["tp2_q8_0_nccl"] = _check_mesh_run("(f) tp2 Q8_0 NCCL", ranks, q8_0_ref,
                                                   gpu_line, "q8_0", floor, parity)
        if ranks[0]["outs"] != tp2_outs or not ranks[0]["graph"]:
            raise AssertionError(f"(f) NCCL tokens {ranks[0]['outs']} != gloo's {tp2_outs}")
        summary["nccl_path"] = "run: tokens equal to (b)'s"
    else:
        log(f"  (f) NCCL path: not run, {torch.cuda.device_count()} card")
        summary["nccl_path"] = f"not run, {torch.cuda.device_count()} card"
    log(f"  phase 14: {time.perf_counter() - t_phase:.1f} s")
    return summary


# ---------------------------------------------------------------------------
# phase 15: context and pipeline parallelism over ranks sharing the card
# ---------------------------------------------------------------------------

# (a): (S, cp, dtype, causal) at Llama-2-7B's attention width (b 1, 32 heads,
# d 128); S = 4096 is Llama-2's published context
RING_CASES = tuple((4096, cp, dt, causal) for cp in (2, 4) for dt in ("f32", "bf16")
                   for causal in (True, False)) + ((16384, 4, "bf16", True),)
RING_TOL = {"f32": 2e-5, "bf16": 0.05}        # tests/test_ring_attention.py
RING_HEADS, RING_D = 32, 128
PP_PROMPT, PP_BATCH, PP_STEPS = 128, 4, 8


def _ring_qkv(S: int, dtype: str, device):
    """(a)'s q, k, v [1, 32, S, 128] from a seed on the card (the same
    tensors in every process)."""
    import torch
    g = torch.Generator(device=device).manual_seed(15 + S)
    dt = torch.float32 if dtype == "f32" else torch.bfloat16
    return [torch.randn((1, RING_HEADS, S, RING_D), generator=g, device=device).to(dt)
            for _ in range(3)]


def ring_job():
    """One of (a)'s four ranks: every RING_CASES case on its cp mesh (cp = 2
    as two rings of the mesh {"r": 2, "cp": 2}, cp = 4 as one): a warm call,
    then two calls timed by the host clock around synchronize, the shifts a
    call counted; the output shard of ring 0; then one shift of a [1, 32,
    2048, 128] bf16 block along the cp = 4 ring, timed alone (gloo's host
    staging of a hop at S/n = 2048)."""
    import torch
    from csinn2_tpu_torch.kernels import launch_counts, reset_launch_counts
    from csinn2_tpu_torch.parallel.cp import ring_attention, shard_sequence
    from csinn2_tpu_torch.parallel.mesh import Mesh, shift
    meshes = {2: Mesh({"r": 2, "cp": 2}, device="cuda"), 4: Mesh({"cp": 4}, device="cuda")}
    out = {"cases": []}
    for S, cp, dtype, causal in RING_CASES:
        mesh = meshes[cp]
        q, k, v = (shard_sequence(t, mesh) for t in _ring_qkv(S, dtype, mesh.device))
        ring_attention(q, k, v, mesh, causal=causal)
        times = []
        for _ in range(2):
            reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            o = ring_attention(q, k, v, mesh, causal=causal)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        shifts = launch_counts["p2p.cp"]
        if shifts != 2 * (cp - 1):
            raise AssertionError(f"(a) S={S} cp={cp}: {shifts} shifts a call, want {2 * (cp - 1)}")
        rec = dict(S=S, cp=cp, dtype=dtype, causal=causal, ms=min(times), shifts=shifts)
        if mesh.index("r") == 0:
            rec["out"] = (o.view(torch.int16) if dtype == "bf16" else o).cpu().numpy()
        out["cases"].append(rec)
        del q, k, v, o
        torch.cuda.empty_cache()
    blk = torch.ones((1, RING_HEADS, 2048, RING_D), dtype=torch.bfloat16, device=meshes[4].device)
    hops = []
    for i in range(12):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        shift(blk, meshes[4], "cp", 1, "timing")
        torch.cuda.synchronize()
        if i >= 2:
            hops.append((time.perf_counter() - t0) * 1e3)
    out["hop_ms"] = statistics.median(hops)
    out["coords"] = meshes[2].coords
    return out


def ring_path(gpu_line):
    """Phase 15 (a): the ranks' outputs put together against
    ring_attention_reference in this process on the card."""
    import numpy as np
    import torch
    from csinn2_tpu_torch.parallel.cp import ring_attention_reference
    from csinn2_tpu_torch.parallel.launch import spawn
    ranks = spawn(ring_job, 4, backend="gloo", device="cuda", timeout_s=MESH_TIMEOUT_S)
    summary = []
    for i, (S, cp, dtype, causal) in enumerate(RING_CASES):
        q, k, v = _ring_qkv(S, dtype, "cuda")
        want = ring_attention_reference(q, k, v, causal=causal,
                                        q_block=1024 if S > 4096 else None).float()
        del q, k, v
        parts = [r["cases"][i]["out"] for r in ranks[:cp]]
        got = np.concatenate([p.view(np.int16) if dtype == "bf16" else p for p in parts], axis=2)
        got = torch.from_numpy(got).to("cuda")
        got = got.view(torch.bfloat16).float() if dtype == "bf16" else got
        tol = RING_TOL[dtype]
        err = float((got - want).abs().max())
        ok = bool(torch.allclose(got, want, rtol=tol, atol=tol))
        ms = [r["cases"][i]["ms"] for r in ranks]
        log(f"  (a) ring_attention S={S:5d} cp={cp} {dtype:4s} causal={int(causal)}: max_abs_err "
            f"{err:.3e} vs ring_attention_reference (rtol = atol = {tol}); host ms a call, rank 0 "
            f"{ms[0]:.2f} (ranks {min(ms):.2f}-{max(ms):.2f}), p2p.cp {ranks[0]['cases'][i]['shifts']} "
            f"a rank a call [{gpu_line}]")
        if not ok:
            raise AssertionError(f"(a) ring S={S} cp={cp} {dtype} causal={causal}: max err {err}")
        summary.append(dict(S=S, cp=cp, dtype=dtype, causal=causal, max_abs_err=err,
                            host_ms=ms[0], shifts=ranks[0]["cases"][i]["shifts"]))
        del got, want
        torch.cuda.empty_cache()
    hop = ranks[0]["hop_ms"]
    log(f"  (a) one hop of a [1, 32, 2048, 128] bf16 K block (16 MiB) along the cp = 4 ring, "
        f"host clock around synchronize: {hop:.3f} ms (gloo's staging through the host, not a "
        f"link speed); each call shifts K and V 2 (cp - 1) times a rank, the JAX loop's last, "
        f"dead hop left out [{gpu_line}]")
    return dict(cases=summary, hop_ms_2048=hop)


def _pp_tokens(cfg):
    """(b)'s prompts: PP_BATCH seeded rows of PP_PROMPT tokens."""
    import torch
    g = torch.Generator().manual_seed(15)
    return torch.randint(1, cfg.vocab_size, (PP_BATCH, PP_PROMPT), generator=g)


def _digest(t) -> str:
    import hashlib
    return hashlib.sha256(t.contiguous().cpu().numpy().tobytes()).hexdigest()


def _cache_digests(cache, lo, hi, rows):
    """sha256 of layers lo..hi-1, rows 0..rows-1 of a cache's K and V."""
    return (_digest(cache.k[lo:hi, :, :rows]), _digest(cache.v[lo:hi, :, :rows]))


def _pp_run(fwd, tokens, feed):
    """Prefill `tokens` and PP_STEPS decode steps fed `feed` [B, PP_STEPS]
    through fwd(tokens, pos) → logits; the launches of the run (counts
    zeroed just before) and the decode steps' host times."""
    import numpy as np
    import torch
    from csinn2_tpu_torch.kernels import launch_counts, reset_launch_counts
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits = fwd(tokens, 0)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    steps, step_ms = [], []
    for i in range(feed.shape[1]):
        t0 = time.perf_counter()
        steps.append(fwd(feed[:, i:i + 1], tokens.shape[1] + i)[:, -1])
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    return dict(logits=logits.float().cpu().numpy(),
                steps=torch.stack(steps).float().cpu().numpy(), counts=dict(launch_counts),
                prefill_ms=prefill_ms, step_ms=float(np.median(step_ms)))


def pp_spmd_job(mode: str, n_layers: int, axes: dict, Ms, tokens, feed, cache_arrays: bool):
    """One rank of (b) or (c): Llama-2-7B geometry at n_layers, `mode`
    weights made whole on the card from phase 4's seed, an int8 KV cache;
    for each M in Ms an SPMDPipelinedLlama(microbatches=M) on the mesh
    `axes` keeps its stage's layers (its tp shard of them), then _pp_run;
    its cache's written rows as sha256 digests, or as arrays."""
    import dataclasses
    import torch
    from csinn2_tpu_torch.llm.config import LlamaConfig
    from csinn2_tpu_torch.llm.model import init_params_device
    from csinn2_tpu_torch.parallel.mesh import Mesh
    from csinn2_tpu_torch.parallel.pp import SPMDPipelinedLlama
    mesh = Mesh(axes, device="cuda")
    cfg = dataclasses.replace(LlamaConfig.llama2_7b(), n_layers=n_layers)
    full = init_params_device(cfg, mode, seed=0, device=mesh.device)
    out = dict(coords=mesh.coords, backend=mesh.backend(), runs={})
    rows = tokens.shape[1] + feed.shape[1]
    for M in Ms:
        t0 = time.perf_counter()
        pipe = SPMDPipelinedLlama(full, cfg, mesh=mesh, microbatches=M)
        cache = pipe.init_cache(tokens.shape[0], quantized=True)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0

        def fwd(t, pos):
            return pipe(t, cache, pos)[0]
        run = _pp_run(fwd, tokens, feed)
        run.update(build_s=build_s, stage=pipe.stage, Lp=pipe.Lp,
                   mem_gib=torch.cuda.memory_allocated(mesh.device) / 2**30,
                   digests=_cache_digests(cache, 0, pipe.Lp, rows))
        if cache_arrays:
            run["cache"] = (cache.k[:, :, :rows].cpu().numpy(), cache.v[:, :, :rows].cpu().numpy())
        if mesh.rank != 0:
            run["logits_digest"] = (_digest(torch.from_numpy(run.pop("logits"))),
                                    _digest(torch.from_numpy(run.pop("steps"))))
        out["runs"][M] = run
        del pipe, cache
        torch.cuda.empty_cache()
    return out


def _reference_runs(params, cfg, tokens, Ms):
    """The one-process forward over (b)'s inputs: the batch whole through
    llama_forward, whose greedy tokens every other run is fed; and for each
    M > 1 in Ms llama_forward's pieces microbatch by microbatch (the layers
    of each microbatch into its cache rows, then the head over each
    microbatch, which is llama_forward run microbatch by microbatch, and
    the head over the whole batch, the SPMD pipeline's function).  Per M:
    the logits, the decode steps' logits and the cache (int8 KV)."""
    import torch
    from csinn2_tpu_torch.llm.model import (KVCache, embed_tokens, llama_forward, llama_head,
                                            llama_layers)
    B = tokens.shape[0]
    cache = KVCache.create(cfg, B, quantized=True, device="cuda")
    logits, cache = llama_forward(params, tokens, cache, 0, cfg)
    nxt, cols, steps = logits[:, -1].argmax(-1), [], []
    for i in range(PP_STEPS):
        cols.append(nxt)
        lg = llama_forward(params, nxt[:, None].cpu(), cache, tokens.shape[1] + i, cfg)[0][:, -1]
        steps.append(lg)
        nxt = lg.argmax(-1)
    feed = torch.stack(cols, dim=1).cpu()
    out = {1: dict(logits=logits.float().cpu().numpy(),
                   steps=torch.stack(steps).float().cpu().numpy(), cache=cache)}
    for M in (m for m in Ms if m != 1):
        cache = KVCache.create(cfg, B, quantized=True, device="cuda")
        mb = B // M
        runs = {"per_mb": ([], []), "whole_head": ([], [])}
        for i in range(PP_STEPS + 1):
            t, pos = (tokens, 0) if i == 0 else (feed[:, i - 1:i], tokens.shape[1] + i - 1)
            x = embed_tokens(params, t)
            h = torch.cat([llama_layers(params["layers"], x[m * mb:(m + 1) * mb],
                                        KVCache(k=cache.k[:, m * mb:(m + 1) * mb],
                                                v=cache.v[:, m * mb:(m + 1) * mb],
                                                scale=cache.scale), pos, cfg)
                           for m in range(M)])
            for key, lg in (("per_mb", torch.cat([llama_head(params, h[m * mb:(m + 1) * mb], cfg)
                                                  for m in range(M)])),
                            ("whole_head", llama_head(params, h, cfg))):
                runs[key][0 if i == 0 else 1].append(lg if i == 0 else lg[:, -1])
        out[M] = {key: dict(logits=lgs[0].float().cpu().numpy(),
                            steps=torch.stack(st).float().cpu().numpy())
                  for key, (lgs, st) in runs.items()}
        out[M]["cache"] = cache
    return out, feed


def _require_launches(counts, names, label):
    """Fails where a kernel of the run's path launched no time in it."""
    missing = [n for n in names if launches(counts, n) == 0]
    if missing:
        raise AssertionError(f"{label}: never launched {missing}: {counts}")


def _exact(a, b) -> bool:
    import numpy as np
    return bool(np.array_equal(a, b))


def pp_path(gpu_line):
    """Phase 15 (b): pp = 2 at Llama-2-7B Q8_0, 32 layers, int8 KV."""
    import numpy as np
    import torch
    from csinn2_tpu_torch.llm.config import LlamaConfig
    from csinn2_tpu_torch.llm.model import init_params_device
    from csinn2_tpu_torch.parallel.launch import spawn
    from csinn2_tpu_torch.parallel.pp import PipelinedLlama
    cfg = LlamaConfig.llama2_7b()
    tokens = _pp_tokens(cfg)
    params = init_params_device(cfg, "q8_0", seed=0, device="cuda")
    ref, feed = _reference_runs(params, cfg, tokens, (2,))
    rows = PP_PROMPT + PP_STEPS
    half = cfg.n_layers // 2
    ref_dig = {M: [_cache_digests(ref[M]["cache"], s * half, (s + 1) * half, rows)
                   for s in range(2)] for M in ref}
    for M in ref:
        del ref[M]["cache"]
    torch.cuda.empty_cache()
    out = {"pipelined": {}, "spmd": {}}

    # PipelinedLlama, both stages on cuda:0 (the stage params are the same
    # tensors: no copy)
    pipe = PipelinedLlama(params, cfg, ["cuda:0", "cuda:0"])
    for M in (1, 2):
        caches = pipe.init_caches(PP_BATCH, quantized=True)

        def fwd(t, pos):
            return pipe(t, caches, pos, microbatches=M)[0]
        run = _pp_run(fwd, tokens, feed)
        dig = [_cache_digests(c, 0, half, rows) for c in caches]
        want = ref[1] if M == 1 else ref[M]["per_mb"]
        exact = dict(logits=_exact(run["logits"], want["logits"]),
                     steps=_exact(run["steps"], want["steps"]), cache=dig == ref_dig[M])
        log(f"  (b) PipelinedLlama, 2 stages on cuda:0, microbatches {M}: logits of the prefill "
            f"and of {PP_STEPS} decode steps, and every layer's K/V rows, bit for bit against "
            f"llama_forward {'(the batch whole)' if M == 1 else 'microbatch by microbatch'}: "
            f"{exact}; prefill {run['prefill_ms']:.2f} ms, a decode step {run['step_ms']:.2f} ms "
            f"(host clock) [{gpu_line}]")
        if not all(exact.values()):
            raise AssertionError(f"(b) PipelinedLlama M={M}: {exact}")
        _require_launches(run["counts"], ("quant_matmul", "flash_attention"),
                          f"(b) PipelinedLlama M={M}")
        out["pipelined"][M] = dict(exact=exact, counts=run["counts"],
                                   prefill_ms=run["prefill_ms"], step_ms=run["step_ms"])
        del caches
    del pipe, params
    torch.cuda.empty_cache()

    ranks = spawn(pp_spmd_job, 2, backend="gloo", device="cuda", timeout_s=MESH_TIMEOUT_S,
                  args=("q8_0", cfg.n_layers, {"pp": 2}, (1, 2), tokens, feed, False))
    for M in (1, 2):
        runs = [r["runs"][M] for r in ranks]
        r0 = runs[0]
        same = all(r["logits_digest"] == (_digest(torch.from_numpy(r0["logits"])),
                                          _digest(torch.from_numpy(r0["steps"])))
                   for r in runs[1:])
        cache_ok = [r["digests"] == ref_dig[M][r["stage"]] for r in runs]
        # one microbatch: llama_forward on the whole batch; two: its pieces
        # microbatch by microbatch with the head over the whole batch
        want = ref[1] if M == 1 else ref[M]["whole_head"]
        cos = min(_cos(r0["logits"], ref[1]["logits"]), _cos(r0["steps"], ref[1]["steps"]))
        exact = dict(logits=_exact(r0["logits"], want["logits"]),
                     steps=_exact(r0["steps"], want["steps"]))
        for i, r in enumerate(runs):
            log(f"  (b) SPMD pp = 2 M={M} rank {i} stage {r['stage']}: p2p.pp "
                f"{r['counts'].get('p2p.pp', 0)} sends, {r['counts'].get('p2p.pp.recv', 0)} "
                f"receives, {r['counts'].get('pipeline.tick', 0)} ticks, "
                f"{r['counts'].get('pipeline.stage', 0)} stage computes; quant_matmul "
                f"{launches(r['counts'], 'quant_matmul')}, attention "
                f"{ {a: launches(r['counts'], a) for a in ATTENTION} }; prefill "
                f"{r['prefill_ms']:.2f} ms, an eager decode step {r['step_ms']:.2f} ms (host "
                f"clock; two ranks share the card, so not a PP speed); stage built in "
                f"{r['build_s']:.2f} s, {r['mem_gib']:.2f} GiB allocated after [{gpu_line}]")
        log(f"  (b) SPMD pp = 2 M={M}: logits equal on both ranks {same}; every layer's K/V "
            f"rows bit for bit against llama_forward "
            f"{'(the batch whole)' if M == 1 else 'microbatch by microbatch'}: {cache_ok}; "
            f"logits bit for bit against "
            f"{'it' if M == 1 else 'its pieces microbatch by microbatch, the head over the whole batch'}"
            f": {exact}; cosine against the whole batch {cos:.8f}"
            + ("" if M == 1 else f" (llama_forward microbatch by microbatch against the whole "
               f"batch: {_cos(ref[M]['per_mb']['logits'], ref[1]['logits']):.8f} / "
               f"{_cos(ref[M]['per_mb']['steps'], ref[1]['steps']):.8f}, prefill / steps: every "
               "GEMM and attention call sees half the rows, and 32 layers amplify the rounding)"))
        for i, r in enumerate(runs):
            _require_launches(r["counts"], ("quant_matmul", "flash_attention"),
                              f"(b) SPMD M={M} rank {i}")
        if not (same and all(cache_ok) and all(exact.values())):
            raise AssertionError(f"(b) SPMD M={M}: same {same} cache {cache_ok} exact {exact} "
                                 f"cos {cos}")
        out["spmd"][M] = dict(exact=exact, cache_exact=cache_ok, cos=cos,
                              counts=[r["counts"] for r in runs],
                              step_ms=r0["step_ms"], prefill_ms=r0["prefill_ms"])
        if M > 1:
            out["spmd"][M]["cos_llama_forward_per_mb"] = _cos(ref[M]["per_mb"]["logits"],
                                                              ref[1]["logits"])
    return out


def pp_tp_path(gpu_line):
    """Phase 15 (c): pp = 2 x tp = 2 on four ranks, Llama-2-7B width, 4
    layers, Q4_0, int8 KV, microbatches 2, against one process."""
    import dataclasses
    import numpy as np
    import torch
    from csinn2_tpu_torch.llm.config import LlamaConfig
    from csinn2_tpu_torch.llm.model import init_params_device
    from csinn2_tpu_torch.parallel.launch import spawn
    cfg = dataclasses.replace(LlamaConfig.llama2_7b(), n_layers=4)
    tokens = _pp_tokens(cfg)
    params = init_params_device(cfg, "q4_0", seed=0, device="cuda")
    ref, feed = _reference_runs(params, cfg, tokens, (1,))
    ref = ref[1]
    rows = PP_PROMPT + PP_STEPS
    ck = (ref["cache"].k[:, :, :rows].float() * ref["cache"].scale).cpu().numpy()
    cv = (ref["cache"].v[:, :, :rows].float() * ref["cache"].scale).cpu().numpy()
    scale = ref["cache"].scale
    del params, ref["cache"]
    torch.cuda.empty_cache()
    ranks = spawn(pp_spmd_job, 4, backend="gloo", device="cuda", timeout_s=MESH_TIMEOUT_S,
                  args=("q4_0", 4, {"pp": 2, "tp": 2}, (2,), tokens, feed, True))
    runs = [r["runs"][2] for r in ranks]
    r0 = runs[0]
    cos = (_cos(r0["logits"], ref["logits"]), _cos(r0["steps"], ref["steps"]))
    hk = cfg.n_kv_heads // 2
    cache_cos = []
    for r, run in zip(ranks, runs):
        lo, t = run["stage"] * run["Lp"], r["coords"]["tp"]
        k, v = (a.astype(np.float32) * scale for a in run["cache"])
        cache_cos.append(min(_cos(k, ck[lo:lo + run["Lp"], ..., t * hk:(t + 1) * hk, :]),
                             _cos(v, cv[lo:lo + run["Lp"], ..., t * hk:(t + 1) * hk, :])))
    log(f"  (c) pp = 2 x tp = 2, Q4_0, 4 layers, M = 2: logits cosine against one process "
        f"prefill {cos[0]:.6f}, {PP_STEPS} decode steps {cos[1]:.6f} (gate 0.999); each rank's "
        f"K/V block (its 2 layers, its 16 heads) against the one process's: "
        f"{[round(c, 6) for c in cache_cos]} (gate 0.999) [{gpu_line}]")
    for i, (r, run) in enumerate(zip(ranks, runs)):
        c = run["counts"]
        log(f"  (c) rank {i} {r['coords']}: p2p.pp {c.get('p2p.pp', 0)} / recv "
            f"{c.get('p2p.pp.recv', 0)}, all_reduce {c.get('all_reduce.wo', 0)} wo + "
            f"{c.get('all_reduce.w2', 0)} w2, quant_matmul_q4_0 "
            f"{launches(c, 'quant_matmul_q4_0')}, attention "
            f"{ {a: launches(c, a) for a in ATTENTION} }; an eager decode step "
            f"{run['step_ms']:.2f} ms (host clock, four ranks on one card)")
    for i, run in enumerate(runs):
        _require_launches(run["counts"], ("quant_matmul_q4_0", "prefill_attention",
                                          "flash_attention"), f"(c) rank {i}")
    if min(cos) < 0.999 or min(cache_cos) < 0.999:
        raise AssertionError(f"(c) pp x tp: logits cosine {cos}, caches {cache_cos}")
    return dict(cos_prefill=cos[0], cos_steps=cos[1], cache_cos=cache_cos,
                counts=[run["counts"] for run in runs], step_ms=r0["step_ms"])


def pp_moe_path(gpu_line):
    """Phase 15 (d): PipelinedLlama, 2 stages on cuda:0, at Mixtral-8x7B
    width (2 layers, Q4_0), a 128-token prompt, against llama_forward."""
    import torch
    from csinn2_tpu_torch.kernels import launch_counts, reset_launch_counts
    from csinn2_tpu_torch.llm.model import KVCache, init_params_device, llama_forward
    from csinn2_tpu_torch.parallel.pp import PipelinedLlama
    cfg = mixtral_cfg(2)
    params = init_params_device(cfg, "q4_0", seed=14, device="cuda")
    toks = _moe_tokens(cfg)
    want, _ = llama_forward(params, toks, KVCache.create(cfg, 1, quantized=True, device="cuda"),
                            0, cfg)
    pipe = PipelinedLlama(params, cfg, ["cuda:0", "cuda:0"])
    reset_launch_counts()
    got, _ = pipe(toks, pipe.init_caches(1, quantized=True), 0)
    torch.cuda.synchronize()
    counts = dict(launch_counts)
    cos = _cos(got.float().cpu().numpy(), want.float().cpu().numpy())
    exact = bool(torch.equal(got, want))
    log(f"  (d) pp x MoE: PipelinedLlama 2 stages x 1 layer at Mixtral-8x7B width (E = 8, "
        f"top-2, dense), Q4_0, 128-token prompt: logits cosine against llama_forward "
        f"{cos:.8f} (gate 0.999), bit for bit {exact}; quant_matmul_q4_0 launches "
        f"{launches(counts, 'quant_matmul_q4_0')} (2 x (4 + 3E) + 1 = {2 * (4 + 3 * E_MOE) + 1}) "
        f"[{gpu_line}]")
    if cos < 0.999:
        raise AssertionError(f"(d) pp x MoE: cosine {cos}")
    _require_launches(counts, ("quant_matmul_q4_0", "prefill_attention"), "(d) pp x MoE")
    del params, pipe
    torch.cuda.empty_cache()
    return dict(cos=cos, exact=exact, counts=counts)


def _pp_launches(pipeline, name: str) -> dict:
    """Phase 15's launches of kernel `name`: each run whose weights it
    serves (Q8_0: (b); Q4_0: (c), (d); attention: all), a list per rank for
    the SPMD runs."""
    b, runs = pipeline["pp2_q8_0"], {}
    if name != "quant_matmul_q4_0":
        for M in (1, 2):
            runs[f"pipelined_m{M}"] = launches(b["pipelined"][M]["counts"], name)
            runs[f"spmd_m{M}"] = [launches(c, name) for c in b["spmd"][M]["counts"]]
    if name != "quant_matmul":
        runs["pp2xtp2_m2"] = [launches(c, name) for c in pipeline["pp2tp2_q4_0"]["counts"]]
        runs["pp_moe"] = launches(pipeline["pp_moe_q4_0"]["counts"], name)
    return runs


def _without_counts(tree):
    if isinstance(tree, dict):
        return {k: _without_counts(v) for k, v in tree.items() if k != "counts"}
    if isinstance(tree, list):
        return [_without_counts(v) for v in tree]
    return tree


def pipeline_path(gpu_line):
    """Phase 15.  Returns the kernels line's "pipeline" summary (with each
    run's counts and each part's seconds)."""
    t_phase = time.perf_counter()
    parts = (
        ("ring", ring_path, "(a) ring attention at Llama-2-7B attention width (b 1, 32 heads, "
         "d 128), four ranks on the card over gloo: S = 4096 at cp = 2 and 4, f32 and bf16, "
         "causal and not; S = 16384 at cp = 4, bf16, causal"),
        ("pp2_q8_0", pp_path, f"(b) pp = 2, Llama-2-7B Q8_0, 32 layers, int8 KV: batch "
         f"{PP_BATCH} of {PP_PROMPT}-token prompts, then {PP_STEPS} greedy decode steps fed the "
         "one-process run's tokens"),
        ("pp2tp2_q4_0", pp_tp_path, "(c) pp = 2 x tp = 2 on four ranks over gloo, Llama-2-7B "
         "width, 4 layers, Q4_0, int8 KV, microbatches 2"),
        ("pp_moe_q4_0", pp_moe_path, "(d) pp x MoE at Mixtral-8x7B width"))
    out, seconds = {}, {}
    for key, run, text in parts:
        log(f"  {text}")
        t0 = time.perf_counter()
        out[key] = run(gpu_line)
        seconds[key] = time.perf_counter() - t0
        log(f"  {text[:3]} {seconds[key]:.1f} s")
    out["seconds"] = dict(seconds, phase=time.perf_counter() - t_phase)
    log(f"  phase 15: {out['seconds']['phase']:.1f} s")
    return out

def main() -> int:
    here = Path(__file__).resolve().parent
    if not (here / "csinn2_tpu_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke: the csinn2_tpu_torch package is not beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(here))
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    from csinn2_tpu_torch.kernels import _build

    t_start = time.perf_counter()
    gpu_line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]
    log(f"phase 1: card [{gpu_line}] torch {torch.__version__} CUDA {torch.version.cuda} "
        f"devices {torch.cuda.device_count()}")
    _build.libs()
    log(f"  kernels built and loaded in {_build.build_seconds:.2f} s")
    for name, text in _build.build_logs().items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")

    records = {}
    log("phase 2: kernels against their plain versions at 7B shapes")
    check_gemm_plan()
    check_quant_matmul(records)
    check_attention(records)
    check_decode_prologue(records)
    check_new_quant_matmul(records)
    check_int8dot_cold(records)
    check_flash_bhsd(records)
    check_attention_dims(records)
    # kernel name → (launch counts of the run whose path it is on, the run)
    path_counts = {"attention_wide": (check_attention_wide(records),
                                      f"phase 2 (the four entry points at d = {WIDE_DS}, "
                                      "MLA's decode)")}
    torch.cuda.empty_cache()
    api_counts = kernel_api_path()
    for k in ("quant_matmul_none", "quant_matmul_int8dot", "quant_matmul_requant"):
        path_counts[k] = (api_counts, "phase 2 (kernel API: no package caller)")
    log("phase 3: model parity (card vs cpu plain path)")
    for mode, swiglu in (("q8_0", False), ("q4_0", False), ("int8", False), ("int4", False),
                         ("q4_0", True)):
        model_parity(mode, swiglu)
        torch.cuda.empty_cache()
    # kernel name → qmm_reduce launches per decode step of its serving run
    reduce_per_step = {}
    log("phase 4: the first slice's main path, Llama-2-7B Q8_0 int8 KV, run_queue batch 4")
    q8_0 = serve(gpu_line, "q8_0")
    for k in ("quant_matmul", "decode_prologue") + ATTENTION:
        path_counts[k] = (q8_0["counts"], "phase 4 (Q8_0)")
    reduce_per_step["quant_matmul"] = q8_0["reduce_per_step"]
    serve_tiny()
    log("phase 5: this slice's main path, Llama-2-7B Q4_0 int8 KV, run_queue batch 4")
    for key, mode, swiglu, path in (
            ("quant_matmul_q4_0", "q4_0", False, "phase 5 (Q4_0)"),
            ("quant_matmul_channel", "int8", False, "phase 6 (INT8_CHANNEL)"),
            ("quant_matmul_int4_channel", "int4", False, "phase 6 (INT4_CHANNEL)"),
            ("quant_matmul_swiglu", "q4_0", True, "phase 6 (Q4_0, CSINN2_SWIGLU_FUSE=1)")):
        if key == "quant_matmul_channel":
            log("phase 6: the other weight modes' paths, Llama-2-7B int8 KV, run_queue batch 4")
        run = serve(gpu_line, mode, swiglu=swiglu)
        path_counts[key] = (run["counts"], path)
        reduce_per_step[key] = run["reduce_per_step"]
    log("phase 7: the CNN path, MobileNetV1 INT8_SYM 224, graph session, CSINN2_FUSE_DS=1")
    path_counts["fused_dsconv"] = (cnn_path(records, gpu_line),
                                   f"phase 7 (MobileNetV1 INT8_SYM, fused, batch {CNN_BATCH})")
    log("phase 8: the op API's CUDA tier at Llama-2-7B width (block fc, SDPA), "
        "GRAPH session and layer mode")
    op_counts = op_api_path(records, gpu_line)
    path_counts["quant_matmul_t"] = (op_counts,
                                     "phase 8 (op API, Q8_0/Q4_0 block fullyconnected)")
    path_counts["flash_attention_bhsd"] = (op_counts,
                                           "phase 8 (op API, SDPA prefill and decode)")
    log("phase 10: the probe path, the Q4_0 dequant-strategy probes at the 7B decode shapes")
    probe_counts = probe_path(records, gpu_line)
    for kind in PROBE_KERNELS:
        path_counts[f"int4_probe_{kind}"] = (probe_counts, "phase 10 (int4_dequant_probe, M=8)")
    log("phase 11: the port's LLM examples, llama_generate.py and llama7b_bench.py")
    examples_path(here)
    log("phase 12: MoE at Mixtral-8x7B width (E = 8, top-2), Q8_0 and Q4_0 experts on "
        "quant_matmul, int8 KV, max_seq_len cut to 2048")
    moe_counts = moe_path(here, records, gpu_line)
    log("phase 13: the LLM weight I/O, a Llama-2-7B-width GGUF -> python -m csinn2_tpu_torch "
        "convert -> load_llm -> logits, llama_generate.py --ckpt")
    wio_counts = weight_io_path(here, gpu_line)
    log("phase 14: tensor, data and expert parallelism, ranks sharing the card over gloo: "
        "kernels at tp-shard shapes, tp = 2 Llama-2-7B Q8_0, tp = 2 x dp = 2, EP at "
        "Mixtral-8x7B width, the multihost dryrun")
    mesh = mesh_path(here, records, gpu_line, q8_0)
    log("phase 15: context and pipeline parallelism, ranks sharing the card over gloo: ring "
        "attention at Llama-2-7B attention width, pp = 2 Llama-2-7B Q8_0 (PipelinedLlama and "
        "SPMDPipelinedLlama), pp = 2 x tp = 2, pp x MoE at Mixtral-8x7B width")
    pipeline = pipeline_path(gpu_line)
    log("phase 16: the rest of the CNN zoo at 224 through the graph session: MobileNetV2 "
        "UINT8_ASYM, MobileNetV3 INT8_SYM, ResNet-50 INT8_SYM (both layouts), the fused "
        "MobileNetV2/V3 INT8_SYM blocks")
    zoo_counts, cnn_zoo = cnn_zoo_path(records, gpu_line)
    log("phase 17: the streaming-ASR path (DFSMN at examples/dfsmn_stream.py's width, "
        "offline, streamed, batch 1 and 64) and every op-zoo case in a GRAPH session on the "
        "card against the CPU plain path")
    t17 = time.perf_counter()
    dfsmn = dfsmn_path(here, gpu_line)
    op_zoo = op_zoo_path()
    log(f"  phase 17: {time.perf_counter() - t17:.1f} s")
    log("phase 18: the rest of the runtime: HYBRID at Llama-2-7B width, MobileNetV1 INT8_SYM "
        "224 saved / reloaded / layer-benchmarked / traced, the roofline, DUMP, the data loader, "
        "the two CNN examples, --backend")
    hyb_counts, cnn18_counts, runtime = runtime_path(here, gpu_line)
    log(f"total {time.perf_counter() - t_start:.1f} s")

    kernels = []
    for name, (source, replaces) in KERNELS.items():
        counts, path = path_counts[name]
        r = records[name]
        entry = {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                 "launches": launches(counts, name), "path": path,
                 "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
                 "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                 "library_ms": r["library_ms"], "shape": r["shape"]}
        for extra in ("unfused_pair_ms", "ms_cold", "library_ms_cold", "prefill",
                      "decode_cold", "cur_ms", "library_layout", "blocks_ms",
                      "blocks_bound_ms", "launches_phase", "decode", "flash_d576",
                      "decode_d576", "launches_combine", "tp_shards", "zoo", "mha"):
            if extra in r:
                entry[extra] = r[extra]
        if name in reduce_per_step:
            entry["qmm_reduce_per_decode_step"] = reduce_per_step[name]
        if name.startswith("quant_matmul"):
            entry.update(launches_decode=int(counts.get(f"{name}.decode", 0)),
                         launches_prefill=int(counts.get(f"{name}.prefill", 0)))
        if name in moe_counts:           # phase 12's card runs (zeroed before each)
            entry["launches_moe"] = launches(moe_counts[name], name)
            for extra in ("moe_experts", "moe_full_depth"):
                if extra in r:
                    entry[extra] = r[extra]
        if name == "quant_matmul":       # phase 13's forward on the converted weights
            entry["launches_weight_io"] = launches(wio_counts, name)
        # phase 14's runs, each rank's launches (run_queue; the two MoE forwards)
        run = {"quant_matmul_q4_0": "tp2dp2_q4_0"}.get(name, "tp2_q8_0")
        if name in ("quant_matmul", "quant_matmul_q4_0") + ATTENTION:
            entry["launches_tp"] = [launches(c, name) for c in mesh[run]["counts"]]
        if name in ("quant_matmul", "quant_matmul_q4_0"):
            mode = "q8_0" if name == "quant_matmul" else "q4_0"
            entry["launches_ep"] = {k: launches(mesh[f"{k}_{mode}"]["counts"], name)
                                    for k in ("ep2", "ep2xtp2")}
        if name in ("quant_matmul", "quant_matmul_q4_0") + ATTENTION:
            entry["launches_pp"] = _pp_launches(pipeline, name)
        if name == "fused_dsconv":       # phase 16's fused forwards (zeroed before each)
            entry["launches_zoo"] = {k: launches(c, name) for k, c in zoo_counts.items()}
            entry["launches_runtime"] = launches(cnn18_counts, name)    # phase 18 (b)
        if name == "quant_matmul_t":     # phase 18 (a): one HYBRID run
            entry["launches_hybrid"] = launches(hyb_counts, name)
        if name in ATTENTION + ("flash_attention_bhsd",):
            # the split-KV merges of the same source, within `launches`
            entry["launches_combine"] = int(counts.get(f"{name}.combine", 0))
        kernels.append(entry)
    print(gpu_line)
    print(json.dumps({"kernels": kernels, "mesh": {
        k: ({kk: vv for kk, vv in v.items() if kk != "counts"} if isinstance(v, dict) else v)
        for k, v in mesh.items()}, "pipeline": _without_counts(pipeline), "cnn_zoo": cnn_zoo,
        "dfsmn": dfsmn, "op_zoo": op_zoo, "runtime": runtime}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
