"""DFSMN streaming ASR model family (counterpart of
csinn2_tpu/models/dfsmn_asr.py).

The reference runs streaming ASR through per-frame ring-buffered ops,
`cache_matmul`, `cache_conv1d` and `fsmn` (ref:
source/c906_opt/fp16/cache_matmul.c:23-87, source/reference/fsmn.c; params
include/csinn/csinn_data_structure.h:1170-1198).  Those ops exist here too
(ops/ref/attention.py), but one frame of FIR math a launch cannot fill a
GPU, so the model streams in chunks, as the JAX package does:

* The FSMN memory block (centre + lookback + lookahead FIR taps over the
  projected frames, the semantics of shl_ref_fsmn_f32) is ONE depthwise
  (grouped) conv1d over time with a sparse kernel assembled from the tap
  filters, a whole chunk of frames in one convolution.
* The streaming state (the reference's malloc'd ring `asr_buffer`) is a set
  of explicit cache tensors on the model's device, carried through a GRAPH
  Session step: ``logits, *new_caches = step(chunk, *caches)``.
* Lookahead (r_order) delays each block's output by r_order·r_stride
  frames rather than re-running frames when the future arrives, so the
  streamed output equals the offline forward shifted by the total delay.

Architecture (standard DFSMN acoustic model):
    fbank chunk → [ linear→relu → linear proj → memory FIR (+ delayed skip
    from the previous block) ] × N blocks → relu classifier → logits.

The weights are the JAX model's numpy dict, made by the same code from the
same seed; the sessions run on `device` ("cuda" unless the caller passes
"cpu"), their fully-connected layers and convolutions in full f32 (no
TF32), and `_Streamer.step` returns the chunk's logits as a tensor on that
device without synchronizing.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np
import torch

from csinn2_tpu_torch import ops
from csinn2_tpu_torch.core.dtypes import Dtype, RunMode
from csinn2_tpu_torch.core.tensor import Tensor, TensorMeta
from csinn2_tpu_torch.models.common import kaiming
from csinn2_tpu_torch.runtime.session import Session
from csinn2_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass
class DFSMNConfig:
    feat_dim: int = 80          # fbank features per frame
    hidden: int = 512
    proj: int = 256             # memory-block (projection) width
    blocks: int = 4
    l_order: int = 10           # lookback taps (incl. center tap i=0)
    r_order: int = 2            # lookahead taps
    l_stride: int = 1
    r_stride: int = 1
    classes: int = 218          # CTC/senone targets

    @property
    def l_span(self) -> int:    # history frames needed left of center
        return (self.l_order - 1) * self.l_stride

    @property
    def r_span(self) -> int:    # future frames needed right of center
        return self.r_order * self.r_stride

    @property
    def fir_len(self) -> int:
        return self.l_span + self.r_span + 1

    @property
    def block_delay(self) -> int:
        return self.r_span

    @property
    def total_delay(self) -> int:
        """Stream latency in frames: each block defers output by its
        lookahead span."""
        return self.blocks * self.r_span


class DFSMNASR:
    """Config-driven DFSMN acoustic model with offline and streaming
    sessions sharing one weight set."""

    name = "dfsmn_asr"

    def __init__(self, cfg: DFSMNConfig = None, seed: int = 0, device="cuda"):
        self.cfg = cfg or DFSMNConfig()
        self.device = resolve_device(device)
        self.weights: Dict[str, np.ndarray] = {}
        self._init_weights(np.random.default_rng(seed))
        self._sess_cache: Dict[tuple, Session] = {}

    def _init_weights(self, rng):
        c, w = self.cfg, self.weights
        din = c.feat_dim
        for i in range(c.blocks):
            w[f"b{i}.in.w"] = kaiming(rng, (c.hidden, din))
            w[f"b{i}.in.b"] = np.zeros((c.hidden,), np.float32)
            w[f"b{i}.proj.w"] = kaiming(rng, (c.proj, c.hidden))
            # tap filters, the fsmn op's l_filter/r_filter analogs
            # (ref: include/csinn/csinn_data_structure.h csinn_fsmn_params)
            w[f"b{i}.lf"] = (rng.standard_normal((c.l_order, c.proj)) *
                             (0.5 / c.l_order)).astype(np.float32)
            w[f"b{i}.rf"] = (rng.standard_normal((c.r_order, c.proj)) *
                             (0.5 / max(c.r_order, 1))).astype(np.float32)
            din = c.proj
        w["head.w"] = kaiming(rng, (c.hidden, c.proj))
        w["head.b"] = np.zeros((c.hidden,), np.float32)
        w["cls.w"] = kaiming(rng, (c.classes, c.hidden))
        w["cls.b"] = np.zeros((c.classes,), np.float32)

    # -- FIR kernel assembly ---------------------------------------------------

    def _fir_kernel(self, i: int) -> np.ndarray:
        """Sparse depthwise conv1d kernel [proj, 1, fir_len] realizing the
        fsmn tap pattern: out[mid] = seq[mid]·(1+lf[0]) + Σ lf[i]·seq[mid-i·ls]
        + Σ rf[i]·seq[mid+(i+1)·rs]  (the fsmn op's semantics)."""
        c = self.cfg
        lf, rf = self.weights[f"b{i}.lf"], self.weights[f"b{i}.rf"]
        k = np.zeros((c.proj, 1, c.fir_len), np.float32)
        mid = c.l_span
        k[:, 0, mid] += 1.0                                   # identity center
        for j in range(c.l_order):
            k[:, 0, mid - j * c.l_stride] += lf[j]
        for j in range(c.r_order):
            k[:, 0, mid + (j + 1) * c.r_stride] += rf[j]
        return k

    # -- graph fragments ---------------------------------------------------------

    def _block_ff(self, x, i: int):
        """linear→relu→proj over [b, T, D] (leading dims are batch for FC)."""
        w = self.weights
        h = ops.fullyconnected(x, Tensor(w[f"b{i}.in.w"]), Tensor(w[f"b{i}.in.b"]),
                               ops.FCParams(units=self.cfg.hidden, name=f"b{i}.in"))
        h = ops.relu(h)
        return ops.fullyconnected(h, Tensor(w[f"b{i}.proj.w"]), None,
                                  ops.FCParams(units=self.cfg.proj, name=f"b{i}.proj"))

    def _fir(self, p_ncw, i: int, pad: Tuple[int, int]):
        """Depthwise FIR over time; p_ncw [b, proj, T]."""
        return ops.conv1d(p_ncw, Tensor(self._fir_kernel(i)), None,
                          ops.Conv1dParams(group=self.cfg.proj, pad=pad, name=f"b{i}.fir"))

    def _head(self, m):
        w = self.weights
        h = ops.fullyconnected(m, Tensor(w["head.w"]), Tensor(w["head.b"]),
                               ops.FCParams(units=self.cfg.hidden, name="head"))
        h = ops.relu(h)
        return ops.fullyconnected(h, Tensor(w["cls.w"]), Tensor(w["cls.b"]),
                                  ops.FCParams(units=self.cfg.classes, name="cls"))

    @staticmethod
    def _to_ncw(x):      # [b, T, D] -> [b, D, T]
        return ops.transpose(x, ops.TransposeParams(permute=(0, 2, 1)))

    @staticmethod
    def _to_ntd(x):      # [b, D, T] -> [b, T, D]
        return ops.transpose(x, ops.TransposeParams(permute=(0, 2, 1)))

    def _session(self, kind: str, compute_dtype) -> Session:
        kw = {"compute_dtype": compute_dtype} if compute_dtype is not None else {}
        return Session(run_mode=RunMode.GRAPH, name=f"{self.name}_{kind}", device=self.device,
                       **kw)

    # -- offline (full utterance) -------------------------------------------------

    def offline_session(self, batch: int, frames: int, compute_dtype=None) -> Session:
        """Whole-utterance forward [b, T, feat] → [b, T, classes], FIR
        zero-padded so frame t's output is centered at frame t."""
        key = ("offline", batch, frames, compute_dtype)
        if key in self._sess_cache:
            return self._sess_cache[key]
        c = self.cfg
        sess = self._session("offline", compute_dtype)
        with sess.build():
            x = sess.input(TensorMeta(shape=(batch, frames, c.feat_dim),
                                      dtype=Dtype.FLOAT32, name="fbank"))
            m_prev = None
            h = x
            for i in range(c.blocks):
                p = self._block_ff(h, i)
                fir = self._fir(self._to_ncw(p), i, pad=(c.l_span, c.r_span))
                m = self._to_ntd(fir)
                if m_prev is not None:
                    m = ops.add(m, m_prev)          # DFSMN identity skip
                m_prev = m
                h = m
            sess.set_output(self._head(h))
        sess.setup()
        self._sess_cache[key] = sess
        return sess

    # -- streaming -----------------------------------------------------------------

    def stream_state(self, batch: int) -> List[torch.Tensor]:
        """Zero caches on the model's device: per block a FIR history
        [b, proj, fir_len-1] and — when the block has lookahead — a
        skip-delay line [b, r_span, proj] (the functional analog of
        asr_buffer_init, ref: source/c906_opt/fp16/cache_matmul.c)."""
        c = self.cfg
        state: List[torch.Tensor] = []
        for _ in range(c.blocks):
            state.append(torch.zeros((batch, c.proj, c.fir_len - 1), device=self.device))
            if c.r_span:
                state.append(torch.zeros((batch, c.r_span, c.proj), device=self.device))
        return state

    def stream_session(self, batch: int, chunk: int, compute_dtype=None) -> Session:
        """One streaming step: (chunk [b,C,feat], *caches) →
        (logits [b,C,classes] delayed by cfg.total_delay, *new caches).

        Every path through a block is delayed by its r_span so the skip
        addition stays time-aligned: the FIR output for the newest frame
        refers to r_span frames ago, and the skip input is routed through a
        matching delay line."""
        key = ("stream", batch, chunk, compute_dtype)
        if key in self._sess_cache:
            return self._sess_cache[key]
        c = self.cfg
        assert chunk >= 1
        sess = self._session("stream", compute_dtype)
        with sess.build():
            x = sess.input(TensorMeta(shape=(batch, chunk, c.feat_dim),
                                      dtype=Dtype.FLOAT32, name="chunk"))
            caches, new_caches = [], []
            for i in range(c.blocks):
                caches.append(sess.input(TensorMeta(
                    shape=(batch, c.proj, c.fir_len - 1), dtype=Dtype.FLOAT32,
                    name=f"b{i}.fir_cache")))
                if c.r_span:
                    caches.append(sess.input(TensorMeta(
                        shape=(batch, c.r_span, c.proj), dtype=Dtype.FLOAT32,
                        name=f"b{i}.skip_cache")))

            h = x
            m_prev = None
            ci = 0
            for i in range(c.blocks):
                p = self._block_ff(h, i)                     # [b, C, proj]
                fir_cache = caches[ci]
                ci += 1
                seq = ops.concat([fir_cache, self._to_ncw(p)],
                                 ops.ConcatParams(axis=2))    # [b,proj,K-1+C]
                m = self._to_ntd(self._fir(seq, i, pad=(0, 0)))  # C frames, delayed by r_span
                # roll the FIR history forward
                new_caches.append(ops.slice(
                    seq, ops.SliceParams(begin=(0, 0, chunk),
                                         end=(batch, c.proj, c.fir_len - 1 + chunk))))
                if c.r_span:
                    # block 0 has no skip, but still rolls its delay line
                    skip_cache = caches[ci]
                    ci += 1
                    sk = ops.concat([skip_cache, m if m_prev is None else m_prev],
                                    ops.ConcatParams(axis=1))      # [b, r+C, proj]
                    new_caches.append(ops.slice(sk, ops.SliceParams(
                        begin=(0, chunk, 0), end=(batch, chunk + c.r_span, c.proj))))
                    if m_prev is not None:
                        m = ops.add(m, ops.slice(sk, ops.SliceParams(
                            begin=(0, 0, 0), end=(batch, chunk, c.proj))))
                elif m_prev is not None:
                    m = ops.add(m, m_prev)
                m_prev = m
                h = m
            sess.set_output(self._head(h), *new_caches)
        sess.setup()
        self._sess_cache[key] = sess
        return sess

    def stream(self, batch: int = 1, chunk: int = 8, compute_dtype=None):
        return _Streamer(self, batch, chunk, compute_dtype)


class _Streamer:
    """Stateful convenience wrapper: feeds chunks through the step session,
    carrying the caches (the user-facing analog of the reference's
    per-frame csinn_session_run loop over cache ops)."""

    def __init__(self, model: DFSMNASR, batch: int, chunk: int, compute_dtype):
        self.model = model
        self.chunk = chunk
        self.sess = model.stream_session(batch, chunk, compute_dtype)
        self.state = model.stream_state(batch)
        self.delay = model.cfg.total_delay

    def step(self, frames) -> torch.Tensor:
        """frames [b, chunk, feat] (numpy or a tensor) → logits
        [b, chunk, classes] (delayed), on the model's device."""
        if not isinstance(frames, torch.Tensor):
            frames = torch.from_numpy(np.asarray(frames, np.float32))
        out = self.sess.run(frames.float(), *self.state, unwrap=False)
        self.state = list(out[1:])
        return out[0]

    def flush(self) -> torch.Tensor:
        """Drain the model delay with zero frames; returns the tail logits
        ([b, total_delay, classes])."""
        b = self.state[0].shape[0]
        dev = self.model.device
        if self.delay == 0:
            return torch.zeros((b, 0, self.model.cfg.classes), device=dev)
        n_flush = -(-self.delay // self.chunk)
        zeros = torch.zeros((b, self.chunk, self.model.cfg.feat_dim), device=dev)
        return torch.cat([self.step(zeros) for _ in range(n_flush)], dim=1)[:, :self.delay]
