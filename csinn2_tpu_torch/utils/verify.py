"""Golden-output verification metrics (a copy of csinn2_tpu/utils/verify.py,
plus the port's own check_bf16_output).

Mirrors the reference's accuracy gate (ref: result_verify_f32,
tests/utils/test_utils.c:157-190): per-element abs/rel error, plus
KL-divergence and cosine-similarity aggregate checks; and the LLM logit gate
(ref: compute_cs, tests/llm/llama2.c:23-40).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class VerifyResult:
    max_abs_err: float
    max_rel_err: float
    kl_div: float
    cosine_sim: float
    mismatches: int
    total: int
    passed: bool

    def __repr__(self):
        return (f"VerifyResult(pass={self.passed}, max_abs={self.max_abs_err:.3e}, "
                f"max_rel={self.max_rel_err:.3e}, kl={self.kl_div:.3e}, "
                f"cos={self.cosine_sim:.6f}, bad={self.mismatches}/{self.total})")


def cosine_similarity(a: np.ndarray, b: np.ndarray) -> float:
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    na, nb = np.linalg.norm(a), np.linalg.norm(b)
    if na == 0 and nb == 0:
        return 1.0
    if na == 0 or nb == 0:
        return 0.0
    return float(np.dot(a, b) / (na * nb))


def kl_divergence(p: np.ndarray, q: np.ndarray) -> float:
    """KL over softmax-normalized magnitudes (reference uses output distributions)."""
    p = np.abs(np.asarray(p, np.float64).ravel()) + 1e-9
    q = np.abs(np.asarray(q, np.float64).ravel()) + 1e-9
    p /= p.sum()
    q /= q.sum()
    return float(np.sum(p * np.log(p / q)))


def verify(out, golden, tol: float = 1e-4, min_cosine: float = 0.99,
           mode: str = "strict") -> VerifyResult:
    """Elementwise + aggregate compare (ref CI similarity gate 0.99,
    tests/autotest/conftest.py:34).  Pass criterion by `mode`:

      "strict" (default, kernel/op-level): EVERY element within abs-or-rel
               `tol` — a cosine score cannot mask localized errors.
      "cosine" (end-to-end model gate): aggregate cosine >= min_cosine —
               the reference's model-level gate (compute_cs,
               tests/llm/llama2.c:23-40), where accumulated quantization
               error has no meaningful per-element bound.
      "any"    legacy OR of the two arms (elementwise pass or cosine pass).
    """
    out = np.asarray(out, np.float64)
    golden = np.asarray(golden, np.float64)
    assert out.shape == golden.shape, f"shape {out.shape} vs {golden.shape}"
    abs_err = np.abs(out - golden)
    rel_err = abs_err / np.maximum(np.abs(golden), 1e-9)
    bad = (abs_err > tol) & (rel_err > tol)
    cos = cosine_similarity(out, golden)
    kl = kl_divergence(out, golden)
    if mode == "strict":
        passed = not bad.any()
    elif mode == "cosine":
        passed = cos >= min_cosine
    else:
        assert mode == "any", mode
        passed = (not bad.any()) or cos >= min_cosine
    return VerifyResult(
        max_abs_err=float(abs_err.max()) if abs_err.size else 0.0,
        max_rel_err=float(rel_err.max()) if rel_err.size else 0.0,
        kl_div=kl, cosine_sim=cos,
        mismatches=int(bad.sum()), total=int(bad.size), passed=bool(passed),
    )


def _bf16_order(v: np.ndarray) -> np.ndarray:
    """bf16 values (held exactly in f32) as integers whose difference counts
    the bf16 values between them (+0 and -0 both 0)."""
    u = (np.ascontiguousarray(v, np.float32).view(np.uint32) >> 16).astype(np.int64)
    mag = u & 0x7FFF
    return np.where(u & 0x8000, -mag, mag)


def _bf16_value(o: np.ndarray) -> np.ndarray:
    """The bf16 value (as float64) of an order integer of _bf16_order."""
    bits = np.where(o < 0, 0x8000 | -o, o).astype(np.uint32) << 16
    return bits.view(np.float32).astype(np.float64)


def check_bf16_output(got_bf16, got_f32, want_bf16, want_f32, tol) -> None:
    """Hold a bf16 output to a reference's bf16 output where the two f32
    sums agree only within `tol` (another summation order).  Raises
    AssertionError unless:
      1. |got_f32 - want_f32| <= tol everywhere;
      2. got_bf16 is exactly got_f32 rounded to bf16 (nearest even);
      3. got_bf16 equals want_bf16, except where want_f32 lies within tol of
         every bf16 rounding midpoint between the two: one ulp apart where
         want_f32 is that close to their midpoint (two f32 sums on either
         side of it round apart), more only where tol spans several ulps
         (a sum that cancels to far below the tolerance's scale).
    Arrays are numpy (bf16 values as float32); tol a scalar or an array
    broadcast to their shape."""
    import torch
    g32, w32 = (np.asarray(a, np.float32) for a in (got_f32, want_f32))
    gb, wb = (np.asarray(a, np.float32) for a in (got_bf16, want_bf16))
    assert g32.shape == w32.shape == gb.shape == wb.shape, \
        f"shapes {g32.shape} {w32.shape} {gb.shape} {wb.shape}"
    tol = np.broadcast_to(np.asarray(tol, np.float64), g32.shape)

    def first(bad, what):
        if bad.any():
            i = tuple(int(j) for j in np.argwhere(bad)[0])
            raise AssertionError(
                f"{what} at {i} ({int(bad.sum())} elements): got bf16 {gb[i]!r} f32 {g32[i]!r}, "
                f"want bf16 {wb[i]!r} f32 {w32[i]!r}, tol {tol[i]!r}")

    first(~(np.abs(g32.astype(np.float64) - w32) <= tol), "f32 sums differ by more than tol")
    rounded = torch.from_numpy(g32.copy()).to(torch.bfloat16).float().numpy()
    first(rounded.view(np.uint32) != gb.view(np.uint32), "bf16 output is not bf16(its f32 sum)")
    og, ow = _bf16_order(gb), _bf16_order(wb)
    step = np.sign(og - ow)
    # the first and the last midpoint between the two outputs (the same one
    # when they are one ulp apart)
    m_first = (_bf16_value(ow) + _bf16_value(ow + step)) / 2
    m_last = (_bf16_value(og) + _bf16_value(og - step)) / 2
    w64 = w32.astype(np.float64)
    near = (np.abs(w64 - m_first) <= tol) & (np.abs(w64 - m_last) <= tol)
    first((og != ow) & ~near, "bf16 outputs differ away from a rounding midpoint")
