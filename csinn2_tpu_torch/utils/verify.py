"""Golden-output verification metrics (a copy of csinn2_tpu/utils/verify.py).

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
