"""Serial fp64 correctness oracle.

The port's own copy of `attention_tpu.core.oracle` (pure numpy).

Mirrors the semantics of the reference's serial implementation
(`attention.c:20-75`): per query row, (1) scores = Q[i]·K^T * 1/sqrt(dk),
(2) numerically-stable 3-pass softmax (max-subtract, exp-sum, normalize),
(3) result[i] = scores · V.  All math in float64.

This is the ground truth every other backend is verified against, exactly
as `attention.c` is the oracle for `attention-mpi.c` (reference
`README.md:78`).  The implementation here is vectorized NumPy rather than
scalar loops — same math, fp64 throughout, so any elementwise difference
from the C version is far below the ±0.02 verification tolerance
(`attention.c:143`).
"""

from __future__ import annotations

import numpy as np


def attention_oracle(
    q: np.ndarray,
    k: np.ndarray,
    v: np.ndarray,
    *,
    scale: float | None = None,
    row_block: int = 1024,
) -> np.ndarray:
    """Compute softmax(Q K^T / sqrt(dk)) V in float64.

    Args:
      q: (m, dk) queries.
      k: (n, dk) keys.
      v: (n, dv) values.
      scale: score scale; defaults to 1/sqrt(dk) (`attention.c:23`).
      row_block: queries processed per block to bound the (block, n)
        score scratch, the analog of the reference's per-row O(n)
        scratch buffer (`attention.c:26`).

    Returns:
      (m, dv) float64 attention output.
    """
    q = np.asarray(q, dtype=np.float64)
    k = np.asarray(k, dtype=np.float64)
    v = np.asarray(v, dtype=np.float64)
    m, dk = q.shape
    n, dk2 = k.shape
    n2, dv = v.shape
    if dk != dk2 or n != n2:
        raise ValueError(f"shape mismatch: Q{q.shape} K{k.shape} V{v.shape}")
    if scale is None:
        scale = 1.0 / np.sqrt(float(dk))

    out = np.empty((m, dv), dtype=np.float64)
    for start in range(0, m, row_block):
        stop = min(start + row_block, m)
        scores = (q[start:stop] @ k.T) * scale
        scores -= scores.max(axis=-1, keepdims=True)
        np.exp(scores, out=scores)
        scores /= scores.sum(axis=-1, keepdims=True)
        out[start:stop] = scores @ v
    return out


def attention_oracle_mha(
    q: np.ndarray,
    k: np.ndarray,
    v: np.ndarray,
    *,
    scale: float | None = None,
) -> np.ndarray:
    """Multi-head / grouped-query oracle.

    q: (..., hq, m, d), k/v: (..., hkv, n, d) with hq a multiple of hkv
    (GQA: each group of hq/hkv query heads attends to one shared KV head).
    The reference is single-head (`attention.c` has no head dimension);
    this extends the same fp64 math to the multi-head configs in
    BASELINE.json (config 5).
    """
    q = np.asarray(q, dtype=np.float64)
    k = np.asarray(k, dtype=np.float64)
    v = np.asarray(v, dtype=np.float64)
    hq, m, d = q.shape[-3:]
    hkv, n, _ = k.shape[-3:]
    if hq % hkv != 0:
        raise ValueError(f"hq={hq} not a multiple of hkv={hkv}")
    group = hq // hkv
    if scale is None:
        scale = 1.0 / np.sqrt(float(d))
    kx = np.repeat(k, group, axis=-3)
    vx = np.repeat(v, group, axis=-3)
    scores = np.einsum("...md,...nd->...mn", q, kx) * scale
    scores -= scores.max(axis=-1, keepdims=True)
    np.exp(scores, out=scores)
    scores /= scores.sum(axis=-1, keepdims=True)
    return np.einsum("...mn,...nd->...md", scores, vx)
