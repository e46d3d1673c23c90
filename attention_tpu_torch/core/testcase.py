"""Binary testcase format: reader, writer, generator, verifier.

The port's own copy of `attention_tpu.core.testcase` (the port imports
nothing of the JAX package); the same seed writes byte-identical files.

The on-disk contract is byte-compatible with the reference's frozen harness
(`attention.c:84-162`, `attention-mpi.c:417-495`):

  * header: 4 little-endian int32 — m, n, dk, dv
  * m*dk float64 — Q
  * n*dk float64 — K
  * n*dv float64 — V
  * m*dv float64 — expected output (appended after V; the verifier seeks
    past the inputs to reach it, `attention.c:139-140`)

Verification is elementwise ``|result - expected| <= 0.02``
(`attention.c:143`).  The reference's NaN check has a known bug — it tests
``result[base + 1]`` for every column instead of ``result[base + j]``
(`attention.c:150`) — which we fix here: every element is NaN-checked.

The reference ships no generator (testcase files come from the course
grader); ``generate_testcase`` fills that gap, producing files any
implementation — including the reference C binaries — can consume.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Sequence

import numpy as np

from attention_tpu_torch.core.oracle import attention_oracle

HEADER_DTYPE = np.dtype("<i4")
DATA_DTYPE = np.dtype("<f8")
VERIFY_THRESHOLD = 0.02  # attention.c:143


@dataclasses.dataclass
class TestCase:
    q: np.ndarray  # (m, dk) float64
    k: np.ndarray  # (n, dk) float64
    v: np.ndarray  # (n, dv) float64
    expected: np.ndarray | None = None  # (m, dv) float64

    @property
    def dims(self) -> tuple[int, int, int, int]:
        m, dk = self.q.shape
        n, dv = self.v.shape
        return m, n, dk, dv

    def nbytes(self) -> int:
        total = 4 * HEADER_DTYPE.itemsize
        for arr in (self.q, self.k, self.v, self.expected):
            if arr is not None:
                total += arr.size * DATA_DTYPE.itemsize
        return total


def write_testcase(path: str | os.PathLike, case: TestCase) -> None:
    """Serialize a testcase in the reference's binary layout."""
    m, n, dk, dv = case.dims
    if case.k.shape != (n, dk):
        raise ValueError(f"K shape {case.k.shape} != ({n}, {dk})")
    if case.expected is not None and case.expected.shape != (m, dv):
        raise ValueError(f"expected shape {case.expected.shape} != ({m}, {dv})")
    with open(path, "wb") as f:
        np.array([m, n, dk, dv], dtype=HEADER_DTYPE).tofile(f)
        case.q.astype(DATA_DTYPE).tofile(f)
        case.k.astype(DATA_DTYPE).tofile(f)
        case.v.astype(DATA_DTYPE).tofile(f)
        if case.expected is not None:
            case.expected.astype(DATA_DTYPE).tofile(f)


def read_testcase(path: str | os.PathLike, *, with_expected: bool = True) -> TestCase:
    """Load a testcase; mirrors `read_matrices` (`attention.c:100-121`)."""
    with open(path, "rb") as f:
        header = np.fromfile(f, dtype=HEADER_DTYPE, count=4)
        if header.size != 4:
            raise ValueError(f"invalid testcase header in {path}")
        m, n, dk, dv = (int(x) for x in header)
        if min(m, n, dk, dv) <= 0:
            raise ValueError(f"invalid dims {m, n, dk, dv} in {path}")
        q = np.fromfile(f, dtype=DATA_DTYPE, count=m * dk)
        k = np.fromfile(f, dtype=DATA_DTYPE, count=n * dk)
        v = np.fromfile(f, dtype=DATA_DTYPE, count=n * dv)
        if q.size != m * dk or k.size != n * dk or v.size != n * dv:
            raise ValueError(f"truncated testcase data in {path}")
        expected = None
        if with_expected:
            exp = np.fromfile(f, dtype=DATA_DTYPE, count=m * dv)
            if exp.size == m * dv:
                expected = exp.reshape(m, dv)
    return TestCase(
        q=q.reshape(m, dk), k=k.reshape(n, dk), v=v.reshape(n, dv), expected=expected
    )


@dataclasses.dataclass(frozen=True)
class VerifyScan:
    """Full-scan verification statistics (the opt-in mode the chaos
    fuzzer's tolerance ledger consumes, also surfaced by
    ``cli run --stats``): not just the first mismatch, but how wrong
    and how widespread."""

    ok: bool
    threshold: float
    max_abs_err: float   # over finite elements (0.0 if none compared)
    mismatches: int      # elements over threshold OR non-finite
    nonfinite: int       # NaN/Inf result elements
    total: int
    message: str         # the classic first-mismatch diagnostic

    def stats_line(self) -> str:
        return (f"stats: max_abs_err={self.max_abs_err:.6g} "
                f"mismatches={self.mismatches}/{self.total} "
                f"nonfinite={self.nonfinite} "
                f"threshold={self.threshold:g}")


def verify_scan(
    expected: np.ndarray,
    result: np.ndarray,
    *,
    threshold: float = VERIFY_THRESHOLD,
) -> VerifyScan:
    """Full-scan variant of :func:`verify`: same pass/fail semantics,
    plus max-abs-error and mismatch/non-finite counts over EVERY
    element.  A shape mismatch reports every element as mismatched."""
    expected = np.asarray(expected, dtype=np.float64)
    result = np.asarray(result, dtype=np.float64)
    if expected.shape != result.shape:
        return VerifyScan(
            ok=False, threshold=threshold, max_abs_err=float("inf"),
            mismatches=max(expected.size, result.size), nonfinite=0,
            total=max(expected.size, result.size),
            message=(f"shape mismatch: expected {expected.shape}, "
                     f"got {result.shape}"),
        )
    finite = np.isfinite(result)
    err = np.abs(result - expected)
    bad = ~finite | (err > threshold)
    max_err = float(err[finite].max()) if finite.any() else 0.0
    if not bad.any():
        return VerifyScan(ok=True, threshold=threshold,
                          max_abs_err=max_err, mismatches=0,
                          nonfinite=0, total=result.size,
                          message="Correct!")
    idx = np.unravel_index(np.argmax(bad), bad.shape)
    loc = "][".join(str(i) for i in idx)
    return VerifyScan(
        ok=False, threshold=threshold, max_abs_err=max_err,
        mismatches=int(bad.sum()), nonfinite=int((~finite).sum()),
        total=result.size,
        message=(f"Expect result[{loc}] to be {expected[idx]:f}, "
                 f"but it is {result[idx]:f}"),
    )


def verify(
    expected: np.ndarray,
    result: np.ndarray,
    *,
    threshold: float = VERIFY_THRESHOLD,
    full_scan: bool = False,
) -> tuple[bool, str]:
    """Elementwise tolerance check, mirroring `verify` (`attention.c:123-162`).

    Returns (ok, message).  On failure the message pinpoints the first bad
    element with expected/actual values, matching the reference's diagnostic
    print (`attention.c:151`).  Unlike the reference, every element is
    NaN-checked (the reference only checks column 1 of each row,
    `attention.c:150` — a known quirk we fix).

    ``full_scan=True`` appends max-abs-error / mismatch-count statistics
    to the failure message (see :func:`verify_scan` for the structured
    form); the default message stays byte-identical to the reference's.
    """
    if full_scan:
        scan = verify_scan(expected, result, threshold=threshold)
        msg = scan.message if scan.ok \
            else f"{scan.message} [{scan.stats_line()}]"
        return scan.ok, msg
    expected = np.asarray(expected, dtype=np.float64)
    result = np.asarray(result, dtype=np.float64)
    if expected.shape != result.shape:
        return False, f"shape mismatch: expected {expected.shape}, got {result.shape}"
    bad = ~np.isfinite(result) | (np.abs(result - expected) > threshold)
    if not bad.any():
        return True, "Correct!"
    idx = np.unravel_index(np.argmax(bad), bad.shape)
    loc = "][".join(str(i) for i in idx)
    return (
        False,
        f"Expect result[{loc}] to be {expected[idx]:f}, but it is {result[idx]:f}",
    )


def verify_file(
    path: str | os.PathLike,
    result: np.ndarray,
    *,
    threshold: float = VERIFY_THRESHOLD,
) -> tuple[bool, str]:
    """Verify a result against the expected output stored in a testcase file."""
    case = read_testcase(path, with_expected=True)
    if case.expected is None:
        return False, f"no expected output appended to {path}"
    return verify(case.expected, result, threshold=threshold)


def generate_testcase(
    m: int,
    n: int,
    dk: int,
    dv: int,
    *,
    seed: int = 0,
    q_scale: float = 1.0,
    compute_expected: bool = True,
) -> TestCase:
    """Generate a random testcase with the oracle's expected output.

    Inputs are standard normal scaled by ``q_scale`` — with the 1/sqrt(dk)
    score scaling this yields well-conditioned softmax distributions at any
    of the reference's scales (README.md:95-102 `simple`..`scale5`).
    """
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((m, dk)) * q_scale
    k = rng.standard_normal((n, dk)) * q_scale
    v = rng.standard_normal((n, dv))
    expected = attention_oracle(q, k, v) if compute_expected else None
    return TestCase(q=q, k=k, v=v, expected=expected)


# Named suite mirroring the reference's testcase ladder (README.md:95-102).
# The reference's actual file sizes are unpublished; these are chosen so
# `simple` is instant and `scale5` stresses a single chip, with the same
# monotone growth in m/n.
SUITE: dict[str, tuple[int, int, int, int]] = {
    "simple": (128, 128, 32, 32),
    "scale1": (1024, 1024, 64, 64),
    "scale2": (2048, 2048, 64, 64),
    "scale3": (4096, 4096, 128, 128),
    "scale4": (8192, 8192, 128, 128),
    "scale5": (16384, 16384, 128, 128),
}


def generate_suite(
    out_dir: str | os.PathLike,
    names: Sequence[str] | None = None,
    *,
    seed: int = 0,
) -> list[str]:
    """Write the named testcase suite to ``out_dir``; returns file paths."""
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for name in names or SUITE:
        m, n, dk, dv = SUITE[name]
        case = generate_testcase(m, n, dk, dv, seed=seed)
        path = os.path.join(out_dir, f"{name}.bin")
        write_testcase(path, case)
        paths.append(path)
    return paths
