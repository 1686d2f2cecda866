"""What both references share: the residuals of returned pairs and the
comparison with the exact spectrum."""
from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np


def shift_apply(X: np.ndarray, axis: int, lower, diag, upper) -> np.ndarray:
    """The tridiagonal matrix tridiag(lower, diag, upper) applied along
    ``axis`` of X by array shifts: ``diag`` has the axis' length, ``lower``
    and ``upper`` one less (row i's coupling to i - 1 and to i + 1)."""
    n = X.shape[axis]
    shape = [1] * X.ndim
    shape[axis] = n
    Y = np.reshape(diag, shape) * X
    cut = [1] * X.ndim
    cut[axis] = n - 1
    lo = [slice(None)] * X.ndim
    hi = [slice(None)] * X.ndim
    lo[axis] = slice(0, n - 1)
    hi[axis] = slice(1, n)
    Y[tuple(hi)] += np.reshape(lower, cut) * X[tuple(lo)]
    Y[tuple(lo)] += np.reshape(upper, cut) * X[tuple(hi)]
    return Y


def by_blocks(residual_block, lam, Q, block: int = 8,
              threads: int = min(8, os.cpu_count() or 1)) -> np.ndarray:
    """``residual_block(X, lam)`` (the residual vectors of a block of
    columns, float64) over Q's columns, ``block`` at a time on ``threads``
    threads (NumPy lets go of the interpreter lock on large arrays), and
    each column's ||r|| / (max(|lam|, 1) ||x||)."""
    lam = np.asarray(lam, np.float64)

    def one(s):
        X = np.ascontiguousarray(Q[:, s:s + block], np.float64)
        lb = lam[s:s + block]
        R = residual_block(X, lb)
        return (np.sqrt(np.einsum("ij,ij->j", R, R))
                / (np.maximum(np.abs(lb), 1.0)
                   * np.sqrt(np.einsum("ij,ij->j", X, X))))

    with ThreadPoolExecutor(threads) as pool:
        parts = list(pool.map(one, range(0, len(lam), block)))
    return np.concatenate(parts) if parts else np.empty(0)


def residuals(apply_A, apply_B, lam, Q) -> np.ndarray:
    """||A x - lam B x|| / (max(|lam|, 1) ||x||) of every column x of Q."""
    return by_blocks(lambda X, lb: apply_A(X) - apply_B(X) * lb[None, :],
                     lam, Q)


def eigenvalue_error(lam, exact) -> float:
    """max |lam_i - exact_i|, both sorted, of as many pairs as exact."""
    lam = np.sort(np.asarray(lam, np.float64))
    if not len(lam):
        return 0.0
    if len(lam) != len(exact) or not np.all(np.isfinite(lam)):
        return float("inf")
    return float(np.abs(lam - np.sort(exact)).max())


def nearest_error(lam, exact) -> float:
    """The largest distance of a returned eigenvalue to the nearest exact
    one (inf for a value that is not finite); a missing or doubled pair is
    the count's to catch."""
    lam = np.asarray(lam, np.float64)
    if not len(lam):
        return 0.0
    if not np.all(np.isfinite(lam)):
        return float("inf")
    exact = np.sort(np.asarray(exact, np.float64))
    i = np.clip(np.searchsorted(exact, lam), 1, len(exact) - 1)
    return float(np.minimum(np.abs(lam - exact[i - 1]),
                            np.abs(lam - exact[i])).max())
