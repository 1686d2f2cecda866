"""High-level API of the PyTorch port: ``feast`` and ``feast_summary``.

Counterpart of ``feastkit_tpu/interfaces/feast.py`` for sparse operands
(scipy.sparse matrices): ``feast(A, B, (Emin, Emax), M0, fpm)`` runs the
sparse interval driver on ``device`` (``None`` means CUDA). Dense and
matrix-free operands and the sharded backend belong to engines not ported
yet and raise ``NotImplementedError``.
"""
from __future__ import annotations

import sys

import numpy as np
import scipy.sparse as sp

from ..core.types import FeastResult

__all__ = ["feast", "feast_summary"]


def feast(A, B=None, interval=None, M0=None, fpm=None, *, backend=None,
          Q0=None, device=None, **kw) -> FeastResult:
    """All eigenpairs of A x = lam B x with lam in [Emin, Emax] for a
    sparse real symmetric A and B None, a positive diagonal (lumped mass)
    or a sparse symmetric positive-definite matrix (consistent mass,
    solved through the polynomial-inverse composite q(B) A).

    Args:
      A, B: sparse operands (B=None for the standard problem).
      interval: (Emin, Emax).
      M0: subspace size (default max(8, N // 10), capped at N).
      fpm: the 64-slot FEAST parameters (None: defaults).
      backend: None, "auto" or "serial" (the sharded backend is not ported).
      device: torch device; None means "cuda" (raises without CUDA).
      kw: passed to the sparse driver (``solver=``, ``hermitian=``).
    """
    if interval is None:
        raise ValueError("interval=(Emin, Emax) is required")
    Emin, Emax = float(interval[0]), float(interval[1])
    if not Emax > Emin:
        raise ValueError(f"Emin={Emin} must be < Emax={Emax}")
    if backend not in (None, "auto", "serial", ":auto", ":serial"):
        raise NotImplementedError(
            f"backend={backend!r} is not ported to feastkit_tpu_torch yet "
            "(ROADMAP.md, queue 1 item 15)")
    if not sp.issparse(A):
        raise NotImplementedError(
            "feast() on dense or matrix-free operands is not ported to "
            "feastkit_tpu_torch yet (ROADMAP.md, queue 1 items 9 and 13); "
            "pass a scipy.sparse matrix")
    from ..solvers.sparse import sparse_feast_interval
    N = A.shape[0]
    M0r = min(int(M0 or max(8, N // 10)), N)
    return sparse_feast_interval(A, B, Emin, Emax, M0r, fpm, Q0=Q0,
                                 device=device, **kw)


def feast_summary(result, file=None):
    """Human-readable run summary (same text as the JAX package)."""
    file = file or sys.stdout
    print("FEAST Hermitian eigensolver summary", file=file)
    print(f"  eigenvalues found (M) : {result.M}", file=file)
    print(f"  refinement loops      : {result.loop}", file=file)
    print(f"  max relative residual : {result.epsout:.3e}", file=file)
    print(f"  status                : {result.info.name} ({int(result.info)})",
          file=file)
    if result.M:
        lam = np.asarray(result.lam)
        print(f"  lambda range          : [{lam.real.min():.6g}, "
              f"{lam.real.max():.6g}]", file=file)
    return result.info
