"""The five-point Schroedinger operator -Laplace + V(x) + W(y), Dirichlet,
as the port's users hand it over: a scipy CSR matrix and an interval.

    A = (T + diag v) (x) I + I (x) (T + diag w),   T = tridiag(-1, 2, -1),

on an nx x ny grid (row index i * ny + j), so the DIA offsets are 0, +-1
and +-ny and B = I. v and w are the seeded smooth fields of
``fields.smooth_field``; the exact spectrum is every sum of an eigenvalue
of T + diag v and one of T + diag w, which picks the interval here (the
rule of ``chip_smoke.py``'s ``interval_lowest``: Emin = lambda_1 / 2, Emax
in the first gap past the 50th eigenvalue).
"""
from __future__ import annotations

import numpy as np
import scipy.linalg as sla
import scipy.sparse as sp

from . import fields


def operator(v: np.ndarray, w: np.ndarray) -> sp.csr_matrix:
    """A as a CSR matrix, built from its five diagonals (no explicit
    zeros: the couplings across a grid row's end are left out)."""
    nx, ny = len(v), len(w)
    n = nx * ny
    main = ((2.0 + v)[:, None] + (2.0 + w)[None, :]).ravel()
    along = -np.ones(n - 1)
    along[ny - 1::ny] = 0.0            # j = ny - 1 has no right neighbour
    across = -np.ones(n - ny)
    A = sp.diags([across, along, main, along, across],
                 [-ny, -1, 0, 1, ny], shape=(n, n), format="csr")
    A.eliminate_zeros()
    return A


def lowest_1d(d: np.ndarray, count: int) -> np.ndarray:
    """The ``count`` lowest eigenvalues of tridiag(-1, 2 + d, -1)."""
    n = len(d)
    return sla.eigh_tridiagonal(2.0 + d, -np.ones(n - 1), eigvals_only=True,
                                select="i", select_range=(0, count - 1))


def build(cfg: dict, seed: int, k: int) -> dict:
    """Problem ``k`` of a run seeded ``seed``."""
    nx, ny = cfg["grid"]
    pot = cfg["potential"]
    v = fields.smooth_field(fields.rng(seed, k, 0), nx, pot["modes"],
                            pot["amplitude"])
    w = fields.smooth_field(fields.rng(seed, k, 1), ny, pot["modes"],
                            pot["amplitude"])
    lo = cfg["lowest_1d"]
    w2 = np.sort((lowest_1d(v, lo)[:, None]
                  + lowest_1d(w, lo)[None, :]).ravel())
    Emin, Emax, exp = fields.interval_lowest(w2, cfg["pairs_past"])
    if fields.subspace_size(len(exp)) != cfg["M0"]:
        raise ValueError(f"{len(exp)} pairs want M0 = "
                         f"{fields.subspace_size(len(exp))}, the "
                         f"configuration states {cfg['M0']}")
    return dict(A=operator(v, w), B=None, interval=(Emin, Emax),
                M0=cfg["M0"], count=len(exp), inputs=dict(v=v, w=w))
