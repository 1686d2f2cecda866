"""The P1 finite-element pencil of the Schroedinger operator with
consistent mass (``scripts/scale_sparse_gen.py``'s consistent-mass rung,
with a potential):

    A = (Dx + Vx) (x) My + Mx (x) (Dy + Vy),   B = Mx (x) My,

D = tridiag(-1, 2, -1), M = tridiag(1, 4, 1) / 6 and V the 1D
mass-weighted potential, V_ij = M_ij (v_i + v_j) / 2, so A and B have nine
diagonals each. Its eigenvalues are mu_i + nu_j of the two 1D pencils
(D + V) x = mu M x; the interval is ``phase_consistent_mass``'s: Emin = 0
(the pencil is positive definite), Emax in the first gap past the 50th
eigenvalue.
"""
from __future__ import annotations

import numpy as np
import scipy.linalg as sla
import scipy.sparse as sp

from . import fields


def mass_1d(n: int) -> sp.csr_matrix:
    return sp.diags([1 / 6, 4 / 6, 1 / 6], [-1, 0, 1], shape=(n, n),
                    format="csr")


def stiffness_1d(v: np.ndarray) -> sp.csr_matrix:
    """D + V for the potential v."""
    n = len(v)
    mid = 0.5 * (v[:-1] + v[1:])
    return sp.diags([-1.0 + mid / 6, 2.0 + 4 / 6 * v, -1.0 + mid / 6],
                    [-1, 0, 1], shape=(n, n), format="csr")


def pencil(v: np.ndarray, w: np.ndarray):
    Kx, Ky = stiffness_1d(v), stiffness_1d(w)
    Mx, My = mass_1d(len(v)), mass_1d(len(w))
    A = (sp.kron(Kx, My) + sp.kron(Mx, Ky)).tocsr()
    B = sp.kron(Mx, My).tocsr()
    return A, B


def lowest_1d(v: np.ndarray, count: int) -> np.ndarray:
    n = len(v)
    return sla.eigh(stiffness_1d(v).toarray(), mass_1d(n).toarray(),
                    eigvals_only=True, subset_by_index=(0, count - 1))


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
    Emin, Emax, exp = fields.interval_from_zero(w2, cfg["pairs_past"])
    A, B = pencil(v, w)
    if fields.subspace_size(len(exp)) != cfg["M0"]:
        raise ValueError(f"{len(exp)} pairs want M0 = "
                         f"{fields.subspace_size(len(exp))}, the "
                         f"configuration states {cfg['M0']}")
    return dict(A=A, B=B, interval=(Emin, Emax), M0=cfg["M0"],
                count=len(exp), inputs=dict(v=v, w=w))
