"""Plain reference of ``generators/schrodinger_fem.py``'s pencil
A = (Dx + Vx) (x) My + Mx (x) (Dy + Vy), B = Mx (x) My, from the
potentials alone: the exact eigenvalues as sums of the 1D generalized
eigenvalues (Cholesky of M, then dense ``numpy.linalg.eigvalsh``), A and B
applied by array shifts on the grid."""
from __future__ import annotations

import numpy as np

from . import common
from .common import shift_apply


def _stiffness(v: np.ndarray):
    """(lower, diag, upper) of D + V, V_ij = M_ij (v_i + v_j) / 2."""
    mid = 0.5 * (v[:-1] + v[1:])
    off = -1.0 + mid / 6.0
    return off, 2.0 + 4.0 / 6.0 * v, off


def _mass(n: int):
    off = np.full(n - 1, 1.0 / 6.0)
    return off, np.full(n, 4.0 / 6.0), off


def _dense(lower, diag, upper):
    return np.diag(diag) + np.diag(lower, -1) + np.diag(upper, 1)


def _one_d(v: np.ndarray, count: int) -> np.ndarray:
    K = _dense(*_stiffness(v))
    L = np.linalg.cholesky(_dense(*_mass(len(v))))
    Li = np.linalg.inv(L)
    C = Li @ K @ Li.T
    return np.linalg.eigvalsh(0.5 * (C + C.T))[:count]


def exact_eigenvalues(inputs: dict, Emin: float, Emax: float,
                      lowest: int = 64) -> np.ndarray:
    """The eigenvalues of the pencil in [Emin, Emax], from the ``lowest``
    of each 1D pencil."""
    s = np.sort((_one_d(inputs["v"], lowest)[:, None]
                 + _one_d(inputs["w"], lowest)[None, :]).ravel())
    return s[(s >= Emin) & (s <= Emax)]


def operators(inputs: dict):
    v, w = np.asarray(inputs["v"]), np.asarray(inputs["w"])
    nx, ny = len(v), len(w)
    Kx, Ky = _stiffness(v), _stiffness(w)
    Mx, My = _mass(nx), _mass(ny)

    def apply_A(X):
        G = X.reshape(nx, ny, -1)
        Y = shift_apply(shift_apply(G, 1, *My), 0, *Kx)
        Y += shift_apply(shift_apply(G, 1, *Ky), 0, *Mx)
        return Y.reshape(X.shape)

    def apply_B(X):
        G = X.reshape(nx, ny, -1)
        return shift_apply(shift_apply(G, 1, *My), 0, *Mx).reshape(X.shape)

    return apply_A, apply_B


def residuals(inputs: dict, lam, Q) -> np.ndarray:
    """Each returned pair's ||A x - lam B x|| / (max(|lam|, 1) ||x||)."""
    return common.residuals(*operators(inputs), lam, Q)
