"""Plain reference of ``generators/schrodinger_fd.py``'s operator
A = (T + diag v) (x) I + I (x) (T + diag w), B = I, from the potentials
alone: the exact eigenvalues as sums of the 1D eigenvalues (dense
``numpy.linalg.eigvalsh``), residuals with the stencil applied in place on
the grid."""
from __future__ import annotations

import numpy as np

from .common import by_blocks


def _one_d(d: np.ndarray, count: int) -> np.ndarray:
    n = len(d)
    T = (np.diag(2.0 + d) - np.diag(np.ones(n - 1), 1)
         - np.diag(np.ones(n - 1), -1))
    return np.linalg.eigvalsh(T)[:count]


def exact_eigenvalues(inputs: dict, Emin: float, Emax: float,
                      lowest: int = 64) -> np.ndarray:
    """The eigenvalues of A in [Emin, Emax], from the ``lowest`` of each
    1D factor (enough for the ~50 lowest sums)."""
    s = np.sort((_one_d(inputs["v"], lowest)[:, None]
                 + _one_d(inputs["w"], lowest)[None, :]).ravel())
    return s[(s >= Emin) & (s <= Emax)]


def residuals(inputs: dict, lam, Q) -> np.ndarray:
    """Each returned pair's ||A x - lam x|| / (max(|lam|, 1) ||x||), the
    five-point stencil applied in place on the grid (B = I)."""
    v, w = np.asarray(inputs["v"]), np.asarray(inputs["w"])
    nx, ny = len(v), len(w)
    diag = 4.0 + v[:, None] + w[None, :]

    def block(X, lb):
        G = X.reshape(nx, ny, -1)
        R = G * (diag[:, :, None] - lb[None, None, :])
        R[1:] -= G[:-1]
        R[:-1] -= G[1:]
        R[:, 1:] -= G[:, :-1]
        R[:, :-1] -= G[:, 1:]
        return R.reshape(X.shape)

    return by_blocks(block, lam, Q)
