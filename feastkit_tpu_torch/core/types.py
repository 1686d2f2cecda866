"""Result, status and contour types of the PyTorch port.

Counterpart of ``feastkit_tpu/core/types.py``: the same ``FeastError``
codes, the same ``FeastResult`` fields and the same trimming rule. The port
returns eigenvalues and residuals as host numpy arrays and eigenvectors as
a ``torch.Tensor`` on the device the solve ran on.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Any, NamedTuple

import numpy as np


class FeastError(enum.IntEnum):
    """FEAST info codes (same values as the JAX package)."""

    SUCCESS = 0
    ERROR_N = 1              # problem size N <= 0
    ERROR_M0 = 2             # subspace size M0 out of range
    ERROR_EMIN_EMAX = 3      # invalid search interval / region
    ERROR_EMID_R = 4         # invalid center/radius
    NO_CONVERGENCE = 5       # reached max refinement loops without converging
    MEMORY = 6               # workspace allocation failure
    INTERNAL_ERROR_1 = 7     # internal error (contour)
    INTERNAL_ERROR_2 = 8     # internal error (reduced eigensolve)
    PROBLEM_SIZE = 9         # subspace exhausted (M0 too small)


class Contour(NamedTuple):
    """Quadrature contour: nodes ``Zne`` and weights ``Wne`` (host complex
    numpy arrays)."""

    Zne: np.ndarray
    Wne: np.ndarray

    @property
    def ne(self) -> int:
        return int(self.Zne.shape[0])


@dataclasses.dataclass
class FeastResult:
    """Result of a real-interval (symmetric) FEAST solve.

    ``lam`` and ``res`` are host numpy arrays; ``q`` is an (N, M) tensor on
    the solve's device."""

    lam: Any          # (M,) eigenvalues inside the interval, sorted
    q: Any            # (N, M) eigenvectors
    M: int            # number of eigenvalues found inside
    res: Any          # (M,) relative residuals
    info: FeastError  # status code
    epsout: float     # final convergence indicator (max inside residual)
    loop: int         # refinement loops used

    lam_full: Any = None
    q_full: Any = None
    res_full: Any = None
    inside: Any = None
    inner_converged: bool = True

    @property
    def converged(self) -> bool:
        return self.info == FeastError.SUCCESS

    @property
    def eigenvalues(self):
        return self.lam

    @property
    def eigenvectors(self):
        return self.q


def _trim(result_cls, lam_full, q_full, res_full, inside, info, epsout, loop,
          inner_ok=True):
    """Trim the inside-first ordered M0-sized buffers to the M valid
    entries. ``lam_full``, ``res_full`` and ``inside`` are host arrays;
    ``q_full`` may be a device tensor and is sliced, not copied."""
    lam_full = np.asarray(lam_full)
    res_full = np.asarray(res_full)
    inside = np.asarray(inside).astype(bool)
    M = int(inside.sum())
    return result_cls(
        lam=lam_full[:M],
        q=q_full[:, :M],
        M=M,
        res=res_full[:M],
        info=FeastError(int(info)),
        epsout=float(epsout),
        loop=int(loop),
        lam_full=lam_full,
        q_full=q_full,
        res_full=res_full,
        inside=inside,
        inner_converged=bool(inner_ok) or FeastError(int(info))
        == FeastError.SUCCESS,
    )
