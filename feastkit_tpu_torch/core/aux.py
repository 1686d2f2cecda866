"""Custom-contour registry and the helpers of user contours (PyTorch
port).

A copy of part of ``feastkit_tpu/core/aux.py``: a contour registered under
an id that lives in fpm[29], so copying fpm keeps the association (the
drivers read it with ``feast_get_custom_contour`` before they build the
default contour), its scoped form ``with_custom_contour``, point-in-polygon
membership and Cauchy weights for user nodes, and the complex-symmetry
test. The rest of that module (validation, printing, the memory estimate,
the stochastic count) is not ported yet.
"""
from __future__ import annotations

import threading

import numpy as np

from .parameters import FeastParameters
from .types import Contour

__all__ = ["feast_set_custom_contour", "feast_get_custom_contour",
           "feast_clear_custom_contour", "with_custom_contour",
           "feast_inside_contourx", "feast_cauchy_weights",
           "check_complex_symmetric"]

_CUSTOM_CONTOURS: dict[int, Contour] = {}
_REGISTRY_LOCK = threading.Lock()
_NEXT_ID = [1]


def feast_set_custom_contour(fpm, contour: Contour) -> int:
    """Register a contour; stores its id in fpm[29] and returns the id."""
    fpm = fpm if isinstance(fpm, FeastParameters) else FeastParameters(fpm)
    with _REGISTRY_LOCK:
        cid = _NEXT_ID[0]
        _NEXT_ID[0] += 1
        _CUSTOM_CONTOURS[cid] = Contour(np.asarray(contour.Zne, complex),
                                        np.asarray(contour.Wne, complex))
    fpm[29] = cid
    return cid


def feast_get_custom_contour(fpm) -> Contour | None:
    fpm = fpm if isinstance(fpm, FeastParameters) else FeastParameters(fpm)
    cid = fpm[29]
    if cid <= 0:
        return None
    with _REGISTRY_LOCK:
        return _CUSTOM_CONTOURS.get(cid)


def feast_clear_custom_contour(fpm) -> None:
    fpm = fpm if isinstance(fpm, FeastParameters) else FeastParameters(fpm)
    cid = fpm[29]
    with _REGISTRY_LOCK:
        _CUSTOM_CONTOURS.pop(cid, None)
    fpm[29] = 0


class with_custom_contour:
    """Scoped registration (``with with_custom_contour(fpm, contour) as
    fpm:``): registers on enter, clears the contour and restores fpm[29] on
    exit."""

    def __init__(self, fpm, contour: Contour):
        self.fpm = fpm if isinstance(fpm, FeastParameters) \
            else FeastParameters(fpm)
        self.contour = contour

    def __enter__(self):
        self._saved = self.fpm[29]
        feast_set_custom_contour(self.fpm, self.contour)
        return self.fpm

    def __exit__(self, *exc):
        feast_clear_custom_contour(self.fpm)
        self.fpm[29] = self._saved
        return False


def feast_inside_contourx(lam, Zne) -> np.ndarray:
    """Point-in-polygon membership for custom contour nodes (the
    crossing-number test, for any simple polygon)."""
    Z = np.asarray(Zne, complex)
    lam = np.atleast_1d(np.asarray(lam, complex))
    x, y = Z.real, Z.imag
    x1, y1 = np.roll(x, -1), np.roll(y, -1)
    px, py = lam.real[:, None], lam.imag[:, None]
    cond = ((y[None, :] <= py) != (y1[None, :] <= py))
    t = (py - y[None, :]) / np.where(y1 - y == 0, 1e-300, (y1 - y))[None, :]
    xint = x[None, :] + t * (x1 - x)[None, :]
    crossings = np.sum(cond & (px < xint), axis=1)
    return (crossings % 2).astype(bool)


def feast_cauchy_weights(Zne) -> np.ndarray:
    """Cauchy-kernel trapezoid weights for user nodes: central differences
    normalized by 2 pi i, the sign set by the loop's orientation (see
    ``core/contour.feast_customcontour``)."""
    Z = np.asarray(Zne, complex)
    W = (np.roll(Z, -1) - np.roll(Z, 1)) / (2.0 * 2.0j * np.pi)
    area = 0.5 * np.imag(np.sum(np.conj(Z) * np.roll(Z, -1)))
    return -W if area < 0 else W


def check_complex_symmetric(A, tol=1e-12) -> bool:
    """A == A^T (not A^H), for a complex numpy array or tensor."""
    if hasattr(A, "detach"):
        A = A.detach().cpu().numpy()
    A = np.asarray(A)
    return np.iscomplexobj(A) and np.allclose(A, A.T, atol=tol)
