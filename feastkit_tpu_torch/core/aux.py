"""Auxiliary subsystems (PyTorch port): the custom-contour registry,
input validation, polygon membership, Cauchy weights, printing, the memory
estimate and the stochastic eigenvalue count.

A copy of ``feastkit_tpu/core/aux.py``: a contour registered under an id
that lives in fpm[29], so copying fpm keeps the association (the drivers
read it with ``feast_get_custom_contour`` before they build the default
contour), its scoped form ``with_custom_contour``, point-in-polygon
membership and Cauchy weights for user nodes, the complex-symmetry test,
the checks of sizes and contours, the run summary and eigenvalue table
under the fpm[1] print level, the workspace estimate of the port's
buffers and the Hutchinson count of fpm[14] = 2 on a caller's filter.
"""
from __future__ import annotations

import threading

import numpy as np

from .parameters import FeastParameters, _ensure_fpm
from .types import Contour

__all__ = ["feast_set_custom_contour", "feast_get_custom_contour",
           "feast_clear_custom_contour", "feast_clear_all_contours",
           "with_custom_contour", "feast_inside_contourx",
           "feast_cauchy_weights", "check_feast_input", "validate_contour",
           "check_complex_symmetric", "feast_memory_estimate", "feast_info",
           "feast_trace_eigenvalues", "feast_estimate_count"]

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


def feast_clear_all_contours() -> None:
    with _REGISTRY_LOCK:
        _CUSTOM_CONTOURS.clear()


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


def check_feast_input(N, M0, *, Emin=None, Emax=None, Emid=None, r=None):
    """Size and region checks of the RCI entry points (check_feast_srci_input
    / check_feast_grci_input, feast_aux.jl:369-425)."""
    if N <= 0:
        raise ValueError(f"Problem size N must be positive, got {N}")
    if not 0 < M0 <= N:
        raise ValueError(f"Subspace size M0 must be in 1..N={N}, got {M0}")
    if Emin is not None and Emax is not None and not Emax > Emin:
        raise ValueError(f"Invalid interval: Emin={Emin} >= Emax={Emax}")
    if r is not None and not r > 0:
        raise ValueError(f"Contour radius must be positive, got {r}")


def validate_contour(contour: Contour, *, require_closed=False) -> bool:
    """Matching 1-D finite nodes and weights, distinct nodes
    (feast_aux.jl:600-622)."""
    Z = np.asarray(contour.Zne)
    W = np.asarray(contour.Wne)
    if Z.shape != W.shape or Z.ndim != 1 or Z.size == 0:
        raise ValueError("Contour must have matching 1-D nodes and weights")
    if not (np.isfinite(Z).all() and np.isfinite(W).all()):
        raise ValueError("Contour contains non-finite nodes or weights")
    if np.unique(Z).size != Z.size:
        raise ValueError("Contour nodes must be distinct")
    return True


def check_complex_symmetric(A, tol=1e-12) -> bool:
    """A == A^T (not A^H), for a complex numpy array or tensor."""
    if hasattr(A, "detach"):
        A = A.detach().cpu().numpy()
    A = np.asarray(A)
    return np.iscomplexobj(A) and np.allclose(A, A.T, atol=tol)


def _host(X) -> np.ndarray:
    if hasattr(X, "detach"):
        X = X.detach().cpu().numpy()
    return np.asarray(X)


def feast_memory_estimate(N, M0, ne, *, dtype=np.complex128, dense=True,
                          store_factorization=True) -> dict:
    """Workspace bytes of a solve on the port's own buffers
    (feast_aux.jl:645-664), at ``dtype``'s item size: the subspace Q and
    its filtered image ("subspace", 2 N M0); the shifted solves' right-hand
    sides and solutions of one filter application ("solves", ne N M0; the
    Krylov engine holds them a node group at a time); the M0 x M0 reduced
    matrices ("reduced", four); and, for the dense engine, the LU factors of
    the ne shifted pencils ("factors", ne N^2, one pencil's when
    fpm[10] = 0 refactors per application). The port has no real
    embeddings of complex operands and no (re, im) pair modes, so nothing
    else is counted."""
    isize = np.dtype(dtype).itemsize
    est = {
        "subspace": 2 * N * M0 * isize,
        "solves": ne * N * M0 * isize,
        "reduced": 4 * M0 * M0 * isize,
    }
    if dense:
        est["factors"] = (ne if store_factorization else 1) * N * N * isize
    est["total"] = sum(est.values())
    return est


def feast_info(result, fpm=None, file=None):
    """Run summary, silent under fpm[1] = 0 (feast_info_symmetric / general,
    feast_aux.jl:529-596)."""
    import sys
    file = file or sys.stdout
    if fpm is not None and _ensure_fpm(fpm)[1] == 0:
        return
    print("FEAST run info:", file=file)
    print(f"  M (found)   : {result.M}", file=file)
    print(f"  loops       : {result.loop}", file=file)
    print(f"  epsout      : {result.epsout:.3e}", file=file)
    print(f"  info        : {int(result.info)} ({result.info.name})", file=file)


def feast_trace_eigenvalues(result, file=None):
    """Eigenvalue table (feast_trace_eigenvalues, feast_aux.jl:624-643)."""
    import sys
    file = file or sys.stdout
    lam, res = _host(result.lam), _host(result.res)
    print(f"{'idx':>4} {'lambda':>24} {'residual':>12}", file=file)
    for j in range(result.M):
        lam_s = (f"{lam[j]:.12g}" if np.isrealobj(lam)
                 else f"{lam[j].real:+.6g}{lam[j].imag:+.6g}i")
        print(f"{j:>4} {lam_s:>24} {res[j]:>12.3e}", file=file)


def feast_estimate_count(solve_filtered, N, interval_or_contour, fpm=None,
                         *, trials=None, seed=0, device=None) -> float:
    """Hutchinson estimate of the eigenvalue count inside the contour,
    M_est = (1/T) sum_t v_t^T (P v_t) over T Rademacher probes (the
    fpm[14] = 2 / fpm[32] mode, feast_parameters.jl:71-75).
    ``solve_filtered(V) -> P V`` is the caller's filtered-subspace
    application; V is an (N, T) float64 tensor on ``device`` (None: CUDA)
    and the probes are the JAX package's (a numpy ``default_rng(seed)``),
    so both packages estimate from the same vectors."""
    import torch
    from .backend import resolve_device
    fpm = _ensure_fpm(fpm)
    T = trials if trials is not None else fpm[32]
    rng = np.random.default_rng(seed)
    V = rng.choice([-1.0, 1.0], size=(N, T))
    PV = _host(solve_filtered(torch.as_tensor(V).to(resolve_device(device))))
    return float(np.einsum("nt,nt->", V, np.real(PV)) / T)
