"""Small dense general (non-Hermitian) eigendecomposition of the reduced
Rayleigh-Ritz pencil (PyTorch).

Counterpart of ``feastkit_tpu/ops/eig.py``. The reduced problem is M0 x M0
(M0 of order 100), so it runs through LAPACK ``geev`` on the host, as the
JAX package's ``method="callback"`` does (numpy's ``eig`` in the matrix's
own precision, eigenvalues in ascending (Re, Im) order), whatever device
the solve runs on; the (M0, M0) transfer is small beside the contour
solves. The JAX package's ``method="qr"``, an on-device Hessenberg and
shifted-QR Schur decomposition for runtimes that cannot call back to the
host, is a TPU workaround: the port accepts the name and runs the same
LAPACK path.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["general_eig", "generalized_eig", "check_method"]

_METHODS = ("callback", "qr")


def check_method(method: str | None) -> None:
    """Validate an eigensolver name at an entry point: None, "callback"
    or "qr" (all three run host LAPACK ``geev``)."""
    if method is not None and method not in _METHODS:
        raise ValueError(f"Unknown eig method {method!r}; valid: {_METHODS}")


def _host_eig(a: np.ndarray):
    w, v = np.linalg.eig(a)
    # a fixed ordering for determinism: ascending (real, imag)
    order = np.lexsort((w.imag, w.real))
    return w[order].astype(a.dtype), v[:, order].astype(a.dtype)


def general_eig(A, method: str | None = "callback"):
    """Eigenvalues and right eigenvectors of a small general complex
    matrix: (w (n,), V (n, n)) with A V = V diag(w), ascending by (Re, Im),
    on A's device."""
    check_method(method)
    w, v = _host_eig(A.detach().cpu().numpy())
    return (torch.as_tensor(w).to(A.device),
            torch.as_tensor(v).to(A.device))


def generalized_eig(S, G, method: str | None = "callback"):
    """Solve the small general pencil S v = lam G v.

    The FEAST reduced pencil has G = U^H B U with U orthonormal, so G is as
    well conditioned as B; the pencil is reduced to T = G^-1 S through an
    SVD-regularized inverse (directions of G below n eps s_max get a zero
    inverse weight, hence eigenvalues far outside any search region)."""
    n = S.shape[-1]
    U, s, Vh = torch.linalg.svd(G)
    rcond = float(np.finfo(np.float32 if S.dtype == torch.complex64
                           else np.float64).eps) * n
    s_max = torch.clamp(s[0], min=1e-30)
    s_inv = torch.where(s > rcond * s_max,
                        1.0 / torch.clamp(s, min=1e-30),
                        torch.zeros_like(s))
    Ginv = (Vh.mH * s_inv[None, :].to(Vh.dtype)) @ U.mH
    return general_eig(Ginv @ S, method=method)
