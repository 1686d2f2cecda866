"""The FEAST subspace-iteration core for general (non-Hermitian) and
complex-symmetric problems, on torch tensors.

Counterpart of ``feastkit_tpu/kernel/general.py``: the full contour around
a complex centre, the subspace-only accumulation q += W_e X_e (no
conjugate doubling), Rayleigh-Ritz on the orthonormalized filtered basis
with the adjoint pairing S = U^H A U (general) or the transpose pairing
S = U^T A U (``bilinear``, complex symmetric), the reduced general pencil
through ``ops/eig.generalized_eig``, membership of the rotated ellipse
(Emid, r, aspect ratio, rotation) and the deflation and spurious machinery
of the Hermitian core. As in ``kernel/hermitian.py`` the loop is a host
loop that reads the convergence flag (with epsout, for the next inner
tolerance hint) once per loop, and the orthonormalization is the thin SVD
computed as QR and the SVD of the small factor (the same singular values
and left vectors as the JAX package's direct SVD, up to column phases,
which leave the Ritz values unchanged).
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..core.aux import feast_get_custom_contour
from ..core.contour import feast_gcontour
from ..core.tools import inside_first_order, residuals, thin_svd
from ..core.types import FeastError, FeastGeneralResult, _trim
from ..ops.eig import generalized_eig
from .hermitian import (LOOP_TOL_CAP, SPURIOUS_RES, VERIFY_FILTER_TOL,
                        _filter_with_ok, refine, verify_spurious_from)

__all__ = ["GeneralState", "feast_general_core", "make_general_body",
           "init_general_state", "verify_spurious_general",
           "contour_tensors", "general_result"]


class GeneralState(NamedTuple):
    """Carried through the refinement loop (see ``HermitianState``); ``lam``
    and ``trace`` are complex."""

    loop: int
    Q: Optional[torch.Tensor]   # (N, M0) complex subspace
    lam: torch.Tensor           # (M0,) complex Ritz values
    res: torch.Tensor           # (M0,) relative residuals
    inside: torch.Tensor        # (M0,) bool
    epsout: torch.Tensor
    trace: torch.Tensor         # complex
    converged: torch.Tensor
    inner_ok: torch.Tensor


def init_general_state(Q0: torch.Tensor) -> GeneralState:
    M0 = Q0.shape[1]
    dev = Q0.device
    rdtype = Q0.real.dtype
    return GeneralState(
        loop=0, Q=Q0,
        lam=torch.zeros(M0, dtype=Q0.dtype, device=dev),
        res=torch.full((M0,), float("inf"), dtype=rdtype, device=dev),
        inside=torch.zeros(M0, dtype=torch.bool, device=dev),
        epsout=torch.tensor(float("inf"), dtype=rdtype, device=dev),
        trace=torch.tensor(complex("nan+0j"), dtype=Q0.dtype, device=dev),
        converged=torch.tensor(False, device=dev),
        inner_ok=torch.tensor(True, device=dev))


def make_general_body(apply_A: Callable, apply_B: Callable,
                      filter_apply: Callable, Emid, r, *, tol: float,
                      aspect_ratio: float = 1.0, rotation_deg: float = 0.0,
                      convergence_criterion: int = 1, bilinear: bool = False
                      ) -> Callable:
    """One general-FEAST refinement iteration, (state, epsout) -> state,
    epsout the previous loop's as a host float. Directions of the filtered
    basis below eps^(1/4) of its largest singular value are deflated."""
    pair = (lambda U: U.mT) if bilinear else (lambda U: U.mH)
    rot = complex(np.exp(-1j * (rotation_deg / 180.0) * np.pi))
    Emid, r = complex(Emid), float(r)

    def inside_region(lam):
        w = (lam - Emid).to(torch.complex128) * rot
        x = w.real / r
        y = w.imag / (r * aspect_ratio)
        return x * x + y * y <= 1.0

    def body(state: GeneralState, epsout: float) -> GeneralState:
        cdtype = state.Q.dtype
        rdtype = state.res.dtype
        cut = float(torch.finfo(rdtype).eps) ** 0.25
        # deflated directions' Ritz marker: outside the ellipse but of the
        # problem's scale (see the Hermitian core's marker)
        marker = Emid + 3.0 * r
        # inexact-FEAST inner target 0.1 epsout^2, capped
        hint = min(0.1 * epsout * epsout, LOOP_TOL_CAP)
        Qproj, solves_ok = _filter_with_ok(filter_apply, state.Q, state.lam,
                                           hint)
        U, s = thin_svd(Qproj)
        m = (s >= cut * s[0]).to(rdtype)
        Um = U * m[None, :].to(cdtype)
        dead = torch.diag(1.0 - m).to(cdtype)
        S = pair(Um) @ apply_A(Um) + marker * dead
        G = pair(Um) @ apply_B(Um) + dead
        lam, V = generalized_eig(S, G)
        q = Um @ V
        nrm = torch.linalg.vector_norm(q, dim=0)
        q = q / torch.where(nrm > 0, nrm, torch.ones_like(nrm))[None, :]
        res = residuals(apply_A, apply_B, lam, q)
        inside = inside_region(lam)
        order = inside_first_order(lam, inside, general=True)
        lam, q, res, inside = lam[order], q[:, order], res[order], \
            inside[order]
        plausible = inside & (res < SPURIOUS_RES)
        M = plausible.sum()
        epsout_t = torch.where(plausible, res, torch.zeros_like(res)).max()
        trace = torch.where(plausible, lam, torch.zeros_like(lam)).sum()
        if convergence_criterion == 1:
            conv = (epsout_t <= tol) & (M > 0)
        else:
            scale = torch.clamp(state.trace.abs(), min=1.0)
            conv = ((trace - state.trace).abs() <= tol * scale) & (M > 0)
        dev = Qproj.device
        ok = torch.as_tensor(state.inner_ok, device=dev) \
            & torch.as_tensor(solves_ok, device=dev)
        return GeneralState(loop=state.loop + 1, Q=q, lam=lam, res=res,
                            inside=inside, epsout=epsout_t, trace=trace,
                            converged=conv, inner_ok=ok)

    return body


def verify_spurious_general(state: GeneralState, filter_apply: Callable
                            ) -> GeneralState:
    """Final projector-norm spurious acceptance with one more filter
    application at the verify hint (see ``kernel/hermitian``)."""
    Qproj, ok = _filter_with_ok(filter_apply, state.Q, state.lam,
                                VERIFY_FILTER_TOL)
    return verify_spurious_from(state, Qproj, ok, general=True)


def feast_general_core(apply_A: Callable, apply_B: Callable,
                       filter_apply: Callable, Q0, Emid, r, *, tol: float,
                       max_loops: int, aspect_ratio: float = 1.0,
                       rotation_deg: float = 0.0,
                       convergence_criterion: int = 1,
                       subspace_only: bool = False, bilinear: bool = False
                       ) -> GeneralState:
    """The general FEAST refinement around ``filter_apply``: at most
    max_loops + 1 loops, stopping once the state converges, then the
    spurious verification. subspace_only (fpm[14]=1): the first filtered
    subspace, orthonormalized, with loop = 1."""
    init = init_general_state(Q0)
    if subspace_only:
        Qproj, ok = _filter_with_ok(filter_apply, init.Q)
        U, _ = thin_svd(Qproj)
        return init._replace(Q=U, loop=1, inner_ok=ok)
    body = make_general_body(
        apply_A, apply_B, filter_apply, Emid, r, tol=tol,
        aspect_ratio=aspect_ratio, rotation_deg=rotation_deg,
        convergence_criterion=convergence_criterion, bilinear=bilinear)
    return verify_spurious_general(refine(body, init, max_loops),
                                   filter_apply)


def contour_tensors(fpm, Emid, r, cdtype, device, contour=None):
    """Nodes and weights of a general driver's contour (``contour``, else
    the fpm[29] registry's, else the fpm full contour around Emid) as
    ``cdtype`` tensors on ``device``."""
    if contour is None:
        contour = feast_get_custom_contour(fpm)
    if contour is None:
        contour = feast_gcontour(complex(Emid), float(r), fpm)
    return (torch.as_tensor(np.asarray(contour.Zne, cdtype)).to(device),
            torch.as_tensor(np.asarray(contour.Wne, cdtype)).to(device))


def general_result(state: GeneralState) -> FeastGeneralResult:
    """The trimmed result of a finished general refinement."""
    info = FeastError.SUCCESS if bool(state.converged) \
        else FeastError.NO_CONVERGENCE
    return _trim(FeastGeneralResult, state.lam.cpu().numpy(), state.Q,
                 state.res.cpu().numpy(), state.inside.cpu().numpy(),
                 int(info), float(state.epsout), int(state.loop) - 1,
                 inner_ok=bool(state.inner_ok))
