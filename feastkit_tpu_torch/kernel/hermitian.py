"""The Rayleigh-Ritz half of a FEAST refinement loop, on torch tensors.

Counterpart of ``feastkit_tpu/kernel/hermitian.py`` for host-driven
loops: ``make_rayleigh_ritz_update`` turns a filtered subspace into the
next state (orthonormalize with rank deflation, reduced pencil, Ritz
pairs, residuals, inside mask, convergence), and ``verify_spurious_from``
is the final projector-norm test. The orthonormalization is the thin-SVD
route the JAX package takes off the TPU (computed as QR + SVD of the small
factor); its Gram + Newton-Schulz route exists only for the TPU's weak f64
matrix products and is not ported.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from ..core.tools import (inside_first_order, reduced_hermitian_gevp,
                          residuals, thin_svd)

__all__ = ["HermitianState", "make_rayleigh_ritz_update",
           "verify_spurious_from", "init_hermitian_state", "SPURIOUS_RES",
           "VERIFY_FILTER_TOL", "LOOP_TOL_CAP"]

# In-loop plausibility cut: Ritz pairs with O(1) residual are never counted
# toward convergence (counterpart of fpm[38] spurious detection).
SPURIOUS_RES = 0.1

# Inner accuracy the spurious-verification filter pass needs (it feeds only
# the projector-norm test rho > 0.25); kept for the contract of iterative
# filters, which the port does not have yet.
VERIFY_FILTER_TOL = 2e-3

# Cap on the inner accuracy hints of loop filter applications (iterative
# filters only; kept for the same contract).
LOOP_TOL_CAP = 3e-5


class HermitianState(NamedTuple):
    """Carried through the refinement loop. ``loop`` is a Python int; the
    other fields are tensors on the solve's device (``Q`` may be None while
    a filter application holds the subspace)."""

    loop: int
    Q: Optional[torch.Tensor]   # (N, M0) current subspace
    lam: torch.Tensor           # (M0,) Ritz values, inside-first order
    res: torch.Tensor           # (M0,) relative residuals
    inside: torch.Tensor        # (M0,) bool validity mask
    epsout: torch.Tensor        # max residual over plausible inside pairs
    trace: torch.Tensor         # sum of plausible inside Ritz values
    converged: torch.Tensor     # bool
    inner_ok: torch.Tensor      # bool: inner solves met their tolerance


def init_hermitian_state(Q0: torch.Tensor) -> HermitianState:
    M0 = Q0.shape[1]
    kw = dict(dtype=Q0.real.dtype, device=Q0.device)
    return HermitianState(
        loop=0, Q=Q0,
        lam=torch.zeros(M0, **kw),
        res=torch.full((M0,), float("inf"), **kw),
        inside=torch.zeros(M0, dtype=torch.bool, device=Q0.device),
        epsout=torch.tensor(float("inf"), **kw),
        trace=torch.tensor(float("nan"), **kw),
        converged=torch.tensor(False, device=Q0.device),
        inner_ok=torch.tensor(True, device=Q0.device))


def make_rayleigh_ritz_update(apply_A: Callable, apply_B: Callable,
                              Emin, Emax, *, tol: float,
                              convergence_criterion: int = 1) -> Callable:
    """(state, Qproj, solves_ok) -> next state: the non-filter half of a
    refinement loop (same steps and thresholds as the JAX package)."""

    def update(state: HermitianState, Qproj, solves_ok=True):
        rdtype = Qproj.real.dtype
        dev = Qproj.device
        # Rank-deflation threshold eps^(1/4) on the filtered subspace's
        # singular spectrum (see the JAX package for the derivation).
        cut = float(torch.finfo(rdtype).eps) ** 0.25
        # Deflated directions get a Ritz value just outside the interval.
        BIG = float(Emax) + 2.0 * (float(Emax) - float(Emin))
        U, s = thin_svd(Qproj)
        m = (s >= cut * s[0]).to(rdtype)
        Um = U * m[None, :].to(U.dtype)
        dead = torch.diag(1.0 - m).to(U.dtype)
        S = Um.mT.conj() @ apply_A(Um) + BIG * dead
        G = Um.mT.conj() @ apply_B(Um) + dead
        lam, V = reduced_hermitian_gevp(S, G)
        q = Um @ V
        nrm = torch.linalg.vector_norm(q, dim=0)
        q = q / torch.where(nrm > 0, nrm, torch.ones_like(nrm))[None, :]
        lam = lam.real.to(rdtype)
        res = residuals(apply_A, apply_B, lam, q)
        inside = (lam >= Emin) & (lam <= Emax)
        order = inside_first_order(lam, inside)
        lam, q, res, inside = lam[order], q[:, order], res[order], \
            inside[order]
        plausible = inside & (res < SPURIOUS_RES)
        M = plausible.sum()
        zero = torch.zeros((), dtype=rdtype, device=dev)
        epsout = torch.where(plausible, res, zero).max()
        trace = torch.where(plausible, lam, zero).sum()
        if convergence_criterion == 1:
            conv = (epsout <= tol) & (M > 0)
        else:
            scale = torch.clamp(state.trace.abs(), min=1.0)
            conv = ((trace - state.trace).abs() <= tol * scale) & (M > 0)
        ok = torch.as_tensor(state.inner_ok, device=dev) \
            & torch.as_tensor(solves_ok, device=dev)
        return HermitianState(loop=state.loop + 1, Q=q, lam=lam, res=res,
                              inside=inside, epsout=epsout, trace=trace,
                              converged=conv, inner_ok=ok)

    return update


def verify_spurious_from(state: HermitianState, Qproj,
                         ok=True) -> HermitianState:
    """Final spurious verification from a filtered subspace: a genuine
    inside pair keeps projector norm rho = ||P q|| > 0.25."""
    rho = torch.linalg.vector_norm(Qproj, dim=0)
    genuine = state.inside & (rho > 0.25) & (state.res < SPURIOUS_RES)
    order = inside_first_order(state.lam, genuine)
    zero = torch.zeros((), dtype=state.res.dtype, device=state.res.device)
    return state._replace(
        lam=state.lam[order], Q=state.Q[:, order], res=state.res[order],
        inside=genuine[order],
        epsout=torch.where(genuine, state.res, zero).max(),
        inner_ok=torch.as_tensor(state.inner_ok, device=Qproj.device)
        & torch.as_tensor(ok, device=Qproj.device))
