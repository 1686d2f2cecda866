"""The FEAST subspace-iteration core for symmetric problems, on torch
tensors.

Counterpart of ``feastkit_tpu/kernel/hermitian.py``:
``make_rayleigh_ritz_update`` turns a filtered subspace into the next
state (orthonormalize with rank deflation, reduced pencil, Ritz pairs,
residuals, inside mask, convergence), ``verify_spurious_from`` is the
final projector-norm test, and ``feast_hermitian_core`` drives the whole
refinement around a ``filter_apply`` callable (the Krylov contour engine's
``_sparse_ops``), with ``make_hermitian_body``, ``verify_spurious`` and the
warm-start and tolerance-hint protocols of ``_filter_with_ok``. The JAX
package's core is one fused ``while_loop``; here it is a host loop that
reads the convergence flag (with epsout, for the next hint) once per loop.
The orthonormalization is the thin-SVD route the JAX package takes off
the TPU (computed as QR + SVD of the small factor). Where the rows of N are
split over ranks (``nsum``, the sum over the model axis of
``parallel/pfeast.py``), it is the JAX package's Gram route instead: G0 =
nsum(Q^H Q), its eigh on every rank, U = Q V s^-1 and a Newton-Schulz
re-orthonormalization, with every contraction over N an explicit ``nsum``
(the Rayleigh-Ritz pencil, the column norms, the residuals and the
verification's rho); the JAX package's other use of that route, the TPU's
weak f64 matrix products, does not arise here.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from ..core.tools import (inside_first_order, orthonormalize,
                          reduced_hermitian_gevp, residuals, thin_svd)
from ..core.types import FeastError, FeastResult, _trim

__all__ = ["HermitianState", "make_rayleigh_ritz_update",
           "verify_spurious_from", "init_hermitian_state", "SPURIOUS_RES",
           "VERIFY_FILTER_TOL", "LOOP_TOL_CAP", "feast_hermitian_core",
           "make_hermitian_body", "verify_spurious", "refine",
           "hermitian_result"]

# In-loop plausibility cut: Ritz pairs with O(1) residual are never counted
# toward convergence (counterpart of fpm[38] spurious detection).
SPURIOUS_RES = 0.1

# Inner accuracy the spurious-verification filter pass needs (it feeds only
# the projector-norm test rho > 0.25): the hint the core passes to an
# iterative filter's verify application.
VERIFY_FILTER_TOL = 2e-3

# Cap on the inner accuracy hints of loop filter applications: inner errors
# must stay a decade below the rank-deflation cut (eps^(1/4) ~ 1.2e-4 in
# f64).
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


def _col_sq(X):
    return torch.sum((X.conj() * X).real, dim=0)


def _gram_basis(Qproj, nsum):
    """(U, s) of the filtered subspace whose rows are split over ranks:
    G0 = nsum(Q^H Q), its eigenpairs in descending order, U = Q V s^-1
    (the JAX package's Gram route)."""
    lamG, Vg = torch.linalg.eigh(nsum(Qproj.mH @ Qproj))
    s = torch.sqrt(torch.clamp(lamG.flip(0), min=0.0)).to(Qproj.real.dtype)
    Vg = Vg.flip(-1)
    return Qproj @ (Vg / torch.where(s > 0, s, 1.0)[None, :].to(Vg.dtype)), s


def make_rayleigh_ritz_update(apply_A: Callable, apply_B: Callable,
                              Emin, Emax, *, tol: float,
                              convergence_criterion: int = 1,
                              nsum: Optional[Callable] = None) -> Callable:
    """(state, Qproj, solves_ok) -> next state: the non-filter half of a
    refinement loop (same steps and thresholds as the JAX package).
    ``nsum``: the sum over the ranks that hold N's row blocks (the Gram
    route, see the module docstring), or None."""

    def update(state: HermitianState, Qproj, solves_ok=True):
        rdtype = Qproj.real.dtype
        dev = Qproj.device
        # Rank-deflation threshold eps^(1/4) on the filtered subspace's
        # singular spectrum (see the JAX package for the derivation).
        cut = float(torch.finfo(rdtype).eps) ** 0.25
        # Deflated directions get a Ritz value just outside the interval.
        BIG = float(Emax) + 2.0 * (float(Emax) - float(Emin))
        U, s = thin_svd(Qproj) if nsum is None else _gram_basis(Qproj, nsum)
        m = (s >= cut * s[0]).to(rdtype)
        Um = U * m[None, :].to(U.dtype)
        dead = torch.diag(1.0 - m).to(U.dtype)
        red = (lambda x: x) if nsum is None else nsum
        if nsum is not None:
            # Newton-Schulz inverse square root of the kept Gram matrix
            # (one re-orthonormalization pass; masked columns stay zero)
            G1 = nsum(Um.mH @ Um) + dead
            G1 = 0.5 * (G1 + G1.mH)
            eye = torch.eye(G1.shape[0], dtype=G1.dtype, device=dev)
            X = eye
            for _ in range(6):
                X = 0.5 * (X @ (3.0 * eye - G1 @ X @ X))
            Um = (Um @ X) * m[None, :].to(U.dtype)
        S = red(Um.mT.conj() @ apply_A(Um)) + BIG * dead
        G = red(Um.mT.conj() @ apply_B(Um)) + dead
        lam, V = reduced_hermitian_gevp(S, G)
        q = Um @ V
        nrm = torch.linalg.vector_norm(q, dim=0) if nsum is None \
            else torch.sqrt(nsum(_col_sq(q)))
        q = q / torch.where(nrm > 0, nrm, torch.ones_like(nrm))[None, :]
        lam = lam.real.to(rdtype)
        if nsum is None:
            res = residuals(apply_A, apply_B, lam, q)
        else:
            r = apply_A(q) - lam[None, :].to(q.dtype) * apply_B(q)
            res = torch.sqrt(nsum(_col_sq(r))) / torch.clamp(lam.abs(),
                                                              min=1.0)
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


def verify_spurious_from(state: HermitianState, Qproj, ok=True, *,
                         general: bool = False,
                         nsum: Optional[Callable] = None) -> HermitianState:
    """Final spurious verification from a filtered subspace: a genuine
    inside pair keeps projector norm rho = ||P q|| > 0.25. ``general``: a
    ``kernel/general.GeneralState``, reordered by |lam|. ``nsum``: the sum
    over the ranks that hold N's row blocks, or None."""
    rho = torch.linalg.vector_norm(Qproj, dim=0) if nsum is None \
        else torch.sqrt(nsum(_col_sq(Qproj)))
    genuine = state.inside & (rho > 0.25) & (state.res < SPURIOUS_RES)
    order = inside_first_order(state.lam, genuine, general=general)
    zero = torch.zeros((), dtype=state.res.dtype, device=state.res.device)
    return state._replace(
        lam=state.lam[order], Q=state.Q[:, order], res=state.res[order],
        inside=genuine[order],
        epsout=torch.where(genuine, state.res, zero).max(),
        inner_ok=torch.as_tensor(state.inner_ok, device=Qproj.device)
        & torch.as_tensor(ok, device=Qproj.device))


def _filter_with_ok(filter_apply, Q, lam=None, tol_hint=None):
    """filter_apply may return Qproj or (Qproj, ok): iterative filters
    report whether every inner solve converged (ok True otherwise).

    Ritz warm-start protocol: a filter_apply carrying ``takes_ritz=True``
    gets the current Ritz values (``lam=``) and starts each node's inner
    solves from X0 = Q diag(1/(z - lam)). Adaptive-tolerance protocol: a
    ``takes_tol=True`` filter gets ``tol_hint=``, the inner accuracy this
    application needs (a host float)."""
    kwargs = {}
    if lam is not None and getattr(filter_apply, "takes_ritz", False):
        kwargs["lam"] = lam
    if tol_hint is not None and getattr(filter_apply, "takes_tol", False):
        kwargs["tol_hint"] = tol_hint
    out = filter_apply(Q, **kwargs)
    if isinstance(out, tuple):
        Qproj, ok = out
        return Qproj, torch.as_tensor(ok, device=Qproj.device)
    return out, torch.tensor(True, device=out.device)


def make_hermitian_body(apply_A: Callable, apply_B: Callable,
                        filter_apply: Callable, Emin, Emax, *, tol: float,
                        convergence_criterion: int = 1,
                        nsum: Optional[Callable] = None) -> Callable:
    """One FEAST refinement iteration, (state, epsout) -> state, epsout the
    previous loop's as a host float."""
    update = make_rayleigh_ritz_update(
        apply_A, apply_B, Emin, Emax, tol=tol,
        convergence_criterion=convergence_criterion, nsum=nsum)

    def body(state: HermitianState, epsout: float) -> HermitianState:
        # inexact-FEAST inner target 0.1 epsout^2, capped (epsout = inf on
        # loop 0 -> exactly the cap)
        hint = min(0.1 * epsout * epsout, LOOP_TOL_CAP)
        Qproj, solves_ok = _filter_with_ok(filter_apply, state.Q, state.lam,
                                           hint)
        return update(state, Qproj, solves_ok)

    return body


def verify_spurious(state: HermitianState, filter_apply: Callable,
                    nsum: Optional[Callable] = None) -> HermitianState:
    """Final spurious verification with one more filter application (at
    the verify hint VERIFY_FILTER_TOL): see :func:`verify_spurious_from`."""
    Qproj, ok = _filter_with_ok(filter_apply, state.Q, state.lam,
                                VERIFY_FILTER_TOL)
    return verify_spurious_from(state, Qproj, ok, nsum=nsum)


def feast_hermitian_core(apply_A: Callable, apply_B: Callable,
                         filter_apply: Callable, Q0, Emin, Emax, *,
                         tol: float, max_loops: int,
                         convergence_criterion: int = 1,
                         subspace_only: bool = False,
                         nsum: Optional[Callable] = None) -> HermitianState:
    """The FEAST refinement around ``filter_apply`` (counterpart of the JAX
    package's fused core): at most max_loops + 1 loops, stopping once the
    state converges, then the spurious verification. subspace_only
    (fpm[14]=1): return the first filtered subspace, orthonormalized, with
    loop = 1. ``nsum``: the sum over the ranks that hold N's row blocks
    (every rank then holds its rows of Q0 and of the result), or None."""
    init = init_hermitian_state(Q0)
    if subspace_only:
        Qproj, ok = _filter_with_ok(filter_apply, init.Q)
        U = orthonormalize(Qproj)[0] if nsum is None \
            else _gram_basis(Qproj, nsum)[0]
        return init._replace(Q=U, loop=1, inner_ok=ok)
    body = make_hermitian_body(apply_A, apply_B, filter_apply, Emin, Emax,
                               tol=tol,
                               convergence_criterion=convergence_criterion,
                               nsum=nsum)
    return verify_spurious(refine(body, init, max_loops), filter_apply,
                           nsum=nsum)


def refine(body: Callable, state, max_loops: int):
    """The refinement loop of both cores: ``body(state, epsout)`` at most
    max_loops + 1 times from ``state``, stopping once it converges."""
    epsout = float("inf")
    while state.loop < max_loops + 1:
        state = body(state, epsout)
        # one host read per loop: the flag and epsout (the next hint)
        conv, epsout = torch.stack([state.converged.to(state.epsout.dtype),
                                    state.epsout]).tolist()
        if conv:
            break
    return state


def hermitian_result(state: HermitianState) -> FeastResult:
    """The trimmed result of a finished refinement (see
    ``kernel/general.general_result``)."""
    info = FeastError.SUCCESS if bool(state.converged) \
        else FeastError.NO_CONVERGENCE
    return _trim(FeastResult, state.lam.cpu().numpy(), state.Q,
                 state.res.cpu().numpy(), state.inside.cpu().numpy(),
                 int(info), float(state.epsout), int(state.loop) - 1,
                 inner_ok=bool(state.inner_ok))
