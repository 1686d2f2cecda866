"""Matrix-free FEAST on torch tensors: the operator protocol, the interval
and general drivers, and polynomial eigenproblems by operators.

Counterpart of ``feastkit_tpu/solvers/matfree.py``. An operator is a
callable on (N, K) blocks (``LinearOperator``): the caller's matvec, on
whatever device the caller's data lives. The contour engine solves each
contour node's shifted system (z B - A) X = B Q with restarted GMRES or
BiCGStab on the M0 columns at once (``create_iterative_solver``), or with
the caller's own ``solve_shifted(z, RHS) -> X``; the nodes are solved one
after another, as the JAX package's ``jax.lax.map`` does, so the caller's
matvec sees one node's block at a time. ``solver="cheb"`` /
``"contour_poly"`` filter by forward applications only (the Chebyshev
recurrence of ``ops/chebfilter.make_cheb_filter`` on the operator, the
spectrum enclosure from ``operator_spectrum_bounds``' Lanczos unless the
caller gives one).

torch does not promote inside a product, where the JAX package's traced
callables do: a real operator applied to a complex block runs as two real
calls, A Re X + i A Im X (``LinearOperator.__call__``).

The JAX package's pair-carried complex128 path for real operators on a
TPU (``pair_f64``: complex64 GMRES inside float64 (re, im) refinement,
floored at tol 1e-7) and its demotion of complex128 work
(``demote_f64_general``) exist because a TPU cannot compile complex128;
the port runs native complex128, as the JAX package does on the CPU.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from ..core.aux import feast_get_custom_contour
from ..core.backend import resolve_device
from ..core.contour import feast_contour, feast_gcontour
from ..core.parameters import FeastConfig, _ensure_fpm
from ..core.tools import initial_subspace
from ..core.types import FeastGeneralResult, FeastResult
from ..kernel.general import feast_general_core, general_result
from ..kernel.hermitian import (VERIFY_FILTER_TOL, feast_hermitian_core,
                                hermitian_result)
from ..ops.eig import check_method
from ..ops.gmres import bicgstab_block, gmres_block
from .sparse import _stochastic_estimate_result

__all__ = [
    "polynomial_companion_operators", "feast_polynomial_matvec",
    "LinearOperator", "MatrixVecFunction", "feast_matvec",
    "feast_matvec_general", "create_iterative_solver",
    "operator_spectrum_bounds"]

_POLY_SOLVERS = ("cheb", ":cheb", "contour_poly", ":contour_poly")


def _torch_dtype(dtype) -> torch.dtype:
    """A torch dtype from a torch, numpy or named dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.as_tensor(np.zeros((), np.dtype(dtype))).dtype


def _real_of(dtype: torch.dtype) -> torch.dtype:
    return {torch.complex64: torch.float32,
            torch.complex128: torch.float64}.get(dtype, dtype)


def _apply_promoted(fn, dtype: torch.dtype, X):
    """``fn(X)`` in the type a JAX callable traced on X computes in, the
    promotion of the operator's ``dtype`` and X's: a real operator on a
    complex block as two real calls, A Re X + i A Im X."""
    work = torch.promote_types(dtype, X.dtype)
    if work.is_complex and not dtype.is_complex:
        real = _real_of(work)
        return torch.complex(fn(X.real.to(real).contiguous()),
                             fn(X.imag.to(real).contiguous()))
    return fn(X if X.dtype == work else X.to(work))


class LinearOperator:
    """Matrix-free operator over (N, K) blocks: a matvec, a shape, a dtype
    and structure flags (the JAX package's protocol). ``matvec`` takes a
    2-D tensor (columns are vectors); ``rmatvec`` (the adjoint) is
    optional and defaults to matvec for symmetric / Hermitian operators. A
    1-D operand is applied as one column."""

    def __init__(self, matvec: Callable, shape, dtype, *, rmatvec=None,
                 symmetric: bool = False, hermitian: bool = False,
                 posdef: bool = False):
        self._matvec = matvec
        self.shape = tuple(shape)
        self.dtype = _torch_dtype(dtype)
        self.symmetric = bool(symmetric)
        self.hermitian = bool(hermitian)
        self.posdef = bool(posdef)
        if rmatvec is None and (symmetric or hermitian):
            rmatvec = matvec
        self._rmatvec = rmatvec

    def _apply(self, fn, X):
        squeeze = X.dim() == 1
        Y = _apply_promoted(fn, self.dtype, X[:, None] if squeeze else X)
        return Y[:, 0] if squeeze else Y

    def __call__(self, X):
        return self._apply(self._matvec, X)

    __matmul__ = __call__

    def adjoint(self, X):
        if self._rmatvec is None:
            raise ValueError("This LinearOperator has no adjoint (rmatvec)")
        return self._apply(self._rmatvec, X)

    @staticmethod
    def from_matrix(A, **flags):
        """The operator of a dense matrix (a tensor, or an array made one),
        its products computed where the matrix lives, in the promoted
        type of the matrix and the block."""
        A = A if isinstance(A, torch.Tensor) else torch.as_tensor(
            np.asarray(A))

        def product(M, X):
            work = torch.promote_types(M.dtype, X.dtype)
            return (M.to(work) @ X.to(M.device, work)).to(X.device)
        return LinearOperator(lambda X: product(A, X), A.shape, A.dtype,
                              rmatvec=lambda X: product(A.mH, X), **flags)


def MatrixVecFunction(matvec, shape, dtype=torch.float64, *,
                      issymmetric=False, ishermitian=False,
                      isposdef=False) -> LinearOperator:
    """``LinearOperator`` under the reference's constructor name."""
    return LinearOperator(matvec, shape, dtype, symmetric=issymmetric,
                          hermitian=ishermitian, posdef=isposdef)


def create_iterative_solver(A_op, B_op=None, method="gmres", *, tol=1e-12,
                            restart=30, maxiter=500, flag_tol=None):
    """``solve_shifted(z, RHS) -> X`` solving (z B - A) X = RHS with
    restarted GMRES or BiCGStab on all columns at once. CG is refused:
    z B - A is never Hermitian positive definite for complex z.

    ``solve_shifted.with_info(z, RHS)`` also returns whether every column
    converged; ``solve_shifted.with_guess(z, RHS, X0, tol_hint)`` starts
    from the Ritz guess X0, kept per column only where it beats the zero
    iterate, and aims at ``tol_hint`` clamped to [tol, VERIFY_FILTER_TOL]
    (the refinement loop caps the hints it emits)."""
    if str(method).lstrip(":") == "cg":
        raise ValueError(
            "CG is not valid for FEAST shifted systems (z B - A is never "
            "Hermitian positive definite for complex z); use gmres/bicgstab")
    method = str(method).lstrip(":")
    if method not in ("gmres", "bicgstab"):
        raise ValueError(f"Unknown iterative solver {method!r}")

    def solve_shifted_guess(z, RHS, X0=None, tol_hint=None):
        def op(X):
            BX = X if B_op is None else B_op(X)
            return z * BX - A_op(X)
        t = float(tol) if tol_hint is None else min(
            max(float(tol_hint), float(tol)),
            max(float(tol), VERIFY_FILTER_TOL))
        x0 = None
        if X0 is not None:
            X0 = X0.to(RHS.dtype)
            n0 = torch.linalg.vector_norm(RHS - op(X0), dim=0)
            nb = torch.linalg.vector_norm(RHS, dim=0)
            x0 = torch.where((n0 < nb)[None, :], X0, torch.zeros_like(X0))
        if method == "gmres":
            X, info = gmres_block(op, RHS, tol=t, restart=restart,
                                  maxiter=maxiter, x0=x0, flag_tol=flag_tol)
        else:
            X, info = bicgstab_block(op, RHS, tol=t, maxiter=maxiter,
                                     x0=x0, flag_tol=flag_tol)
        return X, torch.all(info.converged)

    def solve_shifted_info(z, RHS):
        return solve_shifted_guess(z, RHS)

    def solve_shifted(z, RHS):
        return solve_shifted_info(z, RHS)[0]

    solve_shifted.with_info = solve_shifted_info
    solve_shifted.with_guess = solve_shifted_guess
    return solve_shifted


def _as_op(A, device=None):
    """A ``LinearOperator`` as it is; a tensor's operator computes where
    the tensor lives, an array's on ``device`` (None: CUDA)."""
    if isinstance(A, LinearOperator):
        return A
    if callable(A):
        raise ValueError(
            "Wrap bare callables in LinearOperator(matvec, shape, dtype)")
    if not isinstance(A, torch.Tensor):
        A = torch.as_tensor(np.asarray(A), device=resolve_device(device))
    return LinearOperator.from_matrix(A)


def _is_double(dtype: torch.dtype) -> bool:
    """True unless the real-component precision is below 64 bits."""
    return dtype not in (torch.float32, torch.complex64, torch.float16,
                         torch.bfloat16, torch.complex32)


def operator_spectrum_bounds(A_op, N, dtype, *, steps=192, pad=1e-3,
                             device=None):
    """Spectrum enclosure [lo, hi] of a symmetric / Hermitian operator by
    ``steps`` Lanczos steps on the device from the JAX package's
    deterministic start vector (one re-orthogonalization against the two
    carried vectors), the tridiagonal's eigenvalues on the host, each
    edge padded outward by its Ritz value's residual |beta_m v_T[last]|
    and by ``pad`` times the span: a polynomial filter needs an enclosure,
    and an underestimate makes its recurrence diverge. The Lanczos runs in
    ``dtype``'s precision, complex for a complex dtype. ``device=None``
    means CUDA."""
    import scipy.linalg as sla
    device = resolve_device(device)
    dt = _torch_dtype(dtype)
    rdt = torch.float64 if _is_double(dt) else torch.float32
    wdt = dt if dt.is_complex else rdt
    v = torch.as_tensor(np.cos(0.7 * np.arange(N)) + 0.5).to(
        device=device, dtype=rdt)
    v = (v / torch.linalg.vector_norm(v)).to(wdt)
    v_prev = torch.zeros_like(v)
    beta = torch.zeros((), dtype=rdt, device=device)
    al, be = [], []
    for _ in range(int(min(steps, N))):
        w = A_op(v[:, None])[:, 0].to(wdt) - beta * v_prev
        alpha = torch.vdot(v, w).real
        w = w - alpha * v
        # one full re-orthogonalization against the two carried vectors
        # (enough for the edges; interior accuracy is not needed)
        w = w - torch.vdot(v, w) * v - torch.vdot(v_prev, w) * v_prev
        beta = torch.linalg.vector_norm(w)
        v_prev, v = v, w / torch.where(beta > 0, beta, 1.0)
        al.append(alpha)
        be.append(beta)
    al = torch.stack(al).cpu().numpy().astype(np.float64)
    be = torch.stack(be).cpu().numpy().astype(np.float64)
    T = np.diag(al) + np.diag(be[:-1], 1) + np.diag(be[:-1], -1)
    w, V = sla.eigh(T)
    # per-Ritz-value residuals: the raw last beta stays O(1) without full
    # re-orthogonalization and would inflate the enclosure
    r_lo = float(abs(be[-1] * V[-1, 0]))
    r_hi = float(abs(be[-1] * V[-1, -1]))
    lo_e, hi_e = float(w[0]), float(w[-1])
    span = max(hi_e - lo_e, 1e-30)
    return lo_e - r_lo - pad * span, hi_e + r_hi + pad * span


def _contour_filter(solve_shifted, apply_B, Z, W, config, cdtype, *,
                    real=False):
    """filter_apply(Q, lam=None, tol_hint=None) -> (sum_e W[e] X_e, ok),
    X_e = solve_shifted(Z[e], B Q) node after node (the real part, cast to
    Q's dtype, where ``real``). A factory solver (with ``with_guess``)
    takes the Ritz warm starts X0 = Q diag(1/(z - lam)) and the inner
    tolerance hints under config.warm_start / adaptive_inner_tol."""
    solve_info = getattr(solve_shifted, "with_info",
                         lambda z, RHS: (solve_shifted(z, RHS), True))
    solve_guess = getattr(solve_shifted, "with_guess", None)
    rich = solve_guess is not None and (
        bool(config.warm_start) or bool(config.adaptive_inner_tol))
    warm = rich and bool(config.warm_start)
    adapt = rich and bool(config.adaptive_inner_tol)
    nodes = [(complex(z), complex(w)) for z, w in zip(Z, W)]

    def filter_apply(Q, lam=None, tol_hint=None):
        rhs = apply_B(Q).to(cdtype)
        acc, ok = None, True
        for z, w in nodes:
            if not rich:
                X, ok_z = solve_info(z, rhs)
            else:
                X0 = None
                if lam is not None and warm:
                    X0 = Q.to(cdtype) * (1.0 / (z - lam.to(cdtype)))[None, :]
                X, ok_z = solve_guess(z, rhs, X0, tol_hint if adapt else None)
            acc = w * X if acc is None else acc.add_(X, alpha=w)
            ok = ok & ok_z
        return (acc.real.to(Q.dtype) if real else acc), ok

    filter_apply.takes_ritz = warm
    filter_apply.takes_tol = adapt
    return filter_apply


def feast_matvec(A_op, B_op, interval, M0, fpm=None, *, solver="gmres",
                 solver_tol=None, solver_maxiter=500, solver_restart=30,
                 solve_shifted=None, hermitian=None, Q0=None, bounds=None,
                 device=None) -> FeastResult:
    """Matrix-free symmetric / Hermitian FEAST on [Emin, Emax].

    ``A_op`` / ``B_op`` are ``LinearOperator``s (or matrices, wrapped by
    ``LinearOperator.from_matrix``; B_op None is the standard problem).
    ``solver``: "gmres" or "bicgstab" (the contour engine on
    ``create_iterative_solver``, tolerance ``solver_tol``, default 0.1 tol
    floored at 10 eps), or the solve-free polynomial filters "cheb" (the
    Jackson indicator) and "contour_poly" (the rational contour filter as
    a Chebyshev series) for standard problems, on the enclosure
    ``bounds=(lo, hi)`` (it must enclose the spectrum) or the one
    ``operator_spectrum_bounds`` estimates. ``solve_shifted(z, RHS) -> X``
    replaces the iterative solver. ``hermitian`` (default: the operator's
    flag, or a complex dtype) runs the complex work type on the mirrored
    nodes. ``device=None`` means CUDA: the subspace lives there."""
    fpm = _ensure_fpm(fpm)
    device = resolve_device(device)
    A_op = _as_op(A_op, device)
    standard = B_op is None
    if not standard:
        B_op = _as_op(B_op, device)
    N = A_op.shape[0]
    Emin, Emax = float(interval[0]), float(interval[1])
    if not Emax > Emin:
        raise ValueError(f"Emin={Emin} must be < Emax={Emax}")
    M0 = int(M0)
    if hermitian is None:
        hermitian = A_op.hermitian or A_op.dtype.is_complex
    f64 = _is_double(A_op.dtype)
    rdtype = np.float64 if f64 else np.float32
    cdtype = np.complex128 if f64 else np.complex64
    work = np.dtype(cdtype if hermitian else rdtype)
    config = FeastConfig.from_fpm(fpm, dtype=cdtype)
    if solver_tol is None:
        solver_tol = max(config.tol * 0.1, 10 * float(np.finfo(rdtype).eps))
    contour = feast_get_custom_contour(fpm) or feast_contour(Emin, Emax, fpm)

    def apply_B(X):
        return X if standard else B_op(X)

    if solver in _POLY_SOLVERS:
        if not standard:
            raise ValueError(
                "matrix-free polynomial filters require a standard "
                "problem (B=None); generalized operators need the "
                "contour solvers (gmres/bicgstab)")
        if solve_shifted is not None:
            raise ValueError("solve_shifted and a polynomial solver are "
                             "mutually exclusive")
        from ..ops.chebfilter import (build_cheb_filter_coeffs,
                                      make_cheb_filter,
                                      rational_filter_cheb_coeffs)
        lo, hi = (float(bounds[0]), float(bounds[1])) if bounds is not None \
            else operator_spectrum_bounds(A_op, N, work, device=device)
        if solver in ("contour_poly", ":contour_poly"):
            coeffs, cinfo = rational_filter_cheb_coeffs(
                contour.Zne, contour.Wne, lo, hi, Emin, Emax)
        else:
            coeffs, cinfo = build_cheb_filter_coeffs(lo, hi, Emin, Emax)
        if cinfo["outside_at_1w"] > 0.25 * cinfo.get("inside_min", 1.0):
            raise ValueError(
                f"the polynomial filter cannot resolve this interval on "
                f"the enclosure [{lo:.3g}, {hi:.3g}] (outside level "
                f"{cinfo['outside_at_1w']:.2g} one width out) — pass a "
                f"tighter bounds=(lo, hi) or use an iterative solver")
        if config.print_level >= 1:
            kindname = ("contour-poly" if cinfo.get("kind") == "rational"
                        else "cheb")
            print(f"feast matvec {kindname} filter: "
                  f"degree={cinfo['degree']} enclosure=[{lo:.3g},{hi:.3g}] "
                  f"outside@1w={cinfo['outside_at_1w']:.2e}", flush=True)
        filter_apply = make_cheb_filter(A_op, lo, hi, np.asarray(
            coeffs, np.float32 if work in (np.float32, np.complex64)
            else np.float64))
    else:
        if solve_shifted is None:
            solve_shifted = create_iterative_solver(
                A_op, None if standard else B_op, solver, tol=solver_tol,
                restart=solver_restart, maxiter=solver_maxiter,
                flag_tol=config.tol)
        Zne = np.asarray(contour.Zne, cdtype)
        Wne = np.asarray(contour.Wne, cdtype)
        if hermitian:       # the mirrored nodes
            Zall = np.concatenate([Zne, np.conj(Zne)])
            Wall = np.concatenate([Wne, np.conj(Wne)])
        else:               # the half contour, the real part doubled
            Zall, Wall = Zne, 2.0 * Wne
        filter_apply = _contour_filter(
            solve_shifted, apply_B, Zall, Wall, config,
            _torch_dtype(cdtype), real=not hermitian)
    if config.mode == 2:
        return _stochastic_estimate_result(filter_apply, N, fpm, work,
                                           device)
    q0 = initial_subspace(fpm, Q0, N, M0, work)
    state = feast_hermitian_core(
        A_op, apply_B, filter_apply, torch.as_tensor(q0).to(device),
        float(rdtype(Emin)), float(rdtype(Emax)), tol=config.tol,
        max_loops=config.max_loops,
        convergence_criterion=config.convergence_criterion,
        subspace_only=(config.mode == 1))
    return hermitian_result(state)


def polynomial_companion_operators(coeff_ops, device=None):
    """(A_op, B_op) of the first-companion linearization of the polynomial
    pencil P(lam) = sum_k lam^k A_k, [A_0, ..., A_d] given as operators:

        A = [[0,    I,    ...      ],        B = diag(I, ..., I, A_d)
             [ ...             I   ],
             [-A_0, -A_1, ..., -A_{d-1}]]

    on blocks of d N rows, so A y = lam B y with y = (x, lam x, ...,
    lam^{d-1} x) solves P(lam) x = 0; the companion matrices are never
    formed, and a product costs d coefficient applications. A coefficient
    given as an array is applied on ``device`` (None: CUDA)."""
    ops = [_as_op(c, device) for c in coeff_ops]
    d = len(ops) - 1
    if d < 1:
        raise ValueError("polynomial needs at least degree 1 (two coefficients)")
    N = ops[0].shape[0]

    def A_mv(Y):
        blocks = [Y[k * N:(k + 1) * N] for k in range(d)]
        last = -ops[0](blocks[0])
        for k in range(1, d):
            last = last - ops[k](blocks[k])
        return torch.cat(blocks[1:] + [last], dim=0)

    def B_mv(Y):
        blocks = [Y[k * N:(k + 1) * N] for k in range(d)]
        return torch.cat(blocks[:-1] + [ops[d](blocks[-1])], dim=0)

    return (LinearOperator(A_mv, (d * N, d * N), ops[0].dtype),
            LinearOperator(B_mv, (d * N, d * N), ops[0].dtype))


def feast_polynomial_matvec(coeff_ops, Emid, r, M0, fpm=None, **kw
                            ) -> FeastGeneralResult:
    """Matrix-free polynomial FEAST: the companion linearization by
    operators, solved by the matrix-free general driver (``kw`` goes to
    it); the eigenvectors are the first N rows of the companion vectors,
    renormalized."""
    A_op, B_op = polynomial_companion_operators(coeff_ops,
                                                kw.get("device"))
    N = A_op.shape[0] // (len(coeff_ops) - 1)
    res = feast_matvec_general(A_op, B_op, Emid, r, M0, fpm, **kw)
    q = res.q[:N]
    nrm = torch.linalg.vector_norm(q, dim=0)
    return dataclasses.replace(
        res, q=q / torch.where(nrm > 0, nrm, 1.0)[None, :])


def feast_matvec_general(A_op, B_op, Emid, r, M0, fpm=None, *,
                         solver="gmres", solver_tol=None, solver_maxiter=500,
                         solver_restart=30, solve_shifted=None,
                         bilinear=False, eig_method=None, Q0=None,
                         device=None) -> FeastGeneralResult:
    """Matrix-free general FEAST inside the ellipse (Emid, r, fpm[18],
    fpm[19]): the full contour, each node's shifted system solved by the
    factory's GMRES / BiCGStab or by ``solve_shifted``, the general core
    of ``kernel/general.py`` (``bilinear``: the transpose pairing of a
    complex-symmetric operator). ``eig_method`` ("callback" or "qr",
    both host LAPACK ``geev``) is checked here. ``device=None`` means
    CUDA."""
    fpm = _ensure_fpm(fpm)
    check_method(eig_method)
    device = resolve_device(device)
    A_op = _as_op(A_op, device)
    standard = B_op is None
    if not standard:
        B_op = _as_op(B_op, device)
    N = A_op.shape[0]
    f64 = _is_double(A_op.dtype)
    rdtype = np.float64 if f64 else np.float32
    cdtype = np.complex128 if f64 else np.complex64
    config = FeastConfig.from_fpm(fpm, dtype=cdtype)
    if solver_tol is None:
        solver_tol = max(config.tol * 0.1, 10 * float(np.finfo(rdtype).eps))
    contour = feast_get_custom_contour(fpm) or feast_gcontour(
        complex(Emid), float(r), fpm)
    if solve_shifted is None:
        solve_shifted = create_iterative_solver(
            A_op, None if standard else B_op, solver, tol=solver_tol,
            restart=solver_restart, maxiter=solver_maxiter,
            flag_tol=config.tol)

    def apply_B(X):
        return X if standard else B_op(X)

    q0 = initial_subspace(fpm, Q0, N, M0, cdtype, general=True)
    filter_apply = _contour_filter(
        solve_shifted, apply_B, np.asarray(contour.Zne, cdtype),
        np.asarray(contour.Wne, cdtype), config, _torch_dtype(cdtype))
    state = feast_general_core(
        A_op, apply_B, filter_apply, torch.as_tensor(q0).to(device),
        complex(cdtype(complex(Emid))), float(rdtype(r)), tol=config.tol,
        max_loops=config.max_loops, aspect_ratio=config.aspect_ratio,
        rotation_deg=config.rotation_deg,
        convergence_criterion=config.convergence_criterion,
        subspace_only=(config.mode == 1), bilinear=bilinear)
    return general_result(state)
