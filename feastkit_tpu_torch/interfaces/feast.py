"""High-level API of the PyTorch port: ``feast``, ``feast_general``,
``feast_banded``, ``feast_custom_contour``, ``feast_polynomial``,
``feast_validate_interval``, ``feast_summary``, the conveniences
``eigvals_feast`` / ``eigen_feast`` and the keyword veneer over fpm
``feast_set_defaults``.

Counterpart of ``feastkit_tpu/interfaces/feast.py``. ``feast(A, B,
(Emin, Emax), M0, fpm)`` routes by storage type: scipy.sparse operands to
the sparse interval driver, dense ones (numpy arrays or tensors) to the
dense driver after the symmetric / Hermitian checks and the Gershgorin
check of the interval. ``feast_general(A, B, Emid, r, M0, fpm)`` routes
general and complex-symmetric problems the same way: sparse operands to
the sparse general driver, dense ones to the dense general driver (the
transpose pairing where A is complex symmetric and not Hermitian).
A ``LinearOperator`` goes to the matrix-free drivers of
``solvers/matfree.py`` (``feast_matvec``, ``feast_matvec_general``), and
``feast_polynomial`` takes operator coefficients (or
``method="matfree"``) to the companion linearization by operators, as
in the JAX package; a bare callable is refused as there. Backend
selection (``backend=``, ``parallel=``, ``strict_backend=``) is the JAX
package's, over the ranks of the default ``torch.distributed`` process
group: a request that resolves to sharded goes to the drivers of
``parallel/pfeast.py`` (every rank calling), as the JAX package's
``feast`` and ``feast_general`` route it, and a matrix-free operand runs
serially instead, as in the JAX package. Everything runs on ``device``
(``None`` means CUDA).
"""
from __future__ import annotations

import sys
import warnings

import numpy as np
import scipy.sparse as sp
import torch

from ..core.aux import with_custom_contour
from ..core.backend import resolve_device, select_parallel_backend
from ..core.parameters import FeastParameters, _ensure_fpm, feastinit
from ..core.types import Contour, FeastGeneralResult, FeastResult
from ..utils import trace

__all__ = ["feast", "feast_general", "feast_banded", "feast_custom_contour",
           "feast_polynomial", "feast_summary", "feast_validate_interval",
           "eigvals_feast", "eigen_feast", "feast_set_defaults"]

_VALID_BACKENDS = ("auto", "serial", "sharded", "threads", "distributed",
                   "mpi")


def _normalize_backend(backend, parallel):
    """Reconcile ``backend=`` with the legacy ``parallel=`` flag: both set
    and conflicting -> error; legacy names fold into sharded."""
    if parallel is not None:
        legacy = "sharded" if parallel else "serial"
        if backend is not None and str(backend) != legacy:
            raise ValueError(
                f"Conflicting parallel={parallel} and backend={backend!r}; "
                "use backend= only")
        backend = legacy
    if backend is None:
        backend = "auto"
    backend = str(backend).lstrip(":")
    if backend not in _VALID_BACKENDS:
        raise ValueError(f"Unknown backend {backend!r}; valid: "
                         f"{_VALID_BACKENDS}")
    if backend in ("threads", "distributed", "mpi"):
        backend = "sharded"
    return backend


def _resolve_backend(backend, parallel, strict_backend, device, *,
                     auto_sharded):
    """"serial" or "sharded". auto_sharded: whether "auto" may pick the
    sharded mesh for this operand class (sparse yes, dense only on
    request, as in the JAX package)."""
    return select_parallel_backend(
        _normalize_backend(backend, parallel), device,
        allow_fallback=not strict_backend, auto_sharded=auto_sharded)


def _resolve_matfree_backend(backend, parallel, strict_backend, device,
                             refusal):
    """The backend of a matrix-free operand: a sharded request warns and
    runs serially, or raises RuntimeError(refusal) under strict_backend
    (the JAX package's texts)."""
    backend = select_parallel_backend(
        _normalize_backend(backend, parallel), device,
        allow_fallback=not strict_backend, auto_sharded=False)
    if backend == "sharded":
        if strict_backend:
            raise RuntimeError(refusal)
        warnings.warn("backend='sharded' unavailable for matrix-free "
                      "operators; falling back to serial", stacklevel=3)


def _dense_shape(A):
    """The shape of a dense operand, as the JAX package reads it (numpy's
    view of anything that is not a tensor: a bare callable has shape ())."""
    return A.shape if isinstance(A, torch.Tensor) else np.asarray(A).shape


def _as_tensor(A) -> torch.Tensor:
    """A numpy array or tensor as a floating (or complex) tensor."""
    t = A if isinstance(A, torch.Tensor) else torch.as_tensor(np.asarray(A))
    return t if t.is_floating_point() or t.is_complex() else t.double()


def feast_validate_interval(A, Emin, Emax, *, warn=True):
    """Gershgorin-disc sanity check of the search interval: (lo, hi)
    Gershgorin bounds, with a warning when [Emin, Emax] misses them."""
    A = _as_tensor(A)
    diag = torch.diagonal(A)
    d = diag.real
    radii = A.abs().sum(dim=1) - diag.abs()
    lo, hi = float((d - radii).min()), float((d + radii).max())
    if warn and (Emax < lo or Emin > hi):
        warnings.warn(
            f"Search interval [{Emin}, {Emax}] lies outside the Gershgorin "
            f"bounds [{lo:.4g}, {hi:.4g}]; no eigenvalues can be found there.",
            stacklevel=3)
    return lo, hi


def _is_hermitian(A, tol=0.0):
    A = _as_tensor(A)
    return bool(torch.allclose(A, A.mT.conj(), atol=tol,
                               rtol=10 * tol if tol else 1e-12))


def feast(A, B=None, interval=None, M0=None, fpm=None, *, backend=None,
          parallel=None, strict_backend=False, contour=None, Q0=None,
          device=None, **kw) -> FeastResult:
    """All eigenpairs of A x = lam B x with lam in [Emin, Emax].

    Args:
      A, B: scipy.sparse matrices, real symmetric or complex Hermitian
        (the sparse driver: B None, a positive diagonal, or a sparse
        symmetric positive-definite matrix; the Krylov contour engine
        through ``solver="gmres"`` / ``"bicgstab"``)
        or dense numpy arrays / tensors (the dense driver: real symmetric
        or complex Hermitian, B symmetric / Hermitian positive definite).
        B=None is the standard problem.
        A ``LinearOperator`` (B None, an operator or a matrix) runs the
        matrix-free driver ``feast_matvec``.
      interval: (Emin, Emax).
      M0: subspace size (default max(8, N // 10), capped at N).
      fpm: the 64-slot FEAST parameters (None: defaults).
      backend, parallel, strict_backend: backend selection as in the JAX
        package: "auto" (sharded for sparse operands on two or more
        ranks), "serial", "sharded"; ``parallel=True`` is "sharded". A
        sharded request on one rank warns and runs serially, or raises
        RuntimeError with ``strict_backend=True``; on two or more ranks it
        runs ``parallel/pfeast.pfeast_sparse`` / ``pfeast_dense`` (the
        contour mesh over every rank; ``kw`` may give ``mesh=``).
      contour: an explicit quadrature for the dense driver (taken and not
        passed on for sparse operands, as in the JAX package).
      device: torch device; None means "cuda" (raises without CUDA).
      kw: passed to the driver (sparse: ``solver=`` "cheb",
        "contour_poly", "gmres" or "bicgstab"; ``hermitian=``; for the
        Krylov engine ``solver_tol=``, ``solver_maxiter=``,
        ``solver_restart=``, ``precond=`` and ``grid=``).
    """
    with trace.span("feast", path="other"):
        if interval is None:
            raise ValueError("interval=(Emin, Emax) is required")
        Emin, Emax = float(interval[0]), float(interval[1])
        if not Emax > Emin:
            raise ValueError(f"Emin={Emin} must be < Emax={Emax}")
        device = resolve_device(device)
        from ..solvers.matfree import LinearOperator, feast_matvec
        if isinstance(A, LinearOperator):
            _resolve_matfree_backend(
                backend, parallel, strict_backend, device,
                "backend='sharded' is not yet available for matrix-free "
                "operators (the model-axis sharded matvec path); use the "
                "serial driver or shard inside your operator callables")
            N = A.shape[0]
            M0r = min(int(M0 or max(8, N // 10)), N)
            trace.solve_attrs(N=int(N), M0=M0r)
            return feast_matvec(A, B, (Emin, Emax), M0r, fpm, Q0=Q0,
                                device=device, **kw)
        if sp.issparse(A):
            backend = _resolve_backend(backend, parallel, strict_backend,
                                       device, auto_sharded=True)
            N = A.shape[0]
            M0r = min(int(M0 or max(8, N // 10)), N)
            trace.solve_attrs(N=int(N), M0=M0r)
            if backend == "sharded":
                from ..parallel.pfeast import pfeast_sparse
                return pfeast_sparse(A, B, Emin, Emax, M0r, fpm, Q0=Q0,
                                     device=device, **kw)
            from ..solvers.sparse import sparse_feast_interval
            return sparse_feast_interval(A, B, Emin, Emax, M0r, fpm, Q0=Q0,
                                         device=device, **kw)

        N = _dense_shape(A)[0]
        if M0 is None:
            M0 = min(N, max(8, N // 10))
        M0 = min(int(M0), N)
        trace.solve_attrs(N=int(N), M0=M0)
        if not _is_hermitian(A, tol=1e-10):
            raise ValueError(
                "feast() requires symmetric/Hermitian A; use feast_general() "
                "for non-Hermitian problems")
        if B is not None and not _is_hermitian(B, tol=1e-10):
            raise ValueError("feast() requires symmetric/Hermitian positive "
                             "definite B; use feast_general() otherwise")
        feast_validate_interval(A, Emin, Emax)
        fpm = _ensure_fpm(fpm)
        backend = _resolve_backend(backend, parallel, strict_backend, device,
                                   auto_sharded=False)
        hermitian = _as_tensor(A).is_complex() or (
            B is not None and _as_tensor(B).is_complex())
        if backend == "sharded":
            from ..parallel.pfeast import pfeast_dense
            return pfeast_dense(A, B, Emin, Emax, M0, fpm, hermitian=hermitian,
                                contour=contour, Q0=Q0, device=device, **kw)
        from ..solvers.dense import dense_hermitian_feast
        return dense_hermitian_feast(A, B, Emin, Emax, M0, fpm,
                                     hermitian=hermitian, contour=contour,
                                     Q0=Q0, device=device, **kw)


def _complex_symmetric(A) -> bool:
    """A complex, A == A^T and A != A^H (numpy's allclose tolerances)."""
    if isinstance(A, torch.Tensor):
        return bool(A.is_complex() and torch.allclose(A, A.mT)
                    and not torch.allclose(A, A.mH))
    A = np.asarray(A)
    return bool(np.iscomplexobj(A) and np.allclose(A, A.T)
                and not np.allclose(A, A.conj().T))


def feast_general(A, B=None, Emid=0.0, r=1.0, M0=None, fpm=None, *,
                  backend=None, parallel=None, strict_backend=False,
                  complex_symmetric=None, device=None, **kw
                  ) -> FeastGeneralResult:
    """All eigenpairs of a general A x = lam B x inside the rotated
    ellipse (Emid, r, fpm[18], fpm[19]).

    Sparse operands (scipy.sparse) go to the sparse general driver
    (``solvers/sparse.sparse_feast_general``: the narrow-band hand-off to
    BCR, else the Krylov contour engine on the DIA kernels), dense ones
    (numpy arrays or tensors) to the dense general driver; a dense complex
    A that is symmetric and not Hermitian takes the transpose pairing
    unless ``complex_symmetric`` says otherwise (for sparse operands it is
    False unless given). Backend selection as in ``feast``: "auto" is
    sharded for sparse operands on two or more ranks, and a request that
    resolves so runs ``parallel/pfeast.pfeast_sparse_general`` /
    ``pfeast_general`` (every rank calling). A
    ``LinearOperator`` runs the matrix-free driver
    ``feast_matvec_general`` (serially, as in the JAX package).
    ``device=None`` means CUDA; ``kw`` goes to the driver."""
    fpm = _ensure_fpm(fpm)
    device = resolve_device(device)
    if sp.issparse(A):
        backend = _resolve_backend(backend, parallel, strict_backend,
                                   device, auto_sharded=True)
        N = A.shape[0]
        M0r = min(int(M0 or max(8, N // 10)), N)
        if backend == "sharded":
            from ..parallel.pfeast import pfeast_sparse_general
            return pfeast_sparse_general(A, B, Emid, r, M0r, fpm,
                                         bilinear=bool(complex_symmetric),
                                         device=device, **kw)
        from ..solvers.sparse import sparse_feast_general
        return sparse_feast_general(A, B, Emid, r, M0r, fpm,
                                    bilinear=bool(complex_symmetric),
                                    device=device, **kw)
    from ..solvers.matfree import LinearOperator, feast_matvec_general
    if isinstance(A, LinearOperator):
        _resolve_matfree_backend(
            backend, parallel, strict_backend, device,
            "backend='sharded' is not yet available for matrix-free "
            "operators; use the serial driver")
        N = A.shape[0]
        return feast_matvec_general(
            A, B, Emid, r, min(int(M0 or max(8, N // 10)), N), fpm,
            bilinear=bool(complex_symmetric or False), device=device, **kw)
    N = _dense_shape(A)[0]
    if M0 is None:
        M0 = min(N, max(8, N // 10))
    M0 = min(int(M0), N)
    backend = _resolve_backend(backend, parallel, strict_backend, device,
                               auto_sharded=False)
    if complex_symmetric is None:
        complex_symmetric = _complex_symmetric(A)
    if backend == "sharded":
        from ..parallel.pfeast import pfeast_general
        return pfeast_general(A, B, Emid, r, M0, fpm,
                              bilinear=bool(complex_symmetric),
                              device=device, **kw)
    from ..solvers.dense_general import dense_general_feast
    return dense_general_feast(A, B, Emid, r, M0, fpm,
                               bilinear=bool(complex_symmetric),
                               device=device, **kw)


def feast_custom_contour(A, B, Zne, Wne, M0, fpm=None, *, general=None,
                         Emid=None, r=None, interval=None, **kw):
    """Solve with an explicit user contour: (Zne, Wne) registered in the
    fpm[29] registry for the call, routed to ``feast`` (pass
    ``interval=(Emin, Emax)``) or ``feast_general`` (``Emid`` and ``r``
    serve only the inside test; by default the centre of the nodes and
    their largest distance from it)."""
    contour = Contour(np.asarray(Zne, complex), np.asarray(Wne, complex))
    fpm = _ensure_fpm(fpm)
    if general is None:
        general = interval is None
    with with_custom_contour(fpm, contour):
        if general:
            if Emid is None or r is None:
                Emid = complex(contour.Zne.mean())
                r = float(np.abs(contour.Zne - Emid).max())
            return feast_general(A, B, Emid, r, M0, fpm, **kw)
        return feast(A, B, interval, M0, fpm, **kw)


def feast_polynomial(coeffs, Emid, r, M0, fpm=None, *, method="companion",
                     **kw) -> FeastGeneralResult:
    """Polynomial eigenproblem sum_k lam^k A_k x = 0 inside the ellipse
    (Emid, r). ``method``: "companion" (the first-companion linearization
    to a d N pencil on the dense general driver, machine precision) or
    "direct" (the Beyn moment scheme on the N-dimensional polynomial
    resolvent: d times less memory, accuracy limited by the quadrature)
    or "matfree" (the companion linearization by operators on the
    matrix-free general driver), which a coefficient given as an operator
    (a ``LinearOperator``, or anything with a callable ``matvec``) also
    selects."""
    from ..solvers import dense_general as _dg
    from ..solvers import matfree as _mf
    if method == "matfree" or any(
            isinstance(c, _mf.LinearOperator)
            or callable(getattr(c, "matvec", None)) for c in coeffs):
        return _mf.feast_polynomial_matvec(coeffs, Emid, r, M0, fpm, **kw)
    if method == "direct":
        return _dg.feast_pep_direct(coeffs, Emid, r, M0, fpm, **kw)
    return _dg.feast_pep(coeffs, Emid, r, M0, fpm, **kw)


def feast_banded(A_bands, kl, ku, interval, M0, fpm=None, *, B_bands=None,
                 klb=0, kub=0, **kw) -> FeastResult:
    """Banded symmetric / Hermitian FEAST on [Emin, Emax]: band storage
    (kl+ku+1, N) in, the sb* / hb* drivers of ``solvers/banded.py``
    (``device=`` among ``kw``; None means CUDA)."""
    from ..solvers import banded as _b
    Emin, Emax = float(interval[0]), float(interval[1])
    hermitian = _as_tensor(A_bands).is_complex() or (
        B_bands is not None and _as_tensor(B_bands).is_complex())
    if B_bands is None:
        if hermitian:
            return _b.feast_hbev(A_bands, kl, ku, Emin, Emax, M0, fpm, **kw)
        return _b.feast_sbev(A_bands, kl, ku, Emin, Emax, M0, fpm, **kw)
    if hermitian:
        return _b.feast_hbgv(A_bands, kl, ku, B_bands, klb, kub,
                             Emin, Emax, M0, fpm, **kw)
    return _b.feast_sbgv(A_bands, kl, ku, B_bands, klb, kub,
                         Emin, Emax, M0, fpm, **kw)


def eigvals_feast(A, interval, *, B=None, M0=None, **kw):
    """Eigenvalues-only convenience (feast_interfaces.jl:514-527): the
    host array ``feast(A, B, interval, M0, **kw).lam``."""
    return feast(A, B, interval, M0, **kw).lam


def eigen_feast(A, interval, *, B=None, M0=None, **kw):
    """(eigenvalues, eigenvectors) convenience (feast_interfaces.jl:529-540):
    the host array of eigenvalues and the (N, M) tensor on the solve's
    device."""
    r = feast(A, B, interval, M0, **kw)
    return r.lam, r.q


def feast_set_defaults(fpm=None, *, nodes=None, tol_exp=None, max_loops=None,
                       print_level=None, quadrature=None, aspect_ratio=None,
                       full_nodes=None) -> FeastParameters:
    """Keyword-named veneer over fpm slots (feast_set_defaults!,
    feast_interfaces.jl:484-512): nodes fpm[2], full_nodes fpm[8], tol_exp
    fpm[3], max_loops fpm[4], print_level fpm[1], quadrature fpm[16],
    aspect_ratio fpm[18] (in hundredths)."""
    fpm = feastinit() if fpm is None else FeastParameters(fpm)
    for slot, value in ((2, nodes), (8, full_nodes), (3, tol_exp),
                        (4, max_loops), (1, print_level), (16, quadrature)):
        if value is not None:
            fpm[slot] = value
    if aspect_ratio is not None:
        fpm[18] = int(round(aspect_ratio * 100))
    return fpm


def feast_summary(result, file=None):
    """Human-readable run summary (same text as the JAX package)."""
    file = file or sys.stdout
    kind = "general" if isinstance(result, FeastGeneralResult) \
        else "Hermitian"
    print(f"FEAST {kind} eigensolver summary", file=file)
    print(f"  eigenvalues found (M) : {result.M}", file=file)
    print(f"  refinement loops      : {result.loop}", file=file)
    print(f"  max relative residual : {result.epsout:.3e}", file=file)
    print(f"  status                : {result.info.name} ({int(result.info)})",
          file=file)
    if result.M:
        lam = np.asarray(result.lam)
        print(f"  lambda range          : [{lam.real.min():.6g}, "
              f"{lam.real.max():.6g}]", file=file)
    return result.info
