"""Dense FEAST drivers: symmetric / Hermitian, standard and generalized
(PyTorch).

Counterpart of ``feastkit_tpu/solvers/dense.py``. The ne shifted pencils
z_e B - A are factored as one batched partial-pivot LU on an (ne, N, N)
tensor in native complex64 or complex128 (``torch.linalg.lu_factor``:
cuSOLVER on the card, LAPACK on the CPU), once per solve (fpm[10] = 1), or
node by node on every filter application (fpm[10] = 0, the low-memory
mode). Each refinement loop then runs batched multi-RHS triangular solves
and one contraction over the nodes:

* real symmetric: a real basis, Q_proj = Re(sum_e 2 W_e X_e), where
  X_e = (z_e B - A)^-1 B Q;
* complex Hermitian: Q_proj = sum_e (W_e X_e + conj(W_e) X'_e), where
  X'_e = (conj(z_e) B - A)^-1 B Q = (z_e B - A)^-H B Q, the adjoint solve
  on the same factors.

``kernel/hermitian.feast_hermitian_core`` refines around that filter. The
JAX package's TPU mechanisms are not ported: its blocked LU
(``ops/blocklu.py``), the f64 pair mode and the real embedding of
complex-Hermitian operands (``ops/splitlu.py``), the iterative-refinement
sweeps that repair the TPU's bf16-level LU, and the host-driven trio of
programs for remote attachments. No refinement sweep runs here: cuSOLVER's
and LAPACK's LU are genuine f32 / f64.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.aux import feast_get_custom_contour
from ..core.backend import resolve_device
from ..core.contour import feast_contour
from ..core.parameters import FeastConfig, _ensure_fpm
from ..core.tools import initial_subspace, lu_factor
from ..core.types import FeastError, FeastResult, _trim
from ..kernel.hermitian import feast_hermitian_core

__all__ = ["feast_sygv", "feast_syev", "feast_hegv", "feast_heev",
           "dense_hermitian_feast"]

_TORCH_DTYPE = {np.dtype(np.float32): torch.float32,
                np.dtype(np.float64): torch.float64,
                np.dtype(np.complex64): torch.complex64,
                np.dtype(np.complex128): torch.complex128}


def _np_dtype(X) -> np.dtype:
    if isinstance(X, torch.Tensor):
        return np.dtype(str(X.dtype).replace("torch.", ""))
    return np.asarray(X).dtype


def _operand(X, dtype: np.dtype, device) -> torch.Tensor:
    """A numpy array or tensor as a tensor of ``dtype`` on ``device`` (the
    real part where a complex operand meets a real work type)."""
    t = X if isinstance(X, torch.Tensor) else torch.as_tensor(np.asarray(X))
    if t.is_complex() and dtype.kind != "c":
        t = t.real
    return t.to(device=device, dtype=_TORCH_DTYPE[dtype])


def _shifted_pencils(A, B, Zne, standard: bool):
    """(ne, N, N) stack of z_e B - A in the complex dtype of Zne."""
    N = A.shape[0]
    Ac = A.to(Zne.dtype)
    Bc = (torch.eye(N, dtype=Zne.dtype, device=A.device) if standard
          else B.to(Zne.dtype))
    return Zne[:, None, None] * Bc[None] - Ac[None]


def _factor(shifted):
    """LU factors of every node's shifted pencil (one batched call)."""
    return lu_factor(shifted)


def _solve(lu, piv, rhs, adjoint: bool):
    """(ne, N, M) solutions with the factors of every node, the same rhs
    (N, M) for all; adjoint: with (z_e B - A)^H."""
    return torch.linalg.lu_solve(lu, piv, rhs, adjoint=adjoint)


def _make_solve_all(A, B, Zne, standard, store_factorization):
    """rhs (N, M0) complex -> X (ne, N, M0) complex, and the adjoint
    variant. store_factorization (fpm[10] = 1) factors every node once;
    otherwise each application factors node by node."""
    shifted = _shifted_pencils(A, B, Zne, standard)
    if store_factorization:
        lu, piv = _factor(shifted)
        del shifted
        return (lambda rhs: _solve(lu, piv, rhs, False),
                lambda rhs: _solve(lu, piv, rhs, True))

    def per_node(rhs, adjoint):
        out = []
        for m in shifted:
            lu, piv = _factor(m)
            out.append(_solve(lu, piv, rhs, adjoint))
        return torch.stack(out)

    return (lambda rhs: per_node(rhs, False),
            lambda rhs: per_node(rhs, True))


def _make_ops(A, B, Zne, Wne, *, standard, hermitian, store_factorization):
    """(apply_A, apply_B, filter_apply) for the given operands."""
    solve_all, solve_all_adj = _make_solve_all(A, B, Zne, standard,
                                               store_factorization)
    apply_A = lambda X: A @ X                                   # noqa: E731
    apply_B = (lambda X: X) if standard else (lambda X: B @ X)  # noqa: E731

    if hermitian:
        Wc = Wne.conj()

        def filter_apply(Q):
            rhs = apply_B(Q).to(Zne.dtype)
            return (torch.einsum("e,enm->nm", Wne, solve_all(rhs))
                    + torch.einsum("e,enm->nm", Wc, solve_all_adj(rhs)))
    else:
        W2 = 2.0 * Wne

        def filter_apply(Q):
            rhs = apply_B(Q).to(Zne.dtype)
            return torch.einsum("e,enm->nm", W2,
                                solve_all(rhs)).real.to(Q.dtype)

    return apply_A, apply_B, filter_apply


def dense_hermitian_feast(A, B, Emin, Emax, M0, fpm=None, *, contour=None,
                          Q0=None, hermitian=None, device=None
                          ) -> FeastResult:
    """Dense symmetric / Hermitian interval driver. ``A`` and ``B`` are
    numpy arrays or tensors (B None for the standard problem).
    ``hermitian=False`` runs the all-real iteration (only the shifted
    solves are complex); None decides from the operands' dtypes.
    ``contour``: the quadrature (default: the fpm[29] registry, else the
    fpm contour of [Emin, Emax]). ``device=None`` means CUDA."""
    device = resolve_device(device)
    fpm = _ensure_fpm(fpm)
    standard = B is None
    shA = tuple(A.shape)
    N = shA[0]
    if len(shA) != 2 or shA[1] != N:
        raise ValueError(f"A must be square, got {shA}")
    if not standard and tuple(B.shape) != shA:
        raise ValueError(f"B must match A: {shA} vs {tuple(B.shape)}")
    if N <= 0:
        return FeastResult(np.zeros(0), torch.zeros((0, 0)), 0, np.zeros(0),
                           FeastError.ERROR_N, 0.0, 0)
    if not 0 < M0 <= N:
        raise ValueError(f"M0 must be in 1..N={N}, got {M0}")
    if not Emax > Emin:
        raise ValueError(f"Emin={Emin} must be < Emax={Emax}")

    dt_in = np.result_type(*[_np_dtype(X) for X in (A, B) if X is not None])
    single = dt_in in (np.dtype(np.float32), np.dtype(np.complex64))
    rdtype = np.dtype(np.float32 if single else np.float64)
    cdtype = np.dtype(np.complex64 if single else np.complex128)
    if hermitian is None:
        hermitian = dt_in.kind == "c"
    work = cdtype if hermitian else rdtype
    A = _operand(A, work, device)
    B = None if standard else _operand(B, work, device)

    config = FeastConfig.from_fpm(fpm, dtype=cdtype)
    if contour is None:
        contour = feast_get_custom_contour(fpm)
    if contour is None:
        contour = feast_contour(Emin, Emax, fpm)
    Zne = torch.as_tensor(np.asarray(contour.Zne, cdtype)).to(device)
    Wne = torch.as_tensor(np.asarray(contour.Wne, cdtype)).to(device)
    apply_A, apply_B, filter_apply = _make_ops(
        A, B, Zne, Wne, standard=standard,
        hermitian=bool(hermitian),
        store_factorization=config.store_factorization)

    if config.mode == 2:
        from .sparse import _stochastic_estimate_result
        return _stochastic_estimate_result(filter_apply, N, fpm, work,
                                           device)

    Q0 = torch.as_tensor(initial_subspace(fpm, Q0, N, M0, work)).to(device)
    state = feast_hermitian_core(
        apply_A, apply_B, filter_apply, Q0, float(Emin), float(Emax),
        tol=config.tol, max_loops=config.max_loops,
        convergence_criterion=config.convergence_criterion,
        subspace_only=(config.mode == 1))
    info = FeastError.SUCCESS if bool(state.converged) \
        else FeastError.NO_CONVERGENCE
    return _trim(FeastResult, state.lam.cpu().numpy(), state.Q,
                 state.res.cpu().numpy(), state.inside.cpu().numpy(),
                 int(info), float(state.epsout), int(state.loop) - 1)


def feast_sygv(A, B, Emin, Emax, M0, fpm=None, **kw) -> FeastResult:
    """Dense real-symmetric generalized problem (feast_sygv!)."""
    return dense_hermitian_feast(A, B, Emin, Emax, M0, fpm,
                                 hermitian=False, **kw)


def feast_syev(A, Emin, Emax, M0, fpm=None, **kw) -> FeastResult:
    """Dense real-symmetric standard problem (feast_syev!)."""
    return dense_hermitian_feast(A, None, Emin, Emax, M0, fpm,
                                 hermitian=False, **kw)


def feast_hegv(A, B, Emin, Emax, M0, fpm=None, **kw) -> FeastResult:
    """Dense complex-Hermitian generalized problem (feast_hegv!); the
    eigenvectors stay complex."""
    return dense_hermitian_feast(A, B, Emin, Emax, M0, fpm,
                                 hermitian=True, **kw)


def feast_heev(A, Emin, Emax, M0, fpm=None, **kw) -> FeastResult:
    """Dense complex-Hermitian standard problem (feast_heev!)."""
    return dense_hermitian_feast(A, None, Emin, Emax, M0, fpm,
                                 hermitian=True, **kw)
