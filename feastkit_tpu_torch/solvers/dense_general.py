"""Dense general (non-Hermitian), complex-symmetric and polynomial drivers
(PyTorch).

Counterpart of ``feastkit_tpu/solvers/dense_general.py``: the shifted
pencils z_e B - A of the full contour are factored as one batched
partial-pivot LU (``solvers/dense._make_solve_all``: cuSOLVER on the card,
LAPACK on the CPU) in native complex64 or complex128, and each refinement
loop runs the batched solves and the
complex sum Q_proj = sum_e W_e (z_e B - A)^-1 B Q over every node (no
conjugate doubling); ``kernel/general.feast_general_core`` refines around
it. ``feast_pep`` solves a polynomial eigenproblem through the first
companion linearization on this driver; ``feast_pep_direct`` runs the Beyn
moment scheme on the N-dimensional polynomial resolvent.

The JAX package's TPU mechanisms are not ported: the demotion of
complex128 work where a TPU cannot compile it (``_gate_general_cdtype``),
the on-device QR eigensolver chosen for runtimes without host callbacks,
and the host-driven programs for remote attachments
(``_run_general_host_loop``): the port's core is a host loop already.
"""
from __future__ import annotations

import numpy as np
import scipy.linalg as sla
import torch

from ..core.backend import resolve_device
from ..core.parameters import FeastConfig, _ensure_fpm
from ..core.tools import initial_subspace, inside_first_order, lu_factor
from ..core.types import FeastError, FeastGeneralResult, _trim
from ..kernel.general import contour_tensors, feast_general_core, \
    general_result
from ..ops.eig import check_method, general_eig
from .dense import _make_solve_all, _np_dtype, _operand
from .sparse import _general_estimate, _stochastic_estimate_result

__all__ = ["feast_gegv", "feast_geev", "feast_gegv_complex_sym",
           "feast_geev_complex_sym", "feast_pep", "feast_pep_direct",
           "dense_general_feast"]


def _cdtype_of(*dtypes) -> np.dtype:
    """complex64 for single-precision inputs, else complex128."""
    dt = np.result_type(*dtypes)
    return np.dtype(np.complex64 if dt in (np.dtype(np.float32),
                                           np.dtype(np.complex64))
                    else np.complex128)


def _general_ops(A, B, Zne, Wne, *, standard, store_factorization):
    """(apply_A, apply_B, filter_apply): Q -> sum_e W_e (z_e B - A)^-1 B Q
    over every node (the solves of ``solvers/dense._make_solve_all``)."""
    solve_all, _ = _make_solve_all(A, B, Zne, standard, store_factorization)
    apply_A = lambda X: A @ X                                   # noqa: E731
    apply_B = (lambda X: X) if standard else (lambda X: B @ X)  # noqa: E731

    def filter_apply(Q):
        return torch.einsum("e,enm->nm", Wne, solve_all(apply_B(Q)))

    return apply_A, apply_B, filter_apply


def _check_general(N, M0, r):
    if not 0 < M0 <= N:
        raise ValueError(f"M0 must be in 1..N={N}, got {M0}")
    if not r > 0:
        raise ValueError(f"Contour radius must be positive, got {r}")


def dense_general_feast(A, B, Emid, r, M0, fpm=None, *, contour=None,
                        Q0=None, bilinear=False, eig_method=None,
                        device=None) -> FeastGeneralResult:
    """The dense general / complex-symmetric driver: every eigenpair of
    A x = lam B x inside the ellipse (Emid, r, fpm[18], fpm[19]). ``A`` and
    ``B`` are numpy arrays or tensors (B None for the standard problem);
    ``bilinear``: the transpose pairing of a complex-symmetric pencil.
    ``contour``: the quadrature (default: the fpm[29] registry, else the
    fpm full contour). ``eig_method`` ("callback" or "qr") is accepted for
    the JAX package's callers: both run host LAPACK ``geev``.
    ``device=None`` means CUDA."""
    check_method(eig_method)
    device = resolve_device(device)
    fpm = _ensure_fpm(fpm)
    standard = B is None
    shA = tuple(A.shape)
    N = shA[0]
    if len(shA) != 2 or shA[1] != N:
        raise ValueError(f"A must be square, got {shA}")
    if not standard and tuple(B.shape) != shA:
        raise ValueError(f"B must match A: {shA} vs {tuple(B.shape)}")
    _check_general(N, M0, r)
    cdtype = _cdtype_of(*[_np_dtype(X) for X in (A, B) if X is not None])
    A = _operand(A, cdtype, device)
    B = None if standard else _operand(B, cdtype, device)
    config = FeastConfig.from_fpm(fpm, dtype=cdtype)
    Zne, Wne = contour_tensors(fpm, Emid, r, cdtype, device, contour)
    apply_A, apply_B, filter_apply = _general_ops(
        A, B, Zne, Wne, standard=standard,
        store_factorization=config.store_factorization)
    if config.mode == 2:
        # trace(P) = M holds for the oblique projector too: real Rademacher
        # probes count the eigenvalues inside (fpm[14] = 2, fpm[32])
        return _general_estimate(_stochastic_estimate_result(
            filter_apply, N, fpm, cdtype, device))
    # general problems seed with a fully complex subspace
    Q0 = torch.as_tensor(initial_subspace(fpm, Q0, N, M0, cdtype,
                                          general=True)).to(device)
    state = feast_general_core(
        apply_A, apply_B, filter_apply, Q0, complex(Emid), float(r),
        tol=config.tol, max_loops=config.max_loops,
        aspect_ratio=config.aspect_ratio, rotation_deg=config.rotation_deg,
        convergence_criterion=config.convergence_criterion,
        subspace_only=(config.mode == 1), bilinear=bilinear)
    return general_result(state)


def feast_gegv(A, B, Emid, r, M0, fpm=None, **kw) -> FeastGeneralResult:
    """Dense general generalized problem A x = lam B x inside the ellipse
    (Emid, r) (feast_gegv!)."""
    return dense_general_feast(A, B, Emid, r, M0, fpm, **kw)


def feast_geev(A, Emid, r, M0, fpm=None, **kw) -> FeastGeneralResult:
    """Dense general standard problem (feast_geev!)."""
    return dense_general_feast(A, None, Emid, r, M0, fpm, **kw)


def feast_gegv_complex_sym(A, B, Emid, r, M0, fpm=None, **kw
                           ) -> FeastGeneralResult:
    """Dense complex-symmetric generalized problem: the transpose pairing
    Q^T A Q (feast_gegv_complex_sym!)."""
    return dense_general_feast(A, B, Emid, r, M0, fpm, bilinear=True, **kw)


def feast_geev_complex_sym(A, Emid, r, M0, fpm=None, **kw
                           ) -> FeastGeneralResult:
    """Dense complex-symmetric standard problem (feast_geev_complex_sym!)."""
    return dense_general_feast(A, None, Emid, r, M0, fpm, bilinear=True,
                               **kw)


def _pep_direct(coeffs, Zne, Wne, V0, Emid, r, *, tol, max_loops,
                aspect_ratio):
    """Direct polynomial FEAST (the Beyn moment scheme):

      Y_e = P(z_e)^-1 V;  A0 = sum w_e Y_e;  A1 = sum w_e z_e Y_e
      thin SVD A0 = U S W^H (rank-deflated);  B = U^H A1 W S^-1
      eig(B) -> Ritz values inside the contour, vectors x = U s.

    A refinement loop replaces V by the Ritz vectors (subspace iteration
    through the polynomial resolvent). Returns (loop, x, lam, res, inside,
    eps, conv) with loop the loops run."""
    degree = len(coeffs) - 1
    cdtype = Zne.dtype
    rdtype = V0.real.dtype
    dev = V0.device
    # moment-matrix rank cut: the Beyn pencil's trailing singular values
    # are quadrature leakage (the filter's outside level), far above
    # machine noise; genuine inside directions sit at O(1)
    rank_cut = 1e-2
    marker = complex(Emid) + 3.0 * float(r)
    # P(z_e) for all nodes by Horner: (ne, N, N), factored once
    P_all = coeffs[degree][None].expand(Zne.shape[0], -1, -1)
    for k in range(degree - 1, -1, -1):
        P_all = P_all * Zne[:, None, None] + coeffs[k][None]
    lu, piv = lu_factor(P_all)
    del P_all

    def apply_P(lam, X):
        """P(lam_j) x_j columnwise (for the residuals)."""
        acc = coeffs[degree] @ X
        for k in range(degree - 1, -1, -1):
            acc = acc * lam[None, :] + coeffs[k] @ X
        return acc

    V = V0
    loop, conv = 0, False
    lam = torch.zeros(V0.shape[1], dtype=cdtype, device=dev)
    res = torch.full((V0.shape[1],), float("inf"), dtype=rdtype, device=dev)
    inside = torch.zeros(V0.shape[1], dtype=torch.bool, device=dev)
    eps = torch.tensor(float("inf"), dtype=rdtype, device=dev)
    while not conv and loop < max_loops + 1:
        Y = torch.linalg.lu_solve(lu, piv, V)
        A0 = torch.einsum("e,enm->nm", Wne, Y)
        A1 = torch.einsum("e,enm->nm", Wne * Zne, Y)
        del Y
        U, s, Wh = torch.linalg.svd(A0, full_matrices=False)
        m = (s >= rank_cut * s[0]).to(rdtype)
        s_inv = torch.where(m > 0, 1.0 / torch.where(s > 0, s,
                                                     torch.ones_like(s)),
                            torch.zeros_like(s))
        Bred = (U.mH @ A1) @ (Wh.mH * s_inv[None, :].to(cdtype))
        # deflated directions -> decoupled marker eigenvalues
        mc = m.to(cdtype)
        Bred = Bred * (mc[:, None] * mc[None, :]) \
            + marker * torch.diag(1.0 - mc)
        lam, Sv = general_eig(Bred)
        x = U @ Sv
        nrm = torch.linalg.vector_norm(x, dim=0)
        x = x / torch.where(nrm > 0, nrm, torch.ones_like(nrm))[None, :]
        res = torch.linalg.vector_norm(apply_P(lam, x), dim=0) \
            / torch.clamp(lam.abs(), min=1.0)
        w = (lam - complex(Emid)).to(torch.complex128)
        xs = w.real / float(r)
        ys = w.imag / (float(r) * aspect_ratio)
        inside = xs * xs + ys * ys <= 1.0
        order = inside_first_order(lam, inside, general=True)
        lam, x, res, inside = lam[order], x[:, order], res[order], \
            inside[order]
        plausible = inside & (res < 0.1)
        eps = torch.where(plausible, res, torch.zeros_like(res)).max()
        conv = bool((eps <= tol) & (plausible.sum() > 0))
        V = x
        loop += 1
    return loop, V, lam, res, inside, eps, conv


def feast_pep_direct(coeffs, Emid, r, M0, fpm=None, eig_method=None,
                     Q0=None, device=None) -> FeastGeneralResult:
    """Direct (linearization-free) polynomial eigensolver: N x M0 memory
    instead of the companion's dN x dM0 (see ``_pep_direct``). Its accuracy
    is limited by the quadrature (the eigenvalue error follows the
    contour's leakage), so it takes at least 32 full-contour nodes; use
    ``feast_pep`` where machine-precision eigenpairs are needed.
    ``eig_method`` as in ``dense_general_feast``. As in the JAX package,
    fpm[14] = 2 runs an ordinary solve here (the scheme has no count)."""
    check_method(eig_method)
    device = resolve_device(device)
    fpm = _ensure_fpm(fpm)
    if fpm[8] < 32:
        fpm = fpm.copy()
        fpm[8] = 32
    cdtype = _cdtype_of(*[_np_dtype(c) for c in coeffs])
    coeffs = [_operand(c, cdtype, device) for c in coeffs]
    N = coeffs[0].shape[0]
    config = FeastConfig.from_fpm(fpm, dtype=cdtype)
    Zne, Wne = contour_tensors(fpm, Emid, r, cdtype, device)
    V0 = torch.as_tensor(initial_subspace(fpm, Q0, N, M0, cdtype,
                                          general=True)).to(device)
    loop, x, lam, res, inside, eps, conv = _pep_direct(
        coeffs, Zne, Wne, V0, Emid, r, tol=config.tol,
        max_loops=config.max_loops, aspect_ratio=config.aspect_ratio)
    info = FeastError.SUCCESS if conv else FeastError.NO_CONVERGENCE
    return _trim(FeastGeneralResult, lam.cpu().numpy(), x,
                 res.cpu().numpy(), inside.cpu().numpy(), int(info),
                 float(eps), loop - 1)


def feast_pep(coeffs, Emid, r, M0, fpm=None, Q0=None, **kw
              ) -> FeastGeneralResult:
    """Polynomial eigenproblem P(lam) x = (sum_k lam^k A_k) x = 0 through
    the first-companion linearization to a (d N)-dimensional pencil
    (feast_pep!). coeffs: [A_0, A_1, ..., A_d], numpy arrays or tensors:

      Ac = [[0, I, 0...], [0, 0, I, ...], [-A0, -A1, ..., -A_{d-1}]],
      Bc = diag(I, ..., I, A_d);  eigenvector x = the first N rows.
    """
    coeffs = [c.detach().cpu().numpy() if isinstance(c, torch.Tensor)
              else np.asarray(c) for c in coeffs]
    d = len(coeffs) - 1
    if d < 1:
        raise ValueError("Polynomial eigenproblem needs degree >= 1")
    N = coeffs[0].shape[0]
    for c in coeffs:
        if c.shape != (N, N):
            raise ValueError("All coefficient matrices must be square and "
                             "equal size")
    cdtype = _cdtype_of(*[c.dtype for c in coeffs])
    coeffs = [c.astype(cdtype) for c in coeffs]
    if d == 1:
        # a linear pencil A0 + lam A1: A x = lam B x with A = -A0, B = A1
        return dense_general_feast(-coeffs[0], coeffs[1], Emid, r, M0, fpm,
                                   Q0=Q0, **kw)
    eye = np.eye(N, dtype=cdtype)
    zero = np.zeros((N, N), cdtype)
    rows = [np.concatenate([zero] * (i + 1) + [eye] + [zero] * (d - i - 2),
                           axis=1) for i in range(d - 1)]
    rows.append(np.concatenate([-c for c in coeffs[:d]], axis=1))
    Ac = np.concatenate(rows, axis=0)
    Bc = sla.block_diag(*([eye] * (d - 1) + [coeffs[d]]))
    # a warm start (fpm[5]) of (N, M0) is lifted into the companion space
    # by vertical tiling (a companion eigenvector's first N rows)
    Q0c = None
    if Q0 is not None:
        Q0 = Q0.detach().cpu().numpy() if isinstance(Q0, torch.Tensor) \
            else np.asarray(Q0)
        if Q0.shape[0] == N:
            Q0c = np.tile(np.asarray(Q0, cdtype), (d, 1))
            nrm = np.linalg.norm(Q0c, axis=0, keepdims=True)
            Q0c = Q0c / np.where(nrm > 0, nrm, 1.0)
        else:
            Q0c = np.asarray(Q0, cdtype)
    res = dense_general_feast(Ac, Bc, Emid, r, M0, fpm, Q0=Q0c, **kw)
    # the eigenvectors back to the first N rows, renormalized
    if res.M:
        q = res.q[:N, :]
        nrm = torch.linalg.vector_norm(q, dim=0)
        res.q = q / torch.where(nrm > 0, nrm, torch.ones_like(nrm))[None, :]
    res.q_full = res.q_full[:N, :]
    return res
