"""Banded FEAST drivers, symmetric and Hermitian (PyTorch).

Counterpart of the interval half of ``feastkit_tpu/solvers/banded.py``:
LAPACK band storage in, the shifted pencils z_e B - A of every contour node
factored once by block cyclic reduction (``ops/banded.py``, batched over
the nodes) and solved every refinement loop. BCR has no cheap adjoint
solve, so a Hermitian pencil factors the mirrored nodes conj(z_e) too
(conjugate-node doubling); a real symmetric one takes Re(sum_e 2 W_e X_e).

At throughput scale (N >= 4096, ``FEAST_CONTOUR_POLY`` on) a pencil takes
the polynomial route of the sparse driver on its sparse form
(``solvers/sparse._sparse_cheb_interval``): one on at most 32 diagonals
in the fused Chebyshev kernels (a Hermitian one in the complex one-step
entries, where the JAX package runs the unfused recurrence), one on more
than 32 in the unfused recurrence on CSR products. When that route is
infeasible BCR answers. It never returns to the sparse router.

The general and complex-symmetric drivers (``feast_gbev`` / ``gbgv`` /
``sbev_complex`` / ``sbgv_complex``) factor the shifted pencils of the full
contour by the same BCR and take the complex sum sum_e W_e X_e over every
node, with ``kernel/general.feast_general_core`` around it. The stochastic
count fpm[14] = 2 runs the probes through the same filters (the polynomial
route's own count at throughput scale). The JAX package's pair and embedding
mechanisms, its demotion of complex128 work and its host-driven programs
are TPU-only and not ported.
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch

from ..core.aux import feast_get_custom_contour
from ..core.backend import resolve_device
from ..core.contour import feast_contour
from ..core.parameters import FeastConfig, _ensure_fpm
from ..core.tools import initial_subspace
from ..core.types import FeastError, FeastGeneralResult, FeastResult, _trim
from ..kernel.general import contour_tensors, feast_general_core, \
    general_result
from ..kernel.hermitian import feast_hermitian_core
from ..ops.banded import (banded_matvec, banded_to_blocktridiag, bcr_factor,
                          bcr_solve)
from ..ops.chebfilter import ChebInfeasible
from ..ops.eig import check_method
from .dense import _TORCH_DTYPE
from .sparse import (_contour_poly_default, _general_estimate,
                     _sparse_cheb_interval, _stochastic_estimate_result)

__all__ = ["feast_sbev", "feast_sbgv", "feast_hbev", "feast_hbgv",
           "feast_gbev", "feast_gbgv", "feast_sbev_complex",
           "feast_sbgv_complex", "identity_bands"]

def identity_bands(N, kl, ku, dtype, device=None) -> torch.Tensor:
    """Band storage of the identity in a (kl+ku+1, N) layout on ``device``
    (None means CUDA, as at every entry point)."""
    bands = torch.zeros((kl + ku + 1, N), dtype=dtype,
                        device=resolve_device(device))
    bands[ku] = 1.0
    return bands


def _common_layout(bands, kl, ku, KL, KU, N, dtype) -> torch.Tensor:
    """Re-pad a band array into the common (KL+KU+1, N) layout."""
    out = torch.zeros((KL + KU + 1, N), dtype=dtype, device=bands.device)
    out[KU - ku:KU - ku + kl + ku + 1] = bands.to(dtype)
    return out


def _banded_machinery(A_bands, kl, ku, B_bands, klb, kub, Zne, work_dtype):
    """(apply_A, apply_B, solve_all) over band storage. solve_all: rhs
    (N, M) -> (ne, N, M) in Zne's complex dtype, through the BCR
    hierarchies of every node's shifted pencil z_e B - A, factored here
    once."""
    N = A_bands.shape[1]
    standard = B_bands is None
    KL = max(kl, 0 if standard else klb)
    KU = max(ku, 0 if standard else kub)
    cdtype = Zne.dtype
    Ac = _common_layout(A_bands, kl, ku, KL, KU, N, cdtype)
    Bc = (identity_bands(N, KL, KU, cdtype, A_bands.device) if standard
          else _common_layout(B_bands, klb, kub, KL, KU, N, cdtype))
    D, L, U, b, _ = banded_to_blocktridiag(
        Zne[:, None, None] * Bc[None] - Ac[None], KL, KU)
    levels, root_lu, root_piv = bcr_factor(D, L, U)
    Npad = D.shape[-3] * b
    del D, L, U

    def solve_all(rhs):
        M = rhs.shape[1]
        rhs_p = torch.zeros((Npad, M), dtype=cdtype, device=rhs.device)
        rhs_p[:N] = rhs
        x = bcr_solve(levels, root_lu, root_piv,
                      rhs_p.reshape(Npad // b, b, M))
        return x.reshape(x.shape[:-3] + (Npad, M))[..., :N, :]

    A_work = _common_layout(A_bands, kl, ku, KL, KU, N, work_dtype)
    apply_A = lambda X: banded_matvec(A_work, X, KL, KU)       # noqa: E731
    if standard:
        apply_B = lambda X: X                                   # noqa: E731
    else:
        B_work = _common_layout(B_bands, klb, kub, KL, KU, N, work_dtype)
        apply_B = lambda X: banded_matvec(B_work, X, KL, KU)   # noqa: E731
    return apply_A, apply_B, solve_all


def _banded_filter(A_bands, kl, ku, B_bands, klb, kub, Zne, Wne, *,
                   hermitian, work_dtype):
    """(apply_A, apply_B, filter_apply): the Hermitian filter sums over the
    nodes and their mirrors, sum_e W_e X_e over z_e and conj(z_e); the real
    one takes Re(sum_e 2 W_e X_e)."""
    if hermitian:
        Zne = torch.cat([Zne, Zne.conj()])
        Wne = torch.cat([Wne, Wne.conj()])
    else:
        Wne = 2.0 * Wne
    apply_A, apply_B, solve_all = _banded_machinery(
        A_bands, kl, ku, B_bands, klb, kub, Zne, work_dtype)

    def filter_apply(Q):
        acc = torch.einsum("e,enm->nm", Wne,
                           solve_all(apply_B(Q).to(Zne.dtype)))
        return acc if hermitian else acc.real.to(Q.dtype)

    return apply_A, apply_B, filter_apply


def _bands_csr(bands, kl, ku, dtype):
    """Band storage -> scipy CSR (scipy's DIA layout is band storage:
    data[k, j] = A[j - offset_k, j] with offset_k = ku - k)."""
    offs = np.arange(ku, -kl - 1, -1)
    N = bands.shape[1]
    return sp.dia_matrix((np.asarray(bands, dtype), offs),
                         shape=(N, N)).tocsr()


def _host(bands):
    if isinstance(bands, torch.Tensor):
        return bands.detach().cpu().numpy()
    return None if bands is None else np.asarray(bands)


def _banded_interval_driver(A_bands, kl, ku, B_bands, klb, kub, Emin, Emax,
                            M0, fpm, hermitian, Q0=None, device=None
                            ) -> FeastResult:
    """The symmetric / Hermitian banded interval driver (the throughput
    route, else BCR). Bands are numpy arrays or tensors."""
    device = resolve_device(device)
    fpm = _ensure_fpm(fpm)
    A_np, B_np = _host(A_bands), _host(B_bands)
    N = A_np.shape[1]
    if not 0 < M0 <= N:
        raise ValueError(f"M0 must be in 1..N={N}, got {M0}")
    if not Emax > Emin:
        raise ValueError(f"Emin={Emin} must be < Emax={Emax}")
    if A_np.shape[0] != kl + ku + 1:
        raise ValueError(
            f"A band array must have kl+ku+1={kl+ku+1} rows, got "
            f"{A_np.shape[0]}")
    is_c = np.iscomplexobj(A_np) or (B_np is not None
                                     and np.iscomplexobj(B_np))
    hermitian = is_c if hermitian is None else hermitian
    f64 = A_np.dtype in (np.dtype(np.float64), np.dtype(np.complex128))
    rdtype = np.dtype(np.float64 if f64 else np.float32)
    cdtype = np.dtype(np.complex128 if f64 else np.complex64)
    work = cdtype if hermitian else rdtype
    config = FeastConfig.from_fpm(fpm, dtype=cdtype)
    contour = feast_get_custom_contour(fpm) or feast_contour(Emin, Emax,
                                                             fpm)
    if N >= 4096 and _contour_poly_default():
        # a banded pencil is a sparse operator: realize the contour's
        # rational filter as one Chebyshev series on it
        try:
            return _sparse_cheb_interval(
                _bands_csr(A_np, kl, ku, work), None if B_np is None
                else _bands_csr(B_np, klb, kub, work), Emin, Emax, M0, fpm,
                hermitian=bool(hermitian), Q0=Q0, contour=contour,
                route=True, device=device)
        except ChebInfeasible as e:
            if config.print_level >= 1:
                print(f"feast banded: contour-polynomial route "
                      f"unavailable ({e}); using the BCR direct engine",
                      flush=True)

    def dev(x):
        return None if x is None else torch.as_tensor(x).to(device)

    apply_A, apply_B, filter_apply = _banded_filter(
        dev(A_np), kl, ku, dev(B_np), klb, kub,
        dev(np.asarray(contour.Zne, cdtype)),
        dev(np.asarray(contour.Wne, cdtype)), hermitian=bool(hermitian),
        work_dtype=_TORCH_DTYPE[work])
    if config.mode == 2:
        return _stochastic_estimate_result(filter_apply, N, fpm, work,
                                           device)
    q0 = torch.as_tensor(initial_subspace(fpm, Q0, N, M0, work)).to(device)
    state = feast_hermitian_core(
        apply_A, apply_B, filter_apply, q0, float(Emin), float(Emax),
        tol=config.tol, max_loops=config.max_loops,
        convergence_criterion=config.convergence_criterion,
        subspace_only=(config.mode == 1))
    info = FeastError.SUCCESS if bool(state.converged) \
        else FeastError.NO_CONVERGENCE
    return _trim(FeastResult, state.lam.cpu().numpy(), state.Q,
                 state.res.cpu().numpy(), state.inside.cpu().numpy(),
                 int(info), float(state.epsout), int(state.loop) - 1)


def feast_sbev(A_bands, kl, ku, Emin, Emax, M0, fpm=None, **kw
               ) -> FeastResult:
    """Banded real-symmetric standard problem (feast_sbev!). A_bands: the
    full (kl+ku+1, N) band storage."""
    return _banded_interval_driver(A_bands, kl, ku, None, 0, 0,
                                   Emin, Emax, M0, fpm, hermitian=False, **kw)


def feast_sbgv(A_bands, kl, ku, B_bands, klb, kub, Emin, Emax, M0,
               fpm=None, **kw) -> FeastResult:
    """Banded real-symmetric generalized problem (feast_sbgv!)."""
    return _banded_interval_driver(A_bands, kl, ku, B_bands, klb, kub,
                                   Emin, Emax, M0, fpm, hermitian=False, **kw)


def feast_hbev(A_bands, kl, ku, Emin, Emax, M0, fpm=None, **kw
               ) -> FeastResult:
    """Banded complex-Hermitian standard problem (feast_hbev!)."""
    return _banded_interval_driver(A_bands, kl, ku, None, 0, 0,
                                   Emin, Emax, M0, fpm, hermitian=True, **kw)


def feast_hbgv(A_bands, kl, ku, B_bands, klb, kub, Emin, Emax, M0,
               fpm=None, **kw) -> FeastResult:
    """Banded complex-Hermitian generalized problem (feast_hbgv!)."""
    return _banded_interval_driver(A_bands, kl, ku, B_bands, klb, kub,
                                   Emin, Emax, M0, fpm, hermitian=True, **kw)


def _banded_general_driver(A_bands, kl, ku, B_bands, klb, kub, Emid, r, M0,
                           fpm, bilinear, eig_method=None, Q0=None,
                           device=None) -> FeastGeneralResult:
    """The general / complex-symmetric banded driver: the shifted pencils
    of the full contour around Emid factored once by BCR, the complex sum
    sum_e W_e X_e over every node (weights unscaled, no mirroring), and
    ``kernel/general.feast_general_core`` around it, in complex64 for
    single-precision bands and complex128 otherwise. ``eig_method`` as in
    ``dense_general.dense_general_feast``."""
    check_method(eig_method)
    device = resolve_device(device)
    fpm = _ensure_fpm(fpm)
    A_np, B_np = _host(A_bands), _host(B_bands)
    N = A_np.shape[1]
    if not 0 < M0 <= N:
        raise ValueError(f"M0 must be in 1..N={N}, got {M0}")
    if not r > 0:
        raise ValueError(f"Contour radius must be positive, got {r}")
    f64 = A_np.dtype in (np.dtype(np.float64), np.dtype(np.complex128))
    cdtype = np.dtype(np.complex128 if f64 else np.complex64)
    config = FeastConfig.from_fpm(fpm, dtype=cdtype)
    Zne, Wne = contour_tensors(fpm, Emid, r, cdtype, device)

    def dev(x):
        return None if x is None else torch.as_tensor(
            np.asarray(x, cdtype)).to(device)

    apply_A, apply_B, solve_all = _banded_machinery(
        dev(A_np), kl, ku, dev(B_np), klb, kub, Zne, _TORCH_DTYPE[cdtype])

    def filter_apply(Q):
        return torch.einsum("e,enm->nm", Wne, solve_all(apply_B(Q)))

    if config.mode == 2:
        # the raw full-contour sum: trace(P) = M, weights unscaled
        return _general_estimate(_stochastic_estimate_result(
            filter_apply, N, fpm, cdtype, device))
    q0 = torch.as_tensor(initial_subspace(fpm, Q0, N, M0, cdtype,
                                          general=True)).to(device)
    state = feast_general_core(
        apply_A, apply_B, filter_apply, q0, complex(Emid), float(r),
        tol=config.tol, max_loops=config.max_loops,
        aspect_ratio=config.aspect_ratio, rotation_deg=config.rotation_deg,
        convergence_criterion=config.convergence_criterion,
        subspace_only=(config.mode == 1), bilinear=bilinear)
    return general_result(state)


def feast_gbev(A_bands, kl, ku, Emid, r, M0, fpm=None, **kw
               ) -> FeastGeneralResult:
    """Banded general standard problem (feast_gbev!)."""
    return _banded_general_driver(A_bands, kl, ku, None, 0, 0, Emid, r, M0,
                                  fpm, bilinear=False, **kw)


def feast_gbgv(A_bands, kl, ku, B_bands, klb, kub, Emid, r, M0, fpm=None,
               **kw) -> FeastGeneralResult:
    """Banded general generalized problem (feast_gbgv!)."""
    return _banded_general_driver(A_bands, kl, ku, B_bands, klb, kub, Emid,
                                  r, M0, fpm, bilinear=False, **kw)


def feast_sbev_complex(A_bands, kl, ku, Emid, r, M0, fpm=None, **kw
                       ) -> FeastGeneralResult:
    """Banded complex-symmetric standard problem (feast_sbev_complex!): the
    transpose pairing."""
    return _banded_general_driver(A_bands, kl, ku, None, 0, 0, Emid, r, M0,
                                  fpm, bilinear=True, **kw)


def feast_sbgv_complex(A_bands, kl, ku, B_bands, klb, kub, Emid, r, M0,
                       fpm=None, **kw) -> FeastGeneralResult:
    """Banded complex-symmetric generalized problem (feast_sbgv_complex!)."""
    return _banded_general_driver(A_bands, kl, ku, B_bands, klb, kub, Emid,
                                  r, M0, fpm, bilinear=True, **kw)
