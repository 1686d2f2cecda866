"""Sparse FEAST: the symmetric and Hermitian interval drivers (the
polynomial-filter path and the Krylov contour engine) and the general /
complex-symmetric drivers on the Krylov engine (PyTorch).

Counterpart of ``feastkit_tpu/solvers/sparse.py`` (``feast_scsrev`` /
``scsrgv`` / ``hcsrev`` / ``hcsrgv``; ``feast_gcsrev`` / ``gcsrgv`` /
``scsrev_complex`` / ``scsrgv_complex`` / ``scsrpev``): the auto route
of ``sparse_feast_interval`` (the rational-contour filter realized as one
Chebyshev polynomial, or the Jackson indicator when that is cheaper),
``solver="cheb"`` / ``"contour_poly"``, and the refinement of
``_sparse_cheb_interval`` for standard, positive-diagonal-B and
sparse-SPD-B (consistent-mass) pencils: the host-driven ladder loop under
mixed precision, else ``kernel/hermitian.feast_hermitian_core`` (the JAX
package's fused run, ``_sparse_cheb_jit``: no stall exit, no best state).
Complex Hermitian operators (``hermitian=None`` means "complex data";
``hermitian=True`` on real data runs in complex work precision, as in the
JAX package) run at native complex64 / complex128.

An operator on at most 32 diagonals, real or complex Hermitian (and, for
the SPD-B composite, a real one with a B on at most 32) has its filter
applications in the fused Chebyshev-step kernels: a complex one in the
one-step complex entries, where the JAX package runs the recurrence
unfused (Mosaic has no complex type; sparse.py:2027). Everything else runs
the JAX package's UNFUSED recurrence (``_sparse_cheb_filter_host``): a
host loop over the coefficients on the operator's products, a torch CSR
product (the JAX package's BCOO product) for an operator with more than 32
diagonals, and the composite q(B~) A~ on them for a sparse SPD B with no
DIA form; so does the stochastic count (fpm[14] = 2).

Every fused filter application runs the fused Chebyshev-step kernels of
``ops/cheb_kernels.py`` on CUDA tensors (their plain versions on CPU
tensors): one 1-step launch for the k=1 init, then 4-step passes where the
shape fits the 4-step kernel, else 2-step passes, else 1-step launches
(``FEAST_CHEB_FUSE2=0`` / ``FEAST_CHEB_FUSE4=0`` select the 1-step and the
2-step configuration, as in the JAX package); a complex operator takes
1-step launches throughout. It does so through a
two-rung precision ladder: ``f32`` (the f32-rounded operator, half the bytes of the bandwidth-bound recurrence) while epsout
is above the f32 floor, then ``f64``. The JAX package's middle
double-single rung exists because a TPU emulates f64; on Hopper it is the
same fp64 kernel, so the port's top rung covers both. The mixed-precision
policy fpm[42] reads "auto" as "on for CUDA" (the JAX package: "on for the
TPU"), and stays off on the CPU.

A sparse SPD B (``_b_sparse_spd``) is solved as in the JAX package: both
operators are congruenced to unit diagonal, f32 Lanczos runs on the
solve's device bound B~ and the pencil's upper edge
(``_b_spd_bounds``, ``_pencil_upper_edge_fast``; a B or A with no DIA
form takes the JAX package's host scipy route instead: ``eigsh`` for B~,
``_pencil_upper_edge`` for the pencil), and the filter runs on
the composite q(B~) A~ with q a Chebyshev polynomial inverse of B~
(``ops/cheb_gen.py``: per outer step one A pass, the inner recurrence in B
and one combine kernel), while Rayleigh-Ritz and the residuals use the
exact pencil. An indefinite or nonsymmetric B is refused with the JAX
package's message (a ValueError; on the auto route the Krylov engine takes
it).

The Krylov contour engine (``solver="gmres"`` / ``"bicgstab"``, fpm[43]=1,
``FEAST_CONTOUR_POLY=0``, or the auto route's fallback when no polynomial
filter resolves the interval at N > ``FEAST_SPARSE_DENSE_N``) is the JAX
package's off-TPU path ``_sparse_hermitian_jit``: ``_sparse_ops`` builds
the operators (the DIA kernels of ``ops/dia.py``, or a CSR product for more
than 32 diagonals) and the contour filter of ``_make_sparse_solve_all``
(per node group one batched GMRES / BiCGStab solve, multigrid or Jacobi
preconditioned, complex64 Krylov inside a complex128 refinement under
mixed precision): the half contour with Re(sum 2 W X) for a real pencil,
the mirrored node set [Z, conj Z] with a complex accumulator for a
Hermitian one. ``kernel/hermitian.feast_hermitian_core`` refines around
it.

The general engine (``sparse_feast_general``: general pencils inside the
ellipse (Emid, r), and complex-symmetric ones with the transpose pairing)
runs the same Krylov filter in complex work on the full contour as given
(``_sparse_general_ops``: no mirrored nodes, the complex sum
sum_e W_e X_e), on the complex DIA entries for an operator of at most 32
diagonals, with ``kernel/general.feast_general_core`` around it; a
narrow-banded pencil goes to the banded general driver first, and a
polynomial eigenproblem's sparse coefficients are densified onto
``solvers/dense_general.feast_pep``.

Two hand-offs leave this module for the direct engines, as in the JAX
package: a narrow-banded pencil (half bandwidth <= 16, N <= 16384) that
nothing pinned to an iterative solve goes to the banded driver
(``solvers/banded._banded_interval_driver``, block cyclic reduction, or
its own polynomial route at N >= 4096), and a pencil of N <=
``FEAST_SPARSE_DENSE_N`` that leaves the polynomial route is densified
onto the dense engine (``solvers/dense.dense_hermitian_feast``).

The JAX package's real embedding of complex Hermitian pencils
(``_sparse_embedded_hermitian``), its ``f64_lu_unavailable`` gate and the
general engine's demotion of complex128 work (``demote_f64_general``)
exist because a TPU has no complex128, and its choice of the on-device QR
eigensolver where complex I/O is required because a remote TPU runtime
cannot call back to the host; they are not ported. The stochastic count
fpm[14]=2 runs on every engine (``_stochastic_estimate_result``).
The sharded drivers (``parallel/pfeast.py``) run these engines on each
rank's share: ``_sparse_ops`` with a rank's contour nodes or row block,
and ``_sparse_cheb_interval(mesh=...)`` with a rank's column block.
"""
from __future__ import annotations

import os
import time
import warnings

import numpy as np
import torch

from ..core.backend import resolve_device
from ..core.contour import feast_contour
from ..core.parameters import (FeastConfig, _ensure_fpm,
                               ifeast_solver_options)
from ..core.tools import initial_subspace
from ..core.types import FeastError, FeastGeneralResult, FeastResult, _trim
from ..kernel.general import contour_tensors, feast_general_core, \
    general_result
from ..kernel.hermitian import (SPURIOUS_RES, VERIFY_FILTER_TOL,
                                feast_hermitian_core, hermitian_result,
                                init_hermitian_state,
                                make_rayleigh_ritz_update,
                                verify_spurious_from)
from ..ops.cheb_gen import cheb_gen_chunk, cheb_gen_init
from ..ops.cheb_kernels import (cheb_c64_chunk, cheb_c128_chunk,
                                cheb_f32_2_chunk, cheb_f32_4_chunk,
                                cheb_f32_chunk, cheb_f64_2_chunk,
                                cheb_f64_4_chunk, cheb_f64_chunk,
                                multistep_plan, transpose_planes)
from ..ops.chebfilter import (ChebInfeasible, _cheb_init, _map_scalars,
                              binva_enclosure,
                              build_cheb_filter_coeffs, cheb_inverse_coeffs,
                              gershgorin_interval, make_apply_binv_a,
                              make_cheb_stepper, rational_filter_cheb_coeffs)
from ..ops.dia import bcoo_to_dia, dia_matvec, dia_matvec_any
from ..ops.eig import check_method
from ..ops.gmres import bicgstab_block, gmres_block
from ..ops.multigrid import (GridStencil, detect_grid_stencil,
                             make_shifted_vcycle, plan_mg_levels)
from ..utils import trace
from .dense import _TORCH_DTYPE, _np_dtype

__all__ = ["feast_scsrev", "feast_scsrgv", "feast_hcsrev", "feast_hcsrgv",
           "sparse_coo_arrays", "sparse_feast_interval",
           "sparse_feast_general", "feast_gcsrev", "feast_gcsrgv",
           "feast_scsrev_complex", "feast_scsrgv_complex", "feast_scsrpev",
           "feast_hcsrpev", "feast_gcsrpev"]


def _upload(host, device, dtype=None):
    """A host tensor on ``device`` (as ``dtype``), its bytes counted where
    they cross to a card (``utils/trace``): a blocking copy converts on the
    host, so ``dtype``'s bytes cross."""
    trace.count_h2d(host, device, dtype)
    return host.to(device=device, dtype=dtype)


def _stochastic_estimate_result(filter_fn, N, fpm, work_dtype, device):
    """fpm[14] = 2, shared by every driver: the JAX package's Rademacher
    probes (an (N, fpm[32]) block from numpy ``default_rng((N * 31 + T) %
    (2**31 - 1))`` in the work dtype) through the solve's own filter on
    ``device``, M_est = E[v^T P v] (feast_parameters.jl:71-75). A
    count-only result: no eigenpairs (lam of size 0, q (N, 0) on the
    device), M = max(round(est), 0), epsout = est, one loop."""
    trials = max(int(fpm[32]), 1)
    rng_probe = np.random.default_rng((N * 31 + trials) % (2**31 - 1))
    V = rng_probe.choice([-1.0, 1.0], size=(N, trials)).astype(work_dtype)
    out = filter_fn(_upload(torch.as_tensor(V), device))
    PV = (out[0] if isinstance(out, tuple) else out).cpu().numpy()
    est = float(np.einsum("nt,nt->", np.real(V), np.real(PV)) / trials)
    return FeastResult(np.zeros(0), torch.zeros(
        (N, 0), dtype=_TORCH_DTYPE[np.dtype(work_dtype)], device=device),
        max(int(round(est)), 0), np.zeros(0), FeastError.SUCCESS, est, 1)


def _general_estimate(res):
    """The count-only result of a general driver."""
    return FeastGeneralResult(np.zeros(0, _np_dtype(res.q)), res.q,
                              res.M, res.res, res.info, res.epsout, res.loop)


def _cast_values(data, dtype):
    """dtype cast keeping the real part of complex data for a real dtype."""
    if dtype is None:
        return data
    if np.iscomplexobj(data) and not np.issubdtype(np.dtype(dtype),
                                                   np.complexfloating):
        data = data.real
    return data.astype(dtype)


def sparse_coo_arrays(A, dtype=None):
    """scipy.sparse / dense input -> host (data, indices (nnz, 2), shape)."""
    import scipy.sparse as sp
    if sp.issparse(A):
        coo = A.tocoo()
        data = _cast_values(coo.data, dtype)
        idx = np.stack([coo.row.astype(np.int32),
                        coo.col.astype(np.int32)], axis=1)
        return np.ascontiguousarray(data), idx, tuple(coo.shape)
    A = np.asarray(A) if dtype is None else _cast_values(np.asarray(A), dtype)
    r, c = np.nonzero(np.ones(A.shape, bool))
    idx = np.stack([r.astype(np.int32), c.astype(np.int32)], axis=1)
    return A.ravel(), idx, tuple(A.shape)


def _peek_dtype(A):
    import scipy.sparse as sp
    if sp.issparse(A):
        return np.zeros((), A.dtype)
    return np.zeros((), np.asarray(A).dtype)


def _is_double(dt) -> bool:
    """True when the real-component precision is 64-bit."""
    dt = np.dtype(dt)
    if dt.kind == "c":
        return np.finfo(dt).dtype.itemsize >= 8
    if dt.kind == "f":
        return dt.itemsize >= 8
    return True          # integer / exotic inputs promote to double


def _b_diagonal(B):
    """B is None/identity -> ("identity", None); a positive diagonal ->
    ("diagonal", d); anything else -> (None, None)."""
    if B is None:
        return "identity", None
    data, idx, shape = sparse_coo_arrays(B)
    if shape[0] != shape[1]:
        return None, None
    off = idx[:, 0] != idx[:, 1]
    if np.any(np.abs(data[off]) > 0):
        return None, None
    diag = np.zeros(shape[0], np.complex128 if np.iscomplexobj(data)
                    else np.float64)
    np.add.at(diag, idx[~off, 0], data[~off])
    if np.iscomplexobj(diag):
        if np.abs(np.imag(diag)).max(initial=0.0) > 0:
            return None, None
        diag = np.real(diag)
    if bool(np.allclose(diag, 1.0, rtol=0, atol=1e-14)):
        return "identity", None
    if np.all(diag > 0):
        return "diagonal", diag
    return None, None


def _b_sparse_spd(B):
    """A real symmetric SPARSE B with a positive diagonal (the
    consistent-mass class) -> ("spd", diag), else (None, None).
    Positive-definiteness itself is certified downstream by the lowest
    eigenvalue of the unit-diagonal congruence (``_b_spd_bounds``)."""
    import scipy.sparse as sp
    data, idx, shape = sparse_coo_arrays(B)
    if shape[0] != shape[1] or np.iscomplexobj(data):
        return None, None
    diag = np.zeros(shape[0], np.float64)
    on = idx[:, 0] == idx[:, 1]
    np.add.at(diag, idx[on, 0], data[on].astype(np.float64))
    if not np.all(diag > 0):
        return None, None
    C = sp.coo_matrix((data, (idx[:, 0], idx[:, 1])), shape=shape).tocsr()
    d = C - C.T
    if d.nnz and np.abs(d.data).max() > 1e-12 * np.abs(data).max():
        return None, None
    return "spd", diag


def _lanczos_tridiag(apply_op, apply_ip, v0, steps):
    """(alphas, betas) of a fixed-step three-term Lanczos recurrence on
    ``apply_op`` in the inner product <x, y> = x^T apply_ip(y) (the
    identity for plain symmetric Lanczos, apply_B for the generalized
    recurrence on B^-1 A). No reorthogonalization and no basis storage:
    orthogonality loss only duplicates converged extreme Ritz values,
    which is harmless for the spectrum-EDGE estimates these feed. Runs in
    v0's dtype and on its device, with no host fetch until the end."""
    def ip(x, y):
        return torch.sum(x * apply_ip(y))

    q = v0 / torch.sqrt(torch.clamp(ip(v0, v0), min=1e-300))
    q_prev = torch.zeros_like(q)
    beta = torch.zeros((), dtype=v0.dtype, device=v0.device)
    alphas, betas = [], []
    for _ in range(steps):
        u = apply_op(q) - beta * q_prev
        a = ip(u, q)
        u = u - a * q
        beta = torch.sqrt(torch.clamp(ip(u, u), min=0.0))
        q_prev, q = q, u / torch.where(beta > 1e-30, beta, 1.0)
        alphas.append(a)
        betas.append(beta)
    return torch.stack(alphas), torch.stack(betas)


def _lanczos_v0(N, device):
    # deterministic start vector (the determinism-by-shape contract): the
    # JAX package's, in f32
    return _upload(torch.as_tensor((np.cos(0.7 * np.arange(N)) + 0.5)
                                   .astype(np.float32).reshape(N, 1)), device)


def _tridiag_edges(al, be):
    import scipy.linalg as sla
    al = np.asarray(al, np.float64)
    be = np.asarray(be, np.float64)[:-1]
    w = sla.eigh_tridiagonal(al, be, eigvals_only=True,
                             lapack_driver="stev")
    return float(w[0]), float(w[-1])


def _pencil_upper_edge_fast(A_dia, offsets_A, B_dia, offsets_B, qc, b_lo,
                            b_hi, N, device, steps=96):
    """Measured upper edge of the congruenced pencil: f32 Lanczos on
    q(B~) A~ (``make_apply_binv_a``) in the B~ inner product, every
    product a plain DIA matvec on ``device`` (the JAX package runs the same
    outside its kernels)."""
    A32 = _upload(torch.as_tensor(np.asarray(A_dia, np.float32)), device)
    B32 = _upload(torch.as_tensor(np.asarray(B_dia, np.float32)), device)

    def apply_B(x):
        return dia_matvec(B32, offsets_B, x)

    apply_C = make_apply_binv_a(lambda x: dia_matvec(A32, offsets_A, x),
                                apply_B, np.float32(b_lo), np.float32(b_hi),
                                np.asarray(qc, np.float32))
    al, be = _lanczos_tridiag(apply_C, apply_B, _lanczos_v0(N, device),
                              min(int(steps), N))
    return _tridiag_edges(al.cpu().numpy(), be.cpu().numpy())[1]


def _b_spd_bounds(B_data, B_idx, N, B_dia, offsets_B, device):
    """Spectrum enclosure [b_lo, b_hi] of the unit-diagonal-scaled B.
    Gershgorin first (free); when the discs touch zero (e.g. P1 2D mass
    matrices, where interior off-diagonal row sums EQUAL the diagonal) a
    fixed-step f32 Lanczos on ``device`` refines the ends (its failure
    raises), or, for a B with no DIA form (``offsets_B`` None), host scipy
    ``eigsh`` with the JAX package's deterministic start vector (its route
    for such a B; on failure Gershgorin's ends stay, as there).
    Raises a ValueError when B is not positive definite enough for the
    polynomial inverse."""
    b_lo, b_hi = gershgorin_interval(B_data, B_idx, N)
    if b_lo <= 0.02 * b_hi and offsets_B is not None:
        B32 = _upload(torch.as_tensor(np.asarray(B_dia, np.float32)), device)
        al, be = _lanczos_tridiag(lambda x: dia_matvec(B32, offsets_B, x),
                                  lambda x: x, _lanczos_v0(N, device),
                                  min(128, N))
        lo_e, hi_e = _tridiag_edges(al.cpu().numpy(), be.cpu().numpy())
        b_lo, b_hi = 0.9 * lo_e, min(1.1 * hi_e, b_hi)
    elif b_lo <= 0.02 * b_hi:
        import scipy.sparse as sp
        import scipy.sparse.linalg as spl
        Bs = sp.coo_matrix((B_data, (B_idx[:, 0], B_idx[:, 1])),
                           shape=(N, N)).tocsr()
        v0 = np.cos(0.7 * np.arange(N)) + 0.5
        try:
            lo_e = float(spl.eigsh(Bs, k=1, which="SA", tol=1e-4, v0=v0,
                                   return_eigenvectors=False)[0])
            hi_e = float(spl.eigsh(Bs, k=1, which="LA", tol=1e-4, v0=v0,
                                   return_eigenvectors=False)[0])
            b_lo, b_hi = 0.9 * lo_e, min(1.1 * hi_e, b_hi)
        except Exception:                                # noqa: BLE001
            pass
    if b_lo <= 1e-6 * b_hi:
        raise ValueError(
            "solver='cheb' with a sparse B requires a well-conditioned "
            f"SPD mass matrix; the scaled B's spectrum enclosure "
            f"[{b_lo:.3g}, {b_hi:.3g}] is not safely positive — use the "
            "contour solvers (gmres/bicgstab) for this pencil")
    return b_lo, b_hi


def _pencil_upper_edge(A_data, A_idx, B_data, B_idx, N):
    """Host Lanczos estimate of lambda_max(B^-1 A) for the scaled SPD-B
    pencil, for operands with no DIA form (counterpart of
    ``_pencil_upper_edge``): scipy ``eigsh`` on (A, B) with a Jacobi-CG
    solve in B, the JAX package's deterministic start vector. None on any
    failure (the enclosure then stays the Gershgorin quotient bound, as in
    the JAX package)."""
    import scipy.sparse as sp
    import scipy.sparse.linalg as spl
    try:
        As = sp.coo_matrix((np.real(A_data).astype(np.float64),
                            (A_idx[:, 0], A_idx[:, 1])), shape=(N, N)).tocsr()
        Bs = sp.coo_matrix((np.real(B_data).astype(np.float64),
                            (B_idx[:, 0], B_idx[:, 1])), shape=(N, N)).tocsr()
        dinv = 1.0 / Bs.diagonal()
        jac = spl.LinearOperator((N, N), matvec=lambda v: dinv * v)

        def bsolve(x):
            y, info = spl.cg(Bs, x, rtol=1e-8, maxiter=200, M=jac)
            if info != 0:
                raise RuntimeError(f"CG in B failed (info={info})")
            return y

        Minv = spl.LinearOperator((N, N), matvec=bsolve)
        v0 = np.cos(0.7 * np.arange(N)) + 0.5
        return float(spl.eigsh(As, k=1, M=Bs, Minv=Minv, which="LA",
                               tol=1e-3, maxiter=150, v0=v0,
                               return_eigenvectors=False)[0])
    except Exception:                                    # noqa: BLE001
        return None


def _densify(X):
    """A sparse or dense operand as a dense host array (duplicates add)."""
    data, idx, shape = sparse_coo_arrays(X)
    D = np.zeros(shape, data.dtype)
    np.add.at(D, (idx[:, 0], idx[:, 1]), data)
    return D


def _quick_narrow_band(A, B, max_half_bw=16, max_n=16384):
    """True for the narrow-banded small pencils the JAX package's auto route
    leaves to its banded direct engine."""
    try:
        _, idx, shape = sparse_coo_arrays(A)
    except Exception:                                    # noqa: BLE001
        return False
    if shape[0] > max_n:
        return False
    d = idx[:, 0].astype(np.int64) - idx[:, 1].astype(np.int64)
    if int(np.abs(d).max(initial=0)) > max_half_bw:
        return False
    if B is not None:
        try:
            _, bi, _ = sparse_coo_arrays(B)
        except Exception:                                # noqa: BLE001
            return False
        db = bi[:, 0].astype(np.int64) - bi[:, 1].astype(np.int64)
        if int(np.abs(db).max(initial=0)) > max_half_bw:
            return False
    return True


def _mixed_enabled(config, device, f64) -> bool:
    """fpm[42] policy: 0 off, 1 auto (on for CUDA tensors: the f32 rung
    halves the bytes of the bandwidth-bound recurrence; off on the CPU),
    2 force. Only meaningful for double-precision work."""
    if not f64 or not config.mixed:
        return False
    if int(config.mixed) >= 2:
        return True
    return device.type == "cuda"


def _cheb_fused_context(A_dia, offsets, coeffs, lo, hi, M):
    """Device operands of both rungs, built once per solve (counterpart of
    ``_cheb_ds_context``): the f64 diagonals and their f32 rounding, the
    coefficients and map scalars in each rung's precision, and each rung's
    steps per pass: 4 where the 4-step kernel's plan takes the shape
    (``multistep_plan``), else 2, else 1, decided per rung from the shape
    alone. ``FEAST_CHEB_FUSE2=0`` keeps the 1-step kernels for every step
    and ``FEAST_CHEB_FUSE4=0`` stops at two steps per pass (the JAX
    package's opt-out switches, with its meaning).

    Complex diagonals (a Hermitian operator) give the complex rungs: "f64"
    complex128 and "f32" complex64, one step per launch (the multi-step
    kernels are real only), with the map scalars of the unfused recurrence
    (``ops/chebfilter._map_scalars``, in the rung's real precision), so on
    the CPU an application equals that recurrence's."""
    N = A_dia.shape[1]
    if A_dia.is_complex():
        def rung(dtype, npd, chunk):
            sc, sh = _map_scalars(lo, hi, dtype)
            return dict(dia=A_dia.to(dtype), coeffs=np.asarray(coeffs, npd),
                        sc=sc, sh=sh, half=0.5, chunk=chunk, dtype=dtype,
                        steps=1)

        return dict(offsets=offsets,
                    f64=rung(torch.complex128, np.float64, cheb_c128_chunk),
                    f32=rung(torch.complex64, np.float32, cheb_c64_chunk))
    fuse2 = os.environ.get("FEAST_CHEB_FUSE2") not in ("0", "")
    fuse4 = fuse2 and os.environ.get("FEAST_CHEB_FUSE4") not in ("0", "")

    def steps(dtype):
        if fuse4 and multistep_plan(offsets, N, M, dtype, 4):
            return 4
        if fuse2 and multistep_plan(offsets, N, M, dtype, 2):
            return 2
        return 1

    return dict(
        offsets=offsets,
        f64=dict(dia=A_dia, coeffs=np.asarray(coeffs, np.float64),
                 sc=2.0 / (hi - lo), sh=(hi + lo) / (hi - lo),
                 half=0.5, chunk=cheb_f64_chunk, chunk2=cheb_f64_2_chunk,
                 chunk4=cheb_f64_4_chunk, dtype=torch.float64,
                 steps=steps(torch.float64)),
        f32=dict(dia=A_dia.to(torch.float32),
                 coeffs=np.asarray(coeffs, np.float32),
                 sc=np.float32(2.0 / (hi - lo)),
                 sh=np.float32((hi + lo) / (hi - lo)),
                 half=np.float32(0.5), chunk=cheb_f32_chunk,
                 chunk2=cheb_f32_2_chunk, chunk4=cheb_f32_4_chunk,
                 dtype=torch.float32, steps=steps(torch.float32)))


def _sparse_cheb_filter_host_fused(ctx, Q, *, rung, n_coeffs=None):
    """One filter application rho(A) Q through the fused step kernels of
    rung "f32" or "f64". The k=1 init is one 1-step kernel launch with
    HALVED map scalars from T0 = 0: T2 = 2 (sc/2 A Q - sh/2 Q) = Ahat Q.
    acc starts at c0 Q in the rung's precision. The remaining r steps run
    as floor(r/4) 4-step passes, then one 2-step pass if r mod 4 >= 2, then
    one 1-step launch if r is odd (with the rung's ``steps`` = 2: r/2
    2-step passes and the odd step; = 1: r 1-step launches). The multi-step
    kernels carry column-major (M, N) planes, so the carry is transposed
    once after the init and acc (or, before an odd last step, the carry)
    once at the end. ``n_coeffs`` truncates the series (the rational
    filter's shorter f32-rung expansion)."""
    r = ctx[rung]
    coeffs = r["coeffs"]
    if n_coeffs is not None:
        coeffs = coeffs[:max(int(n_coeffs), 3)]
    trace.note("filter", steps=len(coeffs) - 1, inner=0, body="fused")
    dia, offsets, sc, sh = r["dia"], ctx["offsets"], r["sc"], r["sh"]
    t1 = Q.to(r["dtype"], copy=True)      # overwritten as the carry rotates
    carry = (torch.zeros_like(t1), t1, t1 * float(coeffs[0]))
    del t1
    carry = r["chunk"](dia, offsets, carry, coeffs[1:2],
                       sc * r["half"], sh * r["half"])
    rest = coeffs[2:]
    n4 = len(rest) // 4 * 4 if r["steps"] == 4 else 0
    n2 = (len(rest) - n4) // 2 * 2 if r["steps"] >= 2 else 0
    if n4 + n2:
        planes = list(carry)
        del carry
        transpose_planes(planes)
        carry = r["chunk4"](dia, offsets, planes, rest[:n4], sc, sh)
        del planes
        carry = r["chunk2"](dia, offsets, carry, rest[n4:n4 + n2], sc, sh)
        if n4 + n2 == len(rest):
            acc = carry[2]
            del carry                     # the T planes, before the copy
            return acc.t().contiguous()
        planes = list(carry)
        del carry
        transpose_planes(planes)
        carry = tuple(planes)
        del planes
    carry = r["chunk"](dia, offsets, carry, rest[n4 + n2:], sc, sh)
    return carry[2]


def _cheb_gen_context(A_dia, offsets_A, B_dia, offsets_B, coeffs, lo, hi,
                      b_lo, b_hi, qc, qc_lo, M):
    """Device operands of both rungs of the sparse-SPD-B composite, built
    once per solve (counterpart of ``_cheb_gen_ds_context``): both
    congruenced operators' diagonals in each rung's precision, the outer
    coefficients, the inner inverse (``qc`` on the f64 rung, the shorter
    ``qc_lo`` on the f32 rung), the outer and B-hat map scalars (f32 on
    the f32 rung, f64 on the f64 rung) and each rung's inner steps per
    pass: 4 where the 4-step kernel's plan takes B~ (``multistep_plan``),
    else 2, else 1. As in the JAX package only ``FEAST_CHEB_FUSE4=0``
    applies (inner passes of two steps); the composite never runs its
    inner steps one at a time by choice."""
    N = A_dia.shape[1]
    fuse4 = os.environ.get("FEAST_CHEB_FUSE4") not in ("0", "")

    def inner_steps(dtype):
        if fuse4 and multistep_plan(offsets_B, N, M, dtype, 4):
            return 4
        if multistep_plan(offsets_B, N, M, dtype, 2):
            return 2
        return 1

    def rung(dtype, npd, q):
        return dict(
            dA=A_dia.to(dtype), dB=B_dia.to(dtype),
            coeffs=np.asarray(coeffs, npd), qc=np.asarray(q, npd),
            scals=dict(sc_C=npd(2.0 / (hi - lo)),
                       sh_C=npd((hi + lo) / (hi - lo)),
                       scB=npd(2.0 / (b_hi - b_lo)),
                       shB=npd((b_hi + b_lo) / (b_hi - b_lo))),
            dtype=dtype, inner_steps=inner_steps(dtype))

    return dict(offsets_A=offsets_A, offsets_B=offsets_B,
                f64=rung(torch.float64, np.float64, qc),
                f32=rung(torch.float32, np.float32, qc_lo))


def _sparse_cheb_filter_host_fused_gen(ctx, Q, *, rung, n_coeffs=None):
    """One composite filter application rho(q(B~) A~) Q on rung "f32" or
    "f64" (counterpart of ``_sparse_cheb_filter_host_fused_gen``): Q is
    transposed once to a column-major (M, N) plane, ``cheb_gen_init`` and
    ``cheb_gen_chunk`` (``ops/cheb_gen.py``) run the whole series on it,
    and the accumulator is transposed back once. ``n_coeffs`` truncates
    the series (the rational filter's shorter f32-rung expansion)."""
    r = ctx[rung]
    coeffs = r["coeffs"]
    if n_coeffs is not None:
        coeffs = coeffs[:max(int(n_coeffs), 3)]
    trace.note("filter", steps=len(coeffs) - 1, inner=len(r["qc"]),
               body="fused_gen")
    ops = (r["dA"], ctx["offsets_A"], r["dB"], ctx["offsets_B"], r["qc"])
    q = Q.to(r["dtype"]).t().contiguous()
    carry = cheb_gen_init(*ops, q, coeffs[:2], r["scals"],
                          inner_steps=r["inner_steps"])
    del q
    carry = cheb_gen_chunk(*ops, carry, coeffs[2:], r["scals"],
                           inner_steps=r["inner_steps"])
    acc = carry[2]
    del carry                              # the T planes, before the copy
    return acc.t().contiguous()


def _sparse_cheb_filter_host(ctx, Q, *, rung, n_coeffs=None):
    """One filter application rho(C) Q by the UNFUSED recurrence on rung
    "f32" or "f64" (counterpart of ``_sparse_cheb_filter_host`` with
    ``_sparse_cheb_init_jit`` / ``_sparse_cheb_chunk_jit``): a host loop
    over the coefficients, each step one product of the rung's operator C
    (A~, or the composite q(B~) A~) and the torch glue of the three-term
    recurrence (``ops/chebfilter._cheb_init`` / ``make_cheb_stepper``), in
    the rung's dtype (complex64 / complex128 for a Hermitian operator).
    ``n_coeffs`` truncates the series (the rational filter's shorter
    f32-rung expansion). The JAX package's chunked dispatches bound the
    work per TPU dispatch; a host loop needs no such budget."""
    r = ctx[rung]
    coeffs = r["coeffs"] if n_coeffs is None else r["coeffs"][:n_coeffs]
    trace.note("filter", steps=len(coeffs) - 1, inner=r.get("inner", 0),
               body="unfused")
    carry = _cheb_init(r["apply"], r["lo"], r["hi"], Q.to(r["dtype"]),
                       coeffs)
    step = make_cheb_stepper(r["apply"], r["lo"], r["hi"])
    for ck in coeffs[2:]:
        carry = step(carry, ck)
    return carry[2]


def _backxform(apply_A, apply_B, dscale, Q, lam):
    """Congruence back-transform for B = D^1/2 B~ D^1/2 (B~ = I for a
    diagonal B): with s = D^-1/2, x_j = s y_j / ||s y_j|| and the ORIGINAL
    pencil's residual ||A x - lam B x|| / max(|lam|, 1) =
    ||(A~ y - lam B~ y) / s|| / (...). Q real or complex (a Hermitian
    pencil's basis); s and lam enter in Q's dtype."""
    s = dscale[:, None].to(Q.dtype)
    nrm = torch.linalg.vector_norm(s * Q, dim=0)
    nrm = torch.where(nrm > 0, nrm, torch.ones_like(nrm))
    X = (s * Q) / nrm[None, :]
    R = ((apply_A(Q) - apply_B(Q) * lam[None, :].to(Q.dtype))
         / (s * nrm[None, :]))
    res = torch.linalg.vector_norm(R, dim=0) / torch.clamp(lam.abs(), min=1.0)
    return X, res


def _sparse_cheb_interval(A, B, Emin, Emax, M0, fpm, *, hermitian,
                          device, Q0=None, contour=None,
                          route=False, mesh=None) -> FeastResult:
    """Polynomial-filtered FEAST for standard, positive-diagonal-B and
    sparse-SPD-B pencils, real symmetric or complex Hermitian (counterpart
    of the JAX package's ``_sparse_cheb_interval``, host-loop branch).
    ``contour``: realize that contour's rational filter as a Chebyshev
    series; ``route=True`` (the auto route) also builds the indicator and
    keeps the cheaper one, and reports an ineligible configuration as
    ChebInfeasible. The fused kernels carry an operator on at most 32
    diagonals, real or complex Hermitian (and a B on at most 32 for the
    SPD-B composite); every other operator runs the unfused recurrence
    (``_sparse_cheb_filter_host``), as the JAX package decides for a real
    one (``_fuse_base``, sparse.py:2027).
    ``mesh`` (a ``parallel/pfeast.py`` mesh, every rank calling): where
    M0 is a multiple of its rank count, each rank filters its own block
    of M0 / ranks columns (the recurrence is column-independent) and the
    blocks meet in one all-reduce before the replicated Rayleigh-Ritz;
    otherwise nothing is sharded."""
    elig_err = ChebInfeasible if route else ValueError
    fpm = _ensure_fpm(fpm)
    trace.solve_attrs(path="cheb")
    with trace.span("route") as route_span:
        with trace.span("route.coo", of="B"):
            b_kind, b_diag = _b_diagonal(B)
            if b_kind is None:
                b_kind, b_diag = _b_sparse_spd(B)
        if b_kind is None:
            raise elig_err(
                "solver='cheb' (polynomial filter) requires a standard "
                "problem (B=None/identity), a positive diagonal B (lumped "
                "mass), or a real symmetric positive-definite sparse B "
                "(consistent mass); indefinite/nonsymmetric pencils need the "
                "contour solvers (gmres/bicgstab)")
        is_complex = np.iscomplexobj(_peek_dtype(A))
        if hermitian is None:
            hermitian = is_complex
        if b_kind == "spd" and hermitian:
            raise elig_err(
                "solver='cheb' with a sparse SPD B currently supports real "
                "symmetric A (complex Hermitian A + sparse B: use the "
                "contour solvers)")
        f64 = _is_double(_peek_dtype(A).dtype)
        rdtype = np.float64 if f64 else np.float32
        tdtype = torch.float64 if f64 else torch.float32
        cdtype = np.complex128 if f64 else np.complex64
        work = np.dtype(cdtype if hermitian else rdtype)
        wdtype = _TORCH_DTYPE[work]
        lo_dtype = torch.complex64 if hermitian else torch.float32

        with trace.span("route.coo", of="A"):
            A_data, A_idx, shape = sparse_coo_arrays(A, work)
            N = shape[0]
            if b_kind in ("diagonal", "spd"):
                dscale = 1.0 / np.sqrt(b_diag.astype(np.float64))
                A_data = (A_data * (dscale[A_idx[:, 0]]
                                    * dscale[A_idx[:, 1]])).astype(work)
        if not 0 < M0 <= N:
            raise ValueError(f"M0 must be in 1..N={N}, got {M0}")
        if not Emax > Emin:
            raise ValueError(f"Emin={Emin} must be < Emax={Emax}")
        with trace.span("route.dia", of="A"):
            outA = bcoo_to_dia(A_data, A_idx, N)
        A_dia_np, offsets = outA if outA else (None, None)

        config = FeastConfig.from_fpm(fpm, dtype=cdtype)
        qinfo = qinfo_lo = qc = qc_lo = None
        offsets_B = None
        if b_kind == "spd":
            # unit-diagonal congruence of B and a polynomial inverse
            # q(B~) ~= B~^-1: the recurrence filters the composite q(B~) A~
            # while Rayleigh-Ritz and the residuals use the exact pencil
            with trace.span("route.coo", of="B"):
                B_data, B_idx, _ = sparse_coo_arrays(B, work)
                B_data = (B_data * (dscale[B_idx[:, 0]]
                                    * dscale[B_idx[:, 1]])).astype(work)
            with trace.span("route.dia", of="B"):
                outB = bcoo_to_dia(B_data, B_idx, N)
            B_dia_np, offsets_B = outB if outB else (None, None)
            try:
                with trace.span("route.bounds", of="B"):
                    b_lo, b_hi = _b_spd_bounds(B_data, B_idx, N, B_dia_np,
                                               offsets_B, device)
            except ValueError as e:
                if route:
                    raise ChebInfeasible(str(e)) from e
                raise
            inv_tol = float(np.clip(0.01 * config.tol, 1e-14, 1e-6))
            with trace.span("route.coeffs", which="inverse"):
                qc, qinfo = cheb_inverse_coeffs(b_lo, b_hi, inv_tol)
            # rung-adaptive inner inverse: the f32 rung's own rounding floor
            # (~sqrt(degree) eps_f32) only needs q to ~1e-5, about half the
            # inner degree of the f64 rung's
            with trace.span("route.coeffs", which="inverse_lo"):
                qc_lo, qinfo_lo = cheb_inverse_coeffs(b_lo, b_hi,
                                                      max(inv_tol, 1e-5))
            with trace.span("route.bounds", of="pencil"):
                a_lo, a_hi = gershgorin_interval(A_data, A_idx, N)
                lo, hi = binva_enclosure(a_lo, a_hi, b_lo, b_hi,
                                         max(qinfo["rel_err"],
                                             qinfo_lo["rel_err"]))
                # tighten the upper edge with a measured pencil eigenvalue
                # (the degree scales as sqrt(enclosure span)); 1.1x over
                # the Lanczos estimate, which converges from below, keeps
                # the spectrum inside. Operands with no DIA form take the
                # host Lanczos (None on failure: the quotient bound
                # stays), as in the JAX package.
                if offsets is not None and offsets_B is not None:
                    hi_e = _pencil_upper_edge_fast(A_dia_np, offsets,
                                                   B_dia_np, offsets_B, qc,
                                                   b_lo, b_hi, N, device)
                else:
                    hi_e = _pencil_upper_edge(A_data, A_idx, B_data, B_idx,
                                              N)
            if hi_e is not None and hi_e > max(float(Emax), 0.0):
                hi = min(hi, (1.1 + qinfo["rel_err"]) * hi_e)
        else:
            with trace.span("route.bounds", of="A"):
                lo, hi = gershgorin_interval(A_data, A_idx, N)
        # Ladder degree rule of the JAX package: a mixed-precision solve
        # spends >= 2 rungs, and a 1.5x-sharper indicator trades a top-rung
        # loop for ~constant total matvecs. Not for the SPD-B composite,
        # where every outer step carries the inner recurrence in B
        # (sparse.py:1845-1861).
        ladder_scale = (1.5 if (_mixed_enabled(config, device, f64)
                                and config.tol <= 1e-6 and b_kind != "spd")
                        else 1.0)
        # FEAST_CHEB_DEGREE (config.cheb_degree > 0) fixes the indicator's
        # degree and caps the rational realization's
        user_cap = int(config.cheb_degree or 0)
        cap_kw = {"cap": user_cap} if user_cap > 0 else {}
        if contour is not None:
            if route:
                # Cost model: rational vs indicator, work = degree x
                # expected loops (~3 rational, ~5 indicator), on the
                # UNSCALED indicator degree (a pinned degree is never
                # scaled); a cap-bound indicator that barely decays outside
                # is refused.
                rat = ind = None
                rat_err = None
                try:
                    with trace.span("route.coeffs", which="rational"):
                        rat = rational_filter_cheb_coeffs(
                            contour.Zne, contour.Wne, lo, hi,
                            float(Emin), float(Emax), **cap_kw)
                except ChebInfeasible as e:
                    # its message only: the exception's traceback holds
                    # this frame, and a frame in a reference cycle keeps
                    # the solve's device tensors until a full collection
                    rat_err = str(e)
                try:
                    with trace.span("route.coeffs", which="indicator"):
                        ind = build_cheb_filter_coeffs(
                            lo, hi, float(Emin), float(Emax),
                            degree=user_cap or None,
                            degree_scale=ladder_scale)
                    if ind[1]["outside_at_1w"] > 0.25 * ind[1]["inside_min"]:
                        ind = None
                except ValueError:
                    ind = None
                if rat is None and ind is None:
                    raise ChebInfeasible(
                        f"neither polynomial filter resolves this "
                        f"configuration ({rat_err})")
                ind_div = 1.0 if user_cap else ladder_scale
                if rat is not None and (ind is None
                                        or 3 * rat[1]["degree"]
                                        <= 5 * ind[1]["degree"] / ind_div):
                    coeffs, cinfo = rat
                else:
                    coeffs, cinfo = ind
            else:
                with trace.span("route.coeffs", which="rational"):
                    coeffs, cinfo = rational_filter_cheb_coeffs(
                        contour.Zne, contour.Wne, lo, hi, float(Emin),
                        float(Emax), **cap_kw)
        else:
            try:
                with trace.span("route.coeffs", which="indicator"):
                    coeffs, cinfo = build_cheb_filter_coeffs(
                        lo, hi, float(Emin), float(Emax),
                        degree=user_cap or None, degree_scale=ladder_scale)
            except ValueError as _e:
                if route:
                    raise ChebInfeasible(str(_e)) from _e
                raise
        kind = "rational" if cinfo.get("kind") == "rational" else "indicator"
        route_span.set(b_kind=b_kind, filter=kind,
                       degree=int(cinfo["degree"]))
        if config.print_level >= 1:
            extra = (f" B-inverse degree={qinfo['degree']} "
                     f"(kappa={qinfo['kappa']:.2f})" if qinfo else "")
            kindname = "contour-poly" if kind == "rational" else "cheb"
            print(f"feast {kindname} filter: degree={cinfo['degree']} "
                  f"enclosure=[{lo:.3g},{hi:.3g}] "
                  f"outside@1w={cinfo['outside_at_1w']:.2e}{extra}",
                  flush=True)
        if config.mode == 2:
            # the unfused recurrence in the work dtype, no ladder, whatever
            # operator the fused kernels would carry (the JAX package's
            # ``_sparse_cheb_filter_host`` on the full series)
            opA = _operator(A_data, A_idx, A_dia_np, offsets, N, wdtype,
                            device)
            if b_kind == "spd":
                opA = make_apply_binv_a(opA, _operator(
                    B_data, B_idx, B_dia_np, offsets_B, N, wdtype, device),
                    b_lo, b_hi, qc)
            ctx = {"f64": dict(apply=opA, lo=lo, hi=hi, dtype=wdtype,
                               coeffs=coeffs)}
            return _stochastic_estimate_result(
                lambda V: _sparse_cheb_filter_host(ctx, V, rung="f64"),
                N, fpm, work, device)

        # rung-truncated series for the f32 rung (rational filters only)
        n_lo = (int(cinfo["degree_lo"]) + 1
                if cinfo.get("degree_lo") else None)
        rung_top = "f64" if f64 else "f32"
        use_lp = _mixed_enabled(config, device, f64)
        fused = offsets is not None and (b_kind != "spd"
                                         or offsets_B is not None)
        block = None
        if mesh is not None:
            from ..parallel.pfeast import _column_block
            block = _column_block(mesh, M0)
        M_loc = M0 if block is None else block[1] - block[0]
        with trace.span("route.upload"):
            if fused:
                # complex diagonals for a Hermitian operator: the fused
                # context's complex rungs
                A_dia = _upload(torch.as_tensor(A_dia_np, dtype=wdtype),
                                device)

                def apply_A(X):
                    return dia_matvec(A_dia, offsets, X)

                if b_kind == "spd":
                    B_dia = _upload(torch.as_tensor(B_dia_np, dtype=tdtype),
                                    device)
                    # the f32 rung runs the shorter inverse, unless f32 is
                    # the top rung
                    ctx = _cheb_gen_context(A_dia, offsets, B_dia, offsets_B,
                                            coeffs, lo, hi, b_lo, b_hi, qc,
                                            qc_lo if f64 else qc, M_loc)
                    filt = _sparse_cheb_filter_host_fused_gen

                    def apply_B(X):
                        return dia_matvec(B_dia, offsets_B, X)
                else:
                    ctx = _cheb_fused_context(A_dia, offsets, coeffs, lo, hi,
                                              M_loc)
                    filt = _sparse_cheb_filter_host_fused
            else:
                # the unfused recurrence (an operand with no DIA form):
                # each rung's operator in its own dtype, the composite
                # q(B~) A~ on them for a sparse SPD B (the shorter inverse
                # on the f32 rung, unless f32 is the top rung)
                def operators(dtype):
                    opA = _operator(A_data, A_idx, A_dia_np, offsets, N,
                                    dtype, device)
                    opB = None if b_kind != "spd" else _operator(
                        B_data, B_idx, B_dia_np, offsets_B, N, dtype, device)
                    return opA, opB

                def rung(dtype, ops, q):
                    # lo, hi and the coefficients enter the recurrence in
                    # its operand's precision (ops/chebfilter._map_scalars)
                    opA, opB = ops
                    op = opA if opB is None else make_apply_binv_a(
                        opA, opB, b_lo, b_hi, q)
                    return dict(apply=op, lo=lo, hi=hi, dtype=dtype,
                                coeffs=coeffs,
                                inner=0 if opB is None else len(q))

                top_ops = operators(wdtype)
                apply_A = top_ops[0]
                if b_kind == "spd":
                    apply_B = top_ops[1]
                ctx = {rung_top: rung(wdtype, top_ops, qc)}
                if use_lp:
                    ctx["f32"] = rung(lo_dtype, operators(lo_dtype), qc_lo)
                filt = _sparse_cheb_filter_host
        if block is not None:
            from ..parallel.pfeast import _column_sharded
            filt = _column_sharded(filt, block)
        if b_kind != "spd":
            def apply_B(X):      # identity: a diagonal B is congruenced away
                return X

        lp_avail = use_lp
        # switch to the top rung at 2x the predicted f32 floor
        # sqrt(degree) * eps_f32 (or 30 tol, whichever is larger)
        lp_switch = max(2.0 * np.sqrt(float(cinfo["degree"])) * 6e-8,
                        30.0 * float(config.tol))
        if qinfo_lo is not None:
            # SPD-B composite: the shorter f32-rung inverse's own error, not
            # the recurrence's rounding, sets that rung's floor
            lp_switch = max(lp_switch, 2.0 * float(qinfo_lo["rel_err"]))

    with trace.span("q0") as q0_span:
        # as the JAX package ships it on the ladder: the seeded subspace's
        # f32 bits, widened (Gaussian noise has no information in its f64
        # mantissa tail, and both packages then start from one subspace);
        # on a card they are drawn there, bit for bit the host's
        f32_start = (use_lp and config.mode != 1 and Q0 is None
                     and int(fpm[5]) == 0 and not hermitian)
        if f32_start and work == np.float64 and device.type == "cuda":
            q0_span.set(draw="card")
            Q0_t = initial_subspace(fpm, Q0, N, M0, work, f32_bits_on=device)
        else:
            q0_span.set(draw="host")
            q0_np = initial_subspace(fpm, Q0, N, M0, work)
            if f32_start:
                q0_np = q0_np.astype(np.float32)
            with trace.span("q0.upload"):
                Q0_t = _upload(torch.as_tensor(q0_np), device, wdtype)
            del q0_np

    if config.mode == 1 or not use_lp:
        # mixed precision off, and the subspace-only mode: the JAX
        # package's fused run (``_sparse_cheb_jit``), i.e. the core's
        # semantics: no stall exit and no best state, at most fpm[4] + 1
        # loops, then the spurious verification on the same filter
        state = feast_hermitian_core(
            apply_A, apply_B, lambda Q: filt(ctx, Q, rung=rung_top), Q0_t,
            float(Emin), float(Emax), tol=config.tol,
            max_loops=config.max_loops,
            convergence_criterion=config.convergence_criterion,
            subspace_only=(config.mode == 1))
        del Q0_t
    else:
        # the precision ladder's host loop (mixed precision on)
        update = make_rayleigh_ritz_update(
            apply_A, apply_B, float(Emin), float(Emax), tol=config.tol,
            convergence_criterion=config.convergence_criterion)
        state = init_hermitian_state(Q0_t)
        del Q0_t
        eps_best, eps_prev, best_state, stall_loops = np.inf, np.inf, None, 0
        gm_prev = np.inf
        for _loop in range(config.max_loops + 1):
            _t0 = time.perf_counter()
            rung = "f32" if use_lp else rung_top
            n_coeffs = n_lo if rung == "f32" else None
            with trace.span("loop", index=_loop, rung=rung):
                # the Rayleigh-Ritz update builds the next basis from
                # Qproj alone: drop the old (N, M0) subspace while the
                # filter runs
                Q_in = state.Q
                state = state._replace(Q=None)
                # the filter records its A-products on the block (the
                # series length less one, as it truncates it) and the
                # composite's inner series length
                with trace.span("filter", rung=rung, columns=M_loc):
                    Qp = filt(ctx, Q_in, rung=rung,
                              n_coeffs=n_coeffs).to(wdtype)
                Q_in = None
                with trace.span("rr"):
                    state = update(state, Qp)
                Qp = None
                # one host fetch per loop: flag, epsout, residuals, mask
                with trace.span("fetch"):
                    conv = bool(state.converged)
                    eps_now = float(state.epsout)
                    res_h = state.res.cpu().numpy()
                    ins_h = state.inside.cpu().numpy()
                M_now = int(np.sum(ins_h))
                if config.print_level >= 1:
                    print(f"feast cheb loop {_loop}: epsout={eps_now:.2e} "
                          f"M={M_now} ({rung} recurrence, "
                          f"{time.perf_counter() - _t0:.1f}s)", flush=True)
                if eps_now < eps_best and M_now > 0 and not use_lp:
                    eps_best, best_state = eps_now, state
                if conv:
                    break
                # a loop stalls only when NEITHER the max nor the geometric
                # mean of the plausible residuals improves
                pl = ins_h & (res_h < SPURIOUS_RES)
                gm_now = (float(np.exp(np.mean(np.log(np.maximum(
                    res_h[pl], 1e-300))))) if pl.any() else np.inf)
                stalled = _loop >= 1 and eps_now >= 0.5 * eps_prev \
                    and gm_now >= 0.7 * gm_prev
                # ladder: a stall (or reaching the f32 floor) switches f32
                # -> top rung; only a stall on the top rung counts toward
                # giving up
                if use_lp and (stalled or eps_now <= lp_switch):
                    use_lp = False
                    stall_loops = 0
                    if config.print_level >= 1:
                        print(f"feast cheb: recurrence switching to "
                              f"{rung_top}", flush=True)
                elif stalled:
                    stall_loops += 1
                    if stall_loops >= 2:
                        break
                else:
                    stall_loops = 0
                eps_prev, gm_prev = eps_now, gm_now
        if best_state is not None:
            state = best_state
        # spurious-verify filter pass: rho = ||P q|| against 0.25, so the
        # f32 rung's noise is irrelevant under the mixed schedule
        vrung = "f32" if lp_avail else rung_top
        n_coeffs = n_lo if vrung == "f32" else None
        with trace.span("verify"):
            with trace.span("filter", rung=vrung, columns=M_loc):
                Qp = filt(ctx, state.Q, rung=vrung,
                          n_coeffs=n_coeffs).to(wdtype)
            state = verify_spurious_from(state, Qp)
            Qp = None

    with trace.span("result"):
        with trace.span("fetch"):
            conv = bool(state.converged)
            lam = state.lam.cpu().numpy()
            res = state.res.cpu().numpy()
            inside = state.inside.cpu().numpy()
            epsout = float(state.epsout)
        Q = state.Q
        if b_kind in ("diagonal", "spd"):
            Q, res_t = _backxform(
                apply_A, apply_B,
                _upload(torch.as_tensor(dscale, dtype=tdtype), device),
                Q, state.lam)
            res = res_t.cpu().numpy()
            epsout = float(res[inside].max()) if inside.any() else epsout
        # Post-verify SUCCESS upgrade: every genuine pair below tol meets
        # the convergence contract even when junk columns pinned the loop's
        # flag.
        if (not conv and inside.any()
                and float(np.max(res[inside])) <= config.tol):
            conv = True
        info = FeastError.SUCCESS if conv else FeastError.NO_CONVERGENCE
        return _trim(FeastResult, lam, Q, res, inside, int(info), epsout,
                     int(state.loop) - 1, inner_ok=bool(state.inner_ok))


# --------------------------------------------------------------------------
# The Krylov contour engine: batched GMRES / BiCGStab shifted solves per
# contour node, multigrid or Jacobi preconditioned, inside the fused FEAST
# core (the JAX package's off-TPU path, ``_sparse_hermitian_jit``).
# --------------------------------------------------------------------------

def _solver_fn(name):
    if name in ("gmres", ":gmres", None):
        return "gmres"
    if name in ("bicgstab", ":bicgstab"):
        return "bicgstab"
    if name in ("cg", ":cg"):
        raise ValueError(
            "CG is not valid for FEAST shifted systems (z B - A is never "
            "Hermitian positive definite for complex z); use gmres/bicgstab")
    raise ValueError(f"Unknown iterative solver {name!r}")


def _csr_matvec(A, X):
    """A @ X for a torch CSR matrix and (N, K) or (g, N, K) X, real or
    complex: one sparse product on an (N, cols) operand. A real CSR takes a
    complex X through its real view (a complex (N, K) tensor is a real
    (N, 2K) one); a complex CSR takes a complex X as it is (a real X is
    promoted first)."""
    if A.is_complex():
        Xr = X.to(A.dtype)
    else:
        Xr = torch.view_as_real(X.contiguous()) if X.is_complex() else X
        Xr = Xr.reshape(*X.shape[:-1], -1)
    if Xr.dim() == 3:
        g, N, c = Xr.shape
        Y = (A @ Xr.permute(1, 0, 2).reshape(N, g * c)).reshape(N, g, c)
        Y = Y.permute(1, 0, 2).contiguous()
    else:
        Y = A @ Xr.contiguous()
    if X.is_complex() and not A.is_complex():
        return torch.view_as_complex(Y.reshape(*X.shape, 2))
    return Y


def _make_apply(csr, dia, offsets):
    """Matvec closure on (N, K) or (g, N, K) operands, real or complex
    (counterpart of ``_make_apply``). An operator on at most 32 diagonals
    applies through the DIA kernels (``ops/dia.py``: one launch for any
    real / complex combination), a node group of one through the
    unbatched entry; a wider one through a torch CSR product, the
    counterpart of the JAX package's BCOO product."""
    if offsets is None:
        return lambda X: _csr_matvec(csr, X)

    def apply(X):
        X = X.contiguous()
        if X.dim() == 3 and X.shape[0] == 1:
            return dia_matvec_any(dia, offsets, X[0]).unsqueeze(0)
        return dia_matvec_any(dia, offsets, X)
    return apply


def _operator(data, idx, dia, offsets, N, dtype, device):
    """The operator of host COO (data, idx) in ``dtype`` on ``device``:
    its DIA diagonals ``dia`` on the DIA kernels where it has a DIA form
    (``offsets``), else a torch CSR product."""
    if offsets is not None:
        return _make_apply(None, _upload(torch.as_tensor(dia), device, dtype),
                           offsets)
    with warnings.catch_warnings():    # "CSR support is in beta"
        warnings.simplefilter("ignore", UserWarning)
        idx = np.asarray(idx, np.int64)
        csr = torch.sparse_coo_tensor(
            torch.as_tensor(idx.T), torch.as_tensor(data).to(dtype),
            (N, N)).coalesce().to_sparse_csr()
        for part in (csr.values(), csr.crow_indices(), csr.col_indices()):
            trace.count_h2d(part, device)
        csr = csr.to(device)
    return _make_apply(csr, None, None)


def _unpack_stencil(mg):
    """Hashable tuple -> GridStencil (see _pack_stencil); a packed tuple may
    carry the planned V-cycle level count as a 4th element."""
    if mg is None:
        return None
    disps, coeffs, grid = mg[:3]
    return GridStencil(np.asarray(disps, np.int64), np.asarray(coeffs), grid)


def _plan_mg(mg_A, mg_B, re_max, precond_base, user_precond):
    """The multigrid decision (needs the search region's real upper edge
    re_max): (precond, mg_A', mg_B') with the planned level count appended
    to mg_A'. Falls back, with the JAX package's warning, to the
    diagonal-dominance-based preconditioner when no feasible V-cycle
    exists."""
    if user_precond not in (None, "mg"):
        return user_precond, None, None
    if mg_A is not None:
        n_lv = plan_mg_levels(_unpack_stencil(mg_A), _unpack_stencil(mg_B),
                              re_max)
        if n_lv is not None:
            return "mg", mg_A + (int(n_lv),), mg_B
    if user_precond == "mg":
        warnings.warn(
            "precond='mg' requested but no feasible multigrid hierarchy "
            "exists for this operator/search region (operator is not a "
            "constant tensor-grid stencil, or the shifted problem is too "
            "indefinite for the coarse-grid budget); falling back",
            RuntimeWarning)
    return precond_base, None, None


def _pack_stencil(st):
    """GridStencil -> hashable nested tuples."""
    if st is None:
        return None
    return (tuple(tuple(int(x) for x in d) for d in st.disps),
            tuple(complex(c) if np.iscomplexobj(st.coeffs) else float(c)
                  for c in st.coeffs),
            tuple(st.grid))


def _guess_grid(offsets, N):
    """Candidate tensor-grid shapes for a DIA offset pattern (row-major),
    largest dimension first; detect_grid_stencil validates."""
    if offsets is None:
        return []
    pos = sorted({int(d) for d in offsets if d > 1})
    cands = []
    for s2 in pos:                                     # 3D: strides (s2*?, s2, s1)
        for s1 in pos:
            if s1 < s2 and s2 % s1 == 0 and N % s2 == 0 \
                    and s2 // s1 >= 3 and N // s2 >= 3 and s1 >= 3:
                cands.append((N // s2, s2 // s1, s1))
    for s in pos:                                      # 2D: strides (s, 1)
        if N % s == 0 and N // s >= 3 and s >= 3:
            cands.append((N // s, s))
    if not pos and all(abs(int(d)) <= 1 for d in offsets):
        cands.append((N,))                             # 1D tridiagonal
    return cands


def _structured_forms(A_data, A_idx, B_data, B_idx, N, standard, dtype,
                      grid=None):
    """DIA structure, diagonals and preconditioner choice (host numpy):
    (A_dia, offsets_A, B_dia, offsets_B, diagA, diagB, precond, mg_A,
    mg_B), DIA arrays (nd, N) or (0, N) dummies with offsets None when
    unstructured. precond is "jacobi" when A is diagonally dominant, else
    "none"; constant stencils on a tensor grid (``grid`` given, or guessed
    from the offsets) make multigrid available as packed stencils, which
    ``_plan_mg`` then accepts or refuses for the search region."""
    outA = bcoo_to_dia(A_data, A_idx, N)
    A_dia, offsets_A = outA if outA else (np.zeros((0, N), dtype), None)
    if standard:
        B_dia, offsets_B = np.zeros((0, N), dtype), None
    else:
        outB = bcoo_to_dia(B_data, B_idx, N)
        B_dia, offsets_B = outB if outB else (np.zeros((0, N), dtype), None)
    maskA = A_idx[:, 0] == A_idx[:, 1]
    diagA = np.zeros(N, dtype)
    np.add.at(diagA, A_idx[maskA, 0], A_data[maskA])
    if standard:
        diagB = np.ones(N, dtype)
    else:
        maskB = B_idx[:, 0] == B_idx[:, 1]
        diagB = np.zeros(N, dtype)
        np.add.at(diagB, B_idx[maskB, 0], B_data[maskB])
    # Jacobi only helps a diagonally dominant pencil (the shift only adds
    # to the diagonal)
    rowsum = np.zeros(N, np.float64)
    np.add.at(rowsum, A_idx[:, 0], np.abs(A_data))
    offdiag = rowsum - np.abs(diagA)
    dominant = np.mean(np.abs(diagA) >= 0.5 * offdiag) > 0.9
    precond = "jacobi" if dominant else "none"
    mg_A = mg_B = None
    if offsets_A is not None and (standard or offsets_B is not None):
        cands = [tuple(int(g) for g in grid)] if grid is not None \
            else _guess_grid(offsets_A, N)
        for cand in cands:
            stA = detect_grid_stencil(A_dia, offsets_A, cand)
            if stA is None:
                continue
            if standard:
                mg_A, mg_B = _pack_stencil(stA), None
                break
            stB = detect_grid_stencil(B_dia, offsets_B, cand)
            if stB is not None:
                mg_A, mg_B = _pack_stencil(stA), _pack_stencil(stB)
                break
    return (A_dia.astype(dtype), offsets_A, B_dia.astype(dtype), offsets_B,
            diagA, diagB, precond, mg_A, mg_B)


def _narrow_band(offsets, N, max_half_bw=16, max_n=16384):
    """(kl, ku) when a DIA offset pattern fits the narrow band the JAX
    package leaves to its banded direct engine, else None."""
    if offsets is None or len(offsets) == 0:
        return None
    kl = max((-d for d in offsets if d < 0), default=0)
    ku = max((d for d in offsets if d > 0), default=0)
    if max(kl, ku) > max_half_bw or N > max_n:
        return None
    return int(kl), int(ku)


def _contour_poly_default():
    """The auto route's polynomial realization (FEAST_CONTOUR_POLY=0
    restores the always-Krylov contour engine)."""
    return os.environ.get("FEAST_CONTOUR_POLY", "1") not in ("0", "")


def _col_sq(X, axis_name=None):
    """Squared column norms over the row axis, summed over the ranks of
    ``axis_name`` where N is sharded over them."""
    if axis_name is None:
        return torch.linalg.vector_norm(X, dim=-2).square()
    import torch.distributed as dist
    out = torch.sum((X.conj() * X).real, dim=-2)
    dist.all_reduce(out, group=axis_name)
    return out


def _make_sparse_solve_all(apply_A_c, apply_B_c, standard, *, solver,
                           solver_tol, solver_maxiter, solver_restart,
                           diagA=None, diagB=None, precond="jacobi",
                           col_block=None, flag_tol=None, mg_A=None,
                           mg_B=None, mixed=False, apply_A_lo=None,
                           apply_B_lo=None, ir_max=5, mg_opts=(2, 2, 0.8, 1),
                           group_max=2, device="cpu", record=None,
                           complex_sum=False, axis_name=None,
                           sync_axes=None, prec_gather_axis=None):
    """filter_partial(Z, W, rhs, Q, lam, tol_hint) -> (sum_e Re(W_e X_e),
    conv) with X_e = (z_e B - A)^-1 rhs (counterpart of
    ``_make_sparse_solve_all``); ``complex_sum``: the complex sum
    sum_e W_e X_e (complex work: the mirrored node set of a Hermitian
    pencil, the full contour of a general one).

    The nodes are solved in groups of g = min(ne, group_max), each group
    one batched solve on a (g, N, cols) carry (a group of one runs the
    unbatched kernels: the JAX package's scan over nodes; a larger group is
    its node-vmapped dispatch); the columns in chunks of ``col_block``,
    zero-padded (the Krylov basis is (m+1) g N cols). Preconditioner
    "mg" (a V-cycle per node from the packed stencils), "jacobi" or
    "none". Mixed precision (``mixed``): complex64 Krylov on the
    column-normalised residual inside an iterative refinement of the
    complex128 iterate, a correction kept per column only where the true
    residual fell, stopping after ``ir_max`` steps, at the target, or
    after two consecutive steps with no column halving its residual (the
    JAX package carries that iterate as (re, im) float64 pairs for the
    TPU; the math is the same).

    ``record`` (a list) receives one dict per Krylov call (op "gmres" or
    "bicgstab", nodes, dtype, trips, restart) and per batch of shifted
    applications outside one (op "shift", nodes, dtype, count): the
    solve's accounting of its operator applications
    (:func:`krylov_dia_launches`).

    The JAX package's sharding hooks, for N split over the ranks of a
    process group (``parallel/pfeast.py``'s model axis): ``axis_name`` (that
    group: the Krylov contractions and the refinement's residual norms are
    summed over it), ``sync_axes`` (the group whose ranks run the same
    number of Krylov and refinement trips: the refinement goes on while
    any of them wants to) and ``prec_gather_axis`` (the group the V-cycle
    gathers its rows over: ``parallel/pfeast._gather_rows_prec``)."""
    from ..ops.gmres import _any

    def note(**ev):
        if record is not None:
            record.append(ev)

    def apply_shift(z, X):
        BX = X if standard else apply_B_c(X)
        return z[:, None, None] * BX - apply_A_c(X)

    def apply_shift_lo(z_lo, X):
        BX = X if standard else apply_B_lo(X)
        return z_lo[:, None, None] * BX - apply_A_lo(X)

    # the attainable c64 GMRES floor is ~eps_c64 kappa ~ 1e-5: aim there
    # and let the refinement steps multiply the accuracy
    lo_tol = max(float(solver_tol), 2e-5) if mixed else float(solver_tol)

    def _eff_tol(tol_hint):
        """The hint clamped to [solver_tol, max(solver_tol,
        VERIFY_FILTER_TOL)]."""
        if tol_hint is None:
            return float(solver_tol)
        hi = max(float(solver_tol), VERIFY_FILTER_TOL)
        return float(min(max(float(tol_hint), float(solver_tol)), hi))

    # the refinement's inner solves keep their restart within the
    # iteration budget (the JAX package's pair path does the same)
    restart = min(int(solver_restart), int(solver_maxiter)) if mixed \
        else int(solver_restart)

    def krylov(apply_op, rhs, tol, prec, x0=None):
        if solver == "gmres":
            X, info = gmres_block(apply_op, rhs, tol=tol, restart=restart,
                                  maxiter=solver_maxiter, apply_prec=prec,
                                  x0=x0, flag_tol=flag_tol,
                                  axis_name=axis_name, sync_axes=sync_axes)
        else:
            X, info = bicgstab_block(apply_op, rhs, tol=tol,
                                     maxiter=solver_maxiter,
                                     apply_prec=prec, x0=x0,
                                     flag_tol=flag_tol, axis_name=axis_name,
                                     sync_axes=sync_axes)
        note(op=solver, nodes=rhs.shape[0], dtype=str(rhs.dtype),
             trips=info.trips, restart=restart)
        return X, info

    def _guard_guess(X0g, rhs, apply_fn):
        """Keep a warm-start guess per column only where it beats the zero
        iterate (one operator application)."""
        R0 = rhs - apply_fn(X0g)
        note(op="shift", nodes=X0g.shape[0], dtype=str(X0g.dtype), count=1)
        n_g2, n_b2 = _col_sq(R0, axis_name), _col_sq(rhs, axis_name)
        good = n_g2 < n_b2
        return (torch.where(good[:, None, :], X0g, 0.0),
                torch.sqrt(torch.minimum(n_g2, n_b2)))

    def solve_cols(z, rhs, prec, X0g=None, tol_hint=None):
        """The g nodes' shifted solves on one column chunk: (X (g, N, K),
        conv (g, K))."""
        g = z.shape[0]
        rhs = rhs.expand(g, *rhs.shape)
        tol_eff = _eff_tol(tol_hint)
        if not mixed:
            x0 = None
            if X0g is not None:
                x0, _ = _guard_guess(X0g, rhs, lambda V: apply_shift(z, V))
            X, info = krylov(lambda V: apply_shift(z, V), rhs, tol_eff,
                             prec, x0=x0)
            return X, info.converged
        hi, lo = rhs.dtype, torch.complex64
        z_lo = z.to(lo)
        nrm = torch.sqrt(_col_sq(rhs, axis_name))
        scale = torch.clamp(nrm, min=1.0)
        target = tol_eff * scale
        lo_eff = lo_tol if tol_hint is None else max(tol_eff, 2e-5)
        X, rn = torch.zeros_like(rhs), nrm
        if X0g is not None:
            X, rn = _guard_guess(X0g, rhs, lambda V: apply_shift(z, V))
        stall = torch.zeros(g, dtype=torch.int64, device=rhs.device)
        go = torch.any(rn > target, dim=-1) & (ir_max > 0)
        it = 0
        while _any(go.any(), sync_axes):
            R = rhs - apply_shift(z, X)
            safe = torch.where(rn > 0, rn, 1.0)[:, None, :]
            dX, _ = krylov(lambda V: apply_shift_lo(z_lo, V),
                           (R / safe).to(lo), lo_eff, prec)
            del R
            X_new = X + dX.to(hi) * safe
            del dX
            rn_new = torch.sqrt(_col_sq(rhs - apply_shift(z, X_new),
                                        axis_name))
            note(op="shift", nodes=g, dtype=str(hi), count=2)
            improved = rn_new < rn
            X_upd = torch.where(improved[:, None, :], X_new, X)
            rn_best = torch.minimum(rn_new, rn)
            # two consecutive < 2x steps before giving up (one is legal
            # near-breakdown behaviour of the c64 inner solve)
            stalled = ~torch.any(rn_new < 0.5 * rn, dim=-1)
            stall_new = torch.where(stalled, stall + 1, 0)
            go_new = ((it + 1 < ir_max) & torch.any(rn_best > target, dim=-1)
                      & (stall_new < 2))
            X = torch.where(go[:, None, None], X_upd, X)
            rn = torch.where(go[:, None], rn_best, rn)
            stall = torch.where(go, stall_new, stall)
            go = go & go_new
            it += 1
        cert = max(tol_eff, flag_tol) if flag_tol is not None else tol_eff
        return X, rn <= 10.0 * cert * scale

    stA, stB = _unpack_stencil(mg_A), _unpack_stencil(mg_B)
    mg_n_levels = mg_A[3] if (mg_A is not None and len(mg_A) > 3) else None
    nu_pre, nu_post, mg_omega, mg_cycles = mg_opts
    dA_t = None if diagA is None else torch.as_tensor(diagA).to(device)
    dB_t = None if (diagB is None or standard) else \
        torch.as_tensor(diagB).to(device)

    def node_prec(z):
        """The preconditioner of the g nodes of shifts z (g,)."""
        dt = torch.complex64 if mixed else z.dtype
        if precond == "mg" and stA is not None:
            vcycle = make_shifted_vcycle(
                stA, stB, z.to(dt), dtype=dt, n_levels=mg_n_levels,
                nu_pre=nu_pre, nu_post=nu_post, omega=mg_omega,
                n_cycles=mg_cycles, device=device)
            if prec_gather_axis is None:
                return vcycle
            from ..parallel.pfeast import _gather_rows_prec
            return _gather_rows_prec(vcycle, prec_gather_axis)
        if precond == "jacobi" and dA_t is not None:
            zc = z.to(dt)[:, None]
            dshift = (zc - dA_t.to(dt)) if dB_t is None \
                else (zc * dB_t.to(dt) - dA_t.to(dt))
            dsafe = torch.where(dshift.abs() > 1e-30, dshift, 1.0)[:, :, None]
            return lambda X: X / dsafe
        return None

    def _chunked(solve_fn, rhs, aux=None):
        """solve_fn over column chunks of rhs (N, K) (and of aux (g, N, K),
        the warm-start guesses), the last chunk zero-padded to col_block
        (a zero column is done at once under the per-column flags)."""
        K = rhs.shape[1]
        cb = col_block if (col_block and col_block < K) else None
        if cb is None:
            return solve_fn(rhs, aux)
        outs, convs = [], []
        for c0 in range(0, K, cb):
            w = min(cb, K - c0)
            r = torch.zeros((rhs.shape[0], cb), dtype=rhs.dtype,
                            device=rhs.device)
            r[:, :w] = rhs[:, c0:c0 + w]
            a = None
            if aux is not None:
                a = torch.zeros(aux.shape[:-1] + (cb,), dtype=aux.dtype,
                                device=aux.device)
                a[..., :w] = aux[..., c0:c0 + w]
            X, conv = solve_fn(r, a)
            outs.append(X[..., :w])
            convs.append(conv[..., :w])
            del X, r, a
        return torch.cat(outs, dim=-1), torch.cat(convs, dim=-1)

    def filter_partial(Z, W, rhs, Q=None, lam=None, tol_hint=None):
        """Z, W: (ne,) complex node and weight tensors; rhs (N, K) complex.
        Q, lam: optional Ritz warm-start data (per node the guess is
        Q diag(1/(z - lam)), guarded per column); tol_hint: optional
        adaptive inner tolerance for every node's solve."""
        warm = Q is not None and lam is not None
        ne = Z.shape[0]
        g = max(1, min(ne, int(group_max)))
        acc = torch.zeros(rhs.shape, dtype=rhs.dtype if complex_sum
                          else rhs.real.dtype, device=rhs.device)
        convs = []
        for b0 in range(0, ne, g):
            zg, wg = Z[b0:b0 + g], W[b0:b0 + g]
            prec = node_prec(zg)
            X0g = None
            if warm:
                s = 1.0 / (zg[:, None] - lam.to(rhs.dtype)[None, :])
                X0g = Q.to(rhs.dtype)[None] * s[:, None, :]
            X, conv = _chunked(
                lambda b, a: solve_cols(zg, b, prec, X0g=a,
                                        tol_hint=tol_hint), rhs, X0g)
            del X0g
            for i in range(zg.shape[0]):        # the JAX package's order
                acc += wg[i] * X[i] if complex_sum \
                    else (wg[i] * X[i]).real
            convs.append(conv.reshape(-1))
            del X
        return acc, torch.all(torch.cat(convs))

    return filter_partial


_NODE_SETS = ("half", "mirrored", "full")


def _sparse_ops(A_data, A_idx, B_data, B_idx, A_dia, B_dia, diagA, diagB,
                Zne, Wne, *, N, config, standard, solver, solver_tol,
                solver_maxiter, solver_restart, offsets_A, offsets_B,
                precond, mg_A=None, mg_B=None, device, f64, record=None,
                nodes="half", make_operator=None, axis_name=None,
                sync_axes=None, prec_gather_axis=None):
    """(apply_A, apply_B, filter_apply) of the Krylov engine (counterpart
    of ``_sparse_ops``): the operators on the solve's device (DIA kernels
    or CSR) and the contour filter with the Ritz warm start and the
    adaptive inner tolerance as ``FeastConfig`` has them. ``nodes`` fixes
    the node set, the work type and the sum: "half" (a real symmetric
    pencil) the half contour in real work, filter_apply(Q, lam, tol_hint)
    = (Re sum_e 2 W_e (z_e B - A)^-1 B Q, all inner solves converged);
    "mirrored" (a Hermitian one) the node set Zall = [Z, conj Z], Wall =
    [W, conj W] in complex work (complex64 / complex128) with the complex
    sum; "full" (a general one) the full contour as given in complex work,
    with the complex sum sum_e W_e (z_e B - A)^-1 B Q.

    The model axis of ``parallel/pfeast.py`` passes ``make_operator``
    (dia, offsets, dtype) -> apply, its halo products on the rank's rows
    (N is then the rank's row count, and diagA / diagB its rows), with the
    sharding hooks of ``_make_sparse_solve_all``."""
    if nodes not in _NODE_SETS:
        raise ValueError(f"nodes must be one of {_NODE_SETS}, got {nodes!r}")
    complex_work = nodes != "half"
    rdt = torch.float64 if f64 else torch.float32
    cdt = torch.complex128 if f64 else torch.complex64
    wdt = cdt if complex_work else rdt
    lo_dt = torch.complex64 if complex_work else torch.float32
    mixed = _mixed_enabled(config, device, f64)

    def operator(data, idx, dia, offsets, dtype):
        if make_operator is not None:
            return make_operator(dia, offsets, dtype)
        return _operator(data, idx, dia, offsets, N, dtype, device)

    def counted(apply, name):
        """The real operator, its applications noted in ``record`` (the
        Rayleigh-Ritz, residual and right-hand-side products)."""
        if record is None:
            return apply

        def apply_counted(X):
            record.append(dict(op="apply", operator=name, nodes=1,
                               dtype=str(X.dtype), count=1))
            return apply(X)
        return apply_counted

    # the shifted solves take the operators as they are (their Krylov
    # calls are recorded as a whole); the core and the filter's right-hand
    # side take the counted ones
    apply_A_c = operator(A_data, A_idx, A_dia, offsets_A, wdt)
    apply_A = counted(apply_A_c, "A")
    apply_A_lo = (operator(A_data, A_idx, A_dia, offsets_A, lo_dt)
                  if mixed else None)
    apply_B_c = apply_B_lo = None
    if standard:
        def apply_B(X):
            return X
    else:
        apply_B_c = operator(B_data, B_idx, B_dia, offsets_B, wdt)
        apply_B = counted(apply_B_c, "B")
        if mixed:
            apply_B_lo = operator(B_data, B_idx, B_dia, offsets_B, lo_dt)
    # bound the Krylov memory: (restart+1) N cols at the Krylov itemsize
    # (complex64 under mixed precision), <= ~1.5 GB (the JAX package's
    # rule, per node)
    itemsize = 8 if mixed else (16 if f64 else 8)
    budget_cols = max(1, int(1.5e9 / (itemsize * (solver_restart + 1) * N)))
    col_block = max(8, 1 << int(np.log2(budget_cols))) \
        if budget_cols < 4096 else None
    filter_partial = _make_sparse_solve_all(
        apply_A_c, apply_B_c, standard, solver=solver,
        solver_tol=solver_tol, solver_maxiter=solver_maxiter,
        solver_restart=solver_restart, diagA=diagA,
        diagB=None if standard else diagB, precond=precond,
        col_block=col_block, flag_tol=config.tol, mg_A=mg_A, mg_B=mg_B,
        mixed=mixed, apply_A_lo=apply_A_lo, apply_B_lo=apply_B_lo,
        ir_max=config.ir_max,
        mg_opts=(config.mg_nu_pre, config.mg_nu_post, config.mg_omega,
                 config.mg_cycles),
        group_max=config.group_max, device=device, record=record,
        complex_sum=complex_work, axis_name=axis_name, sync_axes=sync_axes,
        prec_gather_axis=prec_gather_axis)
    Z = torch.as_tensor(Zne, dtype=cdt, device=device)
    W = torch.as_tensor(Wne, dtype=cdt, device=device)
    if nodes == "mirrored":
        Zall, Wall = torch.cat([Z, Z.conj()]), torch.cat([W, W.conj()])
    elif nodes == "full":
        Zall, Wall = Z, W
    else:
        Zall, Wall = Z, 2.0 * W

    def filter_apply(Q, lam=None, tol_hint=None):
        acc, ok = filter_partial(Zall, Wall, apply_B(Q).to(cdt), Q=Q,
                                 lam=lam, tol_hint=tol_hint)
        return acc.to(Q.dtype), ok

    filter_apply.takes_ritz = bool(config.warm_start)
    filter_apply.takes_tol = bool(config.adaptive_inner_tol)
    filter_apply.col_block = col_block
    return apply_A, apply_B, filter_apply


def _sparse_krylov_interval(A, B, Emin, Emax, M0, fpm, *, hermitian,
                            solver, solver_tol, solver_maxiter,
                            solver_restart, Q0, grid, precond, auto_inner,
                            device) -> FeastResult:
    """The Krylov tail of ``sparse_feast_interval`` for real symmetric and
    complex Hermitian pencils (``hermitian=None``: complex data; True on
    real data runs in complex work precision, as in the JAX package):
    structure detection, the narrow-band hand-off to the banded driver
    (before any dtype decision, as the JAX package orders it), the
    preconditioner plan, the inner tolerance default (0.02 tol, floored at
    10 eps), the contour, the seeded subspace and the FEAST core around the
    Krylov filter."""
    trace.solve_attrs(path="krylov")
    is_complex = np.iscomplexobj(_peek_dtype(A)) or (
        B is not None and np.iscomplexobj(_peek_dtype(B)))
    if hermitian is None:
        hermitian = is_complex
    f64 = _is_double(_peek_dtype(A).dtype)
    rdtype = np.float64 if f64 else np.float32
    cdtype = np.complex128 if f64 else np.complex64
    work = np.dtype(cdtype if hermitian else rdtype)
    A_data, A_idx, shape = sparse_coo_arrays(A, work)
    N = shape[0]
    standard = B is None
    if standard:
        B_data, B_idx = A_data, A_idx
    else:
        B_data, B_idx, _ = sparse_coo_arrays(B, work)
    if not 0 < M0 <= N:
        raise ValueError(f"M0 must be in 1..N={N}, got {M0}")
    if not Emax > Emin:
        raise ValueError(f"Emin={Emin} must be < Emax={Emax}")
    (A_dia, offsets_A, B_dia, offsets_B, diagA, diagB, precond_auto, mg_A,
     mg_B) = _structured_forms(A_data, A_idx, B_data, B_idx, N, standard,
                               work, grid=grid)
    if auto_inner and grid is None:
        bwA = _narrow_band(offsets_A, N)
        bwB = (0, 0) if standard else _narrow_band(offsets_B, N)
        if bwA is not None and bwB is not None:
            # narrow-banded pencil: exact BCR factor / solve per contour
            # node (direct-solver semantics) on its band storage
            from ..ops.banded import dia_to_banded
            from .banded import _banded_interval_driver
            A_bands = dia_to_banded(A_dia, offsets_A, *bwA)
            B_bands = None if standard else dia_to_banded(
                B_dia, offsets_B, *bwB)
            return _banded_interval_driver(
                A_bands, bwA[0], bwA[1], B_bands, bwB[0], bwB[1], Emin,
                Emax, M0, fpm, hermitian, Q0=Q0, device=device)
    precond, mg_A, mg_B = _plan_mg(mg_A, mg_B, float(Emax), precond_auto,
                                   precond)
    config = FeastConfig.from_fpm(fpm, dtype=cdtype)
    if solver_tol is None:
        # the refinement floor sits ~10x above the inner target; 0.02x
        # leaves the converged residual safely below tol
        solver_tol = max(config.tol * 0.02,
                         10 * float(np.finfo(rdtype).eps))
    from ..core.aux import feast_get_custom_contour
    contour = feast_get_custom_contour(fpm) or feast_contour(Emin, Emax, fpm)
    record = []
    apply_A, apply_B, filter_apply = _sparse_ops(
        A_data, A_idx, B_data, B_idx, A_dia, B_dia, diagA, diagB,
        contour.Zne, contour.Wne, N=N, config=config, standard=standard,
        solver=solver, solver_tol=float(solver_tol),
        solver_maxiter=int(solver_maxiter),
        solver_restart=int(solver_restart), offsets_A=offsets_A,
        offsets_B=offsets_B, precond=precond, mg_A=mg_A, mg_B=mg_B,
        device=device, f64=f64, record=record,
        nodes="mirrored" if hermitian else "half")
    if config.mode == 2:
        return _stochastic_estimate_result(filter_apply, N, fpm, work,
                                           device)
    q0_np = initial_subspace(fpm, Q0, N, M0, work)
    if config.print_level >= 1:
        print(f"feast krylov: solver={solver} precond={precond}"
              + (f" ({mg_A[3]} levels)" if precond == "mg" else "")
              + f" solver_tol={float(solver_tol):.2e} "
              f"restart={int(solver_restart)} "
              f"maxiter={int(solver_maxiter)} "
              f"col_block={filter_apply.col_block} "
              f"group={max(1, min(contour.ne, config.group_max))} "
              f"mixed={_mixed_enabled(config, device, f64)}", flush=True)
    state = feast_hermitian_core(
        apply_A, apply_B, filter_apply,
        torch.as_tensor(q0_np).to(device), float(Emin), float(Emax),
        tol=config.tol, max_loops=config.max_loops,
        convergence_criterion=config.convergence_criterion,
        subspace_only=(config.mode == 1))
    result = hermitian_result(state)
    result.krylov = dict(solver=solver, precond=precond,
                         mg_levels=mg_A[3] if precond == "mg" else None,
                         restart=int(solver_restart), standard=standard,
                         hermitian=bool(hermitian),
                         complex=bool(hermitian),
                         a_dia=offsets_A is not None,
                         b_dia=offsets_B is not None, events=record)
    return result


DIA_ENTRIES = ("dia_matvec_f32", "dia_matvec_f64", "dia_matvec_c64",
               "dia_matvec_c128", "dia_matvec_batched_f32",
               "dia_matvec_batched_f64", "dia_matvec_batched_c64",
               "dia_matvec_batched_c128")


def krylov_dia_launches(krylov) -> dict:
    """The DIA kernel launches per entry that a Krylov solve's own record
    (``FeastResult.krylov``) implies: a GMRES call of t restart cycles of
    length m applies its shifted operator 2 + t (m + 2) times (the initial
    residual, per cycle the cycle's residual, m Arnoldi steps and the
    candidate's residual, then the re-verification), a BiCGStab call of t
    steps 2 + 2 t times; a shifted application is one launch per operator
    on the DIA kernels (A, and B for a generalized pencil), on the batched
    entry for a node group and on the unbatched one for a single node, in
    the Krylov call's precision: for real work (a real symmetric pencil)
    complex64 -> the f32 entry, complex128 -> fp64 (the real view); for
    complex work (a Hermitian or a general pencil, ``krylov["complex"]``)
    the c64 / c128 entries. The operators' applications outside the filter
    (Rayleigh-Ritz, residuals, B times the subspace) are one unbatched
    launch each."""
    want = dict.fromkeys(DIA_ENTRIES, 0)
    on_dia = {"A": int(krylov["a_dia"]), "B": int(krylov["b_dia"])}
    per_shift = on_dia["A"] + (0 if krylov["standard"] else on_dia["B"])
    types = ("c64", "c128") if krylov["complex"] else ("f32", "f64")
    for ev in krylov["events"]:
        single = ev["dtype"] in ("torch.complex64", "torch.float32")
        name = ("dia_matvec_batched_" if ev["nodes"] > 1 else "dia_matvec_") \
            + types[0 if single else 1]
        if ev["op"] == "gmres":
            n = per_shift * (2 + ev["trips"] * (ev["restart"] + 2))
        elif ev["op"] == "bicgstab":
            n = per_shift * (2 + 2 * ev["trips"])
        elif ev["op"] == "shift":
            n = per_shift * ev["count"]
        else:
            n = on_dia[ev["operator"]] * ev["count"]
        want[name] += n
    return want


def sparse_feast_interval(A, B, Emin, Emax, M0, fpm=None, *, hermitian=None,
                          solver=None, solver_tol=None, solver_maxiter=None,
                          solver_restart=30, Q0=None, grid=None,
                          precond=None, device=None) -> FeastResult:
    """Sparse symmetric / Hermitian interval driver (counterpart of the JAX
    package's ``sparse_feast_interval``; ``hermitian=None`` decides from
    the operands' dtypes). ``solver=None`` takes the auto route: the
    polynomial realization of the contour filter (or the indicator when
    cheaper); a configuration it cannot resolve falls back, for
    N > FEAST_SPARSE_DENSE_N (default 2048), to the Krylov contour engine.
    ``"cheb"`` runs the indicator filter, ``"contour_poly"`` the rational
    contour filter as a polynomial, ``"gmres"`` / ``"bicgstab"`` the Krylov
    contour engine (as do fpm[43] = 1, the IFEAST options, and
    ``FEAST_CONTOUR_POLY=0``), with ``solver_tol`` (default 0.02 tol),
    ``solver_maxiter`` (default 500), ``solver_restart``, ``precond``
    ("mg", "jacobi", "none"; default: multigrid where the operands are
    grid stencils and a V-cycle is feasible) and ``grid`` (the tensor grid
    of the stencil, else guessed from the offsets). ``device=None`` means
    CUDA."""
    device = resolve_device(device)
    fpm = _ensure_fpm(fpm)
    from ..core.aux import feast_get_custom_contour
    if solver in ("cheb", ":cheb"):
        return _sparse_cheb_interval(A, B, Emin, Emax, M0, fpm,
                                     hermitian=hermitian, Q0=Q0,
                                     device=device)
    if solver in ("contour_poly", ":contour_poly"):
        contour_r = (feast_get_custom_contour(fpm)
                     or feast_contour(Emin, Emax, fpm))
        return _sparse_cheb_interval(A, B, Emin, Emax, M0, fpm,
                                     hermitian=hermitian, Q0=Q0,
                                     device=device, contour=contour_r)
    iopts = ifeast_solver_options(fpm) or {}
    # nothing pinned the inner solve to an iterative method: the narrow-
    # band delegation stays available
    auto_inner = (solver is None and not iopts and solver_tol is None
                  and solver_maxiter is None and precond is None)
    poly_route = auto_inner and grid is None and _contour_poly_default()
    if poly_route:
        with trace.span("route.band"):
            poly_route = not _quick_narrow_band(A, B)
    if poly_route:
        contour_r = (feast_get_custom_contour(fpm)
                     or feast_contour(Emin, Emax, fpm))
        try:
            return _sparse_cheb_interval(
                A, B, Emin, Emax, M0, fpm, hermitian=hermitian, Q0=Q0,
                device=device, contour=contour_r, route=True)
        except ChebInfeasible as e:
            trace.solve_attrs(path="other")
            n = A.shape[0]
            if n <= int(os.environ.get("FEAST_SPARSE_DENSE_N", "2048")):
                # a small pencil off the polynomial route is usually hostile
                # to the Krylov engine too (nodes ~1e-7 from the spectrum):
                # one dense factorization per node shrugs that off
                if int(fpm[1]) >= 1:
                    print(f"feast sparse: contour-polynomial route "
                          f"unavailable ({e}); N={n} small — "
                          f"densifying onto the dense direct engine",
                          flush=True)
                from .dense import dense_hermitian_feast
                return dense_hermitian_feast(
                    _densify(A), None if B is None else _densify(B),
                    Emin, Emax, M0, fpm, Q0=Q0, hermitian=hermitian,
                    device=device)
            if int(fpm[1]) >= 1:
                print(f"feast sparse: contour-polynomial route "
                      f"unavailable ({e}); using the Krylov contour "
                      f"engine", flush=True)
    return _sparse_krylov_interval(
        A, B, Emin, Emax, M0, fpm, hermitian=hermitian,
        solver=_solver_fn(solver or iopts.get("solver", "gmres")),
        solver_tol=(solver_tol if solver_tol is not None
                    else iopts.get("solver_tol")),
        solver_maxiter=(solver_maxiter if solver_maxiter is not None
                        else iopts.get("solver_maxiter", 500)),
        solver_restart=solver_restart, Q0=Q0, grid=grid, precond=precond,
        auto_inner=auto_inner, device=device)


def feast_scsrev(A, Emin, Emax, M0, fpm=None, **kw) -> FeastResult:
    """Sparse real-symmetric standard problem (feast_scsrev!)."""
    return sparse_feast_interval(A, None, Emin, Emax, M0, fpm,
                                 hermitian=False, **kw)


def feast_scsrgv(A, B, Emin, Emax, M0, fpm=None, **kw) -> FeastResult:
    """Sparse real-symmetric generalized problem (feast_scsrgv!)."""
    return sparse_feast_interval(A, B, Emin, Emax, M0, fpm,
                                 hermitian=False, **kw)


def feast_hcsrev(A, Emin, Emax, M0, fpm=None, **kw) -> FeastResult:
    """Sparse complex-Hermitian standard problem (feast_hcsrev!)."""
    return sparse_feast_interval(A, None, Emin, Emax, M0, fpm,
                                 hermitian=True, **kw)


def feast_hcsrgv(A, B, Emin, Emax, M0, fpm=None, **kw) -> FeastResult:
    """Sparse complex-Hermitian generalized problem (feast_hcsrgv!)."""
    return sparse_feast_interval(A, B, Emin, Emax, M0, fpm,
                                 hermitian=True, **kw)


# --- the general / complex-symmetric contour engine -------------------------

def _sparse_general_ops(A_data, A_idx, B_data, B_idx, A_dia, B_dia, diagA,
                        diagB, Zne, Wne, **kw):
    """(apply_A, apply_B, filter_apply) of the general engine (counterpart
    of ``_sparse_general_ops``): ``_sparse_ops`` in complex work with the
    full contour as given, filter_apply(Q, lam, tol_hint) =
    (sum_e W_e (z_e B - A)^-1 B Q, all inner solves converged)."""
    return _sparse_ops(A_data, A_idx, B_data, B_idx, A_dia, B_dia, diagA,
                       diagB, Zne, Wne, nodes="full", **kw)


def sparse_feast_general(A, B, Emid, r, M0, fpm=None, *, bilinear=False,
                         eig_method=None, solver=None, solver_tol=None,
                         solver_maxiter=None, solver_restart=30, Q0=None,
                         grid=None, precond=None, device=None
                         ) -> FeastGeneralResult:
    """Sparse general / complex-symmetric driver (counterpart of the JAX
    package's ``sparse_feast_general``): every eigenpair of A x = lam B x
    inside the ellipse (Emid, r, fpm[18], fpm[19]), complex64 work for
    single-precision A, complex128 otherwise. A narrow-banded pencil (half
    bandwidth <= 16, N <= 16384) that nothing pinned to an iterative solve
    goes to the banded general driver (BCR); everything else runs the
    Krylov contour engine on the full contour (``solver`` "gmres" or
    "bicgstab", ``solver_tol`` default max(0.1 tol, 10 eps), multigrid
    where the operands are grid stencils and a V-cycle is feasible for
    shifts up to Re(Emid) + r, else Jacobi or none), under mixed precision
    complex64 Krylov inside a complex128 refinement (fpm[42]; on for
    CUDA). ``bilinear``: the transpose pairing of a complex-symmetric
    pencil. ``eig_method`` as in ``dense_general.dense_general_feast``.
    ``device=None`` means CUDA."""
    check_method(eig_method)
    device = resolve_device(device)
    fpm = _ensure_fpm(fpm)
    iopts = ifeast_solver_options(fpm) or {}
    # the banded delegation stays available only when nothing pinned the
    # inner solve to an iterative method
    auto_inner = (solver is None and not iopts and solver_tol is None
                  and solver_maxiter is None and precond is None)
    solver = _solver_fn(solver or iopts.get("solver", "gmres"))
    solver_tol = solver_tol if solver_tol is not None \
        else iopts.get("solver_tol")
    solver_maxiter = (solver_maxiter if solver_maxiter is not None
                      else iopts.get("solver_maxiter", 500))
    f64 = _is_double(_peek_dtype(A).dtype)
    rdtype = np.float64 if f64 else np.float32
    cdtype = np.dtype(np.complex128 if f64 else np.complex64)
    A_data, A_idx, shape = sparse_coo_arrays(A, cdtype)
    N = shape[0]
    standard = B is None
    if standard:
        B_data, B_idx = A_data, A_idx
    else:
        B_data, B_idx, _ = sparse_coo_arrays(B, cdtype)
    if not 0 < M0 <= N:
        raise ValueError(f"M0 must be in 1..N={N}, got {M0}")
    if not r > 0:
        raise ValueError(f"Contour radius must be positive, got {r}")
    (A_dia, offsets_A, B_dia, offsets_B, diagA, diagB, precond_auto, mg_A,
     mg_B) = _structured_forms(A_data, A_idx, B_data, B_idx, N, standard,
                               cdtype, grid=grid)
    if auto_inner and grid is None:
        bwA = _narrow_band(offsets_A, N)
        bwB = (0, 0) if standard else _narrow_band(offsets_B, N)
        if bwA is not None and bwB is not None:
            # narrow-banded pencil: exact BCR factor / solve per contour
            # node (direct-solver semantics) on its band storage
            from ..ops.banded import dia_to_banded
            from .banded import _banded_general_driver
            A_bands = dia_to_banded(A_dia, offsets_A, *bwA)
            B_bands = None if standard else dia_to_banded(
                B_dia, offsets_B, *bwB)
            return _banded_general_driver(
                A_bands, bwA[0], bwA[1], B_bands, bwB[0], bwB[1], Emid, r,
                M0, fpm, bilinear, Q0=Q0, device=device)
    precond, mg_A, mg_B = _plan_mg(
        mg_A, mg_B, float(np.real(complex(Emid))) + float(r), precond_auto,
        precond)
    config = FeastConfig.from_fpm(fpm, dtype=cdtype)
    if solver_tol is None:
        solver_tol = max(config.tol * 0.1, 10 * float(np.finfo(rdtype).eps))
    Zne, Wne = contour_tensors(fpm, Emid, r, cdtype, device)
    record = []
    apply_A, apply_B, filter_apply = _sparse_general_ops(
        A_data, A_idx, B_data, B_idx, A_dia, B_dia, diagA, diagB,
        Zne, Wne, N=N, config=config, standard=standard,
        solver=solver, solver_tol=float(solver_tol),
        solver_maxiter=int(solver_maxiter),
        solver_restart=int(solver_restart), offsets_A=offsets_A,
        offsets_B=offsets_B, precond=precond, mg_A=mg_A, mg_B=mg_B,
        device=device, f64=f64, record=record)
    if config.mode == 2:
        # the raw full-contour sum: trace(P) = M for the oblique projector
        return _general_estimate(_stochastic_estimate_result(
            filter_apply, N, fpm, cdtype, device))
    q0_np = initial_subspace(fpm, Q0, N, M0, cdtype, general=True)
    if config.print_level >= 1:
        print(f"feast krylov (general): solver={solver} precond={precond}"
              + (f" ({mg_A[3]} levels)" if precond == "mg" else "")
              + f" solver_tol={float(solver_tol):.2e} "
              f"restart={int(solver_restart)} "
              f"maxiter={int(solver_maxiter)} "
              f"col_block={filter_apply.col_block} "
              f"group={max(1, min(Zne.shape[0], config.group_max))} "
              f"mixed={_mixed_enabled(config, device, f64)}", flush=True)
    state = feast_general_core(
        apply_A, apply_B, filter_apply,
        torch.as_tensor(q0_np).to(device), complex(Emid), float(r),
        tol=config.tol, max_loops=config.max_loops,
        aspect_ratio=config.aspect_ratio, rotation_deg=config.rotation_deg,
        convergence_criterion=config.convergence_criterion,
        subspace_only=(config.mode == 1), bilinear=bilinear)
    result = general_result(state)
    result.krylov = dict(solver=solver, precond=precond,
                         mg_levels=mg_A[3] if precond == "mg" else None,
                         restart=int(solver_restart), standard=standard,
                         hermitian=False, complex=True, general=True,
                         a_dia=offsets_A is not None,
                         b_dia=offsets_B is not None, events=record)
    return result


def feast_gcsrev(A, Emid, r, M0, fpm=None, **kw) -> FeastGeneralResult:
    """Sparse general standard problem (feast_gcsrev!)."""
    return sparse_feast_general(A, None, Emid, r, M0, fpm, **kw)


def feast_gcsrgv(A, B, Emid, r, M0, fpm=None, **kw) -> FeastGeneralResult:
    """Sparse general generalized problem (feast_gcsrgv!)."""
    return sparse_feast_general(A, B, Emid, r, M0, fpm, **kw)


def feast_scsrev_complex(A, Emid, r, M0, fpm=None, **kw
                         ) -> FeastGeneralResult:
    """Sparse complex-symmetric standard problem (feast_scsrev_complex!):
    the transpose pairing."""
    return sparse_feast_general(A, None, Emid, r, M0, fpm, bilinear=True,
                                **kw)


def feast_scsrgv_complex(A, B, Emid, r, M0, fpm=None, **kw
                         ) -> FeastGeneralResult:
    """Sparse complex-symmetric generalized problem
    (feast_scsrgv_complex!)."""
    return sparse_feast_general(A, B, Emid, r, M0, fpm, bilinear=True, **kw)


def feast_scsrpev(coeffs, Emid, r, M0, fpm=None, **kw) -> FeastGeneralResult:
    """Sparse polynomial eigenproblem: the coefficients densified and
    linearized (``solvers/dense_general.feast_pep``), as in the JAX
    package."""
    from .dense_general import feast_pep
    return feast_pep([_densify(c) if not isinstance(c, torch.Tensor)
                      else c for c in coeffs], Emid, r, M0, fpm, **kw)


feast_hcsrpev = feast_scsrpev
feast_gcsrpev = feast_scsrpev
