"""Batched iterative solvers for shifted systems: restarted GMRES, BiCGStab.

Counterpart of ``feastkit_tpu/ops/gmres.py`` on torch tensors, with the
same contracts: all K right-hand sides advance together (one operator
application per Arnoldi step is one block matvec), rtol = atol = tol on
max(||b||, 1), a per-column accept of each restart cycle's correction only
where it lowered the true residual, the two-cycle stall exit, and the
independent re-verification of the true residual at 10 tol (``flag_tol``
loosens the certificate, not the target).

The port adds an optional leading node axis: ``B`` of shape (g, N, K)
solves g shifted systems at once (``apply_op`` and ``apply_prec`` then map
(g, N, K) to (g, N, K), each node with its own shift). Per node nothing
changes: every node keeps its own exit flags, and a node that has exited
keeps its state while the others go on, as under ``vmap`` of the JAX
package's ``while_loop``. A (N, K) ``B`` calls ``apply_op`` on (N, K)
tensors, as in the JAX package.

The loops are host loops with one host read per restart cycle (GMRES) or
per step (BiCGStab); the m Arnoldi steps of a cycle run without one. The
Krylov basis is kept column-major, (g, K, m + 1, N), so the Gram-Schmidt
projections against the first j + 1 vectors are batched matrix products
over the (node, column) pairs; restricting them to those j + 1 vectors
gives the same sums as the JAX package's masked sums over all m + 1. The
per-column Hessenberg least squares goes through the SVD with
``jnp.linalg.lstsq``'s default cut, so the all-zero Hessenberg of a done or
zero-padded column gives a zero step, and every update of a column that is
not active is a ``torch.where`` select, never a multiply (a NaN times 0 is
NaN).

The JAX package's sharding hooks are ported for a row dimension N split
over the ranks of a process group (``parallel/pfeast.py``'s model axis):
``axis_name`` is that axis's group, and every contraction over N (column
norms, the Gram-Schmidt projections, BiCGStab's inner products) is summed
over it with ``torch.distributed.all_reduce`` (the second Gram-Schmidt
pass and the new basis vector's norm in one: ``_gram_schmidt_sharded``);
``sync_axes`` is the group
whose ranks must run the same number of loop trips (their operators hold
collectives), and each loop goes on while any of its ranks still has a
node running (a MAX all-reduce of the flag per trip). A node that has
exited keeps its state on the extra trips, as above.

CG is absent, as in the JAX package: z B - A is never HPD for complex z.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

__all__ = ["gmres_block", "bicgstab_block", "IterativeInfo"]


class IterativeInfo(NamedTuple):
    iterations: torch.Tensor  # (g,) or (): inner iterations executed per node
    residual: torch.Tensor    # (g, K) or (K,) final true-residual norms
    converged: torch.Tensor   # bool, after the 10*tol re-verification
    trips: int                # loop trips the call ran (GMRES restart
    #   cycles, BiCGStab steps): the node that ran longest sets it, and
    #   each trip applied the operator to the whole group


def _col_norms(X, axis_name=None):
    """Column norms over the row axis, summed over ``axis_name``'s ranks
    where N is sharded."""
    if axis_name is None:
        return torch.linalg.vector_norm(X, dim=-2)
    return torch.sqrt(_psum(torch.sum((X.conj() * X).real, dim=-2),
                            axis_name))


def _psum(t, group):
    """``t`` summed over the ranks of ``group`` (None: not sharded)."""
    if group is not None:
        import torch.distributed as dist
        t = t.resolve_conj().contiguous()
        dist.all_reduce(t, group=group)
    return t


def _any(flag, sync_axes):
    """A host bool: whether ``flag`` (a bool tensor) holds on any rank of
    ``sync_axes`` (None: on this one)."""
    if sync_axes is None:
        return bool(flag)
    import torch.distributed as dist
    t = torch.as_tensor(flag, dtype=torch.int32).reshape(1).to(
        flag.device if torch.is_tensor(flag) else "cpu")
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=sync_axes)
    return bool(t.item())


def _mul(a, b):
    """a * b elementwise for small (g, K) coefficient tensors, in real
    arithmetic when complex: torch's CPU complex product rounds differently
    in its vectorized body and its scalar tail, so a node of a group would
    not get the bits it gets alone."""
    if not a.is_complex():
        return a * b
    return torch.complex(a.real * b.real - a.imag * b.imag,
                         a.real * b.imag + a.imag * b.real)


def _batched(apply_op, B, prec, x0):
    """(op, prec, B, x0) on a leading node axis; an (N, K) problem becomes
    one node whose operator is called on (N, K) tensors."""
    if B.dim() == 3:
        return apply_op, prec, B, x0, False

    def op(X):
        return apply_op(X[0]).unsqueeze(0)

    def prec1(X):
        return prec(X[0]).unsqueeze(0)
    return (op, None if prec is None else prec1, B.unsqueeze(0),
            None if x0 is None else x0.unsqueeze(0), True)


def _gram_schmidt(Vj, W):
    """Two classical Gram-Schmidt passes ("twice is enough") of W (g, K, N)
    against the basis vectors Vj (g, K, j+1, N), in place on W; returns the
    projections (g, K, j+1) of both passes summed."""
    h = torch.zeros(Vj.shape[:-1], dtype=W.dtype, device=W.device)
    for _ in range(2):
        # conj(V_i)^T W = conj(V_i^T conj(W)): only the small vector is
        # conjugated
        hp = (Vj @ W.conj().unsqueeze(-1)).squeeze(-1).conj()
        W -= (Vj.transpose(-1, -2) @ hp.unsqueeze(-1)).squeeze(-1)
        h += hp
    return h


def _gram_schmidt_sharded(Vj, W, axis_name):
    """:func:`_gram_schmidt` for rows split over ``axis_name``'s ranks, and
    the new vector's norm: the second pass's projections and the squared
    norm before it meet in ONE all-reduce, and the norm after the pass
    follows by Pythagoras (||W - V h2||^2 = ||W||^2 - ||h2||^2 for the
    orthonormal V; h2 is at the rounding level of W). Returns (h, norm)."""
    hp = _psum((Vj @ W.conj().unsqueeze(-1)).squeeze(-1), axis_name).conj()
    W -= (Vj.transpose(-1, -2) @ hp.unsqueeze(-1)).squeeze(-1)
    p2 = (Vj @ W.conj().unsqueeze(-1)).squeeze(-1)
    n2 = torch.sum((W.conj() * W).real, dim=-1)
    both = _psum(torch.cat([p2, n2.to(p2.dtype).unsqueeze(-1)], dim=-1),
                 axis_name)
    hp2 = both[..., :-1].conj()
    W -= (Vj.transpose(-1, -2) @ hp2.unsqueeze(-1)).squeeze(-1)
    wn2 = both[..., -1].real - torch.sum((hp2.conj() * hp2).real, dim=-1)
    return hp + hp2, torch.sqrt(torch.clamp(wn2, min=0.0))


def _hessenberg_lstsq(H, beta):
    """min ||beta e1 - H y|| per (node, column) for H (g, K, m+1, m),
    through the SVD with ``jnp.linalg.lstsq``'s default cut: singular
    values that are zero or below eps(dtype) * (m+1) * s_max are dropped.
    Returns y (g, K, m)."""
    m = H.shape[-1]
    U, s, Vh = torch.linalg.svd(H, full_matrices=False)
    rcond = torch.finfo(s.dtype).eps * (m + 1)
    mask = (s > 0) & (s >= rcond * s[..., :1])
    uhb = U[..., 0, :].conj() * beta[..., None].to(H.dtype)
    coef = torch.where(mask, uhb / torch.where(mask, s, 1.0).to(H.dtype),
                       torch.zeros((), dtype=H.dtype, device=H.device))
    return (Vh.conj().transpose(-1, -2) @ coef.unsqueeze(-1)).squeeze(-1)


def _gmres_cycle(op, prec, B, X, done, stall, thresh, m, axis_name=None):
    """One restart cycle for every node of the group: m Arnoldi steps, the
    least squares, and the per-column accept. Returns the candidate state
    (the caller keeps it only for the nodes still running)."""
    g, N, K = B.shape
    R = B - op(X)
    beta = _col_norms(R, axis_name)
    active = (~done) & (beta > thresh)
    safe_beta = torch.where(beta > 0, beta, 1.0)
    V = torch.zeros((g, K, m + 1, N), dtype=B.dtype, device=B.device)
    V[:, :, 0, :] = (R / safe_beta[:, None, :].to(B.dtype)).transpose(-1, -2)
    del R
    H = torch.zeros((g, K, m + 1, m), dtype=B.dtype, device=B.device)
    for j in range(m):
        v = V[:, :, j, :].transpose(-1, -2)
        W = op(v if prec is None else prec(v)).transpose(-1, -2).contiguous()
        if axis_name is None:
            H[:, :, :j + 1, j] = _gram_schmidt(V[:, :, :j + 1, :], W)
            wn = torch.linalg.vector_norm(W, dim=-1)
        else:
            H[:, :, :j + 1, j], wn = _gram_schmidt_sharded(
                V[:, :, :j + 1, :], W, axis_name)
        V[:, :, j + 1, :] = W / torch.where(wn > 0, wn, 1.0)[..., None].to(
            B.dtype)
        H[:, :, j + 1, j] = wn.to(B.dtype)
        del W
    Y = _hessenberg_lstsq(H, beta)
    dX = (V[:, :, :m, :].transpose(-1, -2) @ Y.unsqueeze(-1)).squeeze(-1)
    del V
    dX = dX.transpose(-1, -2)
    if prec is not None:
        dX = prec(dX)
    X_cand = torch.where(active[:, None, :], X + dX, X)
    del dX
    res_cand = _col_norms(B - op(X_cand), axis_name)
    # accept the correction per column only where it lowered the true
    # residual (the small least squares is noisy at the rounding floor)
    keep = (res_cand < beta) & active
    X_new = torch.where(keep[:, None, :], X_cand, X)
    res = torch.where(keep, res_cand, beta)
    done_new = done | (res <= thresh)
    # exit after TWO consecutive cycles in which no unconverged column
    # improved by >= 10% (one stagnant cycle is legal near contour nodes)
    improved = res < 0.9 * beta
    stalled = ~torch.any(improved & ~done_new, dim=-1)
    stall_new = torch.where(stalled, stall + 1, 0)
    exit_new = torch.all(done_new, dim=-1) | (stall_new >= 2)
    it_add = torch.where(torch.any(active, dim=-1), m, 0)
    return X_new, done_new, it_add, stall_new, exit_new


def gmres_block(apply_op: Callable, B, *, tol: float = 1e-12,
                restart: int = 30, maxiter: int = 200,
                apply_prec: Callable | None = None, x0=None,
                flag_tol: float | None = None, axis_name=None,
                sync_axes=None):
    """Restarted GMRES on K right-hand sides at once, for one system (B of
    shape (N, K)) or a group of g (B of shape (g, N, K)).

    Args:
      apply_op: applies the (shifted) operator columnwise, in B's layout.
      B: right-hand sides.
      tol: relative AND absolute tolerance (rtol = atol).
      restart: Arnoldi memory m.
      maxiter: total inner-iteration cap (ceil(maxiter / m) cycles).
      apply_prec: optional RIGHT preconditioner M^-1 (solves A M^-1 u = b,
        returns x = M^-1 u); it may return a non-contiguous view.
      x0: optional initial guess of B's shape.
      flag_tol: certify against max(tol, flag_tol) instead of tol.
      axis_name: the process group whose ranks hold N's row blocks (every
        contraction over N is summed over it), or None.
      sync_axes: the process group whose ranks run the same number of
        restart cycles, or None.

    Returns (X, IterativeInfo); converged = ||B - A X|| <= 10 cert scale.
    """
    op, prec, Bb, x0b, squeeze = _batched(apply_op, B, apply_prec, x0)
    g, N, K = Bb.shape
    m = int(restart)
    scale = torch.clamp(_col_norms(Bb, axis_name), min=1.0)
    thresh = float(tol) * scale
    X = torch.zeros_like(Bb) if x0b is None else x0b.to(Bb.dtype)
    n_cycles = max(1, -(-int(maxiter) // m))
    done = _col_norms(Bb - op(X), axis_name) <= thresh
    running = ~torch.all(done, dim=-1)
    iters = torch.zeros(g, dtype=torch.int64, device=Bb.device)
    stall = torch.zeros(g, dtype=torch.int64, device=Bb.device)
    trips = 0
    while trips < n_cycles and _any(running.any(), sync_axes):
        X_new, done_new, it_add, stall_new, exit_new = _gmres_cycle(
            op, prec, Bb, X, done, stall, thresh, m, axis_name)
        X = torch.where(running[:, None, None], X_new, X)
        done = torch.where(running[:, None], done_new, done)
        iters = iters + torch.where(running, it_add, 0)
        stall = torch.where(running, stall_new, stall)
        running = running & ~exit_new
        trips += 1
    cert = max(float(tol), float(flag_tol)) if flag_tol is not None \
        else float(tol)
    true_res = _col_norms(Bb - op(X), axis_name)
    converged = true_res <= 10.0 * cert * scale
    if squeeze:
        return X[0], IterativeInfo(iters[0], true_res[0], converged[0],
                                   trips)
    return X, IterativeInfo(iters, true_res, converged, trips)


def bicgstab_block(apply_op: Callable, B, *, tol: float = 1e-12,
                   maxiter: int = 200, apply_prec: Callable | None = None,
                   x0=None, flag_tol: float | None = None, axis_name=None,
                   sync_axes=None):
    """BiCGStab on K right-hand sides at once (constant memory per column),
    for one system (N, K) or a group (g, N, K). The IFEAST default inner
    solver (fpm[44]=0). Same tolerance, re-verification and sharding
    contract as :func:`gmres_block`."""
    op, prec, Bb, x0b, squeeze = _batched(apply_op, B, apply_prec, x0)
    if prec is None:
        def prec(X):
            return X
    g, N, K = Bb.shape
    scale = torch.clamp(_col_norms(Bb, axis_name), min=1.0)
    thresh = float(tol) * scale
    X = torch.zeros_like(Bb) if x0b is None else x0b.to(Bb.dtype)
    R = Bb - op(X)
    Rhat = R

    def dots(P, Q):
        return _psum(torch.sum(P.conj() * Q, dim=-2), axis_name)

    def safe(x):
        return torch.where(x.abs() > 0, x, torch.ones_like(x))

    def col(v):
        return v[:, None, :]

    P = torch.zeros_like(Bb)
    V = torch.zeros_like(Bb)
    rho = alpha = omega = torch.ones((g, K), dtype=Bb.dtype, device=Bb.device)
    it = torch.zeros(g, dtype=torch.int64, device=Bb.device)
    done = _col_norms(R, axis_name) <= thresh
    running = ~torch.all(done, dim=-1)
    trips = 0
    while trips < int(maxiter) and _any(running.any(), sync_axes):
        rho_n = dots(Rhat, R)
        beta = _mul(rho_n / safe(rho), alpha / safe(omega))
        P_n = R + col(beta) * (P - col(omega) * V)
        Ph = prec(P_n)
        V_n = op(Ph)
        alpha_n = rho_n / safe(dots(Rhat, V_n))
        S = R - col(alpha_n) * V_n
        Sh = prec(S)
        T = op(Sh)
        omega_n = dots(T, S) / safe(dots(T, T))
        X_n = torch.where(col(~done), X + (col(alpha_n) * Ph
                                           + col(omega_n) * Sh), X)
        R_n = S - col(omega_n) * T
        done_n = done | (_col_norms(R_n, axis_name) <= thresh)
        sel = running[:, None, None]
        X, R, P, V = (torch.where(sel, a, b) for a, b in
                      ((X_n, X), (R_n, R), (P_n, P), (V_n, V)))
        sel = running[:, None]
        rho, alpha, omega, done = (torch.where(sel, a, b) for a, b in
                                   ((rho_n, rho), (alpha_n, alpha),
                                    (omega_n, omega), (done_n, done)))
        it = it + running.to(it.dtype)
        running = running & ~torch.all(done, dim=-1)
        trips += 1
    cert = max(float(tol), float(flag_tol)) if flag_tol is not None \
        else float(tol)
    true_res = _col_norms(Bb - op(X), axis_name)
    converged = true_res <= 10.0 * cert * scale
    if squeeze:
        return X[0], IterativeInfo(it[0], true_res[0], converged[0], trips)
    return X, IterativeInfo(it, true_res, converged, trips)
