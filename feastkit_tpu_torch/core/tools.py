"""Numeric helpers of the FEAST refinement loop on torch tensors.

Counterpart of ``feastkit_tpu/core/tools.py``. ``seeded_subspace`` and
``initial_subspace`` are host numpy and give the same bits as the JAX
package (a numpy ``default_rng`` keyed on (N, M0)), so both packages start
from the same subspace. The JAX package's ``gram_accurate`` /
``matmul_accurate`` work around f64 matrix products that a TPU computes
with f32 products; on the CPU and on CUDA a plain ``@`` is genuine f64, so
the port has no such branch.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["seeded_subspace", "initial_subspace", "residuals",
           "inside_first_order", "eigh_polished", "reduced_hermitian_gevp",
           "thin_svd", "orthonormalize", "lu_factor", "feast_name"]


def seeded_subspace(N: int, M0: int, dtype, *, general: bool = False) -> np.ndarray:
    """Deterministic (N, M0) initial subspace with unit columns (host
    array); depends only on (N, M0), bit-identical to the JAX package."""
    dtype = np.dtype(dtype)
    is_complex = np.issubdtype(dtype, np.complexfloating)
    tag = 7 if general else (1 if is_complex else 0)
    rng = np.random.default_rng((N * 1000003 + M0 * 101 + tag) % (2 ** 31 - 1))
    real_dtype = np.float32 if dtype in (np.dtype(np.complex64),
                                         np.dtype(np.float32)) else np.float64
    w = rng.standard_normal((N, M0)).astype(real_dtype)
    if general and is_complex:
        w = w + 1j * rng.standard_normal((N, M0)).astype(real_dtype)
    w = w / np.linalg.norm(w, axis=0, keepdims=True)
    return w.astype(dtype)


def initial_subspace(fpm, Q0, N: int, M0: int, dtype, *,
                     general: bool = False) -> np.ndarray:
    """The caller's Q0 only when fpm[5]=1, else the seeded subspace; a Q0
    with fewer than M0 columns is padded with seeded columns and zero
    columns are replaced by seeded ones (same policy as the JAX package)."""
    if Q0 is None or int(fpm[5]) != 1:
        return seeded_subspace(N, M0, dtype, general=general)
    if isinstance(Q0, torch.Tensor):
        Q0 = Q0.detach().cpu().numpy()
    Q0 = np.asarray(Q0, np.dtype(dtype))
    if Q0.shape[0] != N:
        raise ValueError(f"Q0 must have {N} rows, got {Q0.shape[0]}")
    # the seeded columns are drawn only where a column is missing or zero:
    # a full restart basis (a checkpoint's) resumes without the host draw
    seed = None
    if Q0.shape[1] >= M0:
        Q0 = np.ascontiguousarray(Q0[:, :M0])
    else:
        seed = seeded_subspace(N, M0, dtype, general=general)
        Q0 = np.concatenate([Q0, seed[:, Q0.shape[1]:]], axis=1)
    dead = np.linalg.norm(Q0, axis=0) <= 0
    if dead.any():
        if seed is None:
            seed = seeded_subspace(N, M0, dtype, general=general)
        Q0 = Q0.copy()
        Q0[:, dead] = seed[:, dead]
    return Q0


def residuals(apply_A, apply_B, lam, q):
    """Relative residuals ||A q - lam B q|| / max(|lam|, 1), columnwise."""
    r = apply_A(q) - lam[None, :].to(q.dtype) * apply_B(q)
    return torch.linalg.vector_norm(r, dim=0) / torch.clamp(lam.abs(), min=1.0)


def inside_first_order(lam, inside, *, general: bool = False):
    """Permutation putting inside pairs first, each group ascending in lam
    (real case) or in |lam|^2 (general case), stable, like the JAX
    package's lexsort."""
    key = lam.abs() ** 2 if general else lam
    by_lam = torch.argsort(key, stable=True)
    primary = (~inside[by_lam]).to(torch.int8)
    return by_lam[torch.argsort(primary, stable=True)]


def thin_svd(Q):
    """(U, s) of the thin SVD of a tall-skinny Q, by a QR factorization and
    the SVD of the small triangular factor: the same U and s as a direct
    thin SVD without an (N, M) SVD workspace on the device."""
    Qq, R = torch.linalg.qr(Q, mode="reduced")
    Ur, s, _ = torch.linalg.svd(R)
    return Qq @ Ur, s


def orthonormalize(Q, rtol=None):
    """Orthonormal basis of span(Q) with rank detection (the JAX package's
    replacement of the reference's pivoted-QR compression): (U with all M0
    orthonormal columns, rank, s) from the thin SVD; singular values at or
    below rtol * s_max (default sqrt(eps) of Q's precision) are counted out
    of the rank."""
    U, s = thin_svd(Q)
    if rtol is None:
        rtol = float(np.sqrt(torch.finfo(s.dtype).eps))
    return U, (s > rtol * s[0]).sum(), s


def eigh_polished(C):
    """``torch.linalg.eigh``. The JAX package polishes its eigenvectors
    where the backend's f64 eigh is weak (a TPU); LAPACK and cuSOLVER eigh
    are genuine f64, so the port returns the plain decomposition."""
    return torch.linalg.eigh(C)


def reduced_hermitian_gevp(S, G, eps_scale=None):
    """Solve S v = lam G v (S, G symmetric, G >= 0) by the clipped inverse
    square-root congruence of the JAX package: rank-deficient directions of
    G get huge clipped weights and land far outside the interval."""
    S = 0.5 * (S + S.mT.conj())
    G = 0.5 * (G + G.mT.conj())
    w, U = eigh_polished(G)
    if eps_scale is None:
        # the JAX package's rule: single-precision eps for complex64 only
        eps_scale = float(np.finfo(
            np.float32 if S.dtype == torch.complex64 else np.float64).eps)
    floor = torch.clamp(w[-1], min=0.0) * eps_scale * S.shape[0]
    w_safe = torch.maximum(w, floor)
    w_safe = torch.where(w_safe > 0, w_safe, torch.ones_like(w_safe))
    W = (U * (1.0 / torch.sqrt(w_safe))[None, :]) @ U.mT.conj()
    C = W @ S @ W
    C = 0.5 * (C + C.mT.conj())
    lam, Y = eigh_polished(C)
    return lam, W @ Y


def lu_factor(S):
    """``torch.linalg.lu_factor`` of one matrix or a batch. On the CPU a
    batch of matrices larger than 128 is factored one matrix at a time: the
    CPU build's batched complex getrf with more than one thread reports a
    LASWP argument error and hangs at such sizes (seen from 200 up, not at
    150 and below)."""
    if S.dim() == 2 or S.is_cuda or S.shape[-1] <= 128:
        return torch.linalg.lu_factor(S)
    flat = S.reshape(-1, *S.shape[-2:])
    lus, pivs = zip(*(torch.linalg.lu_factor(s) for s in flat))
    return (torch.stack(lus).reshape(S.shape),
            torch.stack(pivs).reshape(S.shape[:-1]))


def feast_name(code: int) -> str:
    """Decode a 6-digit FEAST routine code into the routine name
    (feast_tools.jl:758-832): [p] {s|d|c|z} [i] feast_ {s|h|g}
    {rci|y|b|csr|e} {x|ev|evx|gv|gvx|pev|pevx}."""
    digits = [0] * 6
    rem = int(code)
    for i in range(6):
        digits[5 - i] = rem % 10
        rem //= 10
    name = "p" if digits[0] == 2 else ""
    name += {1: "s", 2: "d", 3: "c", 4: "z"}.get(digits[1], "")
    if digits[2] == 2:
        name += "i"
    name += "feast_"
    name += {1: "s", 2: "h", 3: "g"}.get(digits[3], "")
    name += {1: "rci", 2: "y", 3: "b", 4: "csr", 5: "e"}.get(digits[4], "")
    name += {1: "x", 2: "ev", 3: "evx", 4: "gv", 5: "gvx",
             6: "pev", 7: "pevx"}.get(digits[5], "")
    return name
