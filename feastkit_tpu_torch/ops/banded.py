"""Band storage, band matvec and a block cyclic-reduction (BCR) factor /
solve on torch tensors.

Counterpart of ``feastkit_tpu/ops/banded.py``. The banded matrix is
re-blocked into block-tridiagonal form (block size b >= max(kl, ku)) and
factored by block cyclic reduction: log2(nb) levels of batched b x b
partial-pivot LU factorizations and matrix products. Every tensor carries
leading batch axes (the contour nodes) where the JAX package maps its
functions over the nodes with ``vmap``.

Band storage is LAPACK's ``ab``: ``bands`` has shape (kl+ku+1, N) and row
k holds diagonal d = ku-k, i.e. bands[k, j] = A[j - (ku-k), j] (row 0 the
highest superdiagonal, out-of-range entries zero). The port's DIA form
(``ops/dia.bcoo_to_dia``) is row-aligned: diags[k, i] = A[i, i + offsets[k]]
with sorted offsets; :func:`dia_to_banded` maps one onto the other.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core.tools import lu_factor

__all__ = ["full_to_banded", "banded_to_full", "dia_to_banded",
           "banded_matvec", "bcr_block", "banded_to_blocktridiag",
           "bcr_factor", "bcr_solve", "BCRLevel"]


def full_to_banded(A, kl: int, ku: int) -> np.ndarray:
    """Dense (N, N) -> band storage (kl+ku+1, N) (host numpy)."""
    A = np.asarray(A)
    N = A.shape[0]
    bands = np.zeros((kl + ku + 1, N), dtype=A.dtype)
    for k in range(kl + ku + 1):
        d = ku - k
        j = np.arange(max(d, 0), min(N, N + d))
        bands[k, j] = A[j - d, j]
    return bands


def banded_to_full(bands, kl: int, ku: int, N: int | None = None
                   ) -> np.ndarray:
    """Band storage -> dense (N, N) (host numpy)."""
    bands = np.asarray(bands)
    N = bands.shape[1] if N is None else N
    A = np.zeros((N, N), dtype=bands.dtype)
    for k in range(kl + ku + 1):
        d = ku - k
        j = np.arange(max(d, 0), min(N, N + d))
        A[j - d, j] = bands[k, j]
    return A


def dia_to_banded(diags, offsets, kl: int, ku: int) -> np.ndarray:
    """Row-aligned DIA form -> band storage (kl+ku+1, N) (host numpy):
    diags[k, i] = A[i, i + offsets[k]] -> bands[ku - d, j] = A[j - d, j].
    Offsets must lie in [-kl, ku]."""
    diags = np.asarray(diags)
    N = diags.shape[1]
    bands = np.zeros((kl + ku + 1, N), dtype=diags.dtype)
    for k, d in enumerate(offsets):
        if not -kl <= d <= ku:
            raise ValueError(f"offset {d} outside band [-{kl}, {ku}]")
        if d >= 0:
            bands[ku - d, d:] = diags[k, : N - d]
        else:
            bands[ku - d, : N + d] = diags[k, -d:]
    return bands


def banded_matvec(bands: torch.Tensor, x: torch.Tensor, kl: int, ku: int
                  ) -> torch.Tensor:
    """y = A @ x with A in band storage; x is (N,) or (N, M). One shifted
    multiply-add per diagonal."""
    N = bands.shape[1]
    x2 = x if x.dim() == 2 else x[:, None]
    y = torch.zeros((N, x2.shape[1]), dtype=torch.promote_types(
        bands.dtype, x.dtype), device=x.device)
    for k in range(bands.shape[0]):
        d = ku - k      # y[i] += A[i, i+d] x[i+d] = bands[k, i+d] x[i+d]
        if d >= 0:
            y[: N - d] += bands[k, d:, None] * x2[d:]
        else:
            y[-d:] += bands[k, :d, None] * x2[:d]
    return y if x.dim() == 2 else y[:, 0]


def bcr_block(kl: int, ku: int, N: int, device_type: str) -> int:
    """BCR block size. The least legal block is max(kl, ku, 1): the
    coupling must stay within neighbouring blocks. The CPU keeps it (the
    JAX package's rule off the TPU). On CUDA each level costs a handful of
    batched launches, so narrow bands re-block to 16 rows, two to three
    levels fewer: config 3's solve (N = 2048, kd = 4) 17.9 ms against
    21.1 at the least block, 20.5 at 32 and 27.8 at 64 on an H100
    (``chip_smoke.py --direct-sweep``, ``PERF.md``)."""
    b_min = max(kl, ku, 1)
    if device_type != "cuda" or N <= 256:
        return b_min
    return max(b_min, 16)


def banded_to_blocktridiag(bands: torch.Tensor, kl: int, ku: int,
                           block: int | None = None):
    """Band storage (..., kl+ku+1, N) -> block-tridiagonal (D, L, U, b, N).

    Block size b >= max(kl, ku, 1) (default :func:`bcr_block` for the
    tensor's device); the block count is padded to a power of two with
    identity diagonal blocks (decoupled trailing equations), so BCR runs a
    fixed log2 schedule. D, L, U have shape (..., nb, b, b); L[i] couples
    block i to i-1 (L[0] = 0) and U[i] to i+1 (U[-1] = 0)."""
    nd, N = bands.shape[-2:]
    b = bcr_block(kl, ku, N, bands.device.type) if block is None else block
    if b < max(kl, ku, 1):
        raise ValueError(f"block {b} < half bandwidth max({kl}, {ku})")
    nb = -(-N // b)
    nb_pad = 1 << max(int(np.ceil(np.log2(max(nb, 1)))), 0)
    # every entry A[i, j] = bands[k, j] (d = j - i = ku - k) lands in D, U
    # or L of row block i // b: flat source and target positions, once
    src, tgt = [], []
    for k in range(nd):
        d = ku - k
        i = np.arange(max(0, -d), min(N, N - d))
        j = i + d
        which = (j // b) - (i // b) + 1           # 0: L, 1: D, 2: U
        src.append(k * N + j)
        tgt.append((((which * nb_pad + i // b) * b + i % b) * b) + j % b)
    src = torch.as_tensor(np.concatenate(src), device=bands.device)
    tgt = torch.as_tensor(np.concatenate(tgt), device=bands.device)
    lead = bands.shape[:-2]
    T = torch.zeros(lead + (3 * nb_pad * b * b,), dtype=bands.dtype,
                    device=bands.device)
    T[..., tgt] = bands.reshape(lead + (nd * N,))[..., src]
    T = T.reshape(lead + (3, nb_pad, b, b))
    pad = torch.arange(N, nb_pad * b, device=bands.device)
    T[..., 1, pad // b, pad % b, pad % b] = 1.0      # identity padding
    return T[..., 1, :, :, :], T[..., 0, :, :, :], T[..., 2, :, :, :], b, N


class BCRLevel(NamedTuple):
    lu_odd: torch.Tensor    # (..., m, b, b) LU factors of the odd blocks
    piv_odd: torch.Tensor   # (..., m, b)
    L_odd: torch.Tensor     # (..., m, b, b) odd blocks' couplings
    U_odd: torch.Tensor
    C1: torch.Tensor        # (..., m, b, b) L_even D_{left odd}^-1
    C2: torch.Tensor        # (..., m, b, b) U_even D_{right odd}^-1


def _shift_right(X):
    """Blocks moved one place along the block axis (-3), a zero block
    first: out[k] = X[k - 1]."""
    return torch.cat([torch.zeros_like(X[..., :1, :, :]),
                      X[..., :-1, :, :]], dim=-3)


def _right_div(X, lu, piv):
    """X D^-1 from D's LU factors (a plain transpose solve, never the
    conjugate one)."""
    return torch.linalg.lu_solve(lu, piv, X, left=False)


def bcr_factor(D, L, U):
    """Block cyclic reduction of a block-tridiagonal matrix with a
    power-of-two block count: (levels, root_lu, root_piv), per level the
    elimination operators, the root the last single block. Every operation
    is batched over the leading axes and the level's blocks."""
    levels = []
    while D.shape[-3] > 1:
        Do, Lo, Uo = D[..., 1::2, :, :], L[..., 1::2, :, :], U[..., 1::2, :, :]
        De, Le, Ue = D[..., 0::2, :, :], L[..., 0::2, :, :], U[..., 0::2, :, :]
        lu_o, piv_o = lu_factor(Do)
        # even block 2k: left odd neighbour 2k-1 (odd index k-1, none for
        # k = 0), right odd neighbour 2k+1 (odd index k); the block count
        # is even, so every even block has its right neighbour
        C1 = torch.cat([torch.zeros_like(Le[..., :1, :, :]),
                        _right_div(Le[..., 1:, :, :], lu_o[..., :-1, :, :],
                                   piv_o[..., :-1, :])], dim=-3)
        C2 = _right_div(Ue, lu_o, piv_o)
        L_left, U_left = _shift_right(Lo), _shift_right(Uo)
        D = De - C1 @ U_left - C2 @ Lo
        L, U = -(C1 @ L_left), -(C2 @ Uo)
        levels.append(BCRLevel(lu_o, piv_o, Lo, Uo, C1, C2))
    root_lu, root_piv = lu_factor(D[..., 0, :, :])
    return levels, root_lu, root_piv


def bcr_solve(levels, root_lu, root_piv, rhs_blocks):
    """Solve with a cached BCR factorization; rhs_blocks is (..., nb, b, M)
    and broadcasts against the factors' leading axes."""
    stack = []
    f = rhs_blocks
    for lvl in levels:          # restriction: fold the odd rhs into the even
        fo, fe = f[..., 1::2, :, :], f[..., 0::2, :, :]
        f = fe - lvl.C1 @ _shift_right(fo) - lvl.C2 @ fo
        stack.append(fo)
    x = torch.linalg.lu_solve(root_lu, root_piv, f[..., 0, :, :])[..., None,
                                                                   :, :]
    for lvl, fo in zip(reversed(levels), reversed(stack)):
        # odd block 2k+1: left even neighbour k, right even neighbour k+1
        x_right = torch.cat([x[..., 1:, :, :],
                             torch.zeros_like(x[..., :1, :, :])], dim=-3)
        xo = torch.linalg.lu_solve(
            lvl.lu_odd, lvl.piv_odd,
            fo - lvl.L_odd @ x - lvl.U_odd @ x_right)
        x = torch.stack([x, xo], dim=-3).reshape(
            xo.shape[:-3] + (2 * xo.shape[-3],) + xo.shape[-2:])
    return x
