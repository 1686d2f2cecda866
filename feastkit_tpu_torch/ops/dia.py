"""Row-aligned DIA (diagonal-offset) storage and its plain matvec.

Counterpart of the host half of ``feastkit_tpu/ops/pallas_kernels.py``.
``diags`` is (nd, N) with a static ``offsets`` tuple; row k holds diagonal
offsets[k] aligned to rows: diags[k, i] = A[i, i + offsets[k]] (zero where
out of range), so

    y[i, :] = sum_k diags[k, i] * x[i + offsets[k], :]

``dia_matvec`` is the plain shifted-add version of that product (the
counterpart of ``dia_matvec_reference``). It serves the f64 Rayleigh-Ritz,
residual and back-transform products, which the JAX package also computes
outside any kernel; the recurrence's matvec is fused into the Chebyshev
step kernels of ``ops/cheb_kernels.py``.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["bands_to_dia", "bcoo_to_dia", "dia_matvec"]


def bands_to_dia(bands, kl: int, ku: int):
    """LAPACK-band layout -> row-aligned (diags, offsets) (host numpy).

    bands[k, j] = A[j - (ku-k), j]  ->  diags[k, i] = A[i, i + d], d = ku-k.
    """
    bands = np.asarray(bands)
    nb, N = bands.shape
    offsets = tuple(ku - k for k in range(nb))
    diags = np.zeros_like(bands)
    for k, d in enumerate(offsets):
        if d >= 0:
            diags[k, : N - d] = bands[k, d:]
        else:
            diags[k, -d:] = bands[k, : N + d]
    return diags, offsets


def bcoo_to_dia(data, indices, N, max_diags: int = 32):
    """COO arrays -> (diags, offsets) if the matrix lives on at most
    ``max_diags`` diagonals, else None (host numpy; duplicates add)."""
    data = np.asarray(data)
    indices = np.asarray(indices)
    offs = indices[:, 1].astype(np.int64) - indices[:, 0].astype(np.int64)
    uniq = np.unique(offs)
    if len(uniq) > max_diags:
        return None
    diags = np.zeros((len(uniq), N), data.dtype)
    pos = np.searchsorted(uniq, offs)
    np.add.at(diags, (pos, indices[:, 0]), data)
    return diags, tuple(int(d) for d in uniq)


def dia_matvec(diags: torch.Tensor, offsets, x: torch.Tensor) -> torch.Tensor:
    """y = A x for (N, M) x by shifted multiply-adds (in-place ``addcmul_``
    on the output: no (N, M) temporary per diagonal)."""
    N = diags.shape[1]
    y = torch.zeros_like(x)
    for k, d in enumerate(offsets):
        if abs(d) >= N:
            continue
        if d >= 0:
            y[: N - d].addcmul_(diags[k, : N - d, None], x[d:])
        else:
            y[-d:].addcmul_(diags[k, -d:, None], x[: N + d])
    return y
