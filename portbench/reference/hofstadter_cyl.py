"""Plain reference of ``generators/hofstadter_cyl.py``'s Harper-Hofstadter
cylinder, from the raw inputs alone (the potential v(x), the flux per
plaquette, the ring's length), in plain PyTorch on the CPU in float64 and
complex128.

The exact eigenvalues: the Fourier transform in y splits H into Ly real
symmetric tridiagonal Harper chains (diagonal 4 + v(x) - 2 cos(k + omega
x), off-diagonals -1, k = 2 pi m / Ly), whose lowest eigenvalues come
from Sturm-count bisection, vectorised over the chains and the indices.
The residuals: H applied by array shifts on the (Lx, Ly, columns) grid,
``torch.roll`` along the ring with the Peierls phases e^{+-i omega x}.
"""
from __future__ import annotations

import math

import numpy as np
import torch

# bisection stops where every bracket is this narrow: 2 ulp of 8, above
# the chains' largest Gershgorin edge (8 + max v is under 9 here)
_WIDTH = 2 * math.ulp(8.0)


def _diagonals(inputs: dict) -> torch.Tensor:
    v = torch.as_tensor(np.asarray(inputs["v"]), dtype=torch.float64)
    ny = int(inputs["ny"])
    omega = 2.0 * math.pi * float(inputs["flux"])
    k = 2.0 * math.pi * torch.arange(ny, dtype=torch.float64) / ny
    x = torch.arange(len(v), dtype=torch.float64)
    return 4.0 + v[None, :] - 2.0 * torch.cos(k[:, None] + omega * x[None, :])


def _count_below(d: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """For each chain c (row of d) and shift sigma[c, j]: how many
    eigenvalues of tridiag(-1, d[c], -1) lie below sigma[c, j], the
    negative pivots of the LDL^T factorisation of the shifted chain. A
    zero pivot needs no guard in IEEE arithmetic: it is +0, so the next
    pivot is -inf and the one after that finite, the count of the chain
    shifted by an infinitesimal."""
    shifted = d[:, :, None] - sigma[:, None, :]
    negative = torch.empty(shifted.shape, dtype=torch.bool)
    q = shifted[:, 0]
    torch.lt(q, 0, out=negative[:, 0])
    for x in range(1, d.shape[1]):
        q = shifted[:, x] - q.reciprocal()
        torch.lt(q, 0, out=negative[:, x])
    return negative.sum(dim=1)


def chain_eigenvalues(inputs: dict, lowest: int) -> torch.Tensor:
    """(Ly, lowest): the ``lowest`` lowest eigenvalues of each chain,
    ascending, by bisection to 2 ulp of 8."""
    d = _diagonals(inputs)
    lo = (d.min(dim=1).values - 2.0)[:, None].repeat(1, lowest)
    hi = (d.max(dim=1).values + 2.0)[:, None].repeat(1, lowest)
    j = torch.arange(lowest)[None, :]
    while bool((hi - lo > _WIDTH).any()):
        mid = 0.5 * (lo + hi)
        above = _count_below(d, mid) > j     # the j-th eigenvalue < mid
        hi = torch.where(above, mid, hi)
        lo = torch.where(above, lo, mid)
    return 0.5 * (lo + hi)


def exact_eigenvalues(inputs: dict, Emin: float, Emax: float,
                      lowest: int = 4) -> np.ndarray:
    """The eigenvalues of H in [Emin, Emax], from the ``lowest`` of each
    chain. Raises where a chain's ``lowest``-th eigenvalue lies at or
    below a finite Emax (the truncation could miss one). An infinite Emax
    (``checks.judge`` asks for the whole spectrum) returns it as far as it
    is complete: up to the least of the chains' ``lowest``-th
    eigenvalues."""
    chains = chain_eigenvalues(inputs, lowest)
    complete = float(chains[:, -1].min())
    if complete <= Emax < math.inf:
        raise ValueError(f"a chain's {lowest}th eigenvalue {complete} lies "
                         f"at or below Emax = {Emax}: raise lowest")
    s = np.sort(chains.numpy().ravel())
    return s[(s >= Emin) & (s <= min(Emax, complete))]


def residuals(inputs: dict, lam, Q, block: int = 8) -> np.ndarray:
    """Each returned pair's ||H x - lam x|| / (max(|lam|, 1) ||x||), H
    applied on the grid in complex128, ``block`` columns at a time."""
    v = torch.as_tensor(np.asarray(inputs["v"]), dtype=torch.float64)
    nx, ny = len(v), int(inputs["ny"])
    omega = 2.0 * math.pi * float(inputs["flux"])
    x = torch.arange(nx, dtype=torch.float64)
    hop = torch.polar(torch.ones(nx, dtype=torch.float64),
                      omega * x)[:, None, None]
    diag = (4.0 + v)[:, None, None].to(torch.complex128)
    lam = np.asarray(lam, np.float64)
    out = []
    for s in range(0, len(lam), block):
        X = torch.as_tensor(np.ascontiguousarray(Q[:, s:s + block]),
                            dtype=torch.complex128)
        lb = torch.as_tensor(lam[s:s + block])
        G = X.reshape(nx, ny, -1)
        R = (diag - lb[None, None, :]) * G
        R[:-1] -= G[1:]
        R[1:] -= G[:-1]
        R -= hop * torch.roll(G, -1, dims=1)           # psi(x, y + 1)
        R -= hop.conj() * torch.roll(G, 1, dims=1)     # psi(x, y - 1)
        out.append(torch.linalg.vector_norm(R.reshape(X.shape), dim=0)
                   / (torch.clamp(lb.abs(), min=1.0)
                      * torch.linalg.vector_norm(X, dim=0)))
    return torch.cat(out).numpy() if out else np.empty(0)
