"""The Harper-Hofstadter Hamiltonian of a quantum Hall bar, as the port's
users hand it over: a complex Hermitian scipy CSR matrix and an interval.

On an Lx x Ly square lattice (row index i = x * Ly + y), open in x and
periodic in y (a cylinder), with flux phi per plaquette in the Landau
gauge (omega = 2 pi phi) and a gate potential v(x) across the bar:

    (H psi)(x, y) = (4 + v(x)) psi(x, y) - psi(x + 1, y) - psi(x - 1, y)
                    - e^{i omega x} psi(x, y + 1) - e^{-i omega x} psi(x, y - 1)

psi(-1, .) = psi(Lx, .) = 0 and y is taken mod Ly, so H has seven complex
diagonals: 0, +-1, +-(Ly - 1) (the y bonds across the seam) and +-Ly. H
is a magnetic Laplacian plus a potential: Hermitian, positive
semidefinite, Gershgorin enclosure [0, 8 + max v].

A Fourier transform in y (psi = e^{iky} u(x), k = 2 pi m / Ly) splits H
into Ly real symmetric tridiagonal Harper chains, diagonal
4 + v(x) - 2 cos(k + omega x) and off-diagonals -1; the spectrum of H is
the union of theirs. The interval is the rule of ``schrodinger_fd``
(``fields.interval_lowest``): Emin = lambda_1 / 2, Emax in the first gap
past the ``pairs_past``-th eigenvalue.
"""
from __future__ import annotations

import numpy as np
import scipy.linalg as sla
import scipy.sparse as sp

from . import fields


def operator(v: np.ndarray, flux: float, ny: int) -> sp.csr_matrix:
    """H as a complex128 CSR matrix (no explicit zeros) for the potential
    v (one value per x), the flux per plaquette and the ring's length."""
    nx = len(v)
    if ny < 3:
        raise ValueError(f"the ring needs at least 3 sites, got {ny}")
    omega = 2.0 * np.pi * flux
    x, y = np.divmod(np.arange(nx * ny), ny)
    i = np.arange(nx * ny)
    hop = np.exp(1j * omega * x)                 # the bond (x, y) -> (x, y+1)
    along = x < nx - 1
    rows = np.concatenate([i, i[along], i[along] + ny, i, i])
    cols = np.concatenate([i, i[along] + ny, i[along],
                           x * ny + (y + 1) % ny, x * ny + (y - 1) % ny])
    data = np.concatenate([4.0 + v[x] + 0j, -np.ones(along.sum()) + 0j,
                           -np.ones(along.sum()) + 0j, -hop, -hop.conj()])
    return sp.csr_matrix((data, (rows, cols)), shape=(nx * ny, nx * ny))


def chain_diagonals(v: np.ndarray, flux: float, ny: int) -> np.ndarray:
    """(Ly, Lx): the diagonal of each Harper chain, 4 + v(x) -
    2 cos(2 pi m / Ly + omega x)."""
    omega = 2.0 * np.pi * flux
    k = 2.0 * np.pi * np.arange(ny) / ny
    x = np.arange(len(v))
    return 4.0 + v[None, :] - 2.0 * np.cos(k[:, None] + omega * x[None, :])


def lowest_chains(v: np.ndarray, flux: float, ny: int,
                  count: int) -> np.ndarray:
    """(Ly, count): the ``count`` lowest eigenvalues of each chain."""
    off = -np.ones(len(v) - 1)
    return np.stack([sla.eigh_tridiagonal(d, off, eigvals_only=True,
                                          select="i",
                                          select_range=(0, count - 1))
                     for d in chain_diagonals(v, flux, ny)])


def build(cfg: dict, seed: int, k: int) -> dict:
    """Problem ``k`` of a run seeded ``seed``."""
    nx, ny = cfg["grid"]
    flux = float(cfg["flux"])
    pot = cfg["potential"]
    omega = 2.0 * np.pi * flux
    v = fields.smooth_field(fields.rng(seed, k, 0), nx, pot["modes"],
                            pot["amplitude_over_omega"] * omega)
    chains = lowest_chains(v, flux, ny, cfg["lowest_1d"])
    Emin, Emax, exp = fields.interval_lowest(np.sort(chains.ravel()),
                                             cfg["pairs_past"])
    if chains[:, -1].min() <= Emax:
        raise ValueError(f"a chain's {cfg['lowest_1d']}th eigenvalue "
                         f"{chains[:, -1].min()} lies at or below Emax = "
                         f"{Emax}: raise lowest_1d")
    if fields.subspace_size(len(exp)) != cfg["M0"]:
        raise ValueError(f"{len(exp)} pairs want M0 = "
                         f"{fields.subspace_size(len(exp))}, the "
                         f"configuration states {cfg['M0']}")
    return dict(A=operator(v, flux, ny), B=None, interval=(Emin, Emax),
                M0=cfg["M0"], count=len(exp),
                inputs=dict(v=v, flux=flux, ny=ny))
