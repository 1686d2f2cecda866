"""Seeded inputs shared by the generators: the smooth potential and the
interval rule.

The potential is the raw input that the generator (which builds the
operator the port is handed) and the reference (which works the exact
spectrum out again) both receive. ``interval_lowest`` is the interval rule
of the repository's scale experiments (copied from ``chip_smoke.py``).
"""
from __future__ import annotations

import numpy as np


def rng(seed: int, k: int, stream: int) -> np.random.Generator:
    """The generator of problem ``k`` of a run seeded ``seed``; ``stream``
    tells the draws of one problem apart. Any whole seed is taken, also
    one wider than 32 bits or negative."""
    return np.random.default_rng(
        np.random.SeedSequence([int(seed) % (1 << 64), int(k) % (1 << 32),
                                int(stream)]))


def smooth_field(gen: np.random.Generator, n: int, modes: int,
                 amplitude: float) -> np.ndarray:
    """A smooth potential at the n interior grid points of [0, 1]: a sum
    of ``modes`` sines and cosines with N(0, 1) / m weights, mapped
    affinely onto [0, amplitude] exactly (its minimum is 0 and its maximum
    ``amplitude`` on every draw, so the spectrum enclosure does not move
    from seed to seed)."""
    x = np.arange(1, n + 1) / (n + 1)
    m = np.arange(1, modes + 1)[:, None]
    a = gen.standard_normal((modes, 1)) / m
    b = gen.standard_normal((modes, 1)) / m
    g = (a * np.cos(np.pi * m * x) + b * np.sin(np.pi * m * x)).sum(axis=0)
    return amplitude * (g - g.min()) / (g.max() - g.min())


def interval_lowest(w, count=50):
    """(Emin, Emax, expected) for the lowest ~count eigenvalues with Emax
    at a genuine gap (the rule of the repo's scale experiments)."""
    gaps = np.nonzero(np.diff(w) > 1e-12)[0]
    hi = gaps[np.searchsorted(gaps, count)]
    Emin = float(w[0] * 0.5)
    Emax = float(0.5 * (w[hi] + w[hi + 1]))
    return Emin, Emax, w[(w >= Emin) & (w <= Emax)]


def interval_from_zero(w, count=50):
    """(0, Emax, expected): ``phase_consistent_mass``'s rule for a
    positive-definite pencil, Emax in the first gap past the count-th
    eigenvalue."""
    gaps = np.nonzero(np.diff(w) > 1e-12)[0]
    hi = gaps[np.searchsorted(gaps, count)]
    Emax = float(0.5 * (w[hi] + w[hi + 1]))
    return 0.0, Emax, w[w <= Emax]


def subspace_size(count: int) -> int:
    """M0 = ceil(1.3 M) rounded up to a multiple of 8."""
    return int(-(-int(np.ceil(1.3 * count)) // 8) * 8)
