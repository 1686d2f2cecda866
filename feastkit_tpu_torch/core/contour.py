"""Quadrature contour generation (PyTorch port, host numpy).

A copy of the half-contour part of ``feastkit_tpu/core/contour.py``:
Gauss-Legendre, trapezoid and Zolotarev nodes and weights for a real
interval. The full-contour (general) rules belong to engines not yet
ported.

Unlike the reference, the Zolotarev rule is *derived* rather than tabulated:
FEAST's hard-coded tables (feast_tools.jl:50-180, from libnum.f90) are the
Zolotarev optimal rational sign approximant on +-[delta, 1/delta] with
delta = 1e-3 (modulus k = 1e-6), Cayley-mapped onto the unit circle. We build
that approximant from Jacobi elliptic functions, which supports every n >= 1
(the reference only supports n in {1..8,10,12,16,20}).
"""
from __future__ import annotations

import functools

import numpy as np
from scipy.special import ellipkm1

from .types import Contour
from .parameters import FeastParameters, feastdefault, FEAST_UNINITIALIZED

__all__ = ["feast_contour", "zolotarev_quadrature"]

# ---------------------------------------------------------------------------
# Zolotarev quadrature (optimal rational filter for real intervals)
# ---------------------------------------------------------------------------

_ZOLOTAREV_GAP_K = 1e-6  # modulus k: sign approximated on +-[k, 1] in sigma


def _sc_complementary(u: np.ndarray, k: float) -> np.ndarray:
    """sc(u, k') = sn(u,k')/cn(u,k') for k' = sqrt(1-k^2), k tiny.

    Via Jacobi's imaginary transformation sc(u,k') = -i*sn(iu,k) and the
    small-modulus expansion sn(w,k) = sin w - (k^2/4)(w - sin w cos w) cos w,
    which at w = iu gives sinh u + (k^2/4)(u - sinh u cosh u * ... ) — exact to
    O(k^4 e^{4u}) ~ 1e-24 * e^{4u}, far below float64 eps for the u <= K'/2
    range used here.
    """
    sh, ch = np.sinh(u), np.cosh(u)
    return sh + (k * k / 4.0) * (sh * ch - u) * ch


@functools.lru_cache(maxsize=64)
def zolotarev_quadrature(n: int, k: float = _ZOLOTAREV_GAP_K):
    """Degree-n Zolotarev quadrature for the FEAST half-contour.

    Returns ``(xe, we, we0)``: n nodes on the unit circle (upper half plane),
    n complex weights, and the constant term we0, such that the rational
    filter  f(x) = we0 + sum_j 2 Re(we_j / (xe_j - x))  equioscillates around
    1 on (-1,1) and around 0 on |x|>1 (real x), with transition width ~1e-3.

    Construction (matches FEAST libnum.f90 tables to ~1e-6, the precision of
    the elliptic-function evaluation; see feast_tools.jl:50-180 for the
    tabulated reference values and Guettel/Polizzi 2013-2015):

      - Zolotarev type-(2n-1,2n) sign approximant R on +-[k,1]:
        c_j = k^2 sc^2(j*K'/(2n), k'), R(s) = M*s*prod(s^2+c_even)/prod(s^2+c_odd)
      - poles s_j = i*sqrt(c_odd) mapped through the Cayley transform
        x = (1+s/delta)/(1-s/delta), delta = sqrt(k), onto the unit circle
      - filter f(x) = (1 - R(delta*(x-1)/(x+1)))/2, expanded in partial
        fractions; we0 = f(inf) = (1 - R(delta))/2.
    """
    if n < 1:
        raise ValueError(f"Zolotarev degree must be >= 1, got {n}")
    Kp = float(ellipkm1(k * k))          # K(k') evaluated accurately
    # c_j = k^2 sc^2(j*K'/(2n), k'), j = 1..2n-1. The small-k expansion in
    # _sc_complementary is only accurate for u <= K'/2 (|k*sinh(u)| << 1), so
    # compute j < n directly and obtain j > n from the exact self-reciprocity
    # c_j * c_{2n-j} = k^2 (sc(K'-u,k') = 1/(k*sc(u,k'))); c_n = k exactly.
    c = np.empty(2 * n - 1, dtype=np.float64)
    j_lo = np.arange(1, n)
    if n > 1:
        u = j_lo * Kp / (2 * n)
        c[:n - 1] = (k * k) * _sc_complementary(u, k) ** 2
        c[n:] = (k * k) / c[:n - 1][::-1]
    c[n - 1] = k
    c_odd = c[0::2]      # n pole parameters
    c_even = c[1::2]     # n-1 zero parameters

    def R_unnormalized(sig):
        sig = np.asarray(sig, dtype=np.complex128)
        num = sig * np.prod(sig[..., None] ** 2 + c_even, axis=-1)
        den = np.prod(sig[..., None] ** 2 + c_odd, axis=-1)
        return num / den

    # Equioscillation normalization M = 2/(max+min of R_un on [k,1]).
    # Extrema are the roots of the log-derivative
    #   g(y) = 1 + sum 2y/(y+c_even) - sum 2y/(y+c_odd),  y = sigma^2,
    # a smooth function whose 2n-1 roots on (k^2, 1) are well separated in
    # log(y); bracket on a log grid and polish with brentq -> machine-precision
    # extremal values (the reference's tables carry 17 digits; grid search
    # alone loses mu for large n where mu ~ 1e-6).
    from scipy.optimize import brentq

    def g(logy):
        y = np.exp(logy)
        return (1.0 + np.sum(2.0 * y / (y + c_even[:, None]), axis=0)
                - np.sum(2.0 * y / (y + c_odd[:, None]), axis=0))

    logy_grid = np.linspace(np.log(k * k), 0.0, 200002)
    gv = g(logy_grid)
    roots = []
    sign_flip = np.nonzero(np.sign(gv[:-1]) != np.sign(gv[1:]))[0]
    for i in sign_flip:
        roots.append(brentq(lambda ly: float(g(np.array([ly]))[0]),
                            logy_grid[i], logy_grid[i + 1], xtol=1e-15))
    crit = np.exp(np.array(roots) / 2.0)          # sigma at extrema
    crit = np.concatenate([[k], crit, [1.0]])      # endpoints are extremal too
    vals = np.real(R_unnormalized(crit))
    vmax, vmin = float(vals.max()), float(vals.min())
    M = 2.0 / (vmax + vmin)
    mu = (vmax - vmin) / (vmax + vmin)   # equioscillation error (docs only)

    delta = np.sqrt(k)
    t = np.sqrt(c_odd) / delta
    xe = (1.0 + 1j * t) / (1.0 - 1j * t)     # unit-circle nodes, upper half

    # Residues of R at sig_j = i*sqrt(c_odd_j)
    sig_j = 1j * np.sqrt(c_odd)
    rho = np.empty(n, dtype=np.complex128)
    for i in range(n):
        num = M * sig_j[i] * np.prod(sig_j[i] ** 2 + c_even)
        den = np.prod(np.delete(sig_j[i] ** 2 + c_odd, i)) * (2.0 * sig_j[i])
        rho[i] = num / den
    # f(x) = (1 - R(sigma(x)))/2, sigma(x) = delta*(x-1)/(x+1),
    # sigma'(x) = 2*delta/(x+1)^2 ; filter convention f = we0 + 2Re(we/(xe-x))
    we = 0.5 * rho * (xe + 1.0) ** 2 / (2.0 * delta)
    we0 = complex((1.0 - M * np.real(
        np.prod(delta ** 2 + c_even) * delta / np.prod(delta ** 2 + c_odd))) / 2.0)

    # Order nodes by ascending real part (matches the reference tables)
    order = np.argsort(xe.real)
    return xe[order], we[order], we0


# ---------------------------------------------------------------------------
# Gauss-Legendre (host-side; the solver bakes nodes in at trace time)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=128)
def _gauss_legendre(n: int):
    x, w = np.polynomial.legendre.leggauss(n)
    return x, w


# ---------------------------------------------------------------------------
# Contours
# ---------------------------------------------------------------------------

def _as_fpm(fpm) -> FeastParameters:
    if not isinstance(fpm, FeastParameters):
        fpm = FeastParameters(fpm)
    if fpm[2] == FEAST_UNINITIALIZED or fpm[2] <= 0 or fpm[16] == FEAST_UNINITIALIZED:
        feastdefault(fpm)
    return fpm


def feast_contour(Emin: float, Emax: float, fpm=None, *, ne=None,
                  quadrature=None, aspect_ratio=None) -> Contour:
    """Elliptical half-contour over [Emin, Emax] (feast_tools.jl:212-284).

    Node e: theta = -pi/2*x_e + pi/2 in [pi, 0];
    z = Emid + r cos(theta) + i*r*aspect*sin(theta);
    weight = 1/4 * w_e * (i*r*sin(theta) + r*aspect*cos(theta))  [Gauss]
           = 1/(2*ne) * jac                                      [trapezoid].
    Zolotarev: z = xe*r + Emid, w = we*r.

    Accepts either an fpm array/object or explicit keyword overrides.
    """
    if fpm is not None:
        fpm = _as_fpm(fpm)
        ne = fpm[2] if ne is None else ne
        quadrature = fpm[16] if quadrature is None else quadrature
        aspect_ratio = fpm[18] / 100.0 if aspect_ratio is None else aspect_ratio
    ne = 8 if ne is None else int(ne)
    quadrature = 0 if quadrature is None else int(quadrature)
    aspect_ratio = 1.0 if aspect_ratio is None else float(aspect_ratio)
    if not Emax > Emin:
        raise ValueError(f"Invalid interval: Emin={Emin} must be < Emax={Emax}")

    r = (Emax - Emin) / 2.0
    Emid = Emin + r

    if quadrature == 2:      # Zolotarev
        xe, we, _ = zolotarev_quadrature(ne)
        return Contour(xe * r + Emid, we * r)

    if quadrature == 0:      # Gauss-Legendre
        x, w = _gauss_legendre(ne)
        theta = -np.pi / 2 * x + np.pi / 2
        z = Emid + r * np.cos(theta) + 1j * r * aspect_ratio * np.sin(theta)
        jac = r * 1j * np.sin(theta) + r * aspect_ratio * np.cos(theta)
        return Contour(z, 0.25 * w * jac)

    # trapezoid
    e = np.arange(ne)
    theta = np.pi - (np.pi / ne) / 2 - (np.pi / ne) * e
    z = Emid + r * np.cos(theta) + 1j * r * aspect_ratio * np.sin(theta)
    jac = r * 1j * np.sin(theta) + r * aspect_ratio * np.cos(theta)
    return Contour(z, jac / (2.0 * ne))
