"""Quadrature contour generation (PyTorch port, host numpy).

A copy of ``feastkit_tpu/core/contour.py``: Gauss-Legendre, trapezoid
and Zolotarev nodes and weights for a real interval (the half contour),
the full contour of the general problems around a complex centre (Gauss as
two half-arcs, or trapezoid; aspect ratio fpm[18], rotation fpm[19]), user
contours with the corrected Cauchy weight, the rational filter evaluators
and the inside-region predicates, bit for bit the JAX package's.

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

__all__ = [
    "feast_contour", "feast_gcontour", "feast_customcontour",
    "feast_contour_expert", "feast_contour_custom_weights",
    "zolotarev_quadrature", "zolotarev_point",
    "feast_rational", "feast_rationalx", "feast_grational", "feast_grationalx",
    "feast_inside_contour", "feast_inside_gcontour",
]

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


def zolotarev_point(n: int, k_index: int):
    """(node, weight) for index k_index in 1..n; k_index=0 returns (0, we0).

    API parity with ``zolotarev_point`` (feast_tools.jl:182-210).
    """
    xe, we, we0 = zolotarev_quadrature(n)
    if k_index == 0:
        return complex(0.0), complex(we0)
    if not 1 <= k_index <= n:
        raise ValueError(f"Zolotarev index must be in 0..{n}, got {k_index}")
    return complex(xe[k_index - 1]), complex(we[k_index - 1])


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


def feast_gcontour(Emid: complex, r: float, fpm=None, *, ne=None,
                   quadrature=None, aspect_ratio=None,
                   rotation_deg=None) -> Contour:
    """Full elliptical contour around complex Emid (feast_tools.jl:286-376).

    Gauss: two half-arcs of ne//2 and ne-ne//2 points (theta in [pi,0] then
    [0,-pi]); trapezoid: theta = pi - (2pi/ne)/2 - (2pi/ne)*e. Both rotated by
    fpm[19] degrees via nr = r*exp(i*rot).
    """
    if fpm is not None:
        fpm = _as_fpm(fpm)
        ne = fpm[8] if ne is None else ne
        quadrature = fpm[16] if quadrature is None else quadrature
        aspect_ratio = fpm[18] / 100.0 if aspect_ratio is None else aspect_ratio
        rotation_deg = fpm[19] if rotation_deg is None else rotation_deg
    ne = 16 if ne is None else int(ne)
    quadrature = 0 if quadrature is None else int(quadrature)
    aspect_ratio = 1.0 if aspect_ratio is None else float(aspect_ratio)
    rotation_deg = 0 if rotation_deg is None else rotation_deg
    if r <= 0:
        raise ValueError(f"Contour radius must be positive, got {r}")
    if quadrature == 2:
        raise ValueError("Zolotarev quadrature is not valid for full (general) contours")

    Emid = complex(Emid)
    rot = rotation_deg / 180.0 * np.pi
    nr = r * np.exp(1j * rot)

    if quadrature == 0:
        n_up = ne // 2
        n_lo = ne - n_up
        zs, ws = [], []
        for count, sign in ((n_up, +1.0), (n_lo, -1.0)):
            x, w = _gauss_legendre(count)
            theta = sign * (-np.pi / 2 * x + np.pi / 2)
            z = Emid + nr * np.cos(theta) + nr * 1j * aspect_ratio * np.sin(theta)
            jac = nr * 1j * np.sin(theta) + nr * aspect_ratio * np.cos(theta)
            zs.append(z)
            ws.append(0.25 * w * jac)
        return Contour(np.concatenate(zs), np.concatenate(ws))

    e = np.arange(ne)
    theta = np.pi - (2 * np.pi / ne) / 2 - (2 * np.pi / ne) * e
    z = Emid + nr * np.cos(theta) + nr * 1j * aspect_ratio * np.sin(theta)
    jac = nr * 1j * np.sin(theta) + nr * aspect_ratio * np.cos(theta)
    return Contour(z, jac / ne)


def feast_customcontour(Zne) -> Contour:
    """Trapezoidal weights from user-provided closed-loop nodes
    (parity: feast_customcontour, feast_tools.jl:378-398).

    Correctness divergence: the reference computes W_i = (Z_{i+1} - Z_{i-1})
    / (2*ne), which is NOT the Cauchy quadrature weight (it is inconsistent
    with the reference's own analytic trapezoid in feast_gcontour:354-367 and
    makes the rational filter of a custom contour ~ i*sin(2pi/ne) instead of
    ~1 inside). We use the correct central-difference Cauchy weight
    W_i = (Z_{i+1} - Z_{i-1}) / (2 * 2*pi*i), so the filter
    sum_i W_i/(Z_i - lam) ~= 1 inside the loop and ~= 0 outside.
    """
    Zne = np.asarray(Zne, dtype=np.complex128)
    Wne = (np.roll(Zne, -1) - np.roll(Zne, 1)) / (2.0 * 2.0j * np.pi)
    # Orientation-normalize: the Cauchy filter needs a counter-clockwise
    # loop; users may supply nodes in either direction (shoelace sign test).
    area = 0.5 * np.imag(np.sum(np.conj(Zne) * np.roll(Zne, -1)))
    if area < 0:
        Wne = -Wne
    return Contour(Zne, Wne)


def feast_contour_expert(Emin: float, Emax: float, ne: int,
                         integration_type: int = 0,
                         ellipse_ratio: int = 100) -> Contour:
    """Expert contour constructor (feast_tools.jl:416-436)."""
    if ne <= 0:
        raise ValueError(f"Number of integration points ne must be positive, got {ne}")
    if not 0 <= integration_type <= 2:
        raise ValueError(f"integration_type must be 0, 1, or 2, got {integration_type}")
    if ellipse_ratio <= 0:
        raise ValueError(f"ellipse_ratio must be positive, got {ellipse_ratio}")
    return feast_contour(Emin, Emax, ne=ne, quadrature=integration_type,
                         aspect_ratio=ellipse_ratio / 100.0)


def feast_contour_custom_weights(Zne, Wne) -> Contour:
    """User supplies both nodes and weights (feast_tools.jl:451-463)."""
    Zne = np.asarray(Zne, dtype=np.complex128)
    Wne = np.asarray(Wne, dtype=np.complex128)
    if Zne.shape != Wne.shape:
        raise ValueError("Zne and Wne must have the same length")
    return Contour(Zne.copy(), Wne.copy())


# ---------------------------------------------------------------------------
# Rational filter evaluators (test oracles for quadrature correctness)
# ---------------------------------------------------------------------------

def feast_rationalx(Zne, Wne, lam) -> np.ndarray:
    """f(lam) = 2*Re sum_e Wne/(Zne - lam) for real lam (half-contour)
    (feast_tools.jl:483-500)."""
    Zne = np.asarray(Zne)[None, :]
    Wne = np.asarray(Wne)[None, :]
    lam = np.atleast_1d(np.asarray(lam, dtype=np.float64))[:, None]
    return 2.0 * np.real(Wne / (Zne - lam)).sum(axis=1)


def feast_rational(lam, Emin: float, Emax: float, fpm=None, **kw) -> np.ndarray:
    """Rational filter with the default elliptical contour; adds the Zolotarev
    we0 constant when fpm[16]==2 (feast_tools.jl:516-531)."""
    fpm_obj = _as_fpm(fpm) if fpm is not None else None
    contour = feast_contour(Emin, Emax, fpm_obj, **kw)
    f = feast_rationalx(contour.Zne, contour.Wne, lam)
    quad = kw.get("quadrature")
    if quad is None and fpm_obj is not None:
        quad = fpm_obj[16]
    if quad == 2:
        ne = kw.get("ne") or (fpm_obj[2] if fpm_obj is not None else 8)
        _, we0 = zolotarev_point(ne, 0)
        f = f + np.real(we0)
    return f


def feast_grationalx(Zne, Wne, lam) -> np.ndarray:
    """f(lam) = sum_e Wne/(Zne - lam) for complex lam (full contour)
    (feast_tools.jl:547-564)."""
    Zne = np.asarray(Zne)[None, :]
    Wne = np.asarray(Wne)[None, :]
    lam = np.atleast_1d(np.asarray(lam, dtype=np.complex128))[:, None]
    return (Wne / (Zne - lam)).sum(axis=1)


def feast_grational(lam, Emid: complex, r: float, fpm=None, **kw) -> np.ndarray:
    contour = feast_gcontour(Emid, r, _as_fpm(fpm) if fpm is not None else None, **kw)
    return feast_grationalx(contour.Zne, contour.Wne, lam)


# ---------------------------------------------------------------------------
# Inside-region predicates (elementwise: numpy arrays or torch tensors)
# ---------------------------------------------------------------------------

def feast_inside_contour(lam, Emin: float, Emax: float):
    """Interval membership (feast_tools.jl:619-621)."""
    return (Emin <= lam) & (lam <= Emax)


def feast_inside_gcontour(lam, Emid: complex, r: float, *, aspect_ratio: float = 1.0,
                          rotation_deg: float = 0.0, fpm=None):
    """Rotated-ellipse membership (feast_tools.jl:623-650):
    un-rotate w = (lam-Emid)*exp(-i*rot), then (Re/r)^2 + (Im/(r*a))^2 <= 1.

    Works elementwise on numpy arrays or torch tensors.
    """
    if fpm is not None:
        fpm = _as_fpm(fpm)
        if fpm[18] > 0:
            aspect_ratio = fpm[18] / 100.0
        rotation_deg = fpm[19]
    w = lam - Emid
    if rotation_deg != 0:
        w = w * np.exp(-1j * (rotation_deg / 180.0 * np.pi))
    x = w.real / r
    y = w.imag / (r * aspect_ratio)
    return x * x + y * y <= 1.0
