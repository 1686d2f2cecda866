"""Chebyshev polynomial spectral-projector filter (PyTorch port).

Counterpart of ``feastkit_tpu/ops/chebfilter.py``. The coefficient
builders are host numpy, copied from the JAX package so that both packages
build the same filter bits: the Gershgorin enclosure, the Jackson-damped
indicator expansion and its auto degree (which reads
``FEAST_CHEB_DEGREE_SCALE`` as the JAX package does), and the Chebyshev
realization of the rational contour filter, and for sparse SPD B the
closed-form polynomial inverse ``cheb_inverse_coeffs`` and the composite's
enclosure ``binva_enclosure``. ``make_cheb_filter`` is the plain recurrence
on tensors and ``make_apply_binv_a`` the plain composite q(B) A (a
Clenshaw sum on tensors); the fused kernels that carry them on the card
live in ``ops/cheb_kernels.py`` and ``ops/cheb_gen.py``.
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils import trace

__all__ = [
    "gershgorin_interval", "cheb_indicator_coeffs", "cheb_eval_scalar",
    "auto_cheb_degree", "build_cheb_filter_coeffs", "make_cheb_filter",
    "make_cheb_stepper", "rational_eval_scalar",
    "rational_filter_cheb_coeffs", "ChebInfeasible", "cheb_inverse_coeffs",
    "make_apply_binv_a", "binva_enclosure",
]


class ChebInfeasible(ValueError):
    """A polynomial filter cannot resolve the requested configuration
    (degree cap bound, contour nodes on the real axis, ...). Routers catch
    this to fall back to the Krylov contour engine; explicit solver=
    requests surface it as the ValueError it is."""


def gershgorin_interval(data, idx, N):
    """Spectrum enclosure [lo, hi] of a (Hermitian) COO matrix by
    Gershgorin discs — host-side, O(nnz), no device work. Safe (always
    contains the spectrum); the Chebyshev filter only needs an enclosure,
    an overestimate merely costs a slightly higher degree."""
    data = np.asarray(data)
    idx = np.asarray(idx)
    rowsum = np.zeros(N, np.float64)
    np.add.at(rowsum, idx[:, 0], np.abs(data).astype(np.float64))
    diag = np.zeros(N, np.float64)
    mask = idx[:, 0] == idx[:, 1]
    np.add.at(diag, idx[mask, 0], np.real(data[mask]).astype(np.float64))
    radius = rowsum - np.abs(diag)
    lo = float(np.min(diag - radius))
    hi = float(np.max(diag + radius))
    # Gershgorin already STRICTLY encloses the spectrum, so the recurrence
    # cannot diverge (T_k stays bounded on [-1,1] for every eigenvalue);
    # the pad only guards the f32 rounding of the affine map's scale/shift
    # (~1e-7 relative). Keep it TINY: for edge intervals (lowest eigenpairs
    # of a Laplacian, exactly where polynomial filtering is used) the
    # arccos-span of the target interval scales like sqrt(E - lo), so an
    # oversized pad directly inflates the auto filter degree — a 1e-3
    # relative pad cost 2-4x the matvecs on the BASELINE configs.
    pad = 1e-6 * max(hi - lo, 1.0)
    return lo - pad, hi + pad


def _jackson_damping(m):
    """Jackson damping factors g_k, k=0..m (kills the Gibbs oscillation of
    the truncated indicator expansion; g_0 = 1)."""
    k = np.arange(m + 1, dtype=np.float64)
    alpha = np.pi / (m + 2)
    return ((m + 2 - k) * np.sin(alpha) * np.cos(k * alpha)
            + np.cos(alpha) * np.sin(k * alpha)) / ((m + 2) * np.sin(alpha))


def cheb_indicator_coeffs(lo, hi, Emin, Emax, degree):
    """Damped Chebyshev coefficients of the indicator of [Emin, Emax] on
    the spectrum enclosure [lo, hi] (host numpy, f64).

    With x = (2*lam - (hi+lo))/(hi-lo) and theta = arccos(x), the exact
    expansion of the indicator over x in [x_lo, x_hi] is
    c_0 = (t_lo - t_hi)/pi, c_k = 2 (sin(k t_lo) - sin(k t_hi)) / (k pi),
    where t_lo = arccos(x_lo) >= t_hi = arccos(x_hi)."""
    m = int(degree)
    if m < 2:
        raise ValueError(f"cheb degree must be >= 2, got {m}")
    x_lo = (2.0 * Emin - (hi + lo)) / (hi - lo)
    x_hi = (2.0 * Emax - (hi + lo)) / (hi - lo)
    x_lo, x_hi = np.clip(x_lo, -1.0, 1.0), np.clip(x_hi, -1.0, 1.0)
    t_lo, t_hi = np.arccos(x_lo), np.arccos(x_hi)
    k = np.arange(1, m + 1, dtype=np.float64)
    c = np.empty(m + 1, np.float64)
    c[0] = (t_lo - t_hi) / np.pi
    c[1:] = 2.0 * (np.sin(k * t_lo) - np.sin(k * t_hi)) / (k * np.pi)
    return c * _jackson_damping(m)


def cheb_eval_scalar(coeffs, lo, hi, lam):
    """Host evaluation of the scalar filter rho(lam) (Clenshaw) — the test
    oracle and the normalization/quality probe."""
    lam = np.asarray(lam, np.float64)
    x = (2.0 * lam - (hi + lo)) / (hi - lo)
    b1 = np.zeros_like(x)
    b2 = np.zeros_like(x)
    for ck in coeffs[:0:-1]:
        b1, b2 = 2.0 * x * b1 - b2 + ck, b1
    return x * b1 - b2 + coeffs[0]


def auto_cheb_degree(lo, hi, Emin, Emax, *, cap=8000, floor=32):
    """Degree rule: the Jackson-damped indicator's edge transition width in
    theta = arccos space is ~ 2*pi/m; ask for it to be <= ~20% of the
    interval's theta-span so the filter plateaus inside and decays hard
    just outside. Near the spectrum edges arccos stretches quadratically,
    which is exactly the regime (lowest eigenpairs of a Laplacian) where
    polynomial filtering shines.

    INTERIOR intervals (both edges well inside the enclosure) get twice
    the degree: there the arccos map has no quadratic stretching, so a
    transition band of the same theta-width holds proportionally many
    more eigenvalues whose filter values (~0.3-0.5) pin the per-loop
    contraction — measured 20 refinement loops at the edge-tuned degree
    vs ~6 at 2x on a 400-dof interior fixture."""
    x_lo = np.clip((2.0 * Emin - (hi + lo)) / (hi - lo), -1.0, 1.0)
    x_hi = np.clip((2.0 * Emax - (hi + lo)) / (hi - lo), -1.0, 1.0)
    t_lo, t_hi = np.arccos(x_lo), np.arccos(x_hi)
    span = max(float(t_lo - t_hi), 1e-12)
    # edge-type = the interval hugs a spectrum end (within 1% of the
    # theta range, e.g. "lowest eigenpairs" with Emin below lambda_min);
    # everything else counts as interior
    edge = (t_lo >= 0.99 * np.pi) or (t_hi <= 0.01 * np.pi)
    sharp = 10.0 if edge else 20.0
    # experimentation knob for the degree-vs-loop-count tradeoff studies
    # (scripts/probe_degree.py): scales the auto degree, default 1.0
    import os
    scale = float(os.environ.get("FEAST_CHEB_DEGREE_SCALE", "1.0"))
    return int(np.clip(np.ceil(scale * sharp * np.pi / span), floor, cap))


def build_cheb_filter_coeffs(lo, hi, Emin, Emax, degree=None, *, cap=8000,
                             degree_scale=1.0):
    """Coefficients normalized by the PLATEAU value max_{[Emin,Emax]} rho,
    so inside values land in ~[0.5, 1] exactly like the rational contour
    filter (1 in the interior, 0.5 at the edges): the kernel's spurious
    test rho > 0.25 and the fpm[14]=2 stochastic count E[v^T P v] then see
    the same scales on either filter. Returns (coeffs, info dict with
    degree/inside_min/outside levels)."""
    if degree is None or int(degree) <= 0:
        degree = auto_cheb_degree(lo, hi, Emin, Emax, cap=cap)
        # ladder sharpening (see solvers/sparse: a mixed-precision ladder
        # spends >= 2 rungs; log outside-level scales ~linearly with
        # degree, so a 1.5x-sharper indicator trades expensive DS/f64
        # loops for ~equal total matvecs — measured 1M: 27.7 -> 25.2 s)
        degree = int(np.clip(np.ceil(degree_scale * degree), degree, cap))
    c = cheb_indicator_coeffs(lo, hi, Emin, Emax, int(degree))
    grid = np.linspace(Emin, Emax, 257)
    inside = cheb_eval_scalar(c, lo, hi, grid)
    inside_min = float(np.min(inside))
    inside_max = float(np.max(inside))
    if inside_min <= 0.25 * inside_max or inside_max <= 0:
        raise ValueError(
            f"Chebyshev filter of degree {degree} cannot resolve the "
            f"interval [{Emin}, {Emax}] inside the spectrum enclosure "
            f"[{lo}, {hi}]; raise the degree cap")
    c = c / inside_max
    inside_min = inside_min / inside_max
    # quality probes: filter level one interval-width outside each edge
    w = Emax - Emin
    probes = np.array([Emin - w, Emax + w])
    probes = probes[(probes > lo) & (probes < hi)]
    out_level = (float(np.max(np.abs(cheb_eval_scalar(c, lo, hi, probes))))
                 if probes.size else 0.0)
    return c, {"degree": int(degree), "inside_min": inside_min,
               "outside_at_1w": out_level}


def cheb_inverse_coeffs(b_lo, b_hi, rel_err, *, cap=512):
    """Chebyshev coefficients of 1/x on [b_lo, b_hi] (0 < b_lo < b_hi) to
    relative accuracy ``rel_err``, host numpy.

    The expansion is geometric: with kappa = b_hi/b_lo the error decays
    like ((sqrt(kappa)-1)/(sqrt(kappa)+1))^m, so diagonally-scaled FEM
    mass matrices (kappa ~ 3..10 after unit-diagonal congruence) need
    m ~ 15..60 for 1e-10. Coefficients by closed form: for
    x = c + d t (c = (b_hi+b_lo)/2, d = (b_hi-b_lo)/2),
    1/x = (2/s) sum_k' (-q)^k T_k(t) with s = sqrt(c^2 - d^2) (geometric
    mean of the endpoints) and q = (c - s)/d. Verified on a grid; the
    degree is the smallest m meeting rel_err (capped)."""
    b_lo, b_hi = float(b_lo), float(b_hi)
    if not 0 < b_lo < b_hi:
        raise ValueError(f"need 0 < b_lo < b_hi, got [{b_lo}, {b_hi}]")
    c = 0.5 * (b_hi + b_lo)
    d = 0.5 * (b_hi - b_lo)
    s = np.sqrt(c * c - d * d)
    q = (c - s) / d
    # error after truncating at degree m ~ q^(m+1)/(1-q) relative to 1/x
    m = int(np.ceil(np.log(max(rel_err, 1e-16) * (1.0 - q))
                    / np.log(q))) if q > 0 else 1
    m = int(np.clip(m, 2, cap))
    k = np.arange(m + 1, dtype=np.float64)
    coef = (2.0 / s) * (-q) ** k
    coef[0] *= 0.5
    # verify on a grid (guards the closed form and the cap)
    t = np.cos(np.linspace(0.0, np.pi, 257))
    x = c + d * t
    b1 = np.zeros_like(t)
    b2 = np.zeros_like(t)
    for ck in coef[:0:-1]:
        b1, b2 = 2.0 * t * b1 - b2 + ck, b1
    approx = t * b1 - b2 + coef[0]
    err = float(np.max(np.abs(approx * x - 1.0)))
    return coef, {"degree": m, "rel_err": err, "kappa": b_hi / b_lo}


def make_apply_binv_a(apply_A, apply_B, b_lo, b_hi, qcoeffs):
    """Composite operator closure X -> q(B)(A X) with q ~= inverse of B on
    [b_lo, b_hi]: the polynomial-inverse spectral transform that extends
    the solve-free Chebyshev filter to generalized pencils with sparse SPD
    B (consistent FEM mass matrices). q(B)A is similar to the symmetric
    q(B)^1/2 A q(B)^1/2, so its spectrum is real and ~= that of B^-1 A to
    the inverse-polynomial accuracy; the FEAST outer loop does exact
    generalized Rayleigh-Ritz with the TRUE pencil, so the approximation
    only shapes the subspace. Evaluation by the Clenshaw recurrence on
    B-hat in the operand's precision: the map scalars are computed from
    ``b_lo`` / ``b_hi`` and ``qcoeffs`` rounded to that precision, as the
    JAX package computes them from its traced arrays. The plain version of
    the fused composite (``ops/cheb_gen.py``); the pencil-edge Lanczos of
    ``solvers/sparse.py`` runs on it."""
    nb = len(qcoeffs)

    def apply_C(X):
        Y = apply_A(X)
        rdt = np.float32 if Y.dtype == torch.float32 else np.float64
        cs = np.asarray(qcoeffs, rdt)
        lo_, hi_ = rdt(b_lo), rdt(b_hi)
        sc = float(rdt(2.0) / (hi_ - lo_))
        sh = float((hi_ + lo_) / (hi_ - lo_))

        def bhat(V):
            return sc * apply_B(V) - sh * V

        b1, b2 = float(cs[nb - 1]) * Y, torch.zeros_like(Y)
        for k in range(1, nb - 1):
            b1, b2 = 2.0 * bhat(b1) - b2 + float(cs[nb - 1 - k]) * Y, b1
        return bhat(b1) - b2 + float(cs[0]) * Y

    return apply_C


def binva_enclosure(a_lo, a_hi, b_lo, b_hi, inv_err):
    """Safe spectrum enclosure of q(B)A from enclosures of A ([a_lo,a_hi],
    Gershgorin) and B ([b_lo,b_hi], 0 < b_lo): the Rayleigh quotient of
    the similar symmetric form gives lam(B^-1 A) within the extreme
    quotients a/b.

    The polynomial-inverse perturbation is RELATIVE per eigenvalue, not
    global: q(B)A is similar to P^(1/2) C P^(1/2) with C = B^-1/2 A B^-1/2
    and P = f(B), f(b) = b q(b) in [1-inv_err, 1+inv_err], so by
    Ostrowski's theorem every composite eigenvalue is lam_i(C) * theta_i
    with theta_i in [1-inv_err, 1+inv_err]. Padding each end by
    inv_err*|end| (instead of inv_err*max|end|) keeps the spectral-edge
    arccos advantage at the LOWER edge of stiffness pencils, where a
    global pad ~inv_err*hi would rival the target interval's width."""
    combos = [a_lo / b_lo, a_lo / b_hi, a_hi / b_lo, a_hi / b_hi]
    lo, hi = min(combos), max(combos)
    tiny = 1e-8 * max(hi - lo, 1.0)
    e = float(inv_err)
    return lo - e * abs(lo) - tiny, hi + e * abs(hi) + tiny


def make_cheb_filter(apply_A, lo, hi, coeffs):
    """Filter closure Q -> rho(A) Q by the three-term recurrence on
    tensors (the plain version: ~degree ``apply_A`` calls). ``coeffs`` is
    a 1-D host array; the recurrence runs in Q's dtype."""
    step = make_cheb_stepper(apply_A, lo, hi)

    def filt(Q):
        carry = _cheb_init(apply_A, lo, hi, Q, coeffs)
        for ck in coeffs[2:]:
            carry = step(carry, ck)
        return carry[2]

    return filt


def _map_scalars(lo, hi, dtype):
    """sc = 2 / (hi - lo) and sh = (hi + lo) / (hi - lo), computed in the
    real precision of the operand dtype ``dtype`` (as the JAX package
    computes them from its traced lo / hi)."""
    rdt = np.float32 if dtype in (torch.float32, torch.complex64) \
        else np.float64
    lo_, hi_ = rdt(lo), rdt(hi)
    return float(rdt(2.0) / (hi_ - lo_)), float((hi_ + lo_) / (hi_ - lo_))


def _ahat(apply_A, lo, hi, X):
    sc, sh = _map_scalars(lo, hi, X.dtype)
    return (sc * apply_A(X)).sub_(X, alpha=sh)


def _cheb_init(apply_A, lo, hi, Q, coeffs):
    """(T0, T1, acc) after the k=0,1 terms: four torch passes around the
    product (the scale and the shift of Ahat, c0 Q and the sum)."""
    trace.count_glue(4)
    T1 = _ahat(apply_A, lo, hi, Q)
    return Q, T1, torch.add(float(coeffs[0]) * Q, T1, alpha=float(coeffs[1]))


def make_cheb_stepper(apply_A, lo, hi):
    """One recurrence step (carry, c_k) -> carry: T2 = 2 Ahat T1 - T0 and
    acc += c_k T2, with the same roundings as the JAX package's
    2 (sc A T1 - sh T1) - T0 (a factor 2 is exact), in place on the new T2
    and on acc (the carry owns acc): four torch passes around the
    product."""

    def step(carry, ck):
        trace.count_glue(4)
        T0, T1, acc = carry
        sc, sh = _map_scalars(lo, hi, T1.dtype)
        T2 = (2.0 * sc) * apply_A(T1)
        T2.sub_(T1, alpha=2.0 * sh).sub_(T0)
        return T1, T2, acc.add_(T2, alpha=float(ck))

    return step


# ----------------------------------------------------------------------
# Polynomial realization of the CONTOUR filter (the rational FEAST filter
# rho(lam) = sum_e 2 Re[w_e / (z_e - lam)] applied as a Chebyshev series).
#
# Key structural fact: every contour node's resolvent action shares the
# SAME Chebyshev basis T_k(A_hat) Y — so the whole quadrature sum is ONE
# polynomial (coefficients = the DCT of the scalar rational filter over
# the spectrum enclosure), applied by the same fused recurrence kernels
# as the indicator filter (ops/cheb_kernels.py). This keeps the
# reference's quadrature semantics EXACTLY (node count fpm[2], rule
# fpm[16], ellipse fpm[18], expert/custom node sets — they all just
# change the scalar function being expanded) while replacing ne
# preconditioned Krylov solves per refinement loop with ~degree fused
# DIA matvecs; parity target: the contour drivers' per-node solve loop
# (feast_sparse.jl:294,334-348 in FeastKit.jl).
#
# The expansion converges geometrically with rate set by the contour
# node CLOSEST to the real axis (Bernstein ellipse through z_e):
# degree ~ ln(1/tol) / (2 sqrt(min_e Im z_e / span)). Feasibility is
# decided here; infeasible configurations raise ChebInfeasible so the
# sparse driver's auto-router can fall back to the Krylov contour
# engine instead of silently under-resolving.
# ----------------------------------------------------------------------


def rational_eval_scalar(Zne, Wne, lam):
    """Host oracle: the FEAST rational filter rho(lam) = sum_e
    2 Re[w_e/(z_e - lam)] for real lam (half-contour node sets; the
    conjugate half enters through the 2 Re, matching filter_partial_pair's
    accumulation and the reference's -2*real(omega*Qe) update)."""
    lam = np.asarray(lam, np.float64)
    acc = np.zeros(lam.shape, np.float64)
    for z, w in zip(np.asarray(Zne), np.asarray(Wne)):
        acc = acc + 2.0 * np.real(w / (z - lam))
    return acc


def rational_filter_cheb_coeffs(Zne, Wne, lo, hi, Emin, Emax, *,
                                tol=1e-4, cap=16000, lo_tol=3e-3):
    """Chebyshev coefficients of the rational contour filter on the
    spectrum enclosure [lo, hi] (host numpy + DCT; compile-time data).

    Returns (coeffs, info): ``coeffs`` is the f64 coefficient array
    truncated at the first degree whose TAIL SUM sum_{k>deg} |c_k| falls
    below ``tol`` — |T_k| <= 1 on the enclosure, so the tail sum IS a
    sup-norm bound on the filter perturbation. A perturbed filter is
    still a polynomial of A (identical eigenvectors); the perturbation
    only floors the per-loop contraction at ~2*tol, so tol = 1e-4 still
    reaches 1e-10 residuals in ~3 refinement loops while shaving ~30% of
    the degree a last-coefficient criterion would demand. ``info``
    carries degree / inside_min / outside_at_1w / trunc_err and
    ``degree_lo`` — the shorter truncation at ``lo_tol`` that the f32
    recurrence rung runs (that rung's loops stop at epsout ~1e-5
    anyway, so a tighter filter there is pure waste).

    Raises ChebInfeasible when a node sits on (or numerically at) the
    real axis inside the enclosure, or when the cap-bounded expansion
    cannot resolve the filter — the caller falls back to the Krylov
    contour engine.
    """
    from scipy.fft import dct

    Zne = np.asarray(Zne, np.complex128)
    Wne = np.asarray(Wne, np.complex128)
    lo, hi = float(lo), float(hi)
    if not hi > lo:
        raise ValueError(f"need lo < hi, got [{lo}, {hi}]")
    span = hi - lo
    im_min = float(np.abs(np.imag(Zne)).min()) if Zne.size else 0.0
    if im_min <= 1e-13 * max(span, 1.0):
        raise ChebInfeasible(
            "contour-polynomial filter needs every quadrature node "
            f"strictly off the real axis; min |Im z_e| = {im_min:.3g}")
    # Resolution floor: a degree-d expansion cannot represent features
    # narrower than ~pi/d in theta = arccos space, so representing the
    # interval's plateau at all needs d >= ~3 pi / theta_span. Checked
    # BEFORE the DCT: a sliver narrower than the sampling grid is
    # invisible to the transform (the sampled filter is ~0 everywhere,
    # every coefficient tiny, and a naive tail truncation would return a
    # degree-2 zero "filter" while the analytic-oracle probes still pass).
    x_lo = np.clip((2.0 * Emin - (hi + lo)) / span, -1.0, 1.0)
    x_hi = np.clip((2.0 * Emax - (hi + lo)) / span, -1.0, 1.0)
    t_span = max(float(np.arccos(x_lo) - np.arccos(x_hi)), 1e-300)
    d_min = int(np.ceil(3.0 * np.pi / t_span))
    if d_min > cap:
        raise ChebInfeasible(
            f"contour-polynomial filter needs degree >= ~{d_min} > cap "
            f"{cap} just to RESOLVE the interval (theta-span {t_span:.3g} "
            f"on the enclosure); falling back to the Krylov contour "
            f"engine")
    # predicted degree from the Bernstein ellipse through the worst node
    # (only a sizing hint for the first DCT length; truncation decides)
    rate = 2.0 * np.sqrt(max(im_min, 1e-300) / span)
    d_pred = int(np.clip(max(np.log(1.0 / tol) / max(rate, 1e-12), d_min),
                         64, 4 * cap))
    mid, half = 0.5 * (hi + lo), 0.5 * (hi - lo)

    M = 1 << int(np.ceil(np.log2(max(2 * d_pred, 256))))
    M = min(M, 1 << int(np.ceil(np.log2(4 * cap))))
    while True:
        j = np.arange(M)
        x = np.cos(np.pi * (j + 0.5) / M)
        f = rational_eval_scalar(Zne, Wne, mid + half * x)
        c = dct(f, type=2) / M
        c[0] *= 0.5
        # tail[k] = sum_{j >= k} |c_j|: sup-norm bound on truncating at k-1
        tail = np.cumsum(np.abs(c)[::-1])[::-1]
        hit = np.nonzero(tail < tol)[0]
        if hit.size and hit[0] < 0.9 * M:
            break                       # decay resolved inside this M
        if M >= 4 * cap:
            break                       # cap decides below
        M *= 2
    deg = int(hit[0]) - 1 if hit.size else M
    if deg > cap:
        raise ChebInfeasible(
            f"contour-polynomial filter needs degree ~{deg} > cap {cap} "
            f"(closest node Im z = {im_min:.3g}, enclosure span "
            f"{span:.3g}); falling back to the Krylov contour engine")
    deg = max(deg, min(d_min, cap), 2)
    coeffs = np.asarray(c[:deg + 1], np.float64)
    hit_lo = np.nonzero(tail < lo_tol)[0]
    degree_lo = int(np.clip((hit_lo[0] - 1) if hit_lo.size else deg, 2, deg))

    # quality probes (host, cheap): truncation error on a dense grid,
    # inside plateau, outside level one interval-width out
    grid = np.linspace(lo, hi, 4097)
    err = float(np.max(np.abs(cheb_eval_scalar(coeffs, lo, hi, grid)
                              - rational_eval_scalar(Zne, Wne, grid))))
    ins = np.linspace(Emin, Emax, 257)
    rin = rational_eval_scalar(Zne, Wne, ins)
    inside_min, inside_max = float(np.min(rin)), float(np.max(rin))
    if not inside_max > 0 or inside_min <= 0.25 * inside_max:
        raise ChebInfeasible(
            f"rational filter's inside plateau [{inside_min:.3g}, "
            f"{inside_max:.3g}] cannot separate genuine from spurious "
            "pairs (custom contour too eccentric?)")
    # direct check of the TRUNCATED POLYNOMIAL's plateau (the analytic
    # oracle above cannot certify the expansion itself)
    pin = cheb_eval_scalar(coeffs, lo, hi, ins)
    if float(np.min(pin)) <= 0.25 * inside_max:
        raise ChebInfeasible(
            f"truncated contour-polynomial underrepresents the inside "
            f"plateau (min {float(np.min(pin)):.3g} vs rational "
            f"{inside_min:.3g}); falling back to the Krylov contour "
            "engine")
    w = Emax - Emin
    probes = np.array([Emin - w, Emax + w])
    probes = probes[(probes > lo) & (probes < hi)]
    out_level = (float(np.max(np.abs(rational_eval_scalar(
        Zne, Wne, probes)))) if probes.size else 0.0)
    return coeffs, {"degree": deg, "degree_lo": degree_lo,
                    "inside_min": inside_min, "inside_max": inside_max,
                    "outside_at_1w": max(out_level, err),
                    "trunc_err": err, "kind": "rational"}
