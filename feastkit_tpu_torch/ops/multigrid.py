"""Geometric multigrid preconditioner for complex-shifted stencil operators.

Counterpart of ``feastkit_tpu/ops/multigrid.py``: the "complex shifted
Laplacian" V-cycle that makes the Krylov engine's shifted solves converge
near the spectrum, for constant-coefficient stencils on a 1-, 2- or 3-D
tensor grid (row-major ordering, zero boundary), B absent or itself a
constant stencil.

* Host side (numpy), with the JAX package's decisions: ``detect_grid_stencil``
  recognizes DIA data as a grid stencil, ``coarsen_stencil`` Galerkin-
  coarsens one numerically (R A P probed on a small grid, with the torch
  transfers on the CPU in the coefficients' dtype), ``plan_mg_levels`` decides
  whether a V-cycle is feasible for the search region and how deep,
  ``stencil_to_dense`` materializes the coarsest level.
* On the solve's device (torch): ``apply_stencil`` (shifted adds),
  ``_restrict`` / ``_prolong`` (the cell-centred linear transfers) and
  ``make_shifted_vcycle``, whose shift may be one scalar or one per node of
  a group: a (g,) shift preconditions (g, N, K) operands, with the coarse
  dense LU factored for the g nodes at once (``torch.linalg.lu_factor``).

``FEAST_STENCIL_CONV=1`` (off by default, as in the JAX package) realizes
``apply_stencil`` as one ``torch.nn.functional.conv2d`` / ``conv3d`` under
the JAX package's gate (a 2-D or 3-D grid, real coefficients, |disp| <= 1,
32-bit or narrower; a complex x as two real convolutions): the
counterpart of its XLA convolution, a library call on the card.
"""
from __future__ import annotations

import itertools
import os
from typing import NamedTuple

import numpy as np
import torch

from ..core.tools import lu_factor

__all__ = ["GridStencil", "detect_grid_stencil", "coarsen_stencil",
           "apply_stencil", "make_shifted_vcycle", "stencil_to_dense",
           "plan_mg_levels"]


class GridStencil(NamedTuple):
    """Constant-coefficient stencil on a tensor grid.

    disps: (ns, ndim) int array of neighbour displacements (each in -1/0/1
           after detection; coarsened stencils may reach +-2).
    coeffs: (ns,) real or complex values.
    grid: tuple of per-axis sizes (row-major flattening).
    """
    disps: np.ndarray
    coeffs: np.ndarray
    grid: tuple


def _strides(grid):
    s = [1] * len(grid)
    for k in range(len(grid) - 2, -1, -1):
        s[k] = s[k + 1] * grid[k + 1]
    return tuple(s)


def detect_grid_stencil(diags, offsets, grid, tol=1e-12):
    """(diags, offsets) DIA data -> GridStencil if it is a constant stencil
    on ``grid``, else None (the JAX package's rules: each flat offset must
    decompose uniquely into per-axis displacements in {-1, 0, 1}; each
    diagonal is constant at the in-grid positions and zero across the
    row-major seams)."""
    grid = tuple(int(g) for g in grid)
    N = int(np.prod(grid))
    diags = np.asarray(diags)
    if diags.shape[1] != N:
        return None
    strides = _strides(grid)
    ndim = len(grid)
    if any(g < 3 for g in grid):
        return None
    disp_table = {}
    for combo in itertools.product((-1, 0, 1), repeat=ndim):
        off = sum(c * s for c, s in zip(combo, strides))
        if off in disp_table:
            return None
        disp_table[off] = combo
    disps, coeffs = [], []
    idx = np.arange(N)
    coords = [idx // strides[k] % grid[k] for k in range(ndim)]
    for row, off in zip(diags, offsets):
        if int(off) not in disp_table:
            return None
        disp = disp_table[int(off)]
        valid = np.ones(N, bool)
        for k in range(ndim):
            tgt = coords[k] + disp[k]
            valid &= (tgt >= 0) & (tgt < grid[k])
        vals = row[valid]
        if vals.size == 0:
            return None
        c = vals.flat[vals.size // 2]
        scale = max(np.abs(diags).max(), 1e-30)
        if not (np.all(np.abs(vals - c) <= tol * scale)
                and np.all(np.abs(row[~valid]) <= tol * scale)):
            return None
        disps.append(disp)
        coeffs.append(c)
    return GridStencil(np.asarray(disps, np.int64), np.asarray(coeffs), grid)


def _stencil_conv(x, disps, coeffs, grid):
    """The stencil as ONE convolution (a correlation: kern[d + 1]
    multiplies x[i + d], zero padding 1, exactly the zero-boundary
    stencil); complex x as two real convolutions."""
    if x.is_complex():
        return torch.complex(_stencil_conv(x.real, disps, coeffs, grid),
                             _stencil_conv(x.imag, disps, coeffs, grid))
    ndim = len(grid)
    kern = np.zeros((3,) * ndim, np.float32)
    for d, c in zip(np.asarray(disps), coeffs):
        kern[tuple(int(dd) + 1 for dd in d)] = np.real(c)
    conv = (torch.nn.functional.conv2d if ndim == 2
            else torch.nn.functional.conv3d)
    w = torch.as_tensor(kern, device=x.device).to(x.dtype)
    out = conv(x.reshape((-1, 1) + tuple(grid)),
               w.reshape((1, 1) + kern.shape), padding=1)
    return out.reshape(x.shape)


def _conv_ok(x, disps, coeffs, grid):
    """The JAX package's gate: opt-in (FEAST_STENCIL_CONV=1), a 2-D or 3-D
    grid, real coefficients, reach <= 1, 32-bit or narrower."""
    if os.environ.get("FEAST_STENCIL_CONV", "0") != "1":
        return False
    return bool(len(grid) in (2, 3)
                and not np.iscomplexobj(np.asarray(coeffs))
                and np.abs(np.asarray(disps)).max(initial=0) <= 1
                and torch.finfo(x.real.dtype).bits <= 32)


def apply_stencil(x, disps, coeffs, grid):
    """y = A x for a constant stencil, zero boundary; x has the grid axes
    LAST (leading axes are batch). Coefficients are Python scalars, so the
    product stays in x's dtype. Under ``FEAST_STENCIL_CONV=1`` and its gate
    (``_conv_ok``) one convolution."""
    ndim = len(grid)
    if _conv_ok(x, disps, coeffs, grid):
        return _stencil_conv(x, disps, coeffs, grid)
    y = torch.zeros_like(x)
    pre = (slice(None),) * (x.dim() - ndim)
    for disp, c in zip(np.asarray(disps), coeffs):
        src, dst = [], []
        for k, d in enumerate(disp):
            n, d = grid[k], int(d)
            if abs(d) >= n:
                break
            src.append(slice(d, n) if d >= 0 else slice(0, n + d))
            dst.append(slice(0, n - d) if d >= 0 else slice(-d, n))
        else:
            y[pre + tuple(dst)].add_(x[pre + tuple(src)], alpha=c)
    return y


def stencil_to_dense(st: GridStencil, dtype=None):
    """Materialize the stencil as a dense (N, N) numpy matrix (coarse
    solves, tests)."""
    grid = st.grid
    N = int(np.prod(grid))
    strides = _strides(grid)
    dtype = dtype or st.coeffs.dtype
    A = np.zeros((N, N), dtype)
    idx = np.arange(N)
    coords = [idx // strides[k] % grid[k] for k in range(len(grid))]
    for disp, c in zip(st.disps, st.coeffs):
        valid = np.ones(N, bool)
        tgt_flat = idx.copy()
        for k, d in enumerate(disp):
            tgt = coords[k] + int(d)
            valid &= (tgt >= 0) & (tgt < grid[k])
            tgt_flat = tgt_flat + int(d) * strides[k]
        A[idx[valid], tgt_flat[valid]] += c
    return A


def _axis_slice(x, ax, sl):
    s = [slice(None)] * x.dim()
    s[ax] = sl
    return x[tuple(s)]


def _restrict(x, ndim):
    """Adjoint (scaled 1/2 per axis) of the cell-centred linear
    prolongation: c_j = (0.25 f_{2j-1} + 0.75 f_{2j} + 0.75 f_{2j+1}
    + 0.25 f_{2j+2}) / 2, zero outside (odd axes padded by one zero)."""
    for ax in range(x.dim() - ndim, x.dim()):
        n = x.shape[ax]
        nc = (n + 1) // 2
        # one zero before (f_{-1}) and enough after (f_{2nc}, f_{2nc+1})
        pad = [0, 0] * (x.dim() - 1 - ax) + [1, 2 * nc + 2 - n - 1]
        xp = torch.nn.functional.pad(x, pad)
        f = [_axis_slice(xp, ax, slice(s, s + 2 * nc, 2)) for s in range(4)]
        comb = 0.25 * f[0]
        comb.add_(f[1], alpha=0.75).add_(f[2], alpha=0.75)
        comb.add_(f[3], alpha=0.25)
        x = comb.mul_(0.5)
    return x


def _prolong(x, fine_shape, ndim):
    """Cell-centred linear interpolation per axis, zero (Dirichlet)
    extension: f_{2j} = 0.75 c_j + 0.25 c_{j-1}, f_{2j+1} = 0.75 c_j +
    0.25 c_{j+1}; cropped to the fine shape."""
    for k, ax in enumerate(range(x.dim() - ndim, x.dim())):
        n = x.shape[ax]
        pad = [0, 0] * (x.dim() - 1 - ax) + [1, 1]
        xp = torch.nn.functional.pad(x, pad)
        cm = _axis_slice(xp, ax, slice(0, n))
        cp = _axis_slice(xp, ax, slice(2, n + 2))
        f_even = (0.75 * x).add_(cm, alpha=0.25)
        f_odd = (0.75 * x).add_(cp, alpha=0.25)
        f = torch.stack([f_even, f_odd], dim=ax + 1)
        f = f.reshape(x.shape[:ax] + (2 * n,) + x.shape[ax + 1:])
        x = _axis_slice(f, ax, slice(0, fine_shape[k]))
    return x


def coarsen_stencil(st: GridStencil) -> GridStencil:
    """Galerkin coarse stencil A_c = R A P, probed numerically: R A P
    applied to a unit impulse at the centre of a small coarse grid (torch
    on the CPU), the stencil read off around it."""
    ndim = len(st.grid)
    # a +2 displacement must stay in range around the centre: >= 5 points
    probe_c = tuple(min(9, max(5, (g + 1) // 2)) for g in st.grid)
    probe_f = tuple(2 * g for g in probe_c)
    center = tuple(g // 2 for g in probe_c)
    e = np.zeros(probe_c)
    e[center] = 1.0
    # the probe runs in the coefficients' own dtype, as in the JAX package
    ex = torch.as_tensor(e.astype(st.coeffs.dtype))
    xf = _prolong(ex, probe_f, ndim)
    yf = apply_stencil(xf, st.disps, [c.item() for c in st.coeffs], probe_f)
    yc = _restrict(yf, ndim).numpy()
    disps, coeffs = [], []
    scale = max(np.abs(yc).max(), 1e-30)
    for off in itertools.product(range(-2, 3), repeat=ndim):
        pos = tuple(c + o for c, o in zip(center, off))
        if not all(0 <= p < g for p, g in zip(pos, probe_c)):
            continue
        v = yc[pos]
        if np.abs(v) > 1e-12 * scale:
            disps.append(off)
            coeffs.append(v)
    grid_c = tuple((g + 1) // 2 for g in st.grid)
    return GridStencil(np.asarray(disps, np.int64), np.asarray(coeffs),
                       grid_c)


def plan_mg_levels(stA: GridStencil, stB, re_max, *, coarse_budget=2048,
                   min_size=4, theta_samples=48):
    """Whether multigrid is FEASIBLE for shifts with Re z <= re_max, and how
    many levels to use (>= 2), or None (the JAX package's rule: the
    coarsest grid must still resolve every mode the shift flips and fit the
    dense-solve budget; the shallowest such hierarchy is taken)."""
    grid = stA.grid
    ndim = len(grid)
    ths = [np.linspace(np.pi / (g + 1), np.pi * g / (g + 1),
                       min(g, theta_samples)) for g in grid]
    TH = np.meshgrid(*ths, indexing="ij")

    def symbol(st):
        sym = np.zeros(TH[0].shape, np.complex128)
        for disp, c in zip(st.disps, st.coeffs):
            phase = np.zeros(TH[0].shape)
            for k, d in enumerate(disp):
                phase = phase + float(d) * TH[k]
            sym = sym + c * np.exp(1j * phase)
        return sym

    symA = symbol(stA)
    if stB is None:
        symB = np.ones(TH[0].shape)
    else:
        symB = symbol(stB)
        symB = np.where(np.abs(symB) > 1e-12, symB, 1e-12)
    lam = np.real(symA) / np.real(np.where(np.abs(np.real(symB)) > 1e-12,
                                           symB, 1.0))
    flipped = lam < float(re_max)
    need = 0
    g = list(grid)
    while np.prod(g) > coarse_budget and min(g) > min_size:
        g = [(x + 1) // 2 for x in g]
        need += 1
    if np.prod(g) > coarse_budget:
        return None
    if flipped.all() or not flipped.any():
        # definite shifted operator: coarsen as deep as sizes allow
        cap = need
        while all((x + 1) // 2 >= min_size for x in g) and cap < 12:
            g = [(x + 1) // 2 for x in g]
            cap += 1
        return max(cap, need) + 1
    cap = min(
        int(np.floor(np.log2((np.pi / 2) / max(float(TH[k][flipped].max()),
                                               1e-9))))
        for k in range(ndim))
    s_max, gs = 0, list(grid)
    while min(gs) >= 2 * min_size:
        gs = [(x + 1) // 2 for x in gs]
        s_max += 1
    cap = min(cap, s_max)
    if cap < max(need, 1):
        return None
    return max(need, 1) + 1


def _stencil_levels(stA: GridStencil, stB, min_size=8, max_levels=12,
                    n_levels=None):
    """Host-side level hierarchy [(stA_l, stB_l), ...], finest first."""
    levels = [(stA, stB)]
    if n_levels is not None:
        while len(levels) < n_levels:
            a, b = levels[-1]
            levels.append((coarsen_stencil(a),
                           coarsen_stencil(b) if b is not None else None))
        return levels
    while (min(levels[-1][0].grid) > min_size
           and int(np.prod(levels[-1][0].grid)) > 4 * min_size ** 2
           and len(levels) < max_levels):
        a, b = levels[-1]
        levels.append((coarsen_stencil(a),
                       coarsen_stencil(b) if b is not None else None))
    return levels


def _center(st):
    """The stencil's centre coefficient as a Python scalar (a numpy or
    0-d tensor scalar would promote a complex64 V-cycle)."""
    for disp, c in zip(st.disps, st.coeffs):
        if not np.any(disp):
            return c.item()
    return 0.0


def make_shifted_vcycle(stA: GridStencil, stB, z, *, nu_pre=2, nu_post=2,
                        omega=0.8, dtype=torch.complex64, n_cycles=1,
                        n_levels=None, device="cpu"):
    """vcycle(X) -> approximate (z B - A)^{-1} X for X of shape (..., N, K).

    ``z`` is one shift (a scalar) or one per node (a (g,) tensor or array,
    for X of shape (g, N, K)); it is cast to ``dtype`` first (a (g,)
    complex128 tensor would otherwise promote a complex64 V-cycle).
    stB=None means B = I; n_levels (from plan_mg_levels) bounds the depth.
    The output has X's shape and ``dtype``; it may be a non-contiguous
    view (the grid layout is (..., K, *grid))."""
    levels = _stencil_levels(stA, stB, n_levels=n_levels)
    ndim = len(stA.grid)
    # a Python complex becomes a tensor in the target dtype directly
    # (torch.as_tensor alone would round it to complex64 first)
    z = (z.to(device=device, dtype=dtype) if torch.is_tensor(z)
         else torch.as_tensor(np.asarray(z), device=device).to(dtype))
    per_node = z.dim() == 1
    # broadcast over (g, K, *grid)
    zb = z.reshape((-1,) + (1,) * (1 + ndim)) if per_node else z

    def coeffs(st):
        return [complex(c) if np.iscomplexobj(st.coeffs) else float(c)
                for c in st.coeffs]

    lv = [(a.grid, a.disps, coeffs(a),
           None if b is None else (b.disps, coeffs(b)),
           zb * (1.0 if b is None else _center(b)) - _center(a))
          for a, b in levels]

    def shifted_apply(x, grid, dA, cA, B):
        Ax = apply_stencil(x, dA, cA, grid)
        Bx = x if B is None else apply_stencil(x, B[0], B[1], grid)
        return zb * Bx - Ax

    aC, bC = levels[-1]
    np_dt = np.complex64 if dtype == torch.complex64 else np.complex128
    Ac = torch.as_tensor(stencil_to_dense(aC).astype(np_dt), device=device)
    Bc = (torch.eye(Ac.shape[0], dtype=dtype, device=device) if bC is None
          else torch.as_tensor(stencil_to_dense(bC).astype(np_dt),
                               device=device))
    Sc = (z[:, None, None] if per_node else z) * Bc - Ac
    coarse_lu, coarse_piv = lu_factor(Sc)

    def level_solve(l, r):
        grid, dA, cA, B, d = lv[l]
        if l == len(lv) - 1:
            Nc = int(np.prod(grid))
            rf = r.reshape(r.shape[:-ndim] + (Nc,))
            if per_node:      # (g, K, Nc): solve with each node's factor
                sol = torch.linalg.lu_solve(coarse_lu, coarse_piv,
                                            rf.transpose(-1, -2))
                sol = sol.transpose(-1, -2)
            else:             # (..., Nc): batch to the columns
                flat = rf.reshape(-1, Nc).transpose(0, 1)
                sol = torch.linalg.lu_solve(coarse_lu, coarse_piv, flat)
                sol = sol.transpose(0, 1)
            return sol.reshape(r.shape)
        w = omega / d
        x = torch.zeros_like(r)
        for _ in range(nu_pre):
            x = x + w * (r - shifted_apply(x, grid, dA, cA, B))
        rc = _restrict(r - shifted_apply(x, grid, dA, cA, B), ndim)
        x = x + _prolong(level_solve(l + 1, rc), grid, ndim)
        for _ in range(nu_post):
            x = x + w * (r - shifted_apply(x, grid, dA, cA, B))
        return x

    grid0 = stA.grid
    N = int(np.prod(grid0))

    def vcycle(X):
        K = X.shape[-1]
        lead = X.shape[:-2]
        xg = X.transpose(-1, -2).to(dtype).reshape(lead + (K,) + grid0)
        out = torch.zeros_like(xg)
        g0 = lv[0]
        for _ in range(n_cycles):
            res = xg - shifted_apply(out, g0[0], g0[1], g0[2], g0[3])
            out = out + level_solve(0, res)
        if out.dtype != dtype:
            raise TypeError(f"V-cycle promoted to {out.dtype}, expected "
                            f"{dtype}")
        return out.reshape(lead + (K, N)).transpose(-1, -2)

    return vcycle
