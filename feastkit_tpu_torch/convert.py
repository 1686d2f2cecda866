"""Carry the JAX package's parameters, operators and solver state across.

For an eigensolver the "weights" are the fpm vector, the operator and the
solver state. These functions take the JAX package's objects (duck-typed:
anything with the same fields, read as numpy arrays) and return the port's
counterparts; they import nothing of the JAX package. Tensors land on
``device``: ``None`` means CUDA (and raises without it), as for every entry
point of the port.
"""
from __future__ import annotations

import numpy as np
import torch

from .core.backend import resolve_device
from .core.parameters import FeastParameters
from .kernel.general import GeneralState
from .kernel.hermitian import HermitianState
from .ops.banded import BCRLevel
from .ops.multigrid import GridStencil

__all__ = ["fpm_from_reference", "dia_from_reference",
           "state_from_reference", "general_state_from_reference",
           "carry_from_reference_packed",
           "stencil_from_reference", "bcr_from_reference"]


def fpm_from_reference(fpm) -> FeastParameters:
    """The same 64 ints as a port ``FeastParameters``."""
    arr = fpm.to_array() if hasattr(fpm, "to_array") else np.asarray(fpm)
    return FeastParameters(np.asarray(arr, np.int64))


def dia_from_reference(diags, offsets, *, dtype=torch.float64,
                       device=None):
    """Row-aligned (nd, N) diagonals and their offsets -> (tensor, tuple)."""
    device = resolve_device(device)
    return (torch.as_tensor(np.array(diags), dtype=dtype, device=device),
            tuple(int(d) for d in offsets))


def state_from_reference(state, *, device=None) -> HermitianState:
    """A reference ``HermitianState``'s leaves -> the port's tensors."""
    device = resolve_device(device)

    def t(x):
        return torch.as_tensor(np.array(x), device=device)
    return HermitianState(
        loop=int(np.asarray(state.loop)), Q=t(state.Q), lam=t(state.lam),
        res=t(state.res), inside=t(state.inside).to(torch.bool),
        epsout=t(state.epsout), trace=t(state.trace),
        converged=t(state.converged).to(torch.bool),
        inner_ok=t(state.inner_ok).to(torch.bool))


def general_state_from_reference(state, *, device=None) -> GeneralState:
    """A reference ``GeneralState``'s leaves (complex lam and trace) -> the
    port's tensors, for one body step from the same state."""
    device = resolve_device(device)
    h = state_from_reference(state, device=device)
    return GeneralState(*h)


def carry_from_reference_packed(planes, plan, N, M, *, device=None):
    """Unpack the reference's recurrence carry into (N, M) tensors.

    ``planes`` is the f32 carry (T0, T1, acc) as transposed (Mp, N_tot) f32
    planes (-> f32 tensors), or the double-single carry (t0h, t0l, t1h,
    t1l, ach, acl) (-> f64 tensors, hi + lo). ``plan`` is the reference's
    layout plan (its ``block`` and ``margin`` locate the data lanes)."""
    device = resolve_device(device)
    b = int(plan.get("margin", 1)) * int(plan["block"])

    def unpack(p):
        return np.asarray(p)[:M, b:b + N].T

    planes = [np.asarray(p) for p in planes]
    if len(planes) == 3:
        out = [unpack(p).astype(np.float32) for p in planes]
    elif len(planes) == 6:
        out = [unpack(hi).astype(np.float64) + unpack(lo).astype(np.float64)
               for hi, lo in zip(planes[0::2], planes[1::2])]
    else:
        raise ValueError(f"expected 3 f32 or 6 double-single planes, got "
                         f"{len(planes)}")
    return tuple(torch.as_tensor(np.ascontiguousarray(x), device=device)
                 for x in out)


def stencil_from_reference(st) -> GridStencil:
    """A reference ``GridStencil`` (displacements, coefficients, grid) ->
    the port's (host numpy, as in the JAX package)."""
    return GridStencil(np.array(st.disps, np.int64), np.array(st.coeffs),
                       tuple(int(g) for g in st.grid))


def bcr_from_reference(levels, root_lu, root_piv, device=None):
    """The JAX package's BCR hierarchy (``bcr_factor``'s levels, each with
    lu_odd, piv_odd, L_odd, U_odd, C1, C2, and the root factors) -> the
    port's, for ``ops/banded.bcr_solve``. Pivots move from LAPACK's 0-based
    rows (jax) to torch's 1-based ones."""
    device = resolve_device(device)

    def t(x):
        return torch.as_tensor(np.array(x), device=device)

    def piv(p):
        return torch.as_tensor(np.array(p, np.int32) + 1, device=device)
    return ([BCRLevel(t(lv.lu_odd), piv(lv.piv_odd), t(lv.L_odd),
                      t(lv.U_odd), t(lv.C1), t(lv.C2)) for lv in levels],
            t(root_lu), piv(root_piv))
