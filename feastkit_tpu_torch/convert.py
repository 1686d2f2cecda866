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
from .kernel.hermitian import HermitianState

__all__ = ["fpm_from_reference", "dia_from_reference",
           "state_from_reference", "carry_from_reference_packed"]


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
