"""Sparse-SPD-B composite Chebyshev recurrence (consistent-mass pencils).

Counterpart of the generalized fusion of ``feastkit_tpu/ops/cheb_pallas.py``:
:func:`cheb_gen_init` of ``cheb_gen_init`` (:1192) and :func:`cheb_gen_chunk`
of ``cheb_gen_chunk`` (:1051). The filter of a pencil with a sparse SPD B
runs on the composite operator

    Chat = sc_C q(B~) A~ - sh_C I,

where A~, B~ are the unit-diagonal congruences and q(B~) ~= B~^-1 is the
closed-form polynomial inverse (``ops/chebfilter.cheb_inverse_coeffs``,
coefficients ``qc``). The inner q(B~) y is itself a Chebyshev recurrence
with an accumulator, so each OUTER step runs the kernels of
``ops/cheb_kernels.py``:

1. y = A~ T1: one one-step launch with halved scalars (0.5, 0, 0) from
   T0 = 0 and without an accumulator (the JAX package passes zero planes
   for both; the port's launch neither loads nor stores them and writes y
   to a new plane);
2. the inner init t1 = Bhat y (one-step launch, scalars scB/2, shB/2,
   from T0 = 0, again not loaded), with the inner accumulator
   qc0 y + qc1 t1: on the fp64 carry through the combine kernel with
   (sc, sh, c_k) = (qc1, -qc0, 0.5) from T0 = F = 0 (the one-step launch
   without an accumulator), as the JAX package's double-single rung does;
   on the f32 carry from acc = qc0 y inside the one-step launch
   (c_k = qc1), as its f32 rung does;
3. the other m_B - 1 inner steps as 4-step passes, a 2-step pass and a
   one-step launch (the split of ``_sparse_cheb_filter_host_fused``; the
   JAX package pads the last group with zero coefficients, which leaves
   the same accumulator); ``inner_steps`` = 2 stops at 2-step passes, 1
   runs one-step launches only;
4. the outer combine T2 = 2 (sc_C z - sh_C T1) - T0, F += c_k T2 with
   z = q(B~) y, one launch of ``cheb_combine_f64`` / ``cheb_combine_f32``
   (on the f32 rung the JAX package writes these three operations as XLA
   glue).

Every plane is column-major (M, N), the layout of the multi-step kernels,
so nothing is transposed inside the recurrence; the filter transposes Q in
and the accumulator out once per application. The carry's dtype chooses
the kernels: float64 the fp64 kernels (the JAX package's double-single
rung, in native fp64 with f64 scalars), float32 the f32 ones. On CPU
tensors every kernel wrapper runs its plain version.
"""
from __future__ import annotations

import torch

from .cheb_kernels import (cheb_combine_f32, cheb_combine_f64,
                           cheb_f32_2_chunk, cheb_f32_4_chunk,
                           cheb_f32_cm_chunk, cheb_f64_2_chunk,
                           cheb_f64_4_chunk, cheb_f64_cm_chunk,
                           cheb_step_cm_f32, cheb_step_cm_f64)

__all__ = ["cheb_gen_init", "cheb_gen_chunk", "inner_split"]

_KERNELS = {
    torch.float64: dict(step=cheb_step_cm_f64, chunk1=cheb_f64_cm_chunk,
                        chunk2=cheb_f64_2_chunk, chunk4=cheb_f64_4_chunk,
                        combine=cheb_combine_f64, ds_form=True),
    torch.float32: dict(step=cheb_step_cm_f32, chunk1=cheb_f32_cm_chunk,
                        chunk2=cheb_f32_2_chunk, chunk4=cheb_f32_4_chunk,
                        combine=cheb_combine_f32, ds_form=False),
}


def _kernels(dtype):
    try:
        return _KERNELS[dtype]
    except KeyError:
        raise TypeError(f"the composite runs on float32 or float64 planes, "
                        f"got {dtype}") from None


def inner_split(n, steps):
    """(n4, n2, n1): how ``n`` inner steps split into 4-step passes, a
    2-step pass and one-step launches for ``steps`` (4, 2 or 1) per pass."""
    if steps not in (1, 2, 4):
        raise ValueError(f"inner_steps must be 1, 2 or 4, got {steps}")
    n4 = n // 4 * 4 if steps == 4 else 0
    n2 = (n - n4) // 2 * 2 if steps >= 2 else 0
    return n4, n2, n - n4 - n2


def _apply_q_of_B(k, dB, offsets_B, qc, y, scB, shB, inner_steps):
    """z = q(B~) y. Consumes y (its buffer joins the inner carry)."""
    if k["ds_form"]:
        t1 = k["step"](dB, offsets_B, None, y, None, scB * 0.5, shB * 0.5,
                       0.0)
        acc = k["combine"](t1, y, None, None, qc[1], -qc[0], 0.5)
    else:
        acc = y * float(qc[0])
        t1 = k["step"](dB, offsets_B, None, y, acc, scB * 0.5, shB * 0.5,
                       qc[1])
    rest = qc[2:]
    n4, n2, _ = inner_split(len(rest), inner_steps)
    carry = k["chunk4"](dB, offsets_B, (y, t1, acc), rest[:n4], scB, shB)
    carry = k["chunk2"](dB, offsets_B, carry, rest[n4:n4 + n2], scB, shB)
    carry = k["chunk1"](dB, offsets_B, carry, rest[n4 + n2:], scB, shB)
    return carry[2]


def cheb_gen_chunk(dA, offsets_A, dB, offsets_B, qc, carry, coeffs_chunk,
                   scals, *, inner_steps=4):
    """Advance the outer composite carry (T0, T1, F), column-major (M, N)
    planes, over a chunk of outer coefficients. ``dA`` / ``dB``: the
    congruenced operators' (nd, N) diagonals in the carry's dtype; ``qc``:
    the inner inverse coefficients (host array, m_B + 1 >= 3 entries);
    ``scals``: sc_C, sh_C (outer map) and scB, shB (B-hat map). T0 and F
    are updated in place, and the returned carry is (T1, T2, F) with T2 in
    T0's buffer."""
    t0, t1, f = carry
    k = _kernels(t1.dtype)
    if len(qc) < 3:
        raise ValueError(f"need at least 3 inverse coefficients, got "
                         f"{len(qc)}")
    if len(coeffs_chunk) == 0:
        return t0, t1, f
    scB, shB = scals["scB"], scals["shB"]
    for ck in coeffs_chunk:
        y = k["step"](dA, offsets_A, None, t1, None, 0.5, 0.0, 0.0)
        z = _apply_q_of_B(k, dB, offsets_B, qc, y, scB, shB, inner_steps)
        del y
        k["combine"](z, t1, t0, f, scals["sc_C"], scals["sh_C"], ck)
        del z
        t0, t1 = t1, t0
    return t0, t1, f


def cheb_gen_init(dA, offsets_A, dB, offsets_B, qc, Q, c01, scals, *,
                  inner_steps=4):
    """Outer carry after the k = 0, 1 terms: (Q, Chat Q, c0 Q + c1 Chat Q)
    for a column-major (M, N) plane Q (kept as T0). As in the JAX package:
    one chunk step with c_k = 0 from (0, Q) gives 2 Chat Q, halved; the
    accumulator is the combine with (c1, -c0, 0.5) on the fp64 carry and
    c0 Q + c1 T1 in two torch operations on the f32 carry."""
    k = _kernels(Q.dtype)
    carry = (torch.zeros_like(Q), Q, torch.zeros_like(Q))
    carry = cheb_gen_chunk(dA, offsets_A, dB, offsets_B, qc, carry, [0.0],
                           scals, inner_steps=inner_steps)
    t1 = carry[1].mul_(0.5)
    del carry
    c0, c1 = float(c01[0]), float(c01[1])
    if k["ds_form"]:
        acc = k["combine"](t1, Q, None, None, c1, -c0, 0.5)
    else:
        acc = Q * c0 + t1 * c1
    return Q, t1, acc
