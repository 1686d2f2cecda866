"""Fused Chebyshev-recurrence step: CUDA kernels, plain version, drivers.

Counterpart of ``feastkit_tpu/ops/cheb_pallas.py`` for the one-step
kernels. One step of the three-term recurrence on row-major (N, M)
tensors,

    T2 = 2 (sc * A @ T1 - sh * T1) - T0,    acc += c_k * T2,

with A in row-aligned DIA form (``ops/dia.py``), runs as ONE pass over
memory: the DIA matvec, the three-term update and the accumulator update.
T2 is written into T0's buffer and acc is updated in place; the drivers
rotate the carry (T0, T1, acc) <- (T1, T2, acc).

* ``cheb_step_f32`` replaces ``_cheb_f32_kernel`` (cheb_pallas.py:685):
  f32 diagonals, vectors and scalars, the f32 rung of the ladder.
* ``cheb_step_f64`` replaces ``_cheb_ds_kernel`` (cheb_pallas.py:256): the
  TPU carries every vector as a double-single (hi, lo) f32 pair because its
  f64 is emulated; Hopper has native fp64, so the port's high rung is plain
  f64 with f64 scalars.

The layout is the port's own: contiguous (N, M) tensors with no transposed
128-lane packing and no zero margins (``convert.carry_from_reference_packed``
unpacks the JAX package's planes). On a CUDA tensor each wrapper launches
its kernel (``csrc/cheb_step.cu``) or raises; on a CPU tensor it runs
:func:`cheb_step_plain`. Each wrapper counts its launches in its
``launches`` attribute.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .dia import dia_matvec

__all__ = ["cheb_step_f32", "cheb_step_f64", "cheb_step_plain",
           "cheb_f32_chunk", "cheb_f64_chunk", "reset_launch_counts",
           "launch_counts"]


def cheb_step_plain(diags, offsets, t0, t1, acc, sc, sh, ck):
    """The plain PyTorch version of one fused step (same in-place contract
    as the kernels; dtype-generic, so it is the plain version of both)."""
    y = dia_matvec(diags, offsets, t1)
    t2 = 2.0 * (sc * y - sh * t1) - t0
    t0.copy_(t2)
    acc.add_(t2, alpha=ck)


@functools.cache
def _library():
    from .cuda_build import load
    lib = load("cheb_step")
    for name, scalar in (("cheb_step_f32", ctypes.c_float),
                         ("cheb_step_f64", ctypes.c_double)):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64),
                       ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                       scalar, scalar, scalar, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.cheb_error_string.argtypes = [ctypes.c_int]
    lib.cheb_error_string.restype = ctypes.c_char_p
    return lib


def _check(diags, offsets, t0, t1, acc, dtype):
    for name, t in (("diags", diags), ("T0", t0), ("T1", t1), ("acc", acc)):
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if t.device != t0.device:
            raise ValueError(f"{name} is on {t.device}, T0 on {t0.device}")
    if t0.dim() != 2 or t1.shape != t0.shape or acc.shape != t0.shape:
        raise ValueError("T0, T1 and acc must be (N, M) of one shape, got "
                         f"{tuple(t0.shape)}, {tuple(t1.shape)}, "
                         f"{tuple(acc.shape)}")
    if diags.dim() != 2 or diags.shape[0] != len(offsets) \
            or diags.shape[1] != t0.shape[0]:
        raise ValueError(f"diags must be ({len(offsets)}, {t0.shape[0]}), "
                         f"got {tuple(diags.shape)}")
    if len(offsets) > 32:
        raise ValueError(f"at most 32 diagonals, got {len(offsets)}")
    if len({t0.data_ptr(), t1.data_ptr(), acc.data_ptr()}) != 3:
        raise ValueError("T0, T1 and acc must be three distinct buffers")


def _launch(wrapper, diags, offsets, t0, t1, acc, sc, sh, ck):
    for name, t in (("diags", diags), ("T0", t0), ("T1", t1), ("acc", acc)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    lib = _library()
    offs = (ctypes.c_int64 * max(len(offsets), 1))(*offsets)
    with torch.cuda.device(t0.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, wrapper.__name__)(
            diags.data_ptr(), offs, len(offsets), t0.data_ptr(),
            t1.data_ptr(), acc.data_ptr(), t0.shape[0], t0.shape[1],
            sc, sh, ck, stream)
    if err != 0:
        raise RuntimeError(f"{wrapper.__name__} launch failed: CUDA error "
                           f"{err} ({lib.cheb_error_string(err).decode()})")
    wrapper.launches += 1


def _step(wrapper, dtype, diags, offsets, t0, t1, acc, sc, sh, ck):
    _check(diags, offsets, t0, t1, acc, dtype)
    if t0.is_cuda:
        _launch(wrapper, diags, offsets, t0, t1, acc, float(sc), float(sh),
                float(ck))
    elif t0.device.type == "cpu":
        cheb_step_plain(diags, offsets, t0, t1, acc, float(sc), float(sh),
                        float(ck))
    else:
        raise ValueError(f"unsupported device {t0.device}")


def cheb_step_f32(diags, offsets, t0, t1, acc, sc, sh, ck):
    """One fused f32 step in place (T0 <- T2, acc += ck T2). Scalars are
    used as f32."""
    _step(cheb_step_f32, torch.float32, diags, offsets, t0, t1, acc,
          sc, sh, ck)


def cheb_step_f64(diags, offsets, t0, t1, acc, sc, sh, ck):
    """One fused fp64 step in place (T0 <- T2, acc += ck T2)."""
    _step(cheb_step_f64, torch.float64, diags, offsets, t0, t1, acc,
          sc, sh, ck)


cheb_step_f32.launches = 0
cheb_step_f64.launches = 0


def launch_counts() -> dict:
    return {"cheb_step_f32": cheb_step_f32.launches,
            "cheb_step_f64": cheb_step_f64.launches}


def reset_launch_counts() -> None:
    cheb_step_f32.launches = 0
    cheb_step_f64.launches = 0


def _chunk(step, diags, offsets, carry, coeffs_chunk, sc, sh):
    t0, t1, acc = carry
    for ck in coeffs_chunk:
        step(diags, offsets, t0, t1, acc, sc, sh, ck)
        t0, t1 = t1, t0
    return t0, t1, acc


def cheb_f32_chunk(diags, offsets, carry, coeffs_chunk, sc, sh):
    """Advance the f32 recurrence carry (T0, T1, acc) over a coefficient
    chunk (counterpart of ``cheb_f32_chunk``)."""
    return _chunk(cheb_step_f32, diags, offsets, carry, coeffs_chunk, sc, sh)


def cheb_f64_chunk(diags, offsets, carry, coeffs_chunk, sc, sh):
    """Advance the fp64 recurrence carry over a coefficient chunk
    (counterpart of ``cheb_ds_chunk``)."""
    return _chunk(cheb_step_f64, diags, offsets, carry, coeffs_chunk, sc, sh)
