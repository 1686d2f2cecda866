"""Fused Chebyshev-recurrence step: CUDA kernels, plain version, drivers.

Counterpart of ``feastkit_tpu/ops/cheb_pallas.py`` for the one-, two- and
four-step kernels. One step of the three-term recurrence on row-major (N, M)
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

The multi-step kernels (``csrc/cheb_multistep.cu``) run S = 2 or 4 steps
per pass,

    T_{s+2} = 2 (sc * A @ T_{s+1} - sh * T_{s+1}) - T_s,   s = 0..S-1,
    acc += c_0 T_2 + c_1 T_3 + ...   (added in that order),

and return T_S, T_{S+1} and acc, the next pass's carry:

* ``cheb_step2_f32`` / ``cheb_step4_f32`` replace ``_cheb_f32_2_kernel``
  (cheb_pallas.py:749) and ``_cheb_f32_4_kernel`` (:847);
* ``cheb_step2_f64`` / ``cheb_step4_f64`` replace ``_cheb_ds2_kernel``
  (:370) and ``_cheb_ds4_kernel`` (:522), in native fp64.

Their carry is COLUMN-major: contiguous (M, N) tensors, one contiguous
N-vector per subspace column (:func:`transpose_planes` converts). The
stencil couples rows only, so a thread block works on a tile of rows of
one column and keeps the intermediate levels of that tile, with their
halos, in shared memory; :func:`multistep_plan` sizes the tile against the
card's shared memory and says whether a shape fits. A block reads T0 and
T1 in its neighbours' rows, so T_S and T_{S+1} are written to two separate
output buffers (the chunk functions ping-pong two pairs); only acc is
updated in place. On a CPU tensor the wrappers run
:func:`cheb_step2_plain` / :func:`cheb_step4_plain`, which are S
applications of :func:`cheb_step_plain`.

The sparse-SPD-B composite (``ops/cheb_gen.py``) runs one-step and
multi-step passes in turn on every outer step, so it needs the one-step
kernels on the column-major carry too: ``cheb_step_cm_f32`` /
``cheb_step_cm_f64`` are the entries of ``csrc/cheb_step.cu`` for (M, N)
planes (plain version :func:`cheb_step_cm_plain`, the 1-step plain version
on the transposed views). Its elementwise combine

    T2 = 2 (sc * z - sh * x) - T0,    F += c_k * T2,

is ``cheb_combine_f64`` (replaces ``_ds_combine_kernel``,
cheb_pallas.py:990, in native fp64) and ``cheb_combine_f32`` (the f32
rung's three XLA operations, cheb_pallas.py:1174-1185, as one pass), in
``csrc/cheb_combine.cu``; plain version :func:`cheb_combine_plain`.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .dia import dia_matvec_plain

__all__ = ["cheb_step_f32", "cheb_step_f64", "cheb_step_plain",
           "cheb_step_cm_f32", "cheb_step_cm_f64", "cheb_step_cm_plain",
           "cheb_step2_f32", "cheb_step4_f32", "cheb_step2_f64",
           "cheb_step4_f64", "cheb_step2_plain", "cheb_step4_plain",
           "cheb_combine_f32", "cheb_combine_f64", "cheb_combine_plain",
           "cheb_f32_chunk", "cheb_f64_chunk", "cheb_f32_cm_chunk",
           "cheb_f64_cm_chunk", "cheb_f32_2_chunk",
           "cheb_f32_4_chunk", "cheb_f64_2_chunk", "cheb_f64_4_chunk",
           "multistep_plan", "transpose_planes", "SHARED_BYTES_PER_BLOCK",
           "reset_launch_counts", "launch_counts"]

# dynamic shared memory one thread block may use on sm_90 (227 KB), and
# what each of two blocks resident on one SM may use (the SM has 228 KB and
# keeps 1 KB per block for itself)
SHARED_BYTES_PER_BLOCK = 232448
_SHARED_BYTES_TWO_BLOCKS = (233472 - 2 * 1024) // 2
_TILE_ALIGN = 32


def cheb_step_plain(diags, offsets, t0, t1, acc, sc, sh, ck):
    """The plain PyTorch version of one fused step (same in-place contract
    as the kernels; dtype-generic, so it is the plain version of both)."""
    y = dia_matvec_plain(diags, offsets, t1)
    t2 = 2.0 * (sc * y - sh * t1) - t0
    t0.copy_(t2)
    acc.add_(t2, alpha=ck)


def cheb_step_cm_plain(diags, offsets, t0, t1, acc, sc, sh, ck):
    """The plain version of one step on column-major (M, N) planes: the
    row-major plain version on the transposed views, which write through
    to the planes (elementwise the same arithmetic in the same order)."""
    cheb_step_plain(diags, offsets, t0.t(), t1.t(), acc.t(), sc, sh, ck)


@functools.cache
def _library():
    from .cuda_build import load
    lib = load("cheb_step")
    for name, scalar in (("cheb_step_f32", ctypes.c_float),
                         ("cheb_step_f64", ctypes.c_double),
                         ("cheb_step_cm_f32", ctypes.c_float),
                         ("cheb_step_cm_f64", ctypes.c_double)):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64),
                       ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                       scalar, scalar, scalar, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.cheb_error_string.argtypes = [ctypes.c_int]
    lib.cheb_error_string.restype = ctypes.c_char_p
    return lib


def _check(diags, offsets, t0, t1, acc, dtype, colmajor=False):
    for name, t in (("diags", diags), ("T0", t0), ("T1", t1), ("acc", acc)):
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if t.device != t0.device:
            raise ValueError(f"{name} is on {t.device}, T0 on {t0.device}")
    if t0.dim() != 2 or t1.shape != t0.shape or acc.shape != t0.shape:
        layout = "(M, N)" if colmajor else "(N, M)"
        raise ValueError(f"T0, T1 and acc must be {layout} of one shape, "
                         f"got {tuple(t0.shape)}, {tuple(t1.shape)}, "
                         f"{tuple(acc.shape)}")
    n = t0.shape[1] if colmajor else t0.shape[0]
    if diags.dim() != 2 or diags.shape[0] != len(offsets) \
            or diags.shape[1] != n:
        raise ValueError(f"diags must be ({len(offsets)}, {n}), "
                         f"got {tuple(diags.shape)}")
    if len(offsets) > 32:
        raise ValueError(f"at most 32 diagonals, got {len(offsets)}")
    if len({t0.data_ptr(), t1.data_ptr(), acc.data_ptr()}) != 3:
        raise ValueError("T0, T1 and acc must be three distinct buffers")


def _launch(wrapper, diags, offsets, t0, t1, acc, sc, sh, ck, colmajor):
    for name, t in (("diags", diags), ("T0", t0), ("T1", t1), ("acc", acc)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    lib = _library()
    offs = (ctypes.c_int64 * max(len(offsets), 1))(*offsets)
    n, m = (t0.shape[1], t0.shape[0]) if colmajor else t0.shape
    with torch.cuda.device(t0.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, wrapper.__name__)(
            diags.data_ptr(), offs, len(offsets), t0.data_ptr(),
            t1.data_ptr(), acc.data_ptr(), n, m, sc, sh, ck, stream)
    if err != 0:
        raise RuntimeError(f"{wrapper.__name__} launch failed: CUDA error "
                           f"{err} ({lib.cheb_error_string(err).decode()})")
    wrapper.launches += 1


def _step(wrapper, dtype, diags, offsets, t0, t1, acc, sc, sh, ck,
          colmajor=False):
    _check(diags, offsets, t0, t1, acc, dtype, colmajor)
    if t0.is_cuda:
        _launch(wrapper, diags, offsets, t0, t1, acc, float(sc), float(sh),
                float(ck), colmajor)
    elif t0.device.type == "cpu":
        plain = cheb_step_cm_plain if colmajor else cheb_step_plain
        plain(diags, offsets, t0, t1, acc, float(sc), float(sh), float(ck))
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


def cheb_step_cm_f32(diags, offsets, t0, t1, acc, sc, sh, ck):
    """One fused f32 step in place on column-major (M, N) planes."""
    _step(cheb_step_cm_f32, torch.float32, diags, offsets, t0, t1, acc,
          sc, sh, ck, colmajor=True)


def cheb_step_cm_f64(diags, offsets, t0, t1, acc, sc, sh, ck):
    """One fused fp64 step in place on column-major (M, N) planes."""
    _step(cheb_step_cm_f64, torch.float64, diags, offsets, t0, t1, acc,
          sc, sh, ck, colmajor=True)


# ------------------------------------------------------------ combine

def cheb_combine_plain(z, x, t0, f, sc, sh, ck):
    """The plain version of the combine (same contract as the kernels;
    dtype-generic): T2 = 2 (sc z - sh x) - T0 and F + ck T2. ``t0`` and
    ``f`` are updated in place (T0 <- T2, f <- F'); either may be None,
    read as zero (T2 is then not kept; F' goes to a new plane). Returns
    the plane that holds F'."""
    t2 = 2.0 * (sc * z - sh * x)
    if t0 is not None:
        t2 = t2 - t0
        t0.copy_(t2)
    if f is None:
        return ck * t2
    return f.add_(t2, alpha=ck)


@functools.cache
def _combine_library():
    from .cuda_build import load
    lib = load("cheb_combine")
    for name, scalar in (("cheb_combine_f32", ctypes.c_float),
                         ("cheb_combine_f64", ctypes.c_double)):
        fn = getattr(lib, name)
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int64]
                       + [scalar] * 3 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    lib.cheb_combine_error_string.argtypes = [ctypes.c_int]
    lib.cheb_combine_error_string.restype = ctypes.c_char_p
    return lib


def _combine(wrapper, dtype, z, x, t0, f, sc, sh, ck):
    named = [("z", z), ("x", x), ("T0", t0), ("F", f)]
    for name, t in named:
        if t is None:
            continue
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if t.device != z.device:
            raise ValueError(f"{name} is on {t.device}, z on {z.device}")
        if t.shape != z.shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, z "
                             f"{tuple(z.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    ptrs = [t.data_ptr() for _, t in named if t is not None]
    if len(set(ptrs)) != len(ptrs):
        raise ValueError("z, x, T0 and F must be distinct buffers")
    sc, sh, ck = float(sc), float(sh), float(ck)
    if z.device.type == "cpu":
        return cheb_combine_plain(z, x, t0, f, sc, sh, ck)
    if not z.is_cuda:
        raise ValueError(f"unsupported device {z.device}")
    out = torch.empty_like(z) if f is None else f
    lib = _combine_library()

    def ptr(t):
        return None if t is None else t.data_ptr()
    with torch.cuda.device(z.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, wrapper.__name__)(
            z.data_ptr(), x.data_ptr(), ptr(t0), ptr(t0), ptr(f),
            out.data_ptr(), z.numel(), sc, sh, ck, stream)
    if err != 0:
        raise RuntimeError(
            f"{wrapper.__name__} launch failed: CUDA error {err} "
            f"({lib.cheb_combine_error_string(err).decode()})")
    wrapper.launches += 1
    return out


def cheb_combine_f32(z, x, t0, f, sc, sh, ck):
    """The f32 combine in one pass: T0 <- 2 (sc z - sh x) - T0 and
    f += ck T2 in place (``t0`` / ``f`` None: read as zero, F' returned in
    a new plane). Returns the plane that holds F'. Scalars are used as
    f32."""
    return _combine(cheb_combine_f32, torch.float32, z, x, t0, f, sc, sh, ck)


def cheb_combine_f64(z, x, t0, f, sc, sh, ck):
    """The fp64 combine; see :func:`cheb_combine_f32`."""
    return _combine(cheb_combine_f64, torch.float64, z, x, t0, f, sc, sh, ck)


# --------------------------------------------------------- multi-step

def multistep_plan(offsets, N, M, dtype, steps):
    """Tile plan of the ``steps``-step kernel (2 or 4) for an (M, N) carry
    of ``dtype``, or None when the shape does not fit this card.

    A block of the kernel owns ``tile`` rows of one column and holds in
    shared memory, with halo = max |offset|: level T2 on tile + 2 (S-1)
    halo rows (T4 is later written over it), for S = 4 level T3 on tile +
    4 halo rows, and the tile's partial accumulator: 2 tile + 2 halo
    elements for S = 2, 3 tile + 10 halo for S = 4, within
    ``SHARED_BYTES_PER_BLOCK``. The shape fits when the largest such tile
    is at least as long as the 2 (S-1) halo rows recomputed beside it at
    the first level (so a pass recomputes at most half of its work). Where
    a tile of half the SM's shared memory is still twice that long, the
    plan takes it, so that two blocks are resident per SM (the kernel is
    latency-bound, and it is built for the 32 registers per thread that
    two blocks of 1024 threads may have;
    measured faster for the 2-step kernels at the main shapes, PERF.md);
    the rows are then split into equal tiles. ``recompute`` and
    ``planes_moved`` are reckoned from the tile and the halo, not read
    from the card. Pure function of its arguments: the routing among the
    4-, 2- and 1-step kernels is decided from it before any launch."""
    if steps not in (2, 4):
        raise ValueError(f"steps must be 2 or 4, got {steps}")
    N, M = int(N), int(M)
    itemsize = torch.finfo(dtype).bits // 8
    halo = max((abs(int(d)) for d in offsets if abs(int(d)) < N), default=0)
    n_tile, n_halo = (3, 10) if steps == 4 else (2, 2)
    min_tile = max(2 * (steps - 1) * halo, _TILE_ALIGN)

    def largest_tile(shared_bytes):
        words = shared_bytes // itemsize
        return (words - n_halo * halo) // n_tile // _TILE_ALIGN * _TILE_ALIGN

    tile_max = largest_tile(SHARED_BYTES_PER_BLOCK)
    if (N <= 0 or M <= 0 or len(offsets) > 32
            or tile_max < min_tile
            or 2 * N + tile_max + (steps + 1) * halo + 1024 > 2**31 - 1):
        return None
    if largest_tile(_SHARED_BYTES_TWO_BLOCKS) >= 2 * min_tile:
        tile_max = largest_tile(_SHARED_BYTES_TWO_BLOCKS)
    tiles = -(-N // tile_max)
    if tiles * M > 2**31 - 1:                # one block per (tile, column)
        return None
    tile = -(-(-(-N // tiles)) // _TILE_ALIGN) * _TILE_ALIGN
    return dict(steps=steps, tile=tile, tiles=tiles, halo=halo,
                shared_bytes=(n_tile * tile + n_halo * halo) * itemsize,
                # arithmetic relative to S exact steps on the own rows
                recompute=1.0 + (steps - 1) * halo / tile,
                # (N, M) planes a pass reads and writes through the halos:
                # T1 on tile + 2 S halo, T0 on tile + 2 (S-1) halo, acc
                # read; T_S, T_{S+1}, acc written
                planes_moved=6.0 + (4 * steps - 2) * halo / tile)


def transpose_planes(planes: list) -> None:
    """Transpose each 2-D tensor of the list into a new contiguous tensor,
    in place in the list: row-major (N, M) planes become the column-major
    (M, N) planes of the multi-step kernels, and back. One plane at a
    time, so each source is released before the next copy is made."""
    for i, x in enumerate(planes):
        planes[i] = x.t().contiguous()


def _multistep_plain(S, diags, offsets, t0, t1, acc, out0, out1, sc, sh, cs):
    if len(cs) != S:
        raise ValueError(f"expected {S} coefficients, got {len(cs)}")
    a, b, c = (x.t().clone(memory_format=torch.contiguous_format)
               for x in (t0, t1, acc))
    for ck in cs:
        cheb_step_plain(diags, offsets, a, b, c, float(sc), float(sh),
                        float(ck))
        a, b = b, a
    out0.copy_(a.t())
    out1.copy_(b.t())
    acc.copy_(c.t())


def cheb_step2_plain(diags, offsets, t0, t1, acc, out0, out1, sc, sh, cs):
    """The plain PyTorch version of one two-step pass on column-major
    (M, N) tensors: two applications of :func:`cheb_step_plain`. Same
    contract as the kernels: T0 and T1 are left as they are, out0 <- T2,
    out1 <- T3, acc updated in place. dtype-generic."""
    _multistep_plain(2, diags, offsets, t0, t1, acc, out0, out1, sc, sh, cs)


def cheb_step4_plain(diags, offsets, t0, t1, acc, out0, out1, sc, sh, cs):
    """The plain PyTorch version of one four-step pass (out0 <- T4,
    out1 <- T5); see :func:`cheb_step2_plain`."""
    _multistep_plain(4, diags, offsets, t0, t1, acc, out0, out1, sc, sh, cs)


@functools.cache
def _multistep_library(*defines):
    from .cuda_build import load
    lib = load("cheb_multistep", *defines)
    for name, scalar, S in (("cheb_step2_f32", ctypes.c_float, 2),
                            ("cheb_step4_f32", ctypes.c_float, 4),
                            ("cheb_step2_f64", ctypes.c_double, 2),
                            ("cheb_step4_f64", ctypes.c_double, 4)):
        fn = getattr(lib, name)
        fn.argtypes = ([ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64),
                        ctypes.c_int] + [ctypes.c_void_p] * 5
                       + [ctypes.c_int64] * 3 + [scalar] * (2 + S)
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    lib.cheb_multistep_error_string.argtypes = [ctypes.c_int]
    lib.cheb_multistep_error_string.restype = ctypes.c_char_p
    return lib


def _check_multistep(diags, offsets, planes, dtype):
    names = ("T0", "T1", "acc", "out0", "out1")
    t0 = planes[0]
    for name, t in (("diags", diags), *zip(names, planes)):
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if t.device != t0.device:
            raise ValueError(f"{name} is on {t.device}, T0 on {t0.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if t0.dim() != 2 or any(t.shape != t0.shape for t in planes):
        raise ValueError("T0, T1, acc, out0 and out1 must be column-major "
                         "(M, N) of one shape, got "
                         + ", ".join(str(tuple(t.shape)) for t in planes))
    if diags.dim() != 2 or diags.shape[0] != len(offsets) \
            or diags.shape[1] != t0.shape[1]:
        raise ValueError(f"diags must be ({len(offsets)}, {t0.shape[1]}), "
                         f"got {tuple(diags.shape)}")
    if len(offsets) > 32:
        raise ValueError(f"at most 32 diagonals, got {len(offsets)}")
    if len({t.data_ptr() for t in planes}) != 5:
        raise ValueError("T0, T1, acc, out0 and out1 must be five distinct "
                         "buffers")


def _multistep(wrapper, S, dtype, diags, offsets, t0, t1, acc, out0, out1,
               sc, sh, cs, defines=()):
    planes = (t0, t1, acc, out0, out1)
    _check_multistep(diags, offsets, planes, dtype)
    cs = [float(c) for c in cs]
    if len(cs) != S:
        raise ValueError(f"expected {S} coefficients, got {len(cs)}")
    if t0.device.type == "cpu":
        _multistep_plain(S, diags, offsets, t0, t1, acc, out0, out1, sc, sh,
                         cs)
        return
    if not t0.is_cuda:
        raise ValueError(f"unsupported device {t0.device}")
    M, N = t0.shape
    plan = multistep_plan(offsets, N, M, dtype, S)
    if plan is None:
        raise ValueError(
            f"{wrapper.__name__}: N={N}, M={M}, offsets={tuple(offsets)} "
            "does not fit the kernel's shared-memory tile (multistep_plan)")
    lib = _multistep_library(*defines)
    offs = (ctypes.c_int64 * max(len(offsets), 1))(*offsets)
    with torch.cuda.device(t0.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, wrapper.__name__)(
            diags.data_ptr(), offs, len(offsets),
            *(t.data_ptr() for t in planes), N, M, plan["tile"],
            float(sc), float(sh), *cs, stream)
    if err != 0:
        raise RuntimeError(
            f"{wrapper.__name__} launch failed: CUDA error {err} "
            f"({lib.cheb_multistep_error_string(err).decode()})")
    wrapper.launches += 1


def cheb_step2_f32(diags, offsets, t0, t1, acc, out0, out1, sc, sh, cs):
    """Two fused f32 steps on column-major (M, N) tensors: out0 <- T2,
    out1 <- T3, acc += cs[0] T2 + cs[1] T3 in place."""
    _multistep(cheb_step2_f32, 2, torch.float32, diags, offsets, t0, t1,
               acc, out0, out1, sc, sh, cs)


def cheb_step4_f32(diags, offsets, t0, t1, acc, out0, out1, sc, sh, cs):
    """Four fused f32 steps: out0 <- T4, out1 <- T5, acc += sum cs[i]
    T_{2+i} in place."""
    _multistep(cheb_step4_f32, 4, torch.float32, diags, offsets, t0, t1,
               acc, out0, out1, sc, sh, cs)


def cheb_step2_f64(diags, offsets, t0, t1, acc, out0, out1, sc, sh, cs):
    """Two fused fp64 steps; see :func:`cheb_step2_f32`."""
    _multistep(cheb_step2_f64, 2, torch.float64, diags, offsets, t0, t1,
               acc, out0, out1, sc, sh, cs)


def cheb_step4_f64(diags, offsets, t0, t1, acc, out0, out1, sc, sh, cs):
    """Four fused fp64 steps; see :func:`cheb_step4_f32`."""
    _multistep(cheb_step4_f64, 4, torch.float64, diags, offsets, t0, t1,
               acc, out0, out1, sc, sh, cs)


_WRAPPERS = (cheb_step_f32, cheb_step_f64, cheb_step2_f32, cheb_step4_f32,
             cheb_step2_f64, cheb_step4_f64, cheb_step_cm_f32,
             cheb_step_cm_f64, cheb_combine_f32, cheb_combine_f64)


def launch_counts() -> dict:
    return {w.__name__: w.launches for w in _WRAPPERS}


def reset_launch_counts() -> None:
    for w in _WRAPPERS:
        w.launches = 0


reset_launch_counts()


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


def cheb_f32_cm_chunk(diags, offsets, carry, coeffs_chunk, sc, sh):
    """One-step launches over a chunk on the column-major f32 carry."""
    return _chunk(cheb_step_cm_f32, diags, offsets, carry, coeffs_chunk, sc,
                  sh)


def cheb_f64_cm_chunk(diags, offsets, carry, coeffs_chunk, sc, sh):
    """One-step launches over a chunk on the column-major fp64 carry."""
    return _chunk(cheb_step_cm_f64, diags, offsets, carry, coeffs_chunk, sc,
                  sh)


def _multistep_chunk(step, S, diags, offsets, carry, coeffs_chunk, sc, sh):
    if len(coeffs_chunk) % S:
        raise ValueError(f"chunk length {len(coeffs_chunk)} is not a "
                         f"multiple of {S}")
    t0, t1, acc = carry
    if len(coeffs_chunk) == 0:
        return t0, t1, acc
    out0, out1 = torch.empty_like(t0), torch.empty_like(t1)
    for i in range(0, len(coeffs_chunk), S):
        step(diags, offsets, t0, t1, acc, out0, out1, sc, sh,
             coeffs_chunk[i:i + S])
        t0, t1, out0, out1 = out0, out1, t0, t1
    return t0, t1, acc


def cheb_f32_2_chunk(diags, offsets, carry, coeffs_chunk, sc, sh):
    """Advance the column-major f32 carry (T0, T1, acc) two steps per pass
    over a chunk of even length (counterpart of ``cheb_f32_2_chunk``). The
    carry's T buffers are reused as the second output pair, so the carry
    passed in is consumed; two more planes are allocated."""
    return _multistep_chunk(cheb_step2_f32, 2, diags, offsets, carry,
                            coeffs_chunk, sc, sh)


def cheb_f32_4_chunk(diags, offsets, carry, coeffs_chunk, sc, sh):
    """Four steps per pass over a chunk whose length is a multiple of 4
    (counterpart of ``cheb_f32_4_chunk``); see :func:`cheb_f32_2_chunk`."""
    return _multistep_chunk(cheb_step4_f32, 4, diags, offsets, carry,
                            coeffs_chunk, sc, sh)


def cheb_f64_2_chunk(diags, offsets, carry, coeffs_chunk, sc, sh):
    """The fp64 two-step chunk (counterpart of ``cheb_ds2_chunk``)."""
    return _multistep_chunk(cheb_step2_f64, 2, diags, offsets, carry,
                            coeffs_chunk, sc, sh)


def cheb_f64_4_chunk(diags, offsets, carry, coeffs_chunk, sc, sh):
    """The fp64 four-step chunk (counterpart of ``cheb_ds4_chunk``)."""
    return _multistep_chunk(cheb_step4_f64, 4, diags, offsets, carry,
                            coeffs_chunk, sc, sh)
