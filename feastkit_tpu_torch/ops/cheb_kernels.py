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

The multi-step kernels run S = 2 or 4 steps per pass,

    T_{s+2} = 2 (sc * A @ T_{s+1} - sh * T_{s+1}) - T_s,   s = 0..S-1,
    acc += c_0 T_2 + c_1 T_3 + ...   (added in that order),

and return T_S, T_{S+1} and acc, the next pass's carry:

* ``cheb_step2_f32`` / ``cheb_step4_f32`` replace ``_cheb_f32_2_kernel``
  (cheb_pallas.py:749) and ``_cheb_f32_4_kernel`` (:847);
* ``cheb_step2_f64`` / ``cheb_step4_f64`` replace ``_cheb_ds2_kernel``
  (:370) and ``_cheb_ds4_kernel`` (:522), in native fp64.

Their carry is COLUMN-major: contiguous (M, N) tensors, one contiguous
N-vector per subspace column (:func:`transpose_planes` converts). The
stencil couples rows only. Both step counts are one streamed kernel
(``csrc/cheb_stream4.cu``, the step count a template parameter): a thread
block walks down a strip of rows for a group of columns in chunks, the S
levels trailing one another by the stencil's reach, each level in a
shared-memory ring. :func:`multistep_plan` sizes the rings, the column
group and the strips against the card and says whether a shape fits. A
block reads T0 and T1 in its neighbours' rows, so T_S and T_{S+1} are
written to two separate output buffers (the chunk functions ping-pong two
pairs); only acc is updated in place. On a CPU tensor the wrappers run
:func:`cheb_step2_plain` / :func:`cheb_step4_plain`, which are S
applications of :func:`cheb_step_plain`.

The sparse-SPD-B composite (``ops/cheb_gen.py``) runs one-step and
multi-step passes in turn on every outer step, so it needs the one-step
kernels on the column-major carry too: ``cheb_step_cm_f32`` /
``cheb_step_cm_f64`` (``csrc/cheb_step_cm.cu``; plain version
:func:`cheb_step_cm_plain`, the 1-step plain version on the transposed
views). They take T0 and acc as optional operands, which gives four forms
(:data:`CM_FORMS`): without T0 it is read as zero and never loaded, and
T2 goes to a new plane; without acc no accumulator is loaded or stored
(c_k must be 0). Every column-major launch of the composite starts from
T0 = 0, and its y = A~ T1 launch has no accumulator. A thread of the
kernel holds its row's diagonals in registers across a group of columns
(:func:`cm_step_plan`). The wrappers return the plane that holds T2 and
count their launches per form too (:func:`form_launch_counts`). Its
elementwise combine

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

from .cuda_build import SHARED_BYTES_PER_BLOCK
from .cuda_build import SM_SHARED_BYTES as _SM_SHARED_BYTES
from .cuda_build import SMS as _SMS
from .cuda_build import sm_count as _sm_count
from .dia import dia_matvec_plain

__all__ = ["cheb_step_f32", "cheb_step_f64", "cheb_step_plain",
           "cheb_step_cm_f32", "cheb_step_cm_f64", "cheb_step_cm_plain",
           "CM_FORMS", "cm_step_plan",
           "cheb_step2_f32", "cheb_step4_f32", "cheb_step2_f64",
           "cheb_step4_f64", "cheb_step2_plain",
           "cheb_step4_plain",
           "cheb_combine_f32", "cheb_combine_f64", "cheb_combine_plain",
           "cheb_f32_chunk", "cheb_f64_chunk", "cheb_f32_cm_chunk",
           "cheb_f64_cm_chunk", "cheb_f32_2_chunk",
           "cheb_f32_4_chunk", "cheb_f64_2_chunk", "cheb_f64_4_chunk",
           "multistep_plan", "reckoned_traffic", "transpose_planes",
           "SHARED_BYTES_PER_BLOCK",
           "reset_launch_counts", "launch_counts", "form_launch_counts"]

# the streamed multi-step kernel (csrc/cheb_stream4.cu): chunks of 256 rows
# (its compile-time block of threads) and, by the bytes of a value, the
# columns a block may take (a ring row of at most 16 bytes)
_STREAM_CHUNK = 256
_STREAM_COLS = {4: (1, 2, 4), 8: (1, 2)}
# the column-major one-step kernel (csrc/cheb_step_cm.cu): the columns a
# thread may take and its blocks of threads (one row each)
_CM_COLS = (1, 2, 4, 8)
_CM_THREADS = (64, 128, 256, 512)
# the forms of the column-major entries, by (T0 absent, acc absent)
CM_FORMS = ("full", "no_t0", "no_acc", "bare")


def cheb_step_plain(diags, offsets, t0, t1, acc, sc, sh, ck):
    """The plain PyTorch version of one fused step (same in-place contract
    as the kernels; dtype-generic, so it is the plain version of both)."""
    y = dia_matvec_plain(diags, offsets, t1)
    t2 = 2.0 * (sc * y - sh * t1) - t0
    t0.copy_(t2)
    acc.add_(t2, alpha=ck)


def cheb_step_cm_plain(diags, offsets, t0, t1, acc, sc, sh, ck):
    """The plain version of one step on column-major (M, N) planes: the
    arithmetic of :func:`cheb_step_plain` in the same order on the
    transposed views, which write through to the planes. ``t0`` None: T0
    is read as zero and T2 goes to a new plane; ``acc`` None: no
    accumulator (``ck`` is not used). Returns the plane that holds T2
    (``t0`` when given)."""
    x = t1.t()
    t2 = 2.0 * (sc * dia_matvec_plain(diags, offsets, x) - sh * x)
    if t0 is None:
        out = torch.empty_like(t1)
    else:
        t2 = t2 - t0.t()
        out = t0
    out.t().copy_(t2)
    if acc is not None:
        acc.t().add_(t2, alpha=ck)
    return out


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
        raise ValueError(f"T0, T1 and acc must be (N, M) of one shape, "
                         f"got {tuple(t0.shape)}, {tuple(t1.shape)}, "
                         f"{tuple(acc.shape)}")
    n = t0.shape[0]
    if diags.dim() != 2 or diags.shape[0] != len(offsets) \
            or diags.shape[1] != n:
        raise ValueError(f"diags must be ({len(offsets)}, {n}), "
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
    n, m = t0.shape
    with torch.cuda.device(t0.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, wrapper.__name__)(
            diags.data_ptr(), offs, len(offsets), t0.data_ptr(),
            t1.data_ptr(), acc.data_ptr(), n, m, sc, sh, ck, stream)
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


# ------------------------------------------------- column-major one-step

def cm_step_plan(N, M):
    """Block shape of the column-major one-step kernel
    (``csrc/cheb_step_cm.cu``) for an (M, N) carry: a thread owns one row
    for a group of ``cols`` columns (``groups`` = ceil(M / cols) of them,
    the last one ragged), a block ``threads`` rows (``strips`` =
    ceil(N / threads) blocks per group); the grid is strips x groups
    blocks. A thread loads its row's diagonals once per group, so ``cols``
    is the largest of 1, 2, 4, 8 not above M; blocks of 128 threads. At
    the consistent-mass shapes (N = 65,536, M = 72) that block shape was
    the fastest ``chip_smoke.py`` timed in both types and in the form the
    composite launches, and blocks that walk several chunks of rows were
    slower (PERF.md). Raises where the kernel does not take the shape
    (N > 2^30, or more than 65535 groups)."""
    N, M = int(N), int(M)
    if N > 2**30 or M < 0 or N < 0:
        raise ValueError(f"N={N}, M={M}: the column-major one-step kernel "
                         "takes 0 <= N <= 2^30")
    cols = max(c for c in _CM_COLS if c <= max(M, 1))
    if -(-M // cols) > 65535:
        raise ValueError(f"M={M}: more than 65535 column groups")
    return _cm_shape(N, M, cols, 128)


def _cm_shape(N, M, cols, threads):
    """The column-major one-step kernel's plan for a given block shape."""
    if cols < 1 or threads not in _CM_THREADS:
        raise ValueError(f"cols={cols}, threads={threads}: cols >= 1, "
                         f"threads one of {_CM_THREADS}")
    return dict(cols=cols, groups=-(-M // cols), threads=threads,
                strips=-(-N // threads))


@functools.cache
def _cm_library():
    from .cuda_build import load
    lib = load("cheb_step_cm")
    for name, scalar in (("cheb_step_cm_f32", ctypes.c_float),
                         ("cheb_step_cm_f64", ctypes.c_double)):
        fn = getattr(lib, name)
        fn.argtypes = ([ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64),
                        ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                        ctypes.c_void_p, ctypes.c_void_p]
                       + [ctypes.c_int64] * 4 + [scalar] * 3
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    lib.cheb_step_cm_error_string.argtypes = [ctypes.c_int]
    lib.cheb_step_cm_error_string.restype = ctypes.c_char_p
    return lib


def _cm_form(t0, acc):
    return CM_FORMS[(t0 is None) + 2 * (acc is None)]


def _check_cm(diags, offsets, t0, t1, acc, dtype, ck):
    named = [(name, t) for name, t in (("diags", diags), ("T0", t0),
                                       ("T1", t1), ("acc", acc))
             if t is not None]
    for name, t in named:
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if t.device != t1.device:
            raise ValueError(f"{name} is on {t.device}, T1 on {t1.device}")
    planes = [t for _, t in named[1:]]
    if t1.dim() != 2 or any(t.shape != t1.shape for t in planes):
        raise ValueError("T0, T1 and acc must be (M, N) of one shape, got "
                         + ", ".join(str(tuple(t.shape)) for t in planes))
    n = t1.shape[1]
    if diags.dim() != 2 or diags.shape[0] != len(offsets) \
            or diags.shape[1] != n:
        raise ValueError(f"diags must be ({len(offsets)}, {n}), "
                         f"got {tuple(diags.shape)}")
    if len(offsets) > 32:
        raise ValueError(f"at most 32 diagonals, got {len(offsets)}")
    if len({t.data_ptr() for t in planes}) != len(planes):
        raise ValueError("T0, T1 and acc must be distinct buffers")
    if acc is None and ck != 0.0:
        raise ValueError(f"without acc, c_k must be 0, got {ck}")


def _step_cm(wrapper, dtype, diags, offsets, t0, t1, acc, sc, sh, ck,
             plan=None):
    """Check the operands, then launch ``wrapper``'s kernel on CUDA tensors
    (its plain version on CPU tensors); ``plan``: a block shape to launch
    with instead of :func:`cm_step_plan`'s (from :func:`_cm_shape`).
    Returns the plane that holds T2."""
    sc, sh, ck = float(sc), float(sh), float(ck)
    _check_cm(diags, offsets, t0, t1, acc, dtype, ck)
    if t1.device.type == "cpu":
        return cheb_step_cm_plain(diags, offsets, t0, t1, acc, sc, sh, ck)
    if not t1.is_cuda:
        raise ValueError(f"unsupported device {t1.device}")
    for name, t in (("diags", diags), ("T0", t0), ("T1", t1), ("acc", acc)):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    M, N = t1.shape
    if plan is None:
        plan = cm_step_plan(N, M)
    out = torch.empty_like(t1) if t0 is None else t0
    lib = _cm_library()
    offs = (ctypes.c_int64 * max(len(offsets), 1))(*offsets)
    with torch.cuda.device(t1.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, wrapper.__name__)(
            diags.data_ptr(), offs, len(offsets), out.data_ptr(),
            int(t0 is not None), t1.data_ptr(),
            None if acc is None else acc.data_ptr(), N, M, plan["cols"],
            plan["threads"], sc, sh, ck, stream)
    if err != 0:
        raise RuntimeError(
            f"{wrapper.__name__} launch failed: CUDA error {err} "
            f"({lib.cheb_step_cm_error_string(err).decode()})")
    wrapper.launches += 1
    wrapper.form_launches[_cm_form(t0, acc)] += 1
    return out


def cheb_step_cm_f32(diags, offsets, t0, t1, acc, sc, sh, ck):
    """One fused f32 step on column-major (M, N) planes: T2 = 2 (sc A T1 -
    sh T1) - T0 into T0's buffer, acc += ck T2 in place. ``t0`` None: read
    as zero, T2 to a new plane; ``acc`` None: no accumulator (``ck`` must
    be 0). Returns the plane that holds T2. Scalars are used as f32."""
    return _step_cm(cheb_step_cm_f32, torch.float32, diags, offsets, t0, t1,
                    acc, sc, sh, ck)


def cheb_step_cm_f64(diags, offsets, t0, t1, acc, sc, sh, ck):
    """One fused fp64 step on column-major (M, N) planes; see
    :func:`cheb_step_cm_f32`."""
    return _step_cm(cheb_step_cm_f64, torch.float64, diags, offsets, t0, t1,
                    acc, sc, sh, ck)


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
    """Plan of the ``steps``-step kernel (2 or 4) for an (M, N) carry of
    ``dtype``, or None when the shape does not fit this card: the streamed
    plan (:func:`_stream_plan`) of ``csrc/cheb_stream4.cu``, which gives
    ``steps``, ``tile`` (rows a block owns), ``tiles``, ``halo``,
    ``shared_bytes`` and the block shape. Pure function of its arguments:
    the routing among the 4-, 2- and 1-step kernels is decided from it
    before any launch."""
    if steps not in (2, 4):
        raise ValueError(f"steps must be 2 or 4, got {steps}")
    return _stream_plan(offsets, N, M, itemsize=_itemsize(dtype),
                        steps=steps)


def _itemsize(dtype):
    return torch.finfo(dtype).bits // 8


def _stream_plan(offsets, N, M, sms=_SMS, itemsize=4, steps=4):
    """Plan of the streamed ``steps``-step kernel (2 or 4,
    ``csrc/cheb_stream4.cu``) for a carry of ``itemsize``-byte values (4:
    f32, 8: fp64), or None when the shape does not fit.

    A block of ``chunk`` = 256 threads walks down a strip of ``tile`` rows
    for a group of ``cols`` columns, ``chunk`` rows at a time, one thread
    per row. With halo = max |offset|, level s trails level s-1 by ``lag``
    = 1 + ceil(halo / chunk) chunks, and each column keeps one ring per
    level in shared memory (:func:`_ring_lengths`): 9 lag + 3 chunks for
    four steps, 4 lag + 1 for two, within ``SHARED_BYTES_PER_BLOCK``.
    The group takes the widest ring row of 16 bytes, 4 f32 or 2 fp64
    columns (the fastest chip_smoke.py --stream-sweep times at the main
    and nine-diagonal shapes, PERF.md), no more than M needs; where their
    rings do not fit, fewer. Two steps: the shape fits wherever one
    column's rings do (halo up to 14,080 rows in f32, 6,912 in fp64; the
    alternative is one step per launch). Four steps, f32: the shape fits
    when a multiprocessor holds at least two columns' blocks
    (``blocks_per_sm`` x ``cols``), or one where M = 1: halo up to 2816
    rows. One f32 column per block alone on its multiprocessor is slower
    than two 2-step passes (the sweep's 5632 x 256 grid, PERF.md), which
    the solver then takes. Four steps, fp64: one column alone is taken
    wherever its rings fit, halo up to 2816 rows: two fp64 2-step passes
    are slower there (the sweep's 1030^2, 2048^2 and 2816 x 512 grids).
    The strips are cut as :func:`_stream_shape` says."""
    N, M = int(N), int(M)
    if N <= 0 or M <= 0 or len(offsets) > 32:
        return None
    halo = max((abs(int(d)) for d in offsets if abs(int(d)) < N), default=0)
    cols = _STREAM_COLS[itemsize][-1]
    while cols > 1 and cols // 2 >= M:
        cols //= 2
    while _stream_ring_bytes(halo, cols, itemsize=itemsize, steps=steps) \
            > SHARED_BYTES_PER_BLOCK:
        if cols == 1:
            return None
        cols //= 2
    plan = _stream_shape(halo, N, M, cols, sms=sms, itemsize=itemsize,
                         steps=steps)
    if plan is None or steps == 4 and plan["blocks_per_sm"] * cols < (
            min(M, 2) if itemsize == 4 else 1):
        return None
    return plan


def _ring_lengths(steps, lag):
    """The chunks of each level's ring (T1 .. T_steps) in the streamed
    kernel (``ring_len`` of ``csrc/cheb_stream4.cu``): from the chunk
    written in an iteration back to the oldest chunk read in it, plus
    one."""
    return [2 * lag + 1 if r == 0 else 2 * lag if r == steps - 1
            else (steps - 1) * lag + 1 if r == 1 else 2 * lag + 1
            for r in range(steps)]


def _stream_ring_bytes(halo, cols, depth=0, itemsize=4, steps=4):
    lag = 1 + -(-halo // _STREAM_CHUNK)
    stage = 3 * (depth + 1) if depth else 0
    return (cols * (sum(_ring_lengths(steps, lag)) + stage) * _STREAM_CHUNK
            * itemsize)


def _stream_regs(cols, itemsize, steps):
    """The registers a thread of the streamed kernel may use (its
    ``Budget``): 64 K over the 256 threads of the blocks it is built to
    share a multiprocessor with: four steps 4 / cols in f32 and 1 in fp64,
    two steps 2."""
    blocks = 2 if steps == 2 else 4 // cols if itemsize == 4 else 1
    return 65536 // (_STREAM_CHUNK * blocks)


def _stream_shape(halo, N, M, cols, strips=None, depth=0, sms=_SMS,
                  itemsize=4, waves=None, steps=4):
    """The streamed ``steps``-step kernel's plan for a given block shape:
    ``cols`` columns per block (1, 2 or 4 in f32, 1 or 2 in fp64), the
    rows in ``strips`` equal chunk-aligned strips, and ``depth`` iterations
    of ``cp.async`` copies in flight (four steps only; 0: the loads go
    through registers one iteration ahead, as :func:`_stream_plan` takes
    them). None where it does not fit. ``blocks_per_sm`` is how many such
    blocks a multiprocessor holds at once (its 228 KB of shared memory,
    2048 threads, and 64 K registers at the kernel's budget,
    :func:`_stream_regs`). The grid is strips x groups (column groups)
    blocks. Without ``strips``, the strips fill ``waves`` waves of the
    resident blocks over ``sms`` multiprocessors, and no strip is shorter
    than 2 (steps - 1) halo rows; without ``waves``, the count of waves (1
    to 4) whose reckoned time is least: per resident block, its waves times
    the chunks a strip iterates over (its own, and (steps - 1) (2 lag - 1)
    of warm-up and halo)."""
    R = _STREAM_CHUNK
    if cols not in _STREAM_COLS[itemsize]:
        raise ValueError(f"cols={cols}: one of {_STREAM_COLS[itemsize]}")
    if steps not in (2, 4) or (depth and steps != 4):
        raise ValueError(f"steps={steps}, depth={depth}: two or four steps, "
                         "cp.async copies with four only")
    shared = _stream_ring_bytes(halo, cols, depth, itemsize, steps)
    lag = 1 + -(-halo // R)
    groups = -(-M // cols)
    per_sm = max(1, min(_SM_SHARED_BYTES // (shared + 1024), 2048 // R,
                        65536 // (R * _stream_regs(cols, itemsize, steps))))
    resident = per_sm * sms

    def cut(w):
        k = max(1, min(w * resident // groups,
                       N // max(2 * (steps - 1) * halo, R)))
        rounds = -(-k * groups // resident)
        return k, rounds * (-(-N // (k * R)) + (steps - 1) * (2 * lag - 1))

    if strips is None:
        strips = (cut(waves)[0] if waves else
                  min((cut(w) for w in range(1, 5)),
                      key=lambda kc: kc[1])[0])
    tile = -(-(-(-N // strips)) // R) * R
    tiles = -(-N // tile)
    if (shared > SHARED_BYTES_PER_BLOCK or N + tile > 2**31 - 1
            or 2 * N + (2 * steps * lag + 4) * R > 2**31 - 1
            or tiles * groups > 2**31 - 1):
        return None
    return dict(steps=steps, tile=tile, tiles=tiles, halo=halo, chunk=R,
                cols=cols, groups=groups, lag=lag, depth=depth,
                blocks_per_sm=per_sm, shared_bytes=shared)


def reckoned_traffic(plan, offsets, N, itemsize=4):
    """What a streamed multi-step pass under ``plan`` (for ``offsets`` and
    N rows) requests, reckoned from the plan and not read from the card:
    ``recompute`` (rows the levels compute over S times the own rows) and
    ``l2_bytes_per_element`` (bytes requested from L2 per element of the
    carry): T1 with its halo chunks, T0, acc read and written, the two
    outputs written, and each level's diagonals once per block for its
    columns."""
    nd, tile, S = len(offsets), plan["tile"], plan["steps"]
    # per strip, as the kernel walks it: the own chunks and, per level s,
    # the chunks [lo[s], hi[s]) it computes (the own ones and (S-1-s) H
    # more each side, clipped to the matrix)
    R, H = plan["chunk"], plan["lag"] - 1
    own = comp = t1 = t0 = 0
    for s0 in range(0, N, tile):
        k_own = -(-(min(s0 + tile, N) - s0) // R)
        k_max = -(-(N - s0) // R)
        lo = [max(-(S - 1 - s) * H, -(s0 // R)) for s in range(S)]
        hi = [min(k_own + (S - 1 - s) * H, k_max) for s in range(S)]
        own += k_own
        comp += sum(h - l for l, h in zip(lo, hi))
        t1 += hi[0] - lo[0] + 2 * H
        t0 += hi[0] - lo[0]
    return dict(recompute=comp / (S * own),
                l2_bytes_per_element=itemsize * (
                    t1 + t0 + 4 * own + nd * comp / plan["cols"]) / own)


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
def _stream_library(*defines):
    from .cuda_build import load
    lib = load("cheb_stream4", *defines)
    for S in (2, 4):
        for name, scalar in ((f"cheb_step{S}_f32", ctypes.c_float),
                             (f"cheb_step{S}_f64", ctypes.c_double)):
            fn = getattr(lib, name)
            fn.argtypes = (
                [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64),
                 ctypes.c_int] + [ctypes.c_void_p] * 5
                + [ctypes.c_int64] * 6 + [scalar] * (2 + S)
                + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
    lib.cheb_stream4_error_string.argtypes = [ctypes.c_int]
    lib.cheb_stream4_error_string.restype = ctypes.c_char_p
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
               sc, sh, cs, defines=(), plan=None):
    """Check the operands, then launch ``wrapper``'s kernel on CUDA tensors
    (its plain version on CPU tensors). ``defines``: build flags of the
    kernel's library; ``plan``: a plan to launch with instead of the
    entry's own (from :func:`_stream_shape`)."""
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
    if plan is None:
        plan = _stream_plan(offsets, N, M, _sm_count(t0.device),
                            _itemsize(dtype), S)
    if plan is None:
        raise ValueError(
            f"{wrapper.__name__}: N={N}, M={M}, offsets={tuple(offsets)} "
            "does not fit the kernel's shared memory (multistep_plan)")
    if plan["steps"] != S:
        raise ValueError(f"{wrapper.__name__}: a plan of {plan['steps']} "
                         f"steps, not {S}")
    lib = _stream_library(*defines)
    offs = (ctypes.c_int64 * max(len(offsets), 1))(*offsets)
    with torch.cuda.device(t0.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, wrapper.__name__)(
            diags.data_ptr(), offs, len(offsets),
            *(t.data_ptr() for t in planes), N, M, plan["chunk"],
            plan["cols"], plan["tile"], plan["depth"],
            float(sc), float(sh), *cs, stream)
    if err != 0:
        raise RuntimeError(
            f"{wrapper.__name__} launch failed: CUDA error {err} "
            f"({lib.cheb_stream4_error_string(err).decode()})")
    wrapper.launches += 1


def cheb_step2_f32(diags, offsets, t0, t1, acc, out0, out1, sc, sh, cs):
    """Two fused f32 steps on column-major (M, N) tensors: out0 <- T2,
    out1 <- T3, acc += cs[0] T2 + cs[1] T3 in place."""
    _multistep(cheb_step2_f32, 2, torch.float32, diags, offsets, t0, t1,
               acc, out0, out1, sc, sh, cs)


def cheb_step4_f32(diags, offsets, t0, t1, acc, out0, out1, sc, sh, cs):
    """Four fused f32 steps: out0 <- T4, out1 <- T5, acc += sum cs[i]
    T_{2+i} in place (the streamed kernel, ``csrc/cheb_stream4.cu``)."""
    _multistep(cheb_step4_f32, 4, torch.float32, diags, offsets, t0, t1,
               acc, out0, out1, sc, sh, cs)


def cheb_step2_f64(diags, offsets, t0, t1, acc, out0, out1, sc, sh, cs):
    """Two fused fp64 steps; see :func:`cheb_step2_f32`."""
    _multistep(cheb_step2_f64, 2, torch.float64, diags, offsets, t0, t1,
               acc, out0, out1, sc, sh, cs)


def cheb_step4_f64(diags, offsets, t0, t1, acc, out0, out1, sc, sh, cs):
    """Four fused fp64 steps; see :func:`cheb_step4_f32` (the same
    streamed kernel, ``csrc/cheb_stream4.cu``)."""
    _multistep(cheb_step4_f64, 4, torch.float64, diags, offsets, t0, t1,
               acc, out0, out1, sc, sh, cs)


_WRAPPERS = (cheb_step_f32, cheb_step_f64, cheb_step2_f32, cheb_step4_f32,
             cheb_step2_f64, cheb_step4_f64, cheb_step_cm_f32,
             cheb_step_cm_f64, cheb_combine_f32, cheb_combine_f64)


def launch_counts() -> dict:
    return {w.__name__: w.launches for w in _WRAPPERS}


def form_launch_counts() -> dict:
    """The column-major one-step entries' launches by form
    (:data:`CM_FORMS`)."""
    return {w.__name__: dict(w.form_launches)
            for w in (cheb_step_cm_f32, cheb_step_cm_f64)}


def reset_launch_counts() -> None:
    for w in _WRAPPERS:
        w.launches = 0
    for w in (cheb_step_cm_f32, cheb_step_cm_f64):
        w.form_launches = dict.fromkeys(CM_FORMS, 0)


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
