"""Row-aligned DIA (diagonal-offset) storage and its matvec: CUDA kernels,
plain version, complex and batched entries.

Counterpart of ``feastkit_tpu/ops/pallas_kernels.py``. ``diags`` is (nd, N)
with a static ``offsets`` tuple; row k holds diagonal offsets[k] aligned to
rows: diags[k, i] = A[i, i + offsets[k]] (zero where out of range), so

    y[i, :] = sum_k diags[k, i] * x[i + offsets[k], :]

* ``dia_matvec_f32`` / ``dia_matvec_f64`` replace ``_dia_kernel``
  (pallas_kernels.py:91, via ``_dia_matvec_32`` :163 and ``dia_matvec``
  :141) on a row-major (N, M) operand;
* ``dia_matvec_batched_f32`` / ``dia_matvec_batched_f64`` replace
  ``_dia_kernel_b`` (:206, via ``_dia_matvec_batched`` :226, the
  ``custom_vmap`` rule the JAX package's node-group dispatch runs) on
  (g, N, M) operands that share the diagonals.

The fp64 entries also stand where the JAX package takes an XLA shifted-add
product for 64-bit data (Mosaic has no 64-bit types): on the card every DIA
product of the port runs in these kernels, the Krylov engine's shifted
applications, the Rayleigh-Ritz, residual and back-transform products and
the Lanczos bounds of the polynomial path alike. The recurrence's own
matvec is fused into the Chebyshev step kernels of ``ops/cheb_kernels.py``.

On a CUDA tensor each wrapper launches its kernel (``csrc/dia_matvec.cu``)
or raises; on a CPU tensor it runs :func:`dia_matvec_plain`, the
shifted-add version of the product (the counterpart of
``dia_matvec_reference``). The kernel has two bodies, and
:func:`dia_plan` chooses one by shape before the launch: the ring body
(x rows read once per strip through a shared-memory ring, each diagonal
value loaded once per row for a column group of all g operands) wherever
a row is whole 16-byte pieces and the ring fits, the flat body (one
thread per element) elsewhere, such as the M = 1 Lanczos vectors. The
wrapper caches the plan and its ctypes arguments per shape. Each wrapper
counts its launches in its ``launches`` attribute, and by body in
``body_launches``. :func:`dia_matvec_any` takes any real/complex
combination: real diagonals times a complex x is ONE launch on the real
view of x (a complex (N, K) tensor is a real (N, 2K) one), where the JAX
package makes two calls; complex diagonals keep its four-product
decomposition.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from .cuda_build import SHARED_BYTES_PER_BLOCK
from .cuda_build import SM_SHARED_BYTES as _SM_SHARED_BYTES
from .cuda_build import SMS as _SMS
from .cuda_build import sm_count as _sm_count

__all__ = ["bands_to_dia", "bcoo_to_dia", "dia_matvec", "dia_matvec_plain",
           "dia_matvec_batched", "dia_matvec_any", "dia_matvec_f32",
           "dia_matvec_f64", "dia_matvec_batched_f32",
           "dia_matvec_batched_f64", "dia_plan", "reckoned_traffic",
           "ring_chunks", "ring_bytes", "launch_counts", "body_counts",
           "reset_launch_counts"]

_MAX_DIAGS = 32


def bands_to_dia(bands, kl: int, ku: int):
    """LAPACK-band layout -> row-aligned (diags, offsets) (host numpy).

    bands[k, j] = A[j - (ku-k), j]  ->  diags[k, i] = A[i, i + d], d = ku-k.
    """
    bands = np.asarray(bands)
    nb, N = bands.shape
    offsets = tuple(ku - k for k in range(nb))
    diags = np.zeros_like(bands)
    for k, d in enumerate(offsets):
        if d >= 0:
            diags[k, : N - d] = bands[k, d:]
        else:
            diags[k, -d:] = bands[k, : N + d]
    return diags, offsets


def bcoo_to_dia(data, indices, N, max_diags: int = _MAX_DIAGS):
    """COO arrays -> (diags, offsets) if the matrix lives on at most
    ``max_diags`` diagonals, else None (host numpy; duplicates add)."""
    data = np.asarray(data)
    indices = np.asarray(indices)
    offs = indices[:, 1].astype(np.int64) - indices[:, 0].astype(np.int64)
    uniq = np.unique(offs)
    if len(uniq) > max_diags:
        return None
    diags = np.zeros((len(uniq), N), data.dtype)
    pos = np.searchsorted(uniq, offs)
    np.add.at(diags, (pos, indices[:, 0]), data)
    return diags, tuple(int(d) for d in uniq)


def dia_matvec_plain(diags: torch.Tensor, offsets, x: torch.Tensor
                     ) -> torch.Tensor:
    """The plain PyTorch version: y = A x for x of shape (..., N, M) (any
    leading batch axes) by shifted multiply-adds (in-place ``addcmul_`` on
    the output: no temporary per diagonal). dtype-generic, so it is the
    plain version of every entry."""
    N = diags.shape[1]
    y = torch.zeros_like(x)
    for k, d in enumerate(offsets):
        if abs(d) >= N:
            continue
        if d >= 0:
            y[..., : N - d, :].addcmul_(diags[k, : N - d, None],
                                        x[..., d:, :])
        else:
            y[..., -d:, :].addcmul_(diags[k, -d:, None], x[..., : N + d, :])
    return y


@functools.cache
def _library():
    from .cuda_build import load
    lib = load("dia_matvec")
    for name, batched in (("dia_matvec_f32", False),
                          ("dia_matvec_f64", False),
                          ("dia_matvec_batched_f32", True),
                          ("dia_matvec_batched_f64", True)):
        fn = getattr(lib, name)
        fn.argtypes = ([ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64),
                        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                        ctypes.c_int64, ctypes.c_int64]
                       + [ctypes.c_int64] * batched
                       + [ctypes.POINTER(ctypes.c_int), ctypes.c_void_p])
        fn.restype = ctypes.c_int
    lib.dia_error_string.argtypes = [ctypes.c_int]
    lib.dia_error_string.restype = ctypes.c_char_p
    return lib


# ----------------------------------------------------------------- the plan

_THREADS = 256                # threads a block, at most
# the ring body's fields, in the order csrc/dia_matvec.cu's launch_ring
# reads them
RING_PLAN_FIELDS = ("cols", "chunk", "lanes", "lag", "depth", "tile")
# the ring body's auto plan, the fastest of chip_smoke.py --dia-sweep at the
# Krylov shapes (PERF.md): each operand's 64 bytes of a ring row (f32 16
# columns, fp64 8), 6 chunks of copies in flight for one operand and 4 for
# a batch, two blocks a multiprocessor in one wave
_ROW_BYTES = 64
_BLOCKS_PER_SM = 2
_MAX_DEPTH = 8


def _auto_depth(g):
    return 6 if g == 1 else 4


def ring_chunks(lag: int, depth: int) -> int:
    """The ring's length in chunks (``ring_chunks`` of
    ``csrc/dia_matvec.cu``): the 2 lag + 1 chunks an iteration reads and the
    ``depth`` chunks whose copies are in flight while it does."""
    return 2 * lag + 1 + depth


def ring_bytes(ring, chunk, lanes, depth, nd, itemsize):
    """A ring-body block's shared memory (``ring_bytes`` of
    ``csrc/dia_matvec.cu``): the x ring of ``ring`` chunks of ``chunk``
    rows of ``lanes`` 16-byte pieces, and the diagonal stage of depth + 1
    chunks of nd values a row."""
    return ring * chunk * lanes * 16 + (depth + 1) * nd * chunk * itemsize


def dia_plan(offsets, N, M, g=1, dtype=torch.float32, sms=_SMS, *,
             body=None, cols=None, depth=None, strips=None):
    """The launch plan of the DIA matvec for g row-major (N, M) operands of
    ``dtype``: which of ``csrc/dia_matvec.cu``'s two bodies runs, and the
    ring body's block shape. A pure function of its arguments (the wrapper
    caches it per shape): the route is chosen before any launch, by shape
    alone, and every plan names its ``body``.

    The ring body takes a shape whose rows are whole 16-byte pieces (M a
    multiple of ``vec`` = 4 f32 or 2 fp64 columns, and at least two) and
    whose indices fit 32 bits (g N M and nd N below 2^31), where two of its
    blocks fit a multiprocessor's shared memory. Its fields: ``cols``
    columns of each operand a block (``_ROW_BYTES`` of each operand's row,
    at most M); ``lanes`` = g cols / vec threads a row, ``chunk`` = 256 //
    lanes rows an iteration, ``threads`` = lanes chunk; ``halo`` = max
    |offset| over the ``nd`` diagonals inside the matrix, ``lag`` =
    ceil(halo / chunk); ``depth`` chunks of copies in flight (6 for one
    operand, 4 for a batch, fewer down to 2 where two blocks would not fit
    otherwise); ``ring`` = :func:`ring_chunks` chunks of ``lanes`` 16-byte
    pieces a row, and the diagonal values of depth + 1 chunks
    (``shared_bytes``, :func:`ring_bytes`); strips of ``tile`` rows (a
    multiple of chunk), ``tiles`` of them, ``groups`` = ceil(M / cols)
    column groups, ``blocks`` = tiles x groups, ``blocks_per_sm`` by shared
    memory and threads. Without ``strips``, the strips make two blocks a
    multiprocessor over ``sms`` in one wave, none shorter than its 2 lag
    halo chunks. The halo rows a strip reads twice then come to a quarter
    of x at the Krylov shapes, and the sweep times them as the fastest: a
    neighbour reads them at about the same time, from L2. Every other
    shape takes the flat body (``reason`` says why): the M = 1 Lanczos
    vectors, odd M, and halos whose rings leave one block a multiprocessor
    (the P=10 Rayleigh-Ritz product, halo 1024 in fp64, where the flat
    body is as fast as the best ring in the sweep). ``body``, ``cols``,
    ``depth`` and ``strips`` override the choice (chip_smoke.py's sweep and
    the card tests); an override the ring body cannot take raises."""
    N, M, g = int(N), int(M), int(g)
    offsets = tuple(int(d) for d in offsets)
    itemsize = torch.finfo(dtype).bits // 8
    vec = 16 // itemsize
    inside = [d for d in offsets if abs(d) < N]
    halo = max((abs(d) for d in inside), default=0)
    flat = dict(body="flat", nd=len(offsets), halo=halo, vec=vec,
                blocks=-(-N * M // _THREADS) * g, threads=_THREADS,
                shared_bytes=0)
    reason = None
    if M % vec or M < 2 * vec:
        reason = f"M = {M} is not whole 16-byte pieces of at least two"
    elif g * N * M >= 2**31 or len(offsets) * N >= 2**31:
        reason = "64-bit indices"
    elif g > _THREADS:
        reason = f"g = {g} operands exceed a block's threads"
    if body == "flat" or body is None and reason is not None:
        return dict(flat, reason=reason or "asked for")
    if reason is not None:
        raise ValueError(f"the ring body does not take this shape: {reason}")
    if body not in (None, "ring"):
        raise ValueError(f"body must be 'ring' or 'flat', got {body!r}")

    def shape(c, dpt):
        lanes = g * c // vec
        chunk = _THREADS // lanes
        lag = -(-halo // chunk)
        ring = ring_chunks(lag, dpt)
        return lanes, chunk, lag, ring, ring_bytes(ring, chunk, lanes, dpt,
                                                   len(inside), itemsize)

    auto = cols is None and depth is None
    if cols is None:
        cols = min(_ROW_BYTES // itemsize, M, _THREADS * vec // g // vec * vec)
    dpt = _auto_depth(g) if depth is None else int(depth)
    if cols % vec or cols <= 0 or g * cols // vec > _THREADS \
            or not 1 <= dpt <= _MAX_DEPTH:
        raise ValueError(f"cols = {cols} (a multiple of {vec}, g cols / "
                         f"{vec} <= {_THREADS}) and depth = {dpt} (1.."
                         f"{_MAX_DEPTH}) do not make a ring plan")
    lanes, chunk, lag, ring, shared = shape(cols, dpt)

    def per_sm(nbytes):
        return min(_SM_SHARED_BYTES // (nbytes + 1024),
                   2048 // (lanes * chunk))

    # fewer copies in flight, down to 2, until two blocks fit
    while auto and per_sm(shared) < _BLOCKS_PER_SM and dpt > 2:
        dpt -= 1
        lanes, chunk, lag, ring, shared = shape(cols, dpt)
    if shared > SHARED_BYTES_PER_BLOCK or (
            auto and body is None and per_sm(shared) < _BLOCKS_PER_SM):
        if body == "ring":
            raise ValueError(f"the ring of {shared} bytes does not fit "
                             f"{SHARED_BYTES_PER_BLOCK}")
        return dict(flat, reason=f"halo {halo}: two blocks' rings of "
                    f"{shared} bytes do not fit a multiprocessor")
    threads = lanes * chunk
    groups = -(-M // cols)
    resident = max(1, min(per_sm(shared), _BLOCKS_PER_SM)) * sms
    if strips is None:
        strips = max(1, min(resident // groups,
                            N // max(2 * lag * chunk, 1)))
    strips = max(1, min(int(strips), -(-N // chunk)))
    tile = -(-(-(-N // strips)) // chunk) * chunk
    tiles = -(-N // tile)
    return dict(body="ring", nd=len(inside), halo=halo, vec=vec, cols=cols,
                lanes=lanes, chunk=chunk, threads=threads, lag=lag,
                depth=dpt, ring=ring, shared_bytes=shared, tile=tile,
                tiles=tiles, groups=groups, blocks=tiles * groups,
                blocks_per_sm=max(1, per_sm(shared)))


def reckoned_traffic(plan, N, M, g=1):
    """What one launch under ``plan`` requests from L2, reckoned from the
    plan and not read from the card: ``l2_bytes_per_element`` per element
    of x, and ``halo_share``, the x rows the ring body loads beyond the
    operand's own over its own. The ring body: x once per strip with L
    chunks each side (clipped to the matrix), y once, each diagonal inside
    the matrix once per row and column group. The flat body: nd neighbours
    of x and y per element, and the nd diagonal values once per warp's row
    (a broadcast to min(M, 32) threads)."""
    itemsize = 16 // plan["vec"]
    nd = plan["nd"]
    if plan["body"] == "flat":
        per = nd + 1 + nd / min(M, 32)
        return dict(l2_bytes_per_element=itemsize * per, halo_share=0.0)
    R, L, tile = plan["chunk"], plan["lag"], plan["tile"]
    rows = 0
    for s0 in range(0, N, tile):
        rows += min(s0 + tile + L * R, N) - max(s0 - L * R, 0)
    x_el = rows * g * M
    per = (x_el + g * N * M + nd * N * plan["groups"]) / (g * N * M)
    return dict(l2_bytes_per_element=itemsize * per,
                halo_share=rows / N - 1.0)


@functools.lru_cache(maxsize=256)
def _cached_launch(offsets, N, M, g, dtype, sms):
    """The plan and the ctypes arguments of a shape, made once: the
    offsets array and, for the ring body, its plan fields."""
    plan = dia_plan(offsets, N, M, g, dtype, sms)
    return plan, _offsets_array(offsets), _plan_array(plan)


def _offsets_array(offsets):
    return (ctypes.c_int64 * max(len(offsets), 1))(*offsets)


def _plan_array(plan):
    if plan["body"] == "flat":
        return None
    return (ctypes.c_int * len(RING_PLAN_FIELDS))(
        *(plan[f] for f in RING_PLAN_FIELDS))


# ----------------------------------------------------------------- wrappers

def _check(diags, offsets, x, dtype, batched):
    for name, t in (("diags", diags), ("x", x)):
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if diags.device != x.device:
        raise ValueError(f"diags is on {diags.device}, x on {x.device}")
    if x.dim() != (3 if batched else 2):
        raise ValueError(f"x must be {'(g, N, M)' if batched else '(N, M)'}"
                         f", got shape {tuple(x.shape)}")
    if diags.dim() != 2 or diags.shape[0] != len(offsets) \
            or diags.shape[1] != x.shape[-2]:
        raise ValueError(f"diags must be ({len(offsets)}, {x.shape[-2]}), "
                         f"got {tuple(diags.shape)}")
    if len(offsets) > _MAX_DIAGS:
        raise ValueError(f"at most {_MAX_DIAGS} diagonals, got "
                         f"{len(offsets)}")


def _launch(wrapper, diags, offsets, x, batched, plan=None):
    """Launch the kernel of ``wrapper`` on CUDA tensors (raises for any
    other device, a non-contiguous operand or a shape the kernel does not
    take) under the shape's cached plan, or under ``plan`` (from
    :func:`dia_plan`) where given; returns the new output tensor."""
    if not (diags.is_cuda and x.is_cuda):
        raise ValueError(f"{wrapper.__name__}: the kernel takes CUDA "
                         f"tensors, got {diags.device} and {x.device}")
    for name, t in (("diags", diags), ("x", x)):
        if not t.is_contiguous():
            raise ValueError(f"{wrapper.__name__}: {name} must be "
                             "contiguous")
    if batched and x.shape[0] > 65535:
        raise ValueError(f"{wrapper.__name__}: at most 65535 operands, got "
                         f"{x.shape[0]}")
    g = x.shape[0] if batched else 1
    n, m = x.shape[-2], x.shape[-1]
    index = x.device.index
    if plan is None:
        plan, offs, arr = _cached_launch(offsets, n, m, g, x.dtype,
                                         _sm_count(index))
    else:
        offs, arr = _offsets_array(offsets), _plan_array(plan)
    if arr is not None and x.data_ptr() % 16:
        x = x.clone()    # the ring body copies 16-byte pieces
    y = torch.empty_like(x)
    lib = _library()
    args = [diags.data_ptr(), offs, len(offsets), x.data_ptr(),
            y.data_ptr(), n, m] + [g] * batched + [arr]
    if index == torch.cuda.current_device():
        err = getattr(lib, wrapper.__name__)(
            *args, torch.cuda.current_stream(index).cuda_stream)
    else:
        with torch.cuda.device(index):
            err = getattr(lib, wrapper.__name__)(
                *args, torch.cuda.current_stream(index).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{wrapper.__name__} launch failed: CUDA error "
                           f"{err} ({lib.dia_error_string(err).decode()})")
    wrapper.launches += 1
    wrapper.body_launches[plan["body"]] += 1
    return y


def _matvec(wrapper, dtype, batched, diags, offsets, x):
    offsets = tuple(int(d) for d in offsets)
    _check(diags, offsets, x, dtype, batched)
    if x.is_cuda:
        return _launch(wrapper, diags, offsets, x, batched)
    if x.device.type != "cpu":
        raise ValueError(f"unsupported device {x.device}")
    return dia_matvec_plain(diags, offsets, x)


def dia_matvec_f32(diags, offsets, x):
    """y = A x for a row-major (N, M) f32 operand."""
    return _matvec(dia_matvec_f32, torch.float32, False, diags, offsets, x)


def dia_matvec_f64(diags, offsets, x):
    """y = A x for a row-major (N, M) fp64 operand."""
    return _matvec(dia_matvec_f64, torch.float64, False, diags, offsets, x)


def dia_matvec_batched_f32(diags, offsets, x):
    """y[b] = A x[b] for (g, N, M) f32 operands sharing the diagonals."""
    return _matvec(dia_matvec_batched_f32, torch.float32, True, diags,
                   offsets, x)


def dia_matvec_batched_f64(diags, offsets, x):
    """y[b] = A x[b] for (g, N, M) fp64 operands sharing the diagonals."""
    return _matvec(dia_matvec_batched_f64, torch.float64, True, diags,
                   offsets, x)


_WRAPPERS = (dia_matvec_f32, dia_matvec_f64, dia_matvec_batched_f32,
             dia_matvec_batched_f64)


def launch_counts() -> dict:
    return {w.__name__: w.launches for w in _WRAPPERS}


def body_counts() -> dict:
    """Each entry's launches by body ("ring", "flat")."""
    return {w.__name__: dict(w.body_launches) for w in _WRAPPERS}


def reset_launch_counts() -> None:
    for w in _WRAPPERS:
        w.launches = 0
        w.body_launches = {"ring": 0, "flat": 0}


reset_launch_counts()


def _real_entry(x, batched):
    if x.dtype == torch.float32:
        return dia_matvec_batched_f32 if batched else dia_matvec_f32
    if x.dtype == torch.float64:
        return dia_matvec_batched_f64 if batched else dia_matvec_f64
    raise TypeError(f"the DIA matvec takes float32 or float64, got {x.dtype}")


def dia_matvec(diags: torch.Tensor, offsets, x: torch.Tensor
               ) -> torch.Tensor:
    """y = A x for a real (N, M) or (N,) operand of the diagonals' dtype
    (the f32 or the fp64 entry; a strided operand is copied first)."""
    if x.dim() == 1:
        return dia_matvec(diags, offsets, x[:, None])[:, 0]
    return _real_entry(x, False)(diags.contiguous(), offsets, x.contiguous())


def dia_matvec_batched(diags: torch.Tensor, offsets, x: torch.Tensor
                       ) -> torch.Tensor:
    """y[b] = A x[b] for real (g, N, M) operands of the diagonals' dtype
    (a strided operand is copied first)."""
    return _real_entry(x, True)(diags.contiguous(), offsets, x.contiguous())


def dia_matvec_any(diags: torch.Tensor, offsets, x: torch.Tensor
                   ) -> torch.Tensor:
    """DIA matvec for any real/complex combination, on (N, M) or (g, N, M)
    operands (the batched entry for the latter).

    Real diagonals times a complex x: one launch on the real view of x,
    (..., N, K) complex -> (..., N, 2K) real. Complex diagonals: the full
    complex product from four real ones (as the JAX package decomposes
    it). A real x with complex diagonals: two."""
    batched = x.dim() == 3

    def mv(d, v):
        return (dia_matvec_batched if batched else dia_matvec)(d, offsets, v)

    a_c, x_c = diags.is_complex(), x.is_complex()
    if not a_c and not x_c:
        return mv(diags, x)
    if not a_c:
        xr = torch.view_as_real(x.contiguous())
        y = mv(diags, xr.reshape(*x.shape[:-1], 2 * x.shape[-1]))
        return torch.view_as_complex(y.reshape(*x.shape, 2))
    dr, di = diags.real.contiguous(), diags.imag.contiguous()
    if not x_c:
        return torch.complex(mv(dr, x), mv(di, x))
    xr, xi = x.real.contiguous(), x.imag.contiguous()
    return torch.complex(mv(dr, xr) - mv(di, xi), mv(dr, xi) + mv(di, xr))
