"""The seeded initial subspace drawn on the card, bit for bit numpy's draw.

``core/tools.seeded_subspace`` draws ``np.random.default_rng(key)
.standard_normal((N, M0))`` on the host and scales each column to unit
norm; the precision ladder of ``solvers/sparse._sparse_cheb_interval``
starts from that subspace's float32 bits, widened to float64. At N =
1,048,576 and M0 = 72 the host draw and its copies take seconds, during
which the card waits. :func:`seeded_subspace_f32_bits` computes the same
bits on a card (``csrc/seeded_draw.cu``), straight into the (N, M0)
float64 buffer the solve keeps: no (N, M0) array on the host, no copy to
the card, a few MB of scratch. It replaces no TPU kernel: the JAX package
draws on the host.

**The stream.** numpy's PCG64: a 128-bit LCG, s <- s * MULT + inc, each
output the XSL-RR of the new state. Position p of the stream is its
(p + 1)-th output; the card reaches any position by the LCG's jump-ahead
(:func:`advance`) from ``np.random.PCG64(key).state``.

**A normal** is numpy's ``random_standard_normal``: a 256-strip ziggurat
(tables in ``csrc/npy_ziggurat.h``, read out of numpy by
``scripts/gen_ziggurat_tables.py``). 98.5% of normals take one position;
a wedge test takes another, and may reject and start over; the tail
beyond R takes pairs of uniforms until one pair is accepted. So where the
k-th normal starts is not known in advance, and the card finds it in three
passes with no wait on the host:

1. *chunk maps*: the stream cut into chunks of :data:`CHUNK` positions.
   For each chunk and each entry offset e < :data:`ENTRIES`: parsed from
   position c * CHUNK + e, the normals that start in the chunk, and the
   exit, the offset into the next chunk at which the next normal starts.
2. *the walk* (one block): the maps composed from entry 0 of chunk 0. In
   groups of :data:`GROUP` chunks, each group's map for each entry; then
   across the groups in order; then inside each group from its true entry,
   which gives each chunk's true entry and the index of its first normal.
   An entry at or past ENTRIES (a normal that overhangs a chunk's end that
   far, which takes rejections in a row; tests force it with small maps)
   is parsed from the stream there and then.
3. *emit*: each chunk parsed again from its true entry, normal k written
   to element k of the row-major (N, M0) buffer. The stream is provisioned
   1/32 longer than the normals need (they take ~2.2% more positions);
   the last chunk parses on until all N * M0 are written, so a stream too
   short still ends in the right bits.

Then each column's norm in numpy's order: ``np.linalg.norm(w, axis=0)``
reduces a C-contiguous (N, M0) array one row at a time for M0 >= 2 (a
sequential chain a column), and for M0 = 1 sums the contiguous column
pairwise in blocks of ``np.getbufsize()`` elements. Each element is then
divided by its column's norm, rounded to float32 and widened, in place.

**Numerics.** Every multiply and add numpy does separately is separate on
the card. The tail takes glibc's ``log1p`` and the wedge test glibc's
``exp``; the card carries both as glibc's x86-64 FMA builds compute them
(the targets glibc's libm picks on a CPU with FMA), each fused
multiply-add where that build fuses one and no other: so the card decides
every draw as numpy does on such a host, with no margin and no wait.
:func:`exp_plain` and :func:`log1p_plain` are the same operations on the
host, held against ``math.exp`` and ``math.log1p`` (the libm numpy calls)
by the tests. Once per process and card, :func:`libm_matches` holds the
card's two functions against the host's libm; where they differ (another
libm, or a CPU without FMA), the card still draws, but its subspace
follows glibc's x86-64 FMA libm, not this host's numpy: a RuntimeWarning
says so, and the ``q0`` span's ``libm`` reads ``differs``.

The card draw runs on a CUDA device only. :func:`subspace_plain` is its
plain version: the same three passes, walk and fix-ups on the host over
numpy's own stream (slow; the tests take it at small shapes and small
chunks).
"""
from __future__ import annotations

import ctypes
import functools
import math
import re
import struct
import time
import warnings
from fractions import Fraction
from pathlib import Path

import numpy as np
import torch

from ..utils import trace as _trace

__all__ = ["CHUNK", "ENTRIES", "GROUP", "stream_key", "stream_start",
           "advance", "chunk_count", "ziggurat", "exp_constants",
           "exp_plain", "log1p_plain", "normal_plain", "draw_plain",
           "norms_plain", "subspace_plain", "seeded_subspace_f32_bits",
           "seeded_draw_f64", "libm_matches", "launch_counts",
           "reset_launch_counts"]

CHUNK = 1024      # stream positions a chunk
ENTRIES = 8       # entry offsets a chunk's map holds
GROUP = 256       # chunks a group of the walk
_MULT = 0x2360ed051fc65da44385df649fccf645
_MASK = (1 << 128) - 1
_HEADER = Path(__file__).resolve().parent / "csrc" / "npy_ziggurat.h"
_EXP_HEADER = _HEADER.with_name("glibc_exp.h")
# the card's log1p and exp are held against the host's on this many
# uniforms of a stream, as the tail and the wedge test use them (and the
# edges of their branches)
_PROBES = 1 << 16
_PROBE_KEY = 0x5EED


def stream_key(N: int, M0: int) -> int:
    """``core/tools.seeded_subspace``'s key of a real draw."""
    return (N * 1000003 + M0 * 101) % (2 ** 31 - 1)


def stream_start(N: int, M0: int) -> tuple:
    """(state, inc) of numpy's PCG64 for the draw of (N, M0)."""
    st = np.random.PCG64(stream_key(N, M0)).state["state"]
    return int(st["state"]), int(st["inc"])


def advance(state: int, inc: int, delta: int) -> int:
    """The LCG's state ``delta`` steps on, by the kernels' jump-ahead."""
    acc_mult, acc_plus, cur_mult, cur_plus = 1, 0, _MULT, inc
    while delta:
        if delta & 1:
            acc_mult = acc_mult * cur_mult & _MASK
            acc_plus = (acc_plus * cur_mult + cur_plus) & _MASK
        cur_plus = (cur_mult + 1) * cur_plus & _MASK
        cur_mult = cur_mult * cur_mult & _MASK
        delta >>= 1
    return (acc_mult * state + acc_plus) & _MASK


def chunk_count(n: int, chunk: int = CHUNK) -> int:
    """The chunks of the stream provisioned for n normals."""
    return -(-(n + n // 32 + 2 * chunk) // chunk)


@functools.cache
def ziggurat() -> tuple:
    """(ki, wi, fi, R, 1/R) as the committed header holds them."""
    text = _HEADER.read_text()

    def table(name):
        body = re.search(name + r"\[256\] = \{(.*?)\};", text, re.S).group(1)
        return [s.strip() for s in body.split(",") if s.strip()]

    def const(name):
        return float(re.search(r"#define " + name + r" (\S+)", text).group(1))
    return ([int(v.rstrip("ULL"), 16) for v in table("npy_zig_ki")],
            [float.fromhex(v) for v in table("npy_zig_wi")],
            [float.fromhex(v) for v in table("npy_zig_fi")],
            const("NPY_ZIGGURAT_NOR_R"), const("NPY_ZIGGURAT_NOR_INV_R"))


@functools.cache
def exp_constants() -> tuple:
    """({name: value} of glibc's exp constants, its 256-word table) as the
    committed header ``csrc/glibc_exp.h`` holds them."""
    text = _EXP_HEADER.read_text()
    consts = {m.group(1): float.fromhex(m.group(2)) for m in re.finditer(
        r"#define GLIBC_EXP_(\w+) (\S+)", text) if m.group(1) != "STORAGE"}
    body = re.search(r"glibc_exp_tab\[256\] = \{(.*?)\};", text, re.S)
    return consts, [int(v.strip().rstrip("ULL"), 16)
                    for v in body.group(1).split(",") if v.strip()]


def _fma(a: float, b: float, c: float) -> float:
    """a * b + c rounded once."""
    return float(Fraction(a) * Fraction(b) + Fraction(c))


def _bits(v: float) -> int:
    return struct.unpack("<Q", struct.pack("<d", v))[0]


def _double(b: int) -> float:
    return struct.unpack("<d", struct.pack("<Q", b % (1 << 64)))[0]


def exp_plain(x: float) -> float:
    """The card's exp on the host: glibc's x86-64 FMA build of e_exp.c for
    |x| < 512 (the wedge test's argument, -x^2 / 2 with |x| < R, lies in
    (-6.7, 0])."""
    c, tab = exp_constants()
    abstop = _bits(x) >> 52 & 0x7ff
    if abstop < 0x3c9:                        # |x| < 2^-54
        return 1.0 + x
    if abstop >= 0x408:
        raise ValueError(f"exp_plain takes |x| < 512, got {x!r}")
    kd = _fma(x, c["INVLN2N"], c["SHIFT"])
    ki = _bits(kd)
    kd -= c["SHIFT"]
    r = _fma(kd, c["NEGLN2LON"], _fma(kd, c["NEGLN2HIN"], x))
    idx = 2 * (ki & 0x7f)
    scale = _double(tab[idx + 1] + (ki << 45))
    r2 = r * r
    tmp = _fma(r2 * r2, _fma(r, c["C5"], c["C4"]),
               _fma(_fma(r, c["C3"], c["C2"]), r2, r + _double(tab[idx])))
    return _fma(scale, tmp, scale)


_LN2_HI, _LN2_LO = 6.93147180369123816490e-01, 1.90821492927058770002e-10
_LP = (6.666666666666735130e-01, 3.999999999940941908e-01,
       2.857142874366239149e-01, 2.222219843214978396e-01,
       1.818357216161805012e-01, 1.531383769920937332e-01,
       1.479819860511658591e-01)


def log1p_plain(x: float) -> float:
    """The card's log1p on the host: glibc's x86-64 FMA build of
    s_log1p.c, operation for operation as ``csrc/seeded_draw.cu`` has it."""
    hx = _bits(x) >> 32
    hx -= (hx >> 31) << 32                    # the high word, signed
    ax = hx & 0x7fffffff
    k, hu, f, c = 1, 0, 0.0, 0.0
    if hx < 0x3FDA827A:
        if ax >= 0x3ff00000:                  # x <= -1
            return -math.inf if x == -1.0 else math.nan
        if ax < 0x3e200000:                   # |x| < 2^-29
            return x if ax < 0x3c900000 else _fma(-(x * x), 0.5, x)
        if hx > 0 or hx <= 0xbfd2bec3 - (1 << 32):
            k, f, hu = 0, x, 1                # -0.2929 < x < 0.41422
    elif hx >= 0x7ff00000:
        return x + x
    if k:
        if hx < 0x43400000:
            u = 1.0 + x
            hu = _bits(u) >> 32
            k = (hu >> 20) - 1023
            c = (1.0 - (u - x) if k > 0 else x - (u - 1.0)) / u
        else:
            u, c = x, 0.0
            hu = _bits(u) >> 32
            k = (hu >> 20) - 1023
        hu &= 0x000fffff
        low = _bits(u) & 0xffffffff
        if hu < 0x6a09e:                      # normalise u
            u = _double((hu | 0x3ff00000) << 32 | low)
        else:                                 # normalise u / 2
            k += 1
            u = _double((hu | 0x3fe00000) << 32 | low)
            hu = (0x00100000 - hu) >> 2
        f = u - 1.0
    hfsq = 0.5 * f * f
    kd = float(k)
    if hu == 0:                               # |f| < 2^-20
        if f == 0.0:
            return 0.0 if k == 0 else _fma(kd, _LN2_HI, _fma(kd, _LN2_LO, c))
        R = _fma(-f, 0.66666666666666666, 1.0) * hfsq
        if k == 0:
            return f - R
        return _fma(kd, _LN2_HI, -((R - _fma(kd, _LN2_LO, c)) - f))
    s = f / (2.0 + f)
    z = s * s
    z2 = z * z
    z4 = z2 * z2
    R = _fma(z2 * z4, _fma(z, _LP[6], _LP[5]), _fma(
        z4, _fma(z, _LP[4], _LP[3]),
        _fma(z, _LP[0], z2 * _fma(z, _LP[2], _LP[1]))))
    w = s * (hfsq + R)
    if k == 0:
        return f - (hfsq - w)
    t = _fma(kd, _LN2_LO, c) + w
    return _fma(kd, _LN2_HI, -((hfsq - t) - f))


class _Stream:
    """numpy's PCG64 outputs of one key, by position, drawn as needed."""

    def __init__(self, key: int):
        self._bits = np.random.PCG64(key)
        self._out: list = []

    def __getitem__(self, p: int) -> int:
        while p >= len(self._out):
            more = max(4096, len(self._out))
            self._out.extend(self._bits.random_raw(more).tolist())
        return self._out[p]


def normal_plain(stream, p: int) -> tuple:
    """numpy's ``random_standard_normal`` from position p of ``stream``:
    (value, the position after it)."""
    ki, wi, fi, R, inv_R = ziggurat()
    while True:
        r = stream[p]
        p += 1
        idx = r & 0xff
        r >>= 8
        rabs = (r >> 1) & 0x000fffffffffffff
        x = -(rabs * wi[idx]) if r & 1 else rabs * wi[idx]
        if rabs < ki[idx]:
            return x, p
        if idx == 0:
            while True:
                xx = -inv_R * math.log1p(-((stream[p] >> 11) * 2.0 ** -53))
                yy = -math.log1p(-((stream[p + 1] >> 11) * 2.0 ** -53))
                p += 2
                if yy + yy > xx * xx:
                    return (-(R + xx) if (rabs >> 8) & 1 else R + xx), p
        u = (stream[p] >> 11) * 2.0 ** -53
        p += 1
        if (fi[idx - 1] - fi[idx]) * u + fi[idx] < math.exp(-0.5 * x * x):
            return x, p


def _parse_chunk(stream, c: int, e: int, chunk: int) -> tuple:
    """(normals that start in chunk c, exit) from position c * chunk + e."""
    p, end, count = c * chunk + e, (c + 1) * chunk, 0
    while p < end:
        p = normal_plain(stream, p)[1]
        count += 1
    return count, p - end


def draw_plain(N: int, M0: int, *, chunk: int = CHUNK,
               entries: int = ENTRIES, group: int = GROUP,
               chunks: int | None = None) -> tuple:
    """The kernels' three passes on the host: the N * M0 normals in stream
    order. ``chunks`` overrides the provisioned stream (a short one makes the last
    chunk parse on)."""
    n = N * M0
    stream = _Stream(stream_key(N, M0))
    C = chunk_count(n, chunk) if chunks is None else chunks
    maps = [[_parse_chunk(stream, c, e, chunk) for e in range(entries)]
            for c in range(C)]

    def step(c, e, count):
        if e >= chunk:                        # no normal starts in c
            return e - chunk, count
        m = maps[c][e] if e < entries else _parse_chunk(stream, c, e, chunk)
        return m[1], count + m[0]

    def walk(g, e, count):
        for c in range(g * group, min((g + 1) * group, C)):
            e, count = step(c, e, count)
        return e, count

    groups = -(-C // group)
    gmaps = [[walk(g, e, 0) for e in range(entries)] for g in range(groups)]
    gentry, gbase, e, count = [], [], 0, 0
    for g in range(groups):
        gentry.append(e)
        gbase.append(count)
        if e < entries:
            count += gmaps[g][e][1]
            e = gmaps[g][e][0]
        else:
            e, count = walk(g, e, count)
    entry, base = [0] * C, [0] * C
    for g in range(groups):
        e, count = gentry[g], gbase[g]
        for c in range(g * group, min((g + 1) * group, C)):
            entry[c], base[c] = e, count
            e, count = step(c, e, count)
    out = np.empty(n)
    for c in range(C):
        k, last = base[c], c == C - 1
        if k >= n or (not last and entry[c] >= chunk):
            continue
        p, end = c * chunk + entry[c], (c + 1) * chunk
        while k < n and (last or p < end):
            out[k], p = normal_plain(stream, p)
            k += 1
    return out


def _pairwise_squares(a) -> float:
    """numpy's ``pairwise_sum`` (loops_utils.h) over the squares of a."""
    n = len(a)
    if n < 8:
        res = 0.0
        for v in a:
            res += v * v
        return res
    if n <= 128:
        r = [v * v for v in a[:8]]
        i = 8
        while i < n - n % 8:
            for j in range(8):
                r[j] += a[i + j] * a[i + j]
            i += 8
        res = ((r[0] + r[1]) + (r[2] + r[3])) + ((r[4] + r[5]) + (r[6] + r[7]))
        for v in a[i:]:
            res += v * v
        return res
    n2 = n // 2
    n2 -= n2 % 8
    return _pairwise_squares(a[:n2]) + _pairwise_squares(a[n2:])


def norms_plain(w: np.ndarray) -> np.ndarray:
    """``np.linalg.norm(w, axis=0)`` in numpy's order, as the kernels sum:
    a chain down each column (M0 >= 2), or pairwise in blocks of numpy's
    buffer size (M0 = 1)."""
    N, M0 = w.shape
    if M0 >= 2:
        acc = np.zeros(M0)
        for r in range(N):
            acc = acc + w[r] * w[r]
        return np.sqrt(acc)
    block, col, acc = np.getbufsize(), w[:, 0].tolist(), 0.0
    for b in range(0, N, block):
        acc = acc + _pairwise_squares(col[b:b + block])
    return np.sqrt(np.array([acc]))


def subspace_plain(N: int, M0: int, **kw) -> np.ndarray:
    """The plain version of the draw: the subspace's float32 bits widened
    to an (N, M0) float64 array; ``kw`` as :func:`draw_plain`."""
    w = draw_plain(N, M0, **kw).reshape(N, M0)
    return (w / norms_plain(w)).astype(np.float32).astype(np.float64)


# ---------------------------------------------------------------- the card

@functools.cache
def _library():
    from .cuda_build import load
    lib = load("seeded_draw")
    lib.seeded_draw_f64.argtypes = ([ctypes.c_uint64] * 4
                                    + [ctypes.c_int64] * 7
                                    + [ctypes.c_void_p] * 11)
    lib.seeded_draw_f64.restype = ctypes.c_int
    lib.seeded_libm_probe_f64.argtypes = ([ctypes.c_uint64] * 4
                                          + [ctypes.c_int64]
                                          + [ctypes.c_void_p] * 3)
    lib.seeded_libm_probe_f64.restype = ctypes.c_int
    lib.seeded_libm_probe_edges.restype = ctypes.c_int
    lib.seeded_draw_error_string.argtypes = [ctypes.c_int]
    lib.seeded_draw_error_string.restype = ctypes.c_char_p
    return lib


def _check(lib, name, err):
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err} "
                           f"({lib.seeded_draw_error_string(err).decode()})")


def _halves(v: int) -> tuple:
    return v & 0xffffffffffffffff, v >> 64


@functools.cache
def libm_matches(index: int) -> bool:
    """Whether card ``index``'s log1p and exp give the host libm's bits
    (``math.log1p``, ``math.exp``: the functions numpy's draw calls) on
    65,536 stream uniforms, as the tail and the wedge test take them, and
    on the edges of their branches, all made on the card. Asked once per
    process and card; where they differ, a RuntimeWarning says what that
    costs (the card draws all the same)."""
    lib = _library()
    bits = np.random.PCG64(_PROBE_KEY).state["state"]
    n = _PROBES + lib.seeded_libm_probe_edges()
    with torch.cuda.device(index):
        xy = torch.empty((4, n), dtype=torch.float64, device="cuda")
        stream = torch.cuda.current_stream().cuda_stream
        _check(lib, "seeded_libm_probe_f64", lib.seeded_libm_probe_f64(
            *_halves(bits["state"]), *_halves(bits["inc"]), _PROBES,
            xy.data_ptr(), xy[2].data_ptr(), stream))
        libm_matches.launches += 1
        lx, ly, ex, ey = xy.cpu().numpy()
    u = np.random.Generator(np.random.PCG64(_PROBE_KEY)).random(_PROBES)
    want_l = np.array([math.log1p(v) for v in lx.tolist()])
    want_e = np.array([math.exp(v) for v in ex.tolist()])
    same = bool(np.array_equal(lx[:_PROBES], -u)
                and np.array_equal(ly.view(np.uint64), want_l.view(np.uint64))
                and np.array_equal(ey.view(np.uint64),
                                   want_e.view(np.uint64)))
    if not same:
        warnings.warn(
            f"the host's log1p / exp differ from glibc's x86-64 FMA build "
            f"that card {index} carries: the seeded subspace drawn there "
            f"may differ from this host's numpy draw in a few tail and "
            f"wedge entries, and the solves from the host's", RuntimeWarning,
            stacklevel=3)
    return same


def seeded_draw_f64(out: torch.Tensor, *, chunk: int = CHUNK,
                    entries: int = ENTRIES,
                    group: int = GROUP) -> torch.Tensor:
    """Launch the draw of ``out``'s shape (N, M0) into ``out``, a contiguous
    float64 CUDA tensor: the seeded subspace's float32 bits, widened; no
    wait. Returns ``out``. ``chunk``, ``entries``, ``group``: the parse's
    cut, which changes no bit of the result (tests cut small to make the
    walk's fix-ups common on the card)."""
    t_on = _trace.ON and time.perf_counter_ns()
    if out.dtype != torch.float64 or out.dim() != 2:
        raise TypeError(f"out must be an (N, M0) float64 tensor, got "
                        f"{out.dtype} {tuple(out.shape)}")
    if not out.is_cuda:
        raise ValueError(f"out must be on a CUDA device, got {out.device}")
    if not out.is_contiguous():
        raise ValueError("out must be contiguous")
    N, M0 = out.shape
    n = N * M0
    if not 0 < entries <= chunk or group <= 0:
        raise ValueError(f"need 0 < entries <= chunk and group > 0, got "
                         f"{entries}, {chunk}, {group}")
    C, block = chunk_count(n, chunk), np.getbufsize()
    groups = -(-C // group)
    sizes = (C * entries, groups * entries, groups * entries, groups, groups,
             C, C, M0, -(-N // block) if M0 == 1 else 1)
    lib = _library()
    with torch.cuda.device(out.device):
        work = torch.empty(sum(sizes), dtype=torch.int64, device=out.device)
        ptrs, at = [], work.data_ptr()
        for size in sizes:
            ptrs.append(at)
            at += 8 * size
        state, inc = stream_start(N, M0)
        stream = torch.cuda.current_stream().cuda_stream
        _check(lib, "seeded_draw_f64", lib.seeded_draw_f64(
            *_halves(state), *_halves(inc), N, M0, chunk, entries, C, group,
            block, *ptrs, out.data_ptr(), stream))
    seeded_draw_f64.launches += 5 if M0 >= 2 else 6
    if t_on:
        _trace.launch_done(t_on)
    return out


def seeded_subspace_f32_bits(N: int, M0: int, device) -> torch.Tensor:
    """The seeded (N, M0) float64 subspace of ``core/tools.seeded_subspace``
    rounded to float32 and widened, drawn on the CUDA device ``device`` as
    a float64 tensor there, with no wait. The enclosing ``q0`` span's
    ``libm`` says whether the host's libm gives the card's bits."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"the seeded draw runs on a CUDA device, got "
                         f"{device}")
    index = torch.cuda.current_device() if device.index is None \
        else device.index
    _trace.note("q0", libm="same" if libm_matches(index) else "differs")
    return seeded_draw_f64(torch.empty((N, M0), dtype=torch.float64,
                                       device=device))


_WRAPPERS = (seeded_draw_f64, libm_matches)


def launch_counts() -> dict:
    return {w.__name__: w.launches for w in _WRAPPERS}


def reset_launch_counts() -> None:
    for w in _WRAPPERS:
        w.launches = 0


reset_launch_counts()
