"""PyTorch port: a CPU rehearsal of the streamed multi-step kernel's schedule.

``csrc/cheb_stream4.cu`` (``cheb_step2_f32`` / ``_f64`` and
``cheb_step4_f32`` / ``_f64``: S = 2 or 4 steps per pass) runs only on the
card. Its schedule is emulated here in numpy, block by block, iteration by
iteration, exactly as the CUDA source walks it: a block owns a strip of
rows for a group of columns; level s (T_{s+2}) computes chunk c0 - s L at
the iteration whose level-0 chunk is c0, over the range [lo[s], hi[s]) of
its strip (the own chunks and (S-1-s) H halo chunks each side, clipped to
the matrix); T1 .. T_S live in rings of the lengths ``_ring_lengths``
gives (2L+1, 3L+1, 2L+1, 2L for four steps; 2L+1, 2L for two), a chunk c
in slot (c - base) mod length; T1 is preloaded for the first iteration and
stored one chunk ahead at the end of each iteration (zeros past the chunks
level 0 needs); T0, acc and the diagonals come from device memory; loads
are masked to the matrix's rows and terms whose neighbour row lies outside
it are dropped. Every ring read checks that its slot holds the chunk the
row needs and was not written in the same iteration, and every ring write
that its slot was not read in the same iteration (the kernel has one
barrier per iteration, so either would be a race between its threads).
The result is held against ``cheb_step4_plain`` / ``cheb_step2_plain``
(fp64 at 1e-12 and f32 at 1e-5 relative to max|acc|) at small shapes
chosen to reach every edge of the schedule: N not a multiple of the chunk
or of the strip, |offset| = nx, halos over one and over several chunks,
1, 3, 5, 7, 9 and 11 diagonals, an offset outside the matrix, and M = 1,
3, 5, 7, 11, 40 and 72 against column groups that do not divide it; under
f32 block shapes (up to 4 columns) and fp64 ones (1 or 2). The plans'
fields are checked too, and that every halo the retired tiled bodies took
still gets a four-step (four-step body) or a two-step (two-step body)
route. The kernel itself is held to the same plain versions on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``). About 11 s in one
process.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from feastkit_tpu_torch.ops import cheb_kernels as ck  # noqa: E402

_NEVER = -(2**62)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # The suite runs files in parallel worker processes on a few cores;
    # torch's default intra-op pool (one spinning thread per core) then
    # starves its neighbours. The port's CPU tensors here are small.
    # numpy's and scipy's OpenBLAS pools (a spinning thread per core
    # each) would too, and worse: beside busy cores a small SVD runs
    # hundreds of times slower on them than on one thread
    from threadpoolctl import threadpool_limits
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(limits=1, user_api="blas"):
        yield
    torch.set_num_threads(n)


class _Ring:
    """One level's ring in one block: values (columns, length * R), and per
    slot the chunk it holds, the iteration that wrote it and the last
    iteration that read it."""

    def __init__(self, cols, length, R):
        self.v = np.full((cols, length * R), np.nan)
        self.R = R
        self.chunk = np.full(length, _NEVER)
        self.wrote = np.full(length, _NEVER)
        self.read_at = np.full(length, _NEVER)

    def read(self, idx, chunks, mask, it):
        slots = idx[mask] // self.R
        assert np.all(self.chunk[slots] == chunks[mask]), "stale ring slot"
        assert np.all(self.wrote[slots] != it), "slot written this iteration"
        self.read_at[slots] = it
        return self.v[:, idx]

    def write(self, c, idx, values, it):
        slot = idx[0] // self.R
        assert np.all(idx // self.R == slot)
        assert self.read_at[slot] != it, "slot read this iteration"
        self.chunk[slot], self.wrote[slot] = c, it
        self.v[:, idx] = values


def _emulate(diags, offsets, t0, t1, acc, sc, sh, cs, plan):
    """(out0, out1, acc) of one pass of the streamed kernel (``plan``'s
    steps, 2 or 4), walked as the CUDA source walks it; numpy (M, N)
    planes of one dtype."""
    m, n = t0.shape
    dt = t0.dtype.type
    sc, sh = dt(sc), dt(sh)
    cs = [dt(c) for c in cs]
    S = plan["steps"]
    R, L, tile, C = plan["chunk"], plan["lag"], plan["tile"], plan["cols"]
    H = L - 1
    lens = ck._ring_lengths(S, L)
    offs = [o if abs(o) < n else (n if o > 0 else -n) for o in offsets]
    acc_in = acc.copy()
    out0 = np.full_like(t0, np.nan)
    out1 = np.full_like(t0, np.nan)
    acc = np.full_like(t0, np.nan)
    p = np.arange(R)

    def load(plane, cols, rows):
        live = (rows >= 0) & (rows < n)
        v = np.zeros((len(cols), R), t0.dtype)
        v[:, live] = plane[np.ix_(cols, rows[live])]
        return v

    # one block per (strip, column group)
    for strip in range(-(-n // tile)):
        for group in range(-(-m // C)):
            s0 = strip * tile
            k_own = -(-(min(s0 + tile, n) - s0) // R)
            k_max = -(-(n - s0) // R)
            lo = [max(-(S - 1 - s) * H, -(s0 // R)) for s in range(S)]
            hi = [min(k_own + (S - 1 - s) * H, k_max) for s in range(S)]
            base = lo[0] - H
            cols = np.arange(group * C, min(group * C + C, m))
            rings = [_Ring(len(cols), ln, R) for ln in lens]

            def slot_rows(r, c):
                return ((c - base) % lens[r]) * R + p

            def t1_chunk(c):
                # zeros past the chunks level 0 needs
                if c < hi[0] + H:
                    return load(t1, cols, s0 + c * R + p)
                return np.zeros((len(cols), R), t0.dtype)

            for c in range(lo[0] - H, lo[0] + H + 1):
                rings[0].write(c, slot_rows(0, c), t1_chunk(c), lo[0] - 1)
            for c0 in range(lo[0], hi[S - 1] + (S - 1) * L):
                for s in range(S):
                    c = c0 - s * L
                    if c < lo[s] or c >= hi[s]:
                        continue
                    rows = s0 + c * R + p
                    live = rows < n
                    src = rings[s]
                    pos = slot_rows(s, c)
                    span = lens[s] * R
                    everyone = np.ones(R, bool)
                    own_chunk = np.full(R, c)
                    center = src.read(pos, own_chunk, everyone, c0)
                    y = np.zeros((len(cols), R), t0.dtype)
                    for k, off in enumerate(offs):
                        ok = (rows + off >= 0) & (rows + off < n)
                        q = pos + off
                        q = np.where(q < 0, q + span, q)
                        q = np.where(q >= span, q - span, q)
                        idx = np.where(ok, q, pos)
                        x = src.read(idx, (rows + off - s0) // R, ok, c0)
                        d = np.where(live, diags[k, np.minimum(rows, n - 1)],
                                     dt(0))
                        y = y + np.where(ok, d * x, dt(0))
                    prev = (load(t0, cols, rows) if s == 0 else
                            rings[s - 1].read(slot_rows(s - 1, c), own_chunk,
                                              everyone, c0))
                    v = dt(2) * (sc * y - sh * center) - prev
                    if s < S - 1:
                        rings[s + 1].write(c, slot_rows(s + 1, c), v, c0)
                    if s == S - 2 and 0 <= c < k_own:
                        out0[np.ix_(cols, rows[live])] = v[:, live]
                    if s == S - 1:
                        a = load(acc_in, cols, rows)
                        if S == 4:
                            t2 = rings[1].read(slot_rows(1, c), own_chunk,
                                               everyone, c0)
                            a = (((a + cs[0] * t2) + cs[1] * prev)
                                 + cs[2] * center) + cs[3] * v
                        else:
                            # T2 is the last level's source, read above
                            a = (a + cs[0] * center) + cs[1] * v
                        acc[np.ix_(cols, rows[live])] = a[:, live]
                        out1[np.ix_(cols, rows[live])] = v[:, live]
                rings[0].write(c0 + L, slot_rows(0, c0 + L),
                               t1_chunk(c0 + L), c0)
    return out0, out1, acc


def _lap2d(nx, ny, seed=0):
    rng = np.random.default_rng(seed)
    n = nx * ny
    dia = np.zeros((5, n))
    dia[2] = 4.0 + rng.random(n)
    dia[1, 1:] = -rng.random(n - 1)
    dia[1, ::nx] = 0.0
    dia[3, :-1] = -rng.random(n - 1)
    dia[3, nx - 1::nx] = 0.0
    dia[0, nx:] = -rng.random(n - nx)
    dia[4, :-nx] = -rng.random(n - nx)
    return dia, (-nx, -1, 0, 1, nx), n


def _banded(offs, n, seed=3):
    rng = np.random.default_rng(seed)
    dia = np.zeros((len(offs), n))
    for k, d in enumerate(offs):
        if abs(d) < n:
            dia[k, max(0, -d):n - max(0, d)] = rng.random(n - abs(d)) - 0.5
    return dia, tuple(offs), n


OPERATORS = {
    # |offset| = nx = 37: N = 1073 rows in 5 chunks of 256
    "lap2d_37x29": lambda: _lap2d(37, 29),
    # nx = 300 and 600 over 256-row chunks: halos over two and three chunks
    "lap2d_300x9": lambda: _lap2d(300, 9),
    "lap2d_600x5": lambda: _lap2d(600, 5),
    "lap2d_33x33": lambda: _lap2d(33, 33),
    "3diags": lambda: _banded((-1, 0, 1), 1073),
    "9diags": lambda: _banded((-34, -33, -32, -1, 0, 1, 32, 33, 34), 1089),
    "9diags_wide": lambda: _banded(
        (-514, -513, -512, -1, 0, 1, 512, 513, 514), 3072),
    "11diags": lambda: _banded((-40, -33, -7, -2, -1, 0, 1, 2, 7, 33, 40),
                               1089),
    # 2 x 60 > N: every level's range is clipped at both ends
    "wide_small": lambda: _banded((-60, -1, 0, 1, 60), 100),
    # a diagonal wholly outside the matrix (its terms are all skipped)
    "outside": lambda: _banded((-1, 0, 1, 150), 130),
    # a 7-point 3D stencil on a 20 x 17 x 5 grid: |offset| = nx ny = 340,
    # a halo over two chunks
    "lap3d_20x17x5": lambda: _banded((-340, -20, -1, 0, 1, 20, 340), 1700),
}

# (operator, M, plan: None for the solver's own, else the columns per block
#  and the strips)
CASES = [
    ("lap2d_37x29", 11, (4, 3)),
    ("lap2d_300x9", 11, (4, 3)),
    ("9diags", 7, (2, 4)),
    ("lap2d_37x29", 7, (2, 2)),
    ("lap2d_300x9", 7, (4, 2)),
    ("lap2d_600x5", 1, (1, 3)),
    ("lap2d_600x5", 11, (4, 1)),
    ("lap2d_33x33", 40, None),
    ("3diags", 7, (2, 4)),
    ("9diags", 1, (1, 2)),
    ("9diags", 11, (4, 3)),
    ("9diags_wide", 7, (4, 2)),
    ("11diags", 11, (4, 4)),
    ("11diags", 7, None),
    ("wide_small", 7, (2, 2)),
    ("outside", 5, (4, 3)),
    ("lap3d_20x17x5", 7, (4, 2)),
    ("lap3d_20x17x5", 11, None),
]


def _halo(offs, n):
    return max((abs(d) for d in offs if abs(d) < n), default=0)


def _plan(offs, n, M, shape, dtype=np.float32):
    """The solver's plan (shape None) or the given block shape, for a
    carry of ``dtype``."""
    itemsize = np.dtype(dtype).itemsize
    if shape is None:
        return ck.multistep_plan(offs, n, M, _TORCH[itemsize], 4)
    cols, strips = shape
    return ck._stream_shape(_halo(offs, n), n, M, cols, strips,
                            itemsize=itemsize)


_TORCH = {4: torch.float32, 8: torch.float64}


def _carry(n, M, dtype, seed=1):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((M, n)).astype(dtype) for _ in range(3)]


def _plain(dia, offs, carry, sc, sh, cs, dtype):
    tdtype = torch.float64 if dtype == np.float64 else torch.float32
    t0, t1, acc = (torch.as_tensor(x.copy()) for x in carry)
    out0, out1 = torch.empty_like(t0), torch.empty_like(t0)
    plain = ck.cheb_step4_plain if len(cs) == 4 else ck.cheb_step2_plain
    plain(torch.as_tensor(dia, dtype=tdtype), offs, t0, t1, acc, out0, out1,
          sc, sh, cs)
    return out0.numpy(), out1.numpy(), acc.numpy()


def _check_schedule(op, M, plan, dtype, tol):
    dia, offs, n = OPERATORS[op]()
    assert plan is not None
    carry = _carry(n, M, dtype)
    sc, sh = dtype(0.37), dtype(0.61)
    cs = [dtype(c) for c in
          np.random.default_rng(2).standard_normal(plan["steps"]) * 0.1]
    got = _emulate(dia.astype(dtype), offs, *carry, sc, sh, cs, plan)
    want = _plain(dia.astype(dtype), offs, carry, float(sc), float(sh),
                  [float(c) for c in cs], dtype)
    scale = float(np.abs(want[2]).max())
    for g, w in zip(got, want):
        assert not np.isnan(g).any()
        assert float(np.abs(g - w).max()) / scale <= tol


def _ids(cases):
    return [f"{o}-M{m}-{s if s else 'plan'}" for o, m, s in cases]


@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-12),
                                       (np.float32, 1e-5)])
@pytest.mark.parametrize("op,M,shape", CASES, ids=_ids(CASES))
def test_schedule_matches_plain(op, M, shape, dtype, tol):
    # f32 block shapes (up to 4 columns), the arithmetic in both types
    dia, offs, n = OPERATORS[op]()
    _check_schedule(op, M, _plan(offs, n, M, shape), dtype, tol)


# fp64 plans: 1 or 2 columns per block
FP64_CASES = [
    ("lap2d_37x29", 11, (2, 3)),
    ("9diags", 7, (2, 3)),
    ("lap3d_20x17x5", 9, (1, 2)),
    ("lap2d_300x9", 7, (2, 2)),
    ("lap2d_600x5", 1, (1, 3)),
    ("lap2d_33x33", 40, None),
    ("9diags", 11, (2, 4)),
    ("9diags_wide", 7, (1, 2)),
    ("11diags", 7, None),
    ("wide_small", 7, (2, 2)),
    ("outside", 5, (2, 3)),
    ("lap3d_20x17x5", 11, None),
]


@pytest.mark.parametrize("op,M,shape", FP64_CASES, ids=_ids(FP64_CASES))
def test_schedule_under_fp64_plans(op, M, shape):
    dia, offs, n = OPERATORS[op]()
    plan = _plan(offs, n, M, shape, np.float64)
    assert plan["cols"] <= 2
    _check_schedule(op, M, plan, np.float64, 1e-12)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("offs,N,M", [
    ((-1024, -1, 0, 1, 1024), 1024 ** 2, 72),
    ((-2048, -1, 0, 1, 2048), 2048 ** 2, 72),
    ((-257, -256, -255, -1, 0, 1, 255, 256, 257), 65536, 72),
    ((-37, -1, 0, 1, 37), 1073, 11),
    ((-60, -1, 0, 1, 60), 100, 1),
    ((-1, 0, 1), 1073, 7)])
def test_stream_plan_fields(offs, N, M, dtype):
    plan = ck.multistep_plan(offs, N, M, dtype, 4)
    size = ck._itemsize(dtype)
    if dtype == torch.float64 and N == 2048 ** 2:
        # two fp64 columns' rings do not fit a 2048-row halo: one column
        # per block, alone on its multiprocessor
        assert (plan["cols"], plan["blocks_per_sm"]) == (1, 1)
    R, L, C = plan["chunk"], plan["lag"], plan["cols"]
    assert C in ((1, 2, 4) if size == 4 else (1, 2)) and R == 256
    # a multiprocessor holds 4 / C f32 or 2 / C fp64 blocks at most
    assert 1 <= plan["blocks_per_sm"] <= max(1, 16 // (C * size))
    assert plan["groups"] * C >= M > (plan["groups"] - 1) * C
    assert (L - 1) * R >= plan["halo"] > (L - 2) * R
    # the rings: 9 L + 3 chunks per column, within the block's budget
    assert plan["shared_bytes"] == C * (9 * L + 3) * R * size
    assert plan["shared_bytes"] <= ck.SHARED_BYTES_PER_BLOCK
    assert plan["tile"] % R == 0 and plan["depth"] == 0
    assert plan["tiles"] * plan["tile"] >= N > (plan["tiles"] - 1) * plan[
        "tile"]
    reckoned = ck.reckoned_traffic(plan, offs, N, size)
    assert reckoned["recompute"] >= 1.0
    assert reckoned["l2_bytes_per_element"] > 6 * size


def test_stream_plan_at_the_main_shapes():
    # f32: 18 groups of 4 columns x 7 strips, one block per multiprocessor
    # of the 132, one wave; a pass requests ~45 B per element from L2 (24 B
    # of planes)
    offs, N = (-1024, -1, 0, 1, 1024), 1024 ** 2
    plan = ck.multistep_plan(offs, N, 72, torch.float32, 4)
    assert (plan["chunk"], plan["cols"], plan["lag"]) == (256, 4, 5)
    assert plan["groups"] * plan["tiles"] == 126
    streamed = ck.reckoned_traffic(plan, offs, N)
    assert streamed["recompute"] < 1.02
    assert 44 < streamed["l2_bytes_per_element"] < 46
    # fp64: 36 groups of 2 columns (196,608 B of rings, one block per SM);
    # 108 blocks of one strip each would leave 24 multiprocessors idle, so
    # the rows are cut into 11 strips, 396 blocks in three waves over all
    # 132; each diagonal load serves 2 columns, not 4: ~131 B per element
    plan64 = ck.multistep_plan(offs, N, 72, torch.float64, 4)
    assert (plan64["chunk"], plan64["cols"], plan64["lag"]) == (256, 2, 5)
    assert plan64["shared_bytes"] == 196608
    assert (plan64["groups"], plan64["tiles"]) == (36, 11)
    streamed64 = ck.reckoned_traffic(plan64, offs, N, 8)
    assert streamed64["recompute"] < 1.04
    assert 130 < streamed64["l2_bytes_per_element"] < 133
    # one wave would be the 108 blocks of 3 strips, reckoned ~128.7 B
    one = ck._stream_shape(1024, N, 72, 2, itemsize=8, waves=1)
    assert one["groups"] * one["tiles"] == 108
    assert 128 < ck.reckoned_traffic(one, offs, N, 8)[
        "l2_bytes_per_element"] < 129


def test_stream_plan_at_nine_diagonals():
    # the consistent-mass B~ at P=8: halo 257, lag 3; fp64 rings of 2
    # columns take 122,880 B (4 would take 245,760); 3 strips x 36 groups
    # in one wave (more waves reckon slower: the strips are short), ~200.6
    # B per element requested from L2
    offs = (-257, -256, -255, -1, 0, 1, 255, 256, 257)
    plan = ck.multistep_plan(offs, 65536, 72, torch.float64, 4)
    assert (plan["cols"], plan["lag"], plan["shared_bytes"]) == (2, 3,
                                                                 122880)
    assert ck._stream_ring_bytes(257, 4, itemsize=8) == 245760
    assert plan["tiles"] * plan["groups"] == 3 * 36
    reckoned = ck.reckoned_traffic(plan, offs, 65536, 8)
    assert 200 < reckoned["l2_bytes_per_element"] < 201


def test_stream_plan_refuses_bad_block_shapes():
    offs = (-1, 0, 1)
    with pytest.raises(ValueError, match="cols"):
        ck._stream_shape(1, 1000, 4, 3, 1)
    with pytest.raises(ValueError, match="cols"):    # 32-byte fp64 rows
        ck._stream_shape(1, 1000, 8, 4, 1, itemsize=8)
    # a halo the rings of one column cannot hold
    assert ck._stream_plan((-6000, 0, 6000), 10**6, 4) is None
    # the cp.async variant takes four steps only
    with pytest.raises(ValueError, match="steps"):
        ck._stream_shape(1, 1000, 4, 4, 1, depth=1, steps=2)
    # the two- and four-step kernels both stream
    for dtype in (torch.float32, torch.float64):
        for steps in (2, 4):
            plan = ck.multistep_plan(offs, 1000, 4, dtype, steps)
            assert plan["chunk"] == 256 and plan["steps"] == steps
            assert plan == ck._stream_plan(
                offs, 1000, 4, itemsize=ck._itemsize(dtype), steps=steps)


@pytest.mark.parametrize("halo,cols,depth,fits", [
    (1024, 4, 1, True),      # the main shapes: one iteration in flight
    (1024, 4, 2, False),     # three stage slots do not fit beside the rings
    (257, 4, 7, True),       # nine diagonals at P=8: up to 7 in flight
    (257, 4, 8, False)])
def test_stream_plan_stage_slots(halo, cols, depth, fits):
    # the cp.async variant adds depth + 1 slots of T1, T0 and acc chunks
    # after the rings
    plan = ck._stream_shape(halo, 1024 ** 2, 72, cols, depth=depth)
    assert (plan is not None) == fits
    if fits:
        L = plan["lag"]
        assert plan["shared_bytes"] == cols * (
            9 * L + 3 + 3 * (depth + 1)) * 256 * 4
        assert plan["shared_bytes"] <= ck.SHARED_BYTES_PER_BLOCK


F32, F64 = torch.float32, torch.float64


@pytest.mark.parametrize("dtype,offs,N,M,cols", [
    # the 7-point stencil on a 32^3 grid: 4 columns per block
    (F32, (-1024, -32, -1, 0, 1, 32, 1024), 32 ** 3, 72, 4),
    # a 2048^2 grid (the tile plan's too): 2 columns, one block per SM
    (F32, (-2048, -1, 0, 1, 2048), 2048 ** 2, 72, 2),
    # the widest halo two columns' rings hold
    (F32, (-2816, -1, 0, 1, 2816), 3000 ** 2, 72, 2),
    # 64^3 (halo 4096, beyond the tile plan's reach): one column alone on
    # its multiprocessor, refused (the solver takes 2-step passes) ...
    (F32, (-4096, -64, -1, 0, 1, 64, 4096), 64 ** 3, 72, None),
    (F32, (-2817, -1, 0, 1, 2817), 3000 ** 2, 72, None),
    # ... but taken for a single column, where the strips fill the card
    (F32, (-4096, -64, -1, 0, 1, 64, 4096), 64 ** 3, 1, 1),
    # fp64: 2 columns up to a 1024-row halo, then one column per block,
    # alone on its multiprocessor, up to the widest halo its rings hold
    (F64, (-1024, -32, -1, 0, 1, 32, 1024), 32 ** 3, 72, 2),
    (F64, (-1030, -1, 0, 1, 1030), 1030 ** 2, 72, 1),
    (F64, (-2048, -1, 0, 1, 2048), 2048 ** 2, 72, 1),
    (F64, (-2816, -1, 0, 1, 2816), 2816 * 512, 72, 1),
    (F64, (-2817, -1, 0, 1, 2817), 2817 * 512, 72, None),
    (F64, (-4096, -64, -1, 0, 1, 64, 4096), 64 ** 3, 72, None)])
def test_stream_plan_columns_in_flight(dtype, offs, N, M, cols):
    plan = ck.multistep_plan(offs, N, M, dtype, 4)
    assert (plan and plan["cols"]) == cols
    if plan is None:
        # the solver takes the tiled two-step passes there
        plan2 = ck.multistep_plan(offs, N, M, dtype, 2)
        assert plan2 is not None and plan2["steps"] == 2
    else:
        assert plan["blocks_per_sm"] * plan["cols"] >= (
            min(M, 2) if dtype == F32 else 1)


def _old_tiled_four_step_took(halo, N, M, itemsize):
    """The rule by which the tile plan of the retired tiled four-step body
    took a shape: its largest tile (three tiles' and ten halos' values in
    the block's shared memory) at least six halos long."""
    words = ck.SHARED_BYTES_PER_BLOCK // itemsize
    tile_max = (words - 10 * halo) // 3 // 32 * 32
    return (N > 0 and M > 0 and tile_max >= max(6 * halo, 32)
            and 2 * N + tile_max + 5 * halo + 1024 <= 2**31 - 1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("M", [72, 1])
def test_four_step_route_where_the_tiles_ran(dtype, M):
    # every halo from 1 to 3000 rows on a 2D grid of nx = halo: wherever
    # the old tiled four-step plan took the shape, the streamed plan does
    # (in fp64 at halos 1025-1034 with one column per block, which two
    # fp64 2-step passes were slower than, PERF.md); and the streamed plan
    # reaches further: 2816 rows (two f32 columns' or one fp64 column's
    # rings), and past 3000 for a single f32 column (5632)
    size = ck._itemsize(dtype)
    took = streams = 0
    for halo in range(1, 3001):
        N = max(halo * halo, 4096)
        plan = ck.multistep_plan((-halo, -1, 0, 1, halo), N, M, dtype, 4)
        if _old_tiled_four_step_took(halo, N, M, size):
            took = halo
            assert plan is not None, halo
        if plan is not None:
            streams = halo
    assert took == (2074 if size == 4 else 1034)
    assert streams == (3000 if size == 4 and M == 1 else 2816)


@pytest.mark.parametrize("nx,cols64", [(1024, 2), (1025, 1), (1030, 1),
                                       (1034, 1), (1035, 1)])
def test_gap_routing_in_the_solver(nx, cols64, monkeypatch):
    # the polynomial path's steps per pass on a 2D Laplacian's five
    # diagonals: both rungs stream four steps; fp64 takes 2 columns per
    # block up to nx = 1024 and one above (1025-1034 ran the tiled
    # four-step body before; 1035 took 2-step passes)
    from feastkit_tpu_torch.solvers import sparse
    for switch in ("FEAST_CHEB_FUSE2", "FEAST_CHEB_FUSE4"):
        monkeypatch.delenv(switch, raising=False)
    offs = (-nx, -1, 0, 1, nx)
    dia = torch.zeros((5, nx * nx), dtype=torch.float64)
    ctx = sparse._cheb_fused_context(dia, offs, np.ones(5), -0.1, 8.1, 72)
    assert ctx["f32"]["steps"] == ctx["f64"]["steps"] == 4
    plan = ck.multistep_plan(offs, nx * nx, 72, torch.float64, 4)
    assert plan["cols"] == cols64
    assert _old_tiled_four_step_took(nx, nx * nx, 72, 8) == (nx < 1035)


# ---------------------------------------------------------------- two steps
#
# The same kernel with S = 2 (cheb_step2_f32 / cheb_step2_f64): rings of
# 2L+1 and 2L chunks (T1, T2), level 0 over the own chunks and H more each
# side, level 1 over the own chunks; acc from T2 (level 1's source) and T3.

OPERATORS.update({
    "1diag": lambda: _banded((0,), 1073),
    "7diags_3d": lambda: _banded((-340, -20, -1, 0, 1, 20, 340), 1700),
})

# (operator, M, (columns per block, strips) or None for the solver's plan)
TWO_STEP_CASES = [
    ("lap2d_37x29", 11, (4, 3)),      # |offset| = nx, ragged groups
    ("lap2d_37x29", 72, None),        # the solver's plan at M = 72
    ("lap2d_300x9", 7, (4, 2)),       # a halo over two chunks
    ("lap2d_600x5", 1, (1, 3)),       # three chunks, one column
    ("lap2d_600x5", 5, (2, 1)),       # one strip
    ("lap2d_33x33", 3, (4, 4)),
    ("1diag", 5, (2, 3)),
    ("3diags", 7, (2, 4)),
    ("9diags", 1, (1, 2)),
    ("9diags", 72, (4, 3)),
    ("9diags_wide", 3, (4, 2)),
    ("11diags", 7, None),
    ("11diags", 5, (4, 4)),
    ("wide_small", 7, (2, 2)),        # every range clipped at both ends
    ("outside", 5, (4, 3)),           # a diagonal outside the matrix
    ("7diags_3d", 7, (4, 2)),
]


def _plan2(offs, n, M, shape, dtype):
    itemsize = np.dtype(dtype).itemsize
    if shape is None:
        return ck.multistep_plan(offs, n, M, _TORCH[itemsize], 2)
    cols, strips = shape
    return ck._stream_shape(_halo(offs, n), n, M, cols, strips,
                            itemsize=itemsize, steps=2)


@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-12),
                                       (np.float32, 1e-5)])
@pytest.mark.parametrize("op,M,shape", TWO_STEP_CASES,
                         ids=_ids(TWO_STEP_CASES))
def test_two_step_schedule_matches_plain(op, M, shape, dtype, tol):
    # f32 block shapes (up to 4 columns), the arithmetic in both types
    dia, offs, n = OPERATORS[op]()
    plan = _plan2(offs, n, M, shape, np.float32)
    assert plan["steps"] == 2
    _check_schedule(op, M, plan, dtype, tol)


TWO_STEP_FP64_CASES = [
    ("lap2d_37x29", 11, (2, 3)),
    ("lap2d_300x9", 3, (1, 2)),
    ("lap2d_600x5", 7, (2, 3)),
    ("9diags", 72, None),
    ("9diags_wide", 5, (2, 2)),
    ("11diags", 1, (1, 4)),
    ("outside", 3, (2, 3)),
    ("7diags_3d", 5, (1, 2)),
]


@pytest.mark.parametrize("op,M,shape", TWO_STEP_FP64_CASES,
                         ids=_ids(TWO_STEP_FP64_CASES))
def test_two_step_schedule_under_fp64_plans(op, M, shape):
    dia, offs, n = OPERATORS[op]()
    plan = _plan2(offs, n, M, shape, np.float64)
    assert plan["cols"] <= 2 and plan["steps"] == 2
    _check_schedule(op, M, plan, np.float64, 1e-12)


def test_two_step_rings():
    # T1: written L chunks ahead of level 0, read back to level 1's prev 2L
    # behind that; T2: written by level 0, read by level 1's stencil 2L - 1
    # behind: 4L + 1 chunks per column, against the four steps' 9L + 3
    for L in (2, 3, 5, 39):
        assert ck._ring_lengths(2, L) == [2 * L + 1, 2 * L]
        assert ck._ring_lengths(4, L) == [2 * L + 1, 3 * L + 1, 2 * L + 1,
                                          2 * L]
    assert ck._stream_ring_bytes(257, 4, steps=2) == 4 * 13 * 256 * 4
    assert ck._stream_ring_bytes(257, 4, steps=4) == 4 * 30 * 256 * 4


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("offs,N,M", [
    ((-1024, -1, 0, 1, 1024), 1024 ** 2, 72),
    ((-512, -1, 0, 1, 512), 512 ** 2, 72),
    ((-257, -256, -255, -1, 0, 1, 255, 256, 257), 65536, 72),
    ((-4096, -64, -1, 0, 1, 64, 4096), 64 ** 3, 72),
    ((-9680, -1, 0, 1, 9680), 9680 * 64, 1),
    ((-37, -1, 0, 1, 37), 1073, 11),
    ((-60, -1, 0, 1, 60), 100, 1),
    ((-1, 0, 1), 1073, 7)])
def test_two_step_plan_fields(offs, N, M, dtype):
    plan = ck.multistep_plan(offs, N, M, dtype, 2)
    size = ck._itemsize(dtype)
    if plan is None:
        # fp64 rings of one column hold a halo of 6912 rows at most
        assert size == 8 and max(abs(d) for d in offs) > 6912
        return
    R, L, C = plan["chunk"], plan["lag"], plan["cols"]
    assert plan["steps"] == 2 and plan["depth"] == 0
    assert C in ((1, 2, 4) if size == 4 else (1, 2)) and R == 256
    assert plan["groups"] * C >= M > (plan["groups"] - 1) * C
    assert (L - 1) * R >= plan["halo"] > (L - 2) * R
    # the rings: 4 L + 1 chunks per column, within the block's budget
    assert plan["shared_bytes"] == C * (4 * L + 1) * R * size
    assert plan["shared_bytes"] <= ck.SHARED_BYTES_PER_BLOCK
    # built for two blocks per multiprocessor (128 registers a thread),
    # fewer where the rings take more than half its shared memory
    assert 1 <= plan["blocks_per_sm"] <= 2
    assert plan["tile"] % R == 0 and plan["tile"] >= 2 * plan["halo"]
    assert plan["tiles"] * plan["tile"] >= N > (plan["tiles"] - 1) * plan[
        "tile"]
    reckoned = ck.reckoned_traffic(plan, offs, N, size)
    assert reckoned["recompute"] >= 1.0
    assert reckoned["l2_bytes_per_element"] > 6 * size


def test_two_step_plan_at_nine_diagonals():
    # the consistent-mass B~ at P=8 (halo 257, lag 3): f32 rings of 4
    # columns take 53,248 B (13 chunks a column), two blocks per
    # multiprocessor; 14 strips x 18 groups = 252 blocks, one wave of the
    # 264 resident; ~46 B per element requested from L2 (each diagonal
    # load serves 4 columns, twice per row), against 24 B of planes
    offs = (-257, -256, -255, -1, 0, 1, 255, 256, 257)
    plan = ck.multistep_plan(offs, 65536, 72, torch.float32, 2)
    assert (plan["cols"], plan["lag"], plan["shared_bytes"]) == (4, 3, 53248)
    assert plan["blocks_per_sm"] == 2
    assert (plan["tiles"], plan["groups"]) == (14, 18)
    assert 46 < ck.reckoned_traffic(plan, offs, 65536)[
        "l2_bytes_per_element"] < 47
    # fp64: 2 columns, 7 strips x 36 groups
    plan64 = ck.multistep_plan(offs, 65536, 72, torch.float64, 2)
    assert (plan64["cols"], plan64["tiles"], plan64["groups"]) == (2, 7, 36)


def _old_tiled_two_step_took(halo, N, M, itemsize):
    """The rule by which the tile plan of the retired tiled two-step body
    took a shape: its largest tile (two tiles' and two halos' values in
    the block's shared memory, 32-row aligned) at least two halos long,
    its row indices and its block count (one block per tile and column)
    within an int."""
    words = ck.SHARED_BYTES_PER_BLOCK // itemsize
    tile_max = (words - 2 * halo) // 2 // 32 * 32
    return (N > 0 and M > 0 and tile_max >= max(2 * halo, 32)
            and 2 * N + tile_max + 3 * halo + 1024 <= 2**31 - 1
            and -(-N // tile_max) * M <= 2**31 - 1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("M", [72, 1])
def test_two_step_route_where_the_tiles_ran(dtype, M):
    # every halo from 1 to past the tile rule's reach, on a 2D grid of
    # nx = halo (at least 4096 rows): wherever the old tiled two-step plan
    # took the shape, the streamed plan does; the streamed plan reaches
    # further, to the widest halo one column's rings hold
    size = ck._itemsize(dtype)
    took = streams = 0
    for halo in range(1, 14200 if size == 4 else 7000):
        N = max(halo * halo, 4096)
        plan = ck.multistep_plan((-halo, -1, 0, 1, halo), N, M, dtype, 2)
        if _old_tiled_two_step_took(halo, N, M, size):
            took = halo
            assert plan is not None and plan["steps"] == 2, halo
        if plan is not None:
            streams = halo
    assert took == (9680 if size == 4 else 4832)
    assert streams == (14080 if size == 4 else 6912)


@pytest.mark.parametrize("nx,f32,f64", [
    (1024, 4, 4),     # the main path: four steps on both rungs
    (2816, 4, 4),     # the widest halo both four-step plans take
    (2900, 2, 2),     # past it: two steps on both rungs
    (4832, 2, 2),     # the tile rule's fp64 reach
    (9680, 2, 1),     # its f32 reach; fp64 two-step rings hold 6912
    (14080, 2, 1)])   # the widest f32 halo the two-step rings hold
def test_two_step_routing_in_the_solver(nx, f32, f64, monkeypatch):
    # the polynomial path's steps per pass on a five-point operator with
    # offsets +-1, +-nx (8 grid rows, so the operands stay small): no shape
    # goes to one step per launch that the tile rule gave two
    from feastkit_tpu_torch.solvers import sparse
    for switch in ("FEAST_CHEB_FUSE2", "FEAST_CHEB_FUSE4"):
        monkeypatch.delenv(switch, raising=False)
    offs = (-nx, -1, 0, 1, nx)
    N = 8 * nx
    dia = torch.zeros((5, N), dtype=torch.float64)
    ctx = sparse._cheb_fused_context(dia, offs, np.ones(5), -0.1, 8.1, 72)
    assert (ctx["f32"]["steps"], ctx["f64"]["steps"]) == (f32, f64)
    for dtype, steps in ((torch.float32, f32), (torch.float64, f64)):
        if _old_tiled_two_step_took(nx, N, 72, ck._itemsize(dtype)):
            assert steps >= 2
