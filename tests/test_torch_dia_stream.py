"""PyTorch port: a CPU rehearsal of the DIA matvec kernels' schedules.

``csrc/dia_matvec.cu`` runs only on the card. Its two bodies are emulated
here in numpy exactly as the CUDA source walks them, under the plans
``ops/dia.py``'s ``dia_plan`` makes:

* the ring body, block by block and iteration by iteration: a block owns a
  strip of ``tile`` rows for a column group of every operand; thread (q,
  lane) holds row q of each chunk and the 16-byte piece ``lane`` of a ring
  row; even strips walk down, odd ones up; the chunks -L .. L of the walk
  are copied in one group and the next D - 1 in one group each; at
  iteration j the block waits for group j, passes its barrier, copies
  chunk j + L + D into the slot its incremental index names, and computes
  chunk j from the ring (rows and columns outside the operand zero-filled,
  out-of-range terms dropped by a test only where the chunk lies within the
  halo of the matrix's first or last row). Every copy asserts that its slot
  is the one (chunk + L) mod Q names, that the slot's previous copy has
  landed and that no thread reads the slot in the same iteration; every
  ring read asserts that its slot holds the chunk the row needs and that
  the copy has landed (the kernel has one barrier an iteration, so any of
  these would be a race between its threads); every output piece is
  written exactly once;
* the flat body, one thread per output element, each term masked to the
  matrix.

The result is held against ``dia_matvec_plain`` (fp64 at 1e-12, f32 at
1e-5 relative to max|y|) at small shapes that reach every edge of the
schedule: 1, 3, 5, 7, 9 and 11 diagonals, |offset| = nx, an offset >= N,
2 max|offset| > N, M = 1, 3, 7, 72, 128 and 144, g = 1, 2 and 3, under f32
and fp64 plans, with the column group, the copies in flight and the strip
count varied. The plan's fields, its shared memory, its route at every
halo and its choices at the Krylov and P=10 shapes are checked too. The
kernels themselves are held to the plain version on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``). About 10 s in one
process.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from feastkit_tpu_torch.ops import dia as D  # noqa: E402

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


def _inside(offsets, N):
    """(offset, row in diags) of the diagonals inside the matrix, as
    launch_ring keeps them."""
    return [(o, k) for k, o in enumerate(offsets) if -N < o < N]


def _emulate_ring(diags, offsets, x, plan):
    """y of one launch of the ring body under ``plan``; numpy (nd, N)
    diagonals and (g, N, M) operands of one dtype."""
    g, N, M = x.shape
    dt = x.dtype.type
    vec, cols, lanes, R = plan["vec"], plan["cols"], plan["lanes"], \
        plan["chunk"]
    L, Dp, tile = plan["lag"], plan["depth"], plan["tile"]
    Q = D.ring_chunks(L, Dp)
    assert Q == plan["ring"]
    # launch_ring's checks
    assert M % vec == 0 and cols % vec == 0 and lanes * vec == g * cols
    assert lanes * R <= 256 and tile % R == 0 and 1 <= Dp <= 8
    diag = _inside(offsets, N)
    nd = len(diag)
    assert Q * R * lanes * 16 + (Dp + 1) * nd * R * x.itemsize == \
        plan["shared_bytes"] <= 232448
    h = max((abs(o) for o, _ in diag), default=0)
    assert L * R >= h and h == plan["halo"] and len(diag) == plan["nd"]
    groups = -(-M // cols)
    assert groups == plan["groups"]
    y = np.full(x.shape, np.nan, x.dtype)
    written = np.zeros(x.shape, np.int64)
    q = np.arange(R)
    lane = np.arange(lanes)
    per_op = cols // vec
    b = lane // per_op
    for strip in range(-(-N // tile)):
        for group in range(groups):
            col = group * cols + (lane % per_op) * vec
            col_ok = col < M
            s0 = strip * tile
            nch = -(-min(tile, N - s0) // R)
            down = strip % 2 == 0
            step_dir = 1 if down else -1
            ring = np.full((Q * R, lanes, vec), np.nan, x.dtype)
            label = np.full(Q, _NEVER)        # chunk a slot holds
            grp_of = np.full(Q, _NEVER)       # its copies' group
            read_at = np.full(Q, _NEVER)      # last iteration reading it
            # the diagonal stage: D + 1 slots of nd x R values, the same
            # bookkeeping
            stage = np.full((Dp + 1, nd, R), np.nan, x.dtype)
            dlabel = np.full(Dp + 1, _NEVER)
            dgrp = np.full(Dp + 1, _NEVER)
            dread_at = np.full(Dp + 1, _NEVER)
            done = [-1]                       # groups landed and visible

            def chunk_at(u):
                return u if down else nch - 1 - u

            def issue(u, slot, dslot, it, grp):
                if L <= u < nch + L:
                    # the diagonal values of own chunk u - L, lane k
                    # copying diagonals k, k + lanes, ...
                    cd = chunk_at(u - L)
                    assert dslot == (u - L) % (Dp + 1), "wrong stage slot"
                    assert dread_at[dslot] != it, "stage read this iteration"
                    assert dlabel[dslot] == _NEVER or dgrp[dslot] <= done[0], \
                        "stage slot's earlier copies still in flight"
                    rows = s0 + cd * R + q
                    ok = rows < N
                    vals = np.zeros((nd, R), x.dtype)
                    for li in range(lanes):
                        for kk in range(li, nd, lanes):
                            vals[kk, ok] = diags[diag[kk][1], rows[ok]]
                    stage[dslot] = vals
                    dlabel[dslot], dgrp[dslot] = cd, grp
                if u >= nch + L:
                    return
                c = chunk_at(u)
                assert slot == (c + L) % Q, "copy to the wrong slot"
                assert read_at[slot] != it, "slot read in this iteration"
                assert label[slot] == _NEVER or grp_of[slot] <= done[0], \
                    "slot's earlier copies still in flight"
                rows = s0 + c * R + q
                ok = (rows >= 0) & (rows < N)
                piece = np.zeros((R, lanes, vec), x.dtype)
                for li in np.flatnonzero(col_ok):
                    piece[ok, li] = x[b[li], rows[ok],
                                      col[li]:col[li] + vec]
                ring[slot * R:(slot + 1) * R] = piece
                label[slot], grp_of[slot] = c, grp

            def slot_of(c):
                return (c + L) % Q

            for u in range(-L, L + 1):
                issue(u, slot_of(chunk_at(u)), 0, -1, 0)
            for u in range(L + 1, L + Dp):
                issue(u, slot_of(chunk_at(u)), u - L, -1, u - L)
            committed = Dp
            cur = slot_of(chunk_at(0))
            ld = slot_of(chunk_at(L + Dp))
            dcur, dld = 0, Dp

            def step(s):
                s += step_dir
                return 0 if s == Q else Q - 1 if s < 0 else s

            for j in range(nch):
                # wait_group(D - 1) + barrier: all but the D - 1 newest
                # groups have landed
                done[0] = committed - 1 - (Dp - 1)
                assert done[0] == j
                issue(j + L + Dp, ld, dld, j, committed)
                committed += 1
                c = chunk_at(j)
                assert cur == slot_of(c)
                assert dlabel[dcur] == c, "stale stage slot"
                assert dgrp[dcur] <= done[0], "read of a stage copy in flight"
                dread_at[dcur] = j
                rows = s0 + c * R + q
                top = s0 + c * R
                edge = top - h < 0 or top + R + h > N
                live = rows < N
                acc = np.zeros((R, lanes, vec), x.dtype)
                for kk, (o, k) in enumerate(diag):
                    nb = rows + o
                    use = live & (nb >= 0) & (nb < N) if edge else live
                    if not edge:
                        assert np.all((nb[live] >= 0) & (nb[live] < N)), \
                            "a steady chunk reaches outside the matrix"
                    pos = cur * R + q + o
                    pos = np.where(pos < 0, pos + Q * R, pos)
                    pos = np.where(pos >= Q * R, pos - Q * R, pos)
                    assert np.all((pos >= 0) & (pos < Q * R))
                    slots = pos[use] // R
                    want = (nb[use] - s0) // R
                    assert np.all(label[slots] == want), "stale ring slot"
                    assert np.all(grp_of[slots] <= done[0]), \
                        "read of a copy in flight"
                    read_at[slots] = j
                    d = np.where(use, stage[dcur, kk], dt(0))
                    acc += d[:, None, None] * np.where(
                        use[:, None, None], ring[pos], dt(0))
                for li in np.flatnonzero(col_ok):
                    rr = rows[live]
                    y[b[li], rr, col[li]:col[li] + vec] = acc[live, li]
                    written[b[li], rr, col[li]:col[li] + vec] += 1
                cur, ld = step(cur), step(ld)
                dcur = 0 if dcur == Dp else dcur + 1
                dld = 0 if dld == Dp else dld + 1
    assert np.all(written == 1), "an output written other than once"
    return y


def _emulate_flat(diags, offsets, x):
    """y of the flat body: per element, each term masked to the matrix."""
    g, N, M = x.shape
    y = np.zeros_like(x)
    i = np.arange(N)
    for k, o in enumerate(offsets):
        ok = (i + o >= 0) & (i + o < N)
        src = np.where(ok, i + o, i)
        y += np.where(ok, diags[k], 0)[None, :, None] * x[:, src, :]
    return y


def _banded(offsets, N, dtype, seed=3):
    rng = np.random.default_rng(seed)
    d = np.zeros((len(offsets), N))
    for k, o in enumerate(offsets):
        if abs(o) < N:
            d[k, max(0, -o):N - max(0, o)] = rng.random(N - abs(o)) - 0.5
    return d.astype(dtype)


def _check(offsets, N, M, g, dtype, tol, **over):
    plan = D.dia_plan(offsets, N, M, g, torch.float32 if dtype == np.float32
                      else torch.float64, sms=4, **over)
    rng = np.random.default_rng(N + M + g)
    diags = _banded(offsets, N, dtype)
    x = rng.standard_normal((g, N, M)).astype(dtype)
    if plan["body"] == "ring":
        y = _emulate_ring(diags, offsets, x, plan)
    else:
        y = _emulate_flat(diags, offsets, x)
    yp = D.dia_matvec_plain(torch.as_tensor(diags), offsets,
                            torch.as_tensor(x)).numpy()
    assert y.dtype == dtype
    scale = max(float(np.abs(yp).max()), 1e-30)
    assert float(np.abs(y - yp).max()) / scale <= tol
    return plan


_LAP = (-37, -1, 0, 1, 37)     # |offset| = nx on a 37-wide grid
CASES = [
    # offsets, N, M, g, plan overrides, body the plan must take
    ((0,), 300, 72, 1, {}, "ring"),
    ((-1, 0, 1), 1073, 8, 1, {}, "ring"),
    (_LAP, 1073, 72, 1, {}, "ring"),
    (_LAP, 1073, 128, 2, {}, "ring"),
    (_LAP, 1073, 144, 3, {}, "ring"),
    ((-34, -33, -32, -1, 0, 1, 32, 33, 34), 1089, 72, 1, {}, "ring"),
    ((-40, -33, -7, -2, -1, 0, 1, 2, 7, 33, 40), 1089, 16, 3, {}, "ring"),
    ((-45, -9, -1, 0, 1, 9, 45), 900, 128, 1, {}, "ring"),     # 3D, seven
    ((-60, -1, 0, 1, 60), 100, 72, 3, {}, "ring"),   # 2 max|offset| > N
    ((-150, -1, 0, 1, 150), 100, 144, 1, {}, "ring"),  # offsets >= N
    ((-150, -1, 0, 1, 150, 400), 100, 8, 2, {}, "ring"),  # six, three in
    (_LAP, 1073, 1, 1, {}, "flat"),
    (_LAP, 1073, 3, 3, {}, "flat"),
    ((-1, 0, 1), 1073, 7, 2, {}, "flat"),
    ((-60, -1, 0, 1, 60), 100, 7, 1, {}, "flat"),
    ((-150, 0, 150), 100, 1, 2, {}, "flat"),
    # the block shape, copies in flight and strips varied
    (_LAP, 1073, 72, 1, dict(cols=4, depth=1, strips=5), "ring"),
    (_LAP, 1073, 72, 1, dict(cols=72, depth=8, strips=3), "ring"),
    (_LAP, 1073, 128, 2, dict(cols=32, depth=2, strips=7), "ring"),
    ((-300, -1, 0, 1, 300), 1500, 16, 1, dict(depth=3, strips=4), "ring"),
    ((-1, 0, 1), 1000, 8, 3, dict(cols=4, depth=6, strips=9), "ring"),
]


def _ids(cases):
    return [f"nd{len(o)}-N{n}-M{m}-g{g}-{b}"
            + "".join(f"-{k}{v}" for k, v in over.items())
            for o, n, m, g, over, b in cases]


@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-12),
                                       (np.float32, 1e-5)],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("offsets,N,M,g,over,body", CASES, ids=_ids(CASES))
def test_schedule_matches_plain(offsets, N, M, g, over, body, dtype, tol):
    if dtype == np.float64 and "cols" in over:
        # a group of the same bytes: half the f32 columns
        over = dict(over, cols=max(2, over["cols"] // 2))
    plan = _check(offsets, N, M, g, dtype, tol, **over)
    assert plan["body"] == body


def test_schedule_walks_both_ways_and_every_edge():
    # several strips (both directions), a last strip shorter than the
    # tile and a last chunk past N, edge chunks at both ends, every slot
    # of the ring reused
    offsets = (-37, -1, 0, 1, 37)
    plan = _check(offsets, 1073, 16, 1, np.float64, 1e-12, cols=8,
                  strips=3, depth=2)
    assert plan["tiles"] == 3 and 1073 % plan["tile"] != 0
    assert 1073 % plan["chunk"] != 0
    assert (plan["tile"] // plan["chunk"]) > plan["ring"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("offsets,N,M,g", [
    ((-256, -1, 0, 1, 256), 65536, 128, 1),
    ((-256, -1, 0, 1, 256), 65536, 72, 1),
    ((-256, -1, 0, 1, 256), 65536, 128, 2),
    ((-1024, -1, 0, 1, 1024), 1048576, 72, 1),
    ((-37, -1, 0, 1, 37), 1073, 144, 3),
    ((-4096, -64, -1, 0, 1, 64, 4096), 262144, 72, 1),
])
def test_plan_fields(offsets, N, M, g, dtype):
    plan = D.dia_plan(offsets, N, M, g, dtype)
    vec = 4 if dtype == torch.float32 else 2
    assert plan["vec"] == vec and plan["nd"] == len(offsets)
    assert plan["halo"] == max(abs(o) for o in offsets)
    if plan["body"] == "flat":
        assert "do not fit a multiprocessor" in plan["reason"]
        return
    assert plan["cols"] % vec == 0 and plan["cols"] <= M
    assert plan["lanes"] == g * plan["cols"] // vec
    assert plan["chunk"] == 256 // plan["lanes"]
    assert plan["threads"] == plan["lanes"] * plan["chunk"] <= 256
    assert plan["lag"] == -(-plan["halo"] // plan["chunk"])
    assert plan["ring"] == 2 * plan["lag"] + 1 + plan["depth"]
    assert plan["shared_bytes"] == (
        plan["ring"] * plan["chunk"] * plan["lanes"] * 16
        + (plan["depth"] + 1) * plan["nd"] * plan["chunk"]
        * (16 // vec)) <= 232448
    assert plan["tile"] % plan["chunk"] == 0
    assert plan["tiles"] == -(-N // plan["tile"])
    assert (plan["tiles"] - 1) * plan["tile"] < N
    assert plan["groups"] == -(-M // plan["cols"])
    assert plan["blocks"] == plan["tiles"] * plan["groups"]
    assert 1 <= plan["blocks_per_sm"] <= 2048 // plan["threads"]
    assert plan["blocks_per_sm"] * (plan["shared_bytes"] + 1024) <= 233472
    # no strip shorter than its 2 lag halo chunks
    assert plan["tiles"] == 1 or plan["tile"] >= 2 * plan["lag"] * \
        plan["chunk"]
    traffic = D.reckoned_traffic(plan, N, M, g)
    assert 0 <= traffic["halo_share"] <= 2 * plan["lag"] * plan["chunk"] \
        * plan["tiles"] / N
    # x once with its halo share, y once, the diagonals once a group
    itemsize = 16 // vec
    assert traffic["l2_bytes_per_element"] >= 2 * itemsize
    # a plan of the same shape is the same plan (the wrapper caches it)
    assert plan == D.dia_plan(offsets, N, M, g, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("M,g", [(8, 1), (72, 1), (128, 2), (144, 3)])
def test_route_at_every_halo(dtype, M, g):
    # halos 1 .. 7999: the ring body wherever two blocks of the plan's
    # column group with two chunks of copies in flight fit a
    # multiprocessor, else the flat body; no ring plan exceeds the shared
    # memory, and every ring covers its halo
    N = 1 << 20
    itemsize = torch.finfo(dtype).bits // 8
    vec = 16 // itemsize
    lanes = g * min(64 // itemsize, M) // vec
    chunk = 256 // lanes
    routes = set()
    for h in list(range(1, 2049, 7)) + list(range(2049, 8000, 61)):
        plan = D.dia_plan((-h, -1, 0, 1, h), N, M, g, dtype)
        lag = -(-h // chunk)
        two = 2 * (D.ring_bytes(2 * lag + 3, chunk, lanes, 2, 5, itemsize)
                   + 1024) <= 233472
        assert (plan["body"] == "ring") == two, (h, plan)
        if two:
            assert plan["lanes"] == lanes and plan["depth"] >= 2
            assert 2 * (plan["shared_bytes"] + 1024) <= 233472
            assert plan["lag"] * plan["chunk"] >= h
        else:
            assert plan["reason"].startswith(f"halo {h}")
        routes.add(plan["body"])
    assert routes == {"ring", "flat"}


@pytest.mark.parametrize("M,g,dtype", [(1, 1, torch.float32),
                                       (3, 2, torch.float32),
                                       (7, 1, torch.float64),
                                       (4, 1, torch.float32),
                                       (2, 3, torch.float64),
                                       (9, 1, torch.float64)])
def test_few_or_odd_columns_take_the_flat_body(M, g, dtype):
    # the Lanczos vectors (M = 1), odd widths and rows under two 16-byte
    # pieces: the flat body, by shape, and the ring body refuses them
    offsets = (-256, -1, 0, 1, 256)
    plan = D.dia_plan(offsets, 65536, M, g, dtype)
    assert plan["body"] == "flat" and "16-byte" in plan["reason"]
    with pytest.raises(ValueError, match="ring body"):
        D.dia_plan(offsets, 65536, M, g, dtype, body="ring")


def test_plans_at_the_krylov_and_rayleigh_ritz_shapes():
    # the sweep's fastest: 64 bytes of each operand's row, two blocks a
    # multiprocessor in one wave, 6 chunks in flight for one operand and 4
    # for a batch
    lap = (-256, -1, 0, 1, 256)
    for M, g, dtype, cols, depth, tiles in (
            (128, 1, torch.float32, 16, 6, 32),
            (72, 1, torch.float64, 8, 6, 29),
            (128, 2, torch.float32, 16, 4, 33),
            (128, 2, torch.float64, 8, 4, 16)):
        plan = D.dia_plan(lap, 65536, M, g, dtype)
        assert plan["body"] == "ring"
        assert (plan["cols"], plan["depth"], plan["tiles"]) == \
            (cols, depth, tiles)
        assert 2 * 132 - plan["groups"] <= plan["blocks"] <= 2 * 132
        assert 2 * (plan["shared_bytes"] + 1024) <= 233472
        assert D.reckoned_traffic(plan, 65536, M, g)["halo_share"] <= 0.25
    # P=10 Rayleigh-Ritz: fp64, M = M0 = 72, halo 1024: the flat body, as
    # fast as the best ring in the sweep
    plan = D.dia_plan((-1024, -1, 0, 1, 1024), 1048576, 72, 1,
                      torch.float64)
    assert plan["body"] == "flat" and plan["reason"].startswith("halo 1024")
    forced = D.dia_plan((-1024, -1, 0, 1, 1024), 1048576, 72, 1,
                        torch.float64, body="ring")
    assert forced["lag"] * forced["chunk"] >= 1024
    # the Lanczos products of the consistent-mass bounds: M = 1, flat
    assert D.dia_plan(lap, 65536, 1, 1, torch.float32)["body"] == "flat"


def test_plan_overrides_and_refusals():
    lap = (-37, -1, 0, 1, 37)
    plan = D.dia_plan(lap, 1073, 72, 1, torch.float32, cols=8, depth=2,
                      strips=3)
    assert (plan["cols"], plan["depth"], plan["tiles"]) == (8, 2, 3)
    assert D.dia_plan(lap, 1073, 72, 1, torch.float32,
                      body="flat")["body"] == "flat"
    for bad in (dict(cols=6), dict(cols=0), dict(depth=0), dict(depth=9),
                dict(body="tiled")):
        with pytest.raises(ValueError):
            D.dia_plan(lap, 1073, 72, 1, torch.float32, **bad)
    with pytest.raises(ValueError, match="does not fit"):
        D.dia_plan((-4000, 0, 4000), 65536, 72, 1, torch.float64,
                   body="ring", cols=72)
    # 64-bit indices take the flat body
    assert D.dia_plan(lap, 1 << 26, 64, 1, torch.float32)["reason"] == \
        "64-bit indices"


def test_wrapper_caches_the_plan_and_counts_nothing_on_the_cpu():
    lap = (-37, -1, 0, 1, 37)
    D._cached_launch.cache_clear()
    a = D._cached_launch(lap, 1073, 72, 1, torch.float32, 132)
    b = D._cached_launch(lap, 1073, 72, 1, torch.float32, 132)
    assert a is b and a[0] == D.dia_plan(lap, 1073, 72, 1, torch.float32)
    assert list(a[1]) == list(lap)
    assert list(a[2]) == [a[0][f] for f in D.RING_PLAN_FIELDS]
    flat = D._cached_launch(lap, 1073, 1, 1, torch.float32, 132)
    assert flat[0]["body"] == "flat" and flat[2] is None
    D.reset_launch_counts()
    x = torch.ones(1073, 72)
    d = torch.as_tensor(_banded(lap, 1073, np.float32))
    D.dia_matvec_f32(d, lap, x)
    assert D.body_counts()["dia_matvec_f32"] == {"ring": 0, "flat": 0}
    assert D.launch_counts()["dia_matvec_f32"] == 0
