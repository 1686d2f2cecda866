"""PyTorch port, column-major one-step entries: forms, plan, JAX reference.

``cheb_step_cm_f32`` / ``cheb_step_cm_f64`` take T0 and acc as optional
operands (four forms, ``CM_FORMS``): without T0 it is read as zero and T2
goes to a new plane, without acc there is no accumulator. On CPU tensors
the wrappers run ``cheb_step_cm_plain``; the CUDA kernel
(``csrc/cheb_step_cm.cu``) is held against it on the card by
tests/test_torch_cuda.py and chip_smoke.py. Here, at small sizes:
  * each form of the plain version is bitwise equal to the full form run
    on explicit zero planes (T0 = 0; acc = 0 with c_k = 0 where the form
    has none);
  * each form is held against the JAX package's one-step Pallas kernels
    ``_cheb_f32_step`` / ``_cheb_ds_step`` in interpret mode, the forms
    without T0 from a zero T0 as ``cheb_gen_chunk`` passes it (f32 1e-5;
    fp64 against double-single 1e-13, relative to the largest entry of
    each compared plane; one step of about 2 nd + 6 operations);
  * a numpy replay of the kernel's walk over its grid (column groups,
    strips, chunks, one row per thread, clamped offsets, zeroed diagonal
    values and the row itself for out-of-range neighbours) writes every
    element once, reads only inside the operands and equals the plain
    version, for the plan's block shape and others, on ragged shapes;
  * the plan's block shapes, the wrappers' refusals and returned planes,
    and that the composite (``ops/cheb_gen.py``) launches the forms
    without T0 and gives bitwise what the full form on zero planes gave.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import scipy.sparse as sp  # noqa: E402

from feastkit_tpu.ops import cheb_pallas as ref_cp  # noqa: E402
from feastkit_tpu_torch.ops import cheb_gen as port_gen  # noqa: E402
from feastkit_tpu_torch.ops import cheb_kernels as port_ck  # noqa: E402
from feastkit_tpu_torch.ops import chebfilter as port_cf  # noqa: E402
from feastkit_tpu_torch.ops.dia import bcoo_to_dia  # noqa: E402

FORMS = port_ck.CM_FORMS


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # The suite runs files in parallel worker processes on a few cores;
    # torch's default intra-op pool (one spinning thread per core) then
    # starves its neighbours. The port's CPU tensors here are small.
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _has(form):
    """(has T0, has acc) of a form."""
    return form in ("full", "no_acc"), form in ("full", "no_t0")


def _random_dia(N, offsets, seed, garbage=False):
    """Random diagonals; entries outside the matrix (rows i with i + off
    outside [0, N)) are zero, or 99 with ``garbage`` (the kernels and the
    plain version must not use them)."""
    rng = np.random.default_rng(seed)
    d = np.full((len(offsets), N), 99.0 if garbage else 0.0)
    for k, o in enumerate(offsets):
        lo, hi = max(0, -o), min(N, N - o)
        if hi > lo:
            d[k, lo:hi] = rng.random(hi - lo) - 0.5
    return d


def _consistent_mass_a(nx):
    """A~ of the consistent-mass pencil on an nx x nx grid (nine
    diagonals, offsets 0, +-1, +-nx, +-nx +-1)."""
    Dx = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(nx, nx))
    Mx = sp.diags([4 / 6, 1 / 6, 1 / 6], [0, 1, -1], shape=(nx, nx))
    A = (sp.kron(Dx, Mx) + sp.kron(Mx, Dx)).tocoo()
    d = 1.0 / np.sqrt(sp.kron(Mx, Mx).diagonal())
    return bcoo_to_dia(A.data * d[A.row] * d[A.col],
                       np.stack([A.row, A.col], axis=1), nx * nx)


OPERATORS = {
    # name -> (diagonals, offsets)
    "nd5": lambda: (_random_dia(1073, (-37, -1, 0, 1, 37), 1),
                    (-37, -1, 0, 1, 37)),
    "nd9": lambda: _consistent_mass_a(32),
    "nd11": lambda: (_random_dia(
        1089, (-40, -33, -7, -2, -1, 0, 1, 2, 7, 33, 40), 2),
        (-40, -33, -7, -2, -1, 0, 1, 2, 7, 33, 40)),
    # 2 max|offset| > N: every row loses a neighbour at one end or both
    "wide": lambda: (_random_dia(100, (-60, -1, 0, 1, 60), 3),
                     (-60, -1, 0, 1, 60)),
}


def _planes(M, N, seed, dtype):
    rng = np.random.default_rng(seed)
    return [torch.as_tensor(rng.standard_normal((M, N))).to(dtype)
            for _ in range(3)]


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


# ----------------------------------------- forms against the full form


@pytest.mark.parametrize("op", list(OPERATORS))
@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("name,dtype", [
    ("cheb_step_cm_f32", torch.float32), ("cheb_step_cm_f64", torch.float64)])
def test_form_is_full_form_on_zero_planes(name, dtype, form, op):
    dia_np, offs = OPERATORS[op]()
    N, M = dia_np.shape[1], 7
    dia = torch.as_tensor(dia_np).to(dtype)
    t0, t1, acc = _planes(M, N, 5, dtype)
    has_t0, has_acc = _has(form)
    ck = 0.3 if has_acc else 0.0
    step = getattr(port_ck, name)
    a = [t0.clone(), t1.clone(), acc.clone()]
    out = step(dia, offs, a[0] if has_t0 else None, a[1],
               a[2] if has_acc else None, 0.4, 0.9, ck)
    b = [t0.clone() if has_t0 else torch.zeros_like(t0), t1.clone(),
         acc.clone() if has_acc else torch.zeros_like(acc)]
    full = step(dia, offs, *b, 0.4, 0.9, ck)
    assert full is b[0]
    assert (out is a[0]) == has_t0
    assert out.dtype == dtype and out.shape == (M, N) and out.is_contiguous()
    assert torch.equal(out, b[0])
    assert torch.equal(a[1], t1)                  # T1 untouched
    if has_acc:
        assert torch.equal(a[2], b[2])
    else:
        assert torch.equal(a[2], acc) and torch.equal(b[2], torch.zeros_like(
            acc))                                 # c_k = 0: acc stays 0


# ------------------------------------ forms against the JAX package

JAX_CASES = [("nd5", 7), ("nd9", 72), ("nd9", 1), ("nd11", 7), ("wide", 1),
             ("wide", 72)]
SC, SH, CK = (float(np.float32(v)) for v in (0.37, 0.61, 0.23))


def _jax_step(dia, offs, T0, T1, acc, ds):
    """One step of the JAX package's one-step kernel in interpret mode on
    the packed planes of the (N, M) arrays T0, T1, acc: (T2, acc') as
    (N, M) float64 arrays."""
    N, M = T1.shape
    plan = ref_cp.cheb_plan(offs, N, M)
    kw = dict(offsets=plan["offsets"], block=plan["block"],
              n_blocks=ref_cp._grid_1step(plan), interpret=True)
    b = plan["block"]

    def unpack(*parts):
        return sum(np.asarray(p, np.float64)[:M, b:b + N].T for p in parts)
    if ds:
        dg = ref_cp.pack_diags(jnp.asarray(dia), plan)
        packed = [ref_cp.pack_state(jnp.asarray(x), plan)
                  for x in (T0, acc, T1)]
    else:
        dg = ref_cp.pack_diags32(jnp.asarray(dia), plan)
        packed = [ref_cp.pack_state32(jnp.asarray(x), plan)
                  for x in (T0, acc, T1)]
    with jax.enable_x64(False):
        smem = jnp.stack([jnp.float32(SC), jnp.float32(SH), jnp.float32(CK),
                          jnp.float32(0.0)])[None, :]
        if ds:
            t2h, t2l, ah, al = ref_cp._cheb_ds_step(
                smem, *dg, *packed[0], *packed[1], *packed[2], **kw)
            return unpack(t2h, t2l), unpack(ah, al)
        t2, a2 = ref_cp._cheb_f32_step(smem, dg, *packed, **kw)
        return unpack(t2), unpack(a2)


@pytest.mark.parametrize("op,M", JAX_CASES)
@pytest.mark.parametrize("ds", [False, True])
def test_forms_match_pallas_one_step(op, M, ds):
    dia_np, offs = OPERATORS[op]()
    N = dia_np.shape[1]
    rng = np.random.default_rng(11)
    T0, T1, acc = (rng.standard_normal((N, M)) for _ in range(3))
    if not ds:      # the f32 kernel sees f32 data
        dia_np, T0, T1, acc = (x.astype(np.float32).astype(np.float64)
                               for x in (dia_np, T0, T1, acc))
    dtype = torch.float64 if ds else torch.float32
    step = port_ck.cheb_step_cm_f64 if ds else port_ck.cheb_step_cm_f32
    tol = 1e-13 if ds else 1e-5
    dia = torch.as_tensor(dia_np).to(dtype)

    def cm(x):
        return torch.as_tensor(x.T.copy()).to(dtype)
    # zero T0, as cheb_gen_chunk passes it: the forms without T0
    ref = _jax_step(dia_np, offs, np.zeros_like(T0), T1, acc, ds)
    for form in ("no_t0", "bare"):
        a = cm(acc)
        out = step(dia, offs, None, cm(T1), a if form == "no_t0" else None,
                   SC, SH, CK if form == "no_t0" else 0.0)
        assert _rel(out.t(), ref[0]) <= tol, form
        if form == "no_t0":
            assert _rel(a.t(), ref[1]) <= tol
    # a nonzero T0: the forms with T0
    ref = _jax_step(dia_np, offs, T0, T1, acc, ds)
    for form in ("full", "no_acc"):
        a = cm(acc)
        out = step(dia, offs, cm(T0), cm(T1), a if form == "full" else None,
                   SC, SH, CK if form == "full" else 0.0)
        assert _rel(out.t(), ref[0]) <= tol, form
        if form == "full":
            assert _rel(a.t(), ref[1]) <= tol


# ------------------------------------------- the kernel's walk, replayed


def _replay(plan, dia, offsets, t0, t1, acc, sc, sh, ck):
    """``csrc/cheb_step_cm.cu`` walked in numpy: block (strip x, group y),
    thread t owns row x threads + t (threads past N stop) for the group's
    columns. Offsets are clamped to [-N, N];
    a neighbour outside [0, N) is the row itself with a zero diagonal
    value. ``t0`` / ``acc`` None: absent. Returns T2, acc and how often
    each element was written; asserts that every read is inside its
    operand."""
    M, N = t1.shape
    cols, threads = plan["cols"], plan["threads"]
    offs = np.clip(np.asarray(offsets, np.int64), -N, N)[:, None]
    out = np.zeros_like(t1) if t0 is None else t0.copy()
    acc = None if acc is None else acc.copy()
    writes = np.zeros((M, N), np.int64)
    for gy in range(plan["groups"]):
        j0 = gy * cols
        for bx in range(plan["strips"]):
            rows = bx * threads + np.arange(threads)
            rows = rows[rows < N]
            r = rows[None, :] + offs
            ok = (r >= 0) & (r < N)
            d = np.where(ok, dia[:, rows], 0.0)
            src = np.where(ok, r, rows[None, :])
            assert src.min() >= 0 and src.max() < N
            for j in range(j0, min(j0 + cols, M)):
                y = np.zeros(rows.size)
                for k in range(len(offsets)):
                    y += d[k] * t1[j, src[k]]
                v = 2.0 * (sc * y - sh * t1[j, rows])
                if t0 is not None:
                    v -= out[j, rows]
                out[j, rows] = v
                writes[j, rows] += 1
                if acc is not None:
                    acc[j, rows] += ck * v
    return out, acc, writes


REPLAY_SHAPES = [
    # (N, offsets, M): ragged groups against 2 / 4 / 8 columns, N not a
    # multiple of the chunk or the strip, |offset| = nx, 2 max|off| > N,
    # an offset beyond N (clamped), one and eleven diagonals
    (1073, (-37, -1, 0, 1, 37), 11),
    (100, (-60, -1, 0, 1, 60), 7),
    (300, (-400, -1, 0, 1, 17), 1),
    (1089, (-40, -33, -7, -2, -1, 0, 1, 2, 7, 33, 40), 5),
    (257, (0,), 3),
]
REPLAY_PLANS = [None, (2, 64), (4, 256), (8, 512), (1, 128)]


@pytest.mark.parametrize("shape", REPLAY_SHAPES)
@pytest.mark.parametrize("block", REPLAY_PLANS)
def test_kernel_walk_replayed(shape, block):
    N, offs, M = shape
    dia = _random_dia(N, offs, 4, garbage=True)
    plan = (port_ck.cm_step_plan(N, M) if block is None
            else port_ck._cm_shape(N, M, *block))
    rng = np.random.default_rng(8)
    t0, t1, acc = (rng.standard_normal((M, N)) for _ in range(3))
    for form in FORMS:
        has_t0, has_acc = _has(form)
        got, got_acc, writes = _replay(plan, dia, offs,
                                       t0 if has_t0 else None, t1,
                                       acc if has_acc else None, 0.4, 0.9,
                                       0.3)
        assert (writes == 1).all(), form
        p = [torch.as_tensor(x.copy()) for x in (t0, t1, acc)]
        want = port_ck.cheb_step_cm_plain(
            torch.as_tensor(dia), offs, p[0] if has_t0 else None, p[1],
            p[2] if has_acc else None, 0.4, 0.9, 0.3)
        assert _rel(got, want) <= 1e-13, form
        if has_acc:
            assert _rel(got_acc, p[2]) <= 1e-13, form


# --------------------------------------------------------------- plan


@pytest.mark.parametrize("N,M,cols,groups", [
    (65536, 72, 8, 9),                                 # the consistent mass
    (1048576, 72, 8, 9), (1073, 11, 8, 2), (1073, 40, 8, 5),
    (100, 7, 4, 2), (100, 1, 1, 1), (1089, 3, 2, 2), (1089, 5, 4, 2),
    (129, 0, 1, 0)])
def test_cm_step_plan(N, M, cols, groups):
    plan = port_ck.cm_step_plan(N, M)
    assert plan["cols"] == cols and plan["groups"] == groups
    assert (groups - 1) * cols < M <= groups * cols or M == groups == 0
    rows = plan["threads"]
    assert rows == 128 and rows in port_ck._CM_THREADS
    assert (plan["strips"] - 1) * rows < N <= plan["strips"] * rows


def test_cm_step_plan_refusals():
    with pytest.raises(ValueError, match="2\\^30"):
        port_ck.cm_step_plan(2**30 + 1, 4)
    with pytest.raises(ValueError, match="65535"):
        port_ck.cm_step_plan(100, 8 * 65536)
    with pytest.raises(ValueError, match="threads"):
        port_ck._cm_shape(100, 4, 4, 96)


# ---------------------------------------------------------- refusals


@pytest.mark.parametrize("case", ["ck_without_acc", "t1_is_t0",
                                  "t1_is_acc", "shape", "dtype", "diags"])
def test_column_major_entry_refuses(case):
    N, M = 50, 3
    dia = torch.ones(3, N, dtype=torch.float64)
    offs = (-1, 0, 1)
    t0, t1, acc = _planes(M, N, 0, torch.float64)
    args = dict(ck_without_acc=(dia, offs, None, t1, None, 1.0, 0.0, 0.1),
                t1_is_t0=(dia, offs, t1, t1, acc, 1.0, 0.0, 0.1),
                t1_is_acc=(dia, offs, None, t1, t1, 1.0, 0.0, 0.1),
                shape=(dia, offs, None, t1, acc.t().contiguous(), 1.0, 0.0,
                       0.1),
                dtype=(dia, offs, t0.float(), t1, acc, 1.0, 0.0, 0.1),
                diags=(dia[:, :-1], offs, None, t1, None, 1.0, 0.0, 0.0))
    err, match = dict(ck_without_acc=(ValueError, "c_k must be 0"),
                      t1_is_t0=(ValueError, "distinct"),
                      t1_is_acc=(ValueError, "distinct"),
                      shape=(ValueError, r"\(M, N\)"),
                      dtype=(TypeError, "float64"),
                      diags=(ValueError, "diags"))[case]
    before = t1.clone()
    with pytest.raises(err, match=match):
        port_ck.cheb_step_cm_f64(*args[case])
    assert torch.equal(t1, before)


def test_form_launch_counts_start_at_zero_on_cpu():
    port_ck.reset_launch_counts()
    dia_np, offs = OPERATORS["wide"]()
    t0, t1, acc = _planes(2, 100, 1, torch.float32)
    port_ck.cheb_step_cm_f32(torch.as_tensor(dia_np).float(), offs, None, t1,
                             None, 1.0, 0.0, 0.0)
    counts = port_ck.form_launch_counts()
    assert set(counts) == {"cheb_step_cm_f32", "cheb_step_cm_f64"}
    assert all(c == dict.fromkeys(FORMS, 0) for c in counts.values())


# --------------------------------------------------------- the composite


def _composite_setup(dtype):
    """The consistent-mass pencil at nx = 10 (N = 100): A~, B~ in DIA
    form, f32-representable scalars, the inverse's first eight terms and
    three outer coefficients."""
    nx = 10
    Dx = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(nx, nx))
    Mx = sp.diags([4 / 6, 1 / 6, 1 / 6], [0, 1, -1], shape=(nx, nx))
    B = sp.kron(Mx, Mx).tocoo()
    d = 1.0 / np.sqrt(B.diagonal())
    out = []
    for X in ((sp.kron(Dx, Mx) + sp.kron(Mx, Dx)).tocoo(), B):
        dn, on = bcoo_to_dia(X.data * d[X.row] * d[X.col],
                             np.stack([X.row, X.col], axis=1), nx * nx)
        out += [torch.as_tensor(dn).to(dtype), on]
    scals = dict(sc_C=0.21, sh_C=1.1, scB=2.0 / 2.25, shB=2.7 / 2.25)
    qc = port_cf.cheb_inverse_coeffs(0.225, 2.475, 1e-3)[0][:8]
    coeffs = np.random.default_rng(5).standard_normal(3) * 0.2
    q = torch.as_tensor(np.random.default_rng(6).standard_normal(
        (9, nx * nx))).to(dtype)
    return out, qc, coeffs, scals, q


@pytest.mark.parametrize("inner_steps", [4, 1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_composite_launches_forms_without_t0(monkeypatch, dtype,
                                             inner_steps):
    """Per outer step the composite's y = A~ T1 launch takes the bare form
    and its inner init the bare (fp64) or no_t0 (f32) form; running every
    launch in the full form on explicit zero planes instead (what the
    composite did before it had the forms) gives the same planes bit for
    bit."""
    ops, qc, coeffs, scals, q = _composite_setup(dtype)
    k = port_gen._KERNELS[dtype]
    step, seen = k["step"], []

    def spy(d, o, t0, t1, acc, sc, sh, ck):
        seen.append(port_ck._cm_form(t0, acc))
        return step(d, o, t0, t1, acc, sc, sh, ck)

    def on_zero_planes(d, o, t0, t1, acc, sc, sh, ck):
        t0 = torch.zeros_like(t1) if t0 is None else t0
        acc = torch.zeros_like(t1) if acc is None else acc
        step(d, o, t0, t1, acc, sc, sh, ck)
        return t0

    def run(fn):
        monkeypatch.setitem(k, "step", fn)
        init = port_gen.cheb_gen_init(*ops, qc, q.clone(), coeffs[:2], scals,
                                      inner_steps=inner_steps)
        return port_gen.cheb_gen_chunk(*ops, qc, init, coeffs[2:], scals,
                                       inner_steps=inner_steps)
    got = run(spy)
    inner = "bare" if dtype == torch.float64 else "no_t0"
    assert seen == ["bare", inner] * 2      # the init's step and one more
    want = run(on_zero_planes)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
