"""PyTorch port: the Krylov contour engine's modules against the JAX package.

* ``ops/gmres.py``: ``gmres_block`` and ``bicgstab_block`` against the JAX
  package's on the same shifted 2D Laplacian and right-hand sides, with
  Jacobi and with the V-cycle, in complex128 and complex64; both certify,
  and the two solutions differ by at most what two certified solutions
  may (see ``_solution_bound``). A group of g = 2 nodes in one batched
  call against two single calls (1e-12: the same arithmetic per node).
* ``ops/multigrid.py``: the host decisions (``detect_grid_stencil``,
  ``plan_mg_levels``, ``_guess_grid``, ``_structured_forms``,
  ``_plan_mg``) are identical, ``coarsen_stencil`` agrees to 1e-14, and
  ``make_shifted_vcycle`` agrees to 1e-5 in complex64 and 1e-12 in
  complex128 (relative to max|y|).
* ``solvers/sparse._sparse_ops``: one filter application against the JAX
  package's ``_sparse_filter_jit`` with the same statics, in complex128
  (fpm[42] = 0) and mixed precision (fpm[42] = 2: the port's complex128
  refinement against the JAX package's (re, im) pair filter).
Inputs come from numpy seeds; the port runs on the CPU. The JAX package's
solves, V-cycles and filters run once, in a child process (this file run as
a script) that keeps its threads to two cores, so that the suite's parallel
workers keep theirs; the host-side decisions are compared in process.
"""
import os
import subprocess
import sys
import warnings

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import scipy.sparse as sp  # noqa: E402

from feastkit_tpu.ops import gmres as ref_gmres  # noqa: E402
from feastkit_tpu.ops import multigrid as ref_mg  # noqa: E402
from feastkit_tpu.solvers import sparse as ref_sparse  # noqa: E402
from feastkit_tpu_torch import convert  # noqa: E402
from feastkit_tpu_torch.ops import gmres as port_gmres  # noqa: E402
from feastkit_tpu_torch.ops import multigrid as port_mg  # noqa: E402
from feastkit_tpu_torch.ops.dia import bcoo_to_dia, dia_matvec_any  # noqa: E402
from feastkit_tpu_torch.solvers import sparse as port_sparse  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the suite runs files in parallel worker processes on a few cores;
    # torch's default intra-op pool would starve its neighbours
    # numpy's and scipy's OpenBLAS pools (a spinning thread per core
    # each) would too, and worse: beside busy cores a small SVD runs
    # hundreds of times slower on them than on one thread
    from threadpoolctl import threadpool_limits
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(limits=1, user_api="blas"):
        yield
    torch.set_num_threads(n)


# A child process that keeps to the last two cores of this process's set:
# the suite runs test files in parallel workers, and the JAX package sizes
# its thread pools by the cores it may use when it is imported, so the
# affinity is set before anything else is.
_CHILD = ("import os, runpy, sys; "
          "os.sched_setaffinity(0, {int(c) for c in sys.argv[1].split(',')}); "
          "sys.argv = sys.argv[2:]; runpy.run_path(sys.argv[0], "
          "run_name='__main__')")


def _reference_command(path):
    """The command that runs this file as a script on ``path``."""
    if not hasattr(os, "sched_setaffinity"):
        return [sys.executable, __file__, str(path)]
    cpus = ",".join(str(c) for c in sorted(os.sched_getaffinity(0))[-2:])
    return [sys.executable, "-c", _CHILD, cpus, __file__, str(path)]


def _lap(*grid):
    """Constant-coefficient Laplacian on a 1-, 2- or 3-D grid (row-major)."""
    out = None
    for k, n in enumerate(grid):
        D = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(n, n))
        term = sp.kron(sp.kron(sp.eye(int(np.prod(grid[:k]))), D),
                       sp.eye(int(np.prod(grid[k + 1:]))))
        out = term if out is None else out + term
    return out.tocsr()


def _consistent_mass(n):
    """A = Dx (x) Mx + Mx (x) Dx, B = Mx (x) Mx, Mx = (1/6)[1 4 1]: the
    consistent-mass pencil of scripts/scale_sparse_gen.py (nine diagonals
    each, both grid stencils)."""
    Dx = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(n, n))
    Mx = sp.diags([1 / 6, 4 / 6, 1 / 6], [-1, 0, 1], shape=(n, n))
    return (sp.kron(Dx, Mx) + sp.kron(Mx, Dx)).tocsr(), sp.kron(Mx, Mx).tocsr()


def _coo(A):
    c = A.tocoo()
    return c.data, np.stack([c.row, c.col], 1).astype(np.int32)


def _dia(A):
    data, idx = _coo(A)
    return bcoo_to_dia(data, idx, A.shape[0])


# ------------------------------------------------------------ solvers

NX = 16
# a node near the low end of the spectrum (where the V-cycle is needed),
# and one farther out, where Jacobi preconditioning alone converges
ZS = {"mg": complex(0.6, 0.05), "jacobi": complex(2.0, 1.0)}
Z = ZS["mg"]


def _problem(dtype, K=4, seed=3):
    A = _lap(NX, NX)
    d, offs = _dia(A)
    rng = np.random.default_rng(seed)
    rhs = (rng.standard_normal((NX * NX, K))
           + 1j * rng.standard_normal((NX * NX, K))).astype(dtype)
    return A, d, offs, rhs


def _ref_ops(d, offs, z, dtype, prec, stA):
    """The shifted operator and preconditioner in the JAX package."""
    rdt = np.float32 if dtype == np.complex64 else np.float64
    dj, zj = jnp.asarray(d.astype(rdt)), np.asarray(z, dtype)

    def op(X):
        return zj * X - ref_sparse.dia_matvec_any(dj, X, offs,
                                                  use_pallas=False)
    if prec == "jacobi":
        dj_s = zj - jnp.asarray(d[list(offs).index(0)].astype(rdt))
        return op, lambda X: X / dj_s[:, None]
    jd = jnp.complex64 if dtype == np.complex64 else jnp.complex128
    return op, ref_mg.make_shifted_vcycle(stA, None, z, dtype=jd)


def _port_ops(d, offs, z, dtype, prec, stA):
    """The same operator and preconditioner in the port."""
    rdt = np.float32 if dtype == np.complex64 else np.float64
    td = torch.complex64 if dtype == np.complex64 else torch.complex128
    dt, zt = torch.as_tensor(d.astype(rdt)), torch.tensor(z, dtype=td)

    def op(X):
        return zt * X - dia_matvec_any(dt, offs, X.contiguous())
    if prec == "jacobi":
        dt_s = zt - torch.as_tensor(d[list(offs).index(0)].astype(rdt))
        return op, lambda X: X / dt_s[..., :, None]
    return op, port_mg.make_shifted_vcycle(
        convert.stencil_from_reference(stA), None, z, dtype=td)


SOLVER_CASES = [(solver, prec, dtype, tol)
                for solver in ("gmres", "bicgstab")
                for prec in ("jacobi", "mg")
                for dtype, tol in (("complex128", 1e-10),
                                   ("complex64", 2e-5))]


def _solver_kw(solver, tol):
    kw = dict(tol=tol, maxiter=400)
    if solver == "gmres":
        kw["restart"] = 20
    return kw


def _reference_solver(solver, prec, dtype, tol):
    """The JAX package's solution and whether every column certified."""
    dtype = np.dtype(dtype).type
    _, d, offs, rhs = _problem(dtype)
    stA = ref_mg.detect_grid_stencil(d, offs, (NX, NX))
    op, prec_fn = _ref_ops(d, offs, ZS[prec], dtype, prec, stA)
    X, info = getattr(ref_gmres, f"{solver}_block")(
        op, jnp.asarray(rhs), apply_prec=prec_fn, **_solver_kw(solver, tol))
    return {"X": np.asarray(X), "ok": np.all(np.asarray(info.converged))}


def _solution_bound(A, z, rhs, tol, X):
    """Two solutions that each certify ||b - S x|| <= 10 tol max(|b|, 1)
    per column differ by at most 2 * 10 tol max(|b|, 1) / sigma_min(S)
    (S = z I - A); returned relative to max|x|."""
    S = z * np.eye(A.shape[0]) - A.toarray()
    smin = np.linalg.svd(S, compute_uv=False)[-1]
    b = np.maximum(np.linalg.norm(rhs, axis=0), 1.0).max()
    return 20.0 * tol * b / smin / np.abs(X).max()


@pytest.mark.parametrize("solver,prec,dtype,tol", SOLVER_CASES)
def test_solver_matches_reference(references, solver, prec, dtype, tol):
    key = _key("solver", solver, prec, dtype)
    dtype = np.dtype(dtype).type
    A, d, offs, rhs = _problem(dtype)
    stA = ref_mg.detect_grid_stencil(d, offs, (NX, NX))
    z = ZS[prec]
    port_op, port_prec = _port_ops(d, offs, z, dtype, prec, stA)
    Xp, ip = getattr(port_gmres, f"{solver}_block")(
        port_op, torch.as_tensor(rhs), apply_prec=port_prec,
        **_solver_kw(solver, tol))
    Xr, Xp = references[f"{key}.X"], Xp.numpy()
    assert Xp.dtype == dtype and Xp.shape == rhs.shape
    assert bool(references[f"{key}.ok"]) and bool(ip.converged.all())
    assert ip.trips >= 1
    bound = _solution_bound(A, z, rhs, tol, Xr)
    assert np.abs(Xp - Xr).max() / np.abs(Xr).max() <= bound
    # the true residual the port reports is its own
    R = rhs - (z * Xp - A @ Xp)
    assert np.allclose(np.linalg.norm(R, axis=0), ip.residual.numpy(),
                       rtol=1e-3, atol=10 * tol)


@pytest.mark.parametrize("prec", ["jacobi", "mg"])
@pytest.mark.parametrize("solver", ["gmres", "bicgstab"])
def test_node_group_matches_single_calls(solver, prec):
    # two nodes in one batched call (each with its own shift and
    # preconditioner) against one call per node: the same arithmetic per
    # node, and each node keeps its own exit flags
    A, d, offs, rhs = _problem(np.complex128, K=3)
    zs = np.array([Z, complex(2.1, 0.4)])
    stA = convert.stencil_from_reference(
        ref_mg.detect_grid_stencil(d, offs, (NX, NX)))
    dt = torch.as_tensor(d)
    diag = torch.as_tensor(d[list(offs).index(0)])
    zt = torch.as_tensor(zs)

    def op(X):           # (g, N, K): node b applies z_b
        zz = zt if X.dim() == 3 else zt[:1]
        return zz[:, None, None] * X - dia_matvec_any(dt, offs, X.contiguous())

    def make_prec(z):
        if prec == "mg":
            return port_mg.make_shifted_vcycle(stA, None, z,
                                               dtype=torch.complex128)
        return lambda X: X / (z[..., None, None] - diag[:, None])

    fn = getattr(port_gmres, f"{solver}_block")
    kw = dict(tol=1e-10, maxiter=400)
    if solver == "gmres":
        kw["restart"] = 20
    b = torch.as_tensor(rhs)
    Xg, ig = fn(op, b.expand(2, *b.shape), apply_prec=make_prec(zt), **kw)
    for i in range(2):
        zi = zt[i:i + 1]

        def op1(X, zi=zi):
            return zi[:, None, None] * X - dia_matvec_any(dt, offs,
                                                          X.contiguous())
        X1, i1 = fn(op1, b[None], apply_prec=make_prec(zi), **kw)
        assert torch.equal(ig.converged[i], i1.converged[0])
        assert int(ig.iterations[i]) == int(i1.iterations[0])
        err = float((Xg[i] - X1[0]).abs().max() / X1[0].abs().max())
        assert err <= 1e-12, (i, err)


def test_hessenberg_lstsq_zero_and_rank_deficient():
    # all-zero H (a done or zero-padded column) gives a zero, finite step
    H = torch.zeros(1, 2, 4, 3, dtype=torch.complex64)
    H[0, 1, :3, :3] = torch.eye(3)
    H[0, 1, 2, 2] = 0                  # rank deficient
    y = port_gmres._hessenberg_lstsq(H, torch.tensor([[1.0, 2.0]]))
    assert bool(torch.isfinite(y).all())
    assert bool((y[0, 0] == 0).all())
    ref = np.asarray(jnp.linalg.lstsq(jnp.asarray(H[0, 1].numpy()),
                                      jnp.asarray([2.0, 0, 0, 0],
                                                  jnp.complex64))[0])
    assert np.abs(y[0, 1].numpy() - ref).max() <= 1e-6


# --------------------------------------------------------- multigrid

def _fixtures():
    A2 = _lap(32, 32)
    Ar = _lap(8, 8).tolil()
    for i in range(64):
        Ar[i, i] = 4.0 + 0.1 * i               # variable: not a stencil
    return {
        "lap2d": (A2, None, None),
        "lap2d_grid": (A2, None, (32, 32)),
        "mass2d": _consistent_mass(16) + (None,),
        "lap3d": (_lap(6, 7, 8), None, None),
        "lap1d": (_lap(50), None, None),
        "variable": (Ar.tocsr(), None, None),
        "wrong_grid": (_lap(12, 10), None, (10, 12)),
    }


FIXTURES = list(_fixtures())


@pytest.mark.parametrize("name", FIXTURES)
def test_structured_forms_and_plan_identical(name):
    A, B, grid = _fixtures()[name]
    N = A.shape[0]
    a_data, a_idx = _coo(A)
    standard = B is None
    b_data, b_idx = (a_data, a_idx) if standard else _coo(B)
    ref = ref_sparse._structured_forms(a_data, a_idx, b_data, b_idx, N,
                                       standard, np.float64, grid=grid)
    got = port_sparse._structured_forms(a_data, a_idx, b_data, b_idx, N,
                                        standard, np.float64, grid=grid)
    ref = ref[:6] + ref[7:]                      # drop use_pallas
    for r, p in zip(ref, got):
        if isinstance(r, np.ndarray):
            assert r.dtype == p.dtype and np.array_equal(r, p)
        else:
            assert r == p
    assert ref_sparse._guess_grid(ref[1], N) == \
        port_sparse._guess_grid(got[1], N)
    for re_max in (0.05, 0.5, 3.0, 9.0):
        for user in (None, "mg", "jacobi"):
            with warnings.catch_warnings(record=True) as wr:
                warnings.simplefilter("always")
                r = ref_sparse._plan_mg(ref[7], ref[8], re_max, ref[6], user)
            with warnings.catch_warnings(record=True) as wp:
                warnings.simplefilter("always")
                p = port_sparse._plan_mg(got[7], got[8], re_max, got[6],
                                         user)
            assert r == p, (re_max, user)
            assert [str(w.message) for w in wr] == \
                [str(w.message) for w in wp]


def _stencils():
    out = {}
    for name in ("lap2d", "mass2d", "lap3d", "lap1d"):
        A, B, _ = _fixtures()[name]
        N = A.shape[0]
        d, offs = _dia(A)
        for cand in ref_sparse._guess_grid(offs, N):
            st = ref_mg.detect_grid_stencil(d, offs, cand)
            if st is not None:
                stB = None if B is None else ref_mg.detect_grid_stencil(
                    *_dia(B), cand)
                out[name] = (st, stB, cand, A, B)
                break
    return out


@pytest.mark.parametrize("name", ["lap2d", "mass2d", "lap3d", "lap1d"])
def test_stencil_detection_and_coarsening(name):
    st_r, stB_r, grid, A, B = _stencils()[name]
    d, offs = _dia(A)
    st_p = port_mg.detect_grid_stencil(d, offs, grid)
    assert np.array_equal(st_p.disps, st_r.disps) \
        and np.array_equal(st_p.coeffs, st_r.coeffs) and st_p.grid == st_r.grid
    assert np.array_equal(port_mg.stencil_to_dense(st_p),
                          ref_mg.stencil_to_dense(st_r))
    for _ in range(3):
        st_r, st_p = ref_mg.coarsen_stencil(st_r), \
            port_mg.coarsen_stencil(st_p)
        assert np.array_equal(st_p.disps, st_r.disps) \
            and st_p.grid == st_r.grid
        assert np.abs(st_p.coeffs - st_r.coeffs).max() <= 1e-14
        if min(st_r.grid) < 5:
            break
    st_r, _, _, _, _ = _stencils()[name]
    st_p = convert.stencil_from_reference(st_r)
    stB_p = None if stB_r is None else convert.stencil_from_reference(stB_r)
    for re_max in (0.05, 0.5, 3.0, 9.0):
        assert port_mg.plan_mg_levels(st_p, stB_p, re_max) == \
            ref_mg.plan_mg_levels(st_r, stB_r, re_max)


VCYCLE_CASES = [(name, dtype, tol) for name in ("lap2d", "mass2d", "lap3d")
                for dtype, tol in (("complex64", 1e-5), ("complex128", 1e-12))]
VCYCLE_Z, VCYCLE_LEVELS = complex(0.4, 0.25), 3


def _vcycle_input(N, dtype):
    rng = np.random.default_rng(7)
    return (rng.standard_normal((N, 3))
            + 1j * rng.standard_normal((N, 3))).astype(dtype)


def _reference_vcycle(name, dtype):
    st_r, stB_r, _, A, _ = _stencils()[name]
    # jitted: the reference's eager V-cycle dispatches hundreds of small
    # programs
    vc = jax.jit(ref_mg.make_shifted_vcycle(
        st_r, stB_r, VCYCLE_Z, dtype=getattr(jnp, dtype),
        n_levels=VCYCLE_LEVELS))
    return {"y": np.asarray(vc(jnp.asarray(_vcycle_input(A.shape[0],
                                                          dtype))))}


@pytest.mark.parametrize("name,dtype,tol", VCYCLE_CASES)
def test_vcycle_matches_reference(references, name, dtype, tol):
    st_r, stB_r, grid, A, _ = _stencils()[name]
    z, n_levels = VCYCLE_Z, VCYCLE_LEVELS
    X = _vcycle_input(A.shape[0], dtype)
    ref = references[f"{_key('vcycle', name, dtype)}.y"]
    vc = port_mg.make_shifted_vcycle(
        convert.stencil_from_reference(st_r),
        None if stB_r is None else convert.stencil_from_reference(stB_r),
        z, dtype=getattr(torch, dtype), n_levels=n_levels)
    got = vc(torch.as_tensor(X))
    assert got.dtype == getattr(torch, dtype) and got.shape == X.shape
    assert np.abs(got.numpy() - ref).max() <= tol * np.abs(ref).max()
    # per-node shifts over a (g, N, K) operand: each node as alone
    zs = np.array([z, complex(1.5, 0.1)])
    vg = port_mg.make_shifted_vcycle(
        convert.stencil_from_reference(st_r),
        None if stB_r is None else convert.stencil_from_reference(stB_r),
        zs, dtype=getattr(torch, dtype), n_levels=n_levels)
    Xg = torch.as_tensor(np.stack([X, X[:, ::-1].copy()]))
    out = vg(Xg)
    for i in range(2):
        one = port_mg.make_shifted_vcycle(
            convert.stencil_from_reference(st_r),
            None if stB_r is None else convert.stencil_from_reference(stB_r),
            zs[i], dtype=getattr(torch, dtype), n_levels=n_levels)(Xg[i])
        assert float((out[i] - one).abs().max()) <= tol * float(
            one.abs().max())


def test_stencil_conv_switch_is_refused(references, monkeypatch):
    """FEAST_STENCIL_CONV=1 is no longer refused: the complex64 V-cycle of
    lap2d runs its stencil products as convolutions and agrees with the
    JAX package's shifted-add V-cycle within the complex64 bar."""
    st_r, _, _, A, _ = _stencils()["lap2d"]
    monkeypatch.setenv("FEAST_STENCIL_CONV", "1")
    calls = []
    conv = port_mg._stencil_conv
    monkeypatch.setattr(port_mg, "_stencil_conv",
                        lambda *a: calls.append(1) or conv(*a))
    got = port_mg.make_shifted_vcycle(
        convert.stencil_from_reference(st_r), None, VCYCLE_Z,
        dtype=torch.complex64, n_levels=VCYCLE_LEVELS)(torch.as_tensor(
            _vcycle_input(A.shape[0], "complex64")))
    ref = references[f"{_key('vcycle', 'lap2d', 'complex64')}.y"]
    assert calls
    assert np.abs(got.numpy() - ref).max() <= 1e-5 * np.abs(ref).max()


# ---------------------------------------------------------- the filter

FILTER_TOL = 1e-10


def _filter_case(mixed):
    """The filter's inputs, the JAX package's host decisions and statics
    (numpy host code) for fpm[42] = ``mixed``."""
    from feastkit_tpu import feastinit as ref_feastinit
    from feastkit_tpu.core.contour import feast_contour as ref_contour
    from feastkit_tpu.core.parameters import FeastConfig as RefConfig
    A = _lap(NX, NX)
    N = A.shape[0]
    Emin, Emax = 0.05, 0.6
    fpm = ref_feastinit()
    fpm[3] = 8
    fpm[42] = mixed
    a_data, a_idx = _coo(A)
    forms = ref_sparse._structured_forms(a_data, a_idx, a_data, a_idx, N,
                                         True, np.float64)
    (A_dia, offs, B_dia, offs_B, diagA, diagB, _, pre, mg_A, mg_B) = forms
    precond, mg_A, mg_B = ref_sparse._plan_mg(mg_A, mg_B, Emax, pre, None)
    contour = ref_contour(Emin, Emax, fpm)
    statics = dict(shape=(N, N),
                   config=RefConfig.from_fpm(fpm, dtype=np.complex128),
                   standard=True, hermitian=False, solver="gmres",
                   solver_tol=FILTER_TOL, solver_maxiter=500,
                   solver_restart=30, offsets_A=offs, offsets_B=offs_B,
                   use_pallas=False, precond=precond, mg_A=mg_A, mg_B=mg_B)
    arrs = (a_data, a_idx, a_data, a_idx, A_dia, B_dia, diagA, diagB,
            np.real(contour.Zne), np.imag(contour.Zne),
            np.real(contour.Wne), np.imag(contour.Wne))
    V = np.random.default_rng(4).standard_normal((N, 6))
    return A, fpm, contour, statics, arrs, V


def _reference_filter(mixed):
    _, _, _, statics, arrs, V = _filter_case(mixed)
    return {"y": np.asarray(ref_sparse._sparse_filter_jit(*arrs, V,
                                                           **statics))}


@pytest.mark.parametrize("mixed", [0, 2])
def test_filter_apply_matches_reference(references, mixed):
    from feastkit_tpu_torch.core.parameters import FeastConfig
    A, fpm, contour, statics, arrs, V = _filter_case(mixed)
    N = A.shape[0]
    a_data, a_idx, _, _, A_dia, B_dia, diagA, diagB = arrs[:8]
    offs, offs_B = statics["offsets_A"], statics["offsets_B"]
    precond, mg_A, mg_B = statics["precond"], statics["mg_A"], statics["mg_B"]
    assert precond == "mg"
    solver_tol = FILTER_TOL
    ref = references[f"{_key('filter', mixed)}.y"]
    cfg_p = FeastConfig.from_fpm(convert.fpm_from_reference(fpm),
                                 dtype=np.complex128)
    record = []
    _, _, filt = port_sparse._sparse_ops(
        a_data, a_idx, a_data, a_idx, A_dia, B_dia, diagA, diagB,
        contour.Zne, contour.Wne, N=N, config=cfg_p, standard=True,
        solver="gmres", solver_tol=solver_tol, solver_maxiter=500,
        solver_restart=30, offsets_A=offs, offsets_B=offs_B,
        precond=precond, mg_A=mg_A, mg_B=mg_B, device=torch.device("cpu"),
        f64=True, record=record)
    got, ok = filt(torch.as_tensor(V))
    assert bool(ok) and got.dtype == torch.float64
    got = got.numpy()
    # each node's solve certifies 10 tol max(|b|,1) (the mixed one through
    # its refinement); the filter sums 2 Re W_e X_e, so two filters differ
    # by at most sum_e 2 |W_e| * 2 * 10 tol max|b| / sigma_min(z_e - A)
    Ad = A.toarray()
    b = max(np.linalg.norm(V, axis=0).max(), 1.0)
    bound = sum(2 * abs(w) * 20 * solver_tol * b / np.linalg.svd(
        z * np.eye(N) - Ad, compute_uv=False)[-1]
        for z, w in zip(contour.Zne, contour.Wne))
    assert np.abs(got - ref).max() <= bound, (np.abs(got - ref).max(), bound)
    ops = {e["op"] for e in record}
    assert ops == ({"gmres"} if mixed == 0 else {"gmres", "shift"})
    # the default node groups: four groups of two nodes
    assert {e["nodes"] for e in record} == {2}


# ----------------------------------------------- the JAX package's results

def _key(*parts):
    return "-".join(str(p) for p in parts)


def _write_references(path):
    """Every JAX-package result the tests above compare with, saved to
    ``path`` (the child process's work)."""
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    out = {}
    for key, fn, args in (
            [(_key("solver", s, p, d), _reference_solver,
              (s, p, d, t)) for s, p, d, t in SOLVER_CASES]
            + [(_key("vcycle", n, d), _reference_vcycle, (n, d))
               for n, d, _ in VCYCLE_CASES]
            + [(_key("filter", m), _reference_filter, (m,)) for m in (0, 2)]):
        for name, value in fn(*args).items():
            out[f"{key}.{name}"] = value
    np.savez(path, **out)


@pytest.fixture(scope="module")
def references(tmp_path_factory):
    """The JAX package's results, computed once in a child process that
    keeps to two cores."""
    path = tmp_path_factory.mktemp("krylov_references") / "references.npz"
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (root, os.environ.get("PYTHONPATH")) if p))
    subprocess.run(_reference_command(path), env=env,
                   check=True, timeout=900)
    with np.load(path) as ref:
        return dict(ref)


if __name__ == "__main__":
    _write_references(sys.argv[1])
