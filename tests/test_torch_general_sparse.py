"""PyTorch port: the sparse general / complex-symmetric engine and its
router against the JAX package.

The Krylov contour engine on a general pencil, pinned with
``solver="gmres"``, on the complex stencil of chip_smoke.py's phase 12 cut
to a 20-by-20 grid: A = (1 + i beta) T (x) I + I (x) T with
T = tridiag(-1, 2, -1) and beta = 0.5 (five constant complex diagonals,
non-Hermitian, normal and complex symmetric), whose eigenvalues are
exactly (1 + i beta) mu_j + mu_k with mu_j = 4 sin^2(j pi / 42), and a
circle around the lowest six of them, with fpm[8] = 8 full-contour nodes:
* standard in complex128 (multigrid with two levels), in complex64, under
  forced mixed precision (fpm[42] = 2: complex64 GMRES inside a
  complex128 refinement) and with the transpose pairing
  (``complex_symmetric=True``);
* generalized with a lumped (positive diagonal) B on a 10-by-10 grid (no
  stencil for B: Jacobi);
* a user contour (the same circle as 12 nodes, clockwise, with their
  Cauchy weights) through ``feast_custom_contour``;
and the router: the narrow-banded tridiagonal of
tests/test_sparse_matfree.py::test_gcsrev_general (n = 80) through
``feast_gcsrev``, which both packages hand to their banded engine. Every
case runs in both packages from the same inputs (the JAX package at x64
on the CPU, the port on the CPU with torch on one thread): the same M and
info, eigenvalues within 1e-7 of each other and of the analytic values or
LAPACK (1e-5 max(1, |lam|) in complex64), residuals below the solve's
tolerance, and the engine each port solve entered. Port-only: the Krylov
record names the complex DIA entries (their plain versions run here),
and ``feast_general``'s backend semantics on sparse operands (F2's: a
sharded request on one device warns as the JAX package does, or raises
its RuntimeError under ``strict_backend``; on two ranks a sharded
request and "auto" run ``parallel/pfeast.pfeast_sparse_general``).

The JAX package's solves run once, in three child processes (this file
run as a script), each kept to one core, while the port's run here.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import scipy.linalg as sla  # noqa: E402
import scipy.sparse as sp  # noqa: E402

import feastkit_tpu_torch as ft  # noqa: E402
from feastkit_tpu_torch.core import backend as port_backend  # noqa: E402
from feastkit_tpu_torch.solvers import banded as port_banded  # noqa: E402
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


BETA = 0.5


def stencil(nx, ny, beta=BETA):
    """(A, its eigenvalues): (1 + i beta) T_x (x) I + I (x) T_y on an
    ny-by-nx grid (rows of nx), T = tridiag(-1, 2, -1)."""
    Tx = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(nx, nx))
    Ty = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(ny, ny))
    A = ((1 + 1j * beta) * sp.kron(sp.eye(ny), Tx)
         + sp.kron(Ty, sp.eye(nx))).tocsr()
    mux = 4 * np.sin(np.arange(1, nx + 1) * np.pi / (2 * (nx + 1))) ** 2
    muy = 4 * np.sin(np.arange(1, ny + 1) * np.pi / (2 * (ny + 1))) ** 2
    return A, ((1 + 1j * beta) * mux[None, :] + muy[:, None]).ravel()


def _inside(w, Emid, r):
    return w[np.asarray(ft.feast_inside_gcontour(w, complex(Emid), r))]


def _match_err(got, exp, rel=False):
    from scipy.optimize import linear_sum_assignment
    got, exp = np.asarray(got), np.asarray(exp)
    assert len(got) == len(exp)
    D = np.abs(got[:, None] - exp[None, :])
    if rel:
        D = D / np.maximum(1.0, np.abs(exp))[None, :]
    ri, ci = linear_sum_assignment(D)
    return D[ri, ci].max(initial=0.0)


EMID, R = 0.2, 0.12        # six eigenvalues inside, the nearest outside
#                            9.8% of r from the edge


def case(name):
    """(run(pkg, **extra) -> result, exact eigenvalues, bar, relative)."""
    A, lam = stencil(20, 20)
    exp = _inside(lam, EMID, R)
    slots = {3: 8, 8: 8}

    def fpm_of(pkg, more=None):
        fpm = pkg.feastinit()
        for k, v in {**slots, **(more or {})}.items():
            fpm[k] = v
        return fpm

    if name in ("std_mg", "c64", "mixed", "bilinear"):
        Ac = A.astype(np.complex64) if name == "c64" else A
        more = {42: 2} if name == "mixed" else {}
        kw = dict(complex_symmetric=True) if name == "bilinear" else {}
        return (lambda pkg, **extra: pkg.feast_general(
            Ac, None, EMID, R, 12, fpm_of(pkg, more), solver="gmres",
            **kw, **extra)), exp, 1e-5 if name == "c64" else 1e-7, \
            name == "c64"
    if name == "gen_lumped":
        # Jacobi-preconditioned GMRES converges slowly on a stencil: a
        # 10-by-10 grid and a circle of six eigenvalues, the nearest
        # outside 6% of r from the edge
        A, _ = stencil(10, 10)
        b = 1.0 + 0.5 * np.random.default_rng(3).random(A.shape[0])
        B = sp.diags(b).tocsr()
        w = sla.eig(A.toarray(), np.diag(b), right=False)
        return (lambda pkg, **extra: pkg.feast_general(
            A, B, 0.5, 0.35, 12, fpm_of(pkg), solver="gmres",
            **extra)), _inside(w, 0.5, 0.35), 1e-7, False
    if name == "custom":
        t = -np.linspace(0.0, 2.0 * np.pi, 13)[:-1]
        Z = EMID + R * (np.cos(t) + 1j * np.sin(t))

        def run(pkg, **extra):
            from importlib import import_module
            aux = import_module(pkg.__name__ + ".core.aux")
            return pkg.feast_custom_contour(
                A, None, Z, aux.feast_cauchy_weights(Z), 12, fpm_of(pkg),
                solver="gmres", **extra)
        return run, exp, 1e-7, False
    if name == "narrow80":
        rng = np.random.default_rng(42)
        n = 80
        main = rng.standard_normal(n) + 1j * rng.standard_normal(n)
        up = rng.standard_normal(n - 1)
        An = sp.diags([main, up, 0.5 * np.ones(n - 1)], [0, 1, -1],
                      format="csr")
        w = np.linalg.eigvals(An.toarray())
        ex = _inside(w, w[0], 0.8)
        return (lambda pkg, **extra: pkg.feast_gcsrev(
            An, w[0], 0.8, min(len(ex) + 5, n), **extra)), ex, 1e-7, False
    raise KeyError(name)


CASES = ["std_mg", "c64", "mixed", "bilinear", "gen_lumped", "custom",
         "narrow80"]
# the cases of each child process, about a third of the JAX package's
# compile and run time each (10-16 s a case)
CHILD_CASES = (("std_mg", "c64"), ("mixed", "narrow80"),
               ("bilinear", "gen_lumped", "custom"))


def _write_reference(path, names):
    """The JAX package's solves of the cases ``names``, saved to ``path``
    (a child process's work)."""
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import feastkit_tpu as ref_ft
    from feastkit_tpu.core import backend as ref_backend
    ref_backend._n_devices = lambda: 1
    out = {}
    for name in names:
        r = case(name)[0](ref_ft)
        out.update({f"{name}/M": r.M, f"{name}/info": int(r.info),
                    f"{name}/lam": np.asarray(r.lam),
                    f"{name}/loop": int(r.loop)})
    np.savez(path, **out)


# the JAX package's Krylov solves spend more time running than compiling,
# so the children keep XLA's default compilation (its costly LLVM passes
# switched off)
_COMPILE = "--xla_llvm_disable_expensive_passes=true"

_CHILD = ("import os, runpy, sys; "
          "os.sched_setaffinity(0, {int(c) for c in sys.argv[1].split(',')}); "
          "sys.argv = sys.argv[2:]; runpy.run_path(sys.argv[0], "
          "run_name='__main__')")


def _reference_command(path, child):
    """This file as a script on ``path`` for the cases of
    CHILD_CASES[child], kept to one core of this process's set, the
    eighth, sixth or third from last where there is one (affinity set
    before JAX sizes its thread pools)."""
    args = [__file__, str(path), str(child)]
    if not hasattr(os, "sched_setaffinity"):
        return [sys.executable] + args
    cpus = sorted(os.sched_getaffinity(0))
    back = (8, 6, 3)[child]
    cpu = cpus[-back] if len(cpus) >= back else cpus[-1]
    return [sys.executable, "-c", _CHILD, str(cpu)] + args


# the port's functions whose entry names the engine a solve reached
ENGINES = ((port_sparse, "_make_sparse_solve_all", "krylov"),
           (port_banded, "bcr_factor", "bcr"))


def _spied(mp, log):
    for module, name, engine in ENGINES:
        orig = getattr(module, name)

        def spy(*a, _orig=orig, _engine=engine, **k):
            if _engine not in log:
                log.append(_engine)
            return _orig(*a, **k)
        mp.setattr(module, name, spy)


@pytest.fixture(scope="module")
def solves(tmp_path_factory):
    """(reference, port): the JAX package's results from the children, and
    the port's with the engines each entered."""
    where = tmp_path_factory.mktemp("general_sparse_reference")
    paths = [where / f"ref{i}.npz" for i in range(len(CHILD_CASES))]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (root, os.environ.get("PYTHONPATH")) if p),
        XLA_FLAGS=" ".join(filter(None, (os.environ.get("XLA_FLAGS"),
                                         _COMPILE))))
    children = [subprocess.Popen(_reference_command(path, i), env=env)
                for i, path in enumerate(paths)]
    try:
        port = {}
        for name in CASES:
            log = []
            with pytest.MonkeyPatch.context() as mp:
                _spied(mp, log)
                port[name] = (case(name)[0](ft, device="cpu"), log)
        for child in children:
            assert child.wait(timeout=900) == 0, \
                "the reference solves failed"
    finally:
        for child in children:
            if child.poll() is None:
                child.kill()
                child.wait()
    ref = {}
    for path in paths:
        with np.load(path) as part:
            ref.update(part)
    return ref, port


@pytest.mark.parametrize("name", CASES)
def test_matches_reference(solves, name):
    ref, port = solves
    r, engines = port[name]
    _, exp, bar, rel = case(name)
    assert r.M == int(ref[f"{name}/M"]) == len(exp) > 0
    assert int(r.info) == int(ref[f"{name}/info"]) == 0
    assert _match_err(r.lam, ref[f"{name}/lam"], rel) <= bar
    assert _match_err(r.lam, exp, rel) <= bar
    assert engines == (["bcr"] if name == "narrow80" else ["krylov"])
    assert isinstance(r, ft.FeastGeneralResult)
    assert r.q.is_complex() and tuple(r.q.shape)[1] == r.M
    tol = float(np.sqrt(np.finfo(np.float32).eps)) if name == "c64" else (
        1e-12 if name == "narrow80" else 1e-8)
    assert float(np.max(r.res)) <= tol


def test_krylov_record(solves):
    """The engine's record: multigrid where the stencil takes it (two
    levels on the 20-by-20 grid), Jacobi for the lumped pencil, the full
    contour of fpm[8] = 8 nodes in groups of two, complex work, and the
    DIA launches it implies on the complex entries only (their plain
    versions run here; the card holds the launch counts to the same
    record)."""
    from feastkit_tpu_torch.ops import dia
    port = solves[1]
    for name in ("std_mg", "c64", "mixed", "bilinear", "custom"):
        k = port[name][0].krylov
        assert k["precond"] == "mg" and k["mg_levels"] == 2, name
        assert k["general"] and k["complex"] and not k["hermitian"]
        assert {e["nodes"] for e in k["events"]
                if e["op"] == "gmres"} == {2}
        # fpm[8] = 8 nodes a filter application: four groups of two
        first = [e for e in k["events"] if e["op"] == "gmres"][:4]
        assert len(first) == 4
    assert port["gen_lumped"][0].krylov["precond"] == "jacobi"
    assert port["narrow80"][0].krylov is None
    want = port_sparse.krylov_dia_launches(port["mixed"][0].krylov)
    assert want["dia_matvec_batched_c64"] > 0
    assert want["dia_matvec_batched_c128"] > 0
    assert want["dia_matvec_c128"] > 0
    assert all(want[n] == 0 for n in want if n[-3:] in ("f32", "f64"))
    single = port_sparse.krylov_dia_launches(port["c64"][0].krylov)
    assert single["dia_matvec_batched_c64"] > 0 and single[
        "dia_matvec_c64"] > 0
    assert all(single[n] == 0 for n in single if not n.endswith("c64"))
    assert dia.dia_matvec_batched_c64.launches == 0


def test_general_filter_is_the_full_complex_sum():
    """One application of the engine's filter on the general flags is
    sum_e W_e (z_e - A)^-1 Q over the nodes as given (no mirror, no real
    part), held to dense solves."""
    A, _ = stencil(6, 5)
    N = A.shape[0]
    fpm = ft.feastinit()
    from feastkit_tpu_torch.core.parameters import FeastConfig
    data, idx, _ = port_sparse.sparse_coo_arrays(A, np.complex128)
    forms = port_sparse._structured_forms(data, idx, data, idx, N, True,
                                          np.complex128)
    c = ft.feast_gcontour(0.5 + 0.1j, 0.6, ne=6)
    _, _, filt = port_sparse._sparse_general_ops(
        data, idx, data, idx, forms[0], forms[2], forms[4], forms[5],
        c.Zne, c.Wne, N=N, config=FeastConfig.from_fpm(fpm),
        standard=True, solver="gmres", solver_tol=1e-13,
        solver_maxiter=500, solver_restart=30, offsets_A=forms[1],
        offsets_B=forms[3], precond="none", device=torch.device("cpu"),
        f64=True)
    rng = np.random.default_rng(0)
    Q = rng.standard_normal((N, 3)) + 1j * rng.standard_normal((N, 3))
    got, ok = filt(torch.as_tensor(Q))
    Ad = A.toarray()
    want = sum(w * np.linalg.solve(z * np.eye(N) - Ad, Q)
               for z, w in zip(c.Zne, c.Wne))
    assert bool(ok) and got.dtype == torch.complex128
    assert np.abs(got.numpy() - want).max() <= 1e-10 * np.abs(want).max()


def test_one_device_sharded_request_matches_reference(monkeypatch):
    """F2's semantics on a sparse general problem: on one device a sharded
    request warns as the JAX package does and runs serially, or raises its
    RuntimeError under strict_backend; "auto" stays serial."""
    import feastkit_tpu as ref_ft
    from feastkit_tpu.core import backend as ref_backend
    from feastkit_tpu.solvers import sparse as ref_sparse
    An = sp.diags([np.arange(1.0, 41.0) * (1 + 0.5j)], [0], format="csr")
    monkeypatch.setattr(ref_backend, "_n_devices", lambda: 1)
    monkeypatch.setattr(port_backend, "_n_devices", lambda device: 1)
    # the JAX package's driver is not run: only its selection is held
    monkeypatch.setattr(ref_sparse, "sparse_feast_general",
                        lambda *a, **k: "serial solve")
    for kw in (dict(parallel=True), dict(backend="sharded"),
               dict(backend="mpi")):
        with pytest.warns(UserWarning) as w_ref:
            assert ref_ft.feast_general(An, None, 3.0 + 1.5j, 1.2, 6,
                                        **kw) == "serial solve"
        with pytest.warns(UserWarning) as w_port:
            r = ft.feast_general(An, None, 3.0 + 1.5j, 1.2, 6, device="cpu",
                                 **kw)
        assert [str(x.message) for x in w_port] == \
            [str(x.message) for x in w_ref]
        assert r.M == 3 and int(r.info) == 0
        with pytest.raises(RuntimeError) as e_ref:
            ref_ft.feast_general(An, None, 3.0 + 1.5j, 1.2, 6,
                                 strict_backend=True, **kw)
        with pytest.raises(RuntimeError) as e_port:
            ft.feast_general(An, None, 3.0 + 1.5j, 1.2, 6,
                             strict_backend=True, device="cpu", **kw)
        assert str(e_port.value).split(". ")[0] == \
            str(e_ref.value).split(". ")[0]
    assert ft.feast_general(An, None, 3.0 + 1.5j, 1.2, 6, device="cpu").M == 3


def test_two_devices_refuse_the_sharded_backend(monkeypatch):
    """On two or more ranks a sparse general problem runs
    ``parallel/pfeast.pfeast_sparse_general`` under a sharded request and
    under "auto" (no longer refused)."""
    from feastkit_tpu_torch.parallel import pfeast as port_pf
    monkeypatch.setattr(port_backend, "_n_devices", lambda device=None: 2)
    seen = []
    monkeypatch.setattr(
        port_pf, "pfeast_sparse_general", lambda *a, **k: seen.append(
            (str(k.get("device")), k.get("bilinear")))
        or "pfeast_sparse_general")
    An = sp.diags([np.arange(1.0, 41.0) * (1 + 0.5j)], [0], format="csr")
    for kw in (dict(parallel=True), dict(backend="sharded"), {},
               dict(strict_backend=True)):
        assert ft.feast_general(An, None, 3.0 + 1.5j, 1.2, 6, device="cpu",
                                **kw) == "pfeast_sparse_general"
    assert seen == [("cpu", False)] * 4
    assert ft.feast_general(An, None, 3.0 + 1.5j, 1.2, 6, parallel=False,
                            device="cpu").M == 3


def test_unported_modes_and_validation():
    A, _ = stencil(20, 20)
    fpm = ft.feastinit()
    fpm[14] = 2
    fpm[32] = 8
    # the stochastic count is ported: six eigenvalues inside
    r = ft.feast_gcsrev(A, EMID, R, 12, fpm, solver="gmres", device="cpu")
    assert r.lam.size == 0 and r.M == max(int(round(r.epsout)), 0)
    assert abs(r.epsout - 6.0) <= 5.0
    with pytest.raises(ValueError, match="M0 must be in"):
        ft.feast_gcsrev(A, EMID, R, 401, device="cpu")
    with pytest.raises(ValueError, match="radius"):
        ft.feast_gcsrev(A, EMID, 0.0, 12, device="cpu")
    with pytest.raises(ValueError, match="CG is not valid"):
        ft.feast_gcsrev(A, EMID, R, 12, solver="cg", device="cpu")


def test_polynomial_sparse_coefficients():
    """feast_scsrpev densifies sparse coefficients onto the companion
    route: the dense coefficients' eigenvalues, and LAPACK's."""
    rng = np.random.default_rng(42)
    n = 16
    M = np.eye(n) + 0.1 * rng.standard_normal((n, n))
    C = 0.3 * rng.standard_normal((n, n))
    K = rng.standard_normal((n, n))
    w = sla.eig(np.block([[np.zeros((n, n)), np.eye(n)], [-K, -C]]),
                np.block([[np.eye(n), np.zeros((n, n))],
                          [np.zeros((n, n)), M]]), right=False)
    exp = _inside(w, 0.0, 1.0)
    M0 = min(len(exp) + 6, 2 * n)
    r = ft.feast_scsrpev([sp.csr_matrix(K), sp.csr_matrix(C),
                          sp.csr_matrix(M)], 0.0, 1.0, M0, device="cpu")
    d = ft.feast_pep([K, C, M], 0.0, 1.0, M0, device="cpu")
    assert r.M == d.M == len(exp) > 0 and int(r.info) == 0
    assert np.array_equal(r.lam, d.lam)
    assert _match_err(r.lam, exp) <= 1e-7


if __name__ == "__main__":
    _write_reference(sys.argv[1], CHILD_CASES[int(sys.argv[2])])
