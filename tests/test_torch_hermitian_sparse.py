"""PyTorch port: complex Hermitian sparse pencils against the JAX package.

The same seeded inputs go through both packages on the CPU (the JAX
package in x64, both with fpm[42] = 2, the mixed-precision ladder), and the
port must give the JAX package's M and info and its eigenvalues within
1e-8 (1e-9 where the pencil is handed to the dense or banded engine), and
the analytic or LAPACK eigenvalues to the same bar:
* the 2D Laplacian under a seeded diagonal unitary gauge D A D^*
  (``gauge``: five complex diagonals, the Laplacian's spectrum exactly) at
  nx = 16 with ``solver="cheb"`` and ``"contour_poly"`` (the fused
  complex one-step entries on both rungs), through the auto route at nx = 32
  (the polynomial route), and the real Laplacian declared
  ``hermitian=True`` (complex work precision);
* ``feast_hcsrgv`` with a positive diagonal B (the congruence, complex
  back-transform);
* the Krylov engine on Hermitian pencils: the Laplacian on a 32-by-8
  grid with a uniform phase on its +-1 bonds (a constant complex stencil:
  multigrid) and a randomly gauged, shifted one (Jacobi);
* F3: the crowded Hermitian tridiagonal of
  tests/test_sparse_matfree.py::test_narrow_band_crowded_hermitian_spectrum
  (n = 240) through ``feast_hcsrev``, which the JAX package hands to its
  banded engine before it looks at the dtype;
* the densify fallback: the gauged nx = 20 Laplacian under
  ``FEAST_CHEB_DEGREE=4`` (off the polynomial route) onto the dense engine;
* ``feast_hbev`` at N = 4096 (a Hermitian band with ten spikes, the
  interval around them): the banded driver's polynomial route.
Each port solve records the engines it entered. The JAX package's solves
run once, in two child processes (this file run as a script), each kept
to one core and compiled without LLVM's costly passes: the Krylov and
banded engines' cases in one, the polynomial path's in the other, while
the port's run here on one torch thread.
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
from feastkit_tpu_torch.solvers import banded as port_banded  # noqa: E402
from feastkit_tpu_torch.solvers import dense as port_dense  # noqa: E402
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


def lap2d(nx, ny=None):
    """The five-point Laplacian on an ny-by-nx grid (rows of nx)."""
    ny = nx if ny is None else ny
    Dx = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(nx, nx))
    Dy = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(ny, ny))
    return (sp.kron(Dy, sp.eye(nx)) + sp.kron(sp.eye(ny), Dx)).tocsr()


def gauge(A, theta):
    """D A D^* with D = diag(exp(i theta)): A's spectrum, complex entries."""
    C = A.tocoo()
    data = C.data * np.exp(1j * (theta[C.row] - theta[C.col]))
    return sp.csr_matrix((data, (C.row, C.col)), shape=A.shape)


def random_gauge(nx, seed):
    N = nx * nx
    return gauge(lap2d(nx), np.random.default_rng(seed).uniform(
        0.0, 2.0 * np.pi, N))


def lowest(w, count):
    """(Emin, Emax, expected): about the lowest ``count`` eigenvalues, Emax
    at a gap of the spectrum."""
    w = np.sort(w)
    gaps = np.nonzero(np.diff(w) > 1e-10)[0]
    hi = gaps[np.searchsorted(gaps, count)]
    Emin, Emax = float(w[0] - 0.5 * abs(w[0]) - 1e-3), \
        float(0.5 * (w[hi] + w[hi + 1]))
    return Emin, Emax, w[(w >= Emin) & (w <= Emax)]


def hermitian_band(n, kd, seed):
    """A seeded Hermitian band (half bandwidth kd) with ten diagonal spikes
    in [20, 22] above its bulk, in band storage."""
    rng = np.random.default_rng(seed)
    bands = np.zeros((2 * kd + 1, n), complex)
    for d in range(1, kd + 1):
        v = (rng.standard_normal(n - d) + 1j * rng.standard_normal(n - d)) \
            * 0.3
        bands[kd - d, d:] = v
        bands[kd + d, :n - d] = np.conj(v)
    bands[kd] = 2 * kd + rng.standard_normal(n) * 0.4
    bands[kd, rng.choice(n, 10, replace=False)] = np.linspace(20.0, 22.0, 10)
    return bands


def f3_fixture():
    n = 240
    d = np.linspace(-1.0, 1.0, n)
    return sp.diags([np.full(n - 1, 0.08 - 0.05j), d.astype(complex),
                     np.full(n - 1, 0.08 + 0.05j)], [-1, 0, 1]).tocsr()


class _env:
    """Set (or, with None, unset) environment variables for a block."""

    def __init__(self, **env):
        self.env, self.saved = env, {}

    def __enter__(self):
        for k, v in self.env.items():
            self.saved[k] = os.environ.pop(k, None)
            if v is not None:
                os.environ[k] = v

    def __exit__(self, *exc):
        for k, v in self.saved.items():
            os.environ.pop(k, None)
            if v is not None:
                os.environ[k] = v


def _fpm(pkg, tol=8):
    fpm = pkg.feastinit()
    fpm[3] = tol
    fpm[42] = 2
    return fpm


def case(name):
    """(run(pkg, **extra) -> result, exact eigenvalues, bar) of a case."""
    if name in ("cheb16", "poly16", "herm_real16"):
        A = lap2d(16) if name == "herm_real16" else random_gauge(16, 3)
        Emin, Emax, exp = lowest(np.linalg.eigvalsh(lap2d(16).toarray()), 10)
        kw = {"cheb16": dict(solver="cheb"), "poly16": dict(
            solver="contour_poly"), "herm_real16": dict(solver="cheb")}[name]

        def run(pkg, **extra):
            from importlib import import_module
            mod = import_module(pkg.__name__ + ".solvers.sparse")
            return mod.sparse_feast_interval(
                A, None, Emin, Emax, 16, _fpm(pkg), hermitian=True,
                **kw, **extra)
        return run, exp, 1e-8
    if name == "auto32":
        A = random_gauge(32, 4)
        Emin, Emax, exp = lowest(np.linalg.eigvalsh(lap2d(32).toarray()), 8)
        return (lambda pkg, **extra: pkg.feast(
            A, None, (Emin, Emax), 16, _fpm(pkg), **extra)), exp, 1e-8
    if name == "hcsrgv32":
        A = random_gauge(32, 5)
        b = 1.0 + 0.5 * np.random.default_rng(6).random(1024)
        B = sp.diags(b).tocsr()
        w = sla.eigh(A.toarray(), np.diag(b), eigvals_only=True)
        Emin, Emax, exp = lowest(w, 8)
        return (lambda pkg, **extra: pkg.feast_hcsrgv(
            A, B, Emin, Emax, 16, _fpm(pkg), **extra)), exp, 1e-8
    if name == "krylov_mg32":
        A = gauge(lap2d(32, 8), 0.01 * (np.arange(256) % 32))
        Emin, Emax, exp = lowest(np.linalg.eigvalsh(lap2d(32, 8).toarray()),
                                 4)

        def run(pkg, **extra):
            fpm = _fpm(pkg)
            fpm[2] = 4
            return pkg.feast(A, None, (Emin, Emax), 8, fpm,
                             solver="gmres", **extra)
        return run, exp, 1e-8
    if name == "krylov_jacobi16":
        A = (random_gauge(16, 7) + 2.0 * sp.eye(256)).tocsr()
        Emin, Emax, exp = lowest(np.linalg.eigvalsh(A.toarray()), 4)

        def run(pkg, **extra):
            fpm = _fpm(pkg)
            fpm[2] = 4
            return pkg.feast(A, None, (Emin, Emax), 8, fpm,
                             solver="gmres", **extra)
        return run, exp, 1e-8
    if name == "f3":
        A = f3_fixture()
        w = np.linalg.eigvalsh(A.toarray())
        return (lambda pkg, **extra: pkg.feast_hcsrev(
            A, -0.35, 0.23, 90, **extra)), \
            w[(w >= -0.35) & (w <= 0.23)], 1e-9
    if name == "densify20":
        A = random_gauge(20, 8)
        w = np.linalg.eigvalsh(lap2d(20).toarray())

        def run(pkg, **extra):
            with _env(FEAST_CHEB_DEGREE="4"):
                return pkg.feast(A, None, (0.5 * w[0], (w[7] + w[8]) / 2),
                                 16, _fpm(pkg, 12), **extra)
        return run, w[:8], 1e-9
    if name == "hbev4096":
        bands = hermitian_band(4096, 2, 9)
        w = sla.eig_banded(bands[:3], eigvals_only=True, select="v",
                           select_range=(19.5, 22.5))

        def run(pkg, **extra):
            from importlib import import_module
            mod = import_module(pkg.__name__ + ".solvers.banded")
            return mod.feast_hbev(bands, 2, 2, 19.5, 22.5, 16, _fpm(pkg),
                                  **extra)
        return run, np.sort(w), 1e-8
    raise KeyError(name)


CASES = ["cheb16", "poly16", "herm_real16", "auto32", "hcsrgv32",
         "krylov_mg32", "krylov_jacobi16", "f3", "densify20", "hbev4096"]
# the cases of each child process: about half of the JAX package's
# compile and run time each
CHILD_CASES = (("krylov_mg32", "krylov_jacobi16", "f3"),
               ("cheb16", "poly16", "herm_real16", "auto32", "hcsrgv32",
                "densify20", "hbev4096"))


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
                    f"{name}/lam": np.asarray(r.lam)})
    np.savez(path, **out)


# the JAX package's solves are small: XLA's CPU compile, not their run, is
# their cost, so the child compiles without LLVM's costly passes (no
# fast-math; the same IEEE operations)
_FAST_COMPILE = ("--xla_backend_optimization_level=0 "
                 "--xla_llvm_disable_expensive_passes=true")

_CHILD = ("import os, runpy, sys; "
          "os.sched_setaffinity(0, {int(c) for c in sys.argv[1].split(',')}); "
          "sys.argv = sys.argv[2:]; runpy.run_path(sys.argv[0], "
          "run_name='__main__')")


def _reference_command(path, child):
    """This file as a script on ``path`` for the cases of CHILD_CASES[child],
    kept to one core of this process's set, the fifth (child 0) or the
    seventh (child 1) from last where there is one (the banded and Krylov
    files' children keep to the last four, the unfused file's to the
    sixth; affinity set before JAX sizes its thread pools)."""
    args = [__file__, str(path), str(child)]
    if not hasattr(os, "sched_setaffinity"):
        return [sys.executable] + args
    cpus = sorted(os.sched_getaffinity(0))
    back = (5, 7)[child]
    cpu = cpus[-back] if len(cpus) >= back else cpus[-1]
    return [sys.executable, "-c", _CHILD, str(cpu)] + args


# the port's functions whose entry names the engine a solve reached
ENGINES = ((port_sparse, "_sparse_cheb_filter_host", "unfused"),
           (port_sparse, "_sparse_cheb_filter_host_fused", "fused"),
           (port_sparse, "_make_sparse_solve_all", "krylov"),
           (port_banded, "bcr_factor", "bcr"),
           (port_dense, "dense_hermitian_feast", "dense"))


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
    """(reference, port): the JAX package's results from the child, and the
    port's with the engines each entered."""
    where = tmp_path_factory.mktemp("hermitian_reference")
    paths = [where / f"ref{i}.npz" for i in range(len(CHILD_CASES))]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (root, os.environ.get("PYTHONPATH")) if p),
        XLA_FLAGS=" ".join(filter(None, (os.environ.get("XLA_FLAGS"),
                                         _FAST_COMPILE))))
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


# every polynomial case has a DIA form: the fused complex one-step entries
WANT_ENGINES = {"cheb16": ["fused"], "poly16": ["fused"],
                "herm_real16": ["fused"],
                "auto32": ["fused"], "hcsrgv32": ["fused"],
                "krylov_mg32": ["krylov"], "krylov_jacobi16": ["krylov"],
                "f3": ["bcr"], "densify20": ["dense"],
                "hbev4096": ["fused"]}


@pytest.mark.parametrize("name", CASES)
def test_matches_reference(solves, name):
    ref, port = solves
    r, engines = port[name]
    _, exp, bar = case(name)
    assert r.M == int(ref[f"{name}/M"]) == len(exp)
    assert int(r.info) == int(ref[f"{name}/info"]) == 0
    lam = np.sort(np.asarray(r.lam))
    assert np.abs(lam - np.sort(ref[f"{name}/lam"])).max() <= bar
    assert np.abs(lam - exp).max() <= bar
    assert engines == WANT_ENGINES[name]
    assert r.q.is_complex() and r.q.shape == (r.q.shape[0], r.M)


def test_krylov_preconditioners(solves):
    port = solves[1]
    mg, _ = port["krylov_mg32"]
    jac, _ = port["krylov_jacobi16"]
    assert mg.krylov["hermitian"] and mg.krylov["precond"] == "mg"
    assert mg.krylov["mg_levels"] == 2
    assert jac.krylov["hermitian"] and jac.krylov["precond"] == "jacobi"
    # the mirrored node set: 2 fpm[2] nodes in groups of two
    assert {e["nodes"] for e in mg.krylov["events"]
            if e["op"] == "gmres"} == {2}


def test_residuals_below_tolerance(solves):
    for name, (r, _) in solves[1].items():
        tol = 1e-12 if name in ("f3", "densify20") else 1e-8
        assert float(np.max(r.res)) <= tol, name


def test_hermitian_launches_follow_the_krylov_record(solves, monkeypatch):
    """The Krylov record of a Hermitian solve names the complex DIA entries
    (their plain versions run here; the card holds the launch counts to
    the same record)."""
    from feastkit_tpu_torch.ops import dia
    r, _ = solves[1]["krylov_mg32"]
    want = port_sparse.krylov_dia_launches(r.krylov)
    assert want["dia_matvec_batched_c64"] > 0
    assert want["dia_matvec_batched_c128"] > 0
    assert want["dia_matvec_c128"] > 0
    assert all(want[n] == 0 for n in want if n[-3:] in ("f32", "f64"))
    assert dia.dia_matvec_batched_c64.launches == 0


if __name__ == "__main__":
    _write_reference(sys.argv[1], CHILD_CASES[int(sys.argv[2])])
