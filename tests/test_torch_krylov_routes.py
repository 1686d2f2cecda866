"""PyTorch port: every way into the Krylov contour engine, on the CPU.

* BiCGStab through the IFEAST switch fpm[43] = 1 (fpm[44] = 0) on
  ``lap2d(32)``, the consistent-mass pencil of scripts/scale_sparse_gen.py at
  P = 5 with ``grid=(32, 32)`` (multigrid with a B stencil, 2 levels), and
  an operator on more than 32 diagonals (the CSR product, Jacobi), each
  against its analytic or dense eigenvalues (1e-8) with residuals <= 1e-8;
* the auto route's ways in: ``FEAST_CONTOUR_POLY=0``, and the
  ``ChebInfeasible`` fallback above ``FEAST_SPARSE_DENSE_N`` (below it the
  pencil is densified onto the dense engine), with a narrow-banded pencil
  going to the banded engine instead;
* ``FEAST_CHEB_DEGREE``: the degree the port's polynomial path picks under
  the switch equals the JAX package's (both stopped right after the pick).
Inputs come from numpy seeds; the port runs on the CPU.
"""
import os
import re
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import scipy.sparse as sp  # noqa: E402

import feastkit_tpu_torch as ft  # noqa: E402
from feastkit_tpu_torch.solvers import sparse as port_sparse  # noqa: E402

TOL = 1e-8


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


def _lap2d(nx):
    D = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(nx, nx))
    A = (sp.kron(D, sp.eye(nx)) + sp.kron(sp.eye(nx), D)).tocsr()
    mu = 2.0 - 2.0 * np.cos(np.arange(1, nx + 1) * np.pi / (nx + 1))
    return A, np.sort((mu[:, None] + mu[None, :]).ravel())


def _lowest(w, count):
    """(Emin, Emax, expected) for the lowest ~count eigenvalues, Emax at a
    gap of the spectrum."""
    gaps = np.nonzero(np.diff(w) > 1e-12)[0]
    hi = gaps[np.searchsorted(gaps, count)]
    Emin, Emax = float(0.5 * w[0]), float(0.5 * (w[hi] + w[hi + 1]))
    return Emin, Emax, w[(w >= Emin) & (w <= Emax)]


def _fpm(**slots):
    fpm = ft.feastinit()
    fpm[3] = 8
    for k, v in slots.items():
        fpm[int(k[1:])] = v
    return fpm


def _check(r, exact, solver, precond):
    assert r.krylov is not None, "the Krylov engine ran"
    assert r.krylov["solver"] == solver and r.krylov["precond"] == precond
    assert r.M == len(exact) and int(r.info) == 0
    assert np.abs(np.sort(r.lam) - exact).max() <= TOL
    assert float(np.max(r.res)) <= TOL


def test_ifeast_bicgstab():
    A, w = _lap2d(32)
    Emin, Emax, exact = _lowest(w, 12)
    # fpm[43] = 1: the IFEAST options, BiCGStab (fpm[44] = 0) at 1e-10
    # inner accuracy (fpm[45]) within 400 iterations (fpm[46])
    r = ft.feast(A, None, (Emin, Emax), 24,
                 _fpm(f43=1, f44=0, f45=10, f46=400), device="cpu")
    _check(r, exact, "bicgstab", "mg")
    # BiCGStab calls, the warm starts' guards and the core's products
    assert {e["op"] for e in r.krylov["events"]} == {"bicgstab", "shift",
                                                     "apply"}


def test_consistent_mass_with_grid():
    import scipy.linalg as sla
    nx = 32
    Dx = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(nx, nx))
    Mx = sp.diags([4 / 6, 1 / 6, 1 / 6], [0, 1, -1], shape=(nx, nx))
    A = (sp.kron(Dx, Mx) + sp.kron(Mx, Dx)).tocsr()
    B = sp.kron(Mx, Mx).tocsr()
    mu = sla.eigh(Dx.toarray(), Mx.toarray(), eigvals_only=True)
    w = np.sort((mu[:, None] + mu[None, :]).ravel())
    _, Emax, _ = _lowest(w, 12)
    exact = w[w <= Emax]
    r = ft.feast(A, B, (0.0, Emax), 24, _fpm(), solver="gmres",
                 grid=(nx, nx), device="cpu")
    _check(r, exact, "gmres", "mg")
    assert r.krylov["mg_levels"] == 2 and not r.krylov["standard"]


def test_operator_on_more_than_32_diagonals():
    # a diagonally dominant operator on 35 diagonals: the CSR product and
    # the Jacobi preconditioner
    N = 300
    rng = np.random.default_rng(5)
    A = sp.diags(4.0 + np.linspace(0.0, 2.0, N))
    for k in range(1, 18):
        v = 0.05 * rng.standard_normal(N - k) / k
        A = A + sp.diags([v, v], [-k, k])
    A = A.tocsr()
    w = np.linalg.eigvalsh(A.toarray())
    Emin, Emax, exact = _lowest(w, 8)
    r = ft.feast(A, None, (Emin, Emax), 16, _fpm(), solver="gmres",
                 device="cpu")
    _check(r, exact, "gmres", "jacobi")
    assert not r.krylov["a_dia"]
    assert port_sparse.krylov_dia_launches(r.krylov) == dict.fromkeys(
        port_sparse.DIA_ENTRIES, 0)


def test_contour_poly_off_takes_the_krylov_engine(monkeypatch):
    A, w = _lap2d(20)          # half bandwidth 20: not a narrow band
    Emin, Emax, exact = _lowest(w, 8)
    monkeypatch.setenv("FEAST_CONTOUR_POLY", "0")
    r = ft.feast(A, None, (Emin, Emax), 16, _fpm(), device="cpu")
    _check(r, exact, "gmres", "mg")
    # a narrow-banded pencil goes to the banded direct engine instead
    A16, w16 = _lap2d(16)
    Emin, Emax, exact16 = _lowest(w16, 8)
    r = ft.feast(A16, None, (Emin, Emax), 16, _fpm(), device="cpu")
    assert r.krylov is None and r.M == len(exact16) and int(r.info) == 0
    assert np.abs(np.sort(r.lam) - exact16).max() <= TOL
    assert float(np.max(r.res)) <= TOL


def test_cheb_infeasible_falls_back_to_krylov(monkeypatch, capsys):
    # a degree cap the rational filter cannot meet and the indicator's
    # quality gate refuses: the polynomial route is infeasible
    A, w = _lap2d(20)
    Emin, Emax, exact = _lowest(w, 8)
    monkeypatch.setenv("FEAST_CHEB_DEGREE", "4")
    # at N <= FEAST_SPARSE_DENSE_N the pencil is densified onto the dense
    # engine, with the JAX package's message
    r = ft.feast(A, None, (Emin, Emax), 16, _fpm(f1=1), device="cpu")
    assert "densifying onto the dense direct engine" in \
        capsys.readouterr().out
    assert r.krylov is None and r.M == len(exact) and int(r.info) == 0
    assert np.abs(np.sort(r.lam) - exact).max() <= TOL
    assert float(np.max(r.res)) <= TOL
    monkeypatch.setenv("FEAST_SPARSE_DENSE_N", "100")
    r = ft.feast(A, None, (Emin, Emax), 16, _fpm(f1=1), device="cpu")
    assert "using the Krylov contour engine" in capsys.readouterr().out
    _check(r, exact, "gmres", "mg")


class _Picked(Exception):
    pass


def _picked_degree(monkeypatch, capsys, module, feast, A, interval, M0,
                   fpm, **kw):
    """Run ``feast`` until its polynomial filter is picked (the seeded
    subspace comes right after) and return the printed degree."""
    def stop(*a, **k):
        raise _Picked
    monkeypatch.setattr(module, "initial_subspace", stop)
    capsys.readouterr()
    with pytest.raises(_Picked):
        feast(A, None, interval, M0, fpm, **kw)
    out = capsys.readouterr().out
    found = re.search(r"filter: degree=(\d+)", out)
    assert found, out
    return int(found.group(1))


@pytest.mark.parametrize("solver", [None, "cheb"])
def test_cheb_degree_switch_matches_reference(monkeypatch, capsys, solver):
    pytest.importorskip("jax")
    import feastkit_tpu as ref_ft
    from feastkit_tpu.core import tools as ref_tools
    A, w = _lap2d(20)
    Emin, Emax, _ = _lowest(w, 8)
    picked = {}
    for degree in (None, "60"):
        if degree is not None:
            monkeypatch.setenv("FEAST_CHEB_DEGREE", degree)
        ref_fpm = ref_ft.feastinit()
        ref_fpm[3], ref_fpm[1] = 8, 1
        ref = _picked_degree(monkeypatch, capsys, ref_tools, ref_ft.feast,
                             A, (Emin, Emax), 16, ref_fpm, solver=solver,
                             backend="serial")
        got = _picked_degree(monkeypatch, capsys, port_sparse, ft.feast,
                             A, (Emin, Emax), 16, _fpm(f1=1), solver=solver,
                             device="cpu")
        assert got == ref
        picked[degree] = got
    # the indicator takes the pinned degree; the route's rational filter
    # takes it as a cap
    assert picked["60"] == 60 if solver == "cheb" else picked["60"] <= 60
    assert picked["60"] != picked[None]


def _subspace_only_reference(path):
    """The JAX package's fpm[14] = 1 solve, its (M, info, loop) saved to
    ``path`` (the child process's work)."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import feastkit_tpu as ref_ft
    A, _ = _lap2d(20)
    fpm = ref_ft.feastinit()
    fpm[3], fpm[14] = 8, 1
    r = ref_ft.feast(A, None, (0.01, 0.6), 16, fpm, solver="gmres",
                     backend="serial")
    np.save(path, np.array([r.M, int(r.info), r.loop]))


def test_subspace_only_mode_matches_reference(tmp_path):
    # fpm[14] = 1: one filter application, orthonormalized, no Rayleigh-Ritz
    # (the core's subspace-only branch); the result carries no pairs in
    # either package. The JAX package's solve runs in a child process (this
    # file run as a script) that keeps to two cores, beside the port's, so
    # that the suite's parallel workers keep theirs.
    pytest.importorskip("jax")
    from feastkit_tpu_torch.kernel import hermitian
    path = tmp_path / "subspace_only.npy"
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (root, os.environ.get("PYTHONPATH")) if p))
    A, _ = _lap2d(20)
    seen = []
    orig = hermitian.orthonormalize

    def spy(Q):
        seen.append(orig(Q)[0])
        return orig(Q)
    child = subprocess.Popen(_reference_command(path), env=env)
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(hermitian, "orthonormalize", spy)
            got = ft.feast(A, None, (0.01, 0.6), 16, _fpm(f14=1),
                           solver="gmres", device="cpu")
        assert child.wait(timeout=600) == 0, "the reference solve failed"
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
    ref = tuple(int(v) for v in np.load(path))
    assert (got.M, int(got.info), got.loop) == ref == (0, 5, 0)
    U = seen[0]
    assert U.shape == (A.shape[0], 16)
    assert float((U.T @ U - torch.eye(16, dtype=U.dtype)).abs().max()) <= 1e-12


if __name__ == "__main__":
    _subspace_only_reference(sys.argv[1])
