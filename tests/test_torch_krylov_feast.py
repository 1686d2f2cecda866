"""PyTorch port: the Krylov contour engine end to end against the JAX package.

``feast(lap2d(32), None, (Emin, Emax), 24, fpm, solver="gmres")`` with
fpm[3] = 8: N = 1024, the lowest 13 pairs, Emax at a gap of the analytic
spectrum. Both packages plan the multigrid preconditioner with 2 levels
there. The port (on the CPU) and the JAX package give the same M and info,
eigenvalues within 1e-8 of each other and of the analytic values, and
residuals below the tolerance, in complex128 (fpm[42] = 0) and under mixed
precision (fpm[42] = 2: the port's complex128 refinement against the JAX
package's (re, im) pair filter). ``FEAST_GROUP_MAX=1`` (node by node, the
unbatched DIA entry) agrees with the default node groups to 1e-10, and the
DIA applications each solve makes equal what its own Krylov record implies
(the accounting ``chip_smoke.py`` holds the kernels' launch counts to on the
card). Each solve runs once, in a module fixture. The reference's two
run in a child process (this file run as a script) that keeps to two
cores, beside the port's three, so that the suite's parallel workers keep
theirs.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import scipy.sparse as sp  # noqa: E402

import feastkit_tpu as ref_ft  # noqa: E402
import feastkit_tpu_torch as ft  # noqa: E402
from feastkit_tpu_torch.ops import dia  # noqa: E402
from feastkit_tpu_torch.solvers.sparse import (DIA_ENTRIES,  # noqa: E402
                                               krylov_dia_launches)

NX, M0, TOL = 32, 24, 1e-8


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


def _problem():
    D = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(NX, NX))
    A = (sp.kron(D, sp.eye(NX)) + sp.kron(sp.eye(NX), D)).tocsr()
    mu = 2.0 - 2.0 * np.cos(np.arange(1, NX + 1) * np.pi / (NX + 1))
    w = np.sort((mu[:, None] + mu[None, :]).ravel())
    gaps = np.nonzero(np.diff(w) > 1e-12)[0]
    hi = gaps[np.searchsorted(gaps, 12)]
    Emin, Emax = float(0.5 * w[0]), float(0.5 * (w[hi] + w[hi + 1]))
    return A, Emin, Emax, w[(w >= Emin) & (w <= Emax)]


def _fpm(mod, mixed):
    fpm = mod.feastinit()
    fpm[3] = 8
    fpm[42] = mixed
    return fpm


def _write_reference(path):
    """The JAX package's two solves (fpm[42] = 0 and 2), saved to ``path``
    (the child process's work)."""
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    A, Emin, Emax, _ = _problem()
    out = {}
    for mixed in (0, 2):
        r = ref_ft.feast(A, None, (Emin, Emax), M0, _fpm(ref_ft, mixed),
                         solver="gmres", backend="serial")
        out.update({f"M{mixed}": r.M, f"info{mixed}": int(r.info),
                    f"lam{mixed}": np.asarray(r.lam)})
    np.savez(path, **out)


def _counted_solve(monkeypatch, mixed, **env):
    """A port solve on the CPU with every DIA product counted by the entry
    that carries it (the wrappers' plain versions count no launch)."""
    A, Emin, Emax, _ = _problem()
    seen = dict.fromkeys(DIA_ENTRIES, 0)
    orig = dia._matvec

    def counting(wrapper, *a):
        seen[wrapper.__name__] += 1
        return orig(wrapper, *a)

    with monkeypatch.context() as m:
        m.setattr(dia, "_matvec", counting)
        for k, v in env.items():
            m.setenv(k, v)
        r = ft.feast(A, None, (Emin, Emax), M0, _fpm(ft, mixed),
                     solver="gmres", device="cpu")
    return r, seen


@pytest.fixture(scope="module")
def solves(tmp_path_factory):
    """(reference, port): the reference's solves in a child process while
    the port's run here."""
    path = tmp_path_factory.mktemp("krylov_reference") / "reference.npz"
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    child_env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (root, os.environ.get("PYTHONPATH")) if p))
    child = subprocess.Popen(_reference_command(path),
                             env=child_env)
    try:
        with pytest.MonkeyPatch.context() as mp:
            port = {key: _counted_solve(mp, mixed, **env)
                    for key, mixed, env in ((0, 0, {}), (2, 2, {}),
                                            ("group1", 0,
                                             {"FEAST_GROUP_MAX": "1"}))}
        assert child.wait(timeout=900) == 0, "the reference solves failed"
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
    with np.load(path) as ref:
        return dict(ref), port


@pytest.mark.parametrize("mixed", [0, 2])
def test_matches_reference_and_analytic(solves, mixed):
    _, _, _, exact = _problem()
    ref, port = solves
    got, _ = port[mixed]
    assert got.M == int(ref[f"M{mixed}"]) == len(exact) == 13
    assert int(got.info) == int(ref[f"info{mixed}"]) == 0
    lam, lam_r = np.sort(got.lam), np.sort(ref[f"lam{mixed}"])
    assert np.abs(lam - lam_r).max() <= TOL
    assert np.abs(lam - exact).max() <= TOL
    assert float(np.max(got.res)) <= TOL and got.epsout <= TOL
    assert got.krylov["precond"] == "mg" and got.krylov["mg_levels"] == 2
    # the refinement's shifted applications appear only under mixed
    # precision, its inner Krylov in complex64
    dtypes = {e["dtype"] for e in got.krylov["events"]
              if e["op"] == "gmres"}
    assert dtypes == ({"torch.complex128"} if mixed == 0
                      else {"torch.complex64"})


@pytest.mark.parametrize("key", [0, 2, "group1"])
def test_dia_products_follow_the_krylov_record(solves, key):
    r, seen = solves[1][key]
    want = krylov_dia_launches(r.krylov)
    assert seen == want
    # node groups of two run the batched entry, a group of one the
    # unbatched one; the Rayleigh-Ritz and residual products are fp64
    batched = seen["dia_matvec_batched_f64"] + seen["dia_matvec_batched_f32"]
    assert (batched == 0) == (key == "group1")
    assert seen["dia_matvec_f64"] > 0
    assert (seen["dia_matvec_batched_f32"] > 0) == (key == 2)


def test_group_of_one_matches_default_groups(solves):
    default, _ = solves[1][0]
    one, _ = solves[1]["group1"]
    assert {e["nodes"] for e in one.krylov["events"]
            if e["op"] == "gmres"} == {1}
    assert {e["nodes"] for e in default.krylov["events"]
            if e["op"] == "gmres"} == {2}
    assert one.M == default.M and int(one.info) == 0
    assert np.abs(np.sort(one.lam) - np.sort(default.lam)).max() <= 1e-10


if __name__ == "__main__":
    _write_reference(sys.argv[1])
