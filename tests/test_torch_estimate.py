"""PyTorch port: the stochastic eigenvalue count fpm[14] = 2 against the JAX
package, on every driver that takes it.

The fixtures of tests/test_estimate_modes.py (the sparse, banded,
matrix-free, dense general, sparse general and banded general drivers;
its two sharded cases are in tests/test_torch_parallel.py), and the
engines those fixtures route
past: the polynomial engine (``solver="cheb"``, on a DIA operator that
the fused kernels would carry: the count runs the unfused recurrence in
the work dtype, float64 and float32), the Krylov interval engine and the
sparse general Krylov engine (``solver="gmres"``), the dense symmetric
driver, and the matrix-free polynomial filter. Both packages draw the same
Rademacher probes, so each count gives the same M and an epsout (the
estimate) within 1e-10 relative (1e-5 in float32) of the JAX package's,
and a count-only result: no eigenpairs, one loop, info 0. As in the JAX
package, ``feast_matvec_general`` and ``feast_pep_direct`` have no count
and run an ordinary solve. The JAX package's counts run in two child
processes (this file run as a script, one core each) while the port's
run here.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import scipy.sparse as sp

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import feastkit_tpu_torch as ft  # noqa: E402
from feastkit_tpu_torch.solvers import sparse as port_sparse  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the suite runs files in parallel worker processes on a few cores;
    # torch's default intra-op pool and numpy's / scipy's OpenBLAS pools
    # would starve their neighbours
    from threadpoolctl import threadpool_limits
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(limits=1, user_api="blas"):
        yield
    torch.set_num_threads(n)


def _is_port(pkg):
    return pkg.__name__ == "feastkit_tpu_torch"


def _fpm(pkg, trials=40):
    fpm = pkg.feastinit()
    fpm[14] = 2
    fpm[32] = trials
    return fpm


def _lap(n):
    return sp.diags([2.0 * np.ones(n), -np.ones(n - 1), -np.ones(n - 1)],
                    [0, 1, -1], format="csr")


def _lap2d(nx):
    T = _lap(nx)
    return (sp.kron(sp.eye(nx), T) + sp.kron(T, sp.eye(nx))).tocsr()


def _bands(n, dtype=np.float64):
    b = np.zeros((3, n), dtype)
    b[0, 1:] = -1.0
    b[1] = 2.0
    b[2, :-1] = -1.0
    return b


def _diag_general(n=200):
    rng = np.random.default_rng(42)
    d = np.concatenate([rng.uniform(-0.5, 0.5, 10)
                        + 1j * rng.uniform(-0.3, 0.3, 10),
                        4.0 + np.arange(n - 10, dtype=float)])
    return sp.diags(d, 0, format="csr")


def _dense_general(n=120):
    rng = np.random.default_rng(42)
    lam = np.concatenate([rng.uniform(-0.5, 0.5, 12)
                          + 1j * rng.uniform(-0.4, 0.4, 12),
                          3.0 + rng.standard_normal(n - 12)])
    X = rng.standard_normal((n, n)) + 0.05 * 1j * rng.standard_normal((n, n))
    return X @ np.diag(lam) @ np.linalg.inv(X)


def _operator(pkg, A):
    """The matrix as the package's LinearOperator."""
    if _is_port(pkg):
        return pkg.LinearOperator.from_matrix(np.asarray(A), symmetric=True)
    import jax.numpy as jnp
    Ad = jnp.asarray(np.asarray(A))
    return pkg.LinearOperator(lambda X: Ad @ X, Ad.shape, Ad.dtype,
                              symmetric=True)


# name -> (call(pkg, **kw), float32)
CASES = {
    "sparse": (lambda pkg, **kw: pkg.feast_scsrev(
        _lap(300), 0.5, 1.5, 8, _fpm(pkg), **kw), False),
    "banded": (lambda pkg, **kw: pkg.feast_sbev(
        _bands(300), 1, 1, 0.5, 1.5, 8, _fpm(pkg), **kw), False),
    "matfree": (lambda pkg, **kw: pkg.feast_matvec(
        _operator(pkg, _lap(300).toarray()), None, (0.5, 1.5), 8,
        _fpm(pkg), **kw), False),
    "matfree_cheb": (lambda pkg, **kw: pkg.feast_matvec(
        _operator(pkg, _lap(300).toarray()), None, (0.5, 1.5), 8,
        _fpm(pkg), solver="cheb", bounds=(0.0, 4.0001), **kw), False),
    "dense_general": (lambda pkg, **kw: pkg.feast_geev(
        _dense_general(), 0.0 + 0.0j, 1.0, 8, _fpm(pkg, 60), **kw), False),
    "sparse_general": (lambda pkg, **kw: pkg.feast_gcsrev(
        _diag_general(), 0.0 + 0.0j, 1.0, 8, _fpm(pkg, 60), **kw), False),
    "banded_general": (lambda pkg, **kw: pkg.zfeast_gbev(
        _bands(400, np.complex128), 1, 1, 2.0 + 0.0j, 0.8, 8,
        _fpm(pkg, 20), **kw), False),
    "polynomial": (lambda pkg, **kw: pkg.feast_scsrev(
        _lap2d(16), 0.5, 1.5, 8, _fpm(pkg), solver="cheb", **kw), False),
    "polynomial_f32": (lambda pkg, **kw: pkg.feast_scsrev(
        _lap2d(16).astype(np.float32), 0.5, 1.5, 8, _fpm(pkg),
        solver="cheb", **kw), True),
    "krylov": (lambda pkg, **kw: pkg.feast_scsrev(
        _lap(300), 0.5, 1.5, 8, _fpm(pkg, 10), solver="gmres", **kw),
        False),
    "general_krylov": (lambda pkg, **kw: pkg.feast_gcsrev(
        _diag_general(), 0.0 + 0.0j, 1.0, 8, _fpm(pkg, 10), solver="gmres",
        **kw), False),
    "dense": (lambda pkg, **kw: pkg.feast_syev(
        _lap(120).toarray(), 0.5, 1.5, 8, _fpm(pkg), **kw), False),
}
# the JAX package's ordinary solves under fpm[14] = 2
SOLVES = {
    "matvec_general": lambda pkg, **kw: pkg.feast_matvec_general(
        _operator(pkg, np.diag(np.arange(1.0, 41.0))), None, 5.0 + 0.0j,
        2.5, 8, _fpm(pkg), **kw),
    "pep_direct": lambda pkg, **kw: pkg.feast_pep_direct(
        [np.diag(np.arange(1.0, 11.0)), 0.1 * np.eye(10), np.eye(10)],
        2.0j, 1.0, 8, _fpm(pkg), **kw),
}
CHILDREN = (("matfree", "krylov", "general_krylov", "matfree_cheb",
             "matvec_general", "pep_direct"),
            tuple(n for n in CASES if n not in (
                "matfree", "krylov", "general_krylov", "matfree_cheb")))


def _summary(r):
    return dict(M=r.M, epsout=float(r.epsout), loop=int(r.loop),
                info=int(r.info), lam=np.asarray(r.lam))


def _write_reference(path, child):
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import feastkit_tpu as ref_ft
    out = {}
    for name in CHILDREN[child]:
        call = CASES[name][0] if name in CASES else SOLVES[name]
        for k, v in _summary(call(ref_ft)).items():
            out[f"{name}/{k}"] = v
    np.savez(path, **out)


_FAST_COMPILE = ("--xla_backend_optimization_level=0 "
                 "--xla_llvm_disable_expensive_passes=true")
_CHILD = ("import os, runpy, sys; "
          "os.sched_setaffinity(0, {int(sys.argv[1])}); "
          "sys.argv = sys.argv[2:]; runpy.run_path(sys.argv[0], "
          "run_name='__main__')")


def _reference_command(path, child):
    """This file as a script on ``path`` for CHILDREN[child], kept to one
    core (the third or the fourth from last of this process's set)."""
    args = [__file__, str(path), str(child)]
    if not hasattr(os, "sched_setaffinity"):
        return [sys.executable] + args
    cpus = sorted(os.sched_getaffinity(0))
    back = 3 + child
    cpu = cpus[-back] if len(cpus) >= back else cpus[-1]
    return [sys.executable, "-c", _CHILD, str(cpu)] + args


@pytest.fixture(scope="module")
def counts(tmp_path_factory):
    """(reference, port): the JAX package's results from the children,
    the port's, and the port's polynomial counts' filter calls by path."""
    where = tmp_path_factory.mktemp("estimate_reference")
    paths = [where / f"ref{i}.npz" for i in range(len(CHILDREN))]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (root, os.environ.get("PYTHONPATH")) if p),
        XLA_FLAGS=" ".join(filter(None, (os.environ.get("XLA_FLAGS"),
                                         _FAST_COMPILE))))
    children = [subprocess.Popen(_reference_command(path, i), env=env)
                for i, path in enumerate(paths)]
    try:
        port = {}
        for name, (call, _) in CASES.items():
            port[name] = call(ft, device="cpu")
        for name, call in SOLVES.items():
            port[name] = call(ft, device="cpu")
        for child in children:
            assert child.wait(timeout=600) == 0, \
                "the reference counts failed"
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


@pytest.mark.parametrize("name", sorted(CASES))
def test_count_matches_reference(counts, name):
    ref, port = counts
    r = port[name]
    assert r.M == int(ref[f"{name}/M"])
    tol = 1e-5 if CASES[name][1] else 1e-10
    est = float(ref[f"{name}/epsout"])
    assert abs(r.epsout - est) <= tol * abs(est)
    assert r.lam.size == 0 and tuple(r.q.shape) == (r.q.shape[0], 0)
    assert r.loop == int(ref[f"{name}/loop"]) == 1
    assert int(r.info) == int(ref[f"{name}/info"]) == 0
    assert r.M == max(int(round(r.epsout)), 0)


@pytest.mark.parametrize("name", sorted(SOLVES))
def test_no_count_runs_an_ordinary_solve(counts, name):
    """feast_matvec_general and feast_pep_direct have no fpm[14] = 2
    branch in the JAX package: both run the ordinary solve."""
    ref, port = counts
    r = port[name]
    assert r.M == int(ref[f"{name}/M"]) > 0 and len(r.lam) == r.M
    lam = np.sort_complex(np.asarray(r.lam))
    assert np.abs(lam - np.sort_complex(ref[f"{name}/lam"])).max() <= 1e-7


def test_count_takes_the_unfused_recurrence(monkeypatch):
    """The polynomial engine's count runs the unfused recurrence
    (``_sparse_cheb_filter_host``) in the work dtype on an operator the
    fused kernels would carry, once over the full series, no ladder."""
    seen = []
    orig = port_sparse._sparse_cheb_filter_host

    def unfused(ctx, Q, *, rung, n_coeffs=None):
        seen.append((rung, Q.dtype, Q.shape, n_coeffs,
                     len(ctx[rung]["coeffs"])))
        return orig(ctx, Q, rung=rung, n_coeffs=n_coeffs)

    def fused(*a, **k):
        raise AssertionError("the count ran the fused kernels")

    monkeypatch.setattr(port_sparse, "_sparse_cheb_filter_host", unfused)
    monkeypatch.setattr(port_sparse, "_sparse_cheb_filter_host_fused", fused)
    r = CASES["polynomial"][0](ft, device="cpu")
    assert r.lam.size == 0 and r.M > 0
    assert len(seen) == 1
    rung, dtype, shape, n_coeffs, ncoef = seen[0]
    assert dtype == torch.float64 and tuple(shape) == (256, 40)
    assert n_coeffs is None and ncoef > 2


if __name__ == "__main__":
    _write_reference(sys.argv[1], int(sys.argv[2]))
