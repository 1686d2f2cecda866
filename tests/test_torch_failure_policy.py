"""PyTorch port: the inner-solve failure policy against the JAX package's
(tests/test_failure_policy.py).

A starved iterative inner solver must be flagged, never silently a
success: where the outer loop failed AND an inner GMRES / BiCGStab solve
missed its tolerance, the result carries ``inner_converged=False`` and the
JAX package's RuntimeWarning ("FEAST did not converge AND the inner
iterative solver ..."), emitted by ``core/types._trim`` as there. The four
cases of the JAX package's file on its inputs: the starved sparse Krylov
solve (n = 200, (0.5, 0.8), M0 = 12, ``solver_maxiter=1``,
``solver_restart=2``), a healthy one (``slow`` there and here), the dense
driver (always converged) and the starved matrix-free solve (n = 120,
(0.5, 1.5), M0 = 10). Each is held to the JAX package's
``inner_converged``, ``info``, M, loop count and warning texts on the same
inputs, its solves in one child process (this file run as a script, one
core) while the port's run here.
"""
import os
import subprocess
import sys
import warnings

import numpy as np
import pytest
import scipy.sparse as sp

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import feastkit_tpu_torch as ft  # noqa: E402

from conftest import laplacian_1d, laplacian_eigs  # noqa: E402


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


def _sparse_laplacian(n):
    return sp.diags([2.0 * np.ones(n), -np.ones(n - 1), -np.ones(n - 1)],
                    [0, 1, -1], format="csr")


def _operator(pkg, n):
    Ad = laplacian_1d(n)
    if pkg.__name__ == "feastkit_tpu_torch":
        return pkg.LinearOperator.from_matrix(Ad, symmetric=True)
    import jax.numpy as jnp
    return pkg.LinearOperator(lambda X: jnp.asarray(Ad) @ X, (n, n),
                              np.float64, symmetric=True)


# name -> call(pkg, **kw)
CASES = {
    "starved_gmres": lambda pkg, **kw: pkg.feast_scsrev(
        _sparse_laplacian(200), 0.5, 0.8, 12, solver_maxiter=1,
        solver_restart=2, **kw),
    "dense": lambda pkg, **kw: pkg.feast_syev(laplacian_1d(60), 0.5, 1.5,
                                              14, **kw),
    "starved_matfree": lambda pkg, **kw: pkg.feast_matvec(
        _operator(pkg, 120), None, (0.5, 1.5), 10, solver_maxiter=1,
        solver_restart=2, **kw),
}
_INNER = "inner iterative solver"


def _run(pkg, name, **kw):
    """(summary dict, the texts of the RuntimeWarnings that name the inner
    solver) of CASES[name] in ``pkg``."""
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        r = CASES[name](pkg, **kw)
    texts = [str(w.message) for w in rec
             if issubclass(w.category, RuntimeWarning)
             and _INNER in str(w.message)]
    return dict(inner=bool(r.inner_converged), info=int(r.info), M=int(r.M),
                loop=int(r.loop)), texts


def _write_reference(path):
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import feastkit_tpu as ref_ft
    out = {}
    for name in CASES:
        summary, texts = _run(ref_ft, name)
        for k, v in summary.items():
            out[f"{name}/{k}"] = v
        out[f"{name}/texts"] = np.asarray(texts, dtype=object)
    np.savez(path, **out)


_FAST_COMPILE = ("--xla_backend_optimization_level=0 "
                 "--xla_llvm_disable_expensive_passes=true")
_CHILD = ("import os, runpy, sys; "
          "os.sched_setaffinity(0, {int(sys.argv[1])}); "
          "sys.argv = sys.argv[2:]; runpy.run_path(sys.argv[0], "
          "run_name='__main__')")


def _reference_command(path):
    """This file as a script on ``path``, kept to the last core of this
    process's set."""
    args = [__file__, str(path)]
    if not hasattr(os, "sched_setaffinity"):
        return [sys.executable] + args
    cpu = sorted(os.sched_getaffinity(0))[-1]
    return [sys.executable, "-c", _CHILD, str(cpu)] + args


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """(reference, port): the JAX package's summaries and warning texts
    from the child, the port's from here meanwhile."""
    path = tmp_path_factory.mktemp("failure_policy") / "ref.npz"
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (os.path.dirname(here), here,
                    os.environ.get("PYTHONPATH")) if p),
        XLA_FLAGS=" ".join(filter(None, (os.environ.get("XLA_FLAGS"),
                                         _FAST_COMPILE))))
    child = subprocess.Popen(_reference_command(path), env=env)
    try:
        port = {name: _run(ft, name, device="cpu") for name in CASES}
        assert child.wait(timeout=600) == 0, "the reference solves failed"
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
    with np.load(path, allow_pickle=True) as z:
        ref = {k: z[k] for k in z.files}
    return ref, port


def _held(results, name):
    ref, port = results
    summary, texts = port[name]
    for k, v in summary.items():
        assert v == ref[f"{name}/{k}"], (name, k)
    assert texts == list(ref[f"{name}/texts"])
    return summary, texts


def test_starved_gmres_is_flagged(results):
    """solver_maxiter=1 cannot converge the shifted solves: the result
    carries inner_converged=False, the RuntimeWarning and a non-SUCCESS
    info, as in the JAX package."""
    summary, texts = _held(results, "starved_gmres")
    assert summary["inner"] is False
    assert summary["info"] != int(ft.FeastError.SUCCESS)
    assert len(texts) == 1 and texts[0].startswith(
        "FEAST did not converge AND the inner iterative solver "
        "(GMRES/BiCGStab) stalled")


@pytest.mark.slow
def test_healthy_solve_not_flagged():
    n = 150
    w = laplacian_eigs(n)
    exp = np.sort(w[(w >= 0.5) & (w <= 0.8)])
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        r = ft.feast_scsrev(_sparse_laplacian(n), 0.5, 0.8, len(exp) + 4,
                            device="cpu")
    assert r.inner_converged is True
    assert not any(_INNER in str(w.message) for w in rec)
    assert r.M == len(exp)


def test_direct_dense_always_inner_converged(results):
    summary, texts = _held(results, "dense")
    assert summary["inner"] is True and texts == []


def test_starved_matfree_flagged(results):
    summary, texts = _held(results, "starved_matfree")
    assert summary["inner"] is False and len(texts) == 1


if __name__ == "__main__":
    _write_reference(sys.argv[1])
