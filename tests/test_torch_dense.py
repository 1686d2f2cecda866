"""PyTorch port: the dense symmetric / Hermitian engine against the JAX
package, and ``feast()``'s backend keywords.

Mirrors tests/test_dense.py: the quickstart, syev, sygv, heev, hegv,
float32, fpm[10] = 0, Zolotarev, the trace criterion, the empty interval,
the ``feast()`` API (dense, standard and generalized, an explicit
``contour=`` and the fpm[29] registry), subspace-only fpm[14] = 1 and the
stochastic count fpm[14] = 2. Every case runs in both packages from the
same seeded numpy inputs, the JAX package at x64 on the CPU, the port on
the CPU with torch on one thread: M and info equal, eigenvalues within
BASELINE.md's bar of each other and of LAPACK (real symmetric 1e-10,
Hermitian 1e-9, f32 1e-5), every residual below the bar. Port-only:
determinism, the input validation and the backend conflicts.

``feast()``'s ``parallel=``, ``strict_backend=`` and ``contour=`` (F2 of
ROADMAP.md): on ``lap2d(16)`` as a sparse matrix each gives the JAX
package's M and eigenvalues; a sharded request on one device warns as the
JAX package does, or raises its RuntimeError under ``strict_backend``; on
two ranks the request runs the sharded drivers (``parallel/pfeast.py``,
replaced by recorders here). For that
the JAX package's device count is patched to 1, as on one card.

The JAX package's solves run once, in a child process (this file run as a
script) that keeps to two cores, while the port's run here.
"""
import os
import subprocess
import sys
import warnings

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import scipy.linalg as sla  # noqa: E402
import scipy.sparse as sp  # noqa: E402

import feastkit_tpu_torch as ft  # noqa: E402
from feastkit_tpu_torch.core import backend as port_backend  # noqa: E402
from feastkit_tpu_torch.core.parameters import (  # noqa: E402
    feastdefault, feast_tolerance)
from feastkit_tpu_torch.solvers import dense as port_dense  # noqa: E402


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


def laplacian_1d(n, dtype=np.float64):
    A = (np.diag(2.0 * np.ones(n)) + np.diag(-1.0 * np.ones(n - 1), 1)
         + np.diag(-1.0 * np.ones(n - 1), -1))
    return A.astype(dtype)


def laplacian_eigs(n):
    return 2.0 - 2.0 * np.cos(np.arange(1, n + 1) * np.pi / (n + 1))


def lap2d(nx):
    D = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(nx, nx))
    return (sp.kron(D, sp.eye(nx)) + sp.kron(sp.eye(nx), D)).tocsr()


def _herm(rng, n):
    H = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    return (H + H.conj().T) / 2


def _inside(w, Emin, Emax):
    return np.sort(w[(w >= Emin) & (w <= Emax)])


def _case(name):
    """(function, args, kwargs, fpm slots, exact eigenvalues, bar) of a
    case; the function is a name looked up in each package."""
    rng = np.random.default_rng(42)
    n = {"quickstart": 100, "syev": 80, "zolotarev": 80, "trapezoid": 80,
         "empty": 40, "stochastic": 300}.get(name, 60)
    A = laplacian_1d(n)
    w = laplacian_eigs(n)
    iv = (0.5, 1.5)
    fpm, bar = {}, 1e-10
    if name == "quickstart":
        return "feast_sygv", (A, np.eye(n), *iv, 25), {}, fpm, \
            _inside(w, *iv), bar
    if name == "syev":
        # 2-2cos(27 pi/81) == 1.0 exactly for n = 80: keep off that tie
        exp = _inside(w, 1.01, 2.0)
        return "feast_syev", (A, 1.01, 2.0, len(exp) + 6), {}, fpm, exp, bar
    if name == "sygv":
        n = 50
        A = rng.standard_normal((n, n))
        A = (A + A.T) / 2
        B = rng.standard_normal((n, n))
        B = B @ B.T + n * np.eye(n)
        w = sla.eigh(A, B, eigvals_only=True)
        Emin, Emax = w[15] - 1e-8, w[30] + 1e-8
        exp = _inside(w, Emin, Emax)
        return "feast_sygv", (A, B, Emin, Emax, len(exp) + 5), {}, fpm, \
            exp, 1e-9
    if name in ("heev", "heev_c64"):
        H = _herm(rng, n)
        w = np.linalg.eigvalsh(H)
        Emin, Emax = w[20] - 1e-9, w[30] + 1e-9
        if name == "heev_c64":
            H = H.astype(np.complex64)
            Emin, Emax = w[20] - 1e-3, w[30] + 1e-3
        return "feast_heev", (H, Emin, Emax, 16), {}, fpm, \
            _inside(w, Emin, Emax), 1e-9 if name == "heev" else 1e-5
    if name == "hegv":
        H = _herm(rng, n)
        Bh = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
        Bh = Bh @ Bh.conj().T + n * np.eye(n)
        w = sla.eigh(H, Bh, eigvals_only=True)
        Emin, Emax = w[25] - 1e-9, w[35] + 1e-9
        return "feast_hegv", (H, Bh, Emin, Emax, 16), {}, fpm, \
            _inside(w, Emin, Emax), 1e-9
    if name == "float32":
        exp = _inside(w, *iv)
        return "feast_sygv", (A.astype(np.float32),
                              np.eye(n, dtype=np.float32), *iv,
                              len(exp) + 5), {}, fpm, exp, 1e-5
    slots = {"no_store": {10: 0}, "zolotarev": {16: 2},
             "trapezoid": {16: 1}, "trace": {6: 0}, "subspace": {14: 1},
             "stochastic": {14: 2, 32: 40}}
    if name in slots:
        M0 = {"zolotarev": 20, "trapezoid": 20, "stochastic": 8}.get(name, 14)
        return "feast_syev", (A, *iv, M0), {}, slots[name], \
            _inside(w, *iv), 1e-8 if name == "trace" else bar
    if name == "empty":
        return "feast_syev", (A, 100.0, 101.0, 8), {}, fpm, np.zeros(0), bar
    exp = _inside(w, *iv)
    if name == "feast":
        return "feast", (A, None, iv, len(exp) + 4), {}, fpm, exp, bar
    if name == "feast_B":
        return "feast", (A, np.eye(n), iv, len(exp) + 4), {}, fpm, exp, bar
    if name == "feast_contour":
        return "feast", (A, None, iv, len(exp) + 4), {"contour": 12}, fpm, \
            exp, bar
    if name == "registry":
        return "feast", (A, None, iv, len(exp) + 4), {"registry": 10}, fpm, \
            exp, bar
    # F2: feast() keywords on lap2d(16) as a sparse matrix, through the
    # polynomial filter (the sparse engine the port ran before the dense
    # and banded ones)
    A = lap2d(16)
    w = np.linalg.eigvalsh(A.toarray())
    iv = (0.0, float((w[10] + w[11]) / 2))
    kw = {"f2_parallel": {"parallel": False},
          "f2_strict": {"strict_backend": True},
          "f2_contour": {"contour": None}}[name]
    return "feast", (A, None, iv, 16), dict(kw, solver="cheb"), fpm, \
        w[:11], 1e-10


# the cases of tests/test_dense.py and F2's keywords, run in both packages
CASES = ["quickstart", "syev", "sygv", "heev", "hegv", "float32",
         "no_store", "zolotarev", "trace", "empty", "feast", "subspace",
         "stochastic", "f2_parallel", "f2_strict", "f2_contour"]
# further cases, held to LAPACK only (each would cost the JAX package a
# compilation of its own)
PORT_CASES = ["heev_c64", "trapezoid", "feast_B", "feast_contour",
              "registry"]


def _run(pkg, name, **extra):
    """One case through ``pkg`` (the JAX package or the port)."""
    from importlib import import_module
    fn, args, kw, slots, _, _ = _case(name)
    fpm = pkg.feastinit()
    for k, v in slots.items():
        fpm[k] = v
    contour = import_module(pkg.__name__ + ".core.contour")
    aux = import_module(pkg.__name__ + ".core.aux")
    if "contour" in kw and kw["contour"] is not None:
        kw = dict(kw, contour=contour.feast_contour(*args[2], ne=kw[
            "contour"]))
    if "registry" in kw:
        aux.feast_set_custom_contour(fpm, contour.feast_contour(
            *args[2], ne=kw.pop("registry")))
    if fn == "feast":
        return pkg.feast(*args[:4], fpm, **kw, **extra)
    mod = import_module(pkg.__name__ + ".solvers.dense")
    return getattr(mod, fn)(*args, fpm, **kw, **extra)


def _summary(r):
    q = np.asarray(r.q_full.cpu() if isinstance(r.q_full, torch.Tensor)
                   else r.q_full) if r.q_full is not None else None
    return dict(M=r.M, info=int(r.info), lam=np.asarray(r.lam),
                res=np.asarray(r.res), epsout=float(r.epsout),
                q_full=q if q is not None else np.zeros(0))


def _write_reference(path):
    """The JAX package's solves of every case, saved to ``path`` (the child
    process's work). Its device count is patched to one, as on one card."""
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import feastkit_tpu as ref_ft
    from feastkit_tpu.core import backend as ref_backend
    ref_backend._n_devices = lambda: 1
    out = {}
    for name in CASES:
        for k, v in _summary(_run(ref_ft, name)).items():
            out[f"{name}/{k}"] = v
    np.savez(path, **out)


# the JAX package's solves are small: XLA's CPU compile, not their run,
# is their cost, so the child compiles without LLVM's costly passes
# (no fast-math; the same IEEE operations)
_FAST_COMPILE = ("--xla_backend_optimization_level=0 "
                 "--xla_llvm_disable_expensive_passes=true")

_CHILD = ("import os, runpy, sys; "
          "os.sched_setaffinity(0, {int(c) for c in sys.argv[1].split(',')}); "
          "sys.argv = sys.argv[2:]; runpy.run_path(sys.argv[0], "
          "run_name='__main__')")


def _reference_command(path):
    """This file as a script on ``path``, kept to the last two cores of
    this process's set (affinity set before JAX sizes its thread pools)."""
    if not hasattr(os, "sched_setaffinity"):
        return [sys.executable, __file__, str(path)]
    cpus = ",".join(str(c) for c in sorted(os.sched_getaffinity(0))[-2:])
    return [sys.executable, "-c", _CHILD, cpus, __file__, str(path)]


@pytest.fixture(scope="module")
def solves(tmp_path_factory):
    """(reference, port) summaries of every case."""
    path = tmp_path_factory.mktemp("dense_reference") / "reference.npz"
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (root, os.environ.get("PYTHONPATH")) if p),
        XLA_FLAGS=" ".join(filter(None, (os.environ.get("XLA_FLAGS"),
                                         _FAST_COMPILE))))
    child = subprocess.Popen(_reference_command(path), env=env)
    try:
        port = {name: _run(ft, name, device="cpu")
                for name in CASES + PORT_CASES}
        assert child.wait(timeout=600) == 0, "the reference solves failed"
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
    with np.load(path) as f:
        ref = {name: {k: f[f"{name}/{k}"] for k in (
            "M", "info", "lam", "res", "epsout", "q_full")} for name in CASES}
    return ref, port


@pytest.mark.parametrize("name", [c for c in CASES + PORT_CASES
                                  if c not in ("subspace", "stochastic")])
def test_matches_reference(solves, name):
    ref, port = solves
    g = port[name]
    _, args, _, _, exact, bar = _case(name)
    lam = np.sort(g.lam)
    # an interval with no eigenvalue never converges (M = 0)
    assert g.M == len(exact)
    assert int(g.info) == (5 if name == "empty" else 0)
    if name in ref:
        assert g.M == int(ref[name]["M"])
        assert int(g.info) == int(ref[name]["info"])
        assert np.abs(lam - np.sort(ref[name]["lam"])).max(
            initial=0.0) <= bar
    assert np.abs(lam - exact).max(initial=0.0) <= bar
    # residuals below the bar, or the solve's own tolerance where a
    # single-precision one is looser (sqrt(eps_f32))
    tol = feast_tolerance(feastdefault(ft.feastinit()), args[0].dtype)
    assert float(np.max(g.res, initial=0.0)) <= max(bar, tol)
    assert g.q.shape[1] == g.M and bool(torch.isfinite(g.q).all())
    assert g.q.is_complex() == name.startswith(("heev", "hegv"))


def test_quickstart_eigenvectors(solves):
    r = solves[1]["quickstart"]
    A = torch.as_tensor(laplacian_1d(100))
    R = A @ r.q - r.q * torch.as_tensor(r.lam)[None, :]
    assert float(torch.linalg.vector_norm(R, dim=0).max()) < 1e-8


def test_float32_stays_single(solves):
    r = solves[1]["float32"]
    assert r.lam.dtype == np.float32 and r.q.dtype == torch.float32


def test_subspace_only_matches_reference(solves):
    """fpm[14] = 1: the filtered subspace, orthonormal, spanning the JAX
    package's (projectors agree)."""
    ref, port = solves
    Q = port["subspace"].q_full
    assert tuple(Q.shape) == (60, 14) and port["subspace"].M == 0
    assert float((Q.mT @ Q - torch.eye(14, dtype=Q.dtype)).abs().max()) < 1e-8
    Qr = ref["subspace"]["q_full"]
    P, Pr = Q.numpy() @ Q.numpy().T, Qr @ Qr.T
    assert np.abs(P - Pr).max() < 1e-8


def test_stochastic_count_matches_reference(solves):
    ref, port = solves
    g, r = port["stochastic"], ref["stochastic"]
    true = len(_case("stochastic")[4])
    assert g.M == int(r["M"]) and int(g.info) == 0 and g.lam.size == 0
    assert abs(g.epsout - float(r["epsout"])) <= 1e-8
    assert abs(g.M - true) <= 0.25 * true + 3


def test_determinism():
    """The same problem twice: bit-identical eigenpairs, whatever numpy's
    global generator holds."""
    A = laplacian_1d(60)
    r1 = ft.feast_syev(A, 0.5, 1.5, 14, device="cpu")
    np.random.seed(123)
    r2 = ft.feast_syev(A, 0.5, 1.5, 14, device="cpu")
    assert np.array_equal(r1.lam, r2.lam)
    assert torch.equal(r1.q, r2.q)


def test_tensor_operands_match_numpy():
    A = laplacian_1d(60)
    r1 = ft.feast_sygv(A, np.eye(60), 0.5, 1.5, 14, device="cpu")
    r2 = ft.feast_sygv(torch.as_tensor(A), torch.eye(60, dtype=torch.float64),
                       0.5, 1.5, 14, device="cpu")
    assert np.array_equal(r1.lam, r2.lam)


def test_validation():
    rng = np.random.default_rng(42)
    A = rng.standard_normal((20, 20))         # not symmetric
    kw = dict(device="cpu")
    with pytest.raises(ValueError, match="symmetric/Hermitian A"):
        ft.feast(A, None, (0.0, 1.0), 5, **kw)
    As = (A + A.T) / 2
    with pytest.raises(ValueError, match="interval"):
        ft.feast(As, None, None, 5, **kw)
    with pytest.raises(ValueError, match="must be <"):
        ft.feast(As, None, (1.0, 0.0), 5, **kw)
    with pytest.warns(UserWarning, match="Gershgorin"):
        r = ft.feast(As, None, (1e6, 2e6), 5, **kw)
    assert r.M == 0
    with pytest.raises(ValueError, match="square"):
        port_dense.dense_hermitian_feast(np.zeros((3, 4)), None, 0.0, 1.0,
                                         2, **kw)
    with pytest.raises(ValueError, match="B must match A"):
        port_dense.dense_hermitian_feast(As, np.eye(3), 0.0, 1.0, 2, **kw)
    with pytest.raises(ValueError, match="M0 must be in"):
        ft.feast_syev(As, 0.0, 1.0, 21, **kw)
    r = port_dense.dense_hermitian_feast(np.zeros((0, 0)), None, 0.0, 1.0,
                                         1, **kw)
    assert r.info == ft.FeastError.ERROR_N and r.M == 0


def test_gershgorin_bounds_match_reference():
    from feastkit_tpu.interfaces.feast import feast_validate_interval as ref
    rng = np.random.default_rng(3)
    for A in (_herm(rng, 30), laplacian_1d(30)):
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            assert ft.feast_validate_interval(A, 0.0, 1.0) == \
                pytest.approx(ref(A, 0.0, 1.0), rel=1e-14)


def test_backend_conflicts():
    A = laplacian_1d(30)
    kw = dict(device="cpu")
    with pytest.raises(ValueError, match="Conflicting"):
        ft.feast(A, None, (0.5, 1.5), 8, backend="serial", parallel=True,
                 **kw)
    with pytest.raises(ValueError, match="Unknown backend"):
        ft.feast(A, None, (0.5, 1.5), 8, backend="bogus", **kw)
    assert ft.feast(A, None, (0.5, 1.5), 8, backend="serial", **kw).M > 0
    assert ft.feast(A, None, (0.5, 1.5), 8, backend=":auto", **kw).M > 0


@pytest.mark.parametrize("operand", ["sparse", "dense"])
def test_one_device_sharded_request_matches_reference(monkeypatch, operand):
    """A sharded request on one device: the JAX package's warning, then a
    serial solve; under strict_backend its RuntimeError."""
    import feastkit_tpu as ref_ft
    from feastkit_tpu.core import backend as ref_backend
    from feastkit_tpu.solvers import dense as ref_dense
    from feastkit_tpu.solvers import sparse as ref_sparse
    A, iv, M0 = _case("f2_strict")[1][0], _case("f2_strict")[1][2], 16
    if operand == "dense":
        A = laplacian_1d(40)
        iv = (0.5, 1.5)
    monkeypatch.setattr(ref_backend, "_n_devices", lambda: 1)
    # the JAX package's drivers are not run: only its selection is held
    monkeypatch.setattr(ref_sparse, "sparse_feast_interval",
                        lambda *a, **k: "serial solve")
    monkeypatch.setattr(ref_dense, "dense_hermitian_feast",
                        lambda *a, **k: "serial solve")
    for kw in (dict(parallel=True), dict(backend="sharded"),
               dict(backend="mpi")):
        with pytest.warns(UserWarning) as w_ref:
            assert ref_ft.feast(A, None, iv, M0, **kw) == "serial solve"
        with pytest.warns(UserWarning) as w_port:
            r = ft.feast(A, None, iv, M0, device="cpu", **kw)
        assert [str(w.message) for w in w_port] == \
            [str(w.message) for w in w_ref]
        assert r.M > 0 and int(r.info) == 0
        with pytest.raises(RuntimeError) as e_ref:
            ref_ft.feast(A, None, iv, M0, strict_backend=True, **kw)
        with pytest.raises(RuntimeError) as e_port:
            ft.feast(A, None, iv, M0, strict_backend=True, device="cpu",
                     **kw)
        first = str(e_ref.value).split(". ")[0]
        assert first == "backend='sharded' requires >= 2 devices but only " \
            "1 visible"
        assert str(e_port.value).startswith(first + ".")


def test_two_devices_refuse_the_sharded_backend(monkeypatch):
    """On two or more ranks anything that resolves to sharded runs the
    sharded drivers of ``parallel/pfeast.py`` (no longer refused): sparse
    operands ``pfeast_sparse``, including under "auto"; dense ones shard
    only on request (``pfeast_dense``), as in the JAX package."""
    from feastkit_tpu_torch.parallel import pfeast as port_pf
    monkeypatch.setattr(port_backend, "_n_devices", lambda device=None: 2)
    seen = []
    for fn in ("pfeast_sparse", "pfeast_dense"):
        monkeypatch.setattr(port_pf, fn, lambda *a, _fn=fn, **k: seen.append(
            (_fn, str(k.get("device")), k.get("hermitian"))) or _fn)
    A, iv = _case("f2_strict")[1][0], _case("f2_strict")[1][2]
    kw = dict(device="cpu")
    for bk in (dict(parallel=True), dict(backend="sharded"), {},
               dict(strict_backend=True)):
        assert ft.feast(A, None, iv, 16, **bk, **kw) == "pfeast_sparse"
    assert ft.feast(A, None, iv, 16, parallel=False, **kw).M == 11
    D = laplacian_1d(40)
    assert ft.feast(D, None, (0.5, 1.5), 16, **kw).M > 0
    assert ft.feast(D, None, (0.5, 1.5), 16, parallel=True, **kw) \
        == "pfeast_dense"
    assert seen == [("pfeast_sparse", "cpu", None)] * 4 + [
        ("pfeast_dense", "cpu", False)]


if __name__ == "__main__":
    _write_reference(sys.argv[1])
