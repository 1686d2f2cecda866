"""PyTorch port: the general-contour family (dense, banded, polynomial)
against the JAX package.

Mirrors tests/test_general.py and the general cases of tests/test_banded.py
(``test_gbev_general``, ``test_sbev_complex_symmetric``): feast_geev on a
diagonal with hand-placed complex eigenvalues and on a random complex
matrix (also a rotated ellipse of aspect ratio 0.5, the trace
convergence criterion fpm[6] = 0, and in complex64 a normal matrix with
its eigenvalues),
feast_gegv, a real non-symmetric matrix, feast_geev_complex_sym,
feast_general's routing of a complex-symmetric A, fpm[10] = 0, the
trapezoid rule, feast_pep (quadratic, companion), the linear polynomial,
feast_pep_direct (the Beyn scheme), feast_gbev, feast_gbgv,
feast_sbev_complex and feast_sbgv_complex. Every case runs in both packages from the same seeded numpy inputs (the
JAX package at x64 on the CPU, the port on the CPU with torch on one
thread): the same M and info, eigenvalues within 1e-7 of each other and
of LAPACK (1e-5 max(1, |lam|) in complex64; the Beyn scheme's LAPACK bar
is its quadrature's, 1e-2), residuals below the solve's tolerance.

Held bit for bit, in this process: the full-contour rules (Gauss as two
half-arcs, trapezoid, aspect ratio, rotation), the user-contour weights,
the expert and custom-weight contours, the rational filters, the inside
predicates, the Cauchy weights and polygon membership, the complex seeded
Q0 and the |lam| ordering of ``inside_first_order(general=True)``.
``generalized_eig`` on seeded pencils against both of the JAX package's
methods (1e-12), and one ``make_general_body`` step from the JAX
package's state after a loop (``general_state_from_reference``): Ritz
values and residuals within 1e-10. Port-only: the API's routing (an
operator runs the matrix-free drivers, the sharded backend as in F2), the validation,
fpm[14] = 2 (the count; feast_pep_direct solves) and ``feast_summary``.

The JAX package's solves run once, in three child processes (this file run
as a script), each kept to one core and compiled without LLVM's costly
passes, while the port's run here.
"""
import io
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


def _inside(w, Emid, r, aspect=1.0, rot=0.0):
    mask = ft.feast_inside_gcontour(np.asarray(w), complex(Emid), r,
                                    aspect_ratio=aspect, rotation_deg=rot)
    return np.asarray(w)[np.asarray(mask)]


def _match_err(got, exp, rel=False):
    """Largest eigenvalue distance under the optimal assignment (sorting
    complex values is ambiguous where real parts tie to rounding);
    ``rel``: relative to max(1, |lam|)."""
    from scipy.optimize import linear_sum_assignment
    got, exp = np.asarray(got), np.asarray(exp)
    assert len(got) == len(exp)
    if len(got) == 0:
        return 0.0
    D = np.abs(got[:, None] - exp[None, :])
    if rel:
        D = D / np.maximum(1.0, np.abs(exp))[None, :]
    ri, ci = linear_sum_assignment(D)
    return D[ri, ci].max()


def _full_to_banded(A, kl, ku):
    n = A.shape[0]
    bands = np.zeros((kl + ku + 1, n), A.dtype)
    for d in range(-kl, ku + 1):
        for j in range(n):
            i = j - d
            if 0 <= i < n:
                bands[ku - d, j] = A[i, j]
    return bands


def _banded_random(rng, N, kl, ku):
    A = np.zeros((N, N), complex)
    for d in range(-kl, ku + 1):
        v = rng.standard_normal(N - abs(d)).astype(float)
        v = v + 1j * rng.standard_normal(N - abs(d))
        A += np.diag(v, d)
    return A


def _quadratic(rng, n):
    M = np.eye(n) + 0.1 * rng.standard_normal((n, n))
    C = 0.3 * rng.standard_normal((n, n))
    K = rng.standard_normal((n, n))
    Ac = np.block([[np.zeros((n, n)), np.eye(n)], [-K, -C]])
    Bc = np.block([[np.eye(n), np.zeros((n, n))],
                   [np.zeros((n, n)), M]])
    return K, C, M, sla.eig(Ac, Bc, right=False)


def case(name):
    """(run(pkg, **extra) -> result, LAPACK's eigenvalues, bar to LAPACK,
    bar to the JAX package, relative) of a case."""
    rng = np.random.default_rng(42)
    mod = {"dense": ".solvers.dense_general", "banded": ".solvers.banded"}

    def call(where, fn, *args, slots=None, **kw):
        def run(pkg, **extra):
            from importlib import import_module
            m = pkg if where is None else import_module(
                pkg.__name__ + mod[where])
            fpm = pkg.feastinit()
            for k, v in (slots or {}).items():
                fpm[k] = v
            return getattr(m, fn)(*args, fpm, **kw, **extra)
        return run

    if name == "geev_diag":
        lam = np.array([0.5 + 0.1j, 0.7 - 0.2j, 1.0 + 0.0j, 2.5 + 1.0j,
                        -1.0 + 0.5j, 0.9 + 0.3j])
        return (call("dense", "feast_geev", np.diag(lam), 0.8 + 0.0j, 0.6,
                     5), _inside(lam, 0.8, 0.6), 1e-10, 1e-10, False)
    if name in ("geev_random", "geev_c64", "geev_rot", "no_store",
                "trace"):
        n = 50
        A = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
        w = np.linalg.eigvals(A)
        slots = {"geev_rot": {18: 50, 19: 30}, "no_store": {10: 0},
                 "trace": {6: 0}}.get(name, {})
        aspect, rot = (0.5, 30.0) if name == "geev_rot" else (1.0, 0.0)
        exp = _inside(w, w[10], 1.5, aspect, rot)
        if name == "geev_c64":
            # a normal matrix with A's eigenvalues: single precision
            # resolves them to its own eps, where A's non-normality would
            # cost a factor of its eigenvalues' condition
            U, _ = np.linalg.qr(rng.standard_normal((n, n))
                                + 1j * rng.standard_normal((n, n)))
            An = ((U * w[None, :]) @ U.conj().T).astype(np.complex64)
            return (call("dense", "feast_geev", An, w[10], 1.5,
                         len(exp) + 6), exp, 1e-5, 1e-5, True)
        return (call("dense", "feast_geev", A, w[10], 1.5, len(exp) + 6,
                     slots=slots), exp, 1e-7, 1e-7, False)
    if name == "gegv":
        n = 40
        A = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
        B = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n)) \
            + 4 * np.eye(n)
        w = sla.eig(A, B, right=False)
        exp = _inside(w, w[5], 1.0)
        return (call("dense", "feast_gegv", A, B, w[5], 1.0,
                     min(len(exp) + 6, n)), exp, 1e-7, 1e-7, False)
    if name == "geev_real":
        n = 40
        A = rng.standard_normal((n, n))
        w = np.linalg.eigvals(A)
        real_w = w[np.abs(w.imag) < 1e-12]
        Emid = complex(np.median(real_w.real), 0.0)
        exp = _inside(w, Emid, 1.2)
        return (call("dense", "feast_geev", A, Emid, 1.2,
                     min(len(exp) + 6, n)), exp, 1e-7, 1e-7, False)
    if name in ("csym", "api_csym"):
        n = 40 if name == "csym" else 30
        A = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
        A = (A + A.T) / 2
        w = np.linalg.eigvals(A)
        exp = _inside(w, w[0], 1.5)
        if name == "csym":
            return (call("dense", "feast_geev_complex_sym", A, w[0], 1.5,
                         min(len(exp) + 6, n)), exp, 1e-7, 1e-7, False)
        return (lambda pkg, **extra: pkg.feast_general(
            A, None, w[0], 1.5, min(len(exp) + 5, n), **extra)), \
            exp, 1e-7, 1e-7, False
    if name == "trapezoid":
        lam = np.array([0.2 + 0.1j, 0.5 - 0.3j, 3.0 + 0.0j])
        return (call("dense", "feast_geev", np.diag(lam), 0.3 + 0.0j, 0.7,
                     3, slots={16: 1}), _inside(lam, 0.3, 0.7), 1e-10,
                1e-10, False)
    if name in ("pep", "pep_direct"):
        n = 16 if name == "pep" else 20
        K, C, M, w = _quadratic(rng, n)
        exp = _inside(w, 0.0, 1.0)
        M0 = min(len(exp) + 6, 2 * n)
        if name == "pep":
            return (call(None, "feast_polynomial", [K, C, M], 0.0 + 0.0j,
                         1.0, M0), exp, 1e-7, 1e-7, False)
        return (call(None, "feast_polynomial", [K, C, M], 0.0 + 0.0j, 1.0,
                     M0, slots={8: 64, 4: 3}, method="direct"), exp, 1e-2,
                1e-7, False)
    if name == "pep_linear":
        n = 12
        A0 = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
        A1 = np.eye(n) + 0.05 * rng.standard_normal((n, n))
        w = sla.eig(-A0, A1, right=False)
        exp = _inside(w, w[0], 1.0)
        return (call(None, "feast_polynomial", [A0, A1], w[0], 1.0,
                     min(len(exp) + 4, n)), exp, 1e-7, 1e-7, False)
    if name == "gbev":
        n = 40
        A = _banded_random(rng, n, 2, 1)
        w = np.linalg.eigvals(A)
        exp = _inside(w, w[0], 1.0)
        return (call("banded", "feast_gbev", _full_to_banded(A, 2, 1), 2, 1,
                     w[0], 1.0, min(len(exp) + 6, n)), exp, 1e-7, 1e-7,
                False)
    if name in ("sbev_csym", "sbgv_csym"):
        n = 40
        A = _banded_random(rng, n, 2, 2)
        A = (A + A.T) / 2
        if name == "sbev_csym":
            w = np.linalg.eigvals(A)
            exp = _inside(w, w[0], 1.2)
            return (call("banded", "feast_sbev_complex",
                         _full_to_banded(A, 2, 2), 2, 2, w[0], 1.2,
                         min(len(exp) + 5, n)), exp, 1e-7, 1e-7, False)
        d = 2.0 + rng.random(n)
        B = np.diag(d) + np.diag(0.1 * np.ones(n - 1), 1) \
            + np.diag(0.1 * np.ones(n - 1), -1)
        w = sla.eig(A, B, right=False)
        exp = _inside(w, w[3], 0.8)
        return (call("banded", "feast_sbgv_complex",
                     _full_to_banded(A, 2, 2), 2, 2,
                     _full_to_banded(B.astype(complex), 1, 1), 1, 1, w[3],
                     0.8, min(len(exp) + 5, n)), exp, 1e-7, 1e-7, False)
    if name == "gbgv":
        n = 40
        A = _banded_random(rng, n, 1, 2)
        B = np.diag(3.0 + rng.random(n)) + np.diag(0.2 * np.ones(n - 1), 1)
        w = sla.eig(A, B, right=False)
        exp = _inside(w, w[2], 0.7)
        return (call("banded", "feast_gbgv", _full_to_banded(A, 1, 2), 1, 2,
                     _full_to_banded(B.astype(complex), 0, 1), 0, 1, w[2],
                     0.7, min(len(exp) + 5, n)), exp, 1e-7, 1e-7, False)
    raise KeyError(name)


CASES = ["geev_diag", "geev_random", "geev_c64", "geev_rot", "no_store",
         "trace", "gegv", "geev_real", "csym", "api_csym", "trapezoid",
         "pep", "pep_direct", "pep_linear", "gbev", "sbev_csym", "gbgv",
         "sbgv_csym"]
# the cases of each child process, about a third of the JAX package's
# compile and run time each (a banded solve costs it ~15 s of compilation,
# a dense one ~2 s)
CHILD_CASES = (CASES[:14], CASES[14:16], CASES[16:])


def _summary(r):
    q = r.q.cpu().numpy() if isinstance(r.q, torch.Tensor) else r.q
    return dict(M=r.M, info=int(r.info), lam=np.asarray(r.lam),
                res=np.asarray(r.res), loop=int(r.loop),
                q=np.asarray(q))


def _write_reference(path, names):
    """The JAX package's solves of the cases ``names``, saved to ``path``
    (a child process's work)."""
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import feastkit_tpu as ref_ft
    out = {}
    for name in names:
        for k, v in _summary(case(name)[0](ref_ft)).items():
            out[f"{name}/{k}"] = v
    np.savez(path, **out)


# the JAX package's solves are small: XLA's CPU compile, not their run, is
# their cost, so the children compile without LLVM's costly passes (no
# fast-math; the same IEEE operations)
_FAST_COMPILE = ("--xla_backend_optimization_level=0 "
                 "--xla_llvm_disable_expensive_passes=true")

_CHILD = ("import os, runpy, sys; "
          "os.sched_setaffinity(0, {int(c) for c in sys.argv[1].split(',')}); "
          "sys.argv = sys.argv[2:]; runpy.run_path(sys.argv[0], "
          "run_name='__main__')")


def _reference_command(path, child):
    """This file as a script on ``path`` for the cases of
    CHILD_CASES[child], kept to one core of this process's set, the eighth
    (child 0), the third (child 1) or the second (child 2) from last where
    there is one (affinity set before JAX sizes its thread pools)."""
    args = [__file__, str(path), str(child)]
    if not hasattr(os, "sched_setaffinity"):
        return [sys.executable] + args
    cpus = sorted(os.sched_getaffinity(0))
    back = (8, 3, 2)[child]
    cpu = cpus[-back] if len(cpus) >= back else cpus[-1]
    return [sys.executable, "-c", _CHILD, str(cpu)] + args


@pytest.fixture(scope="module")
def solves(tmp_path_factory):
    """(reference, port): the JAX package's results from the children and
    the port's."""
    where = tmp_path_factory.mktemp("general_reference")
    paths = [where / f"ref{i}.npz" for i in range(len(CHILD_CASES))]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (root, os.environ.get("PYTHONPATH")) if p),
        XLA_FLAGS=" ".join(filter(None, (os.environ.get("XLA_FLAGS"),
                                         _FAST_COMPILE))))
    children = [subprocess.Popen(_reference_command(path, i), env=env)
                for i, path in enumerate(paths)]
    try:
        port = {name: case(name)[0](ft, device="cpu")
                for name in CASES}
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
    r = port[name]
    _, exp, bar, bar_ref, rel = case(name)
    assert r.M == len(exp)
    assert int(r.info) == (5 if name == "pep_direct" else 0)
    assert r.M == int(ref[f"{name}/M"])
    assert int(r.info) == int(ref[f"{name}/info"])
    assert _match_err(r.lam, ref[f"{name}/lam"], rel) <= bar_ref
    assert _match_err(r.lam, exp, rel) <= bar
    assert isinstance(r, ft.FeastGeneralResult) and r.converged == (
        name != "pep_direct")
    assert r.q.is_complex() and tuple(r.q.shape)[1] == r.M
    if name != "pep_direct":
        tol = 10.0 ** -12 if r.lam.dtype == np.complex128 \
            else float(np.sqrt(np.finfo(np.float32).eps))
        assert float(np.max(r.res, initial=0.0)) <= tol


def test_single_precision_stays_single(solves):
    r = solves[1]["geev_c64"]
    assert r.lam.dtype == np.complex64 and r.q.dtype == torch.complex64


def test_polynomial_eigenvectors(solves):
    """The companion route's eigenvectors (the first N rows) satisfy the
    quadratic: (lam^2 M + lam C + K) x ~ 0, as in the JAX package's test."""
    r = solves[1]["pep"]
    K, C, M, _ = _quadratic(np.random.default_rng(42), 16)
    assert tuple(r.q.shape) == (16, r.M)
    q = r.q.numpy()
    for j in range(r.M):
        lam = r.lam[j]
        assert np.linalg.norm((lam ** 2 * M + lam * C + K) @ q[:, j]) < 1e-5


# ---------------------------------------------------------------------------
# Host numerics, bit for bit
# ---------------------------------------------------------------------------

GCONTOURS = [dict(ne=16), dict(ne=7), dict(ne=16, quadrature=1),
             dict(ne=9, quadrature=1, aspect_ratio=0.4),
             dict(ne=12, aspect_ratio=2.5, rotation_deg=35),
             dict(ne=10, quadrature=1, rotation_deg=-120)]


@pytest.mark.parametrize("kw", GCONTOURS)
def test_gcontour_bit_identical(kw):
    from feastkit_tpu.core import contour as ref
    from feastkit_tpu_torch.core import contour as port
    c_ref = ref.feast_gcontour(0.3 - 0.7j, 1.25, **kw)
    c_port = port.feast_gcontour(0.3 - 0.7j, 1.25, **kw)
    assert np.array_equal(c_port.Zne, c_ref.Zne)
    assert np.array_equal(c_port.Wne, c_ref.Wne)
    lam = np.random.default_rng(1).standard_normal(40) * 1.5 \
        + 1j * np.random.default_rng(2).standard_normal(40)
    assert np.array_equal(port.feast_grationalx(c_port.Zne, c_port.Wne, lam),
                          ref.feast_grationalx(c_ref.Zne, c_ref.Wne, lam))
    a, rot = kw.get("aspect_ratio", 1.0), kw.get("rotation_deg", 0.0)
    assert np.array_equal(
        port.feast_inside_gcontour(lam, 0.3 - 0.7j, 1.25, aspect_ratio=a,
                                   rotation_deg=rot),
        ref.feast_inside_gcontour(lam, 0.3 - 0.7j, 1.25, aspect_ratio=a,
                                  rotation_deg=rot))


def test_gcontour_from_fpm_bit_identical():
    from feastkit_tpu.core import contour as ref
    from feastkit_tpu_torch.core import contour as port
    import feastkit_tpu as ref_ft
    for slots in ({}, {8: 24}, {16: 1, 8: 11}, {18: 60, 19: 45}):
        fpm_p, fpm_r = ft.feastinit(), ref_ft.feastinit()
        for k, v in slots.items():
            fpm_p[k] = v
            fpm_r[k] = v
        c_p = port.feast_gcontour(1.0 + 0.5j, 0.8, fpm_p)
        c_r = ref.feast_gcontour(1.0 + 0.5j, 0.8, fpm_r)
        assert np.array_equal(c_p.Zne, c_r.Zne)
        assert np.array_equal(c_p.Wne, c_r.Wne)
        lam = np.array([1.0 + 0.5j, 1.7 + 0.5j, 1.0 + 1.25j, 2.0 - 1.0j])
        assert np.array_equal(
            port.feast_inside_gcontour(lam, 1.0 + 0.5j, 0.8, fpm=fpm_p),
            ref.feast_inside_gcontour(lam, 1.0 + 0.5j, 0.8, fpm=fpm_r))
        assert np.array_equal(port.feast_grational(lam, 1.0 + 0.5j, 0.8,
                                                   fpm_p),
                              ref.feast_grational(lam, 1.0 + 0.5j, 0.8,
                                                  fpm_r))
    with pytest.raises(ValueError, match="Zolotarev"):
        port.feast_gcontour(0.0, 1.0, quadrature=2)
    with pytest.raises(ValueError, match="radius"):
        port.feast_gcontour(0.0, 0.0)


@pytest.mark.parametrize("orientation", [1, -1])
def test_custom_contours_bit_identical(orientation):
    """The corrected Cauchy weight and the shoelace orientation test, the
    custom-weight and expert contours, the Cauchy weights and polygon
    membership of the aux module."""
    from feastkit_tpu.core import aux as ref_aux
    from feastkit_tpu.core import contour as ref
    from feastkit_tpu_torch.core import aux as port_aux
    from feastkit_tpu_torch.core import contour as port
    t = orientation * np.linspace(0, 2 * np.pi, 13)[:-1]
    Z = 0.5 + 0.2j + np.cos(t) + 0.6j * np.sin(t)
    c_p, c_r = port.feast_customcontour(Z), ref.feast_customcontour(Z)
    assert np.array_equal(c_p.Zne, c_r.Zne)
    assert np.array_equal(c_p.Wne, c_r.Wne)
    assert np.array_equal(port_aux.feast_cauchy_weights(Z),
                          ref_aux.feast_cauchy_weights(Z))
    pts = np.array([0.5 + 0.2j, 1.4 + 0.2j, 1.6 + 0.2j, 0.5 + 0.75j,
                    0.5 + 0.85j, -0.4 - 0.1j])
    assert np.array_equal(port_aux.feast_inside_contourx(pts, Z),
                          ref_aux.feast_inside_contourx(pts, Z))
    W = np.arange(12) * (0.1 + 0.2j)
    for a, b in ((port.feast_contour_custom_weights(Z, W),
                  ref.feast_contour_custom_weights(Z, W)),
                 (port.feast_contour_expert(-1.0, 2.0, 6, 1, 70),
                  ref.feast_contour_expert(-1.0, 2.0, 6, 1, 70)),
                 (port.feast_contour_expert(-1.0, 2.0, 8, 2),
                  ref.feast_contour_expert(-1.0, 2.0, 8, 2))):
        assert np.array_equal(a.Zne, b.Zne) and np.array_equal(a.Wne, b.Wne)
    x = np.linspace(-2.0, 3.0, 41)
    assert np.array_equal(port.feast_rational(x, -1.0, 2.0),
                          ref.feast_rational(x, -1.0, 2.0))
    assert np.array_equal(port.feast_rational(x, -1.0, 2.0, quadrature=2,
                                              ne=8),
                          ref.feast_rational(x, -1.0, 2.0, quadrature=2,
                                             ne=8))
    assert np.array_equal(port.feast_inside_contour(x, -1.0, 2.0),
                          ref.feast_inside_contour(x, -1.0, 2.0))
    assert port.zolotarev_point(8, 3) == ref.zolotarev_point(8, 3)
    assert port.zolotarev_point(8, 0) == ref.zolotarev_point(8, 0)
    assert port_aux.check_complex_symmetric(Z[:, None] * Z[None, :]) \
        is ref_aux.check_complex_symmetric(Z[:, None] * Z[None, :]) is True
    with pytest.raises(ValueError, match="same length"):
        port.feast_contour_custom_weights(Z, W[:3])


@pytest.mark.parametrize("N,M0,dtype", [(50, 11, np.complex128),
                                        (300, 24, np.complex64),
                                        (7, 7, np.complex128)])
def test_general_q0_bit_identical(N, M0, dtype):
    from feastkit_tpu.core import tools as ref
    from feastkit_tpu_torch.core import tools as port
    fpm = ft.feastinit()
    assert np.array_equal(
        port.initial_subspace(fpm, None, N, M0, dtype, general=True),
        ref.initial_subspace(fpm, None, N, M0, dtype, general=True))
    # a warm start shorter than M0 is padded with the seeded columns
    fpm[5] = 1
    Q = np.ones((N, 2), dtype)
    assert np.array_equal(
        port.initial_subspace(fpm, Q, N, M0, dtype, general=True),
        ref.initial_subspace(fpm, Q, N, M0, dtype, general=True))


def test_inside_first_order_general_bit_identical():
    from feastkit_tpu.core import tools as ref
    from feastkit_tpu_torch.core import tools as port
    rng = np.random.default_rng(5)
    lam = rng.standard_normal(64) + 1j * rng.standard_normal(64)
    lam[10:14] = lam[3]                        # ties keep their order
    lam[20] = -lam[5]                          # equal modulus
    inside = rng.random(64) < 0.4
    want = np.asarray(ref.inside_first_order(lam, inside, general=True))
    got = port.inside_first_order(torch.as_tensor(lam),
                                  torch.as_tensor(inside), general=True)
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("n,seed", [(6, 0), (16, 1)])
def test_generalized_eig_matches_reference(n, seed):
    """Seeded pencils, G well conditioned and G rank-deficient by one
    direction: the port's LAPACK path against both of the JAX package's
    methods (host callback, on-device QR)."""
    from feastkit_tpu.ops import eig as ref
    from feastkit_tpu_torch.ops import eig as port
    rng = np.random.default_rng(seed)
    S = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    G = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    G = G @ G.conj().T + n * np.eye(n)
    lam, V = port.generalized_eig(torch.as_tensor(S), torch.as_tensor(G))
    lam = lam.numpy()
    for method in ("callback", "qr"):
        w, _ = ref.generalized_eig(S, G, method=method)
        assert _match_err(lam, np.asarray(w)) <= 1e-12, method
    w_cb, _ = ref.generalized_eig(S, G, method="callback")
    # the same ascending (Re, Im) order as the host callback's
    assert np.abs(lam - np.asarray(w_cb)).max() <= 1e-12
    R = S @ V.numpy() - G @ V.numpy() * lam[None, :]
    assert np.abs(R).max() <= 1e-10 * np.abs(S).max()
    assert np.array_equal(port.generalized_eig(
        torch.as_tensor(S), torch.as_tensor(G), method="qr")[0].numpy(), lam)
    with pytest.raises(ValueError, match="eig method"):
        port.general_eig(torch.as_tensor(S), method="schur")


ENTRY_POINTS = {
    "dense": lambda **kw: ft.feast_geev(np.diag([0.5 + 0.1j, 1.0, 2.5j]),
                                        0.6, 0.3, 2, **kw),
    "banded": lambda **kw: ft.feast_gbev(
        np.array([[0.0, 0.1, 0.1], [0.5 + 0.1j, 1.0, 2.5j]]), 0, 1, 0.6,
        0.3, 2, **kw),
    "sparse": lambda **kw: ft.feast_gcsrev(
        sp.diags([[0.5 + 0.1j, 1.0, 2.5j]], [0], format="csr"), 0.6, 0.3,
        2, **kw),
    "pep_direct": lambda **kw: ft.feast_pep_direct(
        [-np.diag([0.5 + 0.1j, 1.0, 2.5j]), np.eye(3)], 0.6, 0.3, 2, **kw),
}


@pytest.mark.parametrize("entry", sorted(ENTRY_POINTS))
def test_eig_method_checked_at_entry(entry):
    """Each general entry point takes the JAX package's ``eig_method``:
    "qr" runs the same host LAPACK path as the default, bit for bit, and
    an unknown name raises before any work."""
    run = ENTRY_POINTS[entry]
    r = run(device="cpu")
    r_qr = run(device="cpu", eig_method="qr")
    assert r.M == r_qr.M == 1 and np.array_equal(r.lam, r_qr.lam)
    with pytest.raises(ValueError, match="eig method"):
        run(device="cpu", eig_method="schur")


def test_one_body_step_matches_reference():
    """One refinement step of each package's ``make_general_body`` from
    the JAX package's state after one loop, on a dense general pencil:
    the Ritz values and residuals within 1e-10."""
    import jax.numpy as jnp
    from feastkit_tpu.kernel import general as ref_general
    from feastkit_tpu.solvers import dense_general as ref_dg
    from feastkit_tpu_torch import convert
    from feastkit_tpu_torch.kernel import general as port_general
    from feastkit_tpu_torch.solvers import dense_general as port_dg
    rng = np.random.default_rng(7)
    n, M0 = 40, 14
    A = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    B = np.eye(n) + 0.1 * (rng.standard_normal((n, n))
                           + 1j * rng.standard_normal((n, n)))
    w = sla.eig(A, B, right=False)
    Emid, r = complex(w[4]), 1.6
    c = ft.feast_gcontour(Emid, r, ne=16)
    Zne, Wne = c.Zne.astype(np.complex128), c.Wne.astype(np.complex128)
    from feastkit_tpu_torch.core.tools import initial_subspace
    Q0 = initial_subspace(ft.feastinit(), None, n, M0, np.complex128,
                          general=True)
    ops_r = ref_dg._general_ops(jnp.asarray(A), jnp.asarray(B),
                                jnp.asarray(Zne), jnp.asarray(Wne),
                                standard=False, store_factorization=True)
    body_r = ref_general.make_general_body(*ops_r, Emid, r, tol=1e-12)
    s1 = body_r(ref_general.init_general_state(jnp.asarray(Q0)))
    s2_ref = body_r(s1)
    ops_p = port_dg._general_ops(torch.as_tensor(A), torch.as_tensor(B),
                                 torch.as_tensor(Zne), torch.as_tensor(Wne),
                                 standard=False, store_factorization=True)
    body_p = port_general.make_general_body(*ops_p, Emid, r, tol=1e-12)
    s1_p = convert.general_state_from_reference(s1, device="cpu")
    assert s1_p.lam.is_complex() and s1_p.trace.is_complex()
    s2 = body_p(s1_p, float(s1.epsout))
    inside = np.asarray(s2_ref.inside)
    assert np.array_equal(s2.inside.numpy(), inside) and inside.sum() > 0
    lam_r, res_r = np.asarray(s2_ref.lam), np.asarray(s2_ref.res)
    lam_p, res_p = s2.lam.numpy(), s2.res.numpy()
    k = int(inside.sum())
    assert np.abs(lam_p[:k] - lam_r[:k]).max() <= 1e-10
    assert np.abs(res_p[:k] - res_r[:k]).max() <= 1e-10
    assert s2.loop == int(s2_ref.loop)
    assert abs(complex(s2.trace) - complex(s2_ref.trace)) <= 1e-10


# ---------------------------------------------------------------------------
# The API: routing, validation, the stochastic count, the summary
# ---------------------------------------------------------------------------

def _small_general(n=30, seed=3):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    w = np.linalg.eigvals(A)
    return A, w, _inside(w, w[2], 1.5)


def test_operators_raise_item_13():
    """Operators, which raised item 13 until the matrix-free drivers were
    ported, now run them: feast_general on a LinearOperator, and
    feast_polynomial on arrays with method="matfree" or with an operator
    coefficient (P(lam) = A + lam I, so lam = -w), each with the dense
    driver's M and info (tests/test_torch_matfree.py holds these drivers
    to the JAX package)."""
    A, w, exp = _small_general()
    op = ft.LinearOperator.from_matrix(A)
    neg = _inside(-w, -w[2], 1.5)
    for call, want in (
            (lambda: ft.feast_general(op, None, w[2], 1.5, 12,
                                      device="cpu"), exp),
            (lambda: ft.feast_polynomial([A, np.eye(30)], -w[2], 1.5, 12,
                                         method="matfree", device="cpu"),
             neg),
            (lambda: ft.feast_polynomial([op, np.eye(30)], -w[2], 1.5, 12,
                                         device="cpu"), neg)):
        r = call()
        assert r.M == len(want) and int(r.info) == 0
        assert _match_err(r.lam, want) <= 1e-7


def test_one_device_sharded_request_matches_reference(monkeypatch):
    """A dense sharded request on one device: the JAX package's warning,
    then a serial solve; under strict_backend its RuntimeError."""
    import feastkit_tpu as ref_ft
    from feastkit_tpu.core import backend as ref_backend
    from feastkit_tpu.solvers import dense_general as ref_dg
    A, w, exp = _small_general()
    monkeypatch.setattr(ref_backend, "_n_devices", lambda: 1)
    monkeypatch.setattr(port_backend, "_n_devices", lambda device: 1)
    # the JAX package's driver is not run: only its selection is held
    monkeypatch.setattr(ref_dg, "dense_general_feast",
                        lambda *a, **k: "serial solve")
    for kw in (dict(parallel=True), dict(backend="sharded")):
        with pytest.warns(UserWarning) as w_ref:
            assert ref_ft.feast_general(A, None, w[2], 1.5, 12, **kw) \
                == "serial solve"
        with pytest.warns(UserWarning) as w_port:
            r = ft.feast_general(A, None, w[2], 1.5, 12, device="cpu", **kw)
        assert [str(x.message) for x in w_port] == \
            [str(x.message) for x in w_ref]
        assert r.M == len(exp) and int(r.info) == 0
        with pytest.raises(RuntimeError) as e_ref:
            ref_ft.feast_general(A, None, w[2], 1.5, 12, strict_backend=True,
                                 **kw)
        with pytest.raises(RuntimeError) as e_port:
            ft.feast_general(A, None, w[2], 1.5, 12, strict_backend=True,
                             device="cpu", **kw)
        assert str(e_port.value).split(". ")[0] == \
            str(e_ref.value).split(". ")[0]


def test_two_devices_refuse_a_sharded_request(monkeypatch):
    """On two or more ranks a dense sharded request runs
    ``parallel/pfeast.pfeast_general`` (no longer refused); dense operands
    shard only on request."""
    from feastkit_tpu_torch.parallel import pfeast as port_pf
    monkeypatch.setattr(port_backend, "_n_devices", lambda device=None: 2)
    seen = []
    monkeypatch.setattr(port_pf, "pfeast_general", lambda *a, **k: seen.append(
        (str(k.get("device")), k.get("bilinear"))) or "pfeast_general")
    A, w, exp = _small_general()
    for kw in (dict(parallel=True), dict(backend="sharded")):
        assert ft.feast_general(A, None, w[2], 1.5, 12, device="cpu",
                                **kw) == "pfeast_general"
    assert seen == [("cpu", False)] * 2
    # dense operands shard only on request
    assert ft.feast_general(A, None, w[2], 1.5, 12, device="cpu").M \
        == len(exp)


def test_validation_and_unported_modes():
    A, w, exp = _small_general()
    kw = dict(device="cpu")
    with pytest.raises(ValueError, match="square"):
        ft.feast_geev(np.zeros((3, 4), complex), 0.0, 1.0, 2, **kw)
    with pytest.raises(ValueError, match="B must match A"):
        ft.feast_gegv(A, np.eye(3), 0.0, 1.0, 2, **kw)
    with pytest.raises(ValueError, match="M0 must be in"):
        ft.feast_geev(A, 0.0, 1.0, 31, **kw)
    with pytest.raises(ValueError, match="radius"):
        ft.feast_geev(A, 0.0, 0.0, 5, **kw)
    with pytest.raises(ValueError, match="degree >= 1"):
        ft.feast_pep([A], 0.0, 1.0, 5, **kw)
    # the stochastic count (fpm[14] = 2) is ported: a count-only result
    # near the number inside (tests/test_torch_estimate.py holds it to
    # the JAX package); feast_pep_direct has none and solves, as there
    fpm = ft.feastinit()
    fpm[14] = 2
    bands = _full_to_banded(np.diag(np.arange(1.0, 11.0)).astype(complex),
                            0, 0)
    inside = int(np.sum(np.abs(w - w[2]) <= 1.5))
    r = ft.feast_geev(A, w[2], 1.5, 12, fpm, **kw)
    assert r.lam.size == 0 and r.M == max(int(round(r.epsout)), 0)
    assert abs(r.epsout - inside) <= 0.5 * inside + 3
    r = ft.feast_gbev(bands, 0, 0, 2.0, 1.0, 4, fpm, **kw)
    # eigenvalues 1 and 3 lie on the circle (filter value ~1/2 each)
    assert r.lam.size == 0 and r.M == 2 and abs(r.epsout - 2.0) < 0.1
    # P(lam) = A + lam I: the eigenvalues -w, those near -w[2] inside
    r = ft.feast_pep_direct([A, np.eye(30)], -w[2], 1.5, 12, fpm, **kw)
    r0 = ft.feast_pep_direct([A, np.eye(30)], -w[2], 1.5, 12, **kw)
    assert r.M == len(r.lam) == r0.M == len(exp)
    assert np.array_equal(r.lam, r0.lam)


def test_summary_and_custom_contour():
    """feast_summary names a general result; feast_custom_contour solves
    with the user's nodes (an ellipse, clockwise) through the fpm[29]
    registry and clears it afterwards."""
    A, w, exp = _small_general()
    t = -np.linspace(0, 2 * np.pi, 33)[:-1]
    Z = w[2] + 1.5 * (np.cos(t) + 1j * np.sin(t))
    from feastkit_tpu_torch.core.aux import feast_cauchy_weights
    Wn = feast_cauchy_weights(Z)
    from feastkit_tpu_torch.core import aux
    before = dict(aux._CUSTOM_CONTOURS)
    r = ft.feast_custom_contour(A, None, Z, Wn, 12, Emid=w[2], r=1.5,
                                device="cpu")
    assert aux._CUSTOM_CONTOURS == before
    assert r.M == len(exp) and int(r.info) == 0
    assert _match_err(r.lam, exp) <= 1e-7
    buf = io.StringIO()
    assert ft.feast_summary(r, file=buf) == ft.FeastError.SUCCESS
    assert buf.getvalue().startswith("FEAST general eigensolver summary")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert "Hermitian" in _summary_text(ft.feast(
            np.diag(np.arange(1.0, 9.0)), None, (1.5, 4.5), 5,
            device="cpu"))


def test_exports_the_general_family():
    """The general family's public names, as the JAX package exports
    them."""
    import feastkit_tpu as ref_ft
    names = ("feast_general feast_polynomial feast_custom_contour "
             "FeastGeneralResult feast_geev feast_gegv feast_geev_complex_sym "
             "feast_gegv_complex_sym feast_pep feast_pep_direct feast_gbev "
             "feast_gbgv feast_sbev_complex feast_sbgv_complex feast_gcsrev "
             "feast_gcsrgv feast_scsrev_complex feast_scsrgv_complex "
             "feast_scsrpev feast_hcsrpev feast_gcsrpev feast_gcontour "
             "feast_customcontour feast_contour_expert "
             "feast_contour_custom_weights feast_grational feast_grationalx "
             "feast_rational feast_rationalx feast_inside_contour "
             "feast_inside_gcontour feast_inside_contourx "
             "feast_cauchy_weights check_complex_symmetric "
             "with_custom_contour").split()
    for name in names:
        assert name in ft.__all__ and callable(getattr(ft, name)), name
        assert hasattr(ref_ft, name), name


def _summary_text(r):
    buf = io.StringIO()
    ft.feast_summary(r, file=buf)
    return buf.getvalue()


if __name__ == "__main__":
    _write_reference(sys.argv[1], CHILD_CASES[int(sys.argv[2])])
