"""PyTorch port: the matrix-free drivers against the JAX package.

Mirrors the matrix-free cases of tests/test_sparse_matfree.py: the
operator protocol, the symmetric contour solve (GMRES, BiCGStab), the
caller's own shifted solver, the general solve, the CG rejection, the
polynomial companion by operators, the Ritz warm start and the adaptive
inner tolerance (on against off), and the solve-free filters (``cheb``
with the Lanczos bounds and with given bounds, ``contour_poly``) with
their rejections. Also: the real-operator / complex-block split against
A @ X in complex128, a complex Hermitian operator, a float32 operator, a
generalized pencil of operators, the transpose pairing (``bilinear``),
the routing of ``feast``, ``feast_general`` and ``feast_polynomial``
(bare callables refused with the JAX package's errors, a sharded request
warned or refused with its texts), the seeded and the caller's Q0 bit for
bit, and fpm[14] = 2 (the count).

Every solve runs in both packages from the same numpy inputs (the JAX
package at x64 on the CPU, the port on the CPU with torch on one thread):
the same M and info, eigenvalues within 1e-9 of each other (real
symmetric and Hermitian), 1e-7 (general), 1e-5 max(1, |lam|) (float32 /
complex64), and of the exact values; ``operator_spectrum_bounds`` within
1e-8 of the span. The fixtures run at tol 1e-8 (fpm[3] = 8) unless a
case says otherwise, and the small dense ones with a restart as long as
the operator, so that a GMRES solve is one cycle. The JAX package's solves
run once, in three child processes (this file run as a script), each kept
to one core, while the port's run here.
"""
import os
import subprocess
import sys
import warnings

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import feastkit_tpu_torch as ft  # noqa: E402
from feastkit_tpu_torch.core import backend as port_backend  # noqa: E402
from feastkit_tpu_torch.solvers import matfree as port_mf  # noqa: E402


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


def _lap(n):
    return (np.diag(2.0 * np.ones(n)) + np.diag(-np.ones(n - 1), 1)
            + np.diag(-np.ones(n - 1), -1))


def _lap_eigs(n):
    return 2.0 - 2.0 * np.cos(np.arange(1, n + 1) * np.pi / (n + 1))


def _is_port(pkg):
    return pkg.__name__ == "feastkit_tpu_torch"


def _stencil(pkg, n):
    """The 1D Laplacian as a pure callable on (n, K) blocks, no matrix
    anywhere (tests/test_sparse_matfree.py's polynomial-filter operator),
    in the package's array type."""
    if _is_port(pkg):
        def mv(X):
            Xp = torch.nn.functional.pad(X, (0, 0, 1, 1))
            return 2.0 * X - Xp[:-2] - Xp[2:]
        dtype = torch.float64
    else:
        import jax.numpy as jnp

        def mv(X):
            Xp = jnp.pad(X, ((1, 1), (0, 0)))
            return 2.0 * X - Xp[:-2] - Xp[2:]
        dtype = jnp.float64
    return pkg.MatrixVecFunction(mv, (n, n), dtype, issymmetric=True)


def _solver(pkg, M):
    """The caller's shifted solver (z I - M)^-1 RHS, dense, in the
    package's array type."""
    if _is_port(pkg):
        Mt = torch.as_tensor(M)

        def solve(z, RHS):
            S = z * torch.eye(M.shape[0], dtype=RHS.dtype) - Mt.to(RHS.dtype)
            return torch.linalg.solve(S, RHS)
        return solve
    import jax.numpy as jnp
    Mj = jnp.asarray(M)

    def solve(z, RHS):
        S = z * jnp.eye(M.shape[0], dtype=RHS.dtype) - Mj.astype(RHS.dtype)
        return jnp.linalg.solve(S, RHS)
    return solve


def _gapped_general(n, seed, symmetric=False):
    """A complex matrix with n seeded eigenvalues, none with 0.55 < |lam|
    < 1.1 (so the circle of radius 0.8 about 0 is well separated): upper
    triangular with small noise (eigenvalues its diagonal), or complex
    symmetric (diagonal plus symmetric noise)."""
    rng = np.random.default_rng(seed)
    lam = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    a = np.abs(lam)
    band = (a > 0.55) & (a < 1.1)
    lam[band] *= 1.3 / a[band]
    noise = 0.05 * (rng.standard_normal((n, n))
                    + 1j * rng.standard_normal((n, n)))
    if symmetric:
        A = np.diag(lam) + 0.2 * (noise + noise.T)
        return A, np.linalg.eigvals(A)
    return np.diag(lam) + np.triu(noise, 1), lam


def _fpm(pkg):
    """The package's defaults at tol 1e-8."""
    fpm = pkg.feastinit()
    fpm[3] = 8
    return fpm


def case(name):
    """(run(pkg, **extra) -> result, exact eigenvalues, bar, general)."""
    n = 100
    A = _lap(n)
    w = _lap_eigs(n)
    sym_exp = np.sort(w[(w >= 0.5) & (w <= 0.8)])
    M0 = len(sym_exp) + 4

    if name in ("sym_gmres", "sym_bicgstab"):
        def run(pkg, **extra):
            op = pkg.LinearOperator.from_matrix(A, symmetric=True)
            return pkg.feast_matvec(op, None, (0.5, 0.8), M0, _fpm(pkg),
                                    solver=name[4:], **extra)
        return run, sym_exp, 1e-9, False
    if name == "custom_solver":
        # the default tol 1e-12, the caller's dense solve
        def run(pkg, **extra):
            op = pkg.LinearOperator.from_matrix(A, symmetric=True)
            return pkg.feast_matvec(op, None, (0.5, 0.8), M0,
                                    solve_shifted=_solver(pkg, A), **extra)
        return run, sym_exp, 1e-10, False
    if name in ("warm_on", "warm_off"):
        def run(pkg, **extra):
            env = {} if name == "warm_on" else {"FEAST_WARM_START": "0",
                                                "FEAST_ADAPTIVE_TOL": "0"}
            old = {k: os.environ.get(k) for k in env}
            os.environ.update(env)
            try:
                op = pkg.LinearOperator.from_matrix(A, symmetric=True)
                return pkg.feast_matvec(op, None, (0.5, 0.8), M0,
                                        _fpm(pkg), solver_restart=n,
                                        **extra)
            finally:
                for k, v in old.items():
                    if v is None:
                        os.environ.pop(k, None)
                    else:
                        os.environ[k] = v
        return run, sym_exp, 1e-9, False
    if name == "generalized":
        d = np.random.default_rng(5).uniform(1.0, 2.0, n)
        import scipy.linalg as sla
        wg = sla.eigh(A, np.diag(d), eigvals_only=True)
        exp = np.sort(wg[(wg >= 0.3) & (wg <= 0.5)])

        def run(pkg, **extra):
            return pkg.feast_matvec(
                pkg.LinearOperator.from_matrix(A, symmetric=True),
                pkg.LinearOperator.from_matrix(np.diag(d), symmetric=True),
                (0.3, 0.5), len(exp) + 4, _fpm(pkg), solver="bicgstab",
                **extra)
        return run, exp, 1e-9, False
    if name == "hermitian_flag":
        # a real operator in complex work on the mirrored nodes
        def run(pkg, **extra):
            op = pkg.LinearOperator.from_matrix(A, symmetric=True)
            return pkg.feast_matvec(op, None, (0.5, 0.8), M0, _fpm(pkg),
                                    solver="bicgstab", hermitian=True,
                                    **extra)
        return run, sym_exp, 1e-9, False
    if name == "float32":
        def run(pkg, **extra):
            op = pkg.LinearOperator.from_matrix(A.astype(np.float32),
                                                symmetric=True)
            return pkg.feast_matvec(op, None, (0.5, 0.8), M0, _fpm(pkg),
                                    solver="bicgstab", **extra)
        return run, sym_exp, 1e-5, False
    if name in ("hermitian_gmres", "hermitian_cheb"):
        # the 1D Laplacian under a seeded diagonal unitary gauge: complex
        # Hermitian, the Laplacian's spectrum
        nh = 64
        D = np.exp(1j * np.random.default_rng(7).uniform(0, 2 * np.pi, nh))
        H = D[:, None] * _lap(nh) * D.conj()[None, :]
        wh = _lap_eigs(nh)
        exp = np.sort(wh[(wh >= 0.5) & (wh <= 0.9)])
        solver = name.split("_")[1]
        kw = dict(solver_restart=nh) if solver == "gmres" else dict(
            bounds=(0.0, 4.0001))

        def run(pkg, **extra):
            op = pkg.LinearOperator.from_matrix(H, hermitian=True)
            return pkg.feast_matvec(op, None, (0.5, 0.9), len(exp) + 4,
                                    _fpm(pkg), solver=solver, **kw, **extra)
        return run, exp, 1e-9, False
    if name in ("cheb_lanczos", "cheb_bounds", "contour_poly"):
        # tests/test_sparse_matfree.py::test_matfree_polynomial_filters
        ns = 400
        ws = _lap_eigs(ns)
        Emin, Emax = float(ws[0] * 0.5), float(0.5 * (ws[9] + ws[10]))
        exp = np.sort(ws[(ws >= Emin) & (ws <= Emax)])
        kw = {} if name == "cheb_lanczos" else {"bounds": (0.0, 4.0001)}
        solver = "contour_poly" if name == "contour_poly" else "cheb"

        def run(pkg, **extra):
            return pkg.feast_matvec(_stencil(pkg, ns), None, (Emin, Emax),
                                    16, pkg.feastinit(), solver=solver,
                                    **kw, **extra)
        return run, exp, 1e-9, False
    if name in ("general", "general_route", "bilinear"):
        ng = 32
        Ag, lam = _gapped_general(ng, 3, symmetric=name == "bilinear")
        exp = lam[np.abs(lam) <= 0.8]

        def run(pkg, **extra):
            op = pkg.LinearOperator.from_matrix(Ag)
            if name == "general":
                return pkg.feast_matvec_general(
                    op, None, 0.0, 0.8, len(exp) + 4, _fpm(pkg),
                    solver_restart=ng, **extra)
            return pkg.feast_general(
                op, None, 0.0, 0.8, len(exp) + 4, _fpm(pkg),
                complex_symmetric=name == "bilinear", solver_restart=ng,
                **extra)
        return run, exp, 1e-7, True
    if name in ("poly_operators", "poly_arrays"):
        # tests/test_sparse_matfree.py::test_matfree_polynomial_companion
        npoly = 40
        rng = np.random.default_rng(2)
        d0 = rng.uniform(0.5, 2.0, npoly)
        d1 = rng.uniform(-1.0, 1.0, npoly)
        roots = np.concatenate([(-d1[i] + np.array([1, -1]) * np.sqrt(
            d1[i] ** 2 - 4 * d0[i] + 0j)) / 2 for i in range(npoly)])
        center = roots[7]
        dists = np.sort(np.abs(roots - center))
        rr = float((dists[4] + dists[5]) / 2)
        exp = roots[np.abs(roots - center) <= rr]
        coeffs = [np.diag(d0) + 0j, np.diag(d1) + 0j, np.eye(npoly) + 0j]

        def run(pkg, **extra):
            kw = dict(solver_restart=2 * npoly, **extra)
            if name == "poly_arrays":
                return pkg.feast_polynomial(coeffs, complex(center), rr,
                                            len(exp) + 4, _fpm(pkg),
                                            method="matfree", **kw)
            ops = [pkg.LinearOperator.from_matrix(c) for c in coeffs]
            return pkg.feast_polynomial(ops, complex(center), rr,
                                        len(exp) + 4, _fpm(pkg), **kw)
        return run, exp, 1e-7, True
    if name == "feast_route":
        # feast() on an operator: the default solver and M0
        def run(pkg, **extra):
            op = pkg.LinearOperator.from_matrix(A, symmetric=True)
            return pkg.feast(op, None, (0.5, 0.8), None, _fpm(pkg),
                             solver_restart=n, **extra)
        return run, sym_exp, 1e-9, False
    raise KeyError(name)


CASES = ("sym_gmres", "sym_bicgstab", "custom_solver", "warm_on",
         "warm_off", "generalized", "hermitian_flag", "float32",
         "hermitian_gmres", "hermitian_cheb", "cheb_lanczos", "cheb_bounds",
         "contour_poly", "general", "general_route", "bilinear",
         "poly_operators", "poly_arrays", "feast_route")
# the cases of each child process, about a third of the JAX package's
# compile and run time each
CHILD_CASES = (CASES[:6], CASES[6:13], CASES[13:])


def _summary(r):
    q = r.q.cpu().numpy() if isinstance(r.q, torch.Tensor) else r.q
    return dict(M=r.M, info=int(r.info), lam=np.asarray(r.lam),
                res=np.asarray(r.res), loop=int(r.loop), q=np.asarray(q),
                epsout=float(r.epsout))


def _write_reference(path, child):
    """The JAX package's solves of CHILD_CASES[child] (and, in child 0,
    its Lanczos bounds of the stencil), saved to ``path``."""
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import feastkit_tpu as ref_ft
    from feastkit_tpu.solvers.matfree import operator_spectrum_bounds
    out = {}
    if child == 0:
        out["bounds"] = np.asarray(operator_spectrum_bounds(
            _stencil(ref_ft, 400), 400, np.float64))
    for name in CHILD_CASES[child]:
        for k, v in _summary(case(name)[0](ref_ft)).items():
            out[f"{name}/{k}"] = v
    np.savez(path, **out)


_CHILD = ("import os, runpy, sys; "
          "os.sched_setaffinity(0, {int(c) for c in sys.argv[1].split(',')}); "
          "sys.argv = sys.argv[2:]; runpy.run_path(sys.argv[0], "
          "run_name='__main__')")


def _reference_command(path, child):
    """This file as a script on ``path`` for CHILD_CASES[child], kept to
    one core of this process's set, the seventh (child 0), the fourth
    (child 1) or the last (child 2) from last where there is one (the
    affinity set before JAX sizes its thread pools)."""
    args = [__file__, str(path), str(child)]
    if not hasattr(os, "sched_setaffinity"):
        return [sys.executable] + args
    cpus = sorted(os.sched_getaffinity(0))
    back = (7, 4, 1)[child]
    cpu = cpus[-back] if len(cpus) >= back else cpus[-1]
    return [sys.executable, "-c", _CHILD, str(cpu)] + args


@pytest.fixture(scope="module")
def solves(tmp_path_factory):
    """(reference, port): the JAX package's results from the children and
    the port's."""
    where = tmp_path_factory.mktemp("matfree_reference")
    paths = [where / f"ref{i}.npz" for i in range(len(CHILD_CASES))]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (root, os.environ.get("PYTHONPATH")) if p))
    children = [subprocess.Popen(_reference_command(path, i), env=env)
                for i, path in enumerate(paths)]
    try:
        port = {name: case(name)[0](ft, device="cpu") for name in CASES}
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


def _match_err(got, exp, rel=False):
    """Largest eigenvalue distance under the optimal assignment;
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


@pytest.mark.parametrize("name", CASES)
def test_matches_reference(solves, name):
    ref, port = solves
    r = port[name]
    _, exp, bar, general = case(name)
    rel = bar == 1e-5
    assert r.M == len(exp) == int(ref[f"{name}/M"])
    assert int(r.info) == int(ref[f"{name}/info"]) == 0
    assert _match_err(r.lam, ref[f"{name}/lam"], rel) <= bar
    assert _match_err(r.lam, exp, rel) <= bar
    assert isinstance(r, ft.FeastGeneralResult if general else
                      ft.FeastResult)
    assert tuple(r.q.shape)[1] == r.M and r.q.device.type == "cpu"
    tol = 3.5e-4 if name == "float32" else (
        1e-12 if name == "custom_solver" else (
            1e-12 if name.startswith(("cheb", "contour")) else 1e-8))
    assert float(np.max(r.res, initial=0.0)) <= tol


def test_eigenvectors_and_precision(solves):
    """The interval drivers' Ritz vectors are eigenvectors of the
    operator; the float32 operator solves in complex64 work and returns
    float32; the companion eigenvectors (the first N rows, renormalized)
    satisfy P(lam) x = 0."""
    port = solves[1]
    A = torch.as_tensor(_lap(100))
    for name in ("sym_gmres", "generalized", "feast_route"):
        r = port[name]
        q = r.q
        Bq = q if name != "generalized" else torch.as_tensor(np.diag(
            np.random.default_rng(5).uniform(1.0, 2.0, 100))) @ q
        R = A @ q - torch.as_tensor(r.lam)[None, :] * Bq
        assert float(torch.linalg.vector_norm(R, dim=0).max()) <= 1e-7
    r = port["float32"]
    assert r.lam.dtype == np.float32 and r.q.dtype == torch.float32
    r = port["hermitian_flag"]
    assert r.q.dtype == torch.complex128
    r = port["poly_operators"]
    rng = np.random.default_rng(2)
    d0 = rng.uniform(0.5, 2.0, 40)
    d1 = rng.uniform(-1.0, 1.0, 40)
    x = r.q.numpy()
    assert x.shape == (40, r.M)
    assert np.allclose(np.linalg.norm(x, axis=0), 1.0)
    for j, lam in enumerate(r.lam):
        Px = d0 * x[:, j] + lam * d1 * x[:, j] + lam * lam * x[:, j]
        assert np.linalg.norm(Px) <= 1e-6


def test_lanczos_bounds_match_reference(solves):
    """operator_spectrum_bounds of the stencil: within 1e-8 of the span
    of the JAX package's, and enclosing the spectrum tightly."""
    ref = solves[0]["bounds"]
    n = 400
    w = _lap_eigs(n)
    lo, hi = port_mf.operator_spectrum_bounds(_stencil(ft, n), n,
                                              np.float64, device="cpu")
    span = w[-1] - w[0]
    assert abs(lo - ref[0]) <= 1e-8 * span and abs(hi - ref[1]) <= 1e-8 * span
    assert lo <= w[0] and hi >= w[-1]
    assert lo > w[0] - 0.05 * span and hi < w[-1] + 0.05 * span


def test_warm_start_on_and_off(solves, monkeypatch):
    """The factory solver's Ritz warm start and adaptive tolerance: on by
    default (each gmres_block call past the first loop gets x0 and a tol
    hint above solver_tol), off under FEAST_WARM_START=0 /
    FEAST_ADAPTIVE_TOL=0, and both give the JAX package's result (held in
    test_matches_reference)."""
    seen = []
    orig = port_mf.gmres_block

    def spy(op, B, **kw):
        seen.append((kw.get("x0") is not None, kw.get("tol")))
        return orig(op, B, **kw)

    monkeypatch.setattr(port_mf, "gmres_block", spy)
    for name, want in (("warm_on", True), ("warm_off", False)):
        seen.clear()
        r = case(name)[0](ft, device="cpu")
        assert r.M == solves[1][name].M
        assert any(x0 for x0, _ in seen) == want
        assert any(t > 1e-9 for _, t in seen) == want
    assert solves[1]["warm_on"].loop >= 1


def test_real_operator_takes_complex_blocks():
    """A real operator on a complex block is A Re X + i A Im X: against
    A @ X in complex128, one and two dimensional, and the adjoint; a
    complex operator promotes a real block; the f32 operator on a
    complex128 block computes in complex128."""
    rng = np.random.default_rng(0)
    n = 30
    A = rng.standard_normal((n, n))
    X = rng.standard_normal((n, 4)) + 1j * rng.standard_normal((n, 4))
    calls = []

    def mv(Y):
        calls.append(Y.dtype)
        assert not Y.is_complex() and Y.is_contiguous()
        return torch.as_tensor(A) @ Y

    op = ft.LinearOperator(mv, (n, n), torch.float64,
                           rmatvec=lambda Y: torch.as_tensor(A.T) @ Y)
    Xt = torch.as_tensor(X)
    assert torch.allclose(op(Xt), torch.as_tensor(A + 0j) @ Xt, rtol=0,
                          atol=1e-13)
    assert calls == [torch.float64, torch.float64]
    assert torch.allclose(op @ Xt[:, 0], torch.as_tensor(A + 0j) @ Xt[:, 0],
                          rtol=0, atol=1e-13)
    assert torch.allclose(op.adjoint(Xt), torch.as_tensor(A.T + 0j) @ Xt,
                          rtol=0, atol=1e-13)
    Ac = A + 1j * rng.standard_normal((n, n))
    opc = ft.LinearOperator.from_matrix(Ac)
    assert opc(torch.as_tensor(A[:, :2])).dtype == torch.complex128
    assert torch.allclose(opc.adjoint(Xt), torch.as_tensor(Ac.conj().T)
                          @ Xt, rtol=0, atol=1e-13)
    op32 = ft.LinearOperator.from_matrix(A.astype(np.float32))
    assert op32(Xt).dtype == torch.complex128


def test_operator_protocol_matches_reference():
    """tests/test_sparse_matfree.py::test_matfree_operator_protocol in both
    packages: the squeeze of a vector, ``@`` on a block, the adjoint of a
    symmetric operator defaulting to the matvec, and the refusal of an
    adjoint that was not given."""
    import jax.numpy as jnp
    import feastkit_tpu as ref_ft
    n = 100
    A = _lap(n)
    Aj, At = jnp.asarray(A), torch.as_tensor(A)
    ref = ref_ft.MatrixVecFunction(lambda X: Aj @ X, (n, n), jnp.float64,
                                   issymmetric=True)
    port = ft.MatrixVecFunction(lambda X: At @ X, (n, n), torch.float64,
                                issymmetric=True)
    assert port(torch.ones(n, dtype=torch.float64)).shape == (n,) == \
        ref(jnp.ones(n)).shape
    Y = port @ torch.ones((n, 3), dtype=torch.float64)
    assert Y.shape == (n, 3)
    assert np.abs(Y.numpy() - np.asarray(ref @ jnp.ones((n, 3)))).max() \
        < 1e-12
    assert np.array_equal(port.adjoint(torch.ones((n, 2), dtype=torch.float64)
                                       ).numpy(), Y[:, :2].numpy())
    assert port.symmetric and not port.hermitian and not port.posdef
    bare = ft.LinearOperator(lambda X: X, (n, n), np.float64)
    assert bare.dtype == torch.float64
    with pytest.raises(ValueError, match="no adjoint"):
        bare.adjoint(torch.ones(n, dtype=torch.float64))
    # from_matrix computes where its matrix lives
    op = ft.LinearOperator.from_matrix(At, symmetric=True)
    assert op(torch.ones(n, dtype=torch.float64)).device.type == "cpu"


def test_cg_rejected():
    op = ft.LinearOperator(lambda X: X, (10, 10), torch.float64,
                           symmetric=True)
    with pytest.raises(ValueError, match="CG is not valid"):
        ft.create_iterative_solver(op, method="cg")
    with pytest.raises(ValueError, match="CG is not valid"):
        ft.feast_matvec(op, None, (0.5, 1.5), 4, solver=":cg", device="cpu")
    with pytest.raises(ValueError, match="Unknown iterative solver"):
        ft.create_iterative_solver(op, method="minres")


def test_polynomial_filter_rejections_match_reference():
    """The solve-free filters refuse a generalized problem, a caller's
    solver beside them and an enclosure they cannot resolve, with the JAX
    package's errors (raised before any JAX program runs)."""
    import jax.numpy as jnp
    import feastkit_tpu as ref_ft
    from feastkit_tpu.solvers import matfree as ref_mf
    n = 400
    w = _lap_eigs(n)
    Emin, Emax = float(w[0] * 0.5), float(0.5 * (w[9] + w[10]))
    calls = []
    for pkg, mf, dt in ((ref_ft, ref_mf, jnp.float64),
                        (ft, port_mf, torch.float64)):
        kw = {} if pkg is ref_ft else {"device": "cpu"}
        op = _stencil(pkg, n)
        opB = pkg.MatrixVecFunction(lambda X: 2.0 * X, (n, n), dt,
                                    issymmetric=True)
        errs = []
        for call in (
                lambda: mf.feast_matvec(op, opB, (Emin, Emax), 16,
                                        solver="cheb", **kw),
                lambda: mf.feast_matvec(op, None, (Emin, Emax), 16,
                                        solver="cheb",
                                        solve_shifted=lambda z, R: R, **kw),
                lambda: mf.feast_matvec(op, None, (1.0, 1.001), 16,
                                        solver="cheb", bounds=(-4e3, 4e3),
                                        **kw)):
            with pytest.raises(ValueError) as e:
                call()
            errs.append(str(e.value))
        calls.append(errs)
    assert calls[0] == calls[1]
    assert "standard problem" in calls[1][0]
    assert "mutually exclusive" in calls[1][1]


def test_eig_method_checked_at_entry():
    """feast_matvec_general checks ``eig_method`` before any work: an
    unknown name raises; "qr" and "callback" both run host LAPACK."""
    A, lam = _gapped_general(16, 3)
    op = ft.LinearOperator.from_matrix(A)
    with pytest.raises(ValueError, match="Unknown eig method"):
        ft.feast_matvec_general(op, None, 0.0, 0.8, 8, eig_method="lapack",
                                device="cpu")
    exp = lam[np.abs(lam) <= 0.8]
    for method in ("qr", "callback"):
        r = ft.feast_matvec_general(op, None, 0.0, 0.8, len(exp) + 4,
                                    _fpm(ft), solver_restart=16,
                                    eig_method=method, device="cpu")
        assert r.M == len(exp) and int(r.info) == 0


def test_stochastic_count_raises_item_16():
    """fpm[14] = 2 is ported (no longer item 16): both filters give a
    count-only result near the number inside (held to the JAX package in
    tests/test_torch_estimate.py)."""
    fpm = ft.feastinit()
    fpm[14] = 2
    op = _stencil(ft, 40)
    w = _lap_eigs(40)
    inside = int(((w >= 0.01) & (w <= 0.2)).sum())
    for solver in ("cheb", "gmres"):
        r = ft.feast_matvec(op, None, (0.01, 0.2), 8, fpm, solver=solver,
                            bounds=(0.0, 4.0001) if solver == "cheb"
                            else None, device="cpu")
        assert r.lam.size == 0 and r.loop == 1
        assert r.M == max(int(round(r.epsout)), 0)
        assert abs(r.epsout - inside) <= 0.5 * inside + 3


def test_q0_bit_identical(monkeypatch):
    """The subspace the driver starts from: the seeded one, and under
    fpm[5] = 1 the caller's Q0 (short of columns: padded with seeded
    ones, a zero column replaced), bit for bit the JAX package's."""
    from feastkit_tpu.core.tools import initial_subspace as ref_initial
    got = []

    def capture(apply_A, apply_B, filter_apply, Q0, *a, **k):
        got.append(Q0.numpy().copy())
        raise StopIteration

    monkeypatch.setattr(port_mf, "feast_hermitian_core", capture)
    monkeypatch.setattr(port_mf, "feast_general_core", capture)
    n, M0 = 50, 9
    A = _lap(n)
    Q0 = np.random.default_rng(1).standard_normal((n, 5))
    Q0[:, 2] = 0.0
    for fpm5, q0 in ((0, None), (1, Q0)):
        fpm = ft.feastinit()
        fpm[5] = fpm5
        for herm in (False, True):
            with pytest.raises(StopIteration):
                ft.feast_matvec(ft.LinearOperator.from_matrix(A), None,
                                (0.1, 0.5), M0, fpm, hermitian=herm, Q0=q0,
                                device="cpu")
            wd = np.complex128 if herm else np.float64
            assert np.array_equal(got.pop(), ref_initial(
                fpm, q0, n, M0, wd))
        with pytest.raises(StopIteration):
            ft.feast_matvec_general(ft.LinearOperator.from_matrix(A + 0j),
                                    None, 0.3, 0.2, M0, fpm, Q0=q0,
                                    device="cpu")
        assert np.array_equal(got.pop(), ref_initial(
            fpm, q0, n, M0, np.complex128, general=True))


def test_routing_matches_reference(monkeypatch):
    """feast / feast_general / feast_polynomial: a bare callable is refused
    with the JAX package's error; a LinearOperator under a sharded request
    on one device warns (or raises under strict_backend) as the JAX
    package's selection does, and on two devices with the JAX package's
    matrix-free texts; either way the solve runs serially."""
    import feastkit_tpu as ref_ft
    from feastkit_tpu.core import backend as ref_backend
    from feastkit_tpu.solvers import matfree as ref_mf
    n = 20
    eye = np.eye(n)
    for call in (lambda pkg, **k: pkg.feast(lambda x: x, None, (0.1, 0.5),
                                            4, **k),
                 lambda pkg, **k: pkg.feast_general(lambda x: x, None, 0.0,
                                                    1.0, 4, **k),
                 lambda pkg, **k: pkg.feast_polynomial(
                     [lambda x: x, eye], 0.0, 1.0, 4, **k),
                 lambda pkg, **k: pkg.feast_polynomial(
                     [lambda x: x, eye], 0.0, 1.0, 4, method="matfree",
                     **k)):
        with pytest.raises(Exception) as e_ref:
            call(ref_ft)
        with pytest.raises(Exception) as e_port:
            call(ft, device="cpu")
        assert type(e_port.value) is type(e_ref.value)
        assert str(e_port.value) == str(e_ref.value)
    # the JAX package's drivers are not run: only its selection is held
    monkeypatch.setattr(ref_mf, "feast_matvec", lambda *a, **k: "serial")
    monkeypatch.setattr(ref_mf, "feast_matvec_general",
                        lambda *a, **k: "serial")
    monkeypatch.setattr(port_mf, "feast_matvec", lambda *a, **k: "serial")
    monkeypatch.setattr(port_mf, "feast_matvec_general",
                        lambda *a, **k: "serial")
    from feastkit_tpu.solvers.matfree import LinearOperator as RefOp
    ref_op = RefOp.from_matrix(_lap(n), symmetric=True)
    port_op = ft.LinearOperator.from_matrix(_lap(n), symmetric=True)
    calls = ((lambda pkg, op, **k: pkg.feast(op, None, (0.1, 0.5), 4, **k)),
             (lambda pkg, op, **k: pkg.feast_general(op, None, 0.3, 0.2, 4,
                                                     **k)))
    for devices in (1, 2):
        monkeypatch.setattr(ref_backend, "_n_devices", lambda: devices)
        monkeypatch.setattr(port_backend, "_n_devices",
                            lambda device: devices)
        for call in calls:
            for kw in (dict(parallel=True), dict(backend="sharded")):
                with pytest.warns(UserWarning) as w_ref:
                    assert call(ref_ft, ref_op, **kw) == "serial"
                with pytest.warns(UserWarning) as w_port:
                    assert call(ft, port_op, device="cpu", **kw) == "serial"
                assert [str(x.message) for x in w_port] == \
                    [str(x.message) for x in w_ref]
                with pytest.raises(RuntimeError) as e_ref:
                    call(ref_ft, ref_op, strict_backend=True, **kw)
                with pytest.raises(RuntimeError) as e_port:
                    call(ft, port_op, strict_backend=True, device="cpu",
                         **kw)
                assert str(e_port.value).split(". ")[0] == \
                    str(e_ref.value).split(". ")[0]
            with warnings.catch_warnings():
                warnings.simplefilter("error")
                assert call(ft, port_op, device="cpu") == "serial"


def test_array_operands_built_on_the_solve_device(monkeypatch):
    """An array given where an operator goes (B of feast_matvec, a
    coefficient of the companion operators) becomes a tensor on the
    solve's device; a tensor stays where the caller put it, and device=None
    means CUDA."""
    from feastkit_tpu_torch.solvers import matfree
    seen = []
    from_matrix = matfree.LinearOperator.from_matrix

    def record(A, **flags):
        seen.append(A.device.type)
        return from_matrix(A, **flags)
    monkeypatch.setattr(matfree.LinearOperator, "from_matrix",
                        staticmethod(record))
    n = 40
    A = _lap(n)
    op = ft.LinearOperator.from_matrix(torch.as_tensor(A), symmetric=True)
    w = _lap_eigs(n) / 2
    fpm = ft.feastinit()
    res = ft.feast_matvec(op, 2.0 * np.eye(n), (0.0, float(
        (w[3] + w[4]) / 2)), 8, fpm, device="cpu")
    assert seen == ["cpu", "cpu"]
    assert int(res.info) == 0 and res.M == 4
    assert np.abs(np.sort(res.lam) - w[:4]).max() <= 1e-9
    seen.clear()
    matfree.polynomial_companion_operators(
        [torch.as_tensor(A), np.eye(n)], "cpu")
    assert seen == ["cpu", "cpu"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            matfree.polynomial_companion_operators([A, np.eye(n)])


def test_operators_need_a_card_by_default():
    """device=None means CUDA: without a card the drivers raise."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    op = ft.LinearOperator.from_matrix(_lap(10), symmetric=True)
    for call in (lambda: ft.feast_matvec(op, None, (0.1, 0.5), 4),
                 lambda: ft.feast(op, None, (0.1, 0.5), 4),
                 lambda: ft.feast_matvec_general(op, None, 0.3, 0.2, 4),
                 lambda: ft.FeastSRCI(10, 4, 0.1, 0.5)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


if __name__ == "__main__":
    _write_reference(sys.argv[1], int(sys.argv[2]))
