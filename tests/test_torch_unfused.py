"""PyTorch port: the unfused Chebyshev recurrence and the complex DIA
entries against the JAX package.

* Operators with no DIA form (more than 32 diagonals): the 2D Laplacian
  (nx = 32) under a seeded symmetric permutation, real and under a seeded
  unitary gauge (complex), through ``feast``'s auto route: the unfused
  recurrence on torch CSR products (the JAX package's BCOO products), with
  the JAX package's M, info and eigenvalues (1e-8) and the analytic ones.
* A sparse SPD B with no DIA form: the consistent-mass pencil of
  scripts/scale_sparse_gen.py under one seeded permutation of A and B: the
  host scipy bounds of B~ (``eigsh``) and of the pencil's upper edge
  (``_pencil_upper_edge``) at nx = 32 against the JAX package's functions
  on the same data, and a solve at nx = 16 (the bounds, then the composite
  q(B~) A~ on CSR products) against its result; and, with scipy's
  ``eigsh`` made to fail, the same outcomes as the JAX package: the bounds
  keep Gershgorin's ends (here not positive: a ValueError), the polynomial
  solvers refuse the pencil (ValueError) and the auto route goes on to the
  dense engine with the same M, info and eigenvalues.
* One filter application of ``_sparse_cheb_filter_host`` (complex DIA and
  complex CSR operators; the composite) against the JAX package's plain
  recurrence (``make_cheb_filter`` on ``dia_matvec_reference`` /
  ``make_apply_binv_a``) on the same operands, 1e-12 relative.
* ``dia_matvec_any`` on every real / complex combination, unbatched and
  batched, against the JAX package's ``dia_matvec_reference`` in
  complex128 (1e-13) and its four-call Pallas decomposition (interpret
  mode) in complex64 (1e-5); on the CPU each wrapper runs its plain
  version and counts no launch. The complex entries' plans: the ring body
  where a row is whole 16-byte pieces (complex64 two columns a piece,
  complex128 one), the flat one elsewhere.
The JAX package's solves and filter applications run once, in one child
process (this file run as a script) kept to one core; the port's run here
on one torch thread.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import scipy.linalg as sla  # noqa: E402
import scipy.sparse as sp  # noqa: E402

import feastkit_tpu_torch as ft  # noqa: E402
from feastkit_tpu.ops import pallas_kernels as ref_pk  # noqa: E402
from feastkit_tpu_torch.ops import dia  # noqa: E402
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


def lap2d(nx):
    D = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(nx, nx))
    return (sp.kron(D, sp.eye(nx)) + sp.kron(sp.eye(nx), D)).tocsr()


def gauge(A, seed):
    C = A.tocoo()
    theta = np.random.default_rng(seed).uniform(0.0, 2.0 * np.pi,
                                                A.shape[0])
    data = C.data * np.exp(1j * (theta[C.row] - theta[C.col]))
    return sp.csr_matrix((data, (C.row, C.col)), shape=A.shape)


def permuted(X, seed):
    p = np.random.default_rng(seed).permutation(X.shape[0])
    return X[p][:, p].tocsr()


def consistent_mass(nx):
    """A = Dx (x) Mx + Mx (x) Dx, B = Mx (x) Mx (Mx = [1 4 1] / 6) and the
    pencil's eigenvalues mu_i + mu_j."""
    Dx = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(nx, nx))
    Mx = sp.diags([4 / 6, 1 / 6, 1 / 6], [0, 1, -1], shape=(nx, nx))
    A = (sp.kron(Dx, Mx) + sp.kron(Mx, Dx)).tocsr()
    B = sp.kron(Mx, Mx).tocsr()
    mu = sla.eigh(Dx.toarray(), Mx.toarray(), eigvals_only=True)
    return A, B, np.sort((mu[:, None] + mu[None, :]).ravel())


def lowest(w, count):
    w = np.sort(w)
    gaps = np.nonzero(np.diff(w) > 1e-10)[0]
    hi = gaps[np.searchsorted(gaps, count)]
    return 0.5 * float(w[0]), float(0.5 * (w[hi] + w[hi + 1])), hi + 1


def _fpm(pkg):
    fpm = pkg.feastinit()
    fpm[3] = 8
    fpm[42] = 2
    return fpm


def case(name):
    """(run(pkg, **extra) -> result, exact eigenvalues) of a solve."""
    if name in ("perm_real", "perm_complex"):
        A = lap2d(32)
        if name == "perm_complex":
            A = gauge(A, 2)
        A = permuted(A, 1)
        w = np.linalg.eigvalsh(lap2d(32).toarray())
        Emin, Emax, n = lowest(w, 10)
        return (lambda pkg, **extra: pkg.feast(
            A, None, (Emin, Emax), 16, _fpm(pkg), **extra)), w[:n]
    if name == "perm_mass":
        A, B, w = consistent_mass(16)
        A, B = permuted(A, 3), permuted(B, 3)
        _, Emax, n = lowest(w, 6)
        return (lambda pkg, **extra: pkg.feast(
            A, B, (0.0, Emax), 16, _fpm(pkg), **extra)), w[:n]
    raise KeyError(name)


SOLVES = ["perm_real", "perm_complex", "perm_mass"]


def _filter_operands():
    """Host operands of the filter-application comparisons: a complex
    five-diagonal operator (N = 300) with its DIA form, a complex
    operator on 35 diagonals (CSR), the congruenced consistent-mass pair
    at nx = 12, and the coefficients and enclosures."""
    rng = np.random.default_rng(13)
    A5 = gauge(lap2d(15), 14).tocoo()
    wide = sp.diags([rng.standard_normal(300 - abs(k)) * 0.1 / (1 + abs(k))
                     for k in range(-17, 18)], list(range(-17, 18)))
    wide = (wide + wide.T) * 0.5 + sp.diags(4.0 + rng.random(300))
    Aw = gauge(wide.tocsr(), 15).tocoo()
    Am, Bm, _ = consistent_mass(12)
    d = 1.0 / np.sqrt(Bm.diagonal())
    S = sp.diags(d)
    Am, Bm = (S @ Am @ S).tocoo(), (S @ Bm @ S).tocoo()
    coeffs = np.cos(0.37 * np.arange(40)) / (1.0 + np.arange(40))
    Q5 = rng.standard_normal((225, 6)) + 1j * rng.standard_normal((225, 6))
    Qw = rng.standard_normal((300, 5)) + 1j * rng.standard_normal((300, 5))
    Qm = rng.standard_normal((144, 4))
    return dict(A5=A5, Aw=Aw, Am=Am, Bm=Bm, coeffs=coeffs, Q5=Q5, Qw=Qw,
                Qm=Qm, lohi5=(-0.1, 8.1), lohiw=(2.0, 7.0),
                lohim=(0.0, 30.0), blohi=(0.2, 2.3))


def _reference_filters(ops):
    """The JAX package's plain recurrence on the same operands."""
    from feastkit_tpu.ops import chebfilter as rc
    from feastkit_tpu.ops.chebfilter import cheb_inverse_coeffs
    out = {}

    def dia_apply(coo):
        d, offs = ref_pk.bcoo_to_dia(coo.data, np.stack([coo.row, coo.col],
                                                        1), coo.shape[0])
        return lambda X: ref_pk.dia_matvec_reference(jnp.asarray(d), X,
                                                     offs)

    def csr_apply(coo):
        M = jnp.asarray(coo.toarray())
        return lambda X: M @ X

    c = jnp.asarray(ops["coeffs"])
    out["filter_dia"] = np.asarray(rc.make_cheb_filter(
        dia_apply(ops["A5"]), *ops["lohi5"], c)(jnp.asarray(ops["Q5"])))
    out["filter_csr"] = np.asarray(rc.make_cheb_filter(
        csr_apply(ops["Aw"]), *ops["lohiw"], c)(jnp.asarray(ops["Qw"])))
    qc, _ = cheb_inverse_coeffs(*ops["blohi"], 1e-10)
    apply_C = rc.make_apply_binv_a(csr_apply(ops["Am"]),
                                   csr_apply(ops["Bm"]), *ops["blohi"],
                                   jnp.asarray(qc))
    out["filter_composite"] = np.asarray(rc.make_cheb_filter(
        apply_C, *ops["lohim"], c)(jnp.asarray(ops["Qm"])))
    return out


def _write_reference(path):
    """The JAX package's solves, its host bounds on the permuted
    consistent-mass pencil, and its filter applications, saved to
    ``path`` (the child process's work)."""
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import feastkit_tpu as ref_ft
    from feastkit_tpu.core import backend as ref_backend
    from feastkit_tpu.solvers import sparse as ref_sparse
    ref_backend._n_devices = lambda: 1
    out = {}
    for name in SOLVES:
        r = case(name)[0](ref_ft)
        out.update({f"{name}/M": r.M, f"{name}/info": int(r.info),
                    f"{name}/lam": np.asarray(r.lam)})
    A, B, data = _bounds_data()
    out["b_bounds"] = np.asarray(ref_sparse._b_spd_bounds(*data["B"]))
    out["pencil_edge"] = np.asarray(ref_sparse._pencil_upper_edge(
        *data["A"][:2], *data["B"][:2], data["N"]))
    out.update(_reference_filters(_filter_operands()))
    with _eigsh_fails():
        out.update(_eigsh_failure_outcomes(ref_ft, ref_sparse))
    np.savez(path, **out)


class _eigsh_fails:
    """scipy's ``eigsh`` raising ArpackNoConvergence for a block (both
    packages call it through ``scipy.sparse.linalg``)."""

    def __enter__(self):
        import scipy.sparse.linalg as spl
        self.saved = spl.eigsh

        def fail(*a, **k):
            raise spl.ArpackNoConvergence("no convergence (test)", [], [])
        spl.eigsh = fail

    def __exit__(self, *exc):
        import scipy.sparse.linalg as spl
        spl.eigsh = self.saved


EIGSH_SOLVERS = ("cheb", "contour_poly", "auto")


def _eigsh_failure_outcomes(pkg, sparse_mod, **extra):
    """With ``eigsh`` failing: the B~ bounds of ``_bounds_data`` and the
    nx = 16 permuted consistent-mass solve under each of EIGSH_SOLVERS,
    as the exception's class name or the result's M, info and
    eigenvalues."""
    out = {}

    def outcome(key, fn):
        try:
            r = fn()
        except Exception as e:                           # noqa: BLE001
            out[key] = np.array(type(e).__name__)
            return
        if isinstance(r, tuple):
            out[key] = np.asarray(r, float)
        else:
            out.update({key: np.array("result"), f"{key}/M": r.M,
                        f"{key}/info": int(r.info),
                        f"{key}/lam": np.asarray(r.lam)})
    _, _, data = _bounds_data()
    bounds_args = data["B"] + ((None, None, "cpu") if extra else ())
    outcome("eigsh_fails/bounds",
            lambda: sparse_mod._b_spd_bounds(*bounds_args))
    run = case("perm_mass")[0]
    for solver in EIGSH_SOLVERS:
        kw = dict(extra) if solver == "auto" else dict(extra, solver=solver)
        outcome(f"eigsh_fails/{solver}", lambda: run(pkg, **kw))
    return out


def _bounds_data():
    """The permuted consistent-mass pencil (nx = 32) congruenced to unit
    diagonal, as COO arrays (the solver's inputs to its bounds)."""
    A, B, _ = consistent_mass(32)
    A, B = permuted(A, 3), permuted(B, 3)
    N = A.shape[0]
    d = 1.0 / np.sqrt(B.diagonal())
    out = {"N": N}
    for key, X in (("A", A), ("B", B)):
        C = X.tocoo()
        out[key] = (C.data * d[C.row] * d[C.col],
                    np.stack([C.row, C.col], 1).astype(np.int32), N)
    return A, B, out


_CHILD = ("import os, runpy, sys; "
          "os.sched_setaffinity(0, {int(c) for c in sys.argv[1].split(',')}); "
          "sys.argv = sys.argv[2:]; runpy.run_path(sys.argv[0], "
          "run_name='__main__')")
_FAST_COMPILE = ("--xla_backend_optimization_level=0 "
                 "--xla_llvm_disable_expensive_passes=true")


def _reference_command(path):
    """This file as a script on ``path``, kept to one core of this
    process's set, the sixth from last where there is one (the banded and
    Krylov files' children keep to the last four, the Hermitian file's to
    the fifth and the seventh; affinity set before JAX sizes its thread
    pools)."""
    if not hasattr(os, "sched_setaffinity"):
        return [sys.executable, __file__, str(path)]
    cpus = sorted(os.sched_getaffinity(0))
    cpu = cpus[-6] if len(cpus) >= 6 else cpus[-1]
    return [sys.executable, "-c", _CHILD, str(cpu), __file__, str(path)]


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    path = tmp_path_factory.mktemp("unfused_reference") / "ref.npz"
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (root, os.environ.get("PYTHONPATH")) if p),
        XLA_FLAGS=" ".join(filter(None, (os.environ.get("XLA_FLAGS"),
                                         _FAST_COMPILE))))
    child = subprocess.Popen(_reference_command(path), env=env)
    try:
        port = {}
        for name in SOLVES:
            seen = []
            with pytest.MonkeyPatch.context() as mp:
                for fn in ("_sparse_cheb_filter_host",
                           "_sparse_cheb_filter_host_fused",
                           "_sparse_cheb_filter_host_fused_gen",
                           "_pencil_upper_edge", "_pencil_upper_edge_fast"):
                    orig = getattr(port_sparse, fn)

                    def spy(*a, _orig=orig, _fn=fn, **k):
                        if _fn not in seen:
                            seen.append(_fn)
                        return _orig(*a, **k)
                    mp.setattr(port_sparse, fn, spy)
                port[name] = (case(name)[0](ft, device="cpu"), seen)
        assert child.wait(timeout=900) == 0, "the reference run failed"
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
    with np.load(path) as ref:
        return dict(ref), port


@pytest.mark.parametrize("name", SOLVES)
def test_solve_matches_reference(reference, name):
    ref, port = reference
    r, seen = port[name]
    _, exp = case(name)
    assert r.M == int(ref[f"{name}/M"]) == len(exp)
    assert int(r.info) == int(ref[f"{name}/info"]) == 0
    lam = np.sort(np.asarray(r.lam))
    assert np.abs(lam - np.sort(ref[f"{name}/lam"])).max() <= 1e-8
    assert np.abs(lam - exp).max() <= 1e-8
    assert float(np.max(r.res)) <= 1e-8
    # the unfused recurrence and no fused kernel; the host pencil edge for
    # the SPD-B composite whose operands have no DIA form
    want = ["_sparse_cheb_filter_host"]
    if name == "perm_mass":
        want = ["_pencil_upper_edge", "_sparse_cheb_filter_host"]
    assert seen == want
    assert r.q.is_complex() == (name == "perm_complex")


def test_host_bounds_match_reference(reference):
    ref, _ = reference
    _, _, data = _bounds_data()
    b = port_sparse._b_spd_bounds(*data["B"], None, None, "cpu")
    assert np.allclose(b, ref["b_bounds"], rtol=1e-12, atol=0)
    assert 0 < b[0] < b[1]
    edge = port_sparse._pencil_upper_edge(*data["A"][:2], *data["B"][:2],
                                          data["N"])
    assert edge is not None
    assert abs(edge - float(ref["pencil_edge"])) <= 1e-12 * abs(edge)


@pytest.mark.parametrize("what", ("bounds",) + EIGSH_SOLVERS)
def test_eigsh_failure_matches_reference(reference, what):
    """scipy's ``eigsh`` failing on a B with no DIA form: the port keeps
    Gershgorin's ends as the JAX package does, so both refuse this B on the
    polynomial solvers and the auto route goes on (here to the dense
    engine: N <= FEAST_SPARSE_DENSE_N) with the same answer."""
    ref, _ = reference
    with _eigsh_fails():
        port = _eigsh_failure_outcomes(ft, port_sparse, device="cpu")
    key = f"eigsh_fails/{what}"
    assert str(port[key]) == str(ref[key])
    assert str(port[key]) == ("result" if what == "auto" else "ValueError")
    if what == "auto":
        _, exp = case("perm_mass")
        assert port[f"{key}/M"] == int(ref[f"{key}/M"]) == len(exp)
        assert port[f"{key}/info"] == int(ref[f"{key}/info"]) == 0
        lam = np.sort(port[f"{key}/lam"])
        assert np.abs(lam - np.sort(ref[f"{key}/lam"])).max() <= 1e-9
        assert np.abs(lam - exp).max() <= 1e-9


def _port_filter(coo, lohi, coeffs, Q, dtype, composite=None):
    N = coo.shape[0]
    idx = np.stack([coo.row, coo.col], 1)
    out = dia.bcoo_to_dia(coo.data, idx, N)
    d, offs = out if out else (None, None)
    op = port_sparse._operator(coo.data, idx, d, offs, N, dtype, "cpu")
    if composite is not None:
        from feastkit_tpu_torch.ops.chebfilter import (cheb_inverse_coeffs,
                                                       make_apply_binv_a)
        Bc, blohi = composite
        bidx = np.stack([Bc.row, Bc.col], 1)
        bop = port_sparse._operator(Bc.data, bidx, None, None, N, dtype,
                                    "cpu")
        qc, _ = cheb_inverse_coeffs(*blohi, 1e-10)
        op = make_apply_binv_a(op, bop, *blohi, qc)
    ctx = {"f64": dict(apply=op, lo=np.float64(lohi[0]),
                       hi=np.float64(lohi[1]), dtype=dtype,
                       coeffs=np.asarray(coeffs, np.float64))}
    return port_sparse._sparse_cheb_filter_host(
        ctx, torch.as_tensor(Q), rung="f64").numpy(), offs


@pytest.mark.parametrize("which", ["filter_dia", "filter_csr",
                                   "filter_composite"])
def test_filter_application_matches_reference(reference, which):
    ref, _ = reference
    ops = _filter_operands()
    if which == "filter_dia":
        got, offs = _port_filter(ops["A5"], ops["lohi5"], ops["coeffs"],
                                 ops["Q5"], torch.complex128)
        assert offs is not None and len(offs) == 5
    elif which == "filter_csr":
        got, offs = _port_filter(ops["Aw"], ops["lohiw"], ops["coeffs"],
                                 ops["Qw"], torch.complex128)
        assert offs is None              # 35 diagonals: the CSR product
    else:
        Am = ops["Am"]
        got, offs = _port_filter(
            sp.coo_matrix((Am.data, (Am.row, Am.col)), shape=Am.shape),
            ops["lohim"], ops["coeffs"], ops["Qm"], torch.float64,
            composite=(ops["Bm"], ops["blohi"]))
    want = ref[which]
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()


def _operator(seed, N, offsets, complex_values):
    rng = np.random.default_rng(seed)
    d = np.zeros((len(offsets), N), complex if complex_values else float)
    for k, o in enumerate(offsets):
        v = rng.standard_normal(N - abs(o))
        if complex_values:
            v = v + 1j * rng.standard_normal(N - abs(o))
        d[k, max(0, -o):N - max(0, o)] = v
    return d


COMBOS = [(cd, cx) for cd in (True, False) for cx in (True, False)
          if cd or cx]


@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("complex_diags,complex_x", COMBOS)
def test_any_complex_matches_reference(batched, complex_diags, complex_x):
    N, K, offsets = 300, 5, (-17, -1, 0, 1, 17)
    d = _operator(3, N, offsets, complex_diags)
    rng = np.random.default_rng(4)
    shape = (3, N, K) if batched else (N, K)
    x = rng.standard_normal(shape)
    if complex_x:
        x = x + 1j * rng.standard_normal(shape)
    ref = np.stack([np.asarray(ref_pk.dia_matvec_reference(
        jnp.asarray(d), jnp.asarray(xi), offsets))
        for xi in (x if batched else [x])])
    ref = ref if batched else ref[0]
    before = dict(dia.launch_counts())
    got = dia.dia_matvec_any(torch.as_tensor(d), offsets,
                             torch.as_tensor(x)).numpy()
    assert got.dtype == np.complex128 and got.shape == shape
    assert np.abs(got - ref).max() <= 1e-13 * np.abs(ref).max()
    assert dia.launch_counts() == before         # plain on the CPU


@pytest.mark.parametrize("batched", [False, True])
def test_complex64_matches_interpret_decomposition(batched):
    # complex64 diagonals x complex64 x: the JAX package's four real Pallas
    # calls (interpret mode, 32-bit) against the port's one product
    N, K, offsets = 1073, 6, (-37, -1, 0, 1, 37)
    d = _operator(5, N, offsets, True).astype(np.complex64)
    rng = np.random.default_rng(6)
    shape = (2, N, K) if batched else (N, K)
    x = (rng.standard_normal(shape)
         + 1j * rng.standard_normal(shape)).astype(np.complex64)
    with jax.enable_x64(False):
        ref = np.stack([np.asarray(ref_pk.dia_matvec_any(
            jnp.asarray(d), jnp.asarray(xi), offsets, use_pallas=True,
            interpret=True)) for xi in (x if batched else [x])])
    ref = ref if batched else ref[0]
    entry = dia.dia_matvec_batched_c64 if batched else dia.dia_matvec_c64
    got = entry(torch.as_tensor(d), offsets, torch.as_tensor(x)).numpy()
    assert got.dtype == np.complex64
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()


@pytest.mark.parametrize("dtype,M,body", [
    (torch.complex64, 1, "flat"), (torch.complex64, 3, "flat"),
    (torch.complex64, 4, "ring"), (torch.complex64, 72, "ring"),
    (torch.complex128, 1, "flat"), (torch.complex128, 3, "ring"),
    (torch.complex128, 72, "ring")])
def test_complex_plans(dtype, M, body):
    plan = dia.dia_plan((-256, -1, 0, 1, 256), 65536, M, 2, dtype)
    assert plan["body"] == body
    assert plan["vec"] == (2 if dtype == torch.complex64 else 1)
    if body == "ring":
        size = dia.itemsize(dtype)
        assert plan["cols"] == min(64 // size, M)
        assert plan["shared_bytes"] == dia.ring_bytes(
            plan["ring"], plan["chunk"], plan["lanes"], plan["depth"],
            plan["nd"], size)
    # the P=10 products (halo 1024) take the flat body in every type
    assert dia.dia_plan((-1024, -1, 0, 1, 1024), 1 << 20, 72, 1,
                        dtype)["body"] == "flat"


@pytest.mark.parametrize("case_", ["dtype", "cpu"])
def test_complex_wrappers_refuse(case_):
    N, offsets = 40, (-1, 0, 1)
    d = torch.zeros(3, N, dtype=torch.complex128)
    x = torch.zeros(N, 2, dtype=torch.complex128)
    if case_ == "dtype":
        with pytest.raises(TypeError, match="complex64"):
            dia.dia_matvec_c64(d, offsets, x)
        with pytest.raises(TypeError, match="complex128"):
            dia.dia_matvec_c128(d.to(torch.complex64), offsets,
                                x.to(torch.complex64))
    else:
        with pytest.raises(ValueError, match="CUDA tensors"):
            dia._launch(dia.dia_matvec_c128, d, offsets, x, False)
        assert dia.dia_matvec_c128.launches == 0


if __name__ == "__main__":
    _write_reference(sys.argv[1])
