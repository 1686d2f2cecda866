"""PyTorch port: the banded engine (block cyclic reduction) and the sparse
router's hand-offs to the direct engines, against the JAX package.

Mirrors the interval cases of tests/test_banded.py:
* the band utilities (full / band / DIA round trips bit-identical to the
  JAX package's numpy ones, the port's DIA layout mapped to band storage
  on a non-symmetric offset set, the band matvec);
* the block-tridiagonal re-blocking and ``bcr_solve`` (n = 700, kd = 3,
  complex shifted pencils) at block = kd and 128 against the JAX
  package's solution and a dense solve (1e-8), and on the JAX package's own
  factors through ``convert.bcr_from_reference``;
* sbev and hbev against the JAX package and LAPACK; sbgv, hbgv, f32 and
  banded against dense against LAPACK;
* N = 4096: the polynomial route (the default) and BCR
  (``FEAST_CONTOUR_POLY=0``) give the JAX package's eigenpairs;
* the sparse router: ``lap2d(16)`` as CSR goes to the banded engine (M = 11,
  info 0 in both packages); a narrow band of N = 4096 under
  ``FEAST_CHEB_DEGREE=4`` leaves the banded driver's polynomial route for
  BCR, never the sparse router; ``lap2d(20)`` under ``FEAST_CHEB_DEGREE=4``
  (off the polynomial route, N <= FEAST_SPARSE_DENSE_N) is densified onto
  the dense engine.
The bars are BASELINE.md's: real symmetric 1e-10, Hermitian 1e-9, f32
1e-5. The JAX package's solves run once, in four child processes (this
file run as a script), each kept to one core, while the port's run here
with torch on one thread.
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
from feastkit_tpu_torch import convert  # noqa: E402
from feastkit_tpu_torch.ops import banded as port_banded  # noqa: E402
from feastkit_tpu_torch.ops.dia import bcoo_to_dia  # noqa: E402
from feastkit_tpu_torch.solvers import banded as port_sb  # noqa: E402
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


def _banded_random(rng, N, kl, ku, herm=False, sym=False):
    A = np.zeros((N, N), complex if herm else float)
    for d in range(-kl, ku + 1):
        v = rng.standard_normal(N - abs(d))
        if herm:
            v = v + 1j * rng.standard_normal(N - abs(d))
        A += np.diag(v, d)
    if herm:
        A = (A + A.conj().T) / 2
    if sym:
        A = (A + A.T) / 2
    return A


def lap2d(nx):
    D = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(nx, nx))
    return (sp.kron(D, sp.eye(nx)) + sp.kron(sp.eye(nx), D)).tocsr()


def _bcr_problem():
    """n = 700, kd = 3 (tests/test_banded.py), times 1 + 0.5i: a complex
    non-Hermitian band like a shifted pencil's."""
    rng = np.random.default_rng(0)
    n, kd = 700, 3
    A = np.zeros((n, n))
    for d in range(kd + 1):
        v = rng.standard_normal(n - d) * (0.4 if d else 1.0)
        A[np.arange(n - d), np.arange(d, n)] = v
        A[np.arange(d, n), np.arange(n - d)] = v
    A[np.arange(n), np.arange(n)] += 4.0 * kd
    A[np.arange(n - 2), np.arange(2, n)] += 0.3      # not symmetric
    A = A * (1.0 + 0.5j)
    rhs = rng.standard_normal((n, 3)) + 1j * rng.standard_normal((n, 3))
    return A, kd, rhs


def _spiked(n, kd, seed, lo, hi, count):
    """A random symmetric band (half bandwidth kd) with ``count`` diagonal
    spikes spread over [lo, hi] above its bulk (tests/test_banded.py)."""
    rng = np.random.default_rng(seed)
    bands = np.zeros((2 * kd + 1, n))
    for d in range(1, kd + 1):
        v = rng.standard_normal(n - d) * 0.4
        bands[kd - d, d:] = v
        bands[kd + d, :n - d] = v
    bands[kd] = 2 * kd + rng.standard_normal(n) * 0.4
    bands[kd, rng.choice(n, count, replace=False)] = np.linspace(lo, hi,
                                                                 count)
    return bands


def _narrow_csr():
    """bench.py's narrow-band operator (n = 4096 here, kd = 2) without its
    spikes, as CSR; the interval holds its lowest 8 eigenvalues."""
    n, kd = 4096, 2
    rng = np.random.default_rng(7)
    diags, offs = [2.0 * kd + rng.standard_normal(n) * 0.5], [0]
    for d in range(1, kd + 1):
        v = rng.standard_normal(n - d) * 0.5
        diags += [v, v]
        offs += [d, -d]
    A = sp.diags(diags, offs, format="csr")
    lower = np.zeros((kd + 1, n))
    lower[0] = diags[0]
    for d in range(1, kd + 1):
        lower[d, :n - d] = diags[2 * d - 1]
    w = sla.eig_banded(lower, lower=True, eigvals_only=True,
                       select="i", select_range=(0, 8))
    return A, (float(w[0] - 0.1), float((w[7] + w[8]) / 2)), w[:8]


def _driver_case(name):
    """(function name, args, exact eigenvalues, bar) of a driver case."""
    rng = np.random.default_rng(42)
    if name == "sbev":
        n = 120
        A = (np.diag(2.0 * np.ones(n)) + np.diag(-np.ones(n - 1), 1)
             + np.diag(-np.ones(n - 1), -1))
        w = 2.0 - 2.0 * np.cos(np.arange(1, n + 1) * np.pi / (n + 1))
        exp = np.sort(w[(w >= 0.5) & (w <= 1.5)])
        return "feast_sbev", (A, 1, 1, 0.5, 1.5, len(exp) + 6), exp, 1e-10
    if name in ("sbgv", "hbgv"):
        herm = name == "hbgv"
        A = _banded_random(rng, 60, 2, 2, herm=herm, sym=not herm)
        B = _banded_random(rng, 60, 1, 1, herm=herm, sym=not herm) \
            + 8 * np.eye(60)
        w = sla.eigh(A, B, eigvals_only=True)
        return "feast_" + name, (A, 2, 2, B, 1, 1, w[20] - 1e-9,
                                 w[30] + 1e-9, 16), w[20:31], \
            1e-9 if herm else 1e-10
    if name == "hbev":
        A = _banded_random(rng, 50, 3, 3, herm=True)
        w = np.linalg.eigvalsh(A)
        return "feast_hbev", (A, 3, 3, w[15] - 1e-9, w[25] + 1e-9, 16), \
            w[15:26], 1e-9
    if name == "sbev_f32":
        A = _banded_random(rng, 80, 2, 2, sym=True) + 4 * np.eye(80)
        w = np.linalg.eigvalsh(A)
        return "feast_sbev", (A.astype(np.float32), 2, 2, w[30] - 1e-3,
                              w[45] + 1e-3, 22), w[30:46], 1e-5
    raise KeyError(name)


def _run_driver(pkg, name, **extra):
    """A driver case through ``pkg`` (full matrices go in as band
    storage)."""
    from importlib import import_module
    fn, args, _, _ = _driver_case(name)
    band = import_module(pkg.__name__ + ".ops.banded").full_to_banded
    if len(args) == 6:
        A, kl, ku, *rest = args
        args = (band(A, kl, ku), kl, ku, *rest)
    else:
        A, kl, ku, B, klb, kub, *rest = args
        args = (band(A, kl, ku), kl, ku, band(B, klb, kub), klb, kub, *rest)
    mod = import_module(pkg.__name__ + ".solvers.banded")
    return getattr(mod, fn)(*args, **extra)


def _run_case(pkg, name, **extra):
    """Every case that runs a solve, through ``pkg``."""
    if name in ("sbev", "sbgv", "hbev", "hbgv", "sbev_f32"):
        return _run_driver(pkg, name, **extra)
    if name == "lap2d16":
        A = lap2d(16)
        w = np.linalg.eigvalsh(A.toarray())
        return pkg.feast(A, None, (0.0, float((w[10] + w[11]) / 2)), 16,
                         **extra)
    if name == "densify":
        A = lap2d(20)
        w = np.linalg.eigvalsh(A.toarray())
        with _env(FEAST_CHEB_DEGREE="4"):
            return pkg.feast(A, None, (0.5 * w[0], (w[7] + w[8]) / 2), 16,
                             **extra)
    if name == "narrow4096":
        A, iv, _ = _narrow_csr()
        with _env(FEAST_CHEB_DEGREE="4"):
            return pkg.feast(A, None, iv, 16, **extra)
    if name in ("poly4096", "bcr4096"):
        from importlib import import_module
        mod = import_module(pkg.__name__ + ".solvers.banded")
        with _env(FEAST_CONTOUR_POLY="0" if name == "bcr4096" else None):
            return mod.feast_sbev(_spiked(4096, 3, 0, 20.0, 22.0, 10), 3, 3,
                                  18.0, 25.0, 16, **extra)
    raise KeyError(name)


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


def _reference_bcr():
    """The JAX package's re-blocking of a small band, and its BCR
    hierarchy (block 128) of the n = 700 problem and its solution."""
    import jax.numpy as jnp
    from feastkit_tpu.ops import banded as rb
    out = {}
    rng = np.random.default_rng(5)
    A = _banded_random(rng, 37, 2, 1)
    D, L, U, b, _ = rb.banded_to_blocktridiag(
        jnp.asarray(rb.full_to_banded(A, 2, 1)), 2, 1, block=3)
    out.update(blk_D=np.asarray(D), blk_L=np.asarray(L), blk_U=np.asarray(U))
    A, kd, rhs = _bcr_problem()
    n = A.shape[0]
    D, L, U, b, _ = rb.banded_to_blocktridiag(
        jnp.asarray(rb.full_to_banded(A, kd, kd)), kd, kd, block=128)
    levels, rlu, rpiv = rb.bcr_factor(D, L, U)
    Npad = D.shape[0] * b
    rp = np.zeros((Npad, 3), complex)
    rp[:n] = rhs
    x = rb.bcr_solve(levels, rlu, rpiv, jnp.asarray(rp.reshape(-1, b, 3)))
    out["bcr_x"] = np.asarray(x).reshape(Npad, 3)[:n]
    out["bcr_levels"] = np.asarray(len(levels))
    for i, lv in enumerate(levels):
        for f in lv._fields:
            out[f"bcr_{i}_{f}"] = np.asarray(getattr(lv, f))
    out.update(bcr_root_lu=np.asarray(rlu), bcr_root_piv=np.asarray(rpiv))
    return out


# the JAX package's work, split over four child processes (each of its BCR
# solves compiles a program of its own, 10-30 s of one core)
REF_GROUPS = [["bcr", "sbev", "poly4096", "densify"], ["lap2d16"],
              ["narrow4096"], ["hbev"]]


def _write_reference(path, group):
    """The JAX package's share ``group`` of the cases, saved to ``path``
    (a child process's work)."""
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import feastkit_tpu as ref_ft
    from feastkit_tpu.core import backend as ref_backend
    ref_backend._n_devices = lambda: 1
    out = {}
    for name in REF_GROUPS[group]:
        if name == "bcr":
            out.update(_reference_bcr())
            continue
        r = _run_case(ref_ft, name)
        out.update({f"{name}/M": r.M, f"{name}/info": int(r.info),
                    f"{name}/lam": np.asarray(r.lam)})
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


def _reference_command(path, group):
    """This file as a script on ``path`` and ``group``, kept to one of the
    last four cores of this process's set (affinity set before JAX sizes
    its thread pools)."""
    args = [__file__, str(path), str(group)]
    if not hasattr(os, "sched_setaffinity"):
        return [sys.executable, *args]
    cpus = sorted(os.sched_getaffinity(0))[-4:]
    return [sys.executable, "-c", _CHILD, str(cpus[group % len(cpus)]),
            *args]


PORT_CASES = ["sbev", "sbgv", "hbev", "hbgv", "sbev_f32", "lap2d16",
              "densify", "narrow4096", "poly4096", "bcr4096"]


def _spy(monkeypatch, module, name, log):
    orig = getattr(module, name)

    def spy(*a, **k):
        log.append(name)
        return orig(*a, **k)
    monkeypatch.setattr(module, name, spy)


@pytest.fixture(scope="module")
def solves(tmp_path_factory):
    """(reference, port): the JAX package's results and the port's, each
    port result with the engines it reached."""
    tmp = tmp_path_factory.mktemp("banded_reference")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (root, os.environ.get("PYTHONPATH")) if p),
        XLA_FLAGS=" ".join(filter(None, (os.environ.get("XLA_FLAGS"),
                                         _FAST_COMPILE))))
    children = [subprocess.Popen(_reference_command(tmp / f"r{g}.npz", g),
                                 env=env) for g in range(len(REF_GROUPS))]
    try:
        port = {}
        for name in PORT_CASES:
            log = []
            with pytest.MonkeyPatch.context() as mp:
                _spy(mp, port_sb, "bcr_factor", log)
                _spy(mp, port_sb, "_sparse_cheb_interval", log)
                _spy(mp, port_dense, "dense_hermitian_feast", log)
                _spy(mp, port_sparse, "_sparse_krylov_interval", log)
                port[name] = (_run_case(ft, name, device="cpu"), log)
        for c in children:
            assert c.wait(timeout=600) == 0, "the reference solves failed"
    finally:
        for c in children:
            if c.poll() is None:
                c.kill()
                c.wait()
    ref = {}
    for g in range(len(REF_GROUPS)):
        with np.load(tmp / f"r{g}.npz") as f:
            ref.update({k: f[k] for k in f.files})
    return ref, port


# -- band utilities ---------------------------------------------------------

@pytest.mark.parametrize("kl,ku", [(2, 3), (0, 2), (3, 0), (1, 1)])
@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
def test_band_round_trips_match_reference(kl, ku, dtype):
    from feastkit_tpu.ops import banded as rb
    rng = np.random.default_rng(kl * 10 + ku)
    A = _banded_random(rng, 30, kl, ku)
    if dtype == np.complex128:
        A = A + 1j * _banded_random(rng, 30, kl, ku)
    bands = port_banded.full_to_banded(A, kl, ku)
    assert np.array_equal(bands, rb.full_to_banded(A, kl, ku))
    assert np.array_equal(port_banded.banded_to_full(bands, kl, ku), A)
    assert np.array_equal(port_banded.banded_to_full(bands, kl, ku),
                          rb.banded_to_full(bands, kl, ku))
    x = torch.as_tensor(rng.standard_normal((30, 4)))
    y = port_banded.banded_matvec(torch.as_tensor(bands), x, kl, ku)
    assert np.abs(y.numpy() - A @ x.numpy()).max() < 1e-12


def test_port_dia_layout_maps_to_band_storage():
    """The port's row-aligned DIA form of a non-symmetric operator goes to
    the same band storage as the JAX package's mapping and as the dense
    matrix's."""
    from feastkit_tpu.ops import banded as rb
    from feastkit_tpu.ops import pallas_kernels as rpk
    rng = np.random.default_rng(11)
    n, offsets = 41, (-3, -1, 0, 2)
    A = sum(sp.diags(rng.standard_normal(n - abs(d)), d, shape=(n, n))
            for d in offsets).tocoo()
    idx = np.stack([A.row, A.col], axis=1)
    diags, offs = bcoo_to_dia(A.data, idx, n)
    r_diags, r_offs = rpk.bcoo_to_dia(A.data, idx, n)
    assert offs == offsets == tuple(r_offs)
    bands = port_banded.dia_to_banded(diags, offs, 3, 2)
    assert np.array_equal(bands, rb.dia_to_banded(r_diags, r_offs, 3, 2))
    assert np.array_equal(bands,
                          port_banded.full_to_banded(A.toarray(), 3, 2))
    with pytest.raises(ValueError, match="outside band"):
        port_banded.dia_to_banded(diags, offs, 2, 2)


def test_blocktridiag_matches_reference(solves):
    ref, _ = solves
    rng = np.random.default_rng(5)
    A = _banded_random(rng, 37, 2, 1)
    D, L, U, b, N = port_banded.banded_to_blocktridiag(
        torch.as_tensor(port_banded.full_to_banded(A, 2, 1)), 2, 1, block=3)
    assert (b, N) == (3, 37) and D.shape == (16, 3, 3)
    for got, key in ((D, "blk_D"), (L, "blk_L"), (U, "blk_U")):
        assert np.array_equal(got.numpy(), ref[key])


def test_bcr_block_rule():
    # the least legal block on the CPU (the JAX package's rule off the
    # TPU); CUDA re-blocks narrow bands (PERF.md, the block sweep)
    assert port_banded.bcr_block(2, 2, 8192, "cpu") == 2
    assert port_banded.bcr_block(4, 4, 2048, "cpu") == 4
    assert port_banded.bcr_block(0, 0, 100, "cpu") == 1
    assert port_banded.bcr_block(2, 2, 8192, "cuda") == 16
    assert port_banded.bcr_block(4, 4, 2048, "cuda") == 16
    assert port_banded.bcr_block(40, 3, 4096, "cuda") == 40
    assert port_banded.bcr_block(1, 1, 200, "cuda") == 1
    with pytest.raises(ValueError, match="half bandwidth"):
        port_banded.banded_to_blocktridiag(torch.zeros(5, 40), 2, 2, block=1)


def _port_bcr(A, kd, rhs, block):
    n = A.shape[0]
    D, L, U, b, _ = port_banded.banded_to_blocktridiag(
        torch.as_tensor(port_banded.full_to_banded(A, kd, kd)), kd, kd,
        block=block)
    levels, rlu, rpiv = port_banded.bcr_factor(D, L, U)
    Npad = D.shape[-3] * b
    rp = torch.zeros((Npad, 3), dtype=torch.complex128)
    rp[:n] = torch.as_tensor(rhs)
    x = port_banded.bcr_solve(levels, rlu, rpiv, rp.reshape(-1, b, 3))
    return x.reshape(Npad, 3)[:n].numpy(), (D, L, U, b)


@pytest.mark.parametrize("block", [3, 16, 128])
def test_bcr_solve_matches_reference(solves, block):
    ref, _ = solves
    A, kd, rhs = _bcr_problem()
    x, _ = _port_bcr(A, kd, rhs, block)
    assert np.abs(x - np.linalg.solve(A, rhs)).max() <= 1e-8
    assert np.abs(x - ref["bcr_x"]).max() <= 1e-8


def test_bcr_solve_on_reference_factors(solves):
    """The port's bcr_solve on the JAX package's own hierarchy (pivots
    carried from 0-based to 1-based) gives its solution."""
    ref, _ = solves
    A, kd, rhs = _bcr_problem()
    n = A.shape[0]
    fields = ("lu_odd", "piv_odd", "L_odd", "U_odd", "C1", "C2")
    Level = type("Level", (), {})
    levels = []
    for i in range(int(ref["bcr_levels"])):
        lv = Level()
        for f in fields:
            setattr(lv, f, ref[f"bcr_{i}_{f}"])
        levels.append(lv)
    lv_p, rlu, rpiv = convert.bcr_from_reference(
        levels, ref["bcr_root_lu"], ref["bcr_root_piv"], device="cpu")
    b = 128
    Npad = (2 ** len(levels)) * b
    rp = torch.zeros((Npad, 3), dtype=torch.complex128)
    rp[:n] = torch.as_tensor(rhs)
    x = port_banded.bcr_solve(lv_p, rlu, rpiv, rp.reshape(-1, b, 3))
    x = x.reshape(Npad, 3)[:n].numpy()
    assert np.abs(x - ref["bcr_x"]).max() <= 1e-12
    # and the port's own factorization of the same blocks has the same
    # eliminated blocks: the odd blocks' couplings are copied, not factored
    _, (D, L, U, _) = _port_bcr(A, kd, rhs, 128)
    own, _, _ = port_banded.bcr_factor(D, L, U)
    assert np.array_equal(own[0].L_odd.numpy(), ref["bcr_0_L_odd"])


# -- drivers ----------------------------------------------------------------

def _check(r, exact, bar, engines, want):
    assert r.M == len(exact) and int(r.info) == 0
    assert np.abs(np.sort(r.lam) - exact).max() <= bar
    assert float(np.max(r.res)) <= max(bar, 3.5e-4 if bar >= 1e-5 else 0)
    assert r.q.shape[1] == r.M and bool(torch.isfinite(r.q).all())
    assert want <= set(engines), engines


@pytest.mark.parametrize("name", ["sbev", "hbev"])
def test_driver_matches_reference(solves, name):
    ref, port = solves
    r, engines = port[name]
    _, _, exact, bar = _driver_case(name)
    _check(r, exact, bar, engines, {"bcr_factor"})
    assert r.M == int(ref[f"{name}/M"]) and int(ref[f"{name}/info"]) == 0
    assert np.abs(np.sort(r.lam) - np.sort(ref[f"{name}/lam"])).max() <= bar
    assert r.q.is_complex() == (name == "hbev")


@pytest.mark.parametrize("name", ["sbgv", "hbgv", "sbev_f32"])
def test_driver_matches_lapack(solves, name):
    r, engines = solves[1][name]
    _, _, exact, bar = _driver_case(name)
    _check(r, exact, bar, engines, {"bcr_factor"})
    if name == "sbev_f32":
        assert r.lam.dtype == np.float32 and r.q.dtype == torch.float32


def test_feast_banded_dispatches_to_the_drivers(solves):
    """feast_banded picks sbev / sbgv / hbev / hbgv from B and the
    dtypes, with the drivers' results."""
    port = solves[1]
    for name in ("sbev", "sbgv", "hbev", "hbgv"):
        fn, args, exact, bar = _driver_case(name)
        if len(args) == 6:
            A, kl, ku, Emin, Emax, M0 = args
            kw = {}
        else:
            A, kl, ku, B, klb, kub, Emin, Emax, M0 = args
            kw = dict(B_bands=port_banded.full_to_banded(B, klb, kub),
                      klb=klb, kub=kub)
        r = ft.feast_banded(port_banded.full_to_banded(A, kl, ku), kl, ku,
                            (Emin, Emax), M0, device="cpu", **kw)
        assert r.M == port[name][0].M
        assert np.array_equal(r.lam, port[name][0].lam)


def test_banded_matches_dense():
    rng = np.random.default_rng(42)
    n = 80
    A = _banded_random(rng, n, 2, 2, sym=True) + 4 * np.eye(n)
    w = np.linalg.eigvalsh(A)
    Emin, Emax = w[30] - 1e-9, w[45] + 1e-9
    rd = ft.feast_syev(A, Emin, Emax, 22, device="cpu")
    rb = ft.feast_sbev(port_banded.full_to_banded(A, 2, 2), 2, 2, Emin, Emax,
                       22, device="cpu")
    assert rd.M == rb.M == 16
    assert np.abs(np.sort(rd.lam) - np.sort(rb.lam)).max() < 1e-10
    assert np.abs(np.sort(rb.lam) - w[30:46]).max() < 1e-10


def test_banded_refusals():
    bands = port_banded.full_to_banded(np.eye(50) * 2.0, 1, 1)
    fpm = ft.feastinit()
    fpm[14] = 2
    # the stochastic count (fpm[14] = 2) is ported: all 50 eigenvalues 2
    # lie inside, so every probe's v^T P v is its squared norm, N
    r = ft.feast_sbev(bands, 1, 1, 1.0, 3.0, 8, fpm, device="cpu")
    assert r.lam.size == 0 and r.M == 50 and abs(r.epsout - 50.0) < 1e-10
    with pytest.raises(ValueError, match="kl\\+ku\\+1"):
        ft.feast_sbev(bands, 2, 1, 1.0, 3.0, 8, device="cpu")
    with pytest.raises(ValueError, match="M0 must be in"):
        ft.feast_sbev(bands, 1, 1, 1.0, 3.0, 51, device="cpu")
    # the general drivers (item 12, ported since) count too (fpm[14] = 2,
    # ported since), and solve: diag(1..50) with a weak symmetric band,
    # the five eigenvalues near 8..12 inside the circle (10, 2.5)
    A = np.diag(np.arange(1.0, 51.0)) + 0.01 * (np.eye(50, k=1)
                                                + np.eye(50, k=-1))
    general = port_banded.full_to_banded(A.astype(complex), 1, 1)
    eye = port_banded.full_to_banded(np.eye(50, dtype=complex), 1, 1)
    for name in ("feast_gbev", "feast_gbgv", "feast_sbev_complex",
                 "feast_sbgv_complex"):
        fn = getattr(port_sb, name)
        lead = (general, 1, 1) + ((eye, 1, 1) if "gv" in name else ())
        r = fn(*lead, 10.0, 2.5, 8, fpm, device="cpu")
        assert r.lam.size == 0 and r.M == 5 and abs(r.epsout - 5.0) < 0.1
        r = fn(*lead, 10.0, 2.5, 8, device="cpu")
        assert r.M == 5 and int(r.info) == 0
        assert np.abs(np.sort(r.lam.real) - np.linalg.eigvalsh(A)[7:12]
                      ).max() <= 1e-10


def test_poly_route_and_bcr_match_reference(solves):
    """N = 4096: the default takes the polynomial route, FEAST_CONTOUR_POLY=0
    BCR; both give the JAX package's (polynomial-route) eigenpairs."""
    ref, port = solves
    (poly, e_poly), (bcr, e_bcr) = port["poly4096"], port["bcr4096"]
    assert e_poly == ["_sparse_cheb_interval"]
    assert e_bcr == ["bcr_factor"]
    for r in (poly, bcr):
        assert r.M == int(ref["poly4096/M"]) == 10 and int(r.info) == 0
        assert np.abs(np.sort(r.lam) - np.sort(ref["poly4096/lam"])).max() \
            <= 1e-9
        assert float(np.max(r.res)) <= 1e-10
    assert np.abs(np.sort(poly.lam) - np.sort(bcr.lam)).max() <= 1e-10


# -- the sparse router's hand-offs ------------------------------------------

def test_narrow_band_csr_goes_to_the_banded_engine(solves):
    ref, port = solves
    r, engines = port["lap2d16"]
    w = np.linalg.eigvalsh(lap2d(16).toarray())
    assert engines == ["_sparse_krylov_interval", "bcr_factor"]
    _check(r, w[:11], 1e-10, engines, {"bcr_factor"})
    assert int(ref["lap2d16/M"]) == 11 and int(ref["lap2d16/info"]) == 0
    assert np.abs(np.sort(r.lam) - np.sort(ref["lap2d16/lam"])).max() <= 1e-10


def test_narrow_band_at_4096_falls_back_to_bcr(solves):
    """N = 4096 under FEAST_CHEB_DEGREE=4: the banded driver's polynomial
    route is infeasible and BCR answers; the sparse router is entered once
    (the delegation) and never again."""
    ref, port = solves
    r, engines = port["narrow4096"]
    assert engines == ["_sparse_krylov_interval", "_sparse_cheb_interval",
                       "bcr_factor"]
    _, _, exact = _narrow_csr()
    _check(r, exact, 1e-10, engines, {"bcr_factor"})
    assert r.M == int(ref["narrow4096/M"]) and \
        int(ref["narrow4096/info"]) == 0
    assert np.abs(np.sort(r.lam) - np.sort(ref["narrow4096/lam"])).max() \
        <= 1e-10


def test_small_pencil_off_the_polynomial_route_densifies(solves, capsys):
    ref, port = solves
    r, engines = port["densify"]
    assert engines == ["dense_hermitian_feast"]
    w = np.linalg.eigvalsh(lap2d(20).toarray())
    _check(r, w[:8], 1e-10, engines, set())
    assert r.M == int(ref["densify/M"]) and int(ref["densify/info"]) == 0
    assert np.abs(np.sort(r.lam) - np.sort(ref["densify/lam"])).max() \
        <= 1e-10
    # the JAX package's message at fpm[1] >= 1
    fpm = ft.feastinit()
    fpm[1] = 1
    A = lap2d(20)
    with _env(FEAST_CHEB_DEGREE="4"):
        ft.feast(A, None, (0.5 * w[0], (w[7] + w[8]) / 2), 16, fpm,
                 device="cpu")
    assert "N=400 small — densifying onto the dense direct engine" in \
        capsys.readouterr().out


if __name__ == "__main__":
    _write_reference(sys.argv[1], int(sys.argv[2]))
