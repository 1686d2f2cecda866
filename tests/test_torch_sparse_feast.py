"""PyTorch port, end to end: feast() on the main-path fixture at small size.

BASELINE config 4 cut to a 64 x 64 grid (N = 4096): the sparse 2D
Laplacian, its lowest 52 pairs with the interval's upper end at a spectral
gap, M0 = 72, fpm[3] = 8 (tol 1e-8). The JAX package (serial backend) and
the port (``device="cpu"``, the plain versions of the kernels) solve the
same problem from the same seeded subspace:
  * fpm[42] = 1: mixed precision is off on the CPU in both packages;
  * fpm[42] = 2: the JAX package runs its unfused f32 -> f64 ladder, the
    port its f32 -> f64 rungs;
  * a positive diagonal B: a separable pencil Dx(x)By + Bx(x)Dy with
    B = Bx(x)By, whose eigenvalues are known exactly.
  * the fused path: the JAX package with ``FEAST_CHEB_DS=1`` and
    fpm[42] = 2 runs its 1-step init and 4-step Pallas kernels in interpret
    mode through the f32 -> double-single ladder (the 1D Laplacian, n = 300,
    of tests/test_cheb_pallas.py keeps that to seconds), the port its
    init -> 4 -> 2 -> 1 schedule on the f32 -> f64 rungs;
  * the port alone under the default switches, ``FEAST_CHEB_FUSE4=0``
    (2-step passes) and ``FEAST_CHEB_FUSE2=0`` (1-step launches): the same
    M and eigenvalues within 1e-10.
Each case checks: the same M and info, eigenvalues within 1e-8 of each
other and of the exact values (the BASELINE.md sparse tolerance), every
residual <= tol, and eigenvectors equal cluster by cluster as subspaces to
1e-7 (the square Laplacian's eigenvalues are doubly degenerate, so
columns are compared only through the subspace each cluster spans).
"""
import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import scipy.linalg as sla  # noqa: E402
import scipy.sparse as sp  # noqa: E402

import feastkit_tpu_torch as ft  # noqa: E402
from feastkit_tpu import feastinit as ref_feastinit  # noqa: E402
from feastkit_tpu.interfaces.feast import feast as ref_feast  # noqa: E402
from feastkit_tpu_torch.convert import fpm_from_reference  # noqa: E402

NX = 64
M0 = 72
TOL = 1e-8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # The suite runs files in parallel worker processes on a few cores;
    # torch's default intra-op pool (one spinning thread per core) then
    # starves its neighbours. The port's CPU tensors here are small.
    # numpy's and scipy's OpenBLAS pools (a spinning thread per core
    # each) would too, and worse: beside busy cores a small SVD runs
    # hundreds of times slower on them than on one thread
    from threadpoolctl import threadpool_limits
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(limits=1, user_api="blas"):
        yield
    torch.set_num_threads(n)


def _lap1d(n):
    return sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(n, n))


def _lowest_interval(w, count=50):
    gaps = np.nonzero(np.diff(w) > 1e-12)[0]
    hi = gaps[np.searchsorted(gaps, count)]
    Emin = float(w[0] * 0.5)
    Emax = float(0.5 * (w[hi] + w[hi + 1]))
    return Emin, Emax, w[(w >= Emin) & (w <= Emax)]


def _fixture(case):
    D = _lap1d(NX)
    if case == "diagB":
        rng = np.random.default_rng(5)
        # a mass varying by up to 10% keeps the congruence's Gershgorin
        # enclosure, hence the filter degree (511) and the test's time,
        # modest
        bx = 1.0 + 0.1 * rng.random(NX)
        by = 1.0 + 0.1 * rng.random(NX)

        def gen_eigs(b):
            s = 1.0 / np.sqrt(b)
            return sla.eigh_tridiagonal(2.0 * s * s, -s[:-1] * s[1:],
                                        eigvals_only=True)

        A = (sp.kron(D, sp.diags(by)) + sp.kron(sp.diags(bx), D)).tocsr()
        B = sp.kron(sp.diags(bx), sp.diags(by)).tocsr()
        mu, nu = gen_eigs(bx), gen_eigs(by)
    else:
        A = (sp.kron(D, sp.eye(NX)) + sp.kron(sp.eye(NX), D)).tocsr()
        B = None
        mu = nu = 2.0 - 2.0 * np.cos(np.arange(1, NX + 1) * np.pi / (NX + 1))
    w = np.sort((mu[:, None] + nu[None, :]).ravel())
    return A, B, _lowest_interval(w)


@functools.lru_cache(maxsize=None)
def _solve(case):
    A, B, (Emin, Emax, exact) = _fixture(case)
    fpm = ref_feastinit()
    fpm[3] = 8
    fpm[42] = 2 if case == "ladder" else 1
    r = ref_feast(A, B, (Emin, Emax), M0, fpm, backend="serial")
    p = ft.feast(A, B, (Emin, Emax), M0, fpm_from_reference(fpm),
                 device="cpu")
    return r, p, exact, B


CASES = ["auto", "ladder", "diagB"]


@pytest.mark.parametrize("case", CASES)
def test_same_count_and_status(case):
    r, p, exact, _ = _solve(case)
    assert p.M == r.M == len(exact)
    assert int(p.info) == int(r.info) == 0


@pytest.mark.parametrize("case", CASES)
def test_eigenvalues_and_residuals(case):
    r, p, exact, _ = _solve(case)
    lam_p = np.sort(np.asarray(p.lam))
    assert np.abs(lam_p - np.sort(np.asarray(r.lam))).max() <= TOL
    assert np.abs(lam_p - exact).max() <= TOL
    assert np.asarray(p.res).max() <= TOL
    assert p.epsout <= TOL


def _orth(X):
    return np.linalg.qr(X)[0]


@pytest.mark.parametrize("case", CASES)
def test_eigenvector_clusters_match(case):
    r, p, _, B = _solve(case)
    qp = p.q.numpy()
    qr = np.asarray(r.q)
    assert isinstance(p.q, torch.Tensor) and qp.shape == qr.shape
    lam_p, lam_r = np.asarray(p.lam), np.asarray(r.lam)
    order_p, order_r = np.argsort(lam_p), np.argsort(lam_r)
    lam = lam_p[order_p]
    cuts = np.nonzero(np.diff(lam) > 1e-6 * max(abs(lam).max(), 1.0))[0] + 1
    for idx in np.split(np.arange(len(lam)), cuts):
        P = _orth(qp[:, order_p[idx]])
        R = _orth(qr[:, order_r[idx]])
        # sine of the largest principal angle between the two subspaces
        dist = np.linalg.norm(P - R @ (R.T @ P), 2)
        assert dist <= 1e-7, (case, lam[idx], dist)
    if B is not None:
        # back-transformed vectors of the ORIGINAL pencil: unit 2-norm
        assert np.allclose(np.linalg.norm(qp, axis=0), 1.0, atol=1e-12)


@pytest.mark.parametrize("mixed", [1, 2])
def test_subspace_only_mode_matches(mixed):
    # fpm[14] = 1: one filter application, orthonormalized, no Ritz pairs
    A, B, (Emin, Emax, exact) = _fixture("auto")
    fpm = ref_feastinit()
    fpm[3] = 8
    fpm[14] = 1
    fpm[42] = mixed
    r = ref_feast(A, B, (Emin, Emax), M0, fpm, backend="serial")
    p = ft.feast(A, B, (Emin, Emax), M0, fpm_from_reference(fpm),
                 device="cpu")
    assert (p.M, int(p.info), p.loop) == (r.M, int(r.info), r.loop)
    R = np.asarray(r.q_full)[:, :len(exact)]
    P = p.q_full.numpy()[:, :len(exact)]
    assert np.linalg.norm(P - R @ (R.T @ P), 2) <= 1e-10


@functools.lru_cache(maxsize=None)
def _solve_fused_1d():
    import os
    from feastkit_tpu.solvers.sparse import feast_scsrev as ref_scsrev
    n = 300
    A = sp.diags([2.0 * np.ones(n), -np.ones(n - 1), -np.ones(n - 1)],
                 [0, 1, -1], format="csr")
    w = 2.0 - 2.0 * np.cos(np.arange(1, n + 1) * np.pi / (n + 1))
    exact = np.sort(w[w <= 0.01])
    fpm = ref_feastinit()
    fpm[3] = 13
    fpm[42] = 2
    saved = {k: os.environ.pop(k, None) for k in
             ("FEAST_CHEB_DS", "FEAST_CHEB_FUSE2", "FEAST_CHEB_FUSE4")}
    os.environ["FEAST_CHEB_DS"] = "1"
    try:
        r = ref_scsrev(A, 0.0, 0.01, len(exact) + 4, fpm, solver="cheb")
        p = ft.feast_scsrev(A, 0.0, 0.01, len(exact) + 4,
                            fpm_from_reference(fpm), solver="cheb",
                            device="cpu")
    finally:
        del os.environ["FEAST_CHEB_DS"]
        os.environ.update({k: v for k, v in saved.items() if v is not None})
    return r, p, exact


def test_fused_path_same_count_and_status():
    r, p, exact = _solve_fused_1d()
    assert p.M == r.M == len(exact)
    assert int(p.info) == int(r.info) == 0


def test_fused_path_eigenvalues_and_residuals():
    r, p, exact = _solve_fused_1d()
    lam_p = np.sort(np.asarray(p.lam))
    assert np.abs(lam_p - np.sort(np.asarray(r.lam))).max() <= TOL
    assert np.abs(lam_p - exact).max() <= 1e-13
    assert np.asarray(p.res).max() <= 1e-13     # fpm[3] = 13


@functools.lru_cache(maxsize=None)
def _solve_port_alone(switch, mixed):
    import os
    A, B, (Emin, Emax, exact) = _fixture("auto")
    fpm = ft.feastinit()
    fpm[3] = 8
    fpm[42] = mixed
    names = ("FEAST_CHEB_FUSE2", "FEAST_CHEB_FUSE4")
    saved = {k: os.environ.pop(k, None) for k in names}
    if switch:
        os.environ[switch] = "0"
    try:
        return ft.feast(A, B, (Emin, Emax), M0, fpm, device="cpu"), exact
    finally:
        for k in names:
            os.environ.pop(k, None)
        os.environ.update({k: v for k, v in saved.items() if v is not None})


@pytest.mark.parametrize("mixed", [1, 2])
@pytest.mark.parametrize("switch", ["FEAST_CHEB_FUSE4", "FEAST_CHEB_FUSE2"])
def test_switches_keep_the_result(switch, mixed):
    default, exact = _solve_port_alone(None, mixed)
    other, _ = _solve_port_alone(switch, mixed)
    assert other.M == default.M == len(exact)
    assert int(other.info) == int(default.info) == 0
    assert np.abs(np.sort(other.lam) - np.sort(default.lam)).max() <= 1e-10
    assert np.asarray(other.res).max() <= TOL


def test_auto_route_leaves_no_frame_for_the_collector():
    """An auto-routed solve whose rational filter is refused keeps only the
    refusal's message: no `_sparse_cheb_interval` frame (and none of the
    solve's tensors it holds) waits in a reference cycle for the cyclic
    collector after the solve returns."""
    import gc
    import types
    from feastkit_tpu_torch.solvers import sparse as S
    nx = 120
    T = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(nx, nx))
    A = (sp.kron(sp.eye(nx), T) + sp.kron(T, sp.eye(nx))).tocsr()
    refused = []
    orig = S.rational_filter_cheb_coeffs

    def rational(*a, **k):
        try:
            return orig(*a, **k)
        except S.ChebInfeasible:
            refused.append(True)
            raise
    fpm = ft.feastinit()
    fpm[42] = 2
    S.rational_filter_cheb_coeffs = rational
    gc.collect()
    gc.disable()
    try:
        r = ft.feast(A, None, (0.0, 0.0025), 8, fpm, device="cpu")
        left = [o for o in gc.get_objects()
                if isinstance(o, types.FrameType)
                and o.f_code.co_name == "_sparse_cheb_interval"]
    finally:
        gc.enable()
        S.rational_filter_cheb_coeffs = orig
    assert refused and r.info == 0 and r.M == 1
    assert not left
