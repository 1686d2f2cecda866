"""PyTorch port: the complex one-step Chebyshev entries and the fused route
of a complex Hermitian operator, on the CPU.

``cheb_step_c64`` / ``cheb_step_c128`` (``ops/cheb_kernels.py``; their
plain version here, the CUDA kernels in test_torch_cuda.py) and
``_sparse_cheb_filter_host_fused`` on a complex context, on the
Harper-Hofstadter cylinder's seven diagonals (0, +-1, +-(ny - 1), +-ny),
against the unfused recurrence (``_sparse_cheb_filter_host``) on the same
operator: equal to the bit on both rungs, whole series and truncated. A
complex context takes one step a launch whatever the shape, and the real
multi-step plans refuse a complex dtype. The route: a Hermitian operator
with a DIA form enters the fused filter, one with none the unfused one.
Imports no JAX; a few seconds.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import scipy.sparse as sp  # noqa: E402

import feastkit_tpu_torch as ft  # noqa: E402
from feastkit_tpu_torch.ops import cheb_kernels as ck  # noqa: E402
from feastkit_tpu_torch.ops.dia import bcoo_to_dia  # noqa: E402
from feastkit_tpu_torch.solvers import sparse as port_sparse  # noqa: E402
from portbench.generators import hofstadter_cyl  # noqa: E402

CPU = torch.device("cpu")
RUNGS = [("f64", torch.complex128, "cheb_step_c128"),
         ("f32", torch.complex64, "cheb_step_c64")]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the suite runs files in parallel worker processes on a few cores
    from threadpoolctl import threadpool_limits
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(limits=1, user_api="blas"):
        yield
    torch.set_num_threads(n)


def _cylinder(nx=10, ny=12):
    """The cylinder's complex DIA form: (diagonals, offsets, N)."""
    A = hofstadter_cyl.operator(0.01 * np.cos(np.arange(nx)), 1 / 64,
                                ny).tocoo()
    dia, offs = bcoo_to_dia(A.data, np.stack([A.row, A.col], 1), A.shape[0])
    return dia, offs, A.shape[0]


def _block(N, M, seed):
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.standard_normal((N, M))
                           + 1j * rng.standard_normal((N, M)))


def test_cylinder_has_seven_diagonals():
    dia, offs, _ = _cylinder()
    assert offs == (-12, -11, -1, 0, 1, 11, 12)
    assert dia.dtype == np.complex128


@pytest.mark.parametrize("rung,dtype,entry", RUNGS)
@pytest.mark.parametrize("n_coeffs", [None, 3, 17])
def test_fused_filter_equals_unfused(rung, dtype, entry, n_coeffs):
    dia, offs, N = _cylinder()
    M = 6
    coeffs = np.random.default_rng(1).standard_normal(40) * 0.1
    lo, hi = -0.1, 8.3
    Q = _block(N, M, 0)
    ctx = port_sparse._cheb_fused_context(torch.as_tensor(dia), offs, coeffs,
                                          lo, hi, M)
    op = port_sparse._operator(None, None, dia, offs, N, dtype, CPU)
    unfused = {rung: dict(apply=op, lo=lo, hi=hi, dtype=dtype,
                          coeffs=coeffs)}
    ck.reset_launch_counts()
    got = port_sparse._sparse_cheb_filter_host_fused(ctx, Q, rung=rung,
                                                     n_coeffs=n_coeffs)
    # the plain version ran: no launch counted
    assert all(v == 0 for v in ck.launch_counts().values())
    want = port_sparse._sparse_cheb_filter_host(
        unfused, Q, rung=rung,
        n_coeffs=None if n_coeffs is None else max(n_coeffs, 3))
    assert got.dtype == want.dtype == dtype
    assert torch.equal(got, want)


@pytest.mark.parametrize("rung,dtype,entry", RUNGS)
def test_step_equals_unfused_step(rung, dtype, entry):
    """One entry's step from a carry equals the unfused recurrence's step
    (``make_cheb_stepper``) from the same carry, at the map scalars of
    ``_map_scalars`` in the rung's precision."""
    from feastkit_tpu_torch.ops.chebfilter import (_map_scalars,
                                                   make_cheb_stepper)
    dia, offs, N = _cylinder()
    d = torch.as_tensor(dia).to(dtype)
    carry = [_block(N, 5, s).to(dtype) for s in (2, 3, 4)]
    lo, hi, ckk = -0.1, 8.3, 0.123456789
    sc, sh = _map_scalars(lo, hi, dtype)
    step = make_cheb_stepper(
        port_sparse._operator(None, None, dia, offs, N, dtype, CPU), lo, hi)
    _, t2, acc = step([t.clone() for t in carry], ckk)
    getattr(ck, entry)(d, offs, *carry, sc, sh, ckk)
    assert torch.equal(carry[0], t2) and torch.equal(carry[2], acc)


@pytest.mark.parametrize("N,M", [(120, 6), (4096, 72), (65536, 8),
                                 (262144, 72), (7, 1)])
def test_complex_context_takes_one_step(N, M):
    offs = (-64, -63, -1, 0, 1, 63, 64)
    dia = torch.zeros(len(offs), N, dtype=torch.complex128)
    ctx = port_sparse._cheb_fused_context(dia, offs, np.ones(5), 0.0, 8.0, M)
    assert ctx["f64"]["steps"] == ctx["f32"]["steps"] == 1
    assert ctx["f64"]["dtype"] == ctx["f64"]["dia"].dtype == torch.complex128
    assert ctx["f32"]["dtype"] == ctx["f32"]["dia"].dtype == torch.complex64
    # the real plan would take the real operator of the same shape
    real = port_sparse._cheb_fused_context(dia.real.contiguous(), offs,
                                           np.ones(5), 0.0, 8.0, M)
    assert real["f64"]["steps"] == real["f32"]["steps"] == 4


@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
@pytest.mark.parametrize("steps", [2, 4])
def test_multistep_plan_refuses_complex(dtype, steps):
    with pytest.raises(TypeError, match="real only"):
        ck.multistep_plan((-1, 0, 1), 4096, 8, dtype, steps)


@pytest.mark.parametrize("rung,dtype,entry", RUNGS)
def test_entry_refuses_other_dtypes(rung, dtype, entry):
    dia, offs, N = _cylinder()
    other = torch.complex64 if dtype == torch.complex128 else torch.complex128
    carry = [_block(N, 2, s).to(other) for s in (0, 1, 2)]
    with pytest.raises(TypeError, match=str(dtype)):
        getattr(ck, entry)(torch.as_tensor(dia).to(other), offs, *carry,
                           0.25, 1.0, 0.5)
    assert entry in ck.launch_counts()


def _engines(A, monkeypatch):
    seen = []
    for name in ("_sparse_cheb_filter_host", "_sparse_cheb_filter_host_fused"):
        orig = getattr(port_sparse, name)

        def spy(*a, _orig=orig, _name=name, **k):
            if _name not in seen:
                seen.append(_name)
            return _orig(*a, **k)
        monkeypatch.setattr(port_sparse, name, spy)
    w = np.linalg.eigvalsh(A.toarray())
    fpm = ft.feastinit()
    fpm[3] = 8
    fpm[42] = 2
    r = ft.feast(A, None, (0.0, float(0.5 * (w[5] + w[6]))), 12, fpm,
                 solver="cheb", device="cpu")
    assert r.M == 6 and int(r.info) == 0
    assert np.abs(np.sort(np.asarray(r.lam)) - w[:6]).max() <= 1e-8
    return seen


def test_route_by_dia_form(monkeypatch):
    """The cylinder (seven diagonals) takes the fused filter; under a
    seeded symmetric permutation it has no DIA form and takes the unfused
    one, to the same eigenvalues."""
    A = hofstadter_cyl.operator(0.01 * np.cos(np.arange(8)), 1 / 16,
                                8).tocsr()
    assert _engines(A, monkeypatch) == ["_sparse_cheb_filter_host_fused"]
    p = np.random.default_rng(5).permutation(A.shape[0])
    P = sp.eye(A.shape[0], format="csr")[p]
    assert _engines((P @ A @ P.T).tocsr(), monkeypatch) == [
        "_sparse_cheb_filter_host"]
