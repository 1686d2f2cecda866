"""PyTorch port, host layer: bit-identical to the JAX package.

fpm defaults, contour nodes and weights, the seeded subspace, the spectrum
enclosure, the Chebyshev and rational filter coefficients and the DIA
conversion are host numpy in both packages, so the port must reproduce
them exactly (``array_equal``). Also: the port imports no JAX, and its
entry points refuse to run without CUDA unless the caller asks for the CPU.
"""
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import scipy.linalg as sla  # noqa: E402
import scipy.sparse as sp  # noqa: E402

import feastkit_tpu_torch as ft  # noqa: E402
from feastkit_tpu.core import contour as ref_contour  # noqa: E402
from feastkit_tpu.core import parameters as ref_params  # noqa: E402
from feastkit_tpu.core import tools as ref_tools  # noqa: E402
from feastkit_tpu.ops import chebfilter as ref_cf  # noqa: E402
from feastkit_tpu.ops import pallas_kernels as ref_pk  # noqa: E402
from feastkit_tpu_torch import convert  # noqa: E402
from feastkit_tpu_torch.core import contour as port_contour  # noqa: E402
from feastkit_tpu_torch.core import tools as port_tools  # noqa: E402
from feastkit_tpu_torch.ops import chebfilter as port_cf  # noqa: E402
from feastkit_tpu_torch.ops import dia as port_dia  # noqa: E402


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


def _lap2d(nx, ny):
    Dx = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(nx, nx))
    Dy = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(ny, ny))
    return (sp.kron(Dx, sp.eye(ny)) + sp.kron(sp.eye(nx), Dy)).tocsr()


def _coo(A):
    c = A.tocoo()
    return c.data, np.stack([c.row, c.col], axis=1).astype(np.int32)


def test_feastinit_and_defaults_identical():
    r = ref_params.feastinit()
    p = ft.feastinit()
    assert np.array_equal(r.to_array(), p.to_array())
    ref_params.feastdefault(r)
    ft.feastdefault(p)
    assert np.array_equal(r.to_array(), p.to_array())
    assert np.array_equal(convert.fpm_from_reference(r).to_array(),
                          r.to_array())


@pytest.mark.parametrize("quadrature", [0, 1, 2])
@pytest.mark.parametrize("ne", [4, 8, 12])
def test_contour_nodes_weights_identical(quadrature, ne):
    r = ref_contour.feast_contour(0.1, 2.3, ne=ne, quadrature=quadrature,
                                  aspect_ratio=0.3)
    p = port_contour.feast_contour(0.1, 2.3, ne=ne, quadrature=quadrature,
                                   aspect_ratio=0.3)
    assert np.array_equal(r.Zne, p.Zne)
    assert np.array_equal(r.Wne, p.Wne)


def test_contour_from_fpm_identical():
    fpm_r = ref_params.feastinit()
    fpm_r[16] = 2
    fpm_p = convert.fpm_from_reference(fpm_r)
    r = ref_contour.feast_contour(-1.0, 1.0, fpm_r)
    p = port_contour.feast_contour(-1.0, 1.0, fpm_p)
    assert np.array_equal(r.Zne, p.Zne) and np.array_equal(r.Wne, p.Wne)


@pytest.mark.parametrize("shape", [(4096, 72), (300, 17), (1000, 8)])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_seeded_subspace_identical(shape, dtype):
    r = ref_tools.seeded_subspace(*shape, dtype)
    p = port_tools.seeded_subspace(*shape, dtype)
    assert r.dtype == p.dtype and np.array_equal(r, p)


@pytest.mark.parametrize("nx,ny", [(64, 64), (20, 23)])
def test_gershgorin_and_dia_identical(nx, ny):
    data, idx = _coo(_lap2d(nx, ny))
    N = nx * ny
    assert ref_cf.gershgorin_interval(data, idx, N) \
        == port_cf.gershgorin_interval(data, idx, N)
    rd, ro = ref_pk.bcoo_to_dia(data, idx, N)
    pd, po = port_dia.bcoo_to_dia(data, idx, N)
    assert ro == po and np.array_equal(rd, pd)


@pytest.mark.parametrize("scale", [1.0, 1.5])
@pytest.mark.parametrize("interval", [(0.0023, 0.178), (1.0, 1.6)])
def test_indicator_coeffs_identical(monkeypatch, scale, interval):
    monkeypatch.delenv("FEAST_CHEB_DEGREE_SCALE", raising=False)
    lo, hi = -8e-6, 8.0
    cr, ir = ref_cf.build_cheb_filter_coeffs(lo, hi, *interval,
                                             degree_scale=scale)
    cp, ip = port_cf.build_cheb_filter_coeffs(lo, hi, *interval,
                                              degree_scale=scale)
    assert np.array_equal(cr, cp) and ir == ip


@pytest.mark.parametrize("quadrature", [0, 1])
def test_rational_coeffs_identical(quadrature):
    lo, hi = -8e-6, 8.0
    Emin, Emax = 0.0023355463353467165, 0.17820159421901494
    c = ref_contour.feast_contour(Emin, Emax, ne=8, quadrature=quadrature)
    cr, ir = ref_cf.rational_filter_cheb_coeffs(c.Zne, c.Wne, lo, hi,
                                                Emin, Emax)
    cp, ip = port_cf.rational_filter_cheb_coeffs(c.Zne, c.Wne, lo, hi,
                                                 Emin, Emax)
    assert np.array_equal(cr, cp) and ir == ip


@pytest.mark.parametrize("quadrature,cap", [(2, 16000), (0, 64)])
def test_rational_infeasible_identical(quadrature, cap):
    # a degree beyond the cap (as on the 1M-dof main path, where the router
    # then takes the indicator): both packages refuse it the same way
    Emin, Emax = 0.0023355463353467165, 0.17820159421901494
    c = ref_contour.feast_contour(Emin, Emax, ne=8, quadrature=quadrature)
    with pytest.raises(ref_cf.ChebInfeasible) as er:
        ref_cf.rational_filter_cheb_coeffs(c.Zne, c.Wne, -8e-6, 8.0,
                                           Emin, Emax, cap=cap)
    with pytest.raises(port_cf.ChebInfeasible) as ep:
        port_cf.rational_filter_cheb_coeffs(c.Zne, c.Wne, -8e-6, 8.0,
                                            Emin, Emax, cap=cap)
    assert str(er.value) == str(ep.value)


def test_dia_matvec_matches_reference():
    data, idx = _coo(_lap2d(20, 23))
    N = 460
    dia, offs = port_dia.bcoo_to_dia(data, idx, N)
    x = np.random.default_rng(0).standard_normal((N, 7))
    r = np.asarray(ref_pk.dia_matvec_reference(dia, x, offs))
    d_t, o_t = convert.dia_from_reference(dia, offs, device="cpu")
    p = port_dia.dia_matvec(d_t, o_t, torch.as_tensor(x)).numpy()
    assert np.abs(r - p).max() <= 1e-14 * np.abs(r).max()


def test_device_none_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    A = _lap2d(20, 20)
    with pytest.raises(RuntimeError, match="CUDA"):
        ft.feast(A, None, (0.01, 0.5), 16)
    with pytest.raises(RuntimeError, match="CUDA"):
        ft.feast_scsrev(A, 0.01, 0.5, 16, device="cuda")


@pytest.mark.parametrize("fn", ["dia_from_reference", "state_from_reference",
                                "carry_from_reference_packed"])
def test_convert_device_none_without_cuda_raises(monkeypatch, fn):
    # the converters default to the card like every entry point: no CPU
    # tensors handed back to a caller that asked for nothing
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = {"dia_from_reference": (np.ones((1, 4)), (0,)),
            "state_from_reference": (None,),
            "carry_from_reference_packed": ([np.ones((8, 4))] * 3,
                                            {"block": 1, "margin": 0}, 4, 2)}
    with pytest.raises(RuntimeError, match="CUDA"):
        getattr(convert, fn)(*args[fn])


def test_port_imports_no_jax():
    root = Path(__file__).resolve().parents[1]
    code = ("import sys, feastkit_tpu_torch, feastkit_tpu_torch.convert; "
            "import feastkit_tpu_torch.ops.cheb_kernels; "
            "bad = [m for m in sys.modules if m == 'jax' "
            "or m.startswith('jax.') or m == 'feastkit_tpu' "
            "or m.startswith('feastkit_tpu.')]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=root, check=True,
                   timeout=300)
    for path in (root / "feastkit_tpu_torch").rglob("*.py"):
        for line in path.read_text().splitlines():
            words = line.split()
            if words[:1] in (["import"], ["from"]):
                assert words[1].split(".")[0] not in ("jax",
                                                      "feastkit_tpu"), \
                    f"{path}: {line}"


def test_bands_to_dia_identical():
    rng = np.random.default_rng(4)
    bands = rng.standard_normal((5, 40))
    rd, ro = ref_pk.bands_to_dia(bands, 2, 2)
    pd, po = port_dia.bands_to_dia(bands, 2, 2)
    assert ro == po and np.array_equal(rd, pd)


@pytest.mark.parametrize("as_tensor", [False, True])
def test_initial_subspace_with_q0_identical(as_tensor):
    # fpm[5] = 1: the caller's Q0, padded with seeded columns, zero columns
    # replaced by seeded ones
    fpm = ref_params.feastinit()
    fpm[5] = 1
    ref_params.feastdefault(fpm)
    Q0 = np.random.default_rng(5).standard_normal((300, 10))
    Q0[:, 3] = 0.0
    r = ref_tools.initial_subspace(fpm, Q0, 300, 16, np.float64)
    p = port_tools.initial_subspace(
        convert.fpm_from_reference(fpm),
        torch.as_tensor(Q0) if as_tensor else Q0, 300, 16, np.float64)
    assert np.array_equal(r, p)


def test_custom_contour_registry():
    from feastkit_tpu_torch.core import aux
    fpm = ft.feastinit()
    c = port_contour.feast_contour(0.0, 1.0, ne=6)
    cid = aux.feast_set_custom_contour(fpm, c)
    assert fpm[29] == cid > 0
    got = aux.feast_get_custom_contour(fpm)
    assert np.array_equal(got.Zne, c.Zne) and np.array_equal(got.Wne, c.Wne)
    aux.feast_clear_custom_contour(fpm)
    assert fpm[29] == 0 and aux.feast_get_custom_contour(fpm) is None


def test_unported_paths_raise():
    A = _lap2d(20, 20)
    kw = dict(device="cpu")
    w = np.linalg.eigvalsh(A.toarray())
    # a dense operand runs the dense engine (item 9)
    r = ft.feast(A.toarray(), None, (0.01, 0.5), 16, **kw)
    assert r.M == int(((w >= 0.01) & (w <= 0.5)).sum()) and r.info == 0
    # a sharded request on one device warns and runs serially, as in the
    # JAX package; a bare callable is refused as there (operators run
    # wrapped in a LinearOperator: tests/test_torch_matfree.py)
    with pytest.warns(UserWarning, match="single device"):
        r = ft.feast(A, None, (0.01, 0.5), 16, backend="sharded", **kw)
    assert r.info == 0
    with pytest.raises(IndexError):
        ft.feast(lambda x: A @ x, None, (0.01, 0.5), 16, **kw)
    # a sparse SPD B runs (item 8), and one with no DIA form (41
    # diagonals) through the unfused composite on CSR products (item 6)
    wide_b = sp.eye(400) + sum(0.01 * (sp.eye(400, k=k) + sp.eye(400, k=-k))
                               for k in range(1, 21))
    r = ft.feast(A, wide_b, (0.01, 0.5), 16, solver="cheb", **kw)
    wb = sla.eigh(A.toarray(), wide_b.toarray(), eigvals_only=True)
    wb = wb[(wb >= 0.01) & (wb <= 0.5)]
    assert r.M == len(wb) > 0 and r.info == 0
    assert np.abs(np.sort(r.lam) - wb).max() <= 1e-10
    # the tridiagonal CSR goes to the banded engine (item 11)
    T = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(400, 400)).tocsr()
    wt = 2.0 - 2.0 * np.cos(np.arange(1, 401) * np.pi / 401)
    r = ft.feast(T, None, (0.01, 0.1), 48, **kw)
    assert r.M == int(((wt >= 0.01) & (wt <= 0.1)).sum()) and r.info == 0
    # the stochastic count (fpm[14] = 2) is ported: a count-only result
    fpm = ft.feastinit()
    fpm[14] = 2
    r = ft.feast(A, None, (0.01, 0.5), 16, fpm, solver="cheb", **kw)
    inside = int(((w >= 0.01) & (w <= 0.5)).sum())
    assert r.lam.size == 0 and r.M == max(int(round(r.epsout)), 0)
    assert abs(r.epsout - inside) <= 0.5 * inside + 3
