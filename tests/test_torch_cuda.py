"""PyTorch port on the card: CUDA kernels against their plain versions.

The Chebyshev step kernels (row-major, column-major, 2- and 4-step) and the
combine of the SPD-B composite, each against its plain version at small
shapes, and a standard and a consistent-mass solve on the card against the
same solve on the CPU. Needs a CUDA device and nvcc; elsewhere every test
here skips. Run on the card with
``python -m pytest -m cuda tests/test_torch_cuda.py`` (this file imports no
JAX, so it runs where only the port is installed). The full device check,
at the main path's shapes, is chip_smoke.py.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import scipy.sparse as sp  # noqa: E402

import feastkit_tpu_torch as ft  # noqa: E402
from feastkit_tpu_torch.ops import cheb_kernels as ck  # noqa: E402
from feastkit_tpu_torch.ops.dia import bcoo_to_dia  # noqa: E402


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: "
                    "python -m pytest -m cuda tests/test_torch_cuda.py)")


def _operator(nx, ny, seed=0):
    rng = np.random.default_rng(seed)
    n = nx * ny
    e1 = -rng.random(n - 1)
    e1[np.arange(1, n) % nx == 0] = 0.0
    en = -rng.random(n - nx)
    c = sp.diags([en, e1, 4.0 + rng.random(n), e1, en],
                 [-nx, -1, 0, 1, nx]).tocoo()
    return bcoo_to_dia(c.data, np.stack([c.row, c.col], axis=1), n)


@pytest.mark.cuda
@pytest.mark.parametrize("name,dtype,tol", [
    ("cheb_step_f32", torch.float32, 1e-5),
    ("cheb_step_f64", torch.float64, 1e-13)])
@pytest.mark.parametrize("nx,ny,M", [(37, 29, 11), (33, 33, 72), (5, 7, 1)])
def test_kernel_matches_plain(name, dtype, tol, nx, ny, M):
    _need_cuda()
    dia, offs = _operator(nx, ny)
    g = torch.Generator().manual_seed(1)
    d = torch.as_tensor(dia, dtype=dtype).cuda()
    carry = [torch.randn(nx * ny, M, generator=g, dtype=dtype).cuda()
             for _ in range(3)]
    plain = [t.clone() for t in carry]
    wrapper = getattr(ck, name)
    before = wrapper.launches
    coeffs = np.random.default_rng(2).standard_normal(9) * 0.1
    for c in coeffs:
        wrapper(d, offs, *carry, 0.3, 0.6, c)
        carry[0], carry[1] = carry[1], carry[0]
        ck.cheb_step_plain(d, offs, *plain, 0.3, 0.6, float(c))
        plain[0], plain[1] = plain[1], plain[0]
    torch.cuda.synchronize()
    assert wrapper.launches == before + len(coeffs)
    scale = plain[2].abs().max()
    for a, b in zip(carry, plain):
        assert float((a - b).abs().max() / scale) <= tol


_MULTISTEP = [
    ("cheb_step2_f32", "cheb_step2_plain", 2, torch.float32, 1e-5),
    ("cheb_step4_f32", "cheb_step4_plain", 4, torch.float32, 1e-5),
    ("cheb_step2_f64", "cheb_step2_plain", 2, torch.float64, 1e-13),
    ("cheb_step4_f64", "cheb_step4_plain", 4, torch.float64, 1e-13)]


def _two_passes(name, plain, S, dtype, tol, dia, offs, N, M):
    """Two consecutive passes through the kernel and its plain version
    (the output pair of the first is the input pair of the second)."""
    g = torch.Generator().manual_seed(1)
    d = torch.as_tensor(dia, dtype=dtype).cuda()
    k = [torch.randn(M, N, generator=g, dtype=dtype).cuda()
         for _ in range(5)]
    p = [t.clone() for t in k]
    wrapper, plain = getattr(ck, name), getattr(ck, plain)
    before = wrapper.launches
    coeffs = np.random.default_rng(2).standard_normal(2 * S) * 0.1
    for i in (0, S):
        wrapper(d, offs, *k, 0.3, 0.6, coeffs[i:i + S])
        plain(d, offs, *p, 0.3, 0.6, coeffs[i:i + S])
        k = [k[3], k[4], k[2], k[0], k[1]]
        p = [p[3], p[4], p[2], p[0], p[1]]
    torch.cuda.synchronize()
    assert wrapper.launches == before + 2
    scale = p[2].abs().max()
    for a, b in zip(k[:3], p[:3]):
        assert float((a - b).abs().max() / scale) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("name,plain,S,dtype,tol", _MULTISTEP)
@pytest.mark.parametrize("nx,ny,M", [(37, 29, 11), (33, 33, 72), (5, 7, 1),
                                     (40, 3, 5)])
def test_multistep_kernel_matches_plain(name, plain, S, dtype, tol, nx, ny,
                                        M):
    # (40, 3): S * max|offset| exceeds N
    _need_cuda()
    dia, offs = _operator(nx, ny)
    _two_passes(name, plain, S, dtype, tol, dia, offs, nx * ny, M)


@pytest.mark.cuda
@pytest.mark.parametrize("name,plain,S,dtype,tol", _MULTISTEP)
@pytest.mark.parametrize("offs", [
    (-1, 0, 1), (-40, -33, -7, -2, -1, 0, 1, 2, 7, 33, 40),
    (-34, -33, -32, -1, 0, 1, 32, 33, 34)],
    ids=["3diags", "11diags", "9diags"])
def test_multistep_kernel_other_diagonal_counts(name, plain, S, dtype, tol,
                                                offs):
    # the kernels have bodies for five and nine diagonals and one for any
    # other count: hold the others against the plain version too
    _need_cuda()
    N = 1089
    rng = np.random.default_rng(3)
    dia = np.zeros((len(offs), N))
    for k, d in enumerate(offs):
        dia[k, max(0, -d):N - max(0, d)] = rng.random(N - abs(d)) - 0.5
    _two_passes(name, plain, S, dtype, tol, dia, offs, N, 6)


@pytest.mark.cuda
def test_feast_on_cuda_matches_cpu():
    _need_cuda()
    nx = 40
    D = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(nx, nx))
    A = (sp.kron(D, sp.eye(nx)) + sp.kron(sp.eye(nx), D)).tocsr()
    fpm = ft.feastinit()
    fpm[3] = 8
    ck.reset_launch_counts()
    rg = ft.feast(A, None, (0.001, 0.1), 48, fpm)
    counts = ck.launch_counts()
    rc = ft.feast(A, None, (0.001, 0.1), 48, fpm, device="cpu")
    assert rg.q.is_cuda and rg.info == 0 and rg.M == rc.M
    # the default schedule: one 1-step init per application, then 4-step
    # passes (and the 2-step / 1-step tail the degree asks for)
    assert counts["cheb_step_f32"] > 0 and counts["cheb_step_f64"] > 0
    assert counts["cheb_step4_f32"] > counts["cheb_step_f32"]
    assert counts["cheb_step4_f64"] > counts["cheb_step_f64"]
    assert np.abs(np.sort(rg.lam) - np.sort(rc.lam)).max() <= 1e-8
    assert rg.res.max() <= 1e-8


def _consistent_mass(nx):
    Dx = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(nx, nx))
    Mx = sp.diags([4 / 6, 1 / 6, 1 / 6], [0, 1, -1], shape=(nx, nx))
    return (sp.kron(Dx, Mx) + sp.kron(Mx, Dx)).tocsr(), \
        sp.kron(Mx, Mx).tocsr()


@pytest.mark.cuda
@pytest.mark.parametrize("name,dtype,tol", [
    ("cheb_step_cm_f32", torch.float32, 1e-5),
    ("cheb_step_cm_f64", torch.float64, 1e-13)])
@pytest.mark.parametrize("nx,ny,M", [(37, 29, 11), (33, 33, 72), (5, 7, 1)])
def test_column_major_step_matches_plain(name, dtype, tol, nx, ny, M):
    _need_cuda()
    dia, offs = _operator(nx, ny)
    g = torch.Generator().manual_seed(1)
    d = torch.as_tensor(dia, dtype=dtype).cuda()
    carry = [torch.randn(M, nx * ny, generator=g, dtype=dtype).cuda()
             for _ in range(3)]
    plain = [t.clone() for t in carry]
    wrapper = getattr(ck, name)
    before = wrapper.launches
    coeffs = np.random.default_rng(2).standard_normal(9) * 0.1
    for c in coeffs:
        wrapper(d, offs, *carry, 0.3, 0.6, c)
        carry[0], carry[1] = carry[1], carry[0]
        ck.cheb_step_cm_plain(d, offs, *plain, 0.3, 0.6, float(c))
        plain[0], plain[1] = plain[1], plain[0]
    torch.cuda.synchronize()
    assert wrapper.launches == before + len(coeffs)
    scale = plain[2].abs().max()
    for a, b in zip(carry, plain):
        assert float((a - b).abs().max() / scale) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("name,dtype,tol", [
    ("cheb_combine_f32", torch.float32, 1e-5),
    ("cheb_combine_f64", torch.float64, 1e-13)])
@pytest.mark.parametrize("M,N", [(72, 1089), (1, 100), (7, 4097)])
def test_combine_matches_plain(name, dtype, tol, M, N):
    _need_cuda()
    g = torch.Generator().manual_seed(3)
    z, x, t0, f = (torch.randn(M, N, generator=g, dtype=dtype).cuda()
                   for _ in range(4))
    t0p, fp = t0.clone(), f.clone()
    wrapper = getattr(ck, name)
    before = wrapper.launches
    assert wrapper(z, x, t0, f, 0.3, 0.7, 0.11) is f
    ck.cheb_combine_plain(z, x, t0p, fp, 0.3, 0.7, 0.11)
    out = wrapper(z, x, None, None, 0.25, -0.5, 0.5)
    outp = ck.cheb_combine_plain(z, x, None, None, 0.25, -0.5, 0.5)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 2
    for a, b in ((t0, t0p), (f, fp), (out, outp)):
        assert float((a - b).abs().max() / b.abs().max()) <= tol


@pytest.mark.cuda
def test_consistent_mass_on_cuda_matches_cpu():
    _need_cuda()
    A, B = _consistent_mass(32)
    fpm = ft.feastinit()
    fpm[3] = 8
    ck.reset_launch_counts()
    # 11 pairs below 0.17, which sits in a gap of the spectrum
    rg = ft.feast(A, B, (0.0, 0.17), 24, fpm)
    counts = ck.launch_counts()
    rc = ft.feast(A, B, (0.0, 0.17), 24, fpm, device="cpu")
    assert rg.q.is_cuda and rg.info == 0 and rg.M == rc.M > 0
    # the composite ran on both rungs: its column-major one-step entries,
    # its combine and the multi-step kernels on the nine-diagonal B~
    for name in ("cheb_step_cm_f32", "cheb_step_cm_f64", "cheb_combine_f32",
                 "cheb_combine_f64", "cheb_step4_f32", "cheb_step4_f64"):
        assert counts[name] > 0, name
    assert counts["cheb_step_f32"] == counts["cheb_step_f64"] == 0
    assert np.abs(np.sort(rg.lam) - np.sort(rc.lam)).max() <= 1e-8
    assert rg.res.max() <= 1e-8
