"""PyTorch port on the card: CUDA kernels against their plain versions.

The Chebyshev step kernels (row-major, column-major, 2- and 4-step; the
multi-step ones under block shapes other than the plan's), the
combine of the SPD-B composite and the DIA matvec entries, each against its
plain version at small shapes; what a CUDA entry refuses; and a standard, a
consistent-mass and a Krylov (GMRES with multigrid) solve on the card
against the same solve on the CPU. Needs a CUDA device and nvcc; elsewhere every test
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
    _two_passes(name, plain, S, dtype, tol, _banded(offs, N), offs, N, 6)


@pytest.mark.cuda
@pytest.mark.parametrize("nx,ny,M,shape", [
    (37, 29, 11, (4, 3)),    # ragged column groups and strips
    (300, 9, 7, (4, 2)),     # a halo over two chunks
    (600, 5, 1, (1, 3)),     # a halo over three chunks
    (33, 33, 40, None),      # the solver's own plan
    (40, 3, 5, (2, 2))],     # 2 max|offset| > N
    ids=["nx37", "nx300", "nx600-M1", "plan", "wide"])
def test_streamed_kernel_block_shapes(nx, ny, M, shape):
    # the streamed four-step kernel under column groups and strip counts
    # that reach the edges of its schedule (tests/test_torch_cheb_stream.py
    # rehearses the same cases on the CPU): two passes against the plain
    # version
    _need_cuda()
    dia, offs = _operator(nx, ny)
    N = nx * ny
    plan = None
    if shape is not None:
        cols, strips = shape
        halo = max(abs(d) for d in offs if abs(d) < N)
        plan = ck._stream_shape(halo, N, M, cols, strips)
    _streamed_two_passes(dia, offs, N, M, plan)


def _streamed_two_passes(dia, offs, N, M, plan, dtype=torch.float32, S=4):
    g = torch.Generator().manual_seed(1)
    d = torch.as_tensor(dia, dtype=dtype).cuda()
    k = [torch.randn(M, N, generator=g, dtype=dtype).cuda() for _ in range(5)]
    p = [t.clone() for t in k]
    rung = "f32" if dtype == torch.float32 else "f64"
    wrapper = getattr(ck, f"cheb_step{S}_{rung}")
    before = wrapper.launches
    coeffs = np.random.default_rng(2).standard_normal(2 * S) * 0.1
    for i in (0, S):
        ck._multistep(wrapper, S, dtype, d, offs, *k, 0.3, 0.6,
                      coeffs[i:i + S], plan=plan)
        ck._multistep_plain(S, d, offs, *p, 0.3, 0.6, coeffs[i:i + S])
        k = [k[3], k[4], k[2], k[0], k[1]]
        p = [p[3], p[4], p[2], p[0], p[1]]
    torch.cuda.synchronize()
    assert wrapper.launches == before + 2
    scale = p[2].abs().max()
    tol = 1e-5 if dtype == torch.float32 else 1e-13
    for a, b in zip(k[:3], p[:3]):
        assert float((a - b).abs().max() / scale) <= tol


def _banded(offs, N, seed=3):
    rng = np.random.default_rng(seed)
    dia = np.zeros((len(offs), N))
    for k, d in enumerate(offs):
        dia[k, max(0, -d):N - max(0, d)] = rng.random(N - abs(d)) - 0.5
    return dia


_NINE = (-34, -33, -32, -1, 0, 1, 32, 33, 34)
_ELEVEN = (-40, -33, -7, -2, -1, 0, 1, 2, 7, 33, 40)


@pytest.mark.cuda
@pytest.mark.parametrize("offs,N,M,shape", [
    ((-37, -1, 0, 1, 37), 1073, 11, (2, 3)),          # five, ragged group
    ((-37, -1, 0, 1, 37), 1073, 7, (1, 2)),           # one column a block
    ((-340, -20, -1, 0, 1, 20, 340), 1700, 9, (2, 2)),    # seven (3D)
    ((-340, -20, -1, 0, 1, 20, 340), 1700, 5, (1, 3)),
    (_NINE, 1089, 11, (2, 4)),        # nine
    (_NINE, 1089, 3, (1, 3)),
    (_ELEVEN, 1089, 5, (2, 3)),       # the run-time count
    (_ELEVEN, 1089, 7, (1, 2)),
    ((-300, -1, 0, 1, 300), 2700, 13, (2, 3)),        # halo over 2 chunks
    ((-60, -1, 0, 1, 60), 100, 7, None)],             # the plan, clipped
    ids=["5d-2c", "5d-1c", "7d-2c", "7d-1c", "9d-2c", "9d-1c",
         "11d-2c", "11d-1c", "wide-halo", "plan-small"])
def test_streamed_fp64_block_shapes(offs, N, M, shape):
    # cheb_step4_f64 (the streamed kernel in fp64) under 1 and 2 columns
    # per block, 5, 7, 9 and 11 diagonals and M odd: two passes against
    # the plain version at 1e-13
    _need_cuda()
    plan = None
    if shape is not None:
        cols, strips = shape
        halo = max(abs(d) for d in offs if abs(d) < N)
        plan = ck._stream_shape(halo, N, M, cols, strips, itemsize=8)
    _streamed_two_passes(_banded(offs, N), offs, N, M, plan, torch.float64)


@pytest.mark.cuda
@pytest.mark.parametrize("offs,N,M,depth", [
    ((-340, -20, -1, 0, 1, 20, 340), 1700, 11, 0),    # the ND = 7 body
    ((-37, -1, 0, 1, 37), 1073, 7, 1),                # cp.async, in flight:
    ((-300, -1, 0, 1, 300), 2700, 4, 3),              # 1, 3 and 7
    ((-34, -33, -32, -1, 0, 1, 32, 33, 34), 1089, 12, 7)],
    ids=["7diags", "async1", "async3", "async7-9diags"])
def test_streamed_kernel_variants(offs, N, M, depth):
    # the seven-diagonal body and the cp.async variant (four columns, five
    # or nine diagonals) against the plain version
    _need_cuda()
    halo = max(abs(d) for d in offs)
    _streamed_two_passes(_banded(offs, N), offs, N, M,
                         ck._stream_shape(halo, N, M, 4, 3, depth=depth))


_SEVEN = (-340, -20, -1, 0, 1, 20, 340)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,offs,N,M,shape", [
    (torch.float32, (-37, -1, 0, 1, 37), 1073, 11, (4, 3)),
    (torch.float32, (-37, -1, 0, 1, 37), 1073, 7, (2, 2)),
    (torch.float32, (-37, -1, 0, 1, 37), 1073, 5, (1, 3)),
    (torch.float32, _SEVEN, 1700, 9, (4, 2)),
    (torch.float32, _SEVEN, 1700, 3, (1, 2)),
    (torch.float32, _NINE, 1089, 13, (4, 4)),
    (torch.float32, _NINE, 1089, 5, (2, 3)),
    (torch.float32, _ELEVEN, 1089, 7, (2, 3)),
    (torch.float32, _ELEVEN, 1089, 3, (4, 2)),
    (torch.float32, (-300, -1, 0, 1, 300), 2700, 13, (4, 3)),
    (torch.float32, (-37, -1, 0, 1, 37), 11100, 71, "waves"),
    (torch.float64, (-37, -1, 0, 1, 37), 1073, 11, (2, 3)),
    (torch.float64, (-37, -1, 0, 1, 37), 1073, 7, (1, 2)),
    (torch.float64, _SEVEN, 1700, 9, (2, 2)),
    (torch.float64, _NINE, 1089, 11, (2, 4)),
    (torch.float64, _NINE, 1089, 3, (1, 3)),
    (torch.float64, _ELEVEN, 1089, 5, (2, 3)),
    (torch.float64, _ELEVEN, 1089, 1, (1, 2)),
    (torch.float64, (-300, -1, 0, 1, 300), 2700, 13, (2, 3)),
    (torch.float64, (-37, -1, 0, 1, 37), 11100, 71, "waves"),
    (torch.float32, (-60, -1, 0, 1, 60), 100, 7, None),
    (torch.float64, (-60, -1, 0, 1, 60), 100, 7, None)],
    ids=["f32-5d-4c", "f32-5d-2c", "f32-5d-1c", "f32-7d-4c", "f32-7d-1c",
         "f32-9d-4c", "f32-9d-2c", "f32-11d-2c", "f32-11d-4c",
         "f32-wide-halo", "f32-waves", "f64-5d-2c", "f64-5d-1c",
         "f64-7d-2c", "f64-9d-2c", "f64-9d-1c", "f64-11d-2c", "f64-11d-1c",
         "f64-wide-halo", "f64-waves", "f32-plan-small", "f64-plan-small"])
def test_two_step_block_shapes(dtype, offs, N, M, shape):
    # the streamed kernel's two-step entries under 1, 2 and 4 f32 or 1 and
    # 2 fp64 columns per block, 5, 7, 9 and 11 diagonals, odd M, a strip
    # cut into several waves of resident blocks and the solver's own plan
    # (every range clipped): two passes against the plain version
    _need_cuda()
    size = torch.finfo(dtype).bits // 8
    halo = max(abs(d) for d in offs if abs(d) < N)
    plan = None
    if shape == "waves":
        # one column per block, 71 groups: three waves of the resident
        # blocks over the card's multiprocessors
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        plan = ck._stream_shape(halo, N, M, 1, waves=3, sms=sms,
                                itemsize=size, steps=2)
        assert plan["tiles"] * plan["groups"] > plan["blocks_per_sm"] * sms
    elif shape is not None:
        cols, strips = shape
        plan = ck._stream_shape(halo, N, M, cols, strips, itemsize=size,
                                steps=2)
    _streamed_two_passes(_banded(offs, N), offs, N, M, plan, dtype, S=2)


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


def _cm_case(case):
    """(diagonals, offsets, M) of a column-major form test: five-point
    operators with ragged column groups, the nine-diagonal consistent-mass
    A~, 2 max|offset| > N, eleven diagonals and one."""
    if case == "nd9":
        nx = 32
        Dx = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(nx, nx))
        Mx = sp.diags([4 / 6, 1 / 6, 1 / 6], [0, 1, -1], shape=(nx, nx))
        A = (sp.kron(Dx, Mx) + sp.kron(Mx, Dx)).tocoo()
        d = 1.0 / np.sqrt(sp.kron(Mx, Mx).diagonal())
        dia, offs = bcoo_to_dia(A.data * d[A.row] * d[A.col],
                                np.stack([A.row, A.col], axis=1), nx * nx)
        return dia, offs, 72
    if case in ("wide", "nd11", "nd1"):
        N, offs, M = dict(
            wide=(100, (-60, -1, 0, 1, 60), 7),
            nd11=(1089, (-40, -33, -7, -2, -1, 0, 1, 2, 7, 33, 40), 3),
            nd1=(257, (0,), 5))[case]
        rng = np.random.default_rng(N)
        dia = np.zeros((len(offs), N))
        for k, o in enumerate(offs):
            dia[k, max(0, -o):N - max(0, o)] = rng.random(N - abs(o)) - 0.5
        return dia, offs, M
    nx, ny, M = dict(m11=(37, 29, 11), m72=(33, 33, 72), m1=(5, 7, 1),
                     m6=(40, 30, 6))[case]
    return (*_operator(nx, ny), M)


@pytest.mark.cuda
@pytest.mark.parametrize("name,dtype,tol", [
    ("cheb_step_cm_f32", torch.float32, 1e-5),
    ("cheb_step_cm_f64", torch.float64, 1e-13)])
@pytest.mark.parametrize("form", ["full", "no_t0", "no_acc", "bare"])
@pytest.mark.parametrize("case", ["m11", "m72", "m1", "m6", "nd9", "wide",
                                  "nd11", "nd1"])
def test_column_major_forms_match_plain(name, dtype, tol, form, case):
    """Every form of the column-major entries (T0 and acc present or
    absent) against the plain version in the same form: one launch, T2
    where the form puts it, T1 untouched, each form counted."""
    _need_cuda()
    dia, offs, M = _cm_case(case)
    N = dia.shape[1]
    has_t0, has_acc = form in ("full", "no_acc"), form in ("full", "no_t0")
    g = torch.Generator().manual_seed(4)
    d = torch.as_tensor(dia, dtype=dtype).cuda()
    planes = [torch.randn(M, N, generator=g, dtype=dtype).cuda()
              for _ in range(3)]
    k = [t.clone() for t in planes]
    p = [t.clone() for t in planes]
    ck_ = 0.21 if has_acc else 0.0
    wrapper = getattr(ck, name)
    before = dict(wrapper.form_launches)
    out = wrapper(d, offs, k[0] if has_t0 else None, k[1],
                  k[2] if has_acc else None, 0.3, 0.6, ck_)
    want = ck.cheb_step_cm_plain(d, offs, p[0] if has_t0 else None, p[1],
                                 p[2] if has_acc else None, 0.3, 0.6, ck_)
    torch.cuda.synchronize()
    assert wrapper.form_launches[form] == before[form] + 1
    assert (out is k[0]) == has_t0 and out.is_contiguous()
    assert torch.equal(k[1], planes[1])
    pairs = [(out, want)] + [(k[2], p[2])] * has_acc
    scale = max(float(b.abs().max()) for _, b in pairs)
    for a, b in pairs:
        assert float((a - b).abs().max()) / scale <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("block", [(2, 128), (4, 512), (8, 256), (1, 64),
                                   (8, 64)])
@pytest.mark.parametrize("case", ["m11", "wide", "nd11"])
def test_column_major_block_shapes(block, case):
    """Block shapes other than the plan's (columns per thread, threads per
    block) in the full and bare forms, fp64."""
    _need_cuda()
    dia, offs, M = _cm_case(case)
    N = dia.shape[1]
    plan = ck._cm_shape(N, M, *block)
    g = torch.Generator().manual_seed(5)
    d = torch.as_tensor(dia).cuda()
    t0, t1, acc = (torch.randn(M, N, generator=g, dtype=torch.float64).cuda()
                   for _ in range(3))
    for full in (True, False):
        k = [t0.clone(), acc.clone()]
        out = ck._step_cm(ck.cheb_step_cm_f64, torch.float64, d, offs,
                          k[0] if full else None, t1,
                          k[1] if full else None, 0.3, 0.6,
                          0.2 if full else 0.0, plan=plan)
        p = [t0.clone(), acc.clone()]
        want = ck.cheb_step_cm_plain(d, offs, p[0] if full else None, t1,
                                     p[1] if full else None, 0.3, 0.6,
                                     0.2 if full else 0.0)
        torch.cuda.synchronize()
        pairs = [(out, want)] + [(k[1], p[1])] * full
        scale = max(float(b.abs().max()) for _, b in pairs)
        for a, b in pairs:
            assert float((a - b).abs().max()) / scale <= 1e-13


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


_DIA = [("dia_matvec_f32", torch.float32, 1e-5, False),
        ("dia_matvec_f64", torch.float64, 1e-13, False),
        ("dia_matvec_batched_f32", torch.float32, 1e-5, True),
        ("dia_matvec_batched_f64", torch.float64, 1e-13, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("name,dtype,tol,batched", _DIA)
@pytest.mark.parametrize("N,offs,M,g", [
    (1073, (-37, -1, 0, 1, 37), 11, 2), (100, (-60, -1, 0, 1, 60), 1, 3),
    (1089, (-40, -33, -7, -2, -1, 0, 1, 2, 7, 33, 40), 7, 1),
    (64, (0,), 128, 2)])
def test_dia_matvec_matches_plain(name, dtype, tol, batched, N, offs, M, g):
    _need_cuda()
    from feastkit_tpu_torch.ops import dia as D
    rng = np.random.default_rng(N + M)
    d = np.zeros((len(offs), N))
    for k, o in enumerate(offs):
        d[k, max(0, -o):N - max(0, o)] = rng.random(N - abs(o)) - 0.5
    d = torch.as_tensor(d, dtype=dtype).cuda()
    x = torch.as_tensor(rng.standard_normal((g, N, M) if batched
                                            else (N, M)), dtype=dtype).cuda()
    wrapper = getattr(D, name)
    before = wrapper.launches
    y = wrapper(d, offs, x)
    yp = D.dia_matvec_plain(d, offs, x)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    assert y.dtype == dtype and y.shape == x.shape and y.is_cuda
    assert float((y - yp).abs().max() / yp.abs().max()) <= tol


# (N, offsets, M, g): chip_smoke.py's DIA_AWKWARD, and a ring-width M
_DIA_AWKWARD = [
    (1073, (-37, -1, 0, 1, 37), 1, 3), (1073, (-1, 0, 1), 7, 1),
    (100, (-60, -1, 0, 1, 60), 11, 3), (100, (0,), 7, 3),
    (1089, (-34, -33, -32, -1, 0, 1, 32, 33, 34), 11, 2),
    (1089, (-40, -33, -7, -2, -1, 0, 1, 2, 7, 33, 40), 5, 3),
    (1073, (-37, -1, 0, 1, 37), 72, 2), (100, (-60, -1, 0, 1, 60), 144, 3),
    (1089, (-40, -33, -7, -2, -1, 0, 1, 2, 7, 33, 40), 16, 2),
    (900, (-150, -45, -1, 0, 1, 45, 150, 1000), 8, 1)]


def _dia_operands(N, offs, M, g, dtype, batched):
    rng = np.random.default_rng(N + M + g)
    d = np.zeros((len(offs), N))
    for k, o in enumerate(offs):
        if abs(o) < N:
            d[k, max(0, -o):N - max(0, o)] = rng.random(N - abs(o)) - 0.5
    x = rng.standard_normal((g, N, M) if batched else (N, M))
    return (torch.as_tensor(d, dtype=dtype).cuda(),
            torch.as_tensor(x, dtype=dtype).cuda())


@pytest.mark.cuda
@pytest.mark.parametrize("name,dtype,tol,batched", _DIA)
@pytest.mark.parametrize("body", ["plan", "ring", "flat"])
@pytest.mark.parametrize("N,offs,M,g", _DIA_AWKWARD)
def test_dia_bodies_match_plain(name, dtype, tol, batched, body, N, offs, M,
                                g):
    # the entry's own plan (one launch, counted on its body) and each body
    # forced by a plan, against the plain version; the ring body refuses
    # rows that are not whole 16-byte pieces
    _need_cuda()
    from feastkit_tpu_torch.ops import dia as D
    d, x = _dia_operands(N, offs, M, g, dtype, batched)
    gg = g if batched else 1
    wrapper = getattr(D, name)
    yp = D.dia_matvec_plain(d, offs, x)
    if body == "plan":
        plan = D.dia_plan(offs, N, M, gg, dtype, D._sm_count(0))
        before = dict(wrapper.body_launches)
        y = wrapper(d, offs, x)
        assert wrapper.body_launches[plan["body"]] == \
            before[plan["body"]] + 1
    else:
        vec = 4 if dtype == torch.float32 else 2
        if body == "ring" and (M % vec or M < 2 * vec):
            with pytest.raises(ValueError, match="ring body"):
                D.dia_plan(offs, N, M, gg, dtype, body="ring")
            return
        plan = D.dia_plan(offs, N, M, gg, dtype, body=body)
        y = D._launch(wrapper, d, offs, x, batched, plan=plan)
    torch.cuda.synchronize()
    assert y.shape == x.shape and y.dtype == dtype
    assert float((y - yp).abs().max() / yp.abs().max()) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.float64, 1e-13)],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("N,offs,M,g,over", [
    (1073, (-37, -1, 0, 1, 37), 72, 1, dict(cols=8, depth=1, strips=5)),
    (1073, (-37, -1, 0, 1, 37), 72, 1, dict(cols=72, depth=8, strips=3)),
    (4099, (-64, -1, 0, 1, 64), 128, 2, dict(cols=16, depth=2, strips=7)),
    (4099, (-300, -1, 0, 1, 300), 16, 1, dict(depth=3, strips=4)),
    (1000, (-1, 0, 1), 8, 3, dict(cols=4, depth=6, strips=9)),
    (1089, (-34, -33, -32, -1, 0, 1, 32, 33, 34), 72, 1,
     dict(cols=8, strips=6)),
    (65536, (-256, -1, 0, 1, 256), 128, 1, dict()),
    (16384, (-129, -128, -127, -1, 0, 1, 127, 128, 129), 72, 2, dict())],
    ids=["narrow-d1", "wide-d8", "g2-d2", "halo300", "g3-d6", "nine",
         "krylov", "nine-g2"])
def test_dia_ring_block_shapes(dtype, tol, N, offs, M, g, over):
    # ring plans other than the entry's own: column groups, copies in
    # flight and strip counts (both walk directions), against the plain
    # version
    _need_cuda()
    from feastkit_tpu_torch.ops import dia as D
    batched = g > 1
    if dtype == torch.float64 and "cols" in over:
        over = dict(over, cols=max(2, over["cols"] // 2))
    name = ("dia_matvec_batched_" if batched else "dia_matvec_") + (
        "f32" if dtype == torch.float32 else "f64")
    d, x = _dia_operands(N, offs, M, g, dtype, batched)
    plan = D.dia_plan(offs, N, M, g, dtype, body="ring", **over)
    y = D._launch(getattr(D, name), d, offs, x, batched, plan=plan)
    yp = D.dia_matvec_plain(d, offs, x)
    torch.cuda.synchronize()
    assert float((y - yp).abs().max() / yp.abs().max()) <= tol


@pytest.mark.cuda
def test_dia_ring_takes_a_misaligned_operand():
    # a contiguous operand 4 bytes past a 16-byte boundary is copied
    # before the ring body's 16-byte copies
    _need_cuda()
    from feastkit_tpu_torch.ops import dia as D
    N, offs = 1073, (-37, -1, 0, 1, 37)
    d, big = _dia_operands(N, offs, 72, 1, torch.float32, False)
    x = big.reshape(-1)[1:1 + N * 64].reshape(N, 64)
    assert x.data_ptr() % 16 and x.is_contiguous()
    assert D.dia_plan(offs, N, 64, 1, torch.float32)["body"] == "ring"
    y = D.dia_matvec_f32(d, offs, x)
    yp = D.dia_matvec_plain(d, offs, x)
    torch.cuda.synchronize()
    assert float((y - yp).abs().max() / yp.abs().max()) <= 1e-5


@pytest.mark.cuda
def test_dia_matvec_any_complex_is_one_launch():
    _need_cuda()
    from feastkit_tpu_torch.ops import dia as D
    N, offs = 1073, (-37, -1, 0, 1, 37)
    rng = np.random.default_rng(1)
    d = torch.as_tensor(rng.random((5, N)), dtype=torch.float32).cuda()
    x = torch.as_tensor(rng.standard_normal((2, N, 6))
                        + 1j * rng.standard_normal((2, N, 6)),
                        dtype=torch.complex64).cuda()
    before = D.launch_counts()
    y = D.dia_matvec_any(d, offs, x)
    after = D.launch_counts()
    assert after["dia_matvec_batched_f32"] == \
        before["dia_matvec_batched_f32"] + 1
    yp = torch.complex(D.dia_matvec_plain(d, offs, x.real.contiguous()),
                       D.dia_matvec_plain(d, offs, x.imag.contiguous()))
    assert float((y - yp).abs().max() / yp.abs().max()) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["dtype", "non_contiguous", "cpu_tensor"])
def test_dia_cuda_entry_refuses(case):
    _need_cuda()
    from feastkit_tpu_torch.ops import dia as D
    N, offs = 50, (-1, 0, 1)
    d = torch.ones(3, N, dtype=torch.float64).cuda()
    x = torch.zeros(N, 3, dtype=torch.float64).cuda()
    before = D.dia_matvec_f64.launches
    if case == "dtype":
        with pytest.raises(TypeError):
            D.dia_matvec_f32(d, offs, x)
    elif case == "non_contiguous":
        with pytest.raises(ValueError, match="contiguous"):
            D.dia_matvec_f64(d, offs, torch.zeros(3, N, dtype=torch.float64)
                             .cuda().t())
    else:
        with pytest.raises(ValueError, match="CUDA tensors"):
            D._launch(D.dia_matvec_f64, d.cpu(), offs, x.cpu(), False)
    assert D.dia_matvec_f64.launches == before


@pytest.mark.cuda
def test_krylov_feast_on_cuda_matches_cpu():
    _need_cuda()
    from feastkit_tpu_torch.ops import dia as D
    from feastkit_tpu_torch.solvers.sparse import krylov_dia_launches
    nx = 32
    Dx = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(nx, nx))
    A = (sp.kron(Dx, sp.eye(nx)) + sp.kron(sp.eye(nx), Dx)).tocsr()
    fpm = ft.feastinit()
    fpm[3] = 8
    D.reset_launch_counts()
    rg = ft.feast(A, None, (0.001, 0.2), 24, fpm, solver="gmres")
    counts = D.launch_counts()
    rc = ft.feast(A, None, (0.001, 0.2), 24, fpm, solver="gmres",
                  device="cpu")
    assert rg.q.is_cuda and rg.info == 0 and rg.M == rc.M > 0
    assert rg.krylov["precond"] == "mg"
    # mixed precision on CUDA: the c64 Krylov on the batched f32 entry,
    # the refinement on the fp64 one, Rayleigh-Ritz on the unbatched fp64
    assert counts == krylov_dia_launches(rg.krylov)
    for name in ("dia_matvec_batched_f32", "dia_matvec_batched_f64",
                 "dia_matvec_f64"):
        assert counts[name] > 0, name
    assert np.abs(np.sort(rg.lam) - np.sort(rc.lam)).max() <= 1e-8
    assert rg.res.max() <= 1e-8
