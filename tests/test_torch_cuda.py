"""PyTorch port on the card: CUDA kernels against their plain versions.

The Chebyshev step kernels (row-major, column-major, 2- and 4-step; the
multi-step ones under block shapes other than the plan's), the
combine of the SPD-B composite and the DIA matvec entries, each against its
plain version at small shapes; what a CUDA entry refuses; a standard, a
consistent-mass and a Krylov (GMRES with multigrid) solve on the card
against the same solve on the CPU; and the general family's drivers
(dense, banded, polynomial, and the sparse Krylov engine with its DIA
launches held to its record) on the card against the CPU. Needs a CUDA
device and nvcc; elsewhere every test here skips. Run on the card with
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


def _rand_band(rng, n, kd, herm):
    """A random symmetric / Hermitian band of half bandwidth kd, diagonally
    shifted, as a full matrix."""
    A = np.zeros((n, n), complex if herm else float)
    for d in range(1, kd + 1):
        v = rng.standard_normal(n - d)
        if herm:
            v = v + 1j * rng.standard_normal(n - d)
        A += np.diag(v, d)
    A = A + A.conj().T + np.diag(2.0 * kd + rng.standard_normal(n))
    return A


_DIRECT = [(dt, herm, gen) for dt in ("f32", "f64")
           for herm in (False, True) for gen in (False, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("dt,herm,gen", _DIRECT)
def test_dense_driver_on_cuda_matches_cpu(dt, herm, gen):
    _need_cuda()
    rng = np.random.default_rng(3)
    n = 120
    A = _rand_band(rng, n, n - 1, herm) / np.sqrt(n)
    B = None
    if gen:
        C = rng.standard_normal((n, n)) * 0.3 / np.sqrt(n)
        B = C @ C.T + np.eye(n)
    rdt = {"f32": np.float32, "f64": np.float64}[dt]
    cdt = {"f32": np.complex64, "f64": np.complex128}[dt]
    A = A.astype(cdt if herm else rdt)
    B = None if B is None else B.astype(rdt)
    import scipy.linalg as sla
    w = sla.eigh(A.astype(complex), None if B is None else B.astype(float),
                 eigvals_only=True)
    iv = (float(w[39] + w[40]) / 2, float(w[55] + w[56]) / 2)
    rg = ft.feast(A, B, iv, 24)
    rc = ft.feast(A, B, iv, 24, device="cpu")
    bar = 1e-4 if dt == "f32" else 1e-9
    assert rg.q.is_cuda and int(rg.info) == 0 and rg.M == rc.M == 16
    assert rg.q.is_complex() == herm
    assert np.abs(np.sort(rg.lam) - np.sort(rc.lam)).max() <= bar
    assert np.abs(np.sort(rg.lam) - w[40:56]).max() <= bar


@pytest.mark.cuda
@pytest.mark.parametrize("dt,herm,gen", _DIRECT)
def test_banded_driver_on_cuda_matches_cpu(dt, herm, gen):
    _need_cuda()
    from feastkit_tpu_torch.ops.banded import full_to_banded
    rng = np.random.default_rng(4)
    n, kd = 600, 3
    A = _rand_band(rng, n, kd, herm)
    rdt = {"f32": np.float32, "f64": np.float64}[dt]
    cdt = {"f32": np.complex64, "f64": np.complex128}[dt]
    A = A.astype(cdt if herm else rdt)
    kw = {}
    if gen:
        B = _rand_band(rng, n, 1, herm) * 0.1 + 4 * np.eye(n)
        kw = dict(B_bands=full_to_banded(B.astype(A.dtype), 1, 1), klb=1,
                  kub=1)
        import scipy.linalg as sla
        w = sla.eigh(A.astype(complex), B, eigvals_only=True)
    else:
        w = np.linalg.eigvalsh(A.astype(complex))
    iv = (float(w[199] + w[200]) / 2, float(w[215] + w[216]) / 2)
    bands = full_to_banded(A, kd, kd)
    rg = ft.feast_banded(bands, kd, kd, iv, 24, **kw)
    rc = ft.feast_banded(bands, kd, kd, iv, 24, device="cpu", **kw)
    bar = 1e-4 if dt == "f32" else 1e-9
    assert rg.q.is_cuda and int(rg.info) == 0 and rg.M == rc.M == 16
    assert np.abs(np.sort(rg.lam) - np.sort(rc.lam)).max() <= bar
    assert np.abs(np.sort(rg.lam) - w[200:216]).max() <= bar


@pytest.mark.cuda
@pytest.mark.parametrize("n,kd,block", [(700, 3, None), (700, 3, 3),
                                        (700, 3, 128), (4096, 2, None),
                                        (1000, 16, 64)])
@pytest.mark.parametrize("cdt", [torch.complex64, torch.complex128])
def test_bcr_on_cuda_matches_dense_solve(n, kd, block, cdt):
    """BCR on the card against torch.linalg.solve of the dense shifted
    pencils (complex, non-Hermitian)."""
    _need_cuda()
    from feastkit_tpu_torch.ops import banded as OB
    rng = np.random.default_rng(5)
    A = _rand_band(rng, n, kd, True) + 0.3 * np.diag(
        rng.standard_normal(n - 1), 1)
    z = torch.tensor([0.5 + 1.0j, 2.0 - 0.3j], dtype=cdt).cuda()
    bands = torch.as_tensor(OB.full_to_banded(A, kd, kd)).to("cuda", cdt)
    eye = torch.zeros_like(bands)
    eye[kd] = 1.0
    D, L, U, b, _ = OB.banded_to_blocktridiag(
        z[:, None, None] * eye[None] - bands[None], kd, kd, block=block)
    levels, rlu, rpiv = OB.bcr_factor(D, L, U)
    Npad = D.shape[-3] * b
    rhs = torch.as_tensor(rng.standard_normal((n, 5))).to("cuda", cdt)
    rp = torch.zeros(Npad, 5, dtype=cdt, device="cuda")
    rp[:n] = rhs
    x = OB.bcr_solve(levels, rlu, rpiv, rp.reshape(-1, b, 5))
    x = x.reshape(2, Npad, 5)[:, :n]
    Ad = torch.as_tensor(A).to("cuda", cdt)
    I = torch.eye(n, dtype=cdt, device="cuda")
    ref = torch.linalg.solve(z[:, None, None] * I - Ad, rhs)
    tol = 1e-4 if cdt == torch.complex64 else 1e-11
    assert float((x - ref).abs().max() / ref.abs().max()) <= tol


_DIA_COMPLEX = [("dia_matvec_c64", torch.complex64, 1e-5, False),
                ("dia_matvec_c128", torch.complex128, 1e-13, False),
                ("dia_matvec_batched_c64", torch.complex64, 1e-5, True),
                ("dia_matvec_batched_c128", torch.complex128, 1e-13, True)]


def _complex_operands(N, offs, M, g, dtype, batched):
    rng = np.random.default_rng(N + M + g + 1)
    d = np.zeros((len(offs), N), complex)
    for k, o in enumerate(offs):
        if abs(o) < N:
            n = N - abs(o)
            d[k, max(0, -o):N - max(0, o)] = (rng.random(n) - 0.5
                                              + 1j * (rng.random(n) - 0.5))
    shape = (g, N, M) if batched else (N, M)
    x = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    return (torch.as_tensor(d).to(dtype).cuda(),
            torch.as_tensor(x).to(dtype).cuda())


@pytest.mark.cuda
@pytest.mark.parametrize("name,dtype,tol,batched", _DIA_COMPLEX)
@pytest.mark.parametrize("body", ["plan", "ring", "flat"])
@pytest.mark.parametrize("N,offs,M,g", _DIA_AWKWARD + [
    (1000, (-7, -2, -1, 0, 1, 2, 7), 3, 2), (1000, (-5, -3, -1), 6, 2)])
def test_dia_complex_entries_match_plain(name, dtype, tol, batched, body, N,
                                         offs, M, g):
    # the complex entries under their own plan (one launch, counted on its
    # body) and each body forced by a plan, against the plain version; a
    # complex64 row is two columns a 16-byte piece, a complex128 one
    _need_cuda()
    from feastkit_tpu_torch.ops import dia as D
    d, x = _complex_operands(N, offs, M, g, dtype, batched)
    gg = g if batched else 1
    wrapper = getattr(D, name)
    yp = D.dia_matvec_plain(d, offs, x)
    if body == "plan":
        plan = D.dia_plan(offs, N, M, gg, dtype, D._sm_count(0))
        before = (wrapper.launches, dict(wrapper.body_launches))
        y = wrapper(d, offs, x)
        assert wrapper.launches == before[0] + 1
        assert wrapper.body_launches[plan["body"]] == \
            before[1][plan["body"]] + 1
    else:
        vec = 2 if dtype == torch.complex64 else 1
        if body == "ring" and (M % vec or M < 2 * vec):
            with pytest.raises(ValueError, match="ring body"):
                D.dia_plan(offs, N, M, gg, dtype, body="ring")
            return
        plan = D.dia_plan(offs, N, M, gg, dtype, body=body)
        y = D._launch(wrapper, d, offs, x, batched, plan=plan)
    torch.cuda.synchronize()
    assert y.shape == x.shape and y.dtype == dtype and y.is_cuda
    assert float((y - yp).abs().max() / yp.abs().max()) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
@pytest.mark.parametrize("real_x", [False, True])
def test_dia_matvec_any_complex_diagonals_one_launch(dtype, real_x):
    # complex diagonals: one launch of the complex entry (a real x promoted
    # first), no real entry
    _need_cuda()
    from feastkit_tpu_torch.ops import dia as D
    N, offs = 1073, (-37, -1, 0, 1, 37)
    d, x = _complex_operands(N, offs, 8, 2, dtype, True)
    if real_x:
        x = x.real.contiguous()
    before = D.launch_counts()
    y = D.dia_matvec_any(d, offs, x)
    after = D.launch_counts()
    entry = "dia_matvec_batched_" + ("c64" if dtype == torch.complex64
                                     else "c128")
    assert {k: after[k] - before[k] for k in after} == {
        k: int(k == entry) for k in after}
    yp = D.dia_matvec_plain(d, offs, x.to(dtype))
    tol = 1e-5 if dtype == torch.complex64 else 1e-13
    assert float((y - yp).abs().max() / yp.abs().max()) <= tol


@pytest.mark.cuda
def test_hermitian_feast_on_cuda_matches_cpu():
    # the gauge-rotated Laplacian (five complex diagonals) on the
    # polynomial path: the unfused recurrence on the complex entries
    _need_cuda()
    from feastkit_tpu_torch.ops import dia as D
    nx = 32
    Dx = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(nx, nx))
    A = (sp.kron(Dx, sp.eye(nx)) + sp.kron(sp.eye(nx), Dx)).tocoo()
    theta = np.random.default_rng(3).uniform(0.0, 2.0 * np.pi, nx * nx)
    A = sp.csr_matrix((A.data * np.exp(1j * (theta[A.row] - theta[A.col])),
                       (A.row, A.col)), shape=A.shape)
    fpm = ft.feastinit()
    fpm[3] = 8
    fpm[42] = 2
    D.reset_launch_counts()
    ck.reset_launch_counts()
    rg = ft.feast(A, None, (0.001, 0.2), 24, fpm)
    counts = D.launch_counts()
    rc = ft.feast(A, None, (0.001, 0.2), 24, fpm, device="cpu")
    assert rg.q.is_cuda and rg.q.is_complex() and rg.info == 0
    assert rg.M == rc.M > 0
    assert counts["dia_matvec_c64"] > 0 and counts["dia_matvec_c128"] > 0
    assert all(v == 0 for k, v in counts.items() if k[-3:] in ("f32",
                                                               "f64"))
    assert all(v == 0 for v in ck.launch_counts().values())
    assert np.abs(np.sort(rg.lam) - np.sort(rc.lam)).max() <= 1e-8
    assert rg.res.max() <= 1e-8


def _general_inside(w, Emid, r):
    return w[np.abs(w - Emid) <= r]


def _circle(w, Emid, count):
    """The radius around Emid half-way between the count-th nearest
    eigenvalue and the next: (r, the eigenvalues inside)."""
    d = np.sort(np.abs(w - Emid))
    r = float(d[count - 1] + d[count]) / 2
    return r, _general_inside(w, Emid, r)


def _general_match(got, exp):
    from scipy.optimize import linear_sum_assignment
    got, exp = np.asarray(got), np.asarray(exp)
    assert len(got) == len(exp)
    D = np.abs(got[:, None] - exp[None, :])
    ri, ci = linear_sum_assignment(D)
    return D[ri, ci].max(initial=0.0)


_GENERAL = [(dt, gen, bil) for dt in ("c64", "c128") for gen in (False, True)
            for bil in (False, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("dt,gen,bil", _GENERAL)
def test_dense_general_on_cuda_matches_cpu(dt, gen, bil):
    # a normal matrix U diag(w) U^T (complex symmetric for the transpose
    # pairing: U complex orthogonal there) with a seeded spectrum
    _need_cuda()
    import scipy.linalg as sla
    rng = np.random.default_rng(5)
    n = 160
    w = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    if bil:
        U, _ = np.linalg.qr(rng.standard_normal((n, n)))
        A = (U * w[None, :]) @ U.T
    else:
        U, _ = np.linalg.qr(rng.standard_normal((n, n))
                            + 1j * rng.standard_normal((n, n)))
        A = (U * w[None, :]) @ U.conj().T
    B = None
    if gen:
        C = rng.standard_normal((n, n)) * 0.2 / np.sqrt(n)
        B = np.eye(n) + (C + C.T) / 2
        w = sla.eig(A, B, right=False)
    cdt = {"c64": np.complex64, "c128": np.complex128}[dt]
    A = A.astype(cdt)
    B = None if B is None else B.astype(cdt)
    Emid = 0.2 + 0.1j
    r, exp = _circle(w, Emid, 12)
    kw = dict(complex_symmetric=bil)
    rg = ft.feast_general(A, B, Emid, r, len(exp) + 8, **kw)
    rc = ft.feast_general(A, B, Emid, r, len(exp) + 8, device="cpu", **kw)
    bar = 1e-4 if dt == "c64" else 1e-9
    assert rg.q.is_cuda and int(rg.info) == 0 and rg.M == rc.M == len(exp)
    assert _general_match(rg.lam, rc.lam) <= bar
    assert _general_match(rg.lam, exp) <= bar


@pytest.mark.cuda
@pytest.mark.parametrize("dt,gen,bil", _GENERAL)
def test_banded_general_on_cuda_matches_cpu(dt, gen, bil):
    # T + i beta T^2 on a band (normal and complex symmetric), a
    # generalized pencil with a diagonal B
    _need_cuda()
    import scipy.linalg as sla
    from feastkit_tpu_torch.ops.banded import full_to_banded
    n, beta = 600, 0.5
    T = np.diag(2.0 * np.ones(n)) - np.diag(np.ones(n - 1), 1) \
        - np.diag(np.ones(n - 1), -1)
    A = T + 1j * beta * (T @ T)
    mu = 4 * np.sin(np.arange(1, n + 1) * np.pi / (2 * (n + 1))) ** 2
    w = mu + 1j * beta * mu ** 2
    kw = {}
    if gen:
        b = 1.0 + 0.2 * np.random.default_rng(6).random(n)
        w = sla.eig(A, np.diag(b), right=False)
        kw = dict(B_bands=full_to_banded(np.diag(b).astype(complex), 0, 0),
                  klb=0, kub=0)
    cdt = {"c64": np.complex64, "c128": np.complex128}[dt]
    bands = full_to_banded(A, 2, 2).astype(cdt)
    if gen:
        kw["B_bands"] = kw["B_bands"].astype(cdt)
    Emid = 2.0 + 2.0j
    r, exp = _circle(w, Emid, 6)
    fn = ft.feast_sbev_complex if bil else ft.feast_gbev
    if gen:
        fn = ft.feast_sbgv_complex if bil else ft.feast_gbgv
        args = (bands, 2, 2, kw["B_bands"], 0, 0, Emid, r, len(exp) + 8)
    else:
        args = (bands, 2, 2, Emid, r, len(exp) + 8)
    rg = fn(*args)
    rc = fn(*args, device="cpu")
    bar = 1e-4 if dt == "c64" else 1e-9
    assert rg.q.is_cuda and int(rg.info) == 0 and rg.M == rc.M == len(exp)
    assert _general_match(rg.lam, rc.lam) <= bar
    assert _general_match(rg.lam, exp) <= bar


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["companion", "direct"])
def test_polynomial_on_cuda_matches_cpu(method):
    _need_cuda()
    n = 96
    k = np.linspace(0.5, 2.0, n)
    K, C, M = np.diag(k), 0.05 * np.eye(n), np.eye(n)
    lam = np.concatenate([-0.025 + 1j * np.sqrt(k - 0.000625 + 0j),
                          -0.025 - 1j * np.sqrt(k - 0.000625 + 0j)])
    Emid, r = -0.025 + 1.05j, 0.03
    exp = _general_inside(lam, Emid, r)
    rg = ft.feast_polynomial([K, C, M], Emid, r, len(exp) + 8,
                             method=method)
    rc = ft.feast_polynomial([K, C, M], Emid, r, len(exp) + 8,
                             method=method, device="cpu")
    bar = 1e-9 if method == "companion" else 1e-6
    assert rg.q.is_cuda and rg.M == rc.M == len(exp) > 0
    assert int(rg.info) == int(rc.info)
    assert _general_match(rg.lam, rc.lam) <= bar
    assert _general_match(rg.lam, exp) <= (1e-9 if method == "companion"
                                           else 1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("bil", [False, True])
def test_sparse_general_on_cuda_matches_cpu(bil):
    # the complex stencil (1 + i beta) T (x) I + I (x) T on a 32 x 32 grid
    # through the Krylov engine: multigrid, complex64 GMRES inside a
    # complex128 refinement on CUDA, the complex DIA entries launched as
    # the solve's Krylov record implies
    _need_cuda()
    from feastkit_tpu_torch.ops import dia as D
    from feastkit_tpu_torch.solvers.sparse import krylov_dia_launches
    nx, beta = 32, 0.5
    T = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(nx, nx))
    A = ((1 + 1j * beta) * sp.kron(sp.eye(nx), T)
         + sp.kron(T, sp.eye(nx))).tocsr()
    mu = 4 * np.sin(np.arange(1, nx + 1) * np.pi / (2 * (nx + 1))) ** 2
    lam = ((1 + 1j * beta) * mu[None, :] + mu[:, None]).ravel()
    Emid, r = 0.15, 0.1
    exp = _general_inside(lam, Emid, r)
    fpm = ft.feastinit()
    fpm[3] = 8
    D.reset_launch_counts()
    rg = ft.feast_general(A, None, Emid, r, len(exp) + 8, fpm,
                          solver="gmres", complex_symmetric=bil)
    counts = D.launch_counts()
    rc = ft.feast_general(A, None, Emid, r, len(exp) + 8, fpm,
                          solver="gmres", complex_symmetric=bil,
                          device="cpu")
    assert rg.q.is_cuda and int(rg.info) == 0 and rg.M == rc.M == len(exp)
    assert rg.krylov["precond"] == "mg" and rg.krylov["complex"]
    assert counts == krylov_dia_launches(rg.krylov)
    for name in ("dia_matvec_batched_c64", "dia_matvec_batched_c128",
                 "dia_matvec_c128"):
        assert counts[name] > 0, name
    assert all(v == 0 for k, v in counts.items() if k[-3:] in ("f32",
                                                               "f64"))
    assert _general_match(rg.lam, rc.lam) <= 1e-8
    assert _general_match(rg.lam, exp) <= 1e-8
    assert rg.res.max() <= 1e-8


def _lap2d_dia_operator(nx, device):
    """The 2D Laplacian on an nx x nx grid as a LinearOperator whose matvec
    is dia_matvec_f64 on its five diagonals (``device``)."""
    from feastkit_tpu_torch.ops import dia as D
    T = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(nx, nx))
    c = (sp.kron(T, sp.eye(nx)) + sp.kron(sp.eye(nx), T)).tocoo()
    dia, offs = bcoo_to_dia(c.data, np.stack([c.row, c.col], axis=1),
                            nx * nx)
    d = torch.as_tensor(dia, device=device)
    op = ft.LinearOperator(lambda X: D.dia_matvec_f64(d, offs, X),
                           (nx * nx, nx * nx), torch.float64, symmetric=True)
    wx = 2.0 - 2.0 * np.cos(np.arange(1, nx + 1) * np.pi / (nx + 1))
    return op, np.sort((wx[:, None] + wx[None, :]).ravel())


@pytest.mark.cuda
@pytest.mark.parametrize("solver", ["gmres", "bicgstab", "cheb"])
def test_matfree_on_cuda_matches_cpu(solver):
    """feast on a DIA-kernel operator (phase 13 of chip_smoke.py at a
    small size) on the card against the CPU; for the polynomial filter the
    dia_matvec_f64 launches equal their reckoning: the 192 Lanczos steps,
    len(coeffs) - 1 per filter application (one a loop and the spurious
    check) and two a loop (Rayleigh-Ritz, residuals)."""
    _need_cuda()
    from feastkit_tpu_torch.ops import dia as D
    from feastkit_tpu_torch.ops.chebfilter import build_cheb_filter_coeffs
    from feastkit_tpu_torch.solvers.matfree import operator_spectrum_bounds
    nx = 16
    op, w = _lap2d_dia_operator(nx, "cuda")
    opc, _ = _lap2d_dia_operator(nx, "cpu")
    Emin, Emax = float(w[0] / 2), float((w[19] + w[20]) / 2)
    exp = w[(w >= Emin) & (w <= Emax)]
    fpm = ft.feastinit()
    fpm[3] = 8
    if solver == "cheb":
        lo, hi = operator_spectrum_bounds(op, nx * nx, np.float64)
        coeffs, _ = build_cheb_filter_coeffs(lo, hi, Emin, Emax)
    D.reset_launch_counts()
    rg = ft.feast(op, None, (Emin, Emax), 28, fpm, solver=solver)
    counts = D.launch_counts()
    rc = ft.feast(opc, None, (Emin, Emax), 28, fpm, solver=solver,
                  device="cpu")
    assert rg.q.is_cuda and int(rg.info) == int(rc.info) == 0
    assert rg.M == rc.M == len(exp)
    assert np.abs(np.sort(rg.lam) - np.sort(rc.lam)).max() <= 1e-9
    assert np.abs(np.sort(rg.lam) - exp).max() <= 1e-9
    assert all(v == 0 for k, v in counts.items() if k != "dia_matvec_f64")
    if solver == "cheb":
        loops = rg.loop + 1
        assert counts["dia_matvec_f64"] == 192 + (loops + 1) * (
            len(coeffs) - 1) + 2 * loops
    else:
        assert counts["dia_matvec_f64"] > 0


@pytest.mark.cuda
def test_matfree_general_on_cuda_matches_cpu():
    # phase 12's complex stencil on a 16 x 16 grid through feast_general on
    # a LinearOperator: dia_matvec_any on complex128 diagonals
    _need_cuda()
    from feastkit_tpu_torch.ops import dia as D
    nx, beta = 16, 0.5
    T = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(nx, nx))
    c = ((1 + 1j * beta) * sp.kron(sp.eye(nx), T)
         + sp.kron(T, sp.eye(nx))).tocoo()
    dia, offs = bcoo_to_dia(c.data, np.stack([c.row, c.col], axis=1),
                            nx * nx)
    mu = 4 * np.sin(np.arange(1, nx + 1) * np.pi / (2 * (nx + 1))) ** 2
    lam = ((1 + 1j * beta) * mu[None, :] + mu[:, None]).ravel()
    Emid, r = 0.4, 0.3
    exp = _general_inside(lam, Emid, r)
    fpm = ft.feastinit()
    fpm[3] = 8
    out = []
    for device in ("cuda", "cpu"):
        d = torch.as_tensor(dia, device=device)
        op = ft.LinearOperator(lambda X, d=d: D.dia_matvec_any(d, offs, X),
                               (nx * nx, nx * nx), torch.complex128)
        D.reset_launch_counts()
        out.append((ft.feast_general(op, None, Emid, r, len(exp) + 8, fpm,
                                     device=device), D.launch_counts()))
    (rg, counts), (rc, _) = out
    assert rg.q.is_cuda and int(rg.info) == int(rc.info) == 0
    assert rg.M == rc.M == len(exp) > 0
    assert counts["dia_matvec_c128"] > 0 and all(
        v == 0 for k, v in counts.items() if k != "dia_matvec_c128")
    assert _general_match(rg.lam, rc.lam) <= 1e-8
    assert _general_match(rg.lam, exp) <= 1e-7


@pytest.mark.cuda
def test_matfree_polynomial_on_cuda_matches_cpu():
    # the quadratic of tests/test_sparse_matfree.py's companion case, its
    # coefficients operators on the card
    _need_cuda()
    n = 40
    rng = np.random.default_rng(2)
    d0 = rng.uniform(0.5, 2.0, n)
    d1 = rng.uniform(-1.0, 1.0, n)
    roots = np.concatenate([(-d1[i] + np.array([1, -1]) * np.sqrt(
        d1[i] ** 2 - 4 * d0[i] + 0j)) / 2 for i in range(n)])
    center = roots[7]
    dists = np.sort(np.abs(roots - center))
    r = float((dists[4] + dists[5]) / 2)
    exp = roots[np.abs(roots - center) <= r]
    coeffs = [np.diag(d0) + 0j, np.diag(d1) + 0j, np.eye(n) + 0j]
    fpm = ft.feastinit()
    fpm[3] = 8
    res = [ft.feast_polynomial(
        [ft.LinearOperator.from_matrix(torch.as_tensor(c, device=device))
         for c in coeffs], complex(center), r, len(exp) + 4, fpm,
        solver_restart=2 * n, device=device) for device in ("cuda", "cpu")]
    rg, rc = res
    assert rg.q.is_cuda and rg.q.shape == (n, rg.M)
    assert int(rg.info) == int(rc.info) == 0 and rg.M == rc.M == len(exp)
    assert _general_match(rg.lam, rc.lam) <= 1e-8
    assert _general_match(rg.lam, exp) <= 1e-7


@pytest.mark.cuda
def test_matfree_array_operands_on_the_card(monkeypatch):
    """Arrays given to the matrix-free drivers with device=None (feast's
    B beside an operator, feast_polynomial's coefficients with
    method="matfree") become tensors on the card, so their products run
    there; the eigenvalues are the analytic ones."""
    _need_cuda()
    from feastkit_tpu_torch.solvers.matfree import LinearOperator
    seen = []
    from_matrix = LinearOperator.from_matrix

    def record(A, **flags):
        seen.append(A.device.type)
        return from_matrix(A, **flags)
    monkeypatch.setattr(LinearOperator, "from_matrix", staticmethod(record))
    nx = 16
    op, w = _lap2d_dia_operator(nx, "cuda")
    Emin, Emax = float(w[0] / 4), float((w[9] + w[10]) / 4)
    exp = w[:10] / 2
    fpm = ft.feastinit()
    fpm[3] = 8
    res = ft.feast(op, 2.0 * np.eye(nx * nx), (Emin, Emax), 16, fpm)
    assert seen == ["cuda"] and res.q.is_cuda
    assert int(res.info) == 0 and res.M == len(exp)
    assert np.abs(np.sort(res.lam) - exp).max() <= 1e-9
    n = 40
    rng = np.random.default_rng(2)
    d0 = rng.uniform(0.5, 2.0, n)
    d1 = rng.uniform(-1.0, 1.0, n)
    roots = np.concatenate([(-d1[i] + np.array([1, -1]) * np.sqrt(
        d1[i] ** 2 - 4 * d0[i] + 0j)) / 2 for i in range(n)])
    center = roots[7]
    dists = np.sort(np.abs(roots - center))
    r = float((dists[4] + dists[5]) / 2)
    exp = roots[np.abs(roots - center) <= r]
    seen.clear()
    rp = ft.feast_polynomial(
        [np.diag(d0) + 0j, np.diag(d1) + 0j, np.eye(n) + 0j],
        complex(center), r, len(exp) + 4, fpm, method="matfree",
        solver_restart=2 * n)
    assert seen == ["cuda"] * 3 and rp.q.is_cuda
    assert int(rp.info) == 0 and rp.M == len(exp)
    assert _general_match(rp.lam, exp) <= 1e-7


@pytest.mark.cuda
@pytest.mark.parametrize("machine", ["FeastSRCI", "FeastGRCI"])
def test_rci_on_cuda_matches_cpu(machine):
    """An RCI machine serviced with torch LU on the card emits the jobs,
    loops and eigenvalues of the same machine on the CPU."""
    _need_cuda()
    from feastkit_tpu_torch.core.types import FeastRCIJob as Job
    rng = np.random.default_rng(0)
    n = 120
    if machine == "FeastSRCI":
        A = rng.standard_normal((n, n))
        A = (A + A.T) / 2
        B = rng.standard_normal((n, n))
        B = B @ B.T / n + np.eye(n)
        import scipy.linalg as sla
        w = sla.eigh(A, B, eigvals_only=True)
        args = (n, 16, float(w[40] - 1e-9), float(w[50] + 1e-9))
        kw = {}
    else:
        A = np.diag(np.linspace(-1.0, 1.0, n)) + np.triu(
            0.01 * (rng.standard_normal((n, n))
                    + 1j * rng.standard_normal((n, n))), 1)
        B = np.eye(n)
        args = (n, 16, 0.0, 0.1)
        kw = {"standard_B": True}
    runs = []
    for device in ("cuda", "cpu"):
        At, Bt = (torch.as_tensor(X, device=device).to(torch.complex128)
                  for X in (A, B))
        st = getattr(ft, machine)(*args, device=device, **kw)
        jobs = []
        job = st.step()
        while job != Job.DONE:
            jobs.append(int(job))
            if job == Job.FACTORIZE:
                factor = torch.linalg.lu_factor(st.Ze * Bt - At)
            elif job == Job.SOLVE:
                st.workc = torch.linalg.lu_solve(*factor, st.workc)
            elif job == Job.MULT_A:
                st.workc = At @ st.workc
            elif job == Job.MULT_B:
                st.workc = Bt @ st.workc
            job = st.step()
        runs.append((st, jobs))
    (sg, jg), (sc, jc) = runs
    assert jg == jc and sg.loop == sc.loop and sg.q.is_cuda
    assert sg.M == sc.M > 0 and int(sg.info) == int(sc.info) == 0
    assert _general_match(sg.lam[sg.inside], sc.lam[sc.inside]) <= 1e-10


# -- the public surface (aliases, checkpoint, profiling, the count) --------

def _lap2d_csr(nx):
    T = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(nx, nx))
    return (sp.kron(sp.eye(nx), T) + sp.kron(T, sp.eye(nx))).tocsr()


def _count_fpm(mixed=None, trials=10):
    fpm = ft.feastinit()
    fpm[14] = 2
    fpm[32] = trials
    if mixed is not None:
        fpm[42] = mixed
    return fpm


@pytest.mark.cuda
@pytest.mark.parametrize("solver", ["cheb", "gmres"])
def test_count_on_cuda_matches_cpu_and_plain(solver, monkeypatch):
    """fpm[14] = 2 on the polynomial engine (the unfused recurrence on
    dia_matvec_f64, one launch per series step) and on the Krylov engine
    (the DIA entries inside GMRES) at small N: the card's count against
    the CPU's with mixed precision off on both (1e-10 relative), and, with
    the default fpm[42], against the same filter on the same probes with
    the plain DIA product on the card tensors (1e-9 relative)."""
    _need_cuda()
    from feastkit_tpu_torch.ops import dia as D
    from feastkit_tpu_torch.solvers import sparse as S
    A = _lap2d_csr(16)
    w = np.linalg.eigvalsh(A.toarray())
    Emin, Emax = 0.05, float((w[19] + w[20]) / 2)
    seen = []
    orig = S._sparse_cheb_filter_host

    def unfused(ctx, Q, *, rung, n_coeffs=None):
        seen.append(len(ctx[rung]["coeffs"]))
        return orig(ctx, Q, rung=rung, n_coeffs=n_coeffs)
    monkeypatch.setattr(S, "_sparse_cheb_filter_host", unfused)
    rc = ft.feast_scsrev(A, Emin, Emax, 8, _count_fpm(0), solver=solver,
                         device="cpu")
    D.reset_launch_counts()
    rg = ft.feast_scsrev(A, Emin, Emax, 8, _count_fpm(0), solver=solver)
    counts = D.launch_counts()
    assert rg.q.is_cuda and rg.lam.size == 0 and rg.M == rc.M
    assert abs(rg.epsout - rc.epsout) <= 1e-10 * abs(rc.epsout)
    assert abs(rg.epsout - np.sum((w >= Emin) & (w <= Emax))) <= 10
    if solver == "cheb":
        assert counts["dia_matvec_f64"] == seen[-1] - 1
        assert sum(counts.values()) == counts["dia_matvec_f64"]
    else:
        assert sum(counts.values()) > 0
    kernel = ft.feast_scsrev(A, Emin, Emax, 8, _count_fpm(), solver=solver)
    monkeypatch.setattr(S, "dia_matvec_any", D.dia_matvec_plain)
    D.reset_launch_counts()
    plain = ft.feast_scsrev(A, Emin, Emax, 8, _count_fpm(), solver=solver)
    assert sum(D.launch_counts().values()) == 0
    assert abs(kernel.epsout - plain.epsout) <= 1e-9 * abs(plain.epsout)


@pytest.mark.cuda
def test_checkpoint_from_cuda_tensors(tmp_path):
    """A checkpoint of a solve whose basis lives on the card: saved from
    the device tensors, resumed on the card in at most one loop, the
    eigenvalues within 1e-12."""
    _need_cuda()
    n = 60
    A = np.diag(2.0 * np.ones(n)) - np.eye(n, k=1) - np.eye(n, k=-1)
    r = ft.feast_syev(A, 0.5, 1.5, 14)
    assert r.q_full.is_cuda
    ft.save_checkpoint(tmp_path / "ck.npz", r, ft.feastinit(), (0.5, 1.5))
    ck = ft.load_checkpoint(tmp_path / "ck.npz")
    assert isinstance(ck.Q, np.ndarray) and ck.Q.shape == (n, 14)
    r2 = ft.feast_syev(A, 0.5, 1.5, 14, **ft.resume_kwargs(ck))
    assert r2.loop <= 1 and r2.M == r.M
    assert np.abs(np.sort(r2.lam) - np.sort(r.lam)).max() < 1e-12


@pytest.mark.cuda
def test_i_and_x_names_on_cuda_match_cpu():
    """difeast_scsrev (the Krylov engine on the DIA entries) and
    dfeast_syevx (the caller's contour) on the card against the CPU."""
    _need_cuda()
    from feastkit_tpu_torch.ops import dia as D
    n = 120
    A = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(n, n)).tocsr()
    w = np.linalg.eigvalsh(A.toarray())
    exp = w[(w >= 0.5) & (w <= 0.8)]
    D.reset_launch_counts()
    rg = ft.difeast_scsrev(A, 0.5, 0.8, 16)
    assert sum(D.launch_counts().values()) > 0
    rc = ft.difeast_scsrev(A, 0.5, 0.8, 16, device="cpu")
    assert rg.q.is_cuda and rg.M == rc.M == len(exp)
    assert np.abs(np.sort(rg.lam) - exp).max() <= 1e-9
    c = ft.feast_contour(0.5, 1.5, ft.feastinit())
    Ad = A.toarray()
    wd = w[(w >= 0.5) & (w <= 1.5)]
    rg = ft.dfeast_syevx(Ad, 0.5, 1.5, 48, c.Zne, c.Wne)
    rc = ft.dfeast_syevx(Ad, 0.5, 1.5, 48, c.Zne, c.Wne, device="cpu")
    assert rg.q.is_cuda and rg.M == rc.M == len(wd)
    assert np.abs(np.sort(rg.lam) - wd).max() <= 1e-10


@pytest.mark.cuda
def test_trace_to_names_a_port_kernel(tmp_path):
    """trace_to around a small polynomial solve on the card writes a Chrome
    trace whose CUDA kernel events name a Chebyshev or DIA kernel."""
    _need_cuda()
    import json
    A = _lap2d_csr(16)
    w = np.linalg.eigvalsh(A.toarray())
    with ft.trace_to(str(tmp_path)):
        ft.feast_scsrev(A, 0.05, float((w[19] + w[20]) / 2), 28,
                        solver="cheb")
    with open(tmp_path / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name", "") for e in events if e.get("cat") == "kernel"}
    assert any(("cheb" in n or "dia_" in n) for n in names), sorted(names)
    # the port's spans beside it: the filter applications and their launches
    with open(tmp_path / "spans.json") as f:
        spans = json.load(f)["spans"]
    filters = [s for s in spans if s["name"] == "filter"]
    assert filters and all(s["attrs"]["launches"] > 0 for s in filters)
    assert {"route", "q0", "loop", "rr", "verify", "result"} <= {
        s["name"] for s in spans}


_H2D_SOLVE = r"""
import json, sys
import scipy.sparse as sp
import feastkit_tpu_torch as ft
from feastkit_tpu_torch.ops import cheb_kernels as ck, dia, seeded_draw
from feastkit_tpu_torch.utils import trace
out, nx, M0, Emax = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), \
    float(sys.argv[4])
T = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(nx, nx))
A = (sp.kron(sp.eye(nx), T) + sp.kron(T, sp.eye(nx))).tocsr()


def launches():
    return (sum(ck.launch_counts().values())
            + sum(dia.launch_counts().values())
            + sum(seeded_draw.launch_counts().values()))


before = launches()
with ft.trace_to(out):
    r = ft.feast(A, None, (0.0, Emax), M0)
with open(out + "/result.json", "w") as f:
    json.dump(dict(M=int(r.M), info=int(r.info), moved=launches() - before,
                   on=trace.enabled(), left=len(trace.spans())), f)
"""


@pytest.mark.cuda
def test_trace_counts_the_bytes_sent_to_the_card(tmp_path):
    """A traced standard solve on the card through ``feast``: its span
    counts the bytes that cross to the card as the profiler's host-to-
    device copies carry them (the operator's five f64 diagonals: the
    seeded subspace is drawn on the card, its ``q0`` span says so and has
    no upload; less than 64 KiB of scalars and small index arrays cross
    outside the counter), its launches as the kernels' counters moved, and
    host time inside the launch wrappers. The solve runs in a fresh
    process under ``trace_to``: torch.profiler (2.11, CUDA 12.8) records
    the pageable host-to-device copies only in a process's first profiling
    session."""
    _need_cuda()
    import json
    import os
    import subprocess
    import sys
    nx, M0 = 64, 24
    w1 = 2.0 - 2.0 * np.cos(np.arange(1, nx + 1) * np.pi / (nx + 1))
    w = np.sort(np.add.outer(w1, w1).ravel())
    Emax = float((w[16] + w[17]) / 2)      # a gap past 17 pairs
    script = tmp_path / "solve.py"
    script.write_text(_H2D_SOLVE)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (root, os.environ.get("PYTHONPATH")) if p))
    subprocess.run([sys.executable, str(script), str(tmp_path), str(nx),
                    str(M0), repr(Emax)], env=env, check=True, timeout=600)
    with open(tmp_path / "result.json") as f:
        r = json.load(f)
    with open(tmp_path / "spans.json") as f:
        spans = json.load(f)["spans"]
    with open(tmp_path / "trace.json") as f:
        copies = [e for e in json.load(f)["traceEvents"]
                  if e.get("cat") == "gpu_memcpy"
                  and "HtoD" in e.get("name", "")]
    sent = sorted(int(e["args"]["bytes"]) for e in copies)
    assert r["M"] == 17 and r["info"] == 0
    assert not r["on"] and r["left"] == 0
    feast = spans[0]
    assert feast["name"] == "feast" and feast["attrs"]["path"] == "cheb"
    N = nx * nx
    q0 = [s for s in spans if s["name"] == "q0"]
    up = [s for s in spans if s["name"] == "route.upload"]
    assert [s["attrs"]["draw"] for s in q0] == ["card"]
    assert [s["attrs"]["libm"] for s in q0] == ["same"]
    assert [s["attrs"]["h2d_bytes"] for s in q0] == [0]
    assert not [s for s in spans if s["name"] == "q0.upload"]
    assert [s["attrs"]["h2d_bytes"] for s in up] == [5 * N * 8]
    assert feast["attrs"]["h2d_bytes"] == 5 * N * 8
    assert 0 <= sum(sent) - feast["attrs"]["h2d_bytes"] < 1 << 16, sent
    assert feast["attrs"]["launches"] == r["moved"] > 0
    assert feast["attrs"]["launch_host_ns"] > 0


_HALO_RANK = r"""
import sys
from datetime import timedelta
import numpy as np, torch, torch.distributed as dist
rank, store, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
dist.init_process_group("gloo", init_method="file://" + store, rank=rank,
                        world_size=2, timeout=timedelta(seconds=60))
from feastkit_tpu_torch.ops import dia
from feastkit_tpu_torch.parallel import pfeast as pf
rng = np.random.default_rng(7)
N, offsets = 4096, (-64, -1, 0, 1, 64)
diags = torch.as_tensor(rng.standard_normal((5, N)))
x = torch.as_tensor(rng.standard_normal((2, N, 24))
                    + 1j * rng.standard_normal((2, N, 24)))
mesh = pf.contour_model_mesh(1, 2)
size, index, group = pf._axis(mesh, "model")
rows = slice(index * N // 2, (index + 1) * N // 2)
res = {}
for label, X in (("f64", x[0].real), ("c128", x[0]), ("batched", x)):
    d, X = diags.cuda(), X[..., rows, :].contiguous().cuda()
    before = dict(dia.launch_counts())
    y = pf._dia_halo_matvec(d[:, rows], X, offsets, (size, index, group))
    after = dia.launch_counts()
    yp = pf._dia_halo_matvec_plain(d[:, rows], X, offsets,
                                   (size, index, group))
    res[label] = y.cpu().numpy()
    res[label + "/plain"] = yp.cpu().numpy()
    res[label + "/launches"] = sum(after.values()) - sum(before.values())
res["rows"] = np.array([rows.start, rows.stop])
np.savez(out, **res)
dist.destroy_process_group()
"""


@pytest.mark.cuda
def test_halo_product_on_cuda_matches_serial(tmp_path):
    """Two ranks on the card (gloo, CUDA tensors): each rank's rows of the
    halo DIA product, the DIA kernel on the extended block (one launch a
    product), equal the serial plain product's rows and the plain shifted
    adds."""
    _need_cuda()
    import os
    import subprocess
    import sys
    from feastkit_tpu_torch.ops.dia import dia_matvec_plain
    script = tmp_path / "rank.py"
    script.write_text(_HALO_RANK)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (root, os.environ.get("PYTHONPATH")) if p))
    outs = [tmp_path / f"r{r}.npz" for r in range(2)]
    procs = [subprocess.Popen([sys.executable, str(script), str(r),
                               str(tmp_path / "store"), str(outs[r])],
                              env=env) for r in range(2)]
    try:
        for p in procs:
            assert p.wait(timeout=300) == 0
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    rng = np.random.default_rng(7)
    N, offsets = 4096, (-64, -1, 0, 1, 64)
    diags = torch.as_tensor(rng.standard_normal((5, N)))
    x = torch.as_tensor(rng.standard_normal((2, N, 24))
                        + 1j * rng.standard_normal((2, N, 24)))
    for label, X in (("f64", x[0].real), ("c128", x[0]), ("batched", x)):
        want = dia_matvec_plain(diags.to(X.dtype), offsets, X).numpy()
        for out in outs:
            with np.load(out) as z:
                lo, hi = z["rows"]
                bar = 1e-13 * np.abs(want).max()
                assert np.abs(z[label] - want[..., lo:hi, :]).max() <= bar
                assert np.abs(z[label + "/plain"]
                              - want[..., lo:hi, :]).max() <= bar
                assert int(z[label + "/launches"]) == 1


@pytest.mark.cuda
@pytest.mark.parametrize("grid", [(64, 48), (16, 12, 10)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.complex64])
def test_stencil_conv_on_cuda_matches_shifted_adds(grid, dtype, monkeypatch):
    """FEAST_STENCIL_CONV=1 on the card: one cuDNN convolution (complex64
    as two) against the shifted adds on the same tensor, within float32
    rounding."""
    _need_cuda()
    from feastkit_tpu_torch.ops.multigrid import apply_stencil
    nd = len(grid)
    disps = [[0] * nd]
    coeffs = [2.0 * nd]
    for k in range(nd):
        for s in (1, -1):
            d = [0] * nd
            d[k] = s
            disps.append(d)
            coeffs.append(-1.0)
    disps = np.asarray(disps)
    g = torch.Generator().manual_seed(5)
    x = torch.randn((3,) + grid, generator=g, dtype=torch.float32)
    if dtype == torch.complex64:
        x = torch.complex(x, torch.randn((3,) + grid, generator=g))
    x = x.cuda()
    monkeypatch.delenv("FEAST_STENCIL_CONV", raising=False)
    want = apply_stencil(x, disps, coeffs, grid)
    monkeypatch.setenv("FEAST_STENCIL_CONV", "1")
    got = apply_stencil(x, disps, coeffs, grid)
    assert got.dtype == dtype and got.shape == x.shape
    err = float((got - want).abs().max())
    assert err <= 8 * 1.2e-7 * len(coeffs) * float(want.abs().max())


def _host_ladder_start(N, M0):
    """The precision ladder's start as the host draws it."""
    from feastkit_tpu_torch.core.tools import seeded_subspace
    q = seeded_subspace(N, M0, np.float64)
    return q.astype(np.float32).astype(np.float64)


@pytest.mark.cuda
def test_seeded_draw_libm_is_the_hosts():
    """The card's log1p and exp (glibc's x86-64 FMA builds) give the host
    libm's bits on the probe's inputs, with no warning."""
    _need_cuda()
    import warnings
    from feastkit_tpu_torch.ops import seeded_draw as sd
    sd.libm_matches.cache_clear()
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert sd.libm_matches(torch.cuda.current_device())


@pytest.mark.cuda
@pytest.mark.parametrize("N,M0", [(1048576, 72), (65536, 72), (1000, 7),
                                  (3001, 2), (20011, 1), (7, 1), (1, 5)])
def test_seeded_draw_on_the_card_is_the_host_draw(N, M0):
    """The subspace drawn on the card equals the host's float32 bits
    widened, bit for bit: the main path's shape (~17,500 tail draws), the
    consistent-mass cell's, and small and odd shapes (N * M0 not a multiple
    of any chunk, M0 = 1's pairwise norm)."""
    _need_cuda()
    from feastkit_tpu_torch.ops import seeded_draw as sd
    before = sd.seeded_draw_f64.launches
    q = sd.seeded_subspace_f32_bits(N, M0, "cuda")
    assert q.is_cuda and q.dtype == torch.float64
    assert sd.seeded_draw_f64.launches == before + (5 if M0 >= 2 else 6)
    got = q.cpu().numpy()
    assert np.array_equal(got.view(np.uint64),
                          _host_ladder_start(N, M0).view(np.uint64))


@pytest.mark.cuda
@pytest.mark.parametrize("chunk,entries,group", [(7, 2, 5), (16, 1, 3),
                                                 (64, 3, 2)])
def test_seeded_draw_small_chunks_on_the_card(chunk, entries, group):
    """The same passes cut small on the card: many chunks, tails and wedges
    across chunk ends, the walk's fix-ups past the maps."""
    _need_cuda()
    from feastkit_tpu_torch.ops import seeded_draw as sd
    N, M0 = 4099, 24
    out = torch.empty((N, M0), dtype=torch.float64, device="cuda")
    assert sd.seeded_draw_f64(out, chunk=chunk, entries=entries,
                              group=group) is out
    assert np.array_equal(out.cpu().numpy(), _host_ladder_start(N, M0))


@pytest.mark.cuda
def test_card_draw_solve_is_the_host_draw_solve():
    """A five-point solve on the card that draws its subspace there gives
    the same eigenvalues, vectors and loop count, bit for bit, as the same
    solve handed the host draw's widened f32 bits as Q0 (fpm[5] = 1)."""
    _need_cuda()
    from feastkit_tpu_torch.ops import seeded_draw as sd
    nx, M0 = 64, 24
    A = _lap2d_csr(nx)
    w1 = 2.0 - 2.0 * np.cos(np.arange(1, nx + 1) * np.pi / (nx + 1))
    w = np.sort(np.add.outer(w1, w1).ravel())
    Emax = float((w[16] + w[17]) / 2)
    before = sd.seeded_draw_f64.launches
    r_card = ft.feast(A, None, (0.0, Emax), M0)
    assert sd.seeded_draw_f64.launches > before
    fpm = ft.feastinit()
    fpm[5] = 1
    Q0 = _host_ladder_start(nx * nx, M0)
    drawn = sd.seeded_draw_f64.launches
    r_host = ft.feast(A, None, (0.0, Emax), M0, fpm, Q0=Q0)
    assert sd.seeded_draw_f64.launches == drawn
    assert r_card.M == r_host.M == 17 and r_card.info == r_host.info == 0
    assert r_card.loop == r_host.loop
    assert np.array_equal(np.asarray(r_card.lam), np.asarray(r_host.lam))
    assert torch.equal(r_card.q, r_host.q)
