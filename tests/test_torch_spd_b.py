"""PyTorch port, sparse SPD B (consistent mass): held against the JAX package.

The generalized polynomial-filter path filters the composite q(B~) A~ of
the unit-diagonal congruences, with q a Chebyshev polynomial inverse of B~.
The same inputs, made with numpy, go through the JAX package (on the CPU;
its Pallas kernels in interpret mode) and the port (``device="cpu"``, the
plain versions of the kernels):
  * host numerics are bit-identical: ``cheb_inverse_coeffs``,
    ``binva_enclosure``, ``_b_sparse_spd``;
  * the f32 Lanczos bounds (``_b_spd_bounds``, ``_pencil_upper_edge_fast``)
    agree to 1e-4 relative (the two frameworks sum in different orders)
    and enclose the dense truth as the JAX package's own tests require;
  * the plain combine against ``_ds_combine``: fp64 vs double-single
    <= 1e-12, f32 <= 1e-6 relative to the largest entry of each plane;
  * the plain composite init and chunk against ``cheb_gen_init`` /
    ``cheb_gen_chunk`` with f32-representable scalars and coefficients (the
    JAX package rounds them to f32 even on its double-single rung):
    fp64 vs double-single <= 1e-11, f32 <= 1e-5 (about 2^-49 and 2^-23 per
    operation over a few hundred operations per element);
  * end to end: the same M and info, eigenvalues within 1e-8 of each
    other and of scipy's dense eigh, residuals <= tol, and equal filter
    and B-inverse degrees, on the JAX package's own fixtures.
The JAX package's fused interpret-mode end-to-end solve is not run here
(it takes about a minute for a 120-dof pencil); its unfused CPU result is
the end-to-end reference.
"""
import contextlib
import functools
import io
import re

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import scipy.linalg as sla  # noqa: E402
import scipy.sparse as sp  # noqa: E402

import feastkit_tpu_torch as ft  # noqa: E402
from feastkit_tpu import feastinit as ref_feastinit  # noqa: E402
from feastkit_tpu.interfaces.feast import feast as ref_feast  # noqa: E402
from feastkit_tpu.ops import cheb_pallas as ref_cp  # noqa: E402
from feastkit_tpu.ops import chebfilter as ref_cf  # noqa: E402
from feastkit_tpu.solvers import sparse as ref_sparse  # noqa: E402
from feastkit_tpu_torch import convert  # noqa: E402
from feastkit_tpu_torch.ops import cheb_gen as port_gen  # noqa: E402
from feastkit_tpu_torch.ops import cheb_kernels as port_ck  # noqa: E402
from feastkit_tpu_torch.ops import chebfilter as port_cf  # noqa: E402
from feastkit_tpu_torch.ops.dia import bcoo_to_dia, dia_matvec  # noqa: E402
from feastkit_tpu_torch.solvers import sparse as port_sparse  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # The suite runs files in parallel worker processes on a few cores;
    # torch's default intra-op pool (one spinning thread per core) then
    # starves its neighbours. The port's CPU tensors here are small.
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fem1d(n):
    """P1 stiffness / consistent-mass pair on (0, 1), n interior nodes
    (tests/test_cheb_generalized.py)."""
    h = 1.0 / (n + 1)
    K = sp.diags([2.0 / h * np.ones(n), -1.0 / h * np.ones(n - 1),
                  -1.0 / h * np.ones(n - 1)], [0, 1, -1], format="csr")
    M = sp.diags([4 * h / 6 * np.ones(n), h / 6 * np.ones(n - 1),
                  h / 6 * np.ones(n - 1)], [0, 1, -1], format="csr")
    return K, M


def _fem2d(nx):
    """The 2D tensor pair K = D(x)Mx + Mx(x)D, M = Mx(x)Mx: nine diagonals
    each, and the congruenced M's Gershgorin discs touch zero, so the
    Lanczos bound refinement runs (tests/test_cheb_generalized.py)."""
    h = 1.0 / (nx + 1)
    D = sp.diags([2.0 / h * np.ones(nx), -1.0 / h * np.ones(nx - 1),
                  -1.0 / h * np.ones(nx - 1)], [0, 1, -1])
    Mx = sp.diags([4 * h / 6 * np.ones(nx), h / 6 * np.ones(nx - 1),
                   h / 6 * np.ones(nx - 1)], [0, 1, -1])
    return (sp.kron(D, Mx) + sp.kron(Mx, D)).tocsr(), \
        sp.kron(Mx, Mx).tocsr()


def _congruence(K, M):
    """Unit-diagonal congruences (data, idx) of K and M, as both drivers
    build them."""
    d = 1.0 / np.sqrt(M.diagonal())
    out = []
    for X in (K, M):
        data, idx, _ = port_sparse.sparse_coo_arrays(X, np.float64)
        out.append((data * d[idx[:, 0]] * d[idx[:, 1]], idx))
    return out


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


# ------------------------------------------------- (a) host numerics


@pytest.mark.parametrize("b_lo,b_hi,rel_err", [
    (0.225, 2.475, 1e-10), (0.225, 2.475, 1e-5), (0.5, 1.5, 1e-12),
    (0.49999, 1.50001, 1e-6), (1e-3, 1.0, 1e-8), (0.9, 1.1, 1e-14)])
def test_cheb_inverse_coeffs_bit_identical(b_lo, b_hi, rel_err):
    c_r, i_r = ref_cf.cheb_inverse_coeffs(b_lo, b_hi, rel_err)
    c_p, i_p = port_cf.cheb_inverse_coeffs(b_lo, b_hi, rel_err)
    assert np.array_equal(c_r, c_p) and c_p.dtype == np.float64
    assert i_r == i_p


@pytest.mark.parametrize("args", [
    (-0.03, 1.6e4, 0.225, 2.475, 1e-10), (0.0, 8.0, 0.5, 1.5, 1e-5),
    (-2.0, -0.5, 0.3, 1.7, 3e-7), (1.0, 1.0 + 1e-9, 0.9, 1.1, 0.0)])
def test_binva_enclosure_bit_identical(args):
    assert ref_cf.binva_enclosure(*args) == port_cf.binva_enclosure(*args)


def _b_cases():
    n = 50
    A_sym = sp.diags([np.ones(n), 2.0 * np.ones(n - 1),
                      2.0 * np.ones(n - 1)], [0, 1, -1], format="csr")
    return {
        "fem1d": _fem1d(40)[1],
        "fem2d": _fem2d(6)[1],
        "indefinite": A_sym,                    # still the SPD class here
        "nonsymmetric": sp.diags([np.ones(n), 0.3 * np.ones(n - 1)], [0, 1],
                                 format="csr"),
        "negative_diagonal": sp.diags([-np.ones(n), 0.1 * np.ones(n - 1),
                                       0.1 * np.ones(n - 1)], [0, 1, -1],
                                      format="csr"),
        "complex": sp.diags([np.ones(n) + 0j, 0.1j * np.ones(n - 1),
                             -0.1j * np.ones(n - 1)], [0, 1, -1],
                            format="csr"),
        "rectangular": sp.random(6, 5, density=0.5, random_state=1,
                                 format="csr"),
    }


@pytest.mark.parametrize("case", list(_b_cases()))
def test_b_sparse_spd_same_classification(case):
    B = _b_cases()[case]
    k_r, d_r = ref_sparse._b_sparse_spd(B)
    k_p, d_p = port_sparse._b_sparse_spd(B)
    assert k_r == k_p
    assert (d_r is None and d_p is None) or np.array_equal(d_r, d_p)
    assert (k_p == "spd") == (case in ("fem1d", "fem2d", "indefinite"))


# ------------------------------------------------- (b) Lanczos bounds


@functools.lru_cache(maxsize=None)
def _fem2d24_parts():
    K, M = _fem2d(24)
    N = K.shape[0]
    (Kd, Ki), (Md, Mi) = _congruence(K, M)
    K_dia, off_K = bcoo_to_dia(Kd, Ki, N)
    M_dia, off_M = bcoo_to_dia(Md, Mi, N)
    w = sla.eigh(K.toarray(), M.toarray(), eigvals_only=True)
    wb = np.linalg.eigvalsh(sp.coo_matrix(
        (Md, (Mi[:, 0], Mi[:, 1])), shape=(N, N)).toarray())
    return N, (Kd, Ki, K_dia, off_K), (Md, Mi, M_dia, off_M), w, wb


def test_b_spd_bounds_agree_and_enclose():
    N, _, (Md, Mi, M_dia, off_M), _, wb = _fem2d24_parts()
    ref = ref_sparse._b_spd_bounds(Md, Mi, N, B_dia=M_dia, offsets_B=off_M)
    port = port_sparse._b_spd_bounds(Md, Mi, N, M_dia, off_M,
                                     torch.device("cpu"))
    for r, p in zip(ref, port):
        assert abs(p - r) <= 1e-4 * abs(r)
    for lo, hi in (ref, port):
        assert lo <= wb[0] + 1e-9 and hi >= wb[-1] - 1e-9
    # the discs of the congruence touch zero: the Lanczos branch ran
    lo_g, _ = port_cf.gershgorin_interval(Md, Mi, N)
    assert lo_g <= 0.02 * port[1]


def test_pencil_upper_edge_fast_agrees_and_encloses():
    N, (_, _, K_dia, off_K), (Md, Mi, M_dia, off_M), w, _ = _fem2d24_parts()
    b_lo, b_hi = ref_sparse._b_spd_bounds(Md, Mi, N, B_dia=M_dia,
                                          offsets_B=off_M)
    qc, _ = ref_cf.cheb_inverse_coeffs(b_lo, b_hi, 1e-8)
    ref = ref_sparse._pencil_upper_edge_fast(K_dia, off_K, M_dia, off_M, qc,
                                             b_lo, b_hi, N)
    port = port_sparse._pencil_upper_edge_fast(K_dia, off_K, M_dia, off_M,
                                               qc, b_lo, b_hi, N,
                                               torch.device("cpu"))
    assert abs(port - ref) <= 1e-4 * abs(ref)
    for hi_e in (ref, port):
        assert abs(hi_e - w[-1]) < 0.02 * w[-1]


@pytest.mark.parametrize("dtype", ["f64", "f32"])
def test_make_apply_binv_a_matches_reference(dtype):
    N, (_, _, K_dia, off_K), (_, _, M_dia, off_M), _, _ = _fem2d24_parts()
    npd = np.float64 if dtype == "f64" else np.float32
    qc, _ = ref_cf.cheb_inverse_coeffs(0.225, 2.475, 1e-9)
    X = np.random.default_rng(3).standard_normal((N, 5)).astype(npd)
    Kj, Mj = jnp.asarray(K_dia.astype(npd)), jnp.asarray(M_dia.astype(npd))
    from feastkit_tpu.ops.pallas_kernels import dia_matvec_reference
    ref = ref_cf.make_apply_binv_a(
        lambda x: dia_matvec_reference(Kj, x, off_K),
        lambda x: dia_matvec_reference(Mj, x, off_M),
        jnp.asarray(npd(0.225)), jnp.asarray(npd(2.475)),
        qc.astype(npd))(jnp.asarray(X))
    Kt, Mt = torch.as_tensor(K_dia.astype(npd)), torch.as_tensor(
        M_dia.astype(npd))
    port = port_cf.make_apply_binv_a(
        lambda x: dia_matvec(Kt, off_K, x),
        lambda x: dia_matvec(Mt, off_M, x), 0.225, 2.475,
        qc.astype(npd))(torch.as_tensor(X))
    assert port.dtype == (torch.float64 if dtype == "f64" else torch.float32)
    assert _rel(port, ref) <= (1e-12 if dtype == "f64" else 1e-5)


# ------------------------------------------------- (c) the combine

NC, MC = 300, 7


def _combine_setup():
    rng = np.random.default_rng(11)
    planes = [rng.standard_normal((NC, MC)) for _ in range(4)]   # z x t0 f
    plan = ref_cp.cheb_plan((-1, 0, 1), NC, MC, margin=1)
    packed = [ref_cp.pack_state(jnp.asarray(p), plan) for p in planes]
    return planes, plan, packed


@pytest.mark.parametrize("form", ["update", "init"])
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12),
                                       (torch.float32, 1e-6)])
def test_combine_matches_ds_combine(form, dtype, tol):
    planes, plan, packed = _combine_setup()
    # f32-representable scalars: the kernel reads them from f32 SMEM
    sc, sh, ck = ((0.3125, 0.71875, 0.1875) if form == "update"
                  else (-0.40625, 0.84375, 0.5))
    z, x, t0, f = packed
    if form == "init":
        zero = jnp.zeros_like(z[0])
        t0 = f = (zero, zero)
    scal = jnp.asarray([[sc, sh, ck, 0.0]], jnp.float32)
    t2h, t2l, f2h, f2l = ref_cp._ds_combine(scal, *z, *x, *t0, *f,
                                            block=plan["block"],
                                            interpret=True)
    _, t2_ref, f2_ref = convert.carry_from_reference_packed(
        (z[0], z[1], t2h, t2l, f2h, f2l), plan, NC, MC, device="cpu")
    # the port's inputs: the double-single values as f64 (or their f32
    # rounding), column-major as the composite carries them
    ins = convert.carry_from_reference_packed(
        (*z, *x, *t0), plan, NC, MC, device="cpu") + \
        convert.carry_from_reference_packed(
            (*f, *f, *f), plan, NC, MC, device="cpu")[:1]
    zp, xp, t0p, fp = (t.to(dtype).t().contiguous() for t in ins)
    wrapper = (port_ck.cheb_combine_f64 if dtype == torch.float64
               else port_ck.cheb_combine_f32)
    if form == "init":
        out = wrapper(zp, xp, None, None, sc, sh, ck)
        assert out.dtype == dtype and out.shape == (MC, NC)
    else:
        out = wrapper(zp, xp, t0p, fp, sc, sh, ck)
        assert out is fp                        # F updated in place
        assert _rel(t0p.t(), t2_ref) <= tol     # T2 over T0
    assert _rel(out.t(), f2_ref) <= tol
    assert all(v == 0 for v in port_ck.launch_counts().values())


def test_combine_rejects_bad_operands():
    z = torch.zeros(3, 10, dtype=torch.float64)
    with pytest.raises(TypeError, match="float32"):
        port_ck.cheb_combine_f32(z, z.clone(), None, None, 1.0, 0.0, 0.5)
    with pytest.raises(ValueError, match="distinct"):
        port_ck.cheb_combine_f64(z, z, None, None, 1.0, 0.0, 0.5)
    with pytest.raises(ValueError, match="shape"):
        port_ck.cheb_combine_f64(z, torch.zeros(3, 9, dtype=torch.float64),
                                 None, None, 1.0, 0.0, 0.5)
    with pytest.raises(ValueError, match="contiguous"):
        port_ck.cheb_combine_f64(z, torch.zeros(10, 3, dtype=torch.float64).t(),
                                 None, None, 1.0, 0.0, 0.5)


def test_column_major_step_plain_is_transposed_row_major_step():
    rng = np.random.default_rng(4)
    N, M = 90, 5
    offs = (-10, -9, -1, 0, 1, 9, 10)
    dia = torch.as_tensor(rng.standard_normal((len(offs), N)))
    rows = [torch.as_tensor(rng.standard_normal((N, M))) for _ in range(3)]
    cols = [r.t().contiguous() for r in rows]
    for ck in (0.3, -0.1, 0.7):
        port_ck.cheb_step_f64(dia, offs, *rows, 0.4, 0.9, ck)
        rows[0], rows[1] = rows[1], rows[0]
        port_ck.cheb_step_cm_f64(dia, offs, *cols, 0.4, 0.9, ck)
        cols[0], cols[1] = cols[1], cols[0]
    for r, c in zip(rows, cols):
        assert torch.equal(r, c.t())
    with pytest.raises(ValueError, match=r"\(M, N\)"):
        port_ck.cheb_step_cm_f64(dia, offs, cols[0], cols[1],
                                 torch.zeros(N, M, dtype=torch.float64),
                                 0.4, 0.9, 0.1)


# ------------------------------------------------- (d) the composite


def _composite_setup():
    """A 9-diagonal congruenced pencil (the 2D tensor pair, nx = 10),
    f32-representable map scalars, a short inverse and a handful of outer
    coefficients."""
    K, M = _fem2d(10)
    N = K.shape[0]
    (Kd, Ki), (Md, Mi) = _congruence(K, M)
    A_dia, off_A = bcoo_to_dia(Kd, Ki, N)
    B_dia, off_B = bcoo_to_dia(Md, Mi, N)
    a_lo, a_hi = port_cf.gershgorin_interval(Kd, Ki, N)
    lo, hi = port_cf.binva_enclosure(a_lo, a_hi, 0.225, 2.475, 1e-3)
    scals = {k: float(np.float32(v)) for k, v in dict(
        sc_C=2.0 / (hi - lo), sh_C=(hi + lo) / (hi - lo),
        scB=2.0 / (2.475 - 0.225),
        shB=(2.475 + 0.225) / (2.475 - 0.225)).items()}
    # the inverse's first eight terms: six inner steps after the init
    qc = ref_cf.cheb_inverse_coeffs(0.225, 2.475, 1e-3)[0][:8].astype(
        np.float32)
    coeffs = (np.random.default_rng(5).standard_normal(4) * 0.2).astype(
        np.float32)
    Q = np.random.default_rng(6).standard_normal((N, MC))
    return N, (A_dia, off_A), (B_dia, off_B), scals, qc, coeffs, Q


@pytest.mark.parametrize("inner_steps", [2, 4])
@pytest.mark.parametrize("ds", [True, False])
def test_composite_matches_cheb_gen(ds, inner_steps):
    N, (A_dia, off_A), (B_dia, off_B), scals, qc, coeffs, Q = \
        _composite_setup()
    assert len(qc) - 2 == 6          # inner steps: 4 + 2, or 2 + 2 + 2
    plan = ref_cp.cheb_gen_plan(off_A, off_B, N, MC, margin=inner_steps)
    kw = dict(plan=plan, ds=ds, inner_steps=inner_steps, interpret=True)
    if ds:
        dgA = ref_cp.pack_diags(jnp.asarray(A_dia), plan)
        dgB = ref_cp.pack_diags(jnp.asarray(B_dia), plan)
        Qp = ref_cp.pack_state(jnp.asarray(Q), plan)
    else:
        dgA = ref_cp.pack_diags32(jnp.asarray(A_dia), plan)
        dgB = ref_cp.pack_diags32(jnp.asarray(B_dia), plan)
        Qp = ref_cp.pack_state32(jnp.asarray(Q), plan)
    init_ref = ref_cp.cheb_gen_init(dgA, dgB, jnp.asarray(qc), Qp,
                                    jnp.asarray(coeffs[:2]), scals, **kw)
    chunk_ref = ref_cp.cheb_gen_chunk(dgA, dgB, jnp.asarray(qc), init_ref,
                                      jnp.asarray(coeffs[2:]), scals, **kw)
    init_ref = convert.carry_from_reference_packed(init_ref, plan, N, MC,
                                                   device="cpu")
    chunk_ref = convert.carry_from_reference_packed(chunk_ref, plan, N, MC,
                                                    device="cpu")
    dtype = torch.float64 if ds else torch.float32
    dA = torch.as_tensor(A_dia).to(dtype)
    dB = torch.as_tensor(B_dia).to(dtype)
    ops = (dA, off_A, dB, off_B, qc.astype(np.float64) if ds else qc)
    q = torch.as_tensor(Q).to(dtype).t().contiguous()
    init = port_gen.cheb_gen_init(*ops, q, coeffs[:2], scals,
                                  inner_steps=inner_steps)
    tol = 1e-11 if ds else 1e-5
    for p, r in zip(init, init_ref):
        assert p.dtype == dtype and p.shape == (MC, N)
        assert _rel(p.t(), r) <= tol
    out = port_gen.cheb_gen_chunk(*ops, init, coeffs[2:], scals,
                                  inner_steps=inner_steps)
    for p, r in zip(out, chunk_ref):
        assert _rel(p.t(), r) <= tol
    assert all(v == 0 for v in port_ck.launch_counts().values())


@pytest.mark.parametrize("n_coeffs", [None, 5])
def test_gen_filter_equals_plain_composite_filter(n_coeffs):
    """The port's filter application (transposes, init, chunk, every inner
    split) against the plain Chebyshev filter on make_apply_binv_a: the
    same polynomial, so the same result to f64 rounding."""
    N, (A_dia, off_A), (B_dia, off_B), _, _, coeffs, Q = _composite_setup()
    qc, _ = port_cf.cheb_inverse_coeffs(0.225, 2.475, 1e-9)
    dA, dB = torch.as_tensor(A_dia), torch.as_tensor(B_dia)
    lo, hi = -0.5, 9.0
    ctx = port_sparse._cheb_gen_context(dA, off_A, dB, off_B, coeffs, lo,
                                        hi, 0.225, 2.475, qc, qc, MC)
    Qt = torch.as_tensor(Q)
    got = port_sparse._sparse_cheb_filter_host_fused_gen(
        ctx, Qt, rung="f64", n_coeffs=n_coeffs)
    apply_C = port_cf.make_apply_binv_a(
        lambda x: dia_matvec(dA, off_A, x), lambda x: dia_matvec(dB, off_B, x),
        0.225, 2.475, qc)
    c = np.asarray(coeffs, np.float64)[:n_coeffs]
    want = port_cf.make_cheb_filter(apply_C, lo, hi, c)(Qt)
    assert got.shape == (N, MC) and got.is_contiguous()
    assert _rel(got, want) <= 1e-12


@pytest.mark.parametrize("n,steps,split", [
    (6, 4, (4, 2, 0)), (7, 4, (4, 2, 1)), (5, 4, (4, 0, 1)),
    (7, 2, (0, 6, 1)), (7, 1, (0, 0, 7)), (0, 4, (0, 0, 0))])
def test_inner_split(n, steps, split):
    assert port_gen.inner_split(n, steps) == split


# ------------------------------------------------- (e) end to end

TOL_E2E = 1e-8


def _degrees(text):
    m = re.search(r"filter: degree=(\d+) .*B-inverse degree=(\d+)", text)
    assert m, text
    return int(m.group(1)), int(m.group(2))


def _fixture(case):
    """The JAX package's fixtures (tests/test_cheb_generalized.py) at
    tol 1e-8 (fpm[3] = 8), and a 2D pencil on the auto route with Emax at
    a spectral gap (its eigenvalues come in pairs)."""
    if case == "fem1d_cheb":
        K, M = _fem1d(400)
        count, solver = 11, "cheb"
    elif case == "fem1d_ladder":
        K, M = _fem1d(120)
        count, solver = 7, "cheb"
    elif case == "fem2d_cheb":
        K, M = _fem2d(24)
        count, solver = 8, "cheb"
    else:                                     # the auto route, nx = 32
        K, M = _fem2d(32)
        count, solver = 8, None
    w = sla.eigh(K.toarray(), M.toarray(), eigvals_only=True)
    if solver:
        Emax = float(w[count - 1] * 1.001)
    else:
        gaps = np.nonzero(np.diff(w) > 1e-9 * w[-1])[0]
        hi = gaps[np.searchsorted(gaps, count - 1)]
        Emax = float(0.5 * (w[hi] + w[hi + 1]))
    exact = np.sort(w[(w >= 0.0) & (w <= Emax)])
    return K, M, Emax, exact, solver, 8


@functools.lru_cache(maxsize=None)
def _solve(case, mixed=1):
    K, M, Emax, exact, solver, fpm3 = _fixture(case)
    fpm = ref_feastinit()
    fpm[1] = 1
    fpm[3] = fpm3
    fpm[42] = mixed
    M0 = len(exact) + 6
    out_r, out_p = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out_r):
        if solver:
            r = ref_sparse.feast_scsrgv(K, M, 0.0, Emax, M0, fpm,
                                        solver=solver)
        else:
            r = ref_feast(K, M, (0.0, Emax), M0, fpm, backend="serial")
    fpm_p = convert.fpm_from_reference(fpm)
    with contextlib.redirect_stdout(out_p):
        p = (ft.feast_scsrgv(K, M, 0.0, Emax, M0, fpm_p, solver=solver,
                             device="cpu") if solver
             else ft.feast(K, M, (0.0, Emax), M0, fpm_p, device="cpu"))
    return r, p, exact, out_r.getvalue(), out_p.getvalue(), (K, M)


CASES = ["fem1d_cheb", "fem2d_cheb", "fem2d_auto"]


@pytest.mark.parametrize("case", CASES)
def test_e2e_same_count_status_and_degrees(case):
    r, p, exact, out_r, out_p, _ = _solve(case)
    assert p.M == r.M == len(exact)
    assert int(p.info) == int(r.info) == 0
    assert _degrees(out_p) == _degrees(out_r)
    assert ("contour-poly" in out_p) == ("contour-poly" in out_r)


@pytest.mark.parametrize("case", CASES)
def test_e2e_eigenvalues_and_residuals(case):
    r, p, exact, _, _, (K, M) = _solve(case)
    tol = 10.0 ** -_fixture(case)[5]
    lam_p = np.sort(np.asarray(p.lam))
    assert np.abs(lam_p - np.sort(np.asarray(r.lam))).max() <= TOL_E2E
    assert np.abs(lam_p - exact).max() <= TOL_E2E
    assert np.asarray(p.res).max() <= tol and p.epsout <= tol
    # the residuals are the ORIGINAL pencil's, for the returned vectors
    q = p.q.numpy()
    j = int(np.argmin(np.asarray(p.lam)))
    lj = float(p.lam[j])
    rr = np.linalg.norm(K @ q[:, j] - lj * (M @ q[:, j])) / max(abs(lj), 1.0)
    assert abs(rr - float(p.res[j])) <= 1e-12 + 0.1 * rr


def test_e2e_mixed_ladder_prints_both_rungs():
    # fpm[42] = 2 forces the f32 -> f64 ladder on the CPU (the JAX
    # package: its unfused f32 rung, then f64)
    r, p, exact, out_r, out_p, _ = _solve("fem1d_ladder", mixed=2)
    assert "B-inverse degree=" in out_p
    i32, i64 = out_p.find("f32 recurrence"), out_p.find("f64 recurrence")
    assert 0 <= i32 < i64
    assert "f32 recurrence" in out_r
    assert p.M == r.M == len(exact) and int(p.info) == 0
    assert np.abs(np.sort(np.asarray(p.lam)) - exact).max() <= TOL_E2E
    assert np.abs(np.sort(np.asarray(p.lam))
                  - np.sort(np.asarray(r.lam))).max() <= TOL_E2E
    assert np.asarray(p.res).max() <= 1e-8
    assert _degrees(out_p) == _degrees(out_r)


# ------------------------------------------------- (g) refusals


def _tridiag(n, off, sub=None):
    sub = off if sub is None else sub
    return sp.diags([np.ones(n), off * np.ones(n - 1), sub * np.ones(n - 1)],
                    [0, 1, -1], format="csr")


def _refusal_case(case):
    n = 50
    A = sp.diags([2.0 * np.ones(n), -np.ones(n - 1), -np.ones(n - 1)],
                 [0, 1, -1], format="csr")
    if case == "indefinite":
        return A, _tridiag(n, 2.0), None
    if case == "nonsymmetric":
        return A, sp.diags([np.ones(n), 0.3 * np.ones(n - 1)], [0, 1],
                           format="csr"), None
    Ah = (A + sp.diags([0.1j * np.ones(n - 1), -0.1j * np.ones(n - 1)],
                       [1, -1])).tocsr()
    return Ah, _tridiag(n, 0.2), True


@pytest.mark.parametrize("case,match", [("indefinite", "positive"),
                                        ("nonsymmetric", "cheb"),
                                        ("hermitian_A", "real symmetric A")])
def test_refusals_carry_the_reference_message(case, match):
    A, B, herm = _refusal_case(case)
    kw = dict(hermitian=herm, solver="cheb")
    with pytest.raises(ValueError, match=match) as e_r:
        ref_sparse.sparse_feast_interval(A, B, 0.0, 1.0, 8, ref_feastinit(),
                                         **kw)
    with pytest.raises(ValueError, match=match) as e_p:
        ft.sparse_feast_interval(A, B, 0.0, 1.0, 8, ft.feastinit(),
                                 device="cpu", **kw)
    assert str(e_p.value) == str(e_r.value)


@pytest.mark.parametrize("case", ["indefinite", "nonsymmetric"])
def test_auto_route_refusal_names_the_krylov_item(case):
    A, B, _ = _refusal_case(case)
    # a 2D-width band keeps the pencil off the narrow-band delegation
    A = sp.kron(sp.eye(2), A).tocsr() + sp.diags(
        [np.ones(50), np.ones(50)], [-50, 50], shape=(100, 100))
    B = sp.kron(sp.eye(2), B).tocsr()
    with pytest.raises(NotImplementedError, match="queue 1 item 10"):
        ft.sparse_feast_interval(A, B, 0.0, 1.0, 8, ft.feastinit(),
                                 device="cpu")


# ------------------------------------------------- (h) determinism


def test_deterministic_across_numpy_rng_state():
    # tests/test_cheb_generalized.py's check on a smaller tensor pencil
    # (nx = 10 instead of 24, same Lanczos-refined B bounds), the
    # first of the two solves after seeding the global RNG as it does
    K, M = _fem2d(10)
    w = sla.eigh(K.toarray(), M.toarray(), eigvals_only=True)
    gaps = np.nonzero(np.diff(w) > 1e-9 * w[-1])[0]
    hi = gaps[np.searchsorted(gaps, 5)]
    Emax = float(0.5 * (w[hi] + w[hi + 1]))
    fpm = ft.feastinit()
    fpm[3] = 9
    np.random.seed(12345)
    r1 = ft.feast_scsrgv(K, M, 0.0, Emax, 12, fpm, solver="cheb",
                         device="cpu")
    np.random.seed(999)
    r2 = ft.feast_scsrgv(K, M, 0.0, Emax, 12, fpm, solver="cheb",
                         device="cpu")
    assert r1.M == r2.M == hi + 1
    assert np.array_equal(np.asarray(r1.lam), np.asarray(r2.lam))
    assert np.array_equal(np.asarray(r1.res), np.asarray(r2.res))
