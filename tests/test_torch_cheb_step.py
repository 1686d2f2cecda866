"""PyTorch port, fused Chebyshev step: plain versions against the JAX kernels.

The JAX package's Pallas step kernels run in interpret mode on the CPU
(``cheb_f32_chunk`` / ``cheb_ds_chunk``, ``interpret=True``) on the fixtures
of tests/test_cheb_pallas.py; the same carry, brought across by
``convert.carry_from_reference_packed``, goes through the port's chunk
drivers, which take the plain version on CPU tensors. Tolerances, relative
to the largest entry of each compared tensor:
  * f32 step vs the f32 kernel: 1e-5 (f32 rounding, different order);
  * f64 step vs the double-single kernel: 1e-11 (the DS kernel's own
    bound, ~2^-49 per operation over 14 steps);
  * f64 step vs the f64 oracle cheb_ds_step_reference: 1e-13.
The multi-step chunk functions (2 and 4 steps per pass, column-major (M, N)
carry) are held the same way against ``cheb_f32_2_chunk`` /
``cheb_f32_4_chunk`` / ``cheb_ds2_chunk`` / ``cheb_ds4_chunk`` on margin-2
and margin-4 plans, at the same three tolerances; their plain versions
equal S applications of the 1-step plain version bit for bit; and the
solver's init -> 4 -> 2 -> 1 schedule equals the all-1-step schedule.
The CUDA kernels themselves are checked against the same plain versions on
the card by chip_smoke.py.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from feastkit_tpu.ops import cheb_pallas as ref_cp  # noqa: E402
from feastkit_tpu.ops.pallas_kernels import dia_matvec_reference  # noqa: E402
from feastkit_tpu_torch import convert  # noqa: E402
from feastkit_tpu_torch.ops import cheb_kernels as port_ck  # noqa: E402

M = 11
STEPS = 14


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
    d = np.zeros((3, n))
    d[0, 1:] = -1.0
    d[1, :] = 2.0
    d[2, :-1] = -1.0
    return d, (-1, 0, 1), n


def _lap2d(nx):
    n = nx * nx
    d = np.zeros((5, n))
    d[2, :] = 4.0
    d[1, :] = -1.0
    d[1, ::nx] = 0.0
    d[3, :] = -1.0
    d[3, nx - 1::nx] = 0.0
    d[0, nx:] = -1.0
    d[4, :-nx] = -1.0
    return d, (-nx, -1, 0, 1, nx), n


def _off_eq_block():
    # |offset| == the reference's 128-aligned lane block
    N = 1024
    rng0 = np.random.default_rng(7)
    dia = np.zeros((5, N))
    dia[2] = 4.0 + rng0.random(N)
    for k, d in zip((0, 1, 3, 4), (-256, -1, 1, 256)):
        if d > 0:
            dia[k, :N - d] = -rng0.random(N - d)
        else:
            dia[k, -d:] = -rng0.random(N + d)
    return dia, (-256, -1, 0, 1, 256), N


FIXTURES = {"lap1d": lambda: _lap1d(300), "lap2d": lambda: _lap2d(18),
            "off_eq_block": _off_eq_block}


def _setup(fixture, nsteps=STEPS):
    dia, offs, N = FIXTURES[fixture]()
    rng = np.random.default_rng(1)
    Q = rng.standard_normal((N, M))
    sc32 = np.float32(2.0 / 8.2)
    sh32 = np.float32(8.0 / 8.2)
    coeffs32 = np.float32(rng.standard_normal(nsteps) * 0.1)
    T0 = jnp.asarray(Q)
    T1 = float(sc32) * dia_matvec_reference(jnp.asarray(dia), T0, offs) \
        - float(sh32) * T0
    acc = 0.5 * T0
    return dia, offs, N, (T0, T1, acc), sc32, sh32, coeffs32


def _unpack(planes, plan, N):
    return convert.carry_from_reference_packed(planes, plan, N, M,
                                               device="cpu")


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


@pytest.mark.parametrize("fixture", list(FIXTURES))
def test_f32_step_matches_pallas_f32_kernel(fixture):
    dia, offs, N, (T0, T1, acc), sc, sh, cs = _setup(fixture)
    plan = ref_cp.cheb_plan(offs, N, M)
    carry = tuple(ref_cp.pack_state32(x, plan) for x in (T0, T1, acc))
    out_ref = ref_cp.cheb_f32_chunk(ref_cp.pack_diags32(jnp.asarray(dia),
                                                        plan),
                                    carry, jnp.asarray(cs), sc, sh,
                                    plan=plan, interpret=True)
    dg, o = convert.dia_from_reference(dia, offs, dtype=torch.float32,
                                     device="cpu")
    before = port_ck.cheb_step_f32.launches
    out_port = port_ck.cheb_f32_chunk(
        dg, o, _unpack(carry, plan, N),
        cs, sc, sh)
    assert port_ck.cheb_step_f32.launches == before   # CPU: no kernel
    ref = _unpack(out_ref, plan, N)
    assert all(t.dtype == torch.float32 for t in out_port)
    for r, p in zip(ref, out_port):
        assert _rel(p, r) <= 1e-5


@pytest.mark.parametrize("fixture", list(FIXTURES))
def test_f64_step_matches_pallas_ds_kernel(fixture):
    dia, offs, N, (T0, T1, acc), sc, sh, cs = _setup(fixture)
    plan = ref_cp.cheb_plan(offs, N, M)
    dgh, dgl = ref_cp.pack_diags(jnp.asarray(dia), plan)
    carry = sum((ref_cp.pack_state(x, plan) for x in (T0, T1, acc)), ())
    out_ref = ref_cp.cheb_ds_chunk(dgh, dgl, carry, jnp.asarray(cs), sc, sh,
                                   plan=plan, interpret=True)
    d64, o = convert.dia_from_reference(dia, offs, device="cpu")
    before = port_ck.cheb_step_f64.launches
    # the DS kernel rounds its scalars to f32: feed the port the same values
    out_port = port_ck.cheb_f64_chunk(
        d64, o, _unpack(carry, plan, N),
        cs.astype(np.float64), float(sc), float(sh))
    assert port_ck.cheb_step_f64.launches == before
    ref = _unpack(out_ref, plan, N)
    assert all(t.dtype == torch.float64 for t in out_port)
    for r, p in zip(ref, out_port):
        assert _rel(p, r) <= 1e-11


@pytest.mark.parametrize("fixture", list(FIXTURES))
def test_f64_step_matches_f64_oracle(fixture):
    dia, offs, N, (T0, T1, acc), _, _, _ = _setup(fixture)
    rng = np.random.default_rng(2)
    cs = rng.standard_normal(STEPS) * 0.1
    sc, sh = 2.0 / 8.3, 7.9 / 8.3           # unrounded f64 scalars
    t0, t1, ac = T0, T1, acc
    dia_j = jnp.asarray(dia)
    for ck in cs:
        t2, ac = ref_cp.cheb_ds_step_reference((dia_j, offs), t0, t1, ac,
                                               sc, sh, ck)
        t0, t1 = t1, t2
    carry = tuple(torch.as_tensor(np.array(x)) for x in (T0, T1, acc))
    d64, o = convert.dia_from_reference(dia, offs, device="cpu")
    out = port_ck.cheb_f64_chunk(d64, o, carry, cs, sc, sh)
    for r, p in zip((t0, t1, ac), out):
        assert _rel(p, r) <= 1e-13


def test_step_rejects_aliased_and_mistyped_operands():
    dia, offs, N = _lap1d(50)
    d = torch.as_tensor(dia)
    t = [torch.zeros(N, 3, dtype=torch.float64) for _ in range(3)]
    with pytest.raises(ValueError, match="distinct"):
        port_ck.cheb_step_f64(d, offs, t[0], t[0], t[2], 1.0, 0.0, 1.0)
    with pytest.raises(TypeError, match="float32"):
        port_ck.cheb_step_f32(d, offs, *t, 1.0, 0.0, 1.0)
    with pytest.raises(ValueError, match="diags"):
        port_ck.cheb_step_f64(d[:2], offs, *t, 1.0, 0.0, 1.0)


# ------------------------------------------------------------ multi-step

MULTI = [(2, 2), (2, 14), (4, 4), (4, 12)]          # (steps per pass, nsteps)
REF_F32 = {2: ref_cp.cheb_f32_2_chunk, 4: ref_cp.cheb_f32_4_chunk}
REF_DS = {2: ref_cp.cheb_ds2_chunk, 4: ref_cp.cheb_ds4_chunk}
PORT_F32 = {2: port_ck.cheb_f32_2_chunk, 4: port_ck.cheb_f32_4_chunk}
PORT_F64 = {2: port_ck.cheb_f64_2_chunk, 4: port_ck.cheb_f64_4_chunk}
MULTI_WRAPPERS = {(2, torch.float32): "cheb_step2_f32",
                  (4, torch.float32): "cheb_step4_f32",
                  (2, torch.float64): "cheb_step2_f64",
                  (4, torch.float64): "cheb_step4_f64"}


def _columns(carry):
    planes = list(carry)
    port_ck.transpose_planes(planes)
    return planes


def _rows(carry):
    return [t.t() for t in carry]


@pytest.mark.parametrize("S,nsteps", MULTI)
@pytest.mark.parametrize("fixture", list(FIXTURES))
def test_f32_multistep_chunk_matches_pallas_kernel(fixture, S, nsteps):
    dia, offs, N, (T0, T1, acc), sc, sh, cs = _setup(fixture, nsteps)
    plan = ref_cp.cheb_plan(offs, N, M, margin=S)
    carry = tuple(ref_cp.pack_state32(x, plan) for x in (T0, T1, acc))
    out_ref = REF_F32[S](ref_cp.pack_diags32(jnp.asarray(dia), plan), carry,
                         jnp.asarray(cs), sc, sh, plan=plan, interpret=True)
    dg, o = convert.dia_from_reference(dia, offs, dtype=torch.float32,
                                       device="cpu")
    out_port = PORT_F32[S](dg, o, _columns(_unpack(carry, plan, N)), cs, sc,
                           sh)
    assert all(v == 0 for v in port_ck.launch_counts().values())
    assert all(t.dtype == torch.float32 and t.shape == (M, N)
               and t.is_contiguous() for t in out_port)
    for r, p in zip(_unpack(out_ref, plan, N), _rows(out_port)):
        assert _rel(p, r) <= 1e-5


@pytest.mark.parametrize("S,nsteps", MULTI)
@pytest.mark.parametrize("fixture", list(FIXTURES))
def test_f64_multistep_chunk_matches_pallas_ds_kernel(fixture, S, nsteps):
    dia, offs, N, (T0, T1, acc), sc, sh, cs = _setup(fixture, nsteps)
    plan = ref_cp.cheb_plan(offs, N, M, margin=S)
    dgh, dgl = ref_cp.pack_diags(jnp.asarray(dia), plan)
    carry = sum((ref_cp.pack_state(x, plan) for x in (T0, T1, acc)), ())
    out_ref = REF_DS[S](dgh, dgl, carry, jnp.asarray(cs), sc, sh, plan=plan,
                        interpret=True)
    d64, o = convert.dia_from_reference(dia, offs, device="cpu")
    # the DS kernel rounds its scalars to f32: feed the port the same values
    out_port = PORT_F64[S](d64, o, _columns(_unpack(carry, plan, N)),
                           cs.astype(np.float64), float(sc), float(sh))
    assert all(v == 0 for v in port_ck.launch_counts().values())
    assert all(t.dtype == torch.float64 for t in out_port)
    for r, p in zip(_unpack(out_ref, plan, N), _rows(out_port)):
        assert _rel(p, r) <= 1e-11


@pytest.mark.parametrize("S,nsteps", MULTI)
@pytest.mark.parametrize("fixture", list(FIXTURES))
def test_f64_multistep_chunk_matches_f64_oracle(fixture, S, nsteps):
    dia, offs, N, (T0, T1, acc), _, _, _ = _setup(fixture)
    cs = np.random.default_rng(2).standard_normal(nsteps) * 0.1
    sc, sh = 2.0 / 8.3, 7.9 / 8.3           # unrounded f64 scalars
    t0, t1, ac = T0, T1, acc
    dia_j = jnp.asarray(dia)
    for ck in cs:
        t2, ac = ref_cp.cheb_ds_step_reference((dia_j, offs), t0, t1, ac,
                                               sc, sh, ck)
        t0, t1 = t1, t2
    carry = _columns(torch.as_tensor(np.array(x)) for x in (T0, T1, acc))
    d64, o = convert.dia_from_reference(dia, offs, device="cpu")
    out = PORT_F64[S](d64, o, carry, cs, sc, sh)
    for r, p in zip((t0, t1, ac), _rows(out)):
        assert _rel(p, r) <= 1e-13


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("S", [2, 4])
def test_multistep_plain_is_repeated_one_step_plain(S, dtype):
    dia, offs, N = _lap2d(18)
    rng = np.random.default_rng(3)
    d = torch.as_tensor(dia, dtype=dtype)
    rows = [torch.as_tensor(rng.standard_normal((N, M)), dtype=dtype)
            for _ in range(3)]
    cols = _columns(rows)
    out0, out1 = torch.empty_like(cols[0]), torch.empty_like(cols[1])
    t0_in, t1_in = cols[0].clone(), cols[1].clone()
    cs = rng.standard_normal(S) * 0.1
    plain = port_ck.cheb_step2_plain if S == 2 else port_ck.cheb_step4_plain
    plain(d, offs, *cols, out0, out1, 0.3, 0.6, cs)
    for ck in cs:
        port_ck.cheb_step_plain(d, offs, *rows, 0.3, 0.6, float(ck))
        rows[0], rows[1] = rows[1], rows[0]
    # the inputs are left as they were; outputs and acc equal bit for bit
    assert torch.equal(cols[0], t0_in) and torch.equal(cols[1], t1_in)
    for got, want in zip((out0, out1, cols[2]), rows):
        assert torch.equal(got.t(), want)


def _filter_context(monkeypatch, fuse2=None, fuse4=None):
    from feastkit_tpu_torch.solvers import sparse as port_sparse
    for name, val in (("FEAST_CHEB_FUSE2", fuse2), ("FEAST_CHEB_FUSE4", fuse4)):
        if val is None:
            monkeypatch.delenv(name, raising=False)
        else:
            monkeypatch.setenv(name, val)
    return port_sparse


@pytest.mark.parametrize("rem", [0, 1, 2, 3])
def test_schedule_4_2_1_equals_all_one_step(rem, monkeypatch):
    # r = len(coeffs) - 2 steps after the init; r mod 4 = rem
    dia, offs, N = _lap2d(18)
    rng = np.random.default_rng(4)
    coeffs = rng.standard_normal(2 + 8 + rem) * 0.1
    Q = torch.as_tensor(rng.standard_normal((N, M)))
    d = torch.as_tensor(dia)
    calls = {}
    for name in port_ck.launch_counts():
        orig = getattr(port_ck, name)

        def spy(*a, _orig=orig, _name=name):
            calls[_name] = calls.get(_name, 0) + 1
            return _orig(*a)
        monkeypatch.setattr(port_ck, name, spy)
    port_sparse = _filter_context(monkeypatch)
    ctx = port_sparse._cheb_fused_context(d, offs, coeffs, -0.1, 8.1, M)
    assert ctx["f64"]["steps"] == ctx["f32"]["steps"] == 4
    fused = port_sparse._sparse_cheb_filter_host_fused(ctx, Q, rung="f64")
    r = len(coeffs) - 2
    assert calls == {k: v for k, v in (
        ("cheb_step_f64", 1 + r % 2), ("cheb_step4_f64", r // 4),
        ("cheb_step2_f64", (r % 4) // 2)) if v}
    port_sparse = _filter_context(monkeypatch, fuse2="0")
    ctx1 = port_sparse._cheb_fused_context(d, offs, coeffs, -0.1, 8.1, M)
    assert ctx1["f64"]["steps"] == ctx1["f32"]["steps"] == 1
    calls.clear()
    single = port_sparse._sparse_cheb_filter_host_fused(ctx1, Q, rung="f64")
    assert calls == {"cheb_step_f64": 1 + r}
    assert fused.shape == single.shape == (N, M) and fused.is_contiguous()
    assert _rel(fused, single) <= 1e-13


@pytest.mark.parametrize("fuse2,fuse4,steps", [
    (None, None, 4), (None, "0", 2), ("0", None, 1), ("", "1", 1),
    ("1", "", 2)])
def test_switches_select_steps_per_pass(fuse2, fuse4, steps, monkeypatch):
    dia, offs, N = _lap2d(18)
    port_sparse = _filter_context(monkeypatch, fuse2, fuse4)
    ctx = port_sparse._cheb_fused_context(torch.as_tensor(dia), offs,
                                          np.ones(5), -0.1, 8.1, M)
    assert ctx["f32"]["steps"] == ctx["f64"]["steps"] == steps


LAP2D_1M = (-1024, -1, 0, 1, 1024)
LAP2D_4M = (-2048, -1, 0, 1, 2048)
LAP3D_2M = (-128 * 128, -128, -1, 0, 1, 128, 128 * 128)


@pytest.mark.parametrize("offs,N,dtype,steps,fits", [
    # the main path's shapes: both rungs take four steps per pass
    (LAP2D_1M, 1024 ** 2, torch.float32, 4, True),
    (LAP2D_1M, 1024 ** 2, torch.float64, 4, True),
    (LAP2D_1M, 1024 ** 2, torch.float64, 2, True),
    # a 2048 x 2048 grid: four steps in both types (fp64 one column per
    # block), two too
    (LAP2D_4M, 2048 ** 2, torch.float32, 4, True),
    (LAP2D_4M, 2048 ** 2, torch.float64, 4, True),
    (LAP2D_4M, 2048 ** 2, torch.float64, 2, True),
    # a 128^3 Laplacian's +-nx^2 halo fits neither: the 1-step kernels
    (LAP3D_2M, 128 ** 3, torch.float32, 4, False),
    (LAP3D_2M, 128 ** 3, torch.float32, 2, False),
    (LAP3D_2M, 128 ** 3, torch.float64, 2, False)])
def test_multistep_plan_gate(offs, N, dtype, steps, fits):
    plan = port_ck.multistep_plan(offs, N, 72, dtype, steps)
    assert (plan is not None) == fits
    if fits:
        halo = max(abs(d) for d in offs)
        assert plan["halo"] == halo and plan["tile"] % 32 == 0
        assert plan["tile"] * plan["tiles"] >= N
        assert plan["tile"] * (plan["tiles"] - 1) < N
        assert plan["tile"] >= 2 * (steps - 1) * halo
        assert plan["shared_bytes"] <= port_ck.SHARED_BYTES_PER_BLOCK


@pytest.mark.parametrize("fault,exc,match", [
    ("aliased_out", ValueError, "distinct"),
    ("aliased_in", ValueError, "distinct"),
    ("mistyped", TypeError, "float32"),
    ("noncontiguous", ValueError, "contiguous"),
    ("row_major", ValueError, "diags"),
    ("shape", ValueError, "one shape"),
    ("coefficients", ValueError, "coefficients")])
@pytest.mark.parametrize("S", [2, 4])
def test_multistep_rejects_bad_operands(S, fault, exc, match):
    dia, offs, N = _lap1d(50)
    d = torch.as_tensor(dia)
    t = [torch.zeros(3, N, dtype=torch.float64) for _ in range(5)]
    cs = [0.1] * S
    step = getattr(port_ck, MULTI_WRAPPERS[(S, torch.float64)])
    if fault == "aliased_out":
        t[3] = t[0]
    elif fault == "aliased_in":
        t[1] = t[2]
    elif fault == "mistyped":
        step = getattr(port_ck, MULTI_WRAPPERS[(S, torch.float32)])
    elif fault == "noncontiguous":
        t[1] = torch.zeros(N, 3, dtype=torch.float64).t()
    elif fault == "row_major":
        t = [torch.zeros(N, 3, dtype=torch.float64) for _ in range(5)]
    elif fault == "shape":
        t[4] = torch.zeros(4, N, dtype=torch.float64)
    elif fault == "coefficients":
        cs = [0.1] * 3
    with pytest.raises(exc, match=match):
        step(d, offs, *t, 1.0, 0.0, cs)


@pytest.mark.parametrize("S", [2, 4])
def test_multistep_chunk_rejects_ragged_chunk(S):
    dia, offs, N = _lap1d(50)
    carry = [torch.zeros(3, N, dtype=torch.float64) for _ in range(3)]
    with pytest.raises(ValueError, match="multiple"):
        PORT_F64[S](torch.as_tensor(dia), offs, carry, np.ones(S + 1), 1.0,
                    0.0)
