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
    n = torch.get_num_threads()
    torch.set_num_threads(1)
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


def _setup(fixture):
    dia, offs, N = FIXTURES[fixture]()
    rng = np.random.default_rng(1)
    Q = rng.standard_normal((N, M))
    sc32 = np.float32(2.0 / 8.2)
    sh32 = np.float32(8.0 / 8.2)
    coeffs32 = np.float32(rng.standard_normal(STEPS) * 0.1)
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
