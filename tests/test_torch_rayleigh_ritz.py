"""PyTorch port, Rayleigh-Ritz update and spurious verification.

The same state and filtered subspace (seeded numpy) go through the JAX
package's ``make_rayleigh_ritz_update`` / ``verify_spurious_from`` and the
port's counterparts (state carried across by ``convert``). The operator is
a 2D Laplacian on a 20 x 23 grid, whose low eigenvalues are simple, so the
Ritz pairs are well defined one by one. Tolerances: Ritz values 1e-12
absolute (they are O(0.1)); residuals 1e-10 relative to each residual;
inside and verify masks equal.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import scipy.sparse as sp  # noqa: E402

from feastkit_tpu.kernel import hermitian as ref_h  # noqa: E402
from feastkit_tpu.ops.pallas_kernels import dia_matvec_reference  # noqa: E402
from feastkit_tpu_torch import convert  # noqa: E402
from feastkit_tpu_torch.core.tools import seeded_subspace  # noqa: E402
from feastkit_tpu_torch.kernel import hermitian as port_h  # noqa: E402
from feastkit_tpu_torch.ops.chebfilter import (  # noqa: E402
    build_cheb_filter_coeffs, gershgorin_interval, make_cheb_filter)
from feastkit_tpu_torch.ops.dia import bcoo_to_dia, dia_matvec  # noqa: E402

NX, NY, M0 = 20, 23, 24
EMIN, EMAX = 0.0, 0.45


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # The suite runs files in parallel worker processes on a few cores;
    # torch's default intra-op pool (one spinning thread per core) then
    # starves its neighbours. The port's CPU tensors here are small.
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _operator():
    Dx = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(NX, NX))
    Dy = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(NY, NY))
    c = (sp.kron(Dx, sp.eye(NY)) + sp.kron(sp.eye(NX), Dy)).tocoo()
    idx = np.stack([c.row, c.col], axis=1)
    N = NX * NY
    lo, hi = gershgorin_interval(c.data, idx, N)
    dia, offs = bcoo_to_dia(c.data, idx, N)
    return dia, offs, lo, hi


@pytest.fixture(scope="module")
def setup():
    dia, offs, lo, hi = _operator()
    N = dia.shape[1]
    # a low-degree indicator: a realistic first-loop filtered subspace
    coeffs, _ = build_cheb_filter_coeffs(lo, hi, EMIN, EMAX, degree=40)
    d_t, o_t = convert.dia_from_reference(dia, offs, device="cpu")
    filt = make_cheb_filter(lambda X: dia_matvec(d_t, o_t, X), lo, hi,
                            coeffs)
    Q = seeded_subspace(N, M0, np.float64)
    Qproj = filt(torch.as_tensor(Q)).numpy()
    ref_A = lambda X: dia_matvec_reference(jnp.asarray(dia), X, offs)  # noqa: E731
    ref_update = ref_h.make_rayleigh_ritz_update(
        ref_A, lambda X: X, jnp.float64(EMIN), jnp.float64(EMAX), tol=1e-8)
    port_update = port_h.make_rayleigh_ritz_update(
        lambda X: dia_matvec(d_t, o_t, X), lambda X: X, EMIN, EMAX,
        tol=1e-8)
    state0 = ref_h.init_hermitian_state(jnp.asarray(Q))
    st_ref = ref_update(state0, jnp.asarray(Qproj), jnp.bool_(True))
    st_port = port_update(
        convert.state_from_reference(state0, device="cpu"),
        torch.as_tensor(Qproj))
    return dict(filt=filt, st_ref=st_ref, st_port=st_port,
                ref_update=ref_update, port_update=port_update)


def test_rayleigh_ritz_matches_reference(setup):
    r, p = setup["st_ref"], setup["st_port"]
    lam_r, lam_p = np.asarray(r.lam), p.lam.numpy()
    assert np.abs(lam_r - lam_p).max() <= 1e-12
    res_r, res_p = np.asarray(r.res), p.res.numpy()
    assert np.all(np.abs(res_r - res_p) <= 1e-10 * res_r)
    assert np.array_equal(np.asarray(r.inside), p.inside.numpy())
    assert 0 < int(p.inside.sum()) < M0        # a mixed, meaningful state
    assert bool(r.converged) == bool(p.converged)
    assert float(r.epsout) == pytest.approx(float(p.epsout), rel=1e-10)
    assert p.loop == int(r.loop) == 1


def test_second_loop_matches_reference(setup):
    # one more loop from the reference's own state: the update is a pure
    # function of (state, Qproj), so the port must follow it
    r1 = setup["st_ref"]
    Qproj = setup["filt"](torch.as_tensor(np.array(r1.Q))).numpy()
    r2 = setup["ref_update"](r1, jnp.asarray(Qproj), jnp.bool_(True))
    p2 = setup["port_update"](
        convert.state_from_reference(r1, device="cpu"),
        torch.as_tensor(Qproj))
    assert np.abs(np.asarray(r2.lam) - p2.lam.numpy()).max() <= 1e-12
    assert np.all(np.abs(np.asarray(r2.res) - p2.res.numpy())
                  <= 1e-10 * np.asarray(r2.res))
    assert np.array_equal(np.asarray(r2.inside), p2.inside.numpy())


def test_verify_masks_match_reference(setup):
    r1 = setup["st_ref"]
    Qproj = setup["filt"](torch.as_tensor(np.array(r1.Q))).numpy()
    vr = ref_h.verify_spurious_from(r1, jnp.asarray(Qproj), jnp.bool_(True))
    vp = port_h.verify_spurious_from(
        convert.state_from_reference(r1, device="cpu"),
        torch.as_tensor(Qproj))
    assert np.array_equal(np.asarray(vr.inside), vp.inside.numpy())
    assert np.array_equal(np.asarray(vr.lam), vp.lam.numpy())
    assert np.array_equal(np.asarray(vr.Q), vp.Q.numpy())
    assert float(vr.epsout) == float(vp.epsout)
