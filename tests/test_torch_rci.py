"""PyTorch port: the reverse-communication step machines against the JAX
package.

Mirrors tests/test_rci.py: the first transitions (standard: FACTORIZE,
SOLVE; generalized: MULT_B first), the Hermitian FACTORIZE_TRANSPOSE /
SOLVE_TRANSPOSE sequence, full drives of FeastSRCI, FeastHRCI and
FeastGRCI on standard and generalized problems (and the transpose pairing
of a complex-symmetric one), the fpm[5] = 1 warm start, FeastPRCI's
PARALLEL_SOLVE protocol and FeastPolyRCI on a quadratic eigenproblem.
The JAX package's machines are host numpy, so both run here in this
process, side by side on the same seeded matrices, each serviced by its
own caller: numpy / scipy LU for the JAX package's, torch LU on tensors
for the port's. At every step both emit the same job, with equal
fpm[50..53] and loop counts; at the end M and info are equal and the
eigenvalues agree within 1e-10 (1e-8 general; 1e-8 for the Beyn scheme,
whose eigenvalues hold to LAPACK's only to its quadrature, 1e-5). The
seeded starts are bit-identical.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import scipy.linalg as sla  # noqa: E402

import feastkit_tpu as ref_ft  # noqa: E402
import feastkit_tpu_torch as ft  # noqa: E402
from feastkit_tpu.core.types import FeastRCIJob as RefJob  # noqa: E402
from feastkit_tpu.kernel import rci as ref_rci  # noqa: E402
from feastkit_tpu_torch.core.types import FeastRCIJob as Job  # noqa: E402
from feastkit_tpu_torch.kernel import rci as port_rci  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the suite runs files in parallel worker processes on a few cores;
    # torch's default intra-op pool and numpy's / scipy's OpenBLAS pools
    # would starve their neighbours
    from threadpoolctl import threadpool_limits
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(limits=1, user_api="blas"):
        yield
    torch.set_num_threads(n)


def _lap(n):
    return (np.diag(2.0 * np.ones(n)) + np.diag(-np.ones(n - 1), 1)
            + np.diag(-np.ones(n - 1), -1))


def _lap_eigs(n):
    return 2.0 - 2.0 * np.cos(np.arange(1, n + 1) * np.pi / (n + 1))


def _ref_service(state, job, A, B, factors):
    """The JAX package's caller: numpy / scipy LU (tests/test_rci.py)."""
    n = A.shape[0]
    if job == RefJob.FACTORIZE:
        M = state.Ze * (np.eye(n) if B is None else B) - A
        factors[state.Ze] = sla.lu_factor(M)
    elif job == RefJob.FACTORIZE_TRANSPOSE:
        assert state.Ze in factors
    elif job == RefJob.SOLVE:
        state.workc = sla.lu_solve(factors[state.Ze], state.workc)
    elif job == RefJob.SOLVE_TRANSPOSE:
        state.workc = sla.lu_solve(factors[state.Ze], state.workc, trans=2)
    elif job == RefJob.MULT_A:
        state.workc = A @ np.asarray(state.workc)
    elif job == RefJob.MULT_B:
        state.workc = (np.eye(n) if B is None else B) @ np.asarray(
            state.workc)
    elif job == RefJob.PARALLEL_SOLVE:
        state.Xall = np.stack([sla.lu_solve(sla.lu_factor(
            z * (np.eye(n) if B is None else B) - A), state.workc)
            for z in state.Zall])


def _port_service(state, job, A, B, factors):
    """The port's caller: torch LU on CPU tensors; a SOLVE for a shift
    that no FACTORIZE announced fails."""
    n = A.shape[0]
    At = torch.as_tensor(A, dtype=torch.complex128)
    Bt = torch.eye(n, dtype=torch.complex128) if B is None else \
        torch.as_tensor(B, dtype=torch.complex128)
    if job == Job.FACTORIZE:
        factors[state.Ze] = torch.linalg.lu_factor(state.Ze * Bt - At)
    elif job == Job.FACTORIZE_TRANSPOSE:
        assert state.Ze in factors
    elif job in (Job.SOLVE, Job.SOLVE_TRANSPOSE):
        assert isinstance(state.workc, torch.Tensor)
        LU, piv = factors[state.Ze]
        state.workc = torch.linalg.lu_solve(
            LU, piv, state.workc, adjoint=job == Job.SOLVE_TRANSPOSE)
    elif job == Job.MULT_A:
        state.workc = At @ state.workc.to(torch.complex128)
    elif job == Job.MULT_B:
        state.workc = Bt @ state.workc.to(torch.complex128)
    elif job == Job.PARALLEL_SOLVE:
        state.Xall = torch.stack([torch.linalg.solve(
            complex(z) * Bt - At, state.workc) for z in state.Zall])


def _lockstep(ref, port, A, B=None, limit=20000):
    """Step both machines together, each serviced by its own caller; the
    same job, fpm[50..53] and loop at every step. Returns the jobs."""
    fr, fp = {}, {}
    jobs = []
    while len(jobs) < limit:
        jr, jp = ref.step(), port.step()
        assert int(jp) == int(jr), (len(jobs), jr, jp)
        assert [port.fpm[k] for k in range(50, 54)] == \
            [ref.fpm[k] for k in range(50, 54)], len(jobs)
        assert port.loop == ref.loop
        jobs.append(int(jp))
        if jr == RefJob.DONE:
            return jobs
        _ref_service(ref, jr, A, B, fr)
        _port_service(port, jp, A, B, fp)
    raise AssertionError("no DONE")


def _rng_hermitian(rng, n):
    H = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    return (H + H.conj().T) / 2


def case(name):
    """(the JAX package's machine, the port's, A, B, expected eigenvalues,
    bar): the JAX package's machine and the port's on one problem."""
    rng = np.random.default_rng(42)
    kw = dict(device="cpu")
    if name == "s_standard":
        n = 80
        A, w = _lap(n), _lap_eigs(n)
        exp = np.sort(w[(w >= 0.5) & (w <= 1.5)])
        args = (n, len(exp) + 5, 0.5, 1.5)
        return (ref_rci.FeastSRCI(*args, standard_B=True),
                port_rci.FeastSRCI(*args, standard_B=True, **kw), A, None,
                exp, 1e-10)
    if name == "s_generalized":
        n = 50
        A = rng.standard_normal((n, n))
        A = (A + A.T) / 2
        B = rng.standard_normal((n, n))
        B = B @ B.T + n * np.eye(n)
        w = sla.eigh(A, B, eigvals_only=True)
        Emin, Emax = w[15] - 1e-9, w[25] + 1e-9
        exp = np.sort(w[(w >= Emin) & (w <= Emax)])
        args = (n, len(exp) + 5, Emin, Emax)
        return (ref_rci.FeastSRCI(*args), port_rci.FeastSRCI(*args, **kw),
                A, B, exp, 1e-10)
    if name in ("h_standard", "h_generalized"):
        n = 50
        H = _rng_hermitian(rng, n)
        B = None
        if name == "h_generalized":
            C = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
            B = C @ C.conj().T / n + np.eye(n)
        w = sla.eigh(H, B, eigvals_only=True)
        Emin, Emax = w[20] - 1e-9, w[30] + 1e-9
        exp = np.sort(w[(w >= Emin) & (w <= Emax)])
        args = (n, len(exp) + 5, Emin, Emax)
        std = dict(standard_B=B is None)
        return (ref_rci.FeastHRCI(*args, **std),
                port_rci.FeastHRCI(*args, **std, **kw), H, B, exp, 1e-10)
    if name in ("g_standard", "g_generalized", "g_bilinear"):
        n = 40
        A = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
        B = None
        if name == "g_bilinear":
            A = (A + A.T) / 2
        if name == "g_generalized":
            B = np.eye(n) + 0.1 * (rng.standard_normal((n, n))
                                   + 1j * rng.standard_normal((n, n)))
        w = sla.eig(A, B, right=False)
        Emid, r = w[0], 1.0
        exp = w[np.asarray(ft.feast_inside_gcontour(w, Emid, r))]
        args = (n, min(len(exp) + 5, n), Emid, r)
        kwg = dict(standard_B=B is None, bilinear=name == "g_bilinear")
        return (ref_rci.FeastGRCI(*args, **kwg),
                port_rci.FeastGRCI(*args, **kwg, **kw), A, B, exp, 1e-8)
    if name == "warm_start":
        n = 80
        A = _lap(n)
        w, V = np.linalg.eigh(A)
        mask = (w >= 0.5) & (w <= 1.5)
        Q0 = np.concatenate([V[:, mask], V[:, :4]], axis=1)
        args = (n, int(mask.sum()) + 4, 0.5, 1.5)
        fr, fp = ref_ft.feastinit(), ft.feastinit()
        fr[5] = fp[5] = 1
        return (ref_rci.FeastSRCI(*args, fr, Q0=Q0, standard_B=True),
                port_rci.FeastSRCI(*args, fp, Q0=torch.as_tensor(Q0),
                                   standard_B=True, **kw), A, None,
                np.sort(w[mask]), 1e-10)
    if name in ("p_standard", "p_generalized"):
        n = 80
        A, w = _lap(n), _lap_eigs(n)
        B = None
        if name == "p_generalized":
            B = np.diag(rng.uniform(1.0, 2.0, n))
            w = sla.eigh(A, B, eigvals_only=True)
        exp = np.sort(w[(w >= 0.5) & (w <= 1.5)])
        args = (n, len(exp) + 5, 0.5, 1.5)
        std = dict(standard_B=B is None)
        return (ref_rci.FeastPRCI(*args, **std),
                port_rci.FeastPRCI(*args, **std, **kw), A, B, exp, 1e-10)
    raise KeyError(name)


CASES = ("s_standard", "s_generalized", "h_standard", "h_generalized",
         "g_standard", "g_generalized", "g_bilinear", "warm_start",
         "p_standard", "p_generalized")


def _match_err(got, exp):
    from scipy.optimize import linear_sum_assignment
    got, exp = np.asarray(got), np.asarray(exp)
    assert len(got) == len(exp)
    if not len(got):
        return 0.0
    D = np.abs(got[:, None] - exp[None, :])
    ri, ci = linear_sum_assignment(D)
    return D[ri, ci].max()


@pytest.mark.parametrize("name", CASES)
def test_drive_matches_reference(name):
    ref, port, A, B, exp, bar = case(name)
    jobs = _lockstep(ref, port, A, B)
    assert port.M == ref.M == len(exp) and int(port.info) == int(ref.info) \
        == 0
    assert port.fpm[51] == port.loop
    if name == "warm_start":
        assert port.loop <= 2
    if name.startswith("p_"):
        assert int(Job.PARALLEL_SOLVE) in jobs and int(Job.SOLVE) not in jobs
    if name.startswith("h_"):
        assert int(Job.SOLVE_TRANSPOSE) in jobs
    lam_p = port.lam[port.inside]
    lam_r = ref.lam[ref.inside]
    assert _match_err(lam_p, lam_r) <= bar
    assert _match_err(lam_p, exp) <= bar
    assert float(np.max(port.res[port.inside])) <= port.tol
    inside = torch.as_tensor(port.inside)
    q = port.q[:, inside]
    assert isinstance(port.q, torch.Tensor) and q.shape == (A.shape[0],
                                                            port.M)
    # the accepted Ritz pairs are eigenpairs: A q = lam B q
    Bq = q if B is None else torch.as_tensor(B).to(q.dtype) @ q
    R = torch.as_tensor(A).to(q.dtype) @ q - torch.as_tensor(
        lam_p).to(q.dtype)[None, :] * Bq
    assert float(torch.linalg.vector_norm(R, dim=0).max()) <= 1e-8


def test_first_transitions():
    """Standard problems emit FACTORIZE, then SOLVE; generalized ones
    MULT_B first; the Hermitian machine announces FACTORIZE_TRANSPOSE
    before each adjoint solve."""
    for machine in ("FeastSRCI", "FeastHRCI"):
        ref = getattr(ref_rci, machine)(20, 6, 0.5, 1.5, standard_B=True)
        port = getattr(port_rci, machine)(20, 6, 0.5, 1.5, standard_B=True,
                                          device="cpu")
        assert port.step() == ref.step() == Job.FACTORIZE
        assert port.Ze == ref.Ze == complex(port.contour.Zne[0])
        assert port.step() == ref.step() == Job.SOLVE
        ref = getattr(ref_rci, machine)(20, 6, 0.5, 1.5)
        port = getattr(port_rci, machine)(20, 6, 0.5, 1.5, device="cpu")
        assert port.step() == ref.step() == Job.MULT_B
        ref.workc = np.asarray(ref.workc)      # identity B
        assert port.step() == ref.step() == Job.FACTORIZE
        assert port.step() == ref.step() == Job.SOLVE
    ref = ref_rci.FeastHRCI(16, 4, -1.0, 1.0, standard_B=True)
    port = port_rci.FeastHRCI(16, 4, -1.0, 1.0, standard_B=True,
                              device="cpu")
    seq = []
    for _ in range(4):
        jr, jp = ref.step(), port.step()
        assert jr == jp
        seq.append(jp)
    assert seq == [Job.FACTORIZE, Job.SOLVE, Job.FACTORIZE_TRANSPOSE,
                   Job.SOLVE_TRANSPOSE]


@pytest.mark.parametrize("N,M0", [(20, 6), (80, 15), (7, 7)])
def test_seeded_starts_bit_identical(N, M0):
    assert np.array_equal(port_rci._seeded_real(N, M0),
                          ref_rci._seeded_real(N, M0))
    assert np.array_equal(port_rci._seeded_complex(N, M0),
                          ref_rci._seeded_complex(N, M0))
    for machine in ("FeastSRCI", "FeastHRCI"):
        ref = getattr(ref_rci, machine)(N, M0, 0.0, 1.0)
        port = getattr(port_rci, machine)(N, M0, 0.0, 1.0, device="cpu")
        assert np.array_equal(port.Q.numpy(), ref.Q)
    ref = ref_rci.FeastGRCI(N, M0, 0.0, 1.0)
    port = port_rci.FeastGRCI(N, M0, 0.0, 1.0, device="cpu")
    assert np.array_equal(port.Q.numpy(), ref.Q)
    ref = ref_rci.FeastPolyRCI(N, 2, M0, 0.0, 1.0)
    port = port_rci.FeastPolyRCI(N, 2, M0, 0.0, 1.0, device="cpu")
    assert np.array_equal(port.V.numpy(), ref.V)


def test_prci_refuses_an_unserviced_solve():
    port = port_rci.FeastPRCI(20, 6, 0.5, 1.5, standard_B=True,
                              device="cpu")
    assert port.step() == Job.PARALLEL_SOLVE
    with pytest.raises(ValueError, match="not serviced"):
        port.step()
    port.Xall = torch.zeros(3, 20, 6, dtype=torch.complex128)
    with pytest.raises(ValueError, match="state.Xall must be"):
        port.step()


def test_poly_rci_matches_reference():
    """FeastPolyRCI on the quadratic of tests/test_rci.py (n = 12),
    against the JAX package's machine in lockstep and the companion
    spectrum."""
    rng = np.random.default_rng(42)
    n = 12
    K = np.diag(rng.uniform(0.5, 2.0, n))
    C = 0.1 * np.eye(n)
    Mm = np.eye(n)
    Acomp = np.block([[np.zeros((n, n)), np.eye(n)], [-K, -C]])
    w = np.linalg.eigvals(Acomp)
    exp = w[np.asarray(ft.feast_inside_gcontour(w, 0.0 + 1.0j, 0.22))]
    assert 0 < len(exp) < n
    M0 = min(len(exp) + 4, n)

    def P(z):
        return K + z * C + z * z * Mm

    ref = ref_rci.FeastPolyRCI(n, 2, M0, 0.0 + 1.0j, 0.22)
    port = port_rci.FeastPolyRCI(n, 2, M0, 0.0 + 1.0j, 0.22, device="cpu")
    fr = fp = None
    for _ in range(10000):
        jr, jp = ref.step(), port.step()
        assert int(jr) == int(jp)
        assert [port.fpm[k] for k in range(50, 54)] == \
            [ref.fpm[k] for k in range(50, 54)]
        if jr == RefJob.DONE:
            break
        if jr == RefJob.FACTORIZE:
            fr = sla.lu_factor(P(ref.Ze))
            fp = torch.linalg.lu_factor(torch.as_tensor(P(port.Ze)))
        elif jr == RefJob.SOLVE:
            ref.workc = sla.lu_solve(fr, ref.workc)
            port.workc = torch.linalg.lu_solve(*fp, port.workc)
        elif jr == RefJob.MULT_A:
            ref.workc = np.stack([P(lam) @ ref.q[:, j]
                                  for j, lam in enumerate(ref.lam)], axis=1)
            port.workc = torch.stack(
                [torch.as_tensor(P(lam)) @ port.q[:, j]
                 for j, lam in enumerate(port.lam)], dim=1)
    assert jr == RefJob.DONE
    assert port.M == ref.M == len(exp) and port.loop == ref.loop
    assert int(port.info) == int(ref.info)
    got = port.lam[port.inside]
    assert _match_err(got, ref.lam[ref.inside]) <= 1e-8
    assert _match_err(got, exp) <= 1e-5


def test_exports_the_matrix_free_and_rci_names():
    """The names of the matrix-free drivers and the step machines, as the
    JAX package exports them."""
    names = ("LinearOperator MatrixVecFunction create_iterative_solver "
             "feast_matvec feast_matvec_general FeastSRCI FeastHRCI "
             "FeastGRCI FeastPRCI FeastPolyRCI FeastRCIJob").split()
    for name in names:
        assert name in ft.__all__ and getattr(ft, name) is not None, name
        assert hasattr(ref_ft, name), name
    assert {j.name: int(j) for j in ft.FeastRCIJob} == \
        {j.name: int(j) for j in ref_ft.FeastRCIJob}
    assert ft.FeastRCIJob.PARALLEL_SOLVE is ft.FeastRCIJob.SOLVE_REDUCED
