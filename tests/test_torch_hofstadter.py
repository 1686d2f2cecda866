"""The Harper-Hofstadter cylinder of the benchmark's ``herm_p9`` cell on
the CPU: the operator the generator builds, the plain reference that
judges it, and the port's complex Hermitian polynomial path on it.

``portbench/generators/hofstadter_cyl.py`` builds H as complex scipy CSR
and takes the interval from the spectra of its Ly Harper chains;
``portbench/reference/hofstadter_cyl.py`` works the spectrum out again by
Sturm bisection and the residuals by array shifts, in plain torch. Here,
on 24 x 24 to 32 x 32 cylinders at phi = 1/64:
  * the chains' spectra are dense ``eigvalsh`` of the assembled H to
    1e-12, so the decoupling holds for the operator the port is handed;
  * the reference's residuals are ||H x - lam x|| of the CSR matrix;
  * ``feast`` through the auto route (the f32 -> f64 ladder forced, as on
    the card) returns the exact count, eigenvalues within 1e-9 and
    residuals under 1e-8 on three seeds;
  * a planted fault in the operator (the phases' sign flipped, one bond
    across the ring's seam dropped) fails the judgement, and a truncation
    that could miss an eigenvalue raises.
"""
import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import scipy.sparse as sp  # noqa: E402

import feastkit_tpu_torch as ft  # noqa: E402
from portbench import checks  # noqa: E402
from portbench.generators import hofstadter_cyl as gen  # noqa: E402
from portbench.reference import hofstadter_cyl as ref  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FLUX = 1.0 / 64


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the suite runs files in parallel worker processes on a few cores
    from threadpoolctl import threadpool_limits
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(limits=1, user_api="blas"):
        yield
    torch.set_num_threads(n)


def _cfg(L=32, pairs_past=10, lowest=4):
    """The cell's configuration cut to an L x L cylinder at phi = 1/64
    (magnetic length 3.2 sites), its potential scaled with the flux."""
    cfg = json.loads((ROOT / "portbench" / "configs"
                      / "herm_p9.json").read_text())
    cfg.update(grid=[L, L], flux=FLUX, pairs_past=pairs_past,
               lowest_1d=lowest, M0=16)
    return cfg


def _inputs(L, seed):
    v = np.random.default_rng(seed).uniform(0.0, 0.02, L)
    return dict(v=v, flux=FLUX, ny=L)


def _faulty(A, fault, ny):
    """A with the phases' sign flipped, or one bond across the seam (the
    pair (x = 0, y = ny - 1) <-> (0, 0)) dropped; both stay Hermitian."""
    A = A.tolil(copy=True)
    if fault == "phase_sign":
        return sp.csr_matrix(A.real - 1j * A.imag)
    A[ny - 1, 0] = 0.0
    A[0, ny - 1] = 0.0
    A = sp.csr_matrix(A)
    A.eliminate_zeros()
    return A


@pytest.mark.parametrize("L,seed", [(24, 0), (32, 1), (27, 2)])
def test_chains_are_the_operator_spectrum(L, seed):
    inputs = _inputs(L, seed)
    A = gen.operator(inputs["v"], FLUX, L)
    assert A.dtype == np.complex128 and A.nnz == L * L * 5 - 2 * L
    H = A.toarray()
    assert np.array_equal(H, H.conj().T)
    offsets = np.unique(np.subtract(*np.nonzero(H)[::-1]))
    assert offsets.tolist() == [-L, -(L - 1), -1, 0, 1, L - 1, L]
    dense = np.linalg.eigvalsh(H)
    chains = ref.chain_eigenvalues(inputs, L).numpy()
    assert chains.shape == (L, L)
    assert np.all(np.diff(chains, axis=1) > 0)
    assert np.abs(np.sort(chains.ravel()) - dense).max() <= 1e-12
    assert np.abs(gen.lowest_chains(inputs["v"], FLUX, L, 4)
                  - chains[:, :4]).max() <= 1e-12


@pytest.mark.parametrize("L", [24, 32])
def test_residuals_are_the_csr_residuals(L):
    inputs = _inputs(L, L)
    A = gen.operator(inputs["v"], FLUX, L)
    rng = np.random.default_rng(L)
    Q = rng.standard_normal((L * L, 11)) + 1j * rng.standard_normal((L * L,
                                                                     11))
    lam = rng.uniform(-3.0, 9.0, 11)
    want = (np.linalg.norm(A @ Q - Q * lam, axis=0)
            / (np.maximum(np.abs(lam), 1.0) * np.linalg.norm(Q, axis=0)))
    got = ref.residuals(inputs, lam, Q, block=4)
    assert isinstance(got, np.ndarray) and got.shape == (11,)
    assert np.allclose(got, want, rtol=1e-12, atol=0)


def _solve(problem, A=None):
    fpm = ft.feastinit()
    fpm[3] = 8
    fpm[42] = 2                      # the ladder, as on the card
    return ft.feast(problem["A"] if A is None else A, None,
                    problem["interval"], problem["M0"], fpm, device="cpu")


def _judge(cfg, problem, r):
    record = dict(problem=problem, M=int(r.M), info=int(r.info),
                  loop=int(r.loop), lam=np.asarray(r.lam),
                  q=r.q.cpu().numpy())
    numbers = checks.judge(ref, cfg, [record])
    return numbers, checks.passes(numbers, 1)


@pytest.mark.parametrize("seed", [0, 7, 2 ** 33 + 17])
def test_feast_meets_the_cell_limits(seed):
    cfg = _cfg()
    problem = gen.build(cfg, seed, 0)
    assert problem["count"] == 11
    r = _solve(problem)
    numbers, ok = _judge(cfg, problem, r)
    assert ok, numbers
    assert r.M == problem["count"] and int(r.info) == 0
    assert numbers["eig_err"]["value"] <= 1e-9
    assert numbers["res_max"]["value"] <= 1e-8


@pytest.mark.parametrize("fault", ["phase_sign", "seam_bond"])
def test_a_planted_fault_fails(fault):
    cfg = _cfg()
    problem = gen.build(cfg, 3, 0)
    bad = _faulty(problem["A"], fault, cfg["grid"][1])
    assert abs(bad - bad.conj().T).max() == 0
    numbers, ok = _judge(cfg, problem, _solve(problem, A=bad))
    assert not ok, numbers
    # the flipped phases keep the spectrum (k -> -k maps the chains onto
    # each other) and move every eigenvector: only the residuals see it
    assert numbers["res_max"]["value"] > 1e-3
    if fault == "phase_sign":
        assert numbers["eig_err"]["value"] <= 1e-9


@pytest.mark.parametrize("where", ["generator", "reference"])
def test_a_short_truncation_raises(where):
    cfg = _cfg(lowest=1)
    if where == "generator":
        with pytest.raises(ValueError, match="raise lowest_1d"):
            gen.build(cfg, 0, 0)
        return
    problem = gen.build(_cfg(), 0, 0)
    Emin, Emax = problem["interval"]
    with pytest.raises(ValueError, match="raise lowest"):
        ref.exact_eigenvalues(problem["inputs"], Emin, Emax, 1)
    # the whole spectrum, as the judge asks for it, stops where it is
    # complete: at the least of the chains' lowest eigenvalues
    s = ref.exact_eigenvalues(problem["inputs"], -np.inf, np.inf, 1)
    assert len(s) == 1 and s[0] == ref.chain_eigenvalues(
        problem["inputs"], 1).min()
